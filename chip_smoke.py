#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpuframe_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit, no result line):

1. Device: the card's name and power limit from ``nvidia-smi``; no CUDA,
   no run.
2. Build: every CUDA kernel of the port (seven sources), compiled from
   ``tpuframe_torch/csrc`` with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
   source, all started together, and beside them the K2 baseline
   (``tests/csrc/cross_entropy_baseline.cu``, the design before saved row
   statistics) and the K6 baseline (``tests/csrc/
   blockwise_attention_baseline.cu``, every product a float32 FMA), for
   timing only; each kernel's registers and spills from ``ptxas``.
3. Kernels: first the launch floor, the time of an empty kernel
   (``csrc/launch_floor.cu``) launched through ``ctypes`` as every kernel
   is, printed on its own line and given as ``floor_ms`` beside each
   kernel's byte or operation bound.  Then each kernel against its plain
   PyTorch version on the card, at the shapes its paths give it and at
   ragged ones, timed with CUDA events (median of 100 launches after
   warm-up, L2 flushed before each) beside its plain version and one
   library call of the same function, in turns: K1 normalize at every
   serve bucket and the train batch of 128 (``torch.addcmul`` into a bf16
   ``out=`` at 64 and 128), K2a cross entropy forward
   (``F.cross_entropy(reduction="none")``) and K2b its backward
   (``torch.autograd.grad`` of that loss), the last two checked also at
   phase 10's (64, 1000) a rank, and timed at the train
   path's (128, 1000) and at an HBM-bound (16384, 1000), f32 and bf16,
   each with its ratio to the floor, as the train path calls them (K2a
   writing the row statistics, K2b taking them), without statistics, and
   the baseline, in turns; checked at every path of the forward with
   labels at 0, at K - 1 and on the row's maximum, K2b from the
   statistics bit-equal to K2b without them; K3a
   LayerNorm forward (``F.layer_norm(eps=1e-6)``) and K3b its backward
   (``torch.autograd.grad`` of it) at the LM path's (16384, 768) bf16 with
   bf16 scale and bias, checked there, in f32 and at a ragged 1000 x 300,
   K3b also timed in f32 and at 1000 x 300 and split by kernel with
   ``torch.profiler``; K4 fused AdamW, one launch over the 149 parameter
   tensors of the GPT-2-small LM plus a misaligned view, over a ragged
   list with ``b1 = 0``, a bf16 list and a list longer than one launch's
   table, each bit-equal to one-entry calls, then one ``FusedAdamW.step()``
   over the 149 tensors timed beside ``torch.optim.AdamW(fused=True)
   .step()`` (the same update) and the per-tensor loop of one-entry calls;
   K5a bucket abs-max
   (``torch.linalg.vector_norm(v, inf, dim=1)``), K5b encode (int8, int8
   stochastic with the same noise, fp8) and K5c decode at the ResNet50-1K
   wire's 25 x 1,022,336 float32, at (3, 130) and on edge rows: amax and
   encode bit-equal, decode within 1e-6 with NaN where amax is NaN; K6a
   blockwise attention forward, K6b its backward's delta and dQ, K6c dK
   and dV, against the plain schedule run in float32 at the long-context
   path's (2, 8192, 12, 64) bf16 causal, ViT's (64, 196, 12, 64) bf16 and
   ragged L = 13 and 1000 in f32 and bf16 (f32 within 1e-5 forward and
   1e-4 gradients, bf16 at most twice the plain bf16 run's distance), two
   runs bit-equal, the K6 baseline held to the same bf16 rule at the path's
   shape, K6a at q scaled by 8 with its lse within 1e-5 of the float64
   logsumexp or no further than twice the f32 plain run; timed at the
   path's shape beside the plain passes,
   ``F.scaled_dot_product_attention(is_causal=True)`` forward and autograd
   backward and the baseline, in turns, each against its operation bound
   in bf16.
   K6's counters are then zeroed, and phases 4 to 10 must leave them at 0.
4. Serve: ResNet50 with 1000 classes under ``bf16_compute`` serves 160
   uint8 224x224 images through ``ServeEngine`` (buckets 1/8/32/64) from 4
   client threads, plus one ``POST /predict`` through ``ServingServer``.
   Launch counters are zeroed just before and read just after; every
   kernel of the path must have launched, once a batch, and no other.
   Served rows are held against direct predicts, against predicts through
   the plain normalize, and an f32 forward on the card against the same
   forward on the CPU.
5. Train: ``Trainer(...).fit()`` on ResNet50-1K (``norm_dtype=bf16``,
   ``precision="bf16"``, SGD lr 0.1 momentum 0.9, uint8 images normalized
   by K1) for 12 batches of 128 plus an eval whose last batch is ragged;
   counters zeroed just before and read just after, each kernel at its
   expected count.  Then the train step alone on one device-resident
   batch (images per second, median of 30 steps, and a ``torch.profiler``
   table of one step), ten steps on one batch that must lower the loss,
   kernel against plain cross entropy in f32 train steps, and an f32 train
   step on the card against the CPU.
6. LM train: ``Trainer(TransformerLM(...), tx=fused_adamw(3e-4,
   weight_decay=1e-4), precision="bf16").fit()`` on the GPT-2-small LM of
   ``benchmarks/bench_lm.py`` (12 layers, 12 heads x 64, vocab 32768, seq
   1024, batch 16, random weights from a seed) for 12 batches of example
   06's next-token data, plus an eval whose last batch is ragged; counters
   zeroed just before and read just after: K3a 25 per forward, K3b 25 per
   step, K4 1 per step (one launch for the 149 tensors), K1 and K2 none.
   Then the train step alone on one
   device-resident batch (tokens per second and MFU, median of 30 steps, a
   ``torch.profiler`` table, and the time of the materialized attention and
   of the float32 logits and loss at the step's shapes), ten steps on one
   batch that must lower the loss, kernel against plain LayerNorm and AdamW
   in f32 steps, and a small f32 LM step on the card against the CPU.
7. Checkpoint and resume: phase 6's LM fit with
   ``checkpoint_interval_batches=2`` stopped by a crash after step 4, a new
   Trainer over the same directory that auto-resumes and runs to step 6
   (its first batch must be batch 5), bit-equal to an uninterrupted 6-step
   fit; the step directory in the JAX package's layout; then the wall time
   and GB/s of a save and a restore of the full LM state (parameters and
   both moments), and of an async save with the step time while it is in
   flight.
8. Compressed data-parallel train: phase 5's ResNet50-1K fit through
   ``Trainer(plan=ParallelPlan(mesh=initialize().mesh), grad_compression=
   "int8")`` on a one-rank NCCL group (``RANK=0``, ``WORLD_SIZE=1``, a free
   ``MASTER_PORT``); counters zeroed just before and read just after: K5a,
   K5b and K5c once a step, K1 and K2 at phase 5's counts.  First loss near
   ln 1000, a non-zero error-feedback residual, then the compressed step's
   median beside the uncompressed step's (in turns), the sync and the
   buffer average alone, one compressed step under CUDA's sync debug mode
   (it must never wait for the device) and a profile; then the state with
   its residual saved, overwritten and restored, bit for bit.
9. Two ranks on one card: two spawned gloo ranks (NCCL refuses two ranks
   on one device) sync a ResNet50-shaped named tree with the kernels; it
   must equal the same ranks' plain run on the CPU bit for bit, give both
   ranks one mean, and decode a NaN on one rank to NaN in its bucket.
10. Uncompressed data parallelism on one card: two spawned gloo ranks
   train phase 5's ResNet50-1K through ``Trainer(plan=ParallelPlan(mesh=
   rt.mesh)).fit()`` (global batch 128, 64 a rank, process loader workers)
   for 4 batches plus an eval whose last batch is ragged; counters zeroed
   just before and read just after on each rank: K1 and K2a once a batch
   (train and eval), K2b once a step.  Both ranks end with the same
   parameters and BatchNorm buffers bit for bit, the eval counts each
   image once, the first loss is near ln 1000.  Then the two-rank step
   alone (img/s; gloo routes every collective through the host) with a
   ``torch.profiler`` count of its device time beside the same step with
   each rank's BatchNorm on its own rows, and one
   f32 step of the two ranks on their halves held against one process's
   step on the global batch, for sync BatchNorm and for local with
   ``bn_groups=2``: loss and running statistics within 1e-5, the update
   within ``DDP_UPDATE_RTOL`` (sync also against one process through the
   cross-rank function), beside controls of what rounding alone moves,
   and two planted faults of the sync backward that must exceed it.
11. ViT serve: phase 4's serve path over ViT-B/16 with 1000 classes
   (random weights from a seed): K1 once a batch, K3a 25 times a forward,
   K6 never (196 tokens take full attention), and the same checks.
12. Long-context LM train: ``bench_lm.py``'s ``long_ctx`` (phase 6's widths
   at seq 8192, batch 2, ``attn_impl="auto"``, so blockwise) through
   ``Trainer(tx=fused_adamw(...), precision="bf16").fit()`` for 4 batches
   plus an eval of 3 batches, counters zeroed just before and read just
   after: K6a 12 a forward, K6b and K6c 12 a step, K3a, K3b and K4 at
   their per-step counts.  The first loss near ln 32768; the step alone
   (tokens per second, MFU on phase 6's formula, a profile with K6's
   share); ten steps on one batch; then ``long_remat`` (``remat=True``)
   for 2 batches: K6a 24 a step, its first loss bit-equal to
   ``long_ctx``'s, its peak memory below it; a small f32 blockwise LM
   step on the card against the CPU.
13. Result: a ``kernels`` JSON line (each kernel with ``floor_ms``; K1 and
   K2 also with ``launches_ddp``, phase 10's count on each rank; K6 with
   ``launches_remat``, its share of the bound, ``baseline_ms``,
   ``speedup`` and ``ptxas``, the registers and spills of its bf16
   tensor-core kernel at each head dim), the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

One phase of 3 alone, for a short run on the card (the kernels it needs
are built at first use)::

    python3 -c "import torch, chip_smoke as cs; f = torch.empty(2**28, dtype=torch.uint8,
    device='cuda'); fl = cs.floor_phase(f); cs.kernel_phase(f, fl); cs.cross_entropy_phase(f, fl,
    cs.baseline_library(cs.start_baseline_build()))"

(one line; the break inside the quotes is harmless).  K6 against its
baseline alone: ``cs.blockwise_phase(f, cs.baseline_library(
cs.start_baseline_build(cs.BASELINE_K6)))``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores


def bound(moved: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over HBM's rate and the float32 operations over its peak."""
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
BUCKETS = (1, 8, 32, 64)
N_REQUESTS = 160
N_CLIENTS = 4
# bf16 logits of one image served in a batch of up to 64 against the same
# image predicted alone: cuDNN picks other algorithms per batch shape, so
# every conv rounds its bf16 output at other places; over ~50 layers that
# stays within a few bf16 ulps (2**-8 each) of the logit scale
BF16_REL_TOL = 3e-2
# f32 forward on the card (TF32 off) against the CPU: only the order of the
# sums differs
F32_REL_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max().item())


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of one bf16 step at the value (its
    ulp: 2**-7 of the power of two at or below |want|) plus 1e-6.  At most
    1 where the two round float32 values a rounding apart, also where a
    value cancels to near zero (there a bf16 ulp is tiny and the ulp count
    of :func:`bf16_ulp_distance` is large)."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(want)  # |want| in [2**(exp-1), 2**exp)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    return float(((got - want).abs() / (ulp + 1e-6)).max())


def time_ms(fn, flush: torch.Tensor, iters: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, by CUDA events.  The flush reads a buffer larger than L2: a
    flush that writes would leave dirty lines whose write-back lands inside
    the timed launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.amax()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_jax_variables(template: dict, seed: int) -> dict:
    """Random weights in the JAX ResNet layout, from ``seed``: He-normal
    conv kernels, LeCun-normal ``fc``, and non-trivial BatchNorm scale,
    bias and running statistics."""
    rng = np.random.default_rng(seed)

    def fill(tree: dict, stats: bool) -> dict:
        out = {}
        for name in sorted(tree):
            v = tree[name]
            if isinstance(v, dict):
                out[name] = fill(v, stats)
                continue
            shape = np.shape(v)
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                scale = np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in)
                a = rng.normal(0.0, scale, shape)
            elif name == "mean":
                a = rng.normal(0.0, 0.1, shape)
            elif name == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif name == "scale":
                a = rng.uniform(0.2, 0.6, shape)
            else:  # BN and fc bias
                a = rng.normal(0.0, 0.05, shape)
            out[name] = a.astype(np.float32)
        return out

    return {"params": fill(template["params"], False),
            "batch_stats": fill(template["batch_stats"], True)}


def demangled(mangled: str) -> str:
    """A kernel's mangled name as ``name<template arguments>``: the last
    length-prefixed name, then its type (``f32``, ``bf16``) and integer
    arguments."""
    if not mangled.startswith("_Z"):
        return mangled
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    rest = mangled[i:]
    if not rest.startswith("I"):
        return name
    targs = rest[1:rest.index("EE") + 1]
    args = [t for t, pat in (("f32", r"^f"), ("bf16", r"^13__nv_bfloat16")) if re.match(pat, targs)]
    return f"{name}<{','.join(args + re.findall(r'Li(\d+)E', targs))}>"


def ptxas_table(text: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from an
    ``nvcc -Xptxas -v`` log, each kernel named by its function and template
    arguments (``attn_bwd_dq_tc<64>``, ``attn_fwd_kernel<bf16,64>``)."""
    table, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = demangled(m.group(1))
            table[fn] = {"registers": None, "spill_stores": None, "spill_loads": None}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            table[fn]["spill_stores"], table[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[fn]["registers"] = int(m.group(1))
    return table


def floor_phase(flush) -> float:
    """The launch floor: the median CUDA-event time of the empty kernel
    (``csrc/launch_floor.cu``), launched from Python through ``ctypes`` as
    every kernel is, after the same L2 flush.  Every kernel's time below
    holds this much overhead."""
    from tpuframe_torch.ops import launch_floor

    before = launch_floor.launches
    launch_floor()
    torch.cuda.synchronize()
    check(launch_floor.launches == before + 1,
          f"launch floor counter moved {launch_floor.launches - before} for one launch")
    floor = min(time_ms(launch_floor, flush), time_ms(launch_floor, flush))
    return floor


def normalize_timings(flush, x) -> dict:
    """K1 on ``x`` (uint8 NHWC) into bf16, timed beside ``torch.addcmul``
    (one TensorIterator launch of b + x * w from uint8 into a bf16 out=,
    the same folded f32 constants; the port never calls it) and the plain
    version; calls in turns (plain, kernel, library, library, kernel,
    plain), the better of each pair kept."""
    from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference

    dev = x.device
    w_t = torch.tensor([(1 / 255) / s for s in STD], dtype=torch.float32, device=dev)
    b_t = torch.tensor([-m / s for m, s in zip(MEAN, STD)], dtype=torch.float32, device=dev)
    lib_out = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    library = functools.partial(torch.addcmul, b_t, x, w_t, out=lib_out)
    library()
    want = normalize_images_reference(x, MEAN, STD, out_dtype=torch.bfloat16)
    lib_ulps = bf16_ulp_distance(lib_out, want)
    check(lib_ulps <= 1, f"torch.addcmul yardstick: {lib_ulps} bf16 ulps from plain (tol 1)")
    kernel = functools.partial(normalize_images, x, MEAN, STD, out_dtype=torch.bfloat16)
    plain = functools.partial(normalize_images_reference, x, MEAN, STD,
                              out_dtype=torch.bfloat16)
    plain_ms = [time_ms(plain, flush)]
    kernel_ms = [time_ms(kernel, flush)]
    library_ms = [time_ms(library, flush), time_ms(library, flush)]
    kernel_ms.append(time_ms(kernel, flush))
    plain_ms.append(time_ms(plain, flush))
    n = x.numel()
    moved = n * 1 + n * 2  # uint8 in, bf16 out
    return {"shape": "x".join(map(str, x.shape)) + " uint8->bf16", "ms": min(kernel_ms),
            "plain_ms": min(plain_ms), "library_ms": min(library_ms),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes_moved": moved,
            "library_ulps": lib_ulps}


def kernel_phase(flush, floor_ms: float):
    """K1 against its plain version on the card: the runs path (C = 3 and
    C = 1 on aligned pointers) at every serve bucket, the train shape and
    element counts that are no multiple of 48, the general path (pointers
    1 byte off 16, 16 channels); then timed at the serve buckets and the
    train shape 128x224x224x3, beside ``torch.addcmul`` at 64 and 128."""
    from tpuframe_torch.ops.normalize import (
        normalize_images,
        normalize_images_reference,
    )

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def images(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    batches = {b: images((b, 224, 224, 3)) for b in BUCKETS + (TRAIN_BATCH,)}
    ragged = images((3, 17, 17, 3))  # 2,601 elements: 54 runs of 48 and 9 left
    odd = images((1, 5, 7, 3))  # 105: two vectors of 16 and a tail of 9
    flat = torch.empty(ragged.numel() + 1, dtype=torch.uint8, device=dev)
    unaligned = flat[1:].view(ragged.shape)  # contiguous, 1 byte off 16
    unaligned.copy_(ragged)
    gray = torch.from_numpy(rng.random((2, 28, 28, 1), dtype=np.float32)).to(dev)
    wide = images((3, 5, 7, 16))
    cases = [(f"{b}x224x224x3 uint8->bf16", batches[b], MEAN, STD, 1 / 255, torch.bfloat16)
             for b in BUCKETS + (TRAIN_BATCH,)]
    cases += [
        ("64x224x224x3 uint8->f32", batches[64], MEAN, STD, 1 / 255, torch.float32),
        (f"{TRAIN_BATCH}x224x224x3 uint8->f32", batches[TRAIN_BATCH], MEAN, STD, 1 / 255,
         torch.float32),
        ("3x17x17x3 uint8->f32", ragged, MEAN, STD, 1 / 255, torch.float32),
        ("3x17x17x3 uint8->bf16", ragged, MEAN, STD, 1 / 255, torch.bfloat16),
        ("1x5x7x3 uint8->bf16", odd, MEAN, STD, 1 / 255, torch.bfloat16),
        ("3x17x17x3 unaligned uint8->bf16", unaligned, MEAN, STD, 1 / 255,
         torch.bfloat16),
        ("2x28x28x1 f32 scale=1 ->f32", gray, (0.5,), (0.5,), 1.0, torch.float32),
        ("2x28x28x1 f32 scale=1 ->bf16", gray, (0.5,), (0.5,), 1.0, torch.bfloat16),
        ("3x5x7x16 uint8->bf16", wide, tuple(np.linspace(0.1, 0.9, 16)),
         tuple(np.linspace(0.2, 0.3, 16)), 1 / 255, torch.bfloat16),
    ]
    max_err = 0.0
    for name, x, mean, std, scale, out_dtype in cases:
        got = normalize_images(x, mean, std, scale=scale, out_dtype=out_dtype)
        want = normalize_images_reference(x, mean, std, scale=scale,
                                          out_dtype=out_dtype)
        torch.cuda.synchronize()
        check(got.dtype == out_dtype and got.shape == x.shape, f"{name}: {got.dtype} {got.shape}")
        err = float((got.float() - want.float()).abs().max().item())
        if out_dtype == torch.float32:
            check(err <= 1e-5, f"normalize {name}: max abs diff {err} > 1e-5")
            log(f"  normalize {name}: max abs diff {err:.3g} (tol 1e-5)")
        else:
            ulps = bf16_ulp_distance(got, want)
            check(ulps <= 1, f"normalize {name}: {ulps} bf16 ulps apart (tol 1)")
            log(f"  normalize {name}: max abs diff {err:.3g}, {ulps} bf16 ulp (tol 1)")
        if x is batches[64] and out_dtype == torch.bfloat16:
            max_err = err
        del got, want

    timed = {b: normalize_timings(flush, batches[b]) for b in (64, TRAIN_BATCH)}
    for b in BUCKETS[:-1]:
        kernel = functools.partial(normalize_images, batches[b], MEAN, STD,
                                   out_dtype=torch.bfloat16)
        n = batches[b].numel()
        timed[b] = {"shape": f"{b}x224x224x3 uint8->bf16",
                    "ms": min(time_ms(kernel, flush), time_ms(kernel, flush)),
                    "bound_ms": 3 * n / HBM_BYTES_PER_S * 1e3, "bytes_moved": 3 * n}
    for b in BUCKETS + (TRAIN_BATCH,):
        t = timed[b]
        extra = ""
        if t.get("library_ms") is not None:
            extra = (f", plain {t['plain_ms'] * 1e3:.2f} us, torch.addcmul "
                     f"{t['library_ms'] * 1e3:.2f} us ({t['library_ulps']} bf16 ulp from plain)")
        log(f"  normalize {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bytes_moved'] / 1e6:.2f} MB at 3.35 TB/s, "
            f"{100 * t['bound_ms'] / t['ms']:.1f} %), {t['ms'] / floor_ms:.2f}x the floor{extra}")
    main = timed[64]
    return {
        "name": "normalize",
        "route": "cuda",
        "source": "tpuframe_torch/csrc/normalize.cu",
        "replaces": "tpuframe/ops/normalize.py:48",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],  # torch.addcmul into a bf16 out=
        "shape": main["shape"],
        "bytes_moved": main["bytes_moved"],
        "buckets_ms": {str(b): timed[b]["ms"] for b in BUCKETS},
        "train": {k: v for k, v in timed[TRAIN_BATCH].items() if k != "library_ulps"},
    }


BASELINE_CE = Path(__file__).resolve().parent / "tests" / "csrc" / "cross_entropy_baseline.cu"
#: K6 before its bf16 backward moved to the tensor cores (every product a
#: float32 FMA), its entry points renamed tf_blockwise_attention_baseline_*
BASELINE_K6 = Path(__file__).resolve().parent / "tests" / "csrc" / "blockwise_attention_baseline.cu"


def start_baseline_build(source: Path = BASELINE_CE):
    """Start ``nvcc`` on a baseline kernel source (the K2 design before
    saved row statistics, ``BASELINE_CE``, or K6's FMA design,
    ``BASELINE_K6``) with the port's flags, beside :func:`build.build`'s;
    :func:`baseline_library` waits for it.  Returns ``(source, process or
    None, temporary output, library path)``."""
    import hashlib

    from tpuframe_torch.ops import build

    digest = hashlib.sha256(source.read_bytes() + " ".join(build.NVCC_FLAGS).encode())
    out = build.BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return source, None, None, out
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(tmp),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return source, proc, tmp, out


def baseline_library(handle, timeout_s: float = 600.0):
    """The built baseline library, its C signatures declared (K2's: the ones
    without statistics; K6's: those of ``ops/blockwise_attention.py``).
    The ``ptxas`` lines of its build, if it was built here, are in
    ``lib.build_log``."""
    import ctypes

    source, proc, tmp, out = handle
    log_text = ""
    if proc is not None:
        log_text, _ = proc.communicate(timeout=timeout_s)
        check(proc.returncode == 0 and tmp.exists(),
              f"nvcc failed to build {source.name}:\n{log_text}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.build_log = log_text
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == BASELINE_K6:
        shape = [i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        lib.tf_blockwise_attention_baseline_fwd.argtypes = [ptr] * 5 + shape
        lib.tf_blockwise_attention_baseline_bwd_dq.argtypes = [ptr] * 8 + shape
        lib.tf_blockwise_attention_baseline_bwd_dkv.argtypes = [ptr] * 8 + shape
        for fn in (lib.tf_blockwise_attention_baseline_fwd,
                   lib.tf_blockwise_attention_baseline_bwd_dq,
                   lib.tf_blockwise_attention_baseline_bwd_dkv):
            fn.restype = i32
        return lib
    lib.tf_cross_entropy_fwd.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.tf_cross_entropy_bwd.argtypes = [ptr] * 3 + [ctypes.c_longlong, ptr] + [i32] * 4 + [ptr]
    lib.tf_cross_entropy_fwd.restype = lib.tf_cross_entropy_bwd.restype = i32
    return lib


def cross_entropy_phase(flush, floor_ms: float, baseline) -> list[dict]:
    """K2a and K2b against their plain versions at the train path's shapes,
    at every path of the forward (rows in registers, streamed, element by
    element, a block per row) and ragged ones, with labels at 0, at K - 1
    and on the row's maximum; K2b from the forward's row statistics (the
    train path) bit-equal to K2b without them.  Then timed at (128, 1000)
    and (16384, 1000), f32 and bf16, beside the plain version, the library
    call, the launch floor and ``baseline`` (the design before saved
    statistics), in turns."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.cross_entropy import (
        _LABEL_CODES,
        _LOGIT_CODES,
        cross_entropy_bwd,
        cross_entropy_bwd_reference,
        cross_entropy_fwd,
        cross_entropy_reference,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)

    def inputs(b, k, dtype, label_dtype=torch.int64, edges=False):
        logits = (rng.standard_normal((b, k)) * 3).astype(np.float32)
        labels = rng.integers(0, k, (b,))
        if edges:  # rows labelled 0, K - 1, and a label on the row's maximum
            labels[0::3], labels[1::3] = 0, k - 1
            logits[2::3][np.arange(len(labels[2::3])), labels[2::3]] = 20.0
        g = torch.from_numpy(rng.uniform(0.5, 2.0, b).astype(np.float32))
        return (torch.from_numpy(logits).to(dtype).to(dev),
                torch.from_numpy(labels).to(label_dtype).to(dev), g.to(dev))

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    cases = [
        ("128x1000 f32 int64", 128, 1000, torch.float32, torch.int64, False),
        ("128x1000 f32 int32", 128, 1000, torch.float32, torch.int32, False),
        # phase 10's logits on each of its two ranks
        ("64x1000 f32", 64, 1000, torch.float32, torch.int64, False),
        ("64x1000 bf16", 64, 1000, torch.bfloat16, torch.int64, False),
        ("130x1000 bf16", 130, 1000, torch.bfloat16, torch.int64, False),
        ("3x10 f32", 3, 10, torch.float32, torch.int64, False),
        ("3x10 bf16", 3, 10, torch.bfloat16, torch.int32, False),
        ("16384x1000 f32", 16384, 1000, torch.float32, torch.int64, False),
        ("16384x1000 bf16", 16384, 1000, torch.bfloat16, torch.int64, False),
        ("128x1000 f32, stride-0 g", 128, 1000, torch.float32, torch.int64, True),
        ("128x1000 bf16, stride-0 g", 128, 1000, torch.bfloat16, torch.int64, True),
    ]
    # the forward's paths at their edges: rows in registers up to 1024 f32
    # and 2048 bf16, streamed up to 4096, a block per row above; element
    # loads where K is no multiple of the 16-byte chunk.  A third of the
    # rows put the row's maximum on the label, where the softmax is 1 less
    # a small sum: the plain version's float32 exponentials lose most there,
    # so the backward on these cases is held against the float64 softmax
    cases += [(f"{b}x{k} {'f32' if dt == torch.float32 else 'bf16'} {str(ldt)[6:]}, edge labels",
               b, k, dt, ldt, False)
              for b, k, dt, ldt in ((128, 1000, torch.float32, torch.int32),
                                    (128, 1000, torch.bfloat16, torch.int64),
                                    (128, 1001, torch.float32, torch.int64),
                                    (128, 1024, torch.float32, torch.int64),
                                    (16, 2048, torch.bfloat16, torch.int32),
                                    (16, 4096, torch.float32, torch.int64),
                                    (16, 4097, torch.float32, torch.int32),
                                    (1, 1000, torch.float32, torch.int64),
                                    (16384, 1000, torch.float32, torch.int64),
                                    (16384, 1001, torch.float32, torch.int64))]
    err = {"fwd": 0.0, "bwd": 0.0}
    for name, b, k, dtype, ldt, stride0 in cases:
        logits, labels, g = inputs(b, k, dtype, ldt, edges="edge labels" in name)
        if stride0:
            g = torch.full((), 1.0 / b, device=dev).expand(b)
        loss = cross_entropy_fwd(logits, labels)
        loss_s, stats = cross_entropy_fwd(logits, labels, with_stats=True)
        grad = cross_entropy_bwd(logits, labels, g)
        grad_s = cross_entropy_bwd(logits, labels, g, stats)
        want_loss = cross_entropy_reference(logits, labels)
        want_grad = cross_entropy_bwd_reference(logits, labels, g)
        note = ""
        if "edge labels" in name:
            onehot = F.one_hot(labels.long(), k).double()
            exact = (torch.softmax(logits.double(), -1) - onehot) * g.double()[:, None]
            note = (f"; against the float64 softmax: K2b "
                    f"{float((grad_s.double() - exact).abs().max()):.3g}, plain "
                    f"{float((want_grad.double() - exact).abs().max()):.3g}")
            want_grad = exact.to(dtype)
        torch.cuda.synchronize()
        check(loss.shape == (b,) and loss.dtype == torch.float32, f"K2a {name}: {loss.shape}")
        check(torch.equal(loss, loss_s), f"K2a {name}: the statistics moved the loss")
        check(grad_s.shape == (b, k) and grad_s.dtype == dtype, f"K2b {name}: {grad_s.dtype}")
        # the statistics are the ones the stats-less K2b takes itself
        check(torch.equal(bits(grad_s), bits(grad)),
              f"K2b {name}: from the statistics not bit-equal to the stats-less K2b")
        e_loss = float((loss - want_loss).abs().max())
        e_grad = float((grad_s.float() - want_grad.float()).abs().max())
        # losses of O(10): 1e-5 absolute; f32 gradients 1e-6 absolute; bf16
        # gradients within one bf16 step of the plain value (of the float64
        # softmax on the edge cases)
        check(e_loss <= 1e-5, f"K2a {name}: max abs diff {e_loss} > 1e-5")
        if dtype == torch.float32:
            check(e_grad <= 1e-6, f"K2b {name}: max abs diff {e_grad} > 1e-6")
            tol = "1e-6"
        else:
            ulps = bf16_ulp_distance(grad_s, want_grad)
            check(ulps <= 1, f"K2b {name}: {ulps} bf16 ulps apart (tol 1)")
            tol = f"{ulps} bf16 ulp, tol 1"
        log(f"  cross entropy {name}: K2a max abs diff {e_loss:.3g} (tol 1e-5), "
            f"K2b {e_grad:.3g} ({tol}), bit-equal without statistics{note}")
        if name == "128x1000 f32 int64":
            err = {"fwd": e_loss, "bwd": e_grad}

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def timed(b, k, dtype):
        logits, labels, g = inputs(b, k, dtype)
        loss_buf = torch.empty(b, dtype=torch.float32, device=dev)
        grad_buf = torch.empty((b, k), dtype=dtype, device=dev)
        codes = (_LOGIT_CODES[dtype], _LABEL_CODES[labels.dtype])
        # the baseline on the same inputs, bit-equal to the stats-less kernel
        check(baseline.tf_cross_entropy_fwd(logits.data_ptr(), labels.data_ptr(),
                                            loss_buf.data_ptr(), b, k, *codes, stream()) == 0,
              "baseline K2a launch")
        check(baseline.tf_cross_entropy_bwd(logits.data_ptr(), labels.data_ptr(), g.data_ptr(),
                                            1, grad_buf.data_ptr(), b, k, *codes,
                                            stream()) == 0, "baseline K2b launch")
        loss, stats = cross_entropy_fwd(logits, labels, with_stats=True)
        grad = cross_entropy_bwd(logits, labels, g, stats)
        torch.cuda.synchronize()
        # the same arithmetic: held at the kernels' tolerances, bits logged
        check(float((loss_buf - loss).abs().max()) <= 1e-6
              and (float((grad_buf.float() - grad.float()).abs().max()) <= 1e-6
                   if dtype == torch.float32 else bf16_ulp_distance(grad_buf, grad) <= 1),
              f"baseline K2 at {b}x{k} disagrees with the kernels")
        log(f"  baseline K2 at {b}x{k} {str(dtype)[6:]}: loss bit-equal "
            f"{torch.equal(loss_buf, loss)}, gradient bit-equal "
            f"{torch.equal(bits(grad_buf), bits(grad))}")
        x = logits.detach().float().requires_grad_(True)
        lib_loss = F.cross_entropy(x, labels, reduction="none")
        lib_err = (lib_loss.detach() - cross_entropy_reference(logits, labels)).abs().max()
        check(float(lib_err) <= 1e-5, "F.cross_entropy yardstick disagrees with the plain forward")
        lib_x = logits.detach().requires_grad_(True)
        lib_loss = F.cross_entropy(lib_x, labels, reduction="none")
        arms = {
            "fwd": {
                "kernel": functools.partial(cross_entropy_fwd, logits, labels, with_stats=True),
                "no_stats": functools.partial(cross_entropy_fwd, logits, labels),
                "baseline": lambda: baseline.tf_cross_entropy_fwd(
                    logits.data_ptr(), labels.data_ptr(), loss_buf.data_ptr(), b, k, *codes,
                    stream()),
                "plain": functools.partial(cross_entropy_reference, logits, labels),
                "library": functools.partial(F.cross_entropy, logits, labels, reduction="none"),
            },
            "bwd": {
                "kernel": functools.partial(cross_entropy_bwd, logits, labels, g, stats),
                "no_stats": functools.partial(cross_entropy_bwd, logits, labels, g),
                "baseline": lambda: baseline.tf_cross_entropy_bwd(
                    logits.data_ptr(), labels.data_ptr(), g.data_ptr(), 1, grad_buf.data_ptr(),
                    b, k, *codes, stream()),
                "plain": functools.partial(cross_entropy_bwd_reference, logits, labels, g, stats),
                "library": lambda: torch.autograd.grad(lib_loss, lib_x, g, retain_graph=True),
            },
        }
        esize = logits.element_size()
        out = {}
        for which, arm in arms.items():
            order = ["plain", "baseline", "kernel", "no_stats", "library"]
            times = {name: [] for name in order}
            for name in order + order[::-1]:  # in turns, each arm twice
                times[name].append(time_ms(arm[name], flush))
            # each input read once, each output written once: logits, int64
            # labels (B*8), g (B*4) and the statistics (B*8) the backward
            # reads or the forward writes; the loss (B*4) or the gradient
            stats_bytes = b * 8
            moved = (b * k * esize + b * 8 + b * 4 + stats_bytes if which == "fwd"
                     else 2 * b * k * esize + b * 8 + b * 4 + stats_bytes)
            best = {name: min(v) for name, v in times.items()}
            out[which] = {"ms": best["kernel"], "no_stats_ms": best["no_stats"],
                          "baseline_ms": best["baseline"], "plain_ms": best["plain"],
                          "library_ms": best["library"], "runs_ms": times,
                          "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes_moved": moved}
        return out

    shapes = {f"{b}x{k} {tag}": (b, k, dt) for b, k in ((128, 1000), (16384, 1000))
              for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    timings = {name: timed(*shape) for name, shape in shapes.items()}
    rows = []
    for which, name, line in (("fwd", "cross_entropy_fwd", 49), ("bwd", "cross_entropy_bwd", 60)):
        for shape, t in timings.items():
            r = t[which]
            log(f"  {name} {shape}: kernel {r['ms'] * 1e3:.2f} us ({r['ms'] / floor_ms:.2f}x the "
                f"floor, {r['bound_ms'] / r['ms'] * 100:.1f} % of the bound), without statistics "
                f"{r['no_stats_ms'] * 1e3:.2f} us, baseline {r['baseline_ms'] * 1e3:.2f} us, plain "
                f"{r['plain_ms'] * 1e3:.2f} us, library {r['library_ms'] * 1e3:.2f} us, bound "
                f"{r['bound_ms'] * 1e3:.3f} us ({r['bytes_moved'] / 1e6:.2f} MB at 3.35 TB/s) "
                f"on {floor_ms * 1e3:.2f} us floor")
        s = timings["128x1000 f32"][which]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "tpuframe_torch/csrc/cross_entropy.cu",
            "replaces": f"tpuframe/ops/cross_entropy.py:{line}",
            "launches": None,  # filled from the main path's run
            "max_abs_err": err[which],
            **{k: s[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "no_stats_ms",
                                 "baseline_ms", "bytes_moved")},
            "bound_by": "bytes",
            "shape": "128x1000 f32, int64 labels, with the row statistics",
            "at": {shape: {k: v for k, v in t[which].items() if k != "runs_ms"}
                   for shape, t in timings.items() if shape != "128x1000 f32"},
        })
    return rows


def layer_norm_phase(flush) -> list[dict]:
    """K3a and K3b against their plain versions at the LM path's (16384,
    768) bf16 with bf16 scale and bias (the bf16 policy casts them), in f32
    and at a ragged (1000, 300), then timed at the path's shape beside the
    plain versions and the library calls."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.layer_norm import (
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_fwd,
        layer_norm_reference,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    path = (16384, 768)

    def inputs(rows, d, dtype):
        x = (rng.standard_normal((rows, d)) * 2 + 0.5).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
        bias = rng.normal(0, 0.3, d).astype(np.float32)
        g = rng.standard_normal((rows, d)).astype(np.float32)
        return tuple(torch.from_numpy(a).to(dtype).to(dev) for a in (x, scale, bias, g))

    cases = [("16384x768 bf16", *path, torch.bfloat16), ("16384x768 f32", *path, torch.float32),
             ("1000x300 f32", 1000, 300, torch.float32),
             ("1000x300 bf16", 1000, 300, torch.bfloat16)]
    err = {}
    for name, rows, d, dtype in cases:
        x, scale, bias, g = inputs(rows, d, dtype)
        y = layer_norm_fwd(x, scale, bias)
        dx, dscale, dbias = layer_norm_bwd(x, scale, g)
        want_y = layer_norm_reference(x, scale, bias)
        want_dx, want_ds, want_db = layer_norm_bwd_reference(x, scale, g)
        torch.cuda.synchronize()
        check(y.dtype == dx.dtype == dtype and dscale.dtype == dbias.dtype == dtype
              and y.shape == dx.shape == x.shape, f"K3 {name}: {y.dtype} {dx.dtype} {dscale.dtype}")
        e_y = float((y.float() - want_y.float()).abs().max())
        e_dx = float((dx.float() - want_dx.float()).abs().max())
        e_ds = float((dscale.float() - want_ds.float()).abs().max())
        e_db = float((dbias.float() - want_db.float()).abs().max())
        if dtype == torch.float32:
            # O(1) values, sums over the row in another order: 1e-5 absolute.
            # dscale and dbias sum `rows` terms in another order (per lane,
            # per warp, then the blocks' partials): within 2e-5 of each
            # column's sum of |terms|
            xf = x.float()
            mu = xf.mean(-1, keepdim=True)
            xhat = (xf - mu) * torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + 1e-6)
            ok_s = bool(((dscale - want_ds).abs() <= 2e-5 * (g * xhat).abs().sum(0) + 1e-6).all())
            ok_b = bool(((dbias - want_db).abs() <= 2e-5 * g.abs().sum(0) + 1e-6).all())
            check(e_y <= 1e-5 and e_dx <= 1e-5 and ok_s and ok_b,
                  f"K3 {name}: y {e_y}, dx {e_dx} (tol 1e-5), dscale {e_ds} ({ok_s}), "
                  f"dbias {e_db} ({ok_b})")
            tol = "1e-5; dscale/dbias 2e-5 of the column's sum of |terms|"
        else:
            # one bf16 step of the value (y and dx cancel to near zero
            # where x is near its row's mean: there the kernel's fused
            # multiply-adds and the plain version's separate roundings
            # land a few float32 roundings apart)
            steps = [round(bf16_steps(a, b), 3) for a, b in
                     ((y, want_y), (dx, want_dx), (dscale, want_ds), (dbias, want_db))]
            check(max(steps) <= 1, f"K3 {name}: bf16 steps y/dx/dscale/dbias {steps} (tol 1)")
            tol = f"bf16 steps y/dx/dscale/dbias {steps}, tol 1"
        log(f"  layer norm {name}: K3a max abs diff {e_y:.3g}, K3b dx {e_dx:.3g}, dscale "
            f"{e_ds:.3g}, dbias {e_db:.3g} ({tol})")
        if (rows, d) == path and dtype == torch.bfloat16:
            err = {"fwd": e_y, "bwd": max(e_dx, e_ds, e_db)}
        again = layer_norm_bwd(x, scale, g)
        check(all(torch.equal(a, b) for a, b in zip((dx, dscale, dbias), again)),
              f"K3b {name}: a rerun gave other bits")

    rows, d = path
    x, scale, bias, g = inputs(rows, d, torch.bfloat16)
    xl, sl, bl = (t.detach().requires_grad_(True) for t in (x, scale, bias))
    lib_y = F.layer_norm(xl, (d,), sl, bl, eps=1e-6)
    lib_steps = bf16_steps(lib_y.detach(), layer_norm_reference(x, scale, bias))
    log(f"  F.layer_norm yardstick 16384x768 bf16: within {lib_steps:.3g} bf16 steps of the "
        "plain version (it takes a two-pass variance)")
    arms = {
        "fwd": (functools.partial(layer_norm_fwd, x, scale, bias),
                functools.partial(layer_norm_reference, x, scale, bias),
                functools.partial(F.layer_norm, x, (d,), scale, bias, eps=1e-6)),
        "bwd": (functools.partial(layer_norm_bwd, x, scale, g),
                functools.partial(layer_norm_bwd_reference, x, scale, g),
                lambda: torch.autograd.grad(lib_y, (xl, sl, bl), g, retain_graph=True)),
    }
    elem = rows * d
    # each input read once, each output written once (bf16): x and y, plus
    # scale and bias; x, g and dx, plus scale, dscale and dbias.  About 8
    # float32 operations an element forward, 16 backward
    moved = {"fwd": 2 * elem * 2 + 2 * d * 2, "bwd": 3 * elem * 2 + 3 * d * 2}
    flops = {"fwd": 8 * elem, "bwd": 16 * elem}
    rows_out = []
    for which, name, line in (("fwd", "layer_norm_fwd", 51), ("bwd", "layer_norm_bwd", 64)):
        kernel, plain, library = arms[which]
        plain_ms = [time_ms(plain, flush)]
        kernel_ms = [time_ms(kernel, flush)]
        library_ms = [time_ms(library, flush), time_ms(library, flush)]
        kernel_ms.append(time_ms(kernel, flush))
        plain_ms.append(time_ms(plain, flush))
        bound_ms, bound_by = bound(moved[which], flops[which])
        r = {"name": name, "route": "cuda", "source": "tpuframe_torch/csrc/layer_norm.cu",
             "replaces": f"tpuframe/ops/layer_norm.py:{line}", "launches": None,
             "max_abs_err": err[which], "ms": min(kernel_ms), "plain_ms": min(plain_ms),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": min(library_ms),
             "shape": "16384x768 bf16, bf16 scale/bias", "bytes_moved": moved[which]}
        log(f"  {name} 16384x768 bf16: kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {r['library_ms'] * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({moved[which] / 1e6:.2f} MB at 3.35 TB/s)")
        rows_out.append(r)
    rows_out[1].update(layer_norm_bwd_detail(flush, inputs, layer_norm_bwd, arms["bwd"][0]))
    return rows_out


def layer_norm_bwd_detail(flush, inputs, layer_norm_bwd, path_call) -> dict:
    """K3b beyond the path's shape: its time at (16384, 768) f32 and at the
    ragged (1000, 300) (the element path), and where a call at the path's
    shape spends its device time, kernel by kernel (``torch.profiler``)."""
    ms_by_shape = {}
    for name, rows, d, dtype in (("16384x768 f32", 16384, 768, torch.float32),
                                 ("1000x300 f32", 1000, 300, torch.float32),
                                 ("1000x300 bf16", 1000, 300, torch.bfloat16)):
        x, scale, _, g = inputs(rows, d, dtype)
        ms_by_shape[name] = time_ms(functools.partial(layer_norm_bwd, x, scale, g), flush)
    split = kernel_split(path_call)
    log("  layer_norm_bwd at other shapes: " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in ms_by_shape.items()))
    log("  layer_norm_bwd 16384x768 bf16, device time by kernel (profiler, no flush): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in split.items()))
    return {"ms_by_shape": ms_by_shape, "profile_split_us": split}


ADAMW_HP = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def adamw_leaf(gen, shape, dtype=torch.float32, offset: int = 0):
    """(p, g, m, v) on the card from ``gen``; ``offset`` > 0 places each
    array that many elements into a larger buffer (off the vector
    alignment)."""
    dev = torch.device("cuda")
    n = int(np.prod(shape))

    def place(t):
        if not offset:
            return t
        flat = torch.empty(n + offset, dtype=t.dtype, device=dev)
        out = flat[offset:].view(shape)
        out.copy_(t)
        return out

    p = torch.randn(shape, generator=gen, device=dev).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    m = torch.randn(shape, generator=gen, device=dev) * 0.1
    v = torch.rand(shape, generator=gen, device=dev) * 0.1
    return tuple(place(t) for t in (p, g, m, v))


def adamw_phase(flush, shapes) -> dict:
    """K4 against its plain version: one multi-tensor launch over
    ``shapes`` (the LM's parameter tensors) plus a view one element off the
    vector alignment, a ragged 257 x 130 list with ``b1 = 0``, a bf16 list,
    and a list longer than one launch's table; each within 1e-6 of the plain
    version (a bf16 parameter within one bf16 step) and bit-equal to
    one-entry calls per tensor.  Then one optimizer step over ``shapes``,
    timed (:func:`adamw_step_times`)."""
    from tpuframe_torch.ops.fused_adamw import (
        TABLE_CAPACITY,
        fused_adamw_multi_update_,
        fused_adamw_update_,
        fused_adamw_update_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    count = torch.full((), 7, dtype=torch.int32, device=dev)
    lm = [adamw_leaf(gen, s) for s in shapes]
    cases = [
        (f"{len(shapes)} LM tensors + 1001 off by one", lm + [adamw_leaf(gen, (1001,), offset=1)],
         ADAMW_HP),
        ("257x130 + 33x7 f32, b1 = 0", [adamw_leaf(gen, (257, 130)), adamw_leaf(gen, (33, 7))],
         dict(lr=1e-2, b1=0.0, b2=0.999, eps=1e-8, weight_decay=0.01)),
        ("bf16 4096x768 + 768 + 1001 off by one",
         [adamw_leaf(gen, (4096, 768), torch.bfloat16), adamw_leaf(gen, (768,), torch.bfloat16),
          adamw_leaf(gen, (1001,), torch.bfloat16, offset=1)], ADAMW_HP),
        (f"{TABLE_CAPACITY + 3} small tensors (over one table)",
         [adamw_leaf(gen, (int(k),)) for k in
          np.random.default_rng(5).integers(1, 3000, TABLE_CAPACITY + 3)], ADAMW_HP),
    ]
    worst = 0.0
    for name, leaves, hp in cases:
        want = [fused_adamw_update_reference(p, g, m, v, count, **hp) for p, g, m, v in leaves]
        multi = [(p.clone(), m.clone(), v.clone()) for p, _, m, v in leaves]
        single = [(p.clone(), m.clone(), v.clone()) for p, _, m, v in leaves]
        l0 = fused_adamw_multi_update_.launches
        fused_adamw_multi_update_([t[0] for t in multi], [lf[1] for lf in leaves],
                                  [t[1] for t in multi], [t[2] for t in multi],
                                  [count] * len(leaves), **hp)
        launches = fused_adamw_multi_update_.launches - l0
        for (p, m, v), (_, g, _, _) in zip(single, leaves):
            fused_adamw_update_(p, g, m, v, count, **hp)
        torch.cuda.synchronize()
        expect = -(-len(leaves) // TABLE_CAPACITY)
        same = all(torch.equal(a, b) for got, one in zip(multi, single) for a, b in zip(got, one))
        err_mv = max(float((a - b).abs().max()) for got, w in zip(multi, want)
                     for a, b in zip(got[1:], w[1:]))
        if leaves[0][0].dtype == torch.bfloat16:
            err_p = max(bf16_steps(got[0], w[0]) for got, w in zip(multi, want))
            ok = err_mv <= 1e-6 and err_p <= 1
            tol = f"m/v {err_mv:.3g} (tol 1e-6), p {err_p:.3g} bf16 steps (tol 1)"
        else:
            err = max(err_mv, max(float((got[0] - w[0]).abs().max())
                                  for got, w in zip(multi, want)))
            worst = max(worst, err)
            ok = err <= 1e-6
            tol = f"max abs diff {err:.3g} (tol 1e-6)"
        # the same float32 expression (the compiler may fuse a multiply-add)
        log(f"  fused AdamW, {name}: {launches} launch(es) (expected {expect}); {tol}; "
            f"bit-equal to one-entry calls: {same}")
        check(ok and same and launches == expect, f"K4 {name}: {tol}, launches {launches}, "
              f"bit-equal {same}")
    del cases, want, multi, single

    # the library yardstick: torch's fused AdamW over the same tensors.  From
    # zero moments at step 1 it gives the same update as the plain version
    params = [torch.nn.Parameter(p.clone()) for p, _, _, _ in lm]
    for prm, (_, g, _, _) in zip(params, lm):
        prm.grad = g.clone()
    hp = ADAMW_HP
    lib = torch.optim.AdamW(params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]), eps=hp["eps"],
                            weight_decay=hp["weight_decay"], fused=True)
    lib.step()
    one_count = torch.ones((), dtype=torch.int32, device=dev)
    lib_err = 0.0
    for prm, (p, g, _, _) in zip(params, lm):
        zeros = torch.zeros_like(p)
        want = fused_adamw_update_reference(p, g, zeros, zeros, one_count, **hp)[0]
        lib_err = max(lib_err, float((prm.detach() - want).abs().max()))
    log(f"  torch.optim.AdamW(fused=True) yardstick: first step within {lib_err:.3g} of the "
        "plain version")
    del lm, params, lib
    torch.cuda.empty_cache()

    t = adamw_step_times(flush, shapes)
    n = t["parameters"]
    moved = n * 4 * 7  # p, g, m, v read; p, m, v written; float32
    bound_ms, bound_by = bound(moved, 16 * n)  # about 16 float32 operations an element
    r = {"name": "fused_adamw", "route": "cuda", "source": "tpuframe_torch/csrc/fused_adamw.cu",
         "replaces": "tpuframe/ops/fused_adamw.py:55", "launches": None, "max_abs_err": worst,
         "ms": t["step_ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": t["library_ms"],
         "per_tensor_ms": t["per_tensor_ms"], "profile_split_us": t["split_us"],
         "shape": f"FusedAdamW.step() over {len(shapes)} f32 tensors, {n} parameters",
         "bytes_moved": moved}
    log(f"  fused_adamw bound {bound_ms:.3f} ms ({moved / 1e9:.2f} GB at 3.35 TB/s): step at "
        f"{bound_ms / r['ms']:.1%} of it; {r['library_ms'] / r['ms']:.3f}x the speed of "
        "AdamW(fused=True)")
    return r


def adamw_step_times(flush, shapes, hp=ADAMW_HP) -> dict:
    """One optimizer step over float32 tensors of ``shapes``, timed in
    turns (median of 20 steps, L2 flushed before each): ``FusedAdamW.step()``
    (what the Trainer runs: the counts' one increment, then K4), ``torch.
    optim.AdamW(fused=True).step()``, the per-tensor loop of
    ``fused_adamw_update_`` (one K4 launch a tensor), and the plain
    version; then the device time of one ``FusedAdamW.step()`` by kernel."""
    from tpuframe_torch.ops.fused_adamw import (
        FusedAdamW,
        fused_adamw_update_,
        fused_adamw_update_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    leaves = [adamw_leaf(gen, s) for s in shapes]
    count = torch.full((), 7, dtype=torch.int32, device=dev)

    def optimizer_params():
        params = [torch.nn.Parameter(p.clone()) for p, _, _, _ in leaves]
        for prm, (_, g, _, _) in zip(params, leaves):
            prm.grad = g.clone()
        return params

    ours = FusedAdamW(optimizer_params(), hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                      weight_decay=hp["weight_decay"])
    lib = torch.optim.AdamW(optimizer_params(), lr=hp["lr"], betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], weight_decay=hp["weight_decay"], fused=True)

    def per_tensor():
        for p, g, m, v in leaves:
            fused_adamw_update_(p, g, m, v, count, **hp)

    def plain():
        for p, g, m, v in leaves:
            fused_adamw_update_reference(p, g, m, v, count, **hp)

    timed = functools.partial(time_ms, flush=flush, iters=20, warmup=3)
    arms = {"plain": plain, "step": ours.step, "per_tensor": per_tensor, "library": lib.step}
    times = {k: [] for k in arms}
    for k in ("plain", "step", "per_tensor", "library", "library", "per_tensor", "step", "plain"):
        times[k].append(timed(arms[k]))
    split = kernel_split(ours.step)
    out = {f"{k}_ms": min(v) for k, v in times.items()}
    out.update(parameters=sum(p.numel() for p, _, _, _ in leaves), split_us=split)
    log(f"  one AdamW step over {len(shapes)} tensors ({out['parameters'] / 1e6:.1f} M "
        f"parameters): FusedAdamW.step {out['step_ms']:.3f} ms, per-tensor loop of "
        f"fused_adamw_update_ {out['per_tensor_ms']:.3f} ms, torch AdamW(fused=True) "
        f"{out['library_ms']:.3f} ms, plain {out['plain_ms']:.3f} ms (each the better of two "
        f"medians)")
    log("  FusedAdamW.step device time by kernel (profiler, no flush): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in split.items()))
    return out


#: the ResNet50-1K gradient on the wire: 25,557,032 float32 elements in 161
#: leaves, 25 buckets of 1,022,336 at the default 4 MiB
WIRE_SHAPE = (25, 1_022_336)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, NaNs compared by position (their payloads may differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = torch.where(nan, 0, a), torch.where(nan, 0, b)
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def quant_wire_phase(flush) -> list[dict]:
    """K5a, K5b (int8, int8 stochastic with the same noise, fp8) and K5c
    against their plain versions at the ResNet50-1K wire's (25, 1022336),
    at (3, 130) and on edge rows: amax and encode bit-equal, decode within
    1e-6 with NaN where the amax is not finite.  Then timed at the wire's
    shape beside the plain versions and, for K5a, the library's
    ``torch.linalg.vector_norm(v, inf, dim=1)``."""
    from tpuframe_torch.ops.quant_wire import (
        bucket_abs_max,
        bucket_abs_max_reference,
        quant_decode,
        quant_decode_reference,
        quant_encode,
        quant_encode_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    edges = torch.tensor([
        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127, -127, 0, -0.0, 3.5, 4.5, 100.5,
         -100.5],
        [1e-40, -3e-41, 2e-39, 0, 5e-45, -1e-38, 1e-39, 7e-42] + [0] * 8,
        [448, -448, 2 ** -9, 2 ** -10, 3 * 2 ** -10, 1, -1, 0.3, 17, 200, 300, 440, 447, 5.5, 6.5,
         232]], device=dev)
    cases = [("25x1022336", torch.randn(WIRE_SHAPE, generator=gen, device=dev) * 1e-3),
             ("3x130", torch.randn((3, 130), generator=gen, device=dev) * 9),
             ("edges", edges)]
    err = {"bucket_abs_max": 0.0, "quant_encode": 0.0, "quant_decode": 0.0}

    def max_diff(a, b):
        """Largest |a - b|, NaNs at the same places counted as 0."""
        return float((torch.nan_to_num(a.float()) - torch.nan_to_num(b.float())).abs().max())

    for name, v in cases:
        noise = torch.rand(v.shape, generator=gen, device=dev)
        amax = bucket_abs_max(v)
        want_amax = bucket_abs_max_reference(v)
        check(same_bits(amax, want_amax), f"K5a {name}: not bit-equal")
        err["bucket_abs_max"] = max(err["bucket_abs_max"], max_diff(amax, want_amax))
        bad = amax.clone()
        bad[0, 0] = float("nan")
        for mode, nz in (("int8", None), ("int8", noise), ("fp8", None)):
            tag = f"{name} {mode}{' stochastic' if nz is not None else ''}"
            q, d = quant_encode(v, amax, mode, noise=nz)
            wq, wd = quant_encode_reference(v, amax, mode, nz)
            check(same_bits(q, wq) and same_bits(d, wd), f"K5b {tag}: not bit-equal")
            err["quant_encode"] = max(err["quant_encode"], max_diff(q, wq), max_diff(d, wd))
            total = q * 2  # two ranks' worth
            for a in (amax, bad):
                got = quant_decode(total, a, mode, 2)
                want = quant_decode_reference(total, a, mode, 2)
                check(torch.equal(torch.isnan(got), torch.isnan(want))
                      and bool(torch.isnan(got[0]).all()) == (a is bad),
                      f"K5c {tag}: NaN rows differ")
                e = max_diff(got, want)
                check(e <= 1e-6, f"K5c {tag}: max abs diff {e} > 1e-6")
                err["quant_decode"] = max(err["quant_decode"], e)
        torch.cuda.synchronize()
        log(f"  quant_wire {name}: K5a and K5b (int8, int8 stochastic, fp8) bit-equal to the "
            f"plain versions; K5c within {err['quant_decode']:.3g} (tol 1e-6), NaN where amax "
            "is NaN")

    v, noise = cases[0][1], torch.rand(WIRE_SHAPE, generator=gen, device=dev)
    amax = bucket_abs_max(v)
    q8, _ = quant_encode(v, amax, "int8")
    qf, _ = quant_encode(v, amax, "fp8")
    lib = functools.partial(torch.linalg.vector_norm, v, float("inf"), dim=1, keepdim=True)
    check(same_bits(lib(), bucket_abs_max_reference(v)), "vector_norm(inf) yardstick differs")
    arms = {
        "bucket_abs_max": (functools.partial(bucket_abs_max, v),
                           functools.partial(bucket_abs_max_reference, v), lib),
        "quant_encode": (functools.partial(quant_encode, v, amax, "int8"),
                         functools.partial(quant_encode_reference, v, amax, "int8"), None),
        "quant_encode_stochastic": (functools.partial(quant_encode, v, amax, "int8", noise),
                                    functools.partial(quant_encode_reference, v, amax, "int8",
                                                      noise), None),
        "quant_encode_fp8": (functools.partial(quant_encode, v, amax, "fp8"),
                             functools.partial(quant_encode_reference, v, amax, "fp8"), None),
        "quant_decode": (functools.partial(quant_decode, q8 * 2, amax, "int8", 2),
                         functools.partial(quant_decode_reference, q8 * 2, amax, "int8", 2), None),
        "quant_decode_fp8": (functools.partial(quant_decode, qf * 2, amax, "fp8", 2),
                             functools.partial(quant_decode_reference, qf * 2, amax, "fp8", 2),
                             None),
    }
    n, nb = v.numel(), v.shape[0]
    # each input read once, each output written once (float32 or int32)
    moved = {"bucket_abs_max": 4 * n + 4 * nb, "quant_encode": 8 * n + 4 * nb,
             "quant_encode_stochastic": 12 * n + 4 * nb, "quant_encode_fp8": 8 * n + 4 * nb,
             "quant_decode": 8 * n + 4 * nb, "quant_decode_fp8": 8 * n + 4 * nb}
    times = {}
    for which, (kernel, plain, library) in arms.items():
        # plain, kernel, library, library, kernel, plain
        plain_ms = [time_ms(plain, flush, iters=30)]
        kernel_ms = [time_ms(kernel, flush)]
        library_ms = [time_ms(library, flush), time_ms(library, flush)] if library else []
        kernel_ms.append(time_ms(kernel, flush))
        plain_ms.append(time_ms(plain, flush, iters=30))
        bound_ms, bound_by = bound(moved[which], 5 * n)  # about 5 operations an element
        times[which] = {"ms": min(kernel_ms), "plain_ms": min(plain_ms),
                        "library_ms": min(library_ms) if library_ms else None,
                        "bound_ms": bound_ms, "bound_by": bound_by, "bytes_moved": moved[which]}
        t = times[which]
        log(f"  {which} 25x1022336: kernel {t['ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us"
            + (f", vector_norm(inf) {t['library_ms'] * 1e3:.2f} us" if library else "")
            + f", bound {bound_ms * 1e3:.2f} us ({moved[which] / 1e6:.1f} MB at 3.35 TB/s)")
    rows = []
    for which, line, shape, extra in (
            ("bucket_abs_max", 91, "25x1022336 f32 -> 25x1 f32", ()),
            ("quant_encode", 107, "25x1022336 f32 -> int32 (int8 grid)",
             ("quant_encode_stochastic", "quant_encode_fp8")),
            ("quant_decode", 125, "25x1022336 int32 (int8 grid) -> f32", ("quant_decode_fp8",))):
        row = {"name": which, "route": "cuda", "source": "tpuframe_torch/csrc/quant_wire.cu",
               "replaces": f"tpuframe/ops/quant_wire.py:{line}", "launches": None,
               "max_abs_err": err[which],
               **{k: times[which][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")},
               "shape": shape, "bytes_moved": times[which]["bytes_moved"]}
        for e in extra:
            row[e.removeprefix(which + "_")] = times[e]
        rows.append(row)
    del cases, v, noise, q8, qf
    return rows


#: bench_lm.py's long_ctx: the GPT-2-small widths at seq 8192, batch 2
LONG_LM = dict(vocab_size=32768, num_layers=12, num_heads=12, head_dim=64, max_len=8192)
LONG_BATCH = 2
#: K6's shapes on the paths: the long-context LM's causal attention, and
#: ViT-B/16's bidirectional attention at the serve bucket of 64
ATTN_PATH = (LONG_BATCH, LONG_LM["max_len"], LONG_LM["num_heads"], LONG_LM["head_dim"])
ATTN_VIT = (64, 196, 12, 64)
# K6 against its plain version run in float32 on the same inputs: in f32
# the sums run in another order over other tiles (1e-5 forward, 1e-4 for
# the gradients); in bf16 the kernel may be at most twice as far from the
# f32 result as the plain bf16 run (the same roundings at the same places,
# other sums before them); lse is float32 on both sides (1e-5)
K6_F32_FWD_TOL = 1e-5
K6_F32_BWD_TOL = 1e-4
K6_BF16_FACTOR = 2.0
#: K6a at large logits (q scaled by 8, causal): lse against the float64
#: logsumexp, since there the float32 plain run's own sums round it by as
#: much as 1e-5 (lse ~ 40, a few float32 steps) and a kernel that sums in
#: another order lands elsewhere; within 1e-5 of it, or no further than
#: twice the float32 plain run (the bf16 rule's form)
K6_LARGE_LOGITS = ((2, 1000, 3, 64), (2, 1000, 2, 128))


def lse_float64(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """The logsumexp (B, H, L) of the scaled scores in float64 over the same
    values: what every float32 lse of attention approximates."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(q.shape[-1])
    if causal:
        l = q.shape[1]
        s = s.masked_fill(~torch.ones(l, l, dtype=torch.bool, device=q.device).tril(), -math.inf)
    return torch.logsumexp(s, -1)


def blockwise_phase(flush, baseline) -> list[dict]:
    """K6a (forward), K6b (delta and dQ) and K6c (dK and dV) against the
    plain schedule on the card: at the long-context path's (2, 8192, 12,
    64) bf16 causal, ViT's (64, 196, 12, 64) bf16 bidirectional, and ragged
    L = 13 and 1000 in f32 and bf16, causal and not; two runs bit-equal;
    K6a at large logits, its lse against the float64 logsumexp
    (``K6_LARGE_LOGITS``).  At the path's shape ``baseline`` (K6's FMA
    design, ``BASELINE_K6``) is held to the same bf16 rule on the same
    inputs.
    Then timed at the path's shape beside the plain passes,
    ``F.scaled_dot_product_attention(is_causal=True)`` (forward, and its
    autograd backward, which computes dQ, dK and dV together) and the
    baseline, in turns."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.blockwise_attention import (
        _CODES,
        _bwd_dkv_reference,
        _bwd_dq_reference,
        _delta,
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_bwd_reference,
        blockwise_attention_fwd,
        blockwise_attention_reference,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)

    def inputs(shape, dtype):
        return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)
                for _ in range(4)]

    def kernels(q, k, v, g, causal):
        out, lse = blockwise_attention_fwd(q, k, v, causal=causal)
        dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=causal)
        dk, dv = blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=causal)
        return out, lse, dq, dk, dv

    def plain(q, k, v, g, causal):
        out, lse = blockwise_attention_reference(q, k, v, causal=causal)
        return (out, lse, *blockwise_attention_bwd_reference(q, k, v, out, lse, g, causal=causal))

    def launch_baseline(fn, ptrs, q, causal):
        b, l, h, d = q.shape
        rc = fn(*(t.data_ptr() for t in ptrs), b, l, h, d, int(causal), 1.0 / math.sqrt(d),
                _CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"baseline K6 launch failed: CUDA error {rc}")

    def baseline_fwd(q, k, v, causal):
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=dev)
        launch_baseline(baseline.tf_blockwise_attention_baseline_fwd, (q, k, v, out, lse), q,
                        causal)
        return out, lse

    def baseline_dq(q, k, v, out, lse, g, causal):
        dq = torch.empty_like(q)
        delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)
        launch_baseline(baseline.tf_blockwise_attention_baseline_bwd_dq,
                        (q, k, v, out, g, lse, dq, delta), q, causal)
        return dq, delta

    def baseline_dkv(q, k, v, lse, delta, g, causal):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        launch_baseline(baseline.tf_blockwise_attention_baseline_bwd_dkv,
                        (q, k, v, g, lse, delta, dk, dv), q, causal)
        return dk, dv

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("2x8192x12x64 bf16 causal", ATTN_PATH, bf16, True),
             ("64x196x12x64 bf16", ATTN_VIT, bf16, False)]
    cases += [(f"2x{l}x3x64 {str(dt)[6:]}{' causal' if c else ''}", (2, l, 3, 64), dt, c)
              for l in (13, 1000) for dt in (f32, bf16) for c in (True, False)]
    path_err = None
    for name, shape, dtype, causal in cases:
        q, k, v, g = inputs(shape, dtype)
        got = kernels(q, k, v, g, causal)
        torch.cuda.synchronize()
        check([t.dtype for t in got] == [dtype, f32, dtype, dtype, dtype],
              f"K6 {name}: dtypes {[t.dtype for t in got]}")
        want = plain(*(t.float() for t in (q, k, v, g)), causal)
        err = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
        check(all(math.isfinite(e) for e in err), f"K6 {name}: non-finite error {err}")
        if dtype == f32:
            ok = err[0] <= K6_F32_FWD_TOL and err[1] <= K6_F32_FWD_TOL and max(err[2:]) <= K6_F32_BWD_TOL
            tol = f"tol {K6_F32_FWD_TOL} out/lse, {K6_F32_BWD_TOL} gradients"
        else:
            ref = [float((a.float() - w).abs().max()) for a, w in zip(plain(q, k, v, g, causal), want)]
            ok = err[1] <= K6_F32_FWD_TOL and all(
                err[i] <= K6_BF16_FACTOR * ref[i] for i in (0, 2, 3, 4))
            tol = (f"plain bf16 {[f'{e:.3g}' for e in ref]}, tol {K6_BF16_FACTOR}x that "
                   f"(lse {K6_F32_FWD_TOL})")
        log(f"  blockwise attention {name}: out/lse/dq/dk/dv max abs diff from the f32 plain "
            f"version {[f'{e:.3g}' for e in err]} ({tol})")
        check(ok, f"K6 {name}: errors {err} ({tol})")
        again = kernels(q, k, v, g, causal)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K6 {name}: a rerun gave other bits")
        if shape == ATTN_PATH:
            path_err = err
            # the baseline's K6a, and its K6b and K6c from the kernels'
            # forward, to the same rule
            base = baseline_fwd(q, k, v, causal)
            bdq, bdelta = baseline_dq(q, k, v, got[0], got[1], g, causal)
            base += (bdq, *baseline_dkv(q, k, v, got[1], bdelta, g, causal))
            base_err = [float((a.float() - w).abs().max()) for a, w in zip(base, want)]
            apart = [float((a.float() - b_.float()).abs().max()) for a, b_ in zip(base, got)]
            log(f"  baseline K6 {name}: out/lse/dq/dk/dv max abs diff from the f32 plain version "
                f"{[f'{e:.3g}' for e in base_err]}, from the kernels "
                f"{[f'{e:.3g}' for e in apart]} (tol {K6_BF16_FACTOR}x the plain bf16 run's, "
                f"lse {K6_F32_FWD_TOL})")
            check(base_err[1] <= K6_F32_FWD_TOL and all(
                base_err[i] <= K6_BF16_FACTOR * ref[i] for i in (0, 2, 3, 4)),
                f"baseline K6 {name}: errors {base_err}, plain bf16 {ref}")
            del bdq, bdelta, base
        del q, k, v, g, got, want, again
    for shape in K6_LARGE_LOGITS:
        q, k, v, _ = inputs(shape, bf16)
        q = q * 8  # exact in bf16
        name = f"{'x'.join(map(str, shape))} bf16 causal, q x 8"
        want, plain_bf16 = (blockwise_attention_reference(*(t.float() for t in (q, k, v)),
                                                          causal=True),
                            blockwise_attention_reference(q, k, v, causal=True))
        runs = {"K6a": blockwise_attention_fwd(q, k, v, causal=True),
                "baseline": baseline_fwd(q, k, v, True), "plain f32": want}
        exact = lse_float64(q, k, True)
        lse_err = {n: float((r[1].double() - exact).abs().max()) for n, r in runs.items()}
        out_err = float((runs["K6a"][0].float() - want[0]).abs().max())
        out_ref = float((plain_bf16[0].float() - want[0]).abs().max())
        lse_tol = max(K6_F32_FWD_TOL, K6_BF16_FACTOR * lse_err["plain f32"])
        log(f"  blockwise attention forward {name}: lse max abs diff from the float64 "
            f"logsumexp {', '.join(f'{n} {e:.3g}' for n, e in lse_err.items())} (K6a's tol "
            f"{lse_tol:.3g}); K6a out {out_err:.3g} from the f32 plain version (plain bf16 "
            f"{out_ref:.3g}, tol {K6_BF16_FACTOR}x that)")
        check(lse_err["K6a"] <= lse_tol and out_err <= K6_BF16_FACTOR * out_ref,
              f"K6a {name}: lse {lse_err['K6a']} (tol {lse_tol}), out {out_err} (plain bf16 "
              f"{out_ref})")
        del q, k, v, want, plain_bf16, runs, exact
    torch.cuda.empty_cache()

    # -- timed at the path's shape: (2, 8192, 12, 64) bf16, causal ------------
    q, k, v, g = inputs(ATTN_PATH, bf16)
    out, lse = blockwise_attention_fwd(q, k, v, causal=True)
    dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=True)
    plain_delta = _delta(out, g)
    heads = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    g_heads = g.transpose(1, 2).contiguous()
    lib_out = F.scaled_dot_product_attention(*heads, is_causal=True)
    lib_err = float((lib_out.detach().transpose(1, 2).float() - out.float()).abs().max())
    log(f"  F.scaled_dot_product_attention yardstick: {lib_err:.3g} max abs from K6a's output")
    arms = {
        "fwd": (lambda: blockwise_attention_fwd(q, k, v, causal=True),
                lambda: blockwise_attention_reference(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(*heads, is_causal=True),
                lambda: baseline_fwd(q, k, v, True)),
        "dq": (lambda: blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=True),
               lambda: _bwd_dq_reference(q, k, v, lse, _delta(out, g), g, True, None), None,
               lambda: baseline_dq(q, k, v, out, lse, g, True)),
        "dkv": (lambda: blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=True),
                lambda: _bwd_dkv_reference(q, k, v, lse, plain_delta, g, True, None), None,
                lambda: baseline_dkv(q, k, v, lse, delta, g, True)),
    }
    times = {}
    for which, (kernel, plain_fn, library, base) in arms.items():
        # plain, kernel, [library, library,] baseline, baseline, kernel, plain
        plain_ms = [time_ms(plain_fn, flush, iters=3, warmup=1)]
        kernel_ms = [time_ms(kernel, flush, iters=20, warmup=2)]
        if library is not None:
            times[which + "_library"] = min(time_ms(library, flush, iters=20, warmup=2)
                                            for _ in range(2))
        times[which + "_baseline"] = min(time_ms(base, flush, iters=10, warmup=1)
                                         for _ in range(2))
        kernel_ms.append(time_ms(kernel, flush, iters=20, warmup=2))
        plain_ms.append(time_ms(plain_fn, flush, iters=3, warmup=1))
        times[which], times[which + "_plain"] = min(kernel_ms), min(plain_ms)
    lib_bwd = lambda: torch.autograd.grad(lib_out, heads, g_heads, retain_graph=True)  # noqa: E731
    times["bwd_library"] = min(time_ms(lib_bwd, flush, iters=20, warmup=2) for _ in range(2))

    b, l, h, d = ATTN_PATH
    product = 2 * b * h * (l * l / 2) * d  # one causal product: the visible half of L^2
    elem, rows = b * l * h * d * 2, b * h * l * 4  # bf16 tensors, float32 rows
    work = {"fwd": (4 * elem + rows, 2 * product),  # q, k, v in, out; lse
            "dq": (6 * elem + 2 * rows, 3 * product),  # q, k, v, out, g in, dq; lse, delta
            "dkv": (6 * elem + 2 * rows, 4 * product)}  # q, k, v, g in, dk, dv; lse, delta
    fa2_bwd_ms = 5 * product / BF16_FLOPS * 1e3  # FlashAttention-2's five backward products
    names = {"fwd": ("blockwise_attention_fwd", 64), "dq": ("blockwise_attention_bwd_dq", 150),
             "dkv": ("blockwise_attention_bwd_dkv", 180)}
    errs = {"fwd": path_err[0], "dq": path_err[2], "dkv": max(path_err[3:])}
    rows_out = []
    for which, (name, line) in names.items():
        moved, flops = work[which]
        by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        r = {"name": name, "route": "cuda", "source": "tpuframe_torch/csrc/blockwise_attention.cu",
             "replaces": f"tpuframe/ops/blockwise_attention.py:{line}", "launches": None,
             "max_abs_err": errs[which], "ms": times[which], "plain_ms": times[which + "_plain"],
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "operations" if by_ops >= by_bytes else "bytes",
             "library_ms": times["fwd_library"] if which == "fwd" else times["bwd_library"],
             "shape": "2x8192x12x64 bf16 causal", "bytes_moved": moved, "flops": flops}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r.update(baseline_ms=times[which + "_baseline"], speedup=times[which + "_baseline"] / r["ms"])
        if which != "fwd":
            r.update(library_covers="dQ, dK and dV together (SDPA's autograd backward)",
                     backward_ms=times["dq"] + times["dkv"], fa2_backward_bound_ms=fa2_bwd_ms)
        log(f"  {name} 2x8192x12x64 bf16 causal: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, baseline "
            f"{r['baseline_ms']:.3f} ms ({r['speedup']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ms ({100 * r['bound_share']:.1f} %; {flops / 1e9:.1f} GFLOP "
            f"at 989 TFLOP/s; {moved / 1e6:.1f} MB at 3.35 TB/s)")
        rows_out.append(r)
    pair_bound = (work["dq"][1] + work["dkv"][1]) / BF16_FLOPS * 1e3
    log(f"  blockwise attention backward (K6b + K6c): {times['dq'] + times['dkv']:.3f} ms "
        f"(baseline {times['dq_baseline'] + times['dkv_baseline']:.3f} ms) against its 7 "
        f"products' {pair_bound:.4f} ms, FlashAttention-2's five products {fa2_bwd_ms:.3f} ms "
        f"and SDPA's backward {times['bwd_library']:.3f} ms")
    return rows_out


def dev_us(e) -> float:
    """Device µs of one ``key_averages()`` entry."""
    return float(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0))


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without namespace, template arguments
    or parameters."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", key, maxsplit=1)[0].strip()


def kernel_split(fn, calls: int = 20) -> dict:
    """Device µs that one call of ``fn`` spends in each CUDA kernel, by
    kernel name (``torch.profiler`` over ``calls`` calls after a warm one;
    no L2 flush between them)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            name = kernel_name(e.key)
            split[name] = split.get(name, 0.0) + dev_us(e) / calls
    return split


def profile(fn, what: str, top: int = 12, also: tuple = ()) -> dict:
    """Where one call of ``fn`` spends its time: host wall time of the call
    (after one warm call), device time summed over its kernels
    (``torch.profiler``), the kernels with the most device time, and every
    kernel whose name holds one of ``also`` (returned by name)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"  profile, {what}: wall {wall_ms:.2f} ms, device "
        f"{total_ms:.2f} ms over {launches} kernel launches "
        f"(device busy {total_ms / wall_ms:.0%} of wall)")
    ranked = sorted(kernels, key=dev_us, reverse=True)
    named = {}
    for i, e in enumerate(ranked):
        if i < top or any(a in e.key for a in also):
            log(f"    {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")
        if any(a in e.key for a in also):
            named[kernel_name(e.key)] = {"ms": dev_us(e) / 1e3, "count": e.count}
    return {"wall_ms": wall_ms, "device_ms": total_ms, "launches": launches, "named": named}


def slice_phase(card: str) -> dict:
    """Phase 4: ResNet50-1K served (K1 once a batch, nothing else)."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.models import ResNet50, from_jax_variables, import_torch_resnet

    dev = initialize().device
    model = ResNet50(num_classes=1000, device=dev)
    variables = random_jax_variables(import_torch_resnet(model.state_dict()), seed=0)
    model.load_state_dict(from_jax_variables(variables))
    return serve_phase(card, model, "ResNet50-1K", {"normalize": 1})


def vit_serve_phase(card: str) -> dict:
    """Phase 11: ViT-B/16-1K (random weights from a seed) served: K1 once a
    batch, K3a 25 times a forward (``ln1`` and ``ln2`` of 12 blocks and
    ``ln_f``); at 196 tokens ``auto`` is full attention, so K6 never."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.models import ViT_B16

    dev = initialize().device
    model = ViT_B16(num_classes=1000, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  ViT-B/16: {n_params / 1e6:.2f} M parameters, 196 tokens at 224 px")
    return serve_phase(card, model, "ViT-B/16-1K", {"normalize": 1, "layer_norm_fwd": 25})


def serve_phase(card: str, model, what: str, per_batch: dict) -> dict:
    """``model`` under ``bf16_compute`` behind ``ServeEngine`` (buckets
    1/8/32/64) and ``ServingServer``: 160 uint8 224x224 requests from 4
    client threads plus one ``POST /predict``, every kernel counter zeroed
    just before and read just after (``per_batch`` launches a served batch,
    the others none); served rows against direct predicts and predicts
    through the plain normalize; an f32 forward on the card against the
    CPU.  Returns the launch counts."""
    from tpuframe_torch.ops.blockwise_attention import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
    )
    from tpuframe_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference
    from tpuframe_torch.parallel import align_model_dtype, bf16_compute, full_precision
    from tpuframe_torch.serve import ServeEngine, ServeKnobs, ServingServer
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import make_predict_fn

    dev = next(model.parameters()).device
    counters = {"normalize": normalize_images, "layer_norm_fwd": layer_norm_fwd,
                "layer_norm_bwd": layer_norm_bwd, "blockwise_attention_fwd": blockwise_attention_fwd,
                "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv}
    policy = bf16_compute()
    align_model_dtype(model, policy)
    predict = make_predict_fn(policy, functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=policy.compute_dtype))
    engine = ServeEngine(
        functools.partial(predict, model),
        knobs=ServeKnobs(buckets=BUCKETS, slo_ms=60_000, queue_cap=1024,
                         batch_wait_ms=5.0),
        item_shape=(224, 224, 3), dtype="uint8", device=dev,
    )
    t0 = time.perf_counter()
    engine.start()
    log(f"  engine warm-up over buckets {BUCKETS}: {time.perf_counter() - t0:.2f} s")
    server = ServingServer(engine)
    images = np.random.default_rng(1).integers(
        0, 256, (N_REQUESTS, 224, 224, 3), dtype=np.uint8)
    reg = get_telemetry().registry
    futures: dict[int, object] = {}

    submitted: dict[int, float] = {}

    def client(k: int) -> None:
        for i in range(k, N_REQUESTS, N_CLIENTS):
            futures[i] = engine.submit(images[i])
        submitted[k] = time.perf_counter()

    try:
        # the main path: counts zeroed just before, read just after
        for fn in counters.values():
            fn.launches = 0
        batches0 = reg.counter("serve/batches").value
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "client thread did not finish")
        served = {i: f.result(timeout=600) for i, f in futures.items()}
        wall = time.perf_counter() - t_start
        buf = io.BytesIO()
        np.save(buf, images[0])
        req = urllib.request.Request(server.url + "/predict", data=buf.getvalue(),
                                     method="POST", headers={"X-Deadline-Ms": "60000"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            status = resp.status
            http_out = np.asarray(json.loads(resp.read())["output"], np.float32)
        check(engine.drain(timeout=120), "engine did not drain")
        launches = {name: fn.launches for name, fn in counters.items()}
        batches = int(reg.counter("serve/batches").value - batches0)
        submit_s = max(submitted.values()) - t_start
    finally:
        server.close()
        engine.stop()

    check(status == 200, f"POST /predict answered {status}")
    lat = sorted(f.latency_s for f in futures.values())
    verdicts = {f.verdict for f in futures.values()}
    check(verdicts == {"ok"}, f"verdicts {verdicts}")
    check(len(served) == N_REQUESTS, f"{len(served)} of {N_REQUESTS} answered")
    for i, out in served.items():
        check(tuple(out.shape) == (1000,) and bool(torch.isfinite(out).all()),
              f"request {i}: shape {tuple(out.shape)} or non-finite logits")
    expected = {name: per_batch.get(name, 0) * batches for name in counters}
    check(batches > 0 and launches == expected,
          f"{what} serve launches {launches} for {batches} served batches, expected {expected}")
    log(f"  {what}: served {N_REQUESTS} + 1 HTTP requests in {batches} batches; "
        f"launches {launches}")
    infer = reg.histogram("span/serve/infer").window()[-batches:]
    occupancy = reg.histogram("serve/batch_occupancy").window()[-batches:]
    log(f"  all {N_REQUESTS} submitted after {submit_s * 1e3:.1f} ms; per batch: "
        f"occupancy {[round(o, 3) for o in occupancy]}, serve/infer ms "
        f"{[round(t * 1e3, 1) for t in infer]}")

    # -- correctness of the served rows (launches here are not counted) ----
    plain_predict = make_predict_fn(policy, functools.partial(
        normalize_images_reference, mean=MEAN, std=STD, out_dtype=policy.compute_dtype))
    worst = {"served vs direct": 0.0, "served vs plain-normalize predict": 0.0,
             "direct: kernel vs plain normalize": 0.0}
    for i, out in served.items():
        x = torch.from_numpy(images[i][None]).to(dev)
        direct = predict(model, x)[0].cpu()
        plain = plain_predict(model, x)[0].cpu()
        scale = float(direct.abs().max())
        for key, a, b in (("served vs direct", out, direct),
                          ("served vs plain-normalize predict", out, plain),
                          ("direct: kernel vs plain normalize", direct, plain)):
            worst[key] = max(worst[key], float((a - b).abs().max()) / scale)
    http_err = float(np.abs(http_out - served[0].numpy()).max()) / float(served[0].abs().max())
    for k, v in worst.items():
        log(f"  {k}: max |diff| / max|logit| = {v:.3g} (tol {BF16_REL_TOL})")
        check(v <= BF16_REL_TOL, f"{k} rel err {v} > {BF16_REL_TOL}")
    check(http_err <= BF16_REL_TOL, f"HTTP row rel err {http_err}")

    xb = torch.from_numpy(images[:BUCKETS[-1]]).to(dev)
    prof = profile(lambda: predict(model, xb), f"{what} predict of {tuple(xb.shape)}")

    # f32 on the card (TF32 off) against the same model on the CPU
    align_model_dtype(model, full_precision())
    predict32 = make_predict_fn(full_precision(), functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32))
    x2 = torch.from_numpy(images[:2])
    on_card = predict32(model, x2.to(dev)).cpu()
    model_cpu = model.to("cpu")
    on_cpu = predict32(model_cpu, x2)
    f32_err = float((on_card - on_cpu).abs().max()) / float(on_cpu.abs().max())
    log(f"  {what} f32 card vs CPU: max |diff| / max|logit| = {f32_err:.3g} (tol {F32_REL_TOL}), "
        f"max|logit| {float(on_cpu.abs().max()):.4g}")
    check(f32_err <= F32_REL_TOL, f"f32 card vs CPU rel err {f32_err}")

    ms = [v * 1e3 for v in lat]
    summary = {
        "model": what,
        "requests": N_REQUESTS,
        "clients": N_CLIENTS,
        "batches": batches,
        "req_per_s": N_REQUESTS / wall,
        "p50_ms": ms[len(ms) // 2],
        "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
        "launches": launches,
        "f32_card_vs_cpu": f32_err,
        "predict_64_device_ms": prof["device_ms"],
        "card": card,
    }
    log(f"  {what} serve: {summary['req_per_s']:.1f} req/s, p50 {summary['p50_ms']:.1f} ms, "
        f"p99 {summary['p99_ms']:.1f} ms over {N_REQUESTS} requests "
        f"({N_CLIENTS} clients, buckets {BUCKETS}) on {card}")
    log("  serve_json " + json.dumps(summary))
    return summary


#: the epoch summary keys of the JAX Trainer (health on, with eval)
SUMMARY_KEYS = {
    "train_loss", "train_accuracy", "train_samples_per_sec", "health_bad_steps", "grad_norm",
    "epoch_time_s", "data_wait_s", "dispatch_s", "host_block_s", "assemble_s", "h2d_s",
    "eval_loss", "eval_accuracy",
}
TRAIN_BATCH = 128
TRAIN_STEPS = 12
# f32 train steps, kernel against plain cross entropy, convolutions
# deterministic and TF32 off: the two differ only in the rounding of the
# cross entropy (~1e-7 relative).  The losses of two steps hold 1e-4
# relative; the parameters are held after the first step, within 1e-4 of
# the largest update: a freshly initialized ResNet50 takes updates of O(1)
# (gradient norm ~7e3 at lr 0.1), so the second step carries those
# roundings ~1e3-fold into the weights (3e-6 -> 1.3e-3 relative, measured
# on the CPU with the plain versions), and is only logged
CE_STEP_LOSS_RTOL = 1e-4
CE_STEP_PARAM_RTOL = 1e-4
# f32 train step on the card (TF32 off) against the CPU: the order of the
# sums differs.  The loss holds 1e-4 relative.  The update (parameters and
# BN statistics after one SGD step at lr 0.1) is held as a whole,
# ||card - cpu|| / ||cpu update|| <= 3e-2: this fresh ResNet18 at batch 8
# in train mode is ill-conditioned.  On the CPU alone, a 1e-6 change of
# the input, or another thread count, moves the update by 1.2e-3 on this
# measure and single tensors by ~1 %; the card changes the order of every
# sum (each op alone agrees with float64 to ~1e-7 on both), and gave 1.0e-2
CPU_STEP_LOSS_RTOL = 1e-4
CPU_STEP_UPDATE_RTOL = 3e-2


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_phase(card: str, dev: torch.device = torch.device("cuda"), image_size: int = 224,
                batch_size: int = TRAIN_BATCH, ce_px: int = 64) -> tuple[dict, dict]:
    """The train slice through ``Trainer.fit`` (main path, counted), then
    the step alone, the overfit check and the two f32 parity checks.
    Returns (launch counts, summary).  The device and sizes are arguments
    so the phase can be rehearsed small on the CPU."""
    import math

    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet18, ResNet50
    from tpuframe_torch.ops.cross_entropy import (
        cross_entropy_bwd,
        cross_entropy_fwd,
        cross_entropy_reference,
    )
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import Callback, Trainer, create_train_state, make_optimizer
    from tpuframe_torch.train.step import make_train_step

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, trainer, metrics):
            self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

    model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
    train = DataLoader(SyntheticImageDataset(n=batch_size * TRAIN_STEPS, image_size=image_size,
                                             num_classes=1000, seed=1),
                       batch_size, shuffle=True, seed=0, transfer_dtype="uint8", num_workers=8)
    eval_images = 2 * batch_size + 44 * batch_size // TRAIN_BATCH  # a ragged last batch
    evl = DataLoader(SyntheticImageDataset(n=eval_images, image_size=image_size,
                                           num_classes=1000, seed=2),
                     batch_size, drop_last=False, transfer_dtype="uint8", num_workers=8)
    steps = StepLosses()
    trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl, optimizer="sgd",
                      lr=0.1, precision="bf16", normalize=(MEAN, STD),
                      max_duration=f"{TRAIN_STEPS}ba", log_interval=1, callbacks=[steps])
    trainer.init_state()
    n_eval = len(evl)
    # -- the main path: counts zeroed just before, read just after ---------
    normalize_images.launches = cross_entropy_fwd.launches = cross_entropy_bwd.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    sync(dev)
    fit_s = time.perf_counter() - t0
    launches = {"normalize": normalize_images.launches,
                "cross_entropy_fwd": cross_entropy_fwd.launches,
                "cross_entropy_bwd": cross_entropy_bwd.launches}
    expected = {"normalize": TRAIN_STEPS + n_eval, "cross_entropy_fwd": TRAIN_STEPS + n_eval,
                "cross_entropy_bwd": TRAIN_STEPS}
    log(f"  fit: {TRAIN_STEPS} steps of {batch_size} + eval of {eval_images} images "
        f"({n_eval} batches) in {fit_s:.2f} s; launches {launches} (expected {expected})")
    check(launches == expected, f"train launches {launches} != {expected}")
    summary = result.history[-1]
    check(SUMMARY_KEYS <= set(summary), f"epoch summary lacks {SUMMARY_KEYS - set(summary)}")
    losses = steps.losses
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"step losses {losses}")
    check(abs(losses[0] - math.log(1000)) <= 1.0,
          f"first-step loss {losses[0]:.4f} not within 1.0 of ln 1000")
    check(summary["health_bad_steps"] == 0.0, f"{summary['health_bad_steps']} bad steps")
    log(f"  step losses {[round(v, 4) for v in losses]}")
    log("  epoch summary " + json.dumps({k: round(v, 6) for k, v in summary.items()}))

    # -- the train step alone on one device-resident batch ------------------
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8)).to(dev),
             "label": torch.from_numpy(rng.integers(0, 1000, batch_size)).to(dev)}
    state, step = trainer.state, trainer._train_step
    fixed = []
    for _ in range(10):  # ten steps on one batch: the overfit check
        state, m = step(state, batch)
        fixed.append(m["loss_sum"] / m["count"])
    fixed = [float(v) for v in torch.stack(fixed).cpu()]
    log(f"  ten steps on one batch: losses {[round(v, 4) for v in fixed]}")
    check(all(math.isfinite(v) for v in fixed) and fixed[-1] < fixed[0],
          f"ten steps on one batch did not lower the loss: {fixed}")
    for _ in range(3):
        state, _ = step(state, batch)
    times = []
    for _ in range(30):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    img_s = batch_size / (step_ms / 1e3)
    mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    log(f"  train step alone, batch {batch_size}: median {step_ms:.2f} ms over 30 steps "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = {img_s:.1f} img/s; "
        f"peak memory {mem_gb:.2f} GB on {card}")
    prof = profile(lambda: step(state, batch), f"train step of {batch_size} (bf16, health on)")
    del trainer, state, model, batch

    # -- kernel against plain cross entropy: f32 train steps on the card ----
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ce_model = ResNet50(num_classes=1000, device=dev, seed=4)
        twin = ResNet50(num_classes=1000, device=dev, seed=5)
        twin.load_state_dict(ce_model.state_dict())
        rng = np.random.default_rng(5)
        batches = [{"image": torch.from_numpy(rng.normal(0, 1, (32, ce_px, ce_px, 3)).astype(
                        np.float32)).to(dev),
                    "label": torch.from_numpy(rng.integers(0, 1000, 32)).to(dev)}
                   for _ in range(2)]
        sgd = make_optimizer("sgd", 0.1)
        start = [v.clone() for v in ce_model.state_dict().values()]
        kernel_state = create_train_state(ce_model, sgd)
        plain_state = create_train_state(twin, sgd)
        kernel_step = make_train_step(full_precision())
        plain_step = make_train_step(full_precision(), loss_fn=cross_entropy_reference)

        def param_diff():
            pairs = [(a, b, s0) for a, b, s0 in zip(ce_model.state_dict().values(),
                                                    twin.state_dict().values(), start)
                     if a.is_floating_point()]
            diff = max(float((a - b).abs().max()) for a, b, _ in pairs)
            update = max(float((a - s0).abs().max()) for a, _, s0 in pairs)
            return diff, diff / update

        worst_loss, param = 0.0, []
        for b in batches:
            kernel_state, km = kernel_step(kernel_state, b)
            plain_state, pm = plain_step(plain_state, b)
            kl, pl = float(km["loss_sum"]), float(pm["loss_sum"])
            worst_loss = max(worst_loss, abs(kl - pl) / abs(pl))
            param.append(param_diff())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"  f32 steps, kernel vs plain cross entropy (ResNet50-1K, 2 steps of 32 at {ce_px} px): "
        f"loss rel diff {worst_loss:.3g} (tol {CE_STEP_LOSS_RTOL}); params + BN stats after "
        f"step 1 max abs diff {param[0][0]:.3g} = {param[0][1]:.3g} of the largest update "
        f"(tol {CE_STEP_PARAM_RTOL}); after step 2 {param[1][0]:.3g} = {param[1][1]:.3g} "
        f"(logged only)")
    check(worst_loss <= CE_STEP_LOSS_RTOL, f"kernel vs plain CE loss rel diff {worst_loss}")
    check(param[0][1] <= CE_STEP_PARAM_RTOL, f"kernel vs plain CE params diff {param[0]}")
    del ce_model, twin, kernel_state, plain_state

    # -- an f32 train step on the card against the CPU -----------------------
    card_model = ResNet18(num_classes=10, num_filters=16, stem="cifar", device=dev, seed=6)
    cpu_model = ResNet18(num_classes=10, num_filters=16, stem="cifar", device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    start = [v.clone() for v in cpu_model.state_dict().values()]
    rng = np.random.default_rng(6)
    b_cpu = {"image": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 10, 8))}
    b_card = {k: v.to(dev) for k, v in b_cpu.items()}
    to_f32 = functools.partial(normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32)
    transform = lambda b: {**b, "image": to_f32(b["image"])}  # noqa: E731
    sgd = make_optimizer("sgd", 0.1)
    card_state, cm = make_train_step(full_precision(), batch_transform=transform)(
        create_train_state(card_model, sgd), b_card)
    cpu_state, pm = make_train_step(full_precision(), batch_transform=transform)(
        create_train_state(cpu_model, sgd), b_cpu)
    cpu_loss_err = abs(float(cm["loss_sum"]) - float(pm["loss_sum"])) / abs(float(pm["loss_sum"]))
    pairs = [(a.cpu(), b, s0) for a, b, s0 in zip(card_model.state_dict().values(),
                                                  cpu_model.state_dict().values(), start)
             if a.is_floating_point()]
    diff_sq = sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs)
    update_sq = sum(float(((b - s0) ** 2).sum()) for _, b, s0 in pairs)
    cpu_update_err = math.sqrt(diff_sq / update_sq)
    cpu_entry_err = max(float((a - b).abs().max()) for a, b, _ in pairs)
    log(f"  f32 train step, card vs CPU (ResNet18 cifar, 32 px, batch 8): loss rel diff "
        f"{cpu_loss_err:.3g} (tol {CPU_STEP_LOSS_RTOL}), update rel diff {cpu_update_err:.3g} "
        f"(tol {CPU_STEP_UPDATE_RTOL}); largest single entry diff {cpu_entry_err:.3g}")
    check(cpu_loss_err <= CPU_STEP_LOSS_RTOL, f"card vs CPU loss rel diff {cpu_loss_err}")
    check(cpu_update_err <= CPU_STEP_UPDATE_RTOL, f"card vs CPU update rel diff {cpu_update_err}")

    out = {
        "img_per_s": img_s,
        "step_ms": step_ms,
        "batch": batch_size,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "fixed_batch_losses": [fixed[0], fixed[-1]],
        "fit_s": fit_s,
        "train_samples_per_sec_fit": summary["train_samples_per_sec"],
        "eval_loss": summary["eval_loss"],
        "profile": prof,
        "peak_memory_gb": mem_gb,
        "kernel_vs_plain_ce": {"loss_rel": worst_loss, "param_step1": param[0],
                               "param_step2": param[1]},
        "card_vs_cpu": {"loss_rel": cpu_loss_err, "update_rel": cpu_update_err,
                        "entry_abs": cpu_entry_err},
        "card": card,
    }
    log("  train_json " + json.dumps(out))
    return launches, out


#: the GPT-2-small LM of ``benchmarks/bench_lm.py`` ("gpt_small")
LM = dict(vocab_size=32768, num_layers=12, num_heads=12, head_dim=64, max_len=1024)
LM_BATCH = 16
LM_STEPS = 12
#: kernel against plain LayerNorm and AdamW: two f32 steps of a 2-layer LM
#: at the path's width, vocabulary and a shorter sequence
LM_PLAIN = dict(vocab_size=32768, num_layers=2, num_heads=12, head_dim=64, max_len=256)
#: the f32 LM step on the card against the CPU
LM_CPU = dict(vocab_size=512, num_layers=2, num_heads=4, head_dim=32, max_len=64)
# f32 LM steps, kernel against plain LayerNorm and AdamW: the two differ in
# the rounding of LayerNorm's sums and of the AdamW expression (~1e-7
# relative).  Losses hold 1e-5 relative.  The parameters are held as a
# whole, ||kernel - plain|| within 1e-4 of the update's norm after each of
# two steps.  AdamW runs with eps 1e-3 here: Adam's update is lr * m /
# (sqrt(v) + eps), and at the default 1e-8 a gradient element that is only
# rounding noise (a sum that is zero in exact arithmetic, ~1e-9) is scaled
# up to a step of order lr on either side, which alone moved the update
# 1.4e-4 of its norm between the two arms on the CPU
LM_STEP_LOSS_RTOL = 1e-5
LM_STEP_UPDATE_RTOL = 1e-4
LM_STEP_ADAMW = dict(eps=1e-3, weight_decay=1e-4)
# the small f32 LM step, card (TF32 off) against the CPU, with the same
# AdamW settings: the order of every sum differs; the loss holds 1e-4
# relative and the update 1e-3 of its norm
LM_CPU_UPDATE_RTOL = 1e-3


class SyntheticTokenDataset:
    """Example 06's deterministic next-token streams
    (``examples/06_lm_sequence_parallel.py``): token t+1 = (start + stride *
    t) mod vocab, keyed by index."""

    def __init__(self, n: int, seq_len: int, vocab: int, seed: int = 0):
        self.n, self.seq_len, self.vocab, self.seed = n, seq_len, vocab, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 100_003 + i)
        start = int(rng.integers(0, self.vocab))
        stride = int(rng.integers(1, 7))
        toks = (start + stride * np.arange(self.seq_len + 1)) % self.vocab
        return toks.astype(np.int32)


class NextTokenDataset(SyntheticTokenDataset):
    """(input, label) next-token pairs."""

    def __getitem__(self, i: int):
        toks = super().__getitem__(i)
        return toks[:-1], toks[1:]


def plain_adamw(lr: float, **hp):
    """An ``OptimizerSpec`` whose optimizer runs the plain AdamW update in
    place of K4: the other arm of the kernel-against-plain check."""
    from tpuframe_torch.ops.fused_adamw import FusedAdamW, fused_adamw_update_reference
    from tpuframe_torch.train import OptimizerSpec

    class PlainAdamW(FusedAdamW):
        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                kw = {k: group[k] for k in ("lr", "b1", "b2", "eps", "weight_decay")}
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    st = self.state[p]
                    st["count"] += 1
                    new = fused_adamw_update_reference(p, p.grad, st["mu"], st["nu"],
                                                       st["count"], **kw)
                    for t, n in zip((p, st["mu"], st["nu"]), new):
                        t.copy_(n)

    return OptimizerSpec(lambda params: PlainAdamW(params, lr, **hp), lr)


def plain_layer_norm(module, x: torch.Tensor) -> torch.Tensor:
    """``FusedLayerNorm.forward`` through the plain version (autograd of
    plain tensor ops) in place of K3a and K3b."""
    from tpuframe_torch.ops.layer_norm import layer_norm_reference

    return layer_norm_reference(x, module.scale, module.bias, module.epsilon).to(module.dtype)


def lm_breakdown(cfg: dict, batch_size: int, dev: torch.device) -> dict:
    """Device time of two parts of the LM step at its shapes: the
    materialized attention (``attention_reference`` forward and backward,
    bf16) of one layer, and the head (``lm_head`` product, f32 logits, the
    per-position loss, and their backward)."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.ring_attention import attention_reference
    from tpuframe_torch.train.step import cross_entropy

    b, l, h, dh, v = (batch_size, cfg["max_len"], cfg["num_heads"], cfg["head_dim"],
                      cfg["vocab_size"])
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    q, k, vv = (rand(b, l, h, dh).requires_grad_(True) for _ in range(3))
    g_out = rand(b, l, h, dh)
    x = rand(b, l, h * dh).requires_grad_(True)
    w = rand(v, h * dh, scale=(h * dh) ** -0.5).requires_grad_(True)
    labels = torch.randint(0, v, (b, l), generator=gen, device=dev)

    def attention():
        torch.autograd.grad(attention_reference(q, k, vv, causal=True), (q, k, vv), g_out)

    def head():
        logits = F.linear(x, w).float()
        torch.autograd.grad(cross_entropy(logits, labels).mean(), (x, w))

    no_flush = torch.empty(1, device=dev)
    attn_ms = time_ms(attention, no_flush, iters=10, warmup=2)
    head_ms = time_ms(head, no_flush, iters=10, warmup=2)
    return {"attention_ms_per_layer": attn_ms, "attention_ms": attn_ms * cfg["num_layers"],
            "head_ms": head_ms}


def lm_phase(card: str, dev: torch.device = torch.device("cuda"), cfg: dict = LM,
             batch_size: int = LM_BATCH, plain_cfg: dict = LM_PLAIN,
             plain_batch: int = 4) -> tuple[dict, dict]:
    """The LM train slice through ``Trainer.fit`` (main path, counted), then
    the step alone, the overfit check and the two f32 parity checks.
    Returns (launch counts, summary).  The device and sizes are arguments
    so the phase can be rehearsed small on the CPU."""
    import math

    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import (
        FusedLayerNorm,
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
        cross_entropy_bwd,
        cross_entropy_fwd,
        fused_adamw,
        fused_adamw_multi_update_,
        layer_norm_bwd,
        layer_norm_fwd,
        normalize_images,
    )
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import Callback, Trainer, create_train_state, make_train_step

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, trainer, metrics):
            self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

    seq, vocab, layers = cfg["max_len"], cfg["vocab_size"], cfg["num_layers"]
    model = TransformerLM(**cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    n_leaves = len(list(model.parameters()))
    train = DataLoader(NextTokenDataset(batch_size * LM_STEPS, seq, vocab, seed=1), batch_size,
                       shuffle=True, seed=0, num_workers=4)
    eval_n = 2 * batch_size + 5  # a ragged last batch
    evl = DataLoader(NextTokenDataset(eval_n, seq, vocab, seed=2), batch_size, drop_last=False,
                     num_workers=4)
    steps = StepLosses()
    trainer = Trainer(model, tx=fused_adamw(3e-4, weight_decay=1e-4), train_dataloader=train,
                      eval_dataloader=evl, precision="bf16", max_duration=f"{LM_STEPS}ba",
                      log_interval=1, callbacks=[steps])
    trainer.init_state()
    n_eval = len(evl)
    counters = {"layer_norm_fwd": layer_norm_fwd, "layer_norm_bwd": layer_norm_bwd,
                "fused_adamw": fused_adamw_multi_update_, "normalize": normalize_images,
                "cross_entropy_fwd": cross_entropy_fwd, "cross_entropy_bwd": cross_entropy_bwd,
                "blockwise_attention_fwd": blockwise_attention_fwd,
                "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv}
    # -- the main path: counts zeroed just before, read just after ---------
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    sync(dev)
    fit_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    n_ln = 2 * layers + 1  # ln1 and ln2 of every block, ln_f
    expected = {"layer_norm_fwd": n_ln * (LM_STEPS + n_eval), "layer_norm_bwd": n_ln * LM_STEPS,
                "fused_adamw": LM_STEPS, "normalize": 0, "cross_entropy_fwd": 0,
                "cross_entropy_bwd": 0, "blockwise_attention_fwd": 0,
                "blockwise_attention_bwd_dq": 0, "blockwise_attention_bwd_dkv": 0}
    log(f"  LM fit: {n_params / 1e6:.1f} M parameters in {n_leaves} tensors, {LM_STEPS} steps "
        f"of {batch_size}x{seq} tokens + eval of {eval_n} sequences ({n_eval} batches) in "
        f"{fit_s:.2f} s; launches {launches} (expected {expected})")
    check(launches == expected, f"LM launches {launches} != {expected}")
    summary = result.history[-1]
    check(SUMMARY_KEYS <= set(summary), f"epoch summary lacks {SUMMARY_KEYS - set(summary)}")
    losses = steps.losses
    check(len(losses) == LM_STEPS and all(math.isfinite(v) for v in losses),
          f"step losses {losses}")
    # the JAX model at init gives ln(vocab) + ~0.5 (logits of unit spread):
    # 10.84 for vocab 32768 on the CPU at 2 layers, width 768
    check(abs(losses[0] - math.log(vocab)) <= 1.0,
          f"first-step loss {losses[0]:.4f} not within 1.0 of ln {vocab} = {math.log(vocab):.4f}")
    check(summary["health_bad_steps"] == 0.0, f"{summary['health_bad_steps']} bad steps")
    check(math.isfinite(summary["eval_loss"]), f"eval loss {summary['eval_loss']}")
    log(f"  step losses {[round(v, 4) for v in losses]}")
    log("  epoch summary " + json.dumps({k: round(v, 6) for k, v in summary.items()}))

    # -- the train step alone on one device-resident batch ------------------
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    state, step = trainer.state, trainer._train_step
    fixed = []
    for _ in range(10):  # ten steps on one batch: the overfit check
        state, m = step(state, batch)
        fixed.append(m["loss_sum"] / m["count"])
    fixed = [float(v) for v in torch.stack(fixed).cpu()]
    log(f"  ten steps on one batch: losses {[round(v, 4) for v in fixed]}")
    check(all(math.isfinite(v) for v in fixed) and fixed[-1] < fixed[0],
          f"ten steps on one batch did not lower the loss: {fixed}")
    for _ in range(3):
        state, _ = step(state, batch)
    times = []
    for _ in range(30):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    tokens = batch_size * seq
    tok_s = tokens / (step_ms / 1e3)
    # 6 N T for the parameters' products, plus attention's QK^T and PV,
    # forward and backward (3 x 4 B H L^2 Dh per layer)
    model_flops = 6 * n_params * tokens
    attn_flops = 3 * 4 * batch_size * cfg["num_heads"] * seq * seq * cfg["head_dim"] * layers
    mfu = (model_flops + attn_flops) / (step_ms / 1e3) / BF16_FLOPS
    mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    log(f"  LM train step alone, batch {batch_size}x{seq}: median {step_ms:.2f} ms over 30 steps "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = {tok_s:.0f} tokens/s; "
        f"MFU {mfu:.4f} ({(model_flops + attn_flops) / 1e12:.2f} TFLOP per step at 989 "
        f"TFLOP/s); peak memory {mem_gb:.2f} GB on {card}")
    prof = profile(lambda: step(state, batch), f"LM train step of {batch_size}x{seq} "
                   "(bf16, health on)", top=30, also=("ln_bwd", "ln_fwd", "adamw"))
    del trainer, state, step, model, batch, toks
    parts = {}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        parts = lm_breakdown(cfg, batch_size, dev)
        log(f"  at the step's shapes: attention forward+backward "
            f"{parts['attention_ms_per_layer']:.3f} ms a layer, {parts['attention_ms']:.2f} ms "
            f"for {layers} layers "
            f"({parts['attention_ms'] / step_ms:.1%} of the step); lm_head + f32 logits + loss "
            f"and backward {parts['head_ms']:.2f} ms ({parts['head_ms'] / step_ms:.1%})")

    # -- kernel against plain LayerNorm and AdamW: f32 LM steps -------------
    kernel_model = TransformerLM(**plain_cfg, device=dev, seed=4)
    plain_model = TransformerLM(**plain_cfg, device=dev, seed=5)
    plain_model.load_state_dict(kernel_model.state_dict())
    for m in plain_model.modules():
        if isinstance(m, FusedLayerNorm):
            m.forward = functools.partial(plain_layer_norm, m)
    start = [p.detach().clone() for p in kernel_model.parameters()]
    kernel_state = create_train_state(kernel_model, fused_adamw(1e-3, **LM_STEP_ADAMW))
    plain_state = create_train_state(plain_model, plain_adamw(1e-3, **LM_STEP_ADAMW))
    f32_step = make_train_step(full_precision())
    prng = np.random.default_rng(5)
    pv, pl_ = plain_cfg["vocab_size"], plain_cfg["max_len"]
    worst_loss, update_rel = 0.0, []
    for _ in range(2):
        t = torch.from_numpy(prng.integers(0, pv, (plain_batch, pl_ + 1))).to(dev)
        b = {"image": t[:, :-1], "label": t[:, 1:]}
        kernel_state, km = f32_step(kernel_state, b)
        before = {n: fn.launches for n, fn in counters.items()}
        plain_state, pm = f32_step(plain_state, b)
        check({n: fn.launches for n, fn in counters.items()} == before,
              "the plain LM step launched a kernel")
        kl, pl = float(km["loss_sum"]), float(pm["loss_sum"])
        worst_loss = max(worst_loss, abs(kl - pl) / abs(pl))
        with torch.no_grad():
            diff = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in
                                 zip(kernel_model.parameters(), plain_model.parameters())))
            upd = math.sqrt(sum(float(((b - s0) ** 2).sum()) for b, s0 in
                                zip(plain_model.parameters(), start)))
        update_rel.append(diff / upd)
    log(f"  f32 LM steps, kernel vs plain LayerNorm and AdamW ({plain_cfg['num_layers']} layers, "
        f"{plain_batch}x{pl_}): loss rel diff {worst_loss:.3g} (tol {LM_STEP_LOSS_RTOL}); "
        f"||kernel - plain|| / ||update|| after step 1 {update_rel[0]:.3g}, step 2 "
        f"{update_rel[1]:.3g} (tol {LM_STEP_UPDATE_RTOL})")
    check(worst_loss <= LM_STEP_LOSS_RTOL, f"kernel vs plain LM loss rel diff {worst_loss}")
    check(max(update_rel) <= LM_STEP_UPDATE_RTOL, f"kernel vs plain LM update rel diff {update_rel}")
    del kernel_model, plain_model, kernel_state, plain_state, start

    # -- a small f32 LM step on the card against the CPU ---------------------
    card_model = TransformerLM(**LM_CPU, device=dev, seed=6)
    cpu_model = TransformerLM(**LM_CPU, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    start = [p.detach().clone() for p in cpu_model.parameters()]
    t = torch.from_numpy(np.random.default_rng(6).integers(0, LM_CPU["vocab_size"],
                                                           (4, LM_CPU["max_len"] + 1)))
    b_cpu = {"image": t[:, :-1], "label": t[:, 1:]}
    b_card = {k: v.to(dev) for k, v in b_cpu.items()}
    _, cm = f32_step(create_train_state(card_model, fused_adamw(1e-3, **LM_STEP_ADAMW)), b_card)
    _, pm = f32_step(create_train_state(cpu_model, fused_adamw(1e-3, **LM_STEP_ADAMW)), b_cpu)
    cpu_loss_err = abs(float(cm["loss_sum"]) - float(pm["loss_sum"])) / abs(float(pm["loss_sum"]))
    pairs = list(zip((p.detach().cpu() for p in card_model.parameters()),
                     (p.detach() for p in cpu_model.parameters()), start))
    cpu_update_err = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs)
                               / sum(float(((b - s0) ** 2).sum()) for _, b, s0 in pairs))
    cpu_entry_err = max(float((a - b).abs().max()) for a, b, _ in pairs)
    log(f"  f32 LM step, card vs CPU ({LM_CPU['num_layers']} layers, width "
        f"{LM_CPU['num_heads'] * LM_CPU['head_dim']}, 4x{LM_CPU['max_len']}): loss rel diff "
        f"{cpu_loss_err:.3g} (tol {CPU_STEP_LOSS_RTOL}), update rel diff {cpu_update_err:.3g} "
        f"(tol {LM_CPU_UPDATE_RTOL}); largest single entry diff {cpu_entry_err:.3g}")
    check(cpu_loss_err <= CPU_STEP_LOSS_RTOL, f"LM card vs CPU loss rel diff {cpu_loss_err}")
    check(cpu_update_err <= LM_CPU_UPDATE_RTOL, f"LM card vs CPU update rel diff {cpu_update_err}")

    out = {
        "tokens_per_s": tok_s,
        "step_ms": step_ms,
        "batch": batch_size,
        "seq": seq,
        "params": n_params,
        "mfu": mfu,
        "step_tflop": (model_flops + attn_flops) / 1e12,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "fixed_batch_losses": [fixed[0], fixed[-1]],
        "fit_s": fit_s,
        "train_samples_per_sec_fit": summary["train_samples_per_sec"],
        "eval_loss": summary["eval_loss"],
        "profile": prof,
        "parts": parts,
        "peak_memory_gb": mem_gb,
        "kernel_vs_plain": {"loss_rel": worst_loss, "update_rel": update_rel},
        "card_vs_cpu": {"loss_rel": cpu_loss_err, "update_rel": cpu_update_err,
                        "entry_abs": cpu_entry_err},
        "card": card,
    }
    log("  lm_json " + json.dumps(out))
    return launches, out


LONG_STEPS = 4  # the long_ctx fit's batches
LONG_REMAT_STEPS = 2  # the long_remat fit's batches
LONG_TIMED = 5  # steps of the step alone
#: the small f32 blockwise LM step on the card against the CPU
LONG_CPU = dict(vocab_size=512, num_layers=2, num_heads=4, head_dim=32, max_len=256,
                attn_impl="blockwise")


def long_context_phase(card: str, dev: torch.device = torch.device("cuda"), cfg: dict = LONG_LM,
                       batch_size: int = LONG_BATCH, cpu_cfg: dict = LONG_CPU) -> tuple[dict, dict]:
    """Phase 12: ``bench_lm.py``'s ``long_ctx`` (GPT-2-small widths, seq
    8192, batch 2, ``attn_impl="auto"``: blockwise) through ``Trainer(tx=
    fused_adamw(...), precision="bf16").fit()`` with an eval, counters
    zeroed just before and read just after; the step alone (tokens/s, MFU,
    a profile with K6's share); ten steps on one batch; then ``long_remat``
    (``remat=True``) through the Trainer (K6a twice a layer, the first loss
    bit-equal, less peak memory); a small f32 blockwise LM step on the card
    against the CPU.  Returns (launch counts, summary); the sizes are
    arguments so the phase can be rehearsed small on the CPU."""
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
        cross_entropy_bwd,
        cross_entropy_fwd,
        fused_adamw,
        fused_adamw_multi_update_,
        layer_norm_bwd,
        layer_norm_fwd,
        normalize_images,
    )
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import Callback, Trainer, create_train_state, make_train_step

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, trainer, metrics):
            self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

    seq, vocab, layers = cfg["max_len"], cfg["vocab_size"], cfg["num_layers"]
    counters = {"blockwise_attention_fwd": blockwise_attention_fwd,
                "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv,
                "layer_norm_fwd": layer_norm_fwd, "layer_norm_bwd": layer_norm_bwd,
                "fused_adamw": fused_adamw_multi_update_, "normalize": normalize_images,
                "cross_entropy_fwd": cross_entropy_fwd, "cross_entropy_bwd": cross_entropy_bwd}
    n_ln = 2 * layers + 1

    def fit(remat: bool, steps: int, with_eval: bool):
        model = TransformerLM(**cfg, remat=remat, device=dev, seed=0)
        train = DataLoader(NextTokenDataset(batch_size * LONG_STEPS, seq, vocab, seed=1),
                           batch_size, shuffle=True, seed=0, num_workers=2)
        evl = (DataLoader(NextTokenDataset(2 * batch_size + 1, seq, vocab, seed=2), batch_size,
                          drop_last=False, num_workers=2) if with_eval else None)
        losses = StepLosses()
        trainer = Trainer(model, tx=fused_adamw(3e-4, weight_decay=1e-4), train_dataloader=train,
                          eval_dataloader=evl, precision="bf16", max_duration=f"{steps}ba",
                          log_interval=1, callbacks=[losses])
        trainer.init_state()
        # -- the main path: counts zeroed just before, read just after -------
        for fn in counters.values():
            fn.launches = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = trainer.fit()
        sync(dev)
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
        n_eval = len(evl) if evl is not None else 0
        fwd = steps * (2 if remat else 1) + n_eval  # the recompute runs each block again
        expected = {"blockwise_attention_fwd": layers * fwd,
                    "blockwise_attention_bwd_dq": layers * steps,
                    "blockwise_attention_bwd_dkv": layers * steps,
                    "layer_norm_fwd": n_ln * (steps + n_eval) + (2 * layers * steps if remat else 0),
                    "layer_norm_bwd": n_ln * steps, "fused_adamw": steps, "normalize": 0,
                    "cross_entropy_fwd": 0, "cross_entropy_bwd": 0}
        what = "long_remat" if remat else "long_ctx"
        log(f"  {what} fit: {steps} steps of {batch_size}x{seq} tokens"
            f"{f' + eval of {2 * batch_size + 1} sequences ({n_eval} batches)' if evl else ''} in "
            f"{fit_s:.2f} s; peak memory {peak:.2f} GB; launches {launches} (expected {expected})")
        check(launches == expected, f"{what} launches {launches} != {expected}")
        check(len(losses.losses) == steps and all(math.isfinite(v) for v in losses.losses),
              f"{what} step losses {losses.losses}")
        return trainer, result.history[-1], losses.losses, launches, peak, fit_s

    trainer, summary, losses, launches, peak_ctx, fit_s = fit(False, LONG_STEPS, True)
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    # a model at init gives about ln(vocab) + 0.5 (phase 6)
    check(abs(losses[0] - math.log(vocab)) <= 1.0,
          f"long_ctx first loss {losses[0]:.4f} not within 1.0 of ln {vocab} = {math.log(vocab):.4f}")
    check(summary["health_bad_steps"] == 0.0 and math.isfinite(summary["eval_loss"]),
          f"long_ctx summary {summary}")
    log(f"  long_ctx step losses {[round(v, 4) for v in losses]}, eval loss "
        f"{summary['eval_loss']:.2f} (a per-sequence sum, ROADMAP Queue 3 item 3)")

    # -- the train step alone on one device-resident batch -------------------
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    state, step = trainer.state, trainer._train_step
    fixed = []
    for _ in range(10):  # ten steps on one batch: the overfit check
        state, m = step(state, batch)
        fixed.append(m["loss_sum"] / m["count"])
    fixed = [float(v) for v in torch.stack(fixed).cpu()]
    log(f"  ten steps on one batch: losses {[round(v, 4) for v in fixed]}")
    check(all(math.isfinite(v) for v in fixed) and fixed[-1] < fixed[0],
          f"ten steps on one batch did not lower the loss: {fixed}")
    times = []
    for _ in range(LONG_TIMED):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    tokens = batch_size * seq
    tok_s = tokens / (step_ms / 1e3)
    # phase 6's formula: 6 N T for the parameters' products plus attention's
    # QK^T and PV, forward and backward, over the full L^2 (3 x 4 B H L^2 Dh
    # a layer): it counts the causal mask's skipped half as work
    model_flops = 6 * n_params * tokens
    attn_flops = 3 * 4 * batch_size * cfg["num_heads"] * seq * seq * cfg["head_dim"] * layers
    mfu = (model_flops + attn_flops) / (step_ms / 1e3) / BF16_FLOPS
    mfu_causal = (model_flops + attn_flops / 2) / (step_ms / 1e3) / BF16_FLOPS
    log(f"  long_ctx train step alone, batch {batch_size}x{seq}: median {step_ms:.2f} ms over "
        f"{LONG_TIMED} steps (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{tok_s:.0f} tokens/s; MFU {mfu:.4f} (phase 6's formula, attention over the full L^2; "
        f"{mfu_causal:.4f} counting the causal half) at 989 TFLOP/s on {card}")
    # K6 in bf16 on the tensor cores; the FMA kernels are f32's
    k6_names = ("tc::attn_fwd_tc", "tc::attn_bwd_dq_tc", "tc::attn_bwd_dkv_tc",
                "attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")
    prof = {}
    if dev.type == "cuda":
        prof = profile(lambda: step(state, batch), f"long_ctx train step of {batch_size}x{seq} "
                       "(bf16, health on)", top=20, also=k6_names)
        k6_ms = sum(v["ms"] for v in prof["named"].values())
        prof["k6_ms"], prof["k6_share"] = k6_ms, k6_ms / prof["device_ms"]
        log(f"  K6 in the step: {k6_ms:.2f} ms of {prof['device_ms']:.2f} ms device time "
            f"({prof['k6_share']:.1%}): " + ", ".join(
                f"{k} {v['ms']:.2f} ms x{v['count']}" for k, v in prof["named"].items()))
    del trainer, state, step, batch, toks
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- long_remat: the same model and data with remat=True -----------------
    trainer, _, remat_losses, remat_launches, peak_remat, remat_fit_s = fit(
        True, LONG_REMAT_STEPS, False)
    toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    state, step = trainer.state, trainer._train_step
    state, _ = step(state, batch)
    remat_times = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        remat_times.append(time.perf_counter() - t0)
    remat_step_ms = statistics.median(remat_times) * 1e3
    log(f"  long_remat train step alone: median {remat_step_ms:.2f} ms over 3 steps "
        f"({tokens / (remat_step_ms / 1e3):.0f} tokens/s; long_ctx {step_ms:.2f} ms)")
    del trainer, state, step, batch, toks
    log(f"  long_remat first loss {remat_losses[0]!r}, long_ctx first loss {losses[0]!r}; peak "
        f"memory long_remat {peak_remat:.3f} GB, long_ctx {peak_ctx:.3f} GB")
    check(remat_losses[0] == losses[0], "long_remat's first loss is not bit-equal to long_ctx's")
    check(dev.type != "cuda" or peak_remat < peak_ctx,
          f"long_remat peak memory {peak_remat} GB not below long_ctx's {peak_ctx} GB")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- a small f32 blockwise LM step on the card against the CPU -----------
    card_model = TransformerLM(**cpu_cfg, device=dev, seed=6)
    cpu_model = TransformerLM(**cpu_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    start = [p.detach().clone() for p in cpu_model.parameters()]
    t = torch.from_numpy(np.random.default_rng(6).integers(0, cpu_cfg["vocab_size"],
                                                           (4, cpu_cfg["max_len"] + 1)))
    b_cpu = {"image": t[:, :-1], "label": t[:, 1:]}
    f32_step = make_train_step(full_precision())
    before = blockwise_attention_fwd.launches
    _, cm = f32_step(create_train_state(card_model, fused_adamw(1e-3, **LM_STEP_ADAMW)),
                     {k: v.to(dev) for k, v in b_cpu.items()})
    check(dev.type != "cuda" or blockwise_attention_fwd.launches == before + cpu_cfg["num_layers"],
          "the f32 blockwise step on the card did not launch K6a once a layer")
    _, pm = f32_step(create_train_state(cpu_model, fused_adamw(1e-3, **LM_STEP_ADAMW)), b_cpu)
    loss_err = abs(float(cm["loss_sum"]) - float(pm["loss_sum"])) / abs(float(pm["loss_sum"]))
    pairs = list(zip((p.detach().cpu() for p in card_model.parameters()),
                     (p.detach() for p in cpu_model.parameters()), start))
    update_err = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs)
                           / sum(float(((b - s0) ** 2).sum()) for _, b, s0 in pairs))
    log(f"  f32 blockwise LM step, card vs CPU ({cpu_cfg['num_layers']} layers, width "
        f"{cpu_cfg['num_heads'] * cpu_cfg['head_dim']}, 4x{cpu_cfg['max_len']}): loss rel diff "
        f"{loss_err:.3g} (tol {CPU_STEP_LOSS_RTOL}), update rel diff {update_err:.3g} "
        f"(tol {LM_CPU_UPDATE_RTOL})")
    check(loss_err <= CPU_STEP_LOSS_RTOL, f"blockwise LM card vs CPU loss rel diff {loss_err}")
    check(update_err <= LM_CPU_UPDATE_RTOL, f"blockwise LM card vs CPU update rel diff {update_err}")

    out = {
        "tokens_per_s": tok_s,
        "step_ms": step_ms,
        "batch": batch_size,
        "seq": seq,
        "params": n_params,
        "mfu": mfu,
        "mfu_causal_half": mfu_causal,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "fixed_batch_losses": [fixed[0], fixed[-1]],
        "fit_s": fit_s,
        "eval_loss": summary["eval_loss"],
        "peak_memory_gb": peak_ctx,
        "remat": {"first_loss": remat_losses[0], "peak_memory_gb": peak_remat,
                  "step_ms": remat_step_ms, "fit_s": remat_fit_s, "launches": remat_launches},
        "profile": prof,
        "card_vs_cpu": {"loss_rel": loss_err, "update_rel": update_err},
        "card": card,
    }
    log("  long_json " + json.dumps(out))
    return {"long_ctx": launches, "long_remat": remat_launches}, out


CKPT_STEPS = 6  # the uninterrupted fit
CKPT_CRASH = 4  # the interrupted fit stops after this step
CKPT_EVERY = 2  # its checkpoint_interval_batches


def _state_tensors(state) -> list:
    """Every tensor of a ``TrainState``'s saveable dict, in a fixed order."""
    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from walk(v)
            elif torch.is_tensor(v):
                yield v
    return list(walk(state.state_dict()))


def _same_state(a, b) -> tuple[bool, float]:
    """(bit-equal, largest |a - b|) over the parameters and optimizer state
    of two ``TrainState``s."""
    ta = [t for t in _state_tensors(a)]
    tb = [t for t in _state_tensors(b)]
    check(len(ta) == len(tb), "states of different layouts")
    equal = all(torch.equal(x, y) for x, y in zip(ta, tb))
    diff = max(float((x.double() - y.double()).abs().max()) for x, y in zip(ta, tb)
               if x.is_floating_point())
    return equal, diff


def checkpoint_phase(card: str, dev: torch.device = torch.device("cuda"), cfg: dict = LM,
                     batch_size: int = LM_BATCH) -> dict:
    """Checkpoint and resume through ``Trainer.fit`` on phase 6's LM.

    (a) A fit with ``checkpoint_interval_batches=2`` stopped by a crash
    after step 4, then a new Trainer over the same directory that
    auto-resumes from the snapshot of step 4 and runs to step 6, against an
    uninterrupted 6-step fit: bit-equal (parameters and optimizer state),
    and the resumed run's first batch is batch 5.  (b) The wall time and
    rate of a save and a restore of the full state, and of an async save,
    with the train step's time while it is in flight.  (d) The step
    directories in the JAX package's layout.  The device and sizes are
    arguments so the phase can be rehearsed small on the CPU."""
    import shutil
    import tempfile

    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.ckpt.meta import (
        _read_meta_doc,
        is_committed,
        read_health,
        read_manifest,
        valid_steps,
    )
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.ops.build import BUILD_DIR
    from tpuframe_torch.train import Callback, Trainer

    seq, vocab = cfg["max_len"], cfg["vocab_size"]

    class Crash(Callback):
        def on_step_end(self, trainer):
            if trainer.batches_seen >= CKPT_CRASH:
                raise RuntimeError("simulated crash")

    class Positions(Callback):
        def __init__(self):
            self.seen = []

        def on_step_end(self, trainer):
            self.seen.append(trainer._train_prefetcher.state_dict()["batches_yielded"])

    def make(directory=None, callbacks=()):
        model = TransformerLM(**cfg, device=dev, seed=0)
        data = NextTokenDataset(batch_size * (CKPT_STEPS + 2), seq, vocab, seed=1)
        return Trainer(model, tx=fused_adamw(3e-4, weight_decay=1e-4),
                       train_dataloader=DataLoader(data, batch_size, shuffle=True, seed=0,
                                                   num_workers=4),
                       precision="bf16", max_duration=f"{CKPT_STEPS}ba", log_interval=0,
                       callbacks=list(callbacks),
                       checkpointer=None if directory is None else Checkpointer(directory),
                       checkpoint_interval_batches=CKPT_EVERY if directory else None)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=BUILD_DIR)
    try:
        # -- (a) interrupted, resumed, against uninterrupted ---------------
        directory = os.path.join(root, "lm")
        first = make(directory, [Crash()])
        try:
            first.fit()
            check(False, "the interrupted fit ran to its end")
        except RuntimeError as e:
            check(str(e) == "simulated crash", f"the interrupted fit failed otherwise: {e!r}")
        intra = directory + "_intra"
        check(valid_steps(intra) == [CKPT_CRASH] and valid_steps(directory) == [],
              f"snapshots {valid_steps(intra)}, epoch-end steps {valid_steps(directory)}")
        snap = _read_meta_doc(intra, CKPT_CRASH)["meta"]
        check(snap["batches_seen"] == CKPT_CRASH and snap["loader_state"]["batches_yielded"]
              == CKPT_CRASH and snap["global_batch"] == batch_size,
              f"snapshot meta {snap}")
        del first
        positions = Positions()
        resumed = make(directory, [positions])
        t0 = time.perf_counter()
        result = resumed.fit()
        sync(dev)
        resume_s = time.perf_counter() - t0
        want_pos = list(range(CKPT_CRASH + 1, CKPT_STEPS + 1))
        check(positions.seen == want_pos,
              f"the resumed run consumed batches {positions.seen}, not {want_pos}")
        check(resumed.state.step == CKPT_STEPS
              and result.checkpoint == os.path.join(directory, str(CKPT_STEPS)),
              f"resumed to step {resumed.state.step}, checkpoint {result.checkpoint}")
        straight = make()
        straight.fit()
        sync(dev)
        equal, diff = _same_state(resumed.state, straight.state)
        repeat_diff = None
        if not equal:  # measure the card's own spread over two straight fits
            again = make()
            again.fit()
            sync(dev)
            _, repeat_diff = _same_state(again.state, straight.state)
            del again
            check(repeat_diff > 0 and diff <= repeat_diff,
                  f"resumed fit {diff:.3g} from the uninterrupted one; two uninterrupted "
                  f"fits {repeat_diff:.3g} apart")
        log(f"  (a) fit of {CKPT_STEPS} steps of {batch_size}x{seq} stopped after step "
            f"{CKPT_CRASH} (snapshots every {CKPT_EVERY}), resumed from the snapshot in "
            f"{resume_s:.2f} s: first batch {positions.seen[0]}, bit-equal to the "
            f"uninterrupted fit {equal} (max |diff| {diff:.3g}"
            + (f", two uninterrupted fits {repeat_diff:.3g} apart)" if not equal else ")"))
        del straight

        # -- (d) the layout --------------------------------------------------
        step_dir = os.path.join(directory, str(CKPT_STEPS))
        state = resumed.state
        n_leaves = len(_state_tensors(state))
        manifest, stamp = read_manifest(directory), read_health(directory)
        doc = _read_meta_doc(directory, CKPT_STEPS)
        check(is_committed(step_dir)
              and sorted(os.listdir(step_dir)) == ["_CHECKPOINT_METADATA", "meta", "state"]
              and set(doc) == {"meta", "metrics", "topology", "health"}
              and doc["meta"]["epoch"] == 1 and doc["meta"]["batches_seen"] == CKPT_STEPS
              and manifest["world_size"] == 1 and len(manifest["leaves"]) == n_leaves
              and stamp["healthy"] and stamp["step"] == CKPT_STEPS
              and valid_steps(intra) == []
              and not [e for e in os.listdir(directory) if not e.isdigit()],
              f"step directory {sorted(os.listdir(step_dir))}, meta {doc.get('meta')}, "
              f"{len(manifest['leaves'])} leaves, stamp {stamp}")
        log(f"  (d) {step_dir}: {sorted(os.listdir(step_dir))}, state/ "
            f"{sorted(os.listdir(os.path.join(step_dir, 'state')))}, meta keys {sorted(doc)}, "
            f"{len(manifest['leaves'])} manifest leaves, health stamp {stamp}")

        # -- (b) full-size save and restore ----------------------------------
        nbytes = sum(t.numel() * t.element_size() for t in _state_tensors(state))
        timing = Checkpointer(os.path.join(root, "timing"), max_to_keep=1)
        sync(dev)
        t0 = time.perf_counter()
        timing.save(state, step=100)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        timing.restore(state)
        sync(dev)
        restore_s = time.perf_counter() - t0
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
        batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
        step = resumed._train_step

        def step_s():
            sync(dev)
            t = time.perf_counter()
            step(state, batch)
            sync(dev)
            return time.perf_counter() - t

        for _ in range(3):
            step_s()
        alone = [step_s() for _ in range(10)]
        saved = [t.clone() for t in _state_tensors(state)]
        async_ck = Checkpointer(os.path.join(root, "async"), max_to_keep=1, async_save=True)
        t0 = time.perf_counter()
        async_ck.save(state, step=200)
        async_return_s = time.perf_counter() - t0
        in_flight = []
        while async_ck._pending is not None and async_ck._pending.is_alive() \
                and len(in_flight) < 500:
            in_flight.append(step_s())
        async_ck.wait()
        async_total_s = time.perf_counter() - t0
        check(async_ck.all_steps() == [200], f"async steps {async_ck.all_steps()}")
        async_ck.restore(state)
        sync(dev)
        check(all(torch.equal(a, b) for a, b in zip(_state_tensors(state), saved)),
              "the async checkpoint does not hold the state of the save call")
        gb = nbytes / 1e9
        out = {
            "state_gb": gb, "save_ms": save_s * 1e3, "save_gb_s": gb / save_s,
            "restore_ms": restore_s * 1e3, "restore_gb_s": gb / restore_s,
            "async_return_ms": async_return_s * 1e3, "async_total_ms": async_total_s * 1e3,
            "step_ms_alone": statistics.median(alone) * 1e3,
            "step_ms_in_flight": statistics.median(in_flight) * 1e3 if in_flight else None,
            "steps_in_flight": len(in_flight), "resume_bit_equal": equal,
            "resume_max_abs_diff": diff, "repeat_max_abs_diff": repeat_diff,
            "resume_fit_s": resume_s, "card": card,
        }
        log(f"  (b) save of the full state ({gb:.3f} GB, {n_leaves} tensors): "
            f"{out['save_ms']:.1f} ms wall, {out['save_gb_s']:.3f} GB/s; restore "
            f"{out['restore_ms']:.1f} ms, {out['restore_gb_s']:.3f} GB/s (the machine's disk "
            f"and host copies, not HBM); async save returns in {out['async_return_ms']:.1f} ms "
            f"and commits after {out['async_total_ms']:.1f} ms; train step median "
            f"{out['step_ms_alone']:.2f} ms alone, "
            + (f"{out['step_ms_in_flight']:.2f} ms over {len(in_flight)} steps while the "
               f"write is in flight" if in_flight else "no step while the write was in flight")
            + f" on {card}")
        log("  ckpt_json " + json.dumps(out))
        del resumed, state, saved
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def compressed_round_trip(trainer, card: str) -> dict:
    """(c) The compressed fit's state (parameters, BatchNorm buffers, SGD
    momentum and the int8 wire's residual) saved, overwritten, and restored
    in place: bit-equal, with the residual's global leaf in the manifest."""
    import shutil
    import tempfile

    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.ops.build import BUILD_DIR

    state = trainer.state
    dev = state.updates.device
    tensors = _state_tensors(state)
    saved = [t.clone() for t in tensors]
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=BUILD_DIR)
    try:
        ck = Checkpointer(root)
        sync(dev)
        t0 = time.perf_counter()
        ck.save(state, plan=trainer.plan)
        save_s = time.perf_counter() - t0
        leaf = ck.manifest_for()["leaves"]["comms/flat"]
        check(leaf["shape"] == [1, *WIRE_SHAPE] and leaf["dtype"] == "float32",
              f"residual leaf {leaf}")
        with torch.no_grad():
            for t in tensors:
                if t.is_floating_point():
                    t.add_(1.0)
        t0 = time.perf_counter()
        ck.restore(state)
        sync(dev)
        restore_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(_state_tensors(state), saved)),
              "the compressed state did not round-trip bit for bit")
        nbytes = sum(t.numel() * t.element_size() for t in saved)
        out = {"state_gb": nbytes / 1e9, "save_ms": save_s * 1e3, "restore_ms": restore_s * 1e3,
               "residual_shape": leaf["shape"]}
        log(f"  (c) compressed state ({nbytes / 1e9:.3f} GB with the residual "
            f"{leaf['shape']}) round-trips bit for bit: save {out['save_ms']:.1f} ms, restore "
            f"{out['restore_ms']:.1f} ms on {card}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def free_port() -> int:
    """A free TCP port on this machine's loopback interface."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_phase(card: str, dev: torch.device = torch.device("cuda"), image_size: int = 224,
             batch_size: int = TRAIN_BATCH) -> tuple[dict, dict]:
    """ResNet50-1K trained as phase 5 configures it, but through
    ``Trainer(plan=ParallelPlan(mesh=initialize().mesh), grad_compression=
    "int8")`` on a one-rank process group (NCCL on the card): the main path,
    counted.  Then the compressed step's median beside the uncompressed
    step's on one device-resident batch, in turns, the wire's parts alone,
    a check that the compressed step never waits for the device, and a
    profile of one compressed step.  Returns (launch counts, summary).  The
    device and sizes are arguments so the phase can be rehearsed small on
    the CPU."""
    import math
    import os

    from tpuframe_torch.core import initialize, shutdown
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode
    from tpuframe_torch.parallel import ParallelPlan, grad_layout, sync_gradients
    from tpuframe_torch.parallel.compression import resolve_fused
    from tpuframe_torch.train import Callback, Trainer
    from tpuframe_torch.train.step import _average_buffers, make_train_step

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, trainer, metrics):
            self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    try:
        rt = initialize(device=dev)
        import torch.distributed as dist

        check(dist.is_initialized() and dist.get_world_size() == 1,
              "initialize() built no one-rank process group")
        backend = dist.get_backend()
        model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
        train = DataLoader(SyntheticImageDataset(n=batch_size * TRAIN_STEPS,
                                                 image_size=image_size, num_classes=1000,
                                                 seed=1),
                           batch_size, shuffle=True, seed=0, transfer_dtype="uint8",
                           num_workers=8)
        eval_images = 2 * batch_size + 44 * batch_size // TRAIN_BATCH  # a ragged last batch
        evl = DataLoader(SyntheticImageDataset(n=eval_images, image_size=image_size,
                                               num_classes=1000, seed=2),
                         batch_size, drop_last=False, transfer_dtype="uint8", num_workers=8)
        steps = StepLosses()
        trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl, optimizer="sgd",
                          lr=0.1, precision="bf16", normalize=(MEAN, STD),
                          max_duration=f"{TRAIN_STEPS}ba", log_interval=1, callbacks=[steps],
                          plan=ParallelPlan(mesh=rt.mesh), grad_compression="int8")
        trainer.init_state()
        n_eval = len(evl)
        counters = {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
                    "cross_entropy_bwd": cross_entropy_bwd, "bucket_abs_max": bucket_abs_max,
                    "quant_encode": quant_encode, "quant_decode": quant_decode}
        # -- the main path: counts zeroed just before, read just after -----
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = trainer.fit()
        sync(dev)
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        expected = {"normalize": TRAIN_STEPS + n_eval, "cross_entropy_fwd": TRAIN_STEPS + n_eval,
                    "cross_entropy_bwd": TRAIN_STEPS, "bucket_abs_max": TRAIN_STEPS,
                    "quant_encode": TRAIN_STEPS, "quant_decode": TRAIN_STEPS}
        wire = trainer._train_step.wire
        log(f"  compressed fit ({backend}, world 1, int8): {TRAIN_STEPS} steps of {batch_size} "
            f"+ eval of {eval_images} images in {fit_s:.2f} s; launches {launches} (expected "
            f"{expected}); wire {wire['n_buckets']} buckets x {wire['bucket_elems']} "
            f"({wire['flat_elems']} elements)")
        check(launches == expected, f"compressed train launches {launches} != {expected}")
        n_params = sum(p.numel() for p in model.parameters())
        check((wire["n_buckets"], wire["bucket_elems"], wire["flat_elems"])
              == (25, 1_022_336, n_params) and n_params == 25_557_032,
              f"wire layout {wire}")
        summary = result.history[-1]
        check(SUMMARY_KEYS <= set(summary), f"epoch summary lacks {SUMMARY_KEYS - set(summary)}")
        losses = steps.losses
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
              f"step losses {losses}")
        check(abs(losses[0] - math.log(1000)) <= 1.0,
              f"first-step loss {losses[0]:.4f} not within 1.0 of ln 1000")
        check(summary["health_bad_steps"] == 0.0, f"{summary['health_bad_steps']} bad steps")
        resid = float(trainer.state.comms["flat"].abs().max())
        check(math.isfinite(resid) and resid > 0, f"error-feedback residual max |r| = {resid}")
        log(f"  step losses {[round(v, 4) for v in losses]}; residual max |r| {resid:.4g}")
        log("  epoch summary " + json.dumps({k: round(v, 6) for k, v in summary.items()}))

        # -- the step alone: compressed and uncompressed, in turns ----------
        rng = np.random.default_rng(3)
        batch = {"image": torch.from_numpy(rng.integers(
                     0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8)).to(dev),
                 "label": torch.from_numpy(rng.integers(0, 1000, batch_size)).to(dev)}
        state = trainer.state
        compressed = trainer._train_step
        transform = functools.partial(normalize_images, mean=MEAN, std=STD,
                                      out_dtype=trainer.policy.compute_dtype)
        plain = make_train_step(trainer.policy, batch_transform=lambda b: {
            **b, "image": transform(b["image"])}, health=trainer.health)

        def median_ms(fn, n=20):
            """Median host wall of ``fn()`` from a synced device to its end."""
            for _ in range(3):
                fn()
            times = []
            for _ in range(n):
                sync(dev)
                t0 = time.perf_counter()
                fn()
                sync(dev)
                times.append(time.perf_counter() - t0)
            return statistics.median(times) * 1e3

        def run_plain():
            plain(state, batch)

        def run_compressed():
            compressed(state, batch)

        arms = {"uncompressed": [median_ms(run_plain)], "compressed": [median_ms(run_compressed)]}
        arms["compressed"].append(median_ms(run_compressed))
        arms["uncompressed"].append(median_ms(run_plain))
        step_ms = {k: min(v) for k, v in arms.items()}
        log(f"  train step alone, batch {batch_size}: compressed int8 (world 1) median "
            f"{step_ms['compressed']:.2f} ms {arms['compressed']}, uncompressed "
            f"{step_ms['uncompressed']:.2f} ms {arms['uncompressed']} (the better of two "
            f"medians of 20 steps, in turns U C C U) on {card}")
        # what the compressed step adds, alone on this step's gradients
        grads = {n: p.grad for n, p in model.named_parameters()}
        config = resolve_fused(trainer.plan, trainer.comms_config)
        layout = grad_layout(grads, config, trainer.plan)
        parts_ms = {
            "sync_gradients": median_ms(lambda: sync_gradients(grads, state.comms, layout, config)),
            "average_buffers": median_ms(lambda: _average_buffers(model, 1)),
        }
        log(f"  the wire's parts alone (median host wall to the device's end): "
            f"{json.dumps(parts_ms)}")
        if dev.type == "cuda":
            # no call of the compressed step may wait for the device
            torch.cuda.set_sync_debug_mode("error")
            try:
                run_compressed()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log("  the compressed step makes no synchronizing call (sync debug mode)")
        prof = profile(run_compressed,
                       f"compressed train step of {batch_size} (bf16, int8 wire, health on)")
        round_trip = compressed_round_trip(trainer, card)
        out = {"round_trip": round_trip, "step_ms": step_ms, "step_ms_runs": arms, "parts_ms": parts_ms, "fit_s": fit_s,
               "first_loss": losses[0], "last_loss": losses[-1], "residual_max": resid,
               "wire": wire, "backend": backend, "profile": prof, "card": card}
        log("  dp_json " + json.dumps(out))
        del trainer, state, model, batch
        return launches, out
    finally:
        shutdown()
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)


def _two_rank_child(rank: int, world: int, store: str, out_dir: str, device: str) -> None:
    """One of two ranks on the same card (gloo: NCCL refuses two ranks on
    one device): ``sync_gradients`` over a ResNet50-shaped named tree with
    the kernels, then the same ranks' plain run on the CPU; writes what it
    saw as JSON."""
    import hashlib
    import os
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    out = {}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.models import ResNet50
        from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode
        from tpuframe_torch.parallel import (
            CommsConfig,
            ParallelPlan,
            grad_layout,
            init_comms_state,
            sync_gradients,
        )

        rt = initialize(device=device, backend="gloo")
        try:
            dev = rt.device
            shapes = {n: p.shape for n, p in
                      ResNet50(num_classes=1000, device="cpu").named_parameters()}
            config = CommsConfig(mode="int8")
            plan = ParallelPlan(mesh=rt.mesh)
            gen = torch.Generator(device=dev).manual_seed(100 + rank)
            grads = {n: torch.randn(s, generator=gen, device=dev) * 1e-2 for n, s in shapes.items()}
            layout = grad_layout(grads, config, plan)
            resid = init_comms_state(grads, plan, config)["flat"]
            resid.normal_(0, 1e-5, generator=gen)
            for poison in (False, True):
                if poison and rank == 1:  # one bad value in the middle of the tree
                    grads["layer3.0.conv2.weight"].view(-1)[7] = float("nan")
                before = (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches)
                card_mean, card_resid = sync_gradients(grads, {"flat": resid}, layout, config)
                sync(dev)
                launched = [a - b for a, b in zip((bucket_abs_max.launches, quant_encode.launches,
                                                   quant_decode.launches), before)]
                cpu_mean, cpu_resid = sync_gradients({k: g.cpu() for k, g in grads.items()},
                                                     {"flat": resid.cpu()}, layout, config)
                equal = all(same_bits(card_mean[k].cpu(), cpu_mean[k]) for k in grads)
                equal = equal and same_bits(card_resid["flat"].cpu(), cpu_resid["flat"])
                flat = torch.cat([card_mean[p].reshape(-1).cpu() for p, _, _, _ in layout.flat])
                nan = torch.isnan(flat)
                digest = hashlib.sha256(torch.where(nan, 0, flat).numpy().tobytes()
                                        + nan.numpy().tobytes()).hexdigest()
                bucket = None
                if poison:
                    offset = next(o for p, _, _, o in layout.flat
                                  if p == "layer3.0.conv2.weight") + 7
                    bucket = offset // layout.bucket_elems
                    lo, hi = bucket * layout.bucket_elems, (bucket + 1) * layout.bucket_elems
                    want = torch.zeros(layout.padded_elems, dtype=torch.bool)
                    want[lo:hi] = True
                    nan_ok = torch.equal(nan, want[:layout.flat_elems])
                else:
                    nan_ok = not bool(nan.any())
                out["nan" if poison else "clean"] = {
                    "card_equals_cpu": equal, "digest": digest, "nan_bucket_ok": nan_ok,
                    "bucket": bucket, "launches": launched, "backend": "gloo",
                    "elements": layout.flat_elems, "buckets": layout.n_buckets}
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def two_rank_phase(timeout_s: float = 300.0, device: str = "cuda:0") -> dict:
    """Two gloo ranks on the one card, spawned: ``sync_gradients`` over a
    ResNet50-shaped named tree (25,557,032 elements, each rank its own
    gradient and residual) with the kernels must equal the same ranks'
    plain run on the CPU bit for bit (int8 round half to even), give both
    ranks the same mean, and decode a NaN on one rank to NaN in its bucket
    on both.  ``device`` is an argument so the phase can be rehearsed on the
    CPU."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_two_rank_child, args=(r, 2, f"{tmp}/store", tmp, device))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, timeout_s - (time.perf_counter() - t0)))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        check(not hung, f"two-rank phase: ranks {hung} hung past {timeout_s} s")
        res = []
        for r in range(2):
            f = Path(tmp, f"rank{r}.json")
            check(f.exists(), f"two-rank phase: rank {r} wrote nothing (exit {procs[r].exitcode})")
            res.append(json.loads(f.read_text()))
    for r, out in enumerate(res):
        check("error" not in out, f"two-rank phase, rank {r}:\n{out.get('error')}")
        for case in ("clean", "nan"):
            o = out[case]
            check(o["card_equals_cpu"], f"rank {r} {case}: card sync differs from the CPU's")
            check(o["nan_bucket_ok"], f"rank {r} {case}: NaN outside (or missing from) "
                                      f"bucket {o['bucket']}")
            check(o["launches"] == [1, 1, 1], f"rank {r} {case}: launches {o['launches']}")
    for case in ("clean", "nan"):
        check(res[0][case]["digest"] == res[1][case]["digest"],
              f"{case}: the two ranks decoded different means")
    log(f"  two gloo ranks on one card, {res[0]['clean']['elements']} elements in "
        f"{res[0]['clean']['buckets']} buckets: means and residuals with the kernels bit-equal "
        f"to the plain run on the CPU on both ranks, one mean on both; a NaN on rank 1 decodes "
        f"to NaN in bucket {res[0]['nan']['bucket']} only, on both ranks "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"ranks": 2, "seconds": time.perf_counter() - t0}


DDP_STEPS = 4  # the main path's batches on two ranks
DDP_TIMED = 10  # steps of the two-rank step alone
# f32, one SGD step (lr 0.1, momentum 0.9) of ResNet50-1K from one seed:
# two gloo ranks on their halves of a batch of 128 against one process on
# all of it (TF32 off).  The loss and the running statistics hold 1e-5: the
# ranks sum the moments in another order and, under sync, take flax's
# E[x^2] - E[x]^2 where one process takes cuDNN's variance (measured 1.9e-7
# and within 2.5e-6 on an H100).  The update (parameters after the step) is
# held as a whole, ||ranks - one|| / ||one - start|| <= DDP_UPDATE_RTOL.  A
# fresh ResNet50's first backward cancels most of each BatchNorm's and
# convolution's gradient sums, so their rounding shows in the update:
# cuDNN picks its algorithms by shape, and local BN's step at the ranks'
# shapes (two microbatches of 64, one process: the control printed beside)
# lies as far from the step at 128 as the two ranks do (5.2e-3 on an H100
# 80GB HBM3 at 700 W).  Sync BN measured 2.2e-2 there, as far as rounding
# alone moves this step: the same step on images moved by 1e-7 of
# themselves lies 2.1e-2 from it, and one process with every BatchNorm
# through the cross-rank function (one-rank gloo group) 2.4e-2; the ranks
# are held against that one too.  Two planted faults of the sync backward
# (its all-reduce dropped: 0.30; the scale's and bias's gradients
# all-reduced, the trap in models/norm.py: 9.2e-2) must read above the
# limit, or the phase fails
DDP_LOSS_RTOL = 1e-5
DDP_STATS_TOL = 1e-5
DDP_UPDATE_RTOL = 5e-2
# local BN's two ranks against the same step in one process at their
# shapes (two microbatches of 64): the same kernels on the same shapes and
# the same sum of two gradients, so only the order inside cuDNN's
# nondeterministic algorithms may differ (one process against itself with
# deterministic ones moves the update 1.6e-5; the ranks measured 1.2e-5)
DDP_SHAPES_RTOL = 1e-4
DDP_FAULTS = ("no all-reduce", "summed affine")


@contextlib.contextmanager
def _through_cross_rank():
    """Every training BatchNorm with ``groups=1`` through the cross-rank
    function (sync BN's plain ops), whatever the world size: on a one-rank
    group its all-reduces sum one term."""
    from tpuframe_torch.models import ReplicaGroupedBatchNorm

    forward = ReplicaGroupedBatchNorm.forward

    def through(self, x):
        if not (self.training and self.groups == 1):
            return forward(self, x)
        return self._sync_forward(x, self.weight.to(torch.float32), self.bias.to(torch.float32))

    with mock.patch.object(ReplicaGroupedBatchNorm, "forward", through):
        yield


@contextlib.contextmanager
def _planted_bn_fault(kind: str):
    """A planted fault of sync BN's backward, for reading what the update's
    limit catches: ``"no all-reduce"`` takes the input's gradient from the
    rank's own sums; ``"summed affine"`` returns the all-reduced scale and
    bias gradients (``world`` times the right ones after the step's
    average)."""
    import torch.distributed as dist

    from tpuframe_torch.models import norm

    sound = norm._CrossRankBatchNorm.backward

    def backward(ctx, *grads):
        if kind == "no all-reduce":
            with mock.patch.object(dist, "all_reduce", lambda *a, **k: None):
                return sound(ctx, *grads)
        dx, dw, db, *rest = sound(ctx, *grads)
        dist.all_reduce(dw)
        dist.all_reduce(db)
        return (dx, dw, db, *rest)

    with mock.patch.object(norm._CrossRankBatchNorm, "backward", staticmethod(backward)):
        yield


def _ddp_reference(dev: torch.device, image_size: int, batch_size: int,
                   ref_dir: str) -> dict:
    """One process's f32 step on the global batch, from the seed the ranks
    use, for ``bn_stats`` "sync" and "local" (two groups, the ranks'
    halves): the start, the loss and the state after, saved under
    ``ref_dir`` for the ranks to compare with (TF32 off, as the ranks run).
    Returns the controls, each as ``_update_rel`` from the saved step: the
    same step again with deterministic cuDNN algorithms, for each;
    (``sync_plain``) the sync step with every BatchNorm through the
    cross-rank function on a one-rank gloo group, saved too;
    (``ulp_input``) the sync step on images moved by 1e-7 of themselves; and
    (``local_shapes``) local BN's step at the ranks' shapes in one process,
    two microbatches of 64, saved too."""
    import torch.distributed as dist

    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import (
        create_train_state,
        make_grad_accum_step,
        make_optimizer,
        make_train_step,
    )

    batch = {k: torch.from_numpy(v).to(dev) for k, v in _ddp_batch(image_size, batch_size).items()}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def one_step(bn_stats: str, n_micro: int = 1, batch: dict = batch) -> dict:
        model = ResNet50(num_classes=1000, device=dev, seed=7, bn_stats=bn_stats, bn_groups=2)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        state = create_train_state(model, make_optimizer("sgd", 0.1))
        if n_micro == 1:
            state, m = make_train_step(full_precision())(state, batch)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
                     for k, v in batch.items()}
            state, m = make_grad_accum_step(n_micro, full_precision())(state, micro)
        params[:] = [k for k, _ in model.named_parameters()]
        return {"start": start, "loss": float(m["loss_sum"]) / float(m["count"]),
                "after": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}

    params: list = []
    control, refs = {}, {}
    for bn_stats in ("sync", "local"):
        runs = []
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            try:
                runs.append(one_step(bn_stats))
            finally:
                torch.backends.cudnn.deterministic = False
        refs[bn_stats] = runs[0]
        torch.save(runs[0], Path(ref_dir, f"{bn_stats}.pt"))
        control[bn_stats] = _update_rel(runs[1]["after"], runs[0], params)
    # sync BN's plain ops in one process at the global batch
    dist.init_process_group("gloo", init_method=f"file://{ref_dir}/one_rank_store",
                            rank=0, world_size=1)
    try:
        with _through_cross_rank():
            plain = one_step("sync")
    finally:
        dist.destroy_process_group()
    torch.save(plain, Path(ref_dir, "sync_plain.pt"))
    control["sync_plain"] = _update_rel(plain["after"], refs["sync"], params)
    control["sync_plain_loss_rel"] = abs(plain["loss"] - refs["sync"]["loss"]) / refs["sync"]["loss"]
    # how far rounding alone moves this step: cuDNN's sync step on images
    # moved by 1e-7 of themselves (seeded noise, about one f32 ulp)
    noise = torch.from_numpy(np.random.default_rng(9).standard_normal(
        batch["image"].shape).astype(np.float32)).to(dev)
    moved = one_step("sync", batch={**batch, "image": batch["image"] * (1 + 1e-7 * noise)})
    control["ulp_input"] = _update_rel(moved["after"], refs["sync"], params)
    # one process at the ranks' shapes: two microbatches of 64 (grad
    # accumulation), each its own BatchNorm group, which is local BN's step
    accum = one_step("sync", n_micro=2)
    torch.save(accum, Path(ref_dir, "local_accum.pt"))
    control["local_shapes"] = _update_rel(accum["after"], refs["local"], params)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return control


def _update_rel(after: dict, ref: dict, params: list) -> float:
    """||after - ref's after|| / ||ref's update|| over the parameters."""
    import math

    diff = sum(float(((after[k] - ref["after"][k]) ** 2).sum()) for k in params)
    update = sum(float(((ref["after"][k] - ref["start"][k]) ** 2).sum()) for k in params)
    return math.sqrt(diff / update)


def _ddp_batch(image_size: int, batch_size: int) -> dict:
    rng = np.random.default_rng(8)
    return {"image": rng.normal(0, 1, (batch_size, image_size, image_size, 3)).astype(np.float32),
            "label": rng.integers(0, 1000, batch_size)}


def _ddp_child(rank: int, world: int, store: str, out_dir: str, device: str, image_size: int,
               batch_size: int) -> None:
    """One of two gloo ranks on the one card: the main path (ResNet50-1K
    through ``Trainer(plan=...).fit()``, counted), the two-rank step alone,
    and the f32 step against one process's (``_ddp_reference``); writes
    what it saw as JSON."""
    import hashlib
    import math
    import os
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    # a spawned process starts from torch's defaults (TF32 convolutions)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.data import DataLoader, SyntheticImageDataset
        from tpuframe_torch.models import ReplicaGroupedBatchNorm, ResNet50
        from tpuframe_torch.ops.blockwise_attention import (
            blockwise_attention_bwd_dkv,
            blockwise_attention_bwd_dq,
            blockwise_attention_fwd,
        )
        from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
        from tpuframe_torch.ops.normalize import normalize_images
        from tpuframe_torch.parallel import ParallelPlan, full_precision
        from tpuframe_torch.train import (
            Callback,
            Trainer,
            create_train_state,
            make_optimizer,
            make_train_step,
        )
        from tpuframe_torch.train.step import _MeanSync

        class StepLosses(Callback):
            def __init__(self):
                self.losses = []

            def on_batch_end(self, trainer, metrics):
                self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

        rt = initialize(device=device, backend="gloo")
        try:
            dev = rt.device
            # -- the main path: counts zeroed just before, read just after --
            model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
            train = DataLoader(SyntheticImageDataset(n=batch_size * DDP_STEPS,
                                                     image_size=image_size, num_classes=1000,
                                                     seed=1),
                               batch_size, shuffle=True, seed=0, transfer_dtype="uint8",
                               num_workers=4, worker_mode="process")
            eval_images = 2 * batch_size + 44 * batch_size // TRAIN_BATCH  # a ragged last batch
            evl = DataLoader(SyntheticImageDataset(n=eval_images, image_size=image_size,
                                                   num_classes=1000, seed=2),
                             batch_size, drop_last=False, transfer_dtype="uint8", num_workers=4)
            steps = StepLosses()
            trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl,
                              optimizer="sgd", lr=0.1, precision="bf16", normalize=(MEAN, STD),
                              max_duration=f"{DDP_STEPS}ba", log_interval=1, callbacks=[steps],
                              plan=ParallelPlan(mesh=rt.mesh))
            trainer.init_state()
            eval_counts = []
            eval_step = trainer._eval_step

            def counted_eval(state, batch):
                m = eval_step(state, batch)
                eval_counts.append(float(m["count"]))
                return m

            trainer._eval_step = counted_eval
            counters = {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
                        "cross_entropy_bwd": cross_entropy_bwd,
                        "blockwise_attention_fwd": blockwise_attention_fwd,
                        "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                        "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv}
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            result = trainer.fit()
            sync(dev)
            fit_s = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            train.close()
            digest = hashlib.sha256()
            for t in model.state_dict().values():
                digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
            summary = result.history[-1]
            out["fit"] = {
                "launches": launches, "n_eval": len(evl), "eval_count": sum(eval_counts),
                "eval_images": eval_images, "losses": steps.losses, "fit_s": fit_s,
                "digest": digest.hexdigest(), "plan_world": trainer.plan.dp_size,
                "local_batch": train.local_batch_size, "bad_steps": summary["health_bad_steps"],
                "eval_loss": summary["eval_loss"],
                "finite": all(math.isfinite(v) for v in steps.losses)}

            # -- the two-rank step alone on a device-resident local batch -----
            rng = np.random.default_rng(3 + rank)
            local = batch_size // world
            batch = {"image": torch.from_numpy(rng.integers(
                         0, 256, (local, image_size, image_size, 3), dtype=np.uint8)).to(dev),
                     "label": torch.from_numpy(rng.integers(0, 1000, local)).to(dev)}
            state, step = trainer.state, trainer._train_step
            for _ in range(3):
                step(state, batch)
            times = []
            for _ in range(DDP_TIMED):
                sync(dev)
                t0 = time.perf_counter()
                step(state, batch)
                sync(dev)
                times.append(time.perf_counter() - t0)
            out["step_ms"] = statistics.median(times) * 1e3
            out["step_ms_all"] = [t * 1e3 for t in times]
            # the stage alone on this step's gradients: the gradient
            # all-reduce in 25 MB buckets and the metrics' sum
            stage = _MeanSync(trainer.plan)
            zero = torch.zeros((), device=dev)
            times = []
            for i in range(8):
                sync(dev)
                t0 = time.perf_counter()
                stage(state, zero, {"count": zero})
                sync(dev)
                if i >= 3:
                    times.append(time.perf_counter() - t0)
            out["grad_sync_ms"] = statistics.median(times) * 1e3
            if dev.type == "cuda":
                # device time of the step, and of the same step with each
                # rank's BatchNorm on its own rows (cuDNN's, no collective)
                out["profile"] = profile(lambda: step(state, batch),
                                         f"rank {rank}: two-rank step of {local} (sync BN)", top=0)
                with mock.patch.object(_MeanSync, "statistics",
                                       lambda self, model: contextlib.nullcontext()):
                    out["profile_local_bn"] = profile(
                        lambda: step(state, batch),
                        f"rank {rank}: the same step, BatchNorm on the rank's rows", top=0)
            del trainer, state, model, batch
            if dev.type == "cuda":
                torch.cuda.empty_cache()

            # -- f32: two ranks on their halves against one process ------------
            glob = _ddp_batch(image_size, batch_size)
            rows = slice(rank * local, (rank + 1) * local)
            mine = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(dev)
                    for k, v in glob.items()}
            refs = {name: torch.load(Path(out_dir, f"{name}.pt"))
                    for name in ("sync", "local", "sync_plain", "local_accum")}
            for bn_stats, fault in [("sync", None), ("local", None)] + [
                    ("sync", f) for f in DDP_FAULTS]:
                ref = refs[bn_stats]
                f32 = ResNet50(num_classes=1000, device=dev, seed=7, bn_stats=bn_stats,
                               bn_groups=2)
                same_start = all(torch.equal(v.cpu(), ref["start"][k])
                                 for k, v in f32.state_dict().items())
                state = create_train_state(f32, make_optimizer("sgd", 0.1))
                with _planted_bn_fault(fault) if fault else contextlib.nullcontext():
                    state, m = make_train_step(full_precision(), plan=ParallelPlan(mesh=rt.mesh))(
                        state, mine)
                loss = float(m["loss_sum"]) / float(m["count"])
                after = {k: v.cpu() for k, v in f32.state_dict().items()}
                params = [k for k, _ in f32.named_parameters()]
                rel = _update_rel(after, ref, params)
                if fault:
                    out[f"fault_{fault}"] = {"update_rel": rel, "vs_plain": _update_rel(
                        after, refs["sync_plain"], params)}
                    del f32, state
                    continue
                stats_err = max(float(((after[k] - ref["after"][k]).abs()
                                       - DDP_STATS_TOL * (1.0 + ref["after"][k].abs())).max())
                                for k in after if k.endswith(("running_mean", "running_var")))
                digest = hashlib.sha256()
                for t in after.values():
                    digest.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
                out[f"f32_{bn_stats}"] = {
                    "same_start": same_start, "loss": loss, "ref_loss": ref["loss"],
                    "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                    "stats_excess": stats_err, "update_rel": rel,
                    "entry_abs": max(float((after[k] - ref["after"][k]).abs().max())
                                     for k in params),
                    "groups": sorted({mod.groups for mod in f32.modules()
                                      if isinstance(mod, ReplicaGroupedBatchNorm)}),
                    "digest": digest.hexdigest()}
                if bn_stats == "local":
                    out["f32_local"]["vs_shapes"] = _update_rel(after, refs["local_accum"], params)
                else:
                    out["f32_sync"]["vs_plain"] = _update_rel(after, refs["sync_plain"], params)
                del f32, state
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def ddp_phase(card: str, timeout_s: float = 900.0, device: str = "cuda:0",
              image_size: int = 224, batch_size: int = TRAIN_BATCH) -> dict:
    """Uncompressed data parallelism on one card: two spawned gloo ranks
    (NCCL refuses two ranks on one device) train ResNet50-1K as phase 5
    configures it through ``Trainer(plan=ParallelPlan(mesh=rt.mesh)).fit()``
    (the main path, counted on each rank), time the two-rank step, and hold
    one f32 step against one process's on the global batch, for sync and
    local BatchNorm.  Returns the ranks' launch counts and a summary.  The
    device and sizes are arguments so the phase can be rehearsed small on
    the CPU."""
    import math
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        control = _ddp_reference(torch.device(device), image_size, batch_size, tmp)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_ddp_child, args=(r, 2, f"{tmp}/store", tmp, device,
                                                      image_size, batch_size))
                 for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, timeout_s - (time.perf_counter() - t0)))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        check(not hung, f"ddp phase: ranks {hung} hung past {timeout_s} s")
        res = []
        for r in range(2):
            f = Path(tmp, f"rank{r}.json")
            check(f.exists(), f"ddp phase: rank {r} wrote nothing (exit {procs[r].exitcode})")
            res.append(json.loads(f.read_text()))
    for r, out in enumerate(res):
        check("error" not in out, f"ddp phase, rank {r}:\n{out.get('error')}")
    fits = [o["fit"] for o in res]
    n_eval = fits[0]["n_eval"]
    expected = {"normalize": DDP_STEPS + n_eval, "cross_entropy_fwd": DDP_STEPS + n_eval,
                "cross_entropy_bwd": DDP_STEPS, "blockwise_attention_fwd": 0,
                "blockwise_attention_bwd_dq": 0, "blockwise_attention_bwd_dkv": 0}
    for r, f in enumerate(fits):
        check(f["launches"] == expected, f"ddp rank {r} launches {f['launches']} != {expected}")
        check(f["plan_world"] == 2 and f["local_batch"] == batch_size // 2,
              f"ddp rank {r}: plan world {f['plan_world']}, local batch {f['local_batch']}")
        check(f["eval_count"] == f["eval_images"],
              f"ddp rank {r}: eval counted {f['eval_count']} of {f['eval_images']} images")
        check(f["finite"] and len(f["losses"]) == DDP_STEPS, f"ddp rank {r} losses {f['losses']}")
        check(abs(f["losses"][0] - math.log(1000)) <= 1.0,
              f"ddp first-step loss {f['losses'][0]:.4f} not within 1.0 of ln 1000")
        check(f["bad_steps"] == 0.0, f"ddp rank {r}: {f['bad_steps']} bad steps")
    check(fits[0]["digest"] == fits[1]["digest"],
          "the two ranks ended the fit with different parameters or BatchNorm buffers")
    check(fits[0]["losses"] == fits[1]["losses"], "the two ranks logged different losses")
    log(f"  two gloo ranks on one card, ResNet50-1K bf16 through Trainer(plan).fit(): "
        f"{DDP_STEPS} steps of {batch_size} ({batch_size // 2} a rank) + eval of "
        f"{fits[0]['eval_images']} images, counted once each; launches a rank "
        f"{fits[0]['launches']} (expected {expected}); step losses "
        f"{[round(v, 4) for v in fits[0]['losses']]}; parameters and BN buffers bit-equal on "
        f"both ranks ({fits[0]['fit_s']:.2f} s)")
    f32 = {}
    for bn_stats in ("sync", "local"):
        a, b = (o[f"f32_{bn_stats}"] for o in res)
        check(a["same_start"] and b["same_start"], f"f32 {bn_stats}: ranks started elsewhere")
        check(a["digest"] == b["digest"] and a["loss"] == b["loss"],
              f"f32 {bn_stats}: the ranks ended the step apart")
        check(a["groups"] == [1 if bn_stats == "sync" else 2], f"f32 {bn_stats}: groups {a}")
        log(f"  f32 step, two ranks vs one process ({bn_stats} BN, ResNet50-1K, {image_size} px, "
            f"batch {batch_size}): loss rel diff {a['loss_rel']:.3g} (tol {DDP_LOSS_RTOL}), "
            f"running statistics within {DDP_STATS_TOL} (excess {a['stats_excess']:.3g}), update "
            f"rel diff {a['update_rel']:.3g} (tol {DDP_UPDATE_RTOL}; one process against itself "
            f"with deterministic cuDNN: {control[bn_stats]:.3g}); largest entry diff "
            f"{a['entry_abs']:.3g}")
        check(a["loss_rel"] <= DDP_LOSS_RTOL, f"f32 {bn_stats} loss rel diff {a['loss_rel']}")
        check(a["stats_excess"] <= 0.0,
              f"f32 {bn_stats} running statistics beyond {DDP_STATS_TOL} (atol and rtol): {a}")
        check(a["update_rel"] <= DDP_UPDATE_RTOL, f"f32 {bn_stats} update rel diff {a}")
        f32[bn_stats] = {k: a[k] for k in ("loss_rel", "stats_excess", "update_rel", "entry_abs")}
        f32[bn_stats]["control_rel"] = control[bn_stats]
    a = res[0]["f32_local"]
    log(f"  local BN's step in one process at the ranks' shapes (two microbatches of "
        f"{batch_size // 2}): "
        f"update rel diff {control['local_shapes']:.3g} from one process at batch 128; the "
        f"two ranks {a['vs_shapes']:.3g} from it (tol {DDP_SHAPES_RTOL})")
    check(a["vs_shapes"] <= DDP_SHAPES_RTOL, f"f32 local against the microbatched step: {a}")
    f32["local"].update(vs_shapes=a["vs_shapes"], shapes_rel=control["local_shapes"])
    a = res[0]["f32_sync"]
    log(f"  sync BN's plain ops in one process (every BatchNorm through the cross-rank function "
        f"on a one-rank gloo group, batch {batch_size}): update rel diff "
        f"{control['sync_plain']:.3g} from cuDNN's step (loss rel diff "
        f"{control['sync_plain_loss_rel']:.3g}); the two ranks {a['vs_plain']:.3g} from it "
        f"(tol {DDP_UPDATE_RTOL}); "
        f"cuDNN's step on images moved by 1e-7 of themselves {control['ulp_input']:.3g} from "
        f"cuDNN's step (rounding alone)")
    check(a["vs_plain"] <= DDP_UPDATE_RTOL, f"f32 sync against the plain-op step: {a}")
    f32["sync"].update(vs_plain=a["vs_plain"], plain_rel=control["sync_plain"],
                       ulp_input_rel=control["ulp_input"])
    faults = {}
    for fault in DDP_FAULTS:
        fa, fb = (o[f"fault_{fault}"] for o in res)
        faults[fault] = fa
        log(f"  planted fault of the sync backward, {fault}: update rel diff "
            f"{fa['update_rel']:.3g} from one process's step (limit {DDP_UPDATE_RTOL}), "
            f"{fa['vs_plain']:.3g} from the plain-op one")
        check(fa["update_rel"] > DDP_UPDATE_RTOL and fb["update_rel"] > DDP_UPDATE_RTOL,
              f"the update's limit {DDP_UPDATE_RTOL} misses the planted fault {fault!r}: {fa}")
    f32["faults"] = faults
    step_ms = max(o["step_ms"] for o in res)
    img_s = batch_size / (step_ms / 1e3)
    grad_sync_ms = max(o["grad_sync_ms"] for o in res)
    log(f"  two-rank step alone (bf16, {batch_size // 2} a rank, gloo: every collective goes "
        f"through the host): median {step_ms:.2f} ms over {DDP_TIMED} steps = {img_s:.1f} img/s "
        f"on {card}; a correctness phase, not a scaling number")
    log(f"  of which the gradient all-reduce (25,557,032 f32 in 25 MB buckets) and the metrics' "
        f"sum alone: median {grad_sync_ms:.2f} ms")
    profiles = {}
    if "profile" in res[0]:
        for key, what in (("profile", "sync BN"),
                          ("profile_local_bn", "BatchNorm on the rank's rows (cuDNN)")):
            ps = [o[key] for o in res]
            profiles[key] = {k: [p[k] for p in ps] for k in ("wall_ms", "device_ms", "launches")}
            r = profiles[key]
            log(f"  profile of the two-rank step, {what}: device {r['device_ms']} ms over "
                f"{r['launches']} launches, wall {r['wall_ms']} ms (ranks 0, 1) on {card}")
    out = {"launches": fits[0]["launches"], "step_ms": step_ms, "img_per_s": img_s,
           "grad_sync_ms": grad_sync_ms,
           "step_ms_ranks": [o["step_ms_all"] for o in res], "f32": f32, "profiles": profiles,
           "fit_s": fits[0]["fit_s"], "losses": fits[0]["losses"], "card": card,
           "seconds": time.perf_counter() - t0}
    log("  ddp_json " + json.dumps(out))
    return out


def main() -> int:
    log("== phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {kind}, "
        f"count {torch.cuda.device_count()}")
    log(f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    log("== phase 2: build")
    from tpuframe_torch.ops import build

    t0 = time.perf_counter()
    # the K2 and K6 baselines' nvcc run beside the port's
    baseline, baseline_k6 = start_baseline_build(), start_baseline_build(BASELINE_K6)
    report = build.build()
    baseline, baseline_k6 = baseline_library(baseline), baseline_library(baseline_k6)
    log(f"  built {sorted(report)} and the K2 and K6 baselines in "
        f"{time.perf_counter() - t0:.2f} s")
    regs = {}
    for name, text in [(n, r["log"]) for n, r in report.items()] + [
            (BASELINE_K6.stem, baseline_k6.build_log)]:
        regs[name] = ptxas_table(text)
        for fn, t in regs[name].items():
            log(f"  {name}: {fn} {t['registers']} registers, spill stores/loads "
                f"{t['spill_stores']}/{t['spill_loads']} bytes")

    log("== phase 3: kernels")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    floor_ms = floor_phase(flush)
    log(f"  launch floor: {floor_ms * 1e3:.2f} us (the empty kernel, CUDA events after the "
        f"L2 flush) on {card}")
    k1 = kernel_phase(flush, floor_ms)
    log(f"  normalize 64x224x224x3 uint8->bf16: kernel {k1['ms'] * 1e3:.2f} us, "
        f"plain {k1['plain_ms'] * 1e3:.2f} us, torch.addcmul {k1['library_ms'] * 1e3:.2f} us, "
        f"bound {k1['bound_ms'] * 1e3:.2f} us "
        f"({k1['bytes_moved'] / 1e6:.2f} MB at 3.35 TB/s) on {card}")
    k2a, k2b = cross_entropy_phase(flush, floor_ms, baseline)
    k3a, k3b = layer_norm_phase(flush)
    from tpuframe_torch.models import TransformerLM

    k4 = adamw_phase(flush, [tuple(p.shape) for p in TransformerLM(**LM).parameters()])
    k5a, k5b, k5c = quant_wire_phase(flush)
    k6a, k6b, k6c = blockwise_phase(flush, baseline_k6)
    for k, fn in ((k6a, "attn_fwd_tc"), (k6b, "attn_bwd_dq_tc"), (k6c, "attn_bwd_dkv_tc")):
        k["ptxas"] = {f"D={d}": regs["blockwise_attention"].get(f"{fn}<{d}>")
                      for d in (16, 32, 64, 128)}
    del flush
    torch.cuda.empty_cache()
    from tpuframe_torch.ops.blockwise_attention import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
    )

    k6_counters = (blockwise_attention_fwd, blockwise_attention_bwd_dq, blockwise_attention_bwd_dkv)
    for fn in k6_counters:  # phases 4 to 10 run no long context: K6 must stay at 0
        fn.launches = 0

    log("== phase 4: serve")
    serve_launches = slice_phase(card)["launches"]["normalize"]

    log("== phase 5: train")
    train_launches, _ = train_phase(card)
    torch.cuda.empty_cache()

    log("== phase 6: LM train")
    lm_launches, _ = lm_phase(card)
    torch.cuda.empty_cache()

    log("== phase 7: checkpoint and resume")
    checkpoint_phase(card)
    torch.cuda.empty_cache()

    log("== phase 8: compressed data-parallel train")
    dp_launches, _ = dp_phase(card)
    torch.cuda.empty_cache()

    log("== phase 9: two ranks on one card")
    two_rank_phase()

    log("== phase 10: uncompressed data parallelism on one card")
    ddp = ddp_phase(card)
    k6_early = [fn.launches for fn in k6_counters]
    log(f"  K6 launches over phases 4 to 10 in this process: {k6_early} (each rank of phase 10: "
        f"{[ddp['launches'][n] for n in ('blockwise_attention_fwd', 'blockwise_attention_bwd_dq', 'blockwise_attention_bwd_dkv')]})")
    check(k6_early == [0, 0, 0], f"K6 launched {k6_early} times in phases 4 to 10")
    torch.cuda.empty_cache()

    log("== phase 11: ViT serve")
    vit = vit_serve_phase(card)
    torch.cuda.empty_cache()

    log("== phase 12: long-context LM train")
    long_launches, long = long_context_phase(card)
    torch.cuda.empty_cache()

    # each kernel's launches on the main paths that run it: K1 serve and
    # train, K2 the ResNet train, K3 and K4 the LM train (where K1 and K2
    # launched no time), K5 the compressed train (which also runs K1 and K2,
    # at phase 5's counts)
    k1["launches"] = serve_launches + train_launches["normalize"]
    k1["launches_serve"] = serve_launches
    k1["launches_train"] = train_launches["normalize"]
    k2a["launches"] = train_launches["cross_entropy_fwd"]
    k2b["launches"] = train_launches["cross_entropy_bwd"]
    k3a["launches"] = lm_launches["layer_norm_fwd"]
    k3b["launches"] = lm_launches["layer_norm_bwd"]
    k4["launches"] = lm_launches["fused_adamw"]
    k5a["launches"] = dp_launches["bucket_abs_max"]
    k5b["launches"] = dp_launches["quant_encode"]
    k5c["launches"] = dp_launches["quant_decode"]
    # phase 10's launches on each of its two ranks, beside the other paths
    k1["launches_ddp"] = ddp["launches"]["normalize"]
    k2a["launches_ddp"] = ddp["launches"]["cross_entropy_fwd"]
    k2b["launches_ddp"] = ddp["launches"]["cross_entropy_bwd"]
    # K6 on the long-context LM's fit (phase 12), the long_remat fit beside
    # it; K3a also on the ViT serve (phase 11)
    for k, name in ((k6a, "blockwise_attention_fwd"), (k6b, "blockwise_attention_bwd_dq"),
                    (k6c, "blockwise_attention_bwd_dkv")):
        k["launches"] = long_launches["long_ctx"][name]
        k["launches_remat"] = long_launches["long_remat"][name]
    k1["launches_vit_serve"] = vit["launches"]["normalize"]
    k3a["launches_vit_serve"] = vit["launches"]["layer_norm_fwd"]
    k3a["launches_long_ctx"] = long_launches["long_ctx"]["layer_norm_fwd"]

    log("== phase 13: result")
    kernels = [k1, k2a, k2b, k3a, k3b, k4, k5a, k5b, k5c, k6a, k6b, k6c]
    for k in kernels:
        k["floor_ms"] = floor_ms  # beside bound_ms, which stays the byte or operation bound
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
