#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpuframe_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit, no result line):

1. Device: the card's name and power limit from ``nvidia-smi``; no CUDA,
   no run.
2. Build: every CUDA kernel of the port, compiled from ``tpuframe_torch/
   csrc`` with ``nvcc`` for ``sm_90a``.
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serve path gives it and at ragged ones, timed with CUDA
   events (median of 100 launches after warm-up, L2 flushed before each)
   beside its plain version and one library call of the same function
   (``torch.addcmul`` into a bf16 ``out=``).
4. Slice: ResNet50 with 1000 classes under ``bf16_compute`` serves 160
   uint8 224x224 images through ``ServeEngine`` (buckets 1/8/32/64) from 4
   client threads, plus one ``POST /predict`` through ``ServingServer``.
   Launch counters are zeroed just before and read just after; every
   kernel of the path must have launched.  Served rows are held against
   direct predicts, against predicts through the plain normalize, and an
   f32 forward on the card against the same forward on the CPU.
5. Result: a ``kernels`` JSON line, the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import functools
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
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


def kernel_phase(flush):
    from tpuframe_torch.ops.normalize import (
        normalize_images,
        normalize_images_reference,
    )

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    serve = torch.from_numpy(
        rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)).to(dev)
    ragged = torch.from_numpy(
        rng.integers(0, 256, (3, 17, 17, 3), dtype=np.uint8)).to(dev)
    flat = torch.empty(ragged.numel() + 1, dtype=torch.uint8, device=dev)
    unaligned = flat[1:].view(ragged.shape)  # contiguous, 1 byte off 16
    unaligned.copy_(ragged)
    gray = torch.from_numpy(rng.random((2, 28, 28, 1), dtype=np.float32)).to(dev)
    cases = [
        ("64x224x224x3 uint8->bf16", serve, MEAN, STD, 1 / 255, torch.bfloat16),
        ("64x224x224x3 uint8->f32", serve, MEAN, STD, 1 / 255, torch.float32),
        ("3x17x17x3 uint8->f32", ragged, MEAN, STD, 1 / 255, torch.float32),
        ("3x17x17x3 uint8->bf16", ragged, MEAN, STD, 1 / 255, torch.bfloat16),
        ("3x17x17x3 unaligned uint8->bf16", unaligned, MEAN, STD, 1 / 255,
         torch.bfloat16),
        ("2x28x28x1 f32 scale=1 ->f32", gray, (0.5,), (0.5,), 1.0, torch.float32),
        ("2x28x28x1 f32 scale=1 ->bf16", gray, (0.5,), (0.5,), 1.0, torch.bfloat16),
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
        if x is serve and out_dtype == torch.bfloat16:
            max_err = err

    # the library yardstick: one TensorIterator launch computing b + x * w
    # from uint8 into bf16 with the same folded f32 constants; the port
    # never calls it
    w_t = torch.tensor([(1 / 255) / s for s in STD], dtype=torch.float32, device=dev)
    b_t = torch.tensor([-m / s for m, s in zip(MEAN, STD)], dtype=torch.float32, device=dev)
    lib_out = torch.empty(serve.shape, dtype=torch.bfloat16, device=dev)
    library = functools.partial(torch.addcmul, b_t, serve, w_t, out=lib_out)
    library()
    want = normalize_images_reference(serve, MEAN, STD, out_dtype=torch.bfloat16)
    lib_ulps = bf16_ulp_distance(lib_out, want)
    check(lib_ulps <= 1, f"torch.addcmul yardstick: {lib_ulps} bf16 ulps from plain (tol 1)")
    log(f"  torch.addcmul yardstick 64x224x224x3 uint8->bf16: {lib_ulps} bf16 ulp "
        f"from the plain version (tol 1)")

    kernel = functools.partial(normalize_images, serve, MEAN, STD,
                               out_dtype=torch.bfloat16)
    plain = functools.partial(normalize_images_reference, serve, MEAN, STD,
                              out_dtype=torch.bfloat16)
    # plain, kernel, library, library, kernel, plain: the pairs bracket any
    # drift of the card
    plain_ms = [time_ms(plain, flush)]
    kernel_ms = [time_ms(kernel, flush)]
    library_ms = [time_ms(library, flush), time_ms(library, flush)]
    kernel_ms.append(time_ms(kernel, flush))
    plain_ms.append(time_ms(plain, flush))
    n = serve.numel()
    moved = n * 1 + n * 2  # uint8 in, bf16 out
    return {
        "name": "normalize",
        "route": "cuda",
        "source": "tpuframe_torch/csrc/normalize.cu",
        "replaces": "tpuframe/ops/normalize.py:48",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": min(kernel_ms),
        "plain_ms": min(plain_ms),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": min(library_ms),  # torch.addcmul into a bf16 out=
        "shape": "64x224x224x3 uint8->bf16",
        "bytes_moved": moved,
    }


def profile_batch(predict, model, x: torch.Tensor, top: int = 12) -> None:
    """Where one full bucket's predict spends its time: host wall time of
    the call, device time summed over its kernels (``torch.profiler``),
    and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    predict(model, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict(model, x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict(model, x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"  profile, predict of {tuple(x.shape)}: wall {wall_ms:.2f} ms, device "
        f"{total_ms:.2f} ms over {launches} kernel launches "
        f"(device busy {total_ms / wall_ms:.0%} of wall)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"    {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")


def slice_phase(card: str):
    from tpuframe_torch.core import initialize
    from tpuframe_torch.models import ResNet50, from_jax_variables, import_torch_resnet
    from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference
    from tpuframe_torch.parallel import align_model_dtype, bf16_compute, full_precision
    from tpuframe_torch.serve import ServeEngine, ServeKnobs, ServingServer
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import make_predict_fn

    rt = initialize()
    dev = rt.device
    model = ResNet50(num_classes=1000, device=dev)
    variables = random_jax_variables(import_torch_resnet(model.state_dict()), seed=0)
    model.load_state_dict(from_jax_variables(variables))
    policy = bf16_compute()
    align_model_dtype(model, policy)
    predict = make_predict_fn(policy, functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=policy.compute_dtype))
    engine = ServeEngine(
        functools.partial(predict, model),
        knobs=ServeKnobs(buckets=BUCKETS, slo_ms=60_000, queue_cap=1024,
                         batch_wait_ms=5.0),
        item_shape=(224, 224, 3), dtype="uint8",
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
        normalize_images.launches = 0
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
        launches = normalize_images.launches
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
    check(launches > 0 and launches == batches,
          f"normalize launched {launches} times for {batches} served batches")
    log(f"  served {N_REQUESTS} + 1 HTTP requests in {batches} batches; "
        f"normalize launches {launches}")
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

    profile_batch(predict, model, torch.from_numpy(images[:BUCKETS[-1]]).to(dev))

    # f32 on the card (TF32 off) against the same model on the CPU
    align_model_dtype(model, full_precision())
    predict32 = make_predict_fn(full_precision(), functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32))
    x2 = torch.from_numpy(images[:2])
    on_card = predict32(model, x2.to(dev)).cpu()
    model_cpu = model.to("cpu")
    on_cpu = predict32(model_cpu, x2)
    f32_err = float((on_card - on_cpu).abs().max()) / float(on_cpu.abs().max())
    log(f"  f32 card vs CPU: max |diff| / max|logit| = {f32_err:.3g} (tol {F32_REL_TOL}), "
        f"max|logit| {float(on_cpu.abs().max()):.4g}")
    check(f32_err <= F32_REL_TOL, f"f32 card vs CPU rel err {f32_err}")

    ms = [v * 1e3 for v in lat]
    summary = {
        "requests": N_REQUESTS,
        "clients": N_CLIENTS,
        "batches": batches,
        "req_per_s": N_REQUESTS / wall,
        "p50_ms": ms[len(ms) // 2],
        "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
        "card": card,
    }
    log(f"  serve: {summary['req_per_s']:.1f} req/s, p50 {summary['p50_ms']:.1f} ms, "
        f"p99 {summary['p99_ms']:.1f} ms over {N_REQUESTS} requests "
        f"({N_CLIENTS} clients, buckets {BUCKETS}) on {card}")
    log("  serve_json " + json.dumps(summary))
    return launches


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
    report = build.build()
    log(f"  built {sorted(report)} in {time.perf_counter() - t0:.2f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("== phase 3: kernels")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    k1 = kernel_phase(flush)
    del flush
    log(f"  normalize 64x224x224x3 uint8->bf16: kernel {k1['ms'] * 1e3:.2f} us, "
        f"plain {k1['plain_ms'] * 1e3:.2f} us, torch.addcmul {k1['library_ms'] * 1e3:.2f} us, "
        f"bound {k1['bound_ms'] * 1e3:.2f} us "
        f"({k1['bytes_moved'] / 1e6:.2f} MB at 3.35 TB/s) on {card}")

    log("== phase 4: slice")
    k1["launches"] = slice_phase(card)

    log("== phase 5: result")
    print(json.dumps({"kernels": [k1]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
