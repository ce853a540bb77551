"""Fused AdamW: one kernel launch for the moment and parameter update of a
whole list of tensors (K4).

Port of ``tpuframe/ops/fused_adamw.py``.  Exposed four ways:

- :func:`fused_adamw_update` — leaf-level ``(p, g, m, v, step) -> (p', m',
  v')``, as in JAX (new tensors).
- :func:`fused_adamw_update_` — the same update of one tensor in place: a
  CUDA tensor launches K4 (``csrc/fused_adamw.cu``) over a one-entry
  table, a CPU tensor takes the plain :func:`fused_adamw_update_reference`.
- :func:`fused_adamw_multi_update_` — a list of tensors in place: on the
  card one K4 launch for every :data:`TABLE_CAPACITY` tensors, on the CPU
  the plain version tensor by tensor, in the same groups.
- :func:`fused_adamw` — the drop-in for the JAX ``optax`` transform: an
  ``OptimizerSpec`` (what the port's ``Trainer`` takes as ``tx``) whose
  optimizer, :class:`FusedAdamW`, keeps ``count``, ``mu`` and ``nu`` as
  tensors in ``optimizer.state``, so the health sentinel restores them on a
  skipped step as JAX restores ``FusedAdamWState``.

Parameters keep their dtype; the moments are float32.  ``count`` is one
int32 device scalar per parameter, raised with one fused add per step and
read by the kernel from device memory, so a step never waits for the host.
Every element is computed by the same expression whatever the list, so a
tensor updated in a list gets the bits it gets alone.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from tpuframe_torch.ops import build
from tpuframe_torch.ops.dispatch import use_kernel
from tpuframe_torch.train.optim import OptimizerSpec

__all__ = [
    "TABLE_CAPACITY",
    "AdamWTable",
    "FusedAdamW",
    "fused_adamw",
    "fused_adamw_multi_update_",
    "fused_adamw_update",
    "fused_adamw_update_",
    "fused_adamw_update_reference",
]

#: tensors of one kernel launch (``kCapacity`` in ``csrc/fused_adamw.cu``)
TABLE_CAPACITY = 256

_P_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = build.load("fused_adamw")
    lib.tf_fused_adamw.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        *([ctypes.c_float] * 9),
        ctypes.c_void_p,
    ]
    lib.tf_fused_adamw.restype = ctypes.c_int
    lib.tf_fused_adamw_capacity.restype = ctypes.c_int
    if lib.tf_fused_adamw_capacity() != TABLE_CAPACITY:
        raise RuntimeError(f"fused AdamW kernel takes {lib.tf_fused_adamw_capacity()} tensors a "
                           f"launch, the wrapper {TABLE_CAPACITY}")
    return lib


def _update_math(p, g, m, v, t, *, lr, b1, b2, eps, weight_decay):
    """The shared math (float32): AdamW with bias correction and decoupled
    decay; ``b**t`` is ``exp(t * log(b))``, 0 where ``b == 0``."""

    def pow_t(b):
        return torch.exp(t * math.log(b)) if b > 0.0 else torch.zeros_like(t)

    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    mhat = m / (1.0 - pow_t(b1))
    vhat = v / (1.0 - pow_t(b2))
    p = p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)
    return p, m, v


def fused_adamw_update_reference(p, g, m, v, step, *, lr: float, b1: float = 0.9,
                                 b2: float = 0.999, eps: float = 1e-8,
                                 weight_decay: float = 0.0):
    """Plain version: ``(p', m', v')`` as new tensors, ``p'`` in the ``p``
    dtype and the moments float32; ``step`` is the 1-based count."""
    pn, mn, vn = _update_math(p.float(), g.float(), m.float(), v.float(), step.float(),
                              lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return pn.to(p.dtype), mn, vn


def _check(p, g, m, v, count) -> None:
    if p.dtype not in _P_CODES or g.dtype != p.dtype:
        raise TypeError(
            f"fused AdamW kernel takes float32 or bfloat16 p and g of one dtype, got "
            f"{p.dtype} and {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"fused AdamW kernel takes float32 moments, got {m.dtype} and {v.dtype}")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise TypeError(f"the step count is one int32 value, got {count.dtype} "
                        f"{tuple(count.shape)}")
    if not (g.shape == m.shape == v.shape == p.shape):
        raise ValueError(
            f"p, g, m, v shapes differ: {tuple(p.shape)} {tuple(g.shape)} "
            f"{tuple(m.shape)} {tuple(v.shape)}")
    if any(t.device != p.device for t in (g, m, v, count)):
        raise ValueError("p, g, m, v and the count must lie on one device")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("fused AdamW kernel needs contiguous p, g, m and v")


class AdamWTable:
    """The host table of K4's launches over fixed tensors on the card: per
    tensor the addresses of ``p``, ``g``, ``m``, ``v`` and its count, and
    its element count (six int64 a row, what ``tf_fused_adamw`` reads).

    ``p``, ``m``, ``v`` and the counts are checked and their addresses read
    once, here; :meth:`fill` writes each call's gradients.  The tensors are
    updated in place, so the addresses hold for as long as the caller keeps
    the same tensors."""

    def __init__(self, ps, ms, vs, counts):
        if not ps or not len(ps) == len(ms) == len(vs) == len(counts):
            raise ValueError(f"a table of {len(ps)} p, {len(ms)} m, {len(vs)} v, {len(counts)} "
                             "counts")
        self.dtype, self.device = ps[0].dtype, ps[0].device
        for p, m, v, c in zip(ps, ms, vs, counts):
            _check(p, p, m, v, c)
            if p.dtype != self.dtype or p.device != self.device:
                raise ValueError(f"one launch takes one dtype on one device, got {p.dtype} on "
                                 f"{p.device} beside {self.dtype} on {self.device}")
        self.shapes = [p.shape for p in ps]
        self.rows = np.array([(p.data_ptr(), 0, m.data_ptr(), v.data_ptr(), c.data_ptr(),
                               p.numel()) for p, m, v, c in zip(ps, ms, vs, counts)],
                             dtype=np.int64)

    def fill(self, gs) -> list[torch.Tensor]:
        """Write the addresses of ``gs``, one gradient per row; checks their
        dtype, device and shape, and copies a non-contiguous one.  Returns
        the gradients the rows point at: keep them until the launch."""
        dt, dev = self.dtype, self.device.index
        if not (len(gs) == len(self.shapes) and all(g.dtype is dt for g in gs)
                and all(g.get_device() == dev for g in gs)
                and [g.shape for g in gs] == self.shapes):
            for g, shape in zip(gs, self.shapes):
                if g.dtype is not dt:
                    raise TypeError(f"fused AdamW kernel takes p and g of one dtype, got {dt} "
                                    f"and {g.dtype}")
                if g.get_device() != dev:
                    raise ValueError(f"a gradient on {g.device}, its parameter on {self.device}")
                if g.shape != shape:
                    raise ValueError(f"a gradient of shape {tuple(g.shape)} for a parameter of "
                                     f"{tuple(shape)}")
            raise ValueError(f"{len(gs)} gradients for a table of {len(self.shapes)} tensors")
        gs = [g if g.is_contiguous() else g.contiguous() for g in gs]
        self.rows[:, 1] = [g.data_ptr() for g in gs]
        return gs


def _launch(rows: np.ndarray, dtype: torch.dtype, device: torch.device, hp: dict) -> None:
    """One K4 launch over ``rows`` (at most TABLE_CAPACITY rows of a table,
    C-contiguous int64) on the current stream; raises if the launch
    fails."""
    b1, b2 = hp["b1"], hp["b2"]
    with torch.cuda.device(device):
        rc = _library().tf_fused_adamw(
            rows.ctypes.data, len(rows), _P_CODES[dtype],
            hp["lr"], b1, b2, 1.0 - b1, 1.0 - b2,
            math.log(b1) if b1 > 0.0 else 0.0, math.log(b2) if b2 > 0.0 else 0.0,
            hp["eps"], hp["weight_decay"],
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused AdamW kernel launch failed: CUDA error {rc}")


def _plain_(ps, gs, ms, vs, counts, hp: dict) -> None:
    """The plain version over one launch's worth of tensors, in place."""
    for p, g, m, v, c in zip(ps, gs, ms, vs, counts):
        pn, mn, vn = fused_adamw_update_reference(p, g, m, v, c, **hp)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)


@torch.no_grad()
def fused_adamw_multi_update_(ps, gs, ms, vs, counts, *, lr: float, b1: float = 0.9,
                              b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                              table: AdamWTable | None = None) -> None:
    """One AdamW step of every tensor of a list, in place on each ``p``,
    ``m`` and ``v``; ``counts`` holds each tensor's 1-based step (an int32
    scalar on the device).  The ``p`` share one dtype.

    On the card one K4 launch updates :data:`TABLE_CAPACITY` tensors, so a
    longer list takes ``ceil(len / TABLE_CAPACITY)`` launches, on the
    current stream.  ``table`` (an :class:`AdamWTable` of the same ``ps``,
    ``ms``, ``vs`` and ``counts``) spares the checks and address reads of
    everything but the gradients: what :class:`FusedAdamW` keeps between
    steps.  A CPU list takes :func:`fused_adamw_update_reference` tensor by
    tensor, in the same groups.  ``fused_adamw_multi_update_.launches``
    counts kernel launches."""
    n = len(ps)
    if not len(gs) == len(ms) == len(vs) == len(counts) == n:
        raise ValueError(f"{n} p, {len(gs)} g, {len(ms)} m, {len(vs)} v, {len(counts)} counts")
    if n == 0:
        return
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if not use_kernel(ps[0]):
        if any(use_kernel(p) for p in ps):
            raise ValueError("a list of CPU and CUDA tensors: one list lies on one device")
        for lo in range(0, n, TABLE_CAPACITY):
            hi = lo + TABLE_CAPACITY
            _plain_(ps[lo:hi], gs[lo:hi], ms[lo:hi], vs[lo:hi], counts[lo:hi], hp)
        return
    if table is None:
        table = AdamWTable(ps, ms, vs, counts)
    elif len(table.shapes) != n:
        raise ValueError(f"a table of {len(table.shapes)} tensors for a list of {n}")
    keep = table.fill(gs)  # noqa: F841  (the gradients the table points at)
    for lo in range(0, n, TABLE_CAPACITY):
        _launch(table.rows[lo:lo + TABLE_CAPACITY], table.dtype, table.device, hp)
        fused_adamw_multi_update_.launches += 1


@torch.no_grad()
def fused_adamw_update_(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                        count: torch.Tensor, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One AdamW step of one tensor, in place on ``p``, ``m`` and ``v``;
    ``count`` is the 1-based step (an int32 scalar on the device).

    A CUDA tensor launches K4 over a one-entry table on the current stream;
    a CPU tensor takes :func:`fused_adamw_update_reference`.
    ``fused_adamw_update_.launches`` counts kernel launches."""
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if not use_kernel(p):
        _plain_([p], [g], [m], [v], [count], hp)
        return
    _check(p, g, m, v, count)
    row = np.array([(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), count.data_ptr(),
                     p.numel())], dtype=np.int64)
    _launch(row, p.dtype, p.device, hp)
    fused_adamw_update_.launches += 1


fused_adamw_multi_update_.launches = 0
fused_adamw_update_.launches = 0


def fused_adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       step: torch.Tensor, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8, weight_decay: float = 0.0):
    """One AdamW step of one tensor as new tensors ``(p', m', v')`` (the JAX
    function's form); ``step`` is the 1-based count (an integer scalar)."""
    p, m, v = p.detach().clone(), m.detach().float().clone(), v.detach().float().clone()
    fused_adamw_update_(p, g.detach().contiguous(), m, v, step.to(p.device, torch.int32),
                        lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return p, m, v


class FusedAdamW(torch.optim.Optimizer):
    """AdamW whose update is K4 on the card, one launch per parameter group
    and dtype (:func:`fused_adamw_multi_update_`).

    State per parameter: ``count`` (int32 scalar on the parameter's
    device), ``mu`` and ``nu`` (float32 zeros like the parameter), created
    with the optimizer as optax's ``init`` creates them.  ``step()`` raises
    the counts of the parameters that have a gradient with one fused add,
    then updates them.  The launch table of a group is built, and its
    tensors checked, at the first step; it is built anew when the group's
    parameters with a gradient change, and after ``load_state_dict`` or a
    copy.  Parameters and state are updated in place, so their addresses
    hold."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "count": torch.zeros((), dtype=torch.int32, device=p.device),
                    "mu": torch.zeros_like(p, dtype=torch.float32),
                    "nu": torch.zeros_like(p, dtype=torch.float32),
                }
        self._launch_plans: dict[int, tuple] = {}

    def __setstate__(self, state):
        # a copied or loaded optimizer builds its tables anew
        super().__setstate__(state)
        self._launch_plans = {}

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load, except that the state keeps its own dtypes (the
        int32 count and float32 moments of JAX's ``FusedAdamWState``):
        torch casts every state tensor to its parameter's dtype."""
        super().load_state_dict(state_dict)
        saved = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(saved, params):
            if i in state_dict["state"]:
                self.state[p] = {k: v.to(device=p.device, copy=True)
                                 for k, v in state_dict["state"][i].items()}

    def _plan(self, index: int, params: list) -> tuple:
        """(counts, parts) of group ``index`` for these ``params``: every
        count, and per (device, dtype) the parameters, moments, counts and
        launch table (None on the CPU)."""
        key = tuple(map(id, params))
        plan = self._launch_plans.get(index)
        if plan is not None and plan[0] == key:
            return plan[1], plan[2]
        states = [self.state[p] for p in params]
        split: dict = {}
        for p, st in zip(params, states):
            split.setdefault((p.device, p.dtype), []).append((p, st["mu"], st["nu"], st["count"]))
        parts = []
        for (device, _), members in split.items():
            ps, ms, vs, cs = (list(col) for col in zip(*members))
            table = AdamWTable(ps, ms, vs, cs) if device.type == "cuda" else None
            parts.append((ps, ms, vs, cs, table))
        counts = [st["count"] for st in states]
        # the plan holds the params, so their ids stay theirs
        self._launch_plans[index] = (key, counts, parts, params)
        return counts, parts

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdamW.step takes no closure")
        for index, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr = group["lr"]
            if torch.is_tensor(lr):
                raise TypeError("FusedAdamW takes a float lr (the kernel's argument)")
            counts, parts = self._plan(index, params)
            torch._foreach_add_(counts, 1)
            for ps, ms, vs, cs, table in parts:
                fused_adamw_multi_update_(ps, [p.grad for p in ps], ms, vs, cs, lr=float(lr),
                                          b1=group["b1"], b2=group["b2"], eps=group["eps"],
                                          weight_decay=group["weight_decay"], table=table)
        return None


def fused_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """The JAX ``fused_adamw`` transform for the port's ``Trainer(tx=...)``:
    an ``OptimizerSpec`` that builds a :class:`FusedAdamW`."""
    lr = float(learning_rate)
    return OptimizerSpec(
        lambda params: FusedAdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay),
        lr)
