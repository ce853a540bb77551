"""Precompile (``tpuframe_torch.compile.precompile``) over the long-context
LM (blockwise attention, with and without ``remat``) and the one-process
MoE LM, on the CPU, against eager and against the JAX package.

Every case compiles with the ``aot_eager`` backend (no code generation),
under a world-1 runtime:

- ``Trainer(precompile=True)`` reports the train step ``dispatchable``, not
  ``skipped``, with no graph break (the MoE's token group is read from the
  runtime's mesh sizes: a guard); its warm-up runs on the live state and restores it bit for
  bit; and its three steps' losses and final parameters are the eager
  Trainer's to the bit.
- Those losses against JAX's train step on the same weights (carried by
  ``from_jax_variables`` from JAX's init) and batches, with
  ``fused_adamw``: within 1e-5 relative, the tolerance of
  ``test_torch_port_long_context.py``'s blockwise loss and of
  ``test_torch_port_moe.py``'s aux loss (the products and sums run in
  another order in XLA and ATen).
- ``_unsupported`` still turns away an ``expert`` or ``seq`` axis above 1
  and dropout, and takes the MoE LM on one process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch._dynamo.utils import counters

import tpuframe_torch.compile.precompile as pc
from tpuframe.models.transformer import TransformerLM as JaxLM
from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw
from tpuframe.parallel.precision import full_precision as jax_f32
from tpuframe.train.state import create_train_state as jax_create_train_state
from tpuframe.train.step import make_train_step as jax_make_train_step
from tpuframe_torch.core import initialize, reset_runtime
from tpuframe_torch.data import DataLoader
from tpuframe_torch.models import TransformerLM, from_jax_variables
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.train import Callback, Trainer, make_train_step

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=16, max_len=16)
KINDS = {"blockwise": dict(attn_impl="blockwise"),
         "remat": dict(attn_impl="blockwise", remat=True),
         "moe": dict(moe_experts=4, moe_top_k=2)}
HP = dict(weight_decay=1e-4)


@pytest.fixture
def aot_eager(monkeypatch):
    """No code generation, the graph-break counter cleared, and a world-1
    runtime (the MoE's token group is read from its mesh)."""
    monkeypatch.setattr(pc, "_BACKEND", "aot_eager")
    torch._dynamo.reset()
    counters.clear()
    initialize(device="cpu")
    try:
        yield
    finally:
        reset_runtime()


class Tokens:
    """(input, label) next-token rows of a seeded random stream."""

    def __init__(self, n: int, seed: int = 1):
        self.rows = np.random.default_rng(seed).integers(
            0, SMALL["vocab_size"], (n, SMALL["max_len"] + 1)).astype(np.int64)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i, :-1], self.rows[i, 1:]


class _Losses(Callback):
    def __init__(self):
        self.losses = []

    def on_batch_end(self, trainer, metrics):
        self.losses.append(metrics["loss_sum"] / metrics["count"])


def _tensors(state) -> dict:
    out = {k: v.clone() for k, v in pc._state_tensors(state).items()}
    out["rng"] = state.generator.get_state()
    return out


def _fit(kind: str, precompile: bool, variables: dict):
    """Three steps of 4 x 16 tokens, the loader's rows in order; with
    ``precompile``, the warm-up's restore checked before the fit."""
    model = TransformerLM(**SMALL, **KINDS[kind], device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    cb = _Losses()
    tr = Trainer(model, tx=fused_adamw(3e-3, **HP), train_dataloader=DataLoader(Tokens(12), 4),
                 max_duration="3ba", log_interval=1, eval_interval=0, health=False,
                 precompile=precompile, callbacks=[cb])
    if precompile:
        before = _tensors(tr.init_state())
        tr.precompile()
        after = _tensors(tr.state)
        assert tr.state.step == 0 and set(before) == set(after)
        for k in before:
            assert torch.equal(before[k], after[k]), k
    tr.fit()
    return tr, cb.losses


def _jax_losses(jm, js) -> list[float]:
    """JAX's train step over the loader's three batches."""
    step = jax_make_train_step(jax_f32(), donate=False)
    rows = Tokens(12).rows.astype(np.int32)
    out = []
    for i in range(3):
        b = rows[4 * i:4 * i + 4]
        js, met = step(js, {"image": b[:, :-1], "label": b[:, 1:]})
        out.append(float(met["loss_sum"]) / float(met["count"]))
    return out


@pytest.mark.parametrize("kind", ["blockwise", "moe"])
def test_precompiled_trainer_is_dispatchable_bit_equal_to_eager_and_matches_jax(aot_eager, kind):
    jm = JaxLM(**SMALL, **KINDS[kind])
    x0 = jnp.asarray(Tokens(4).rows[:, :-1].astype(np.int32))
    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, jax_fused_adamw(3e-3, **HP),
                                init_kwargs={"train": False})
    variables = {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), js.params)}
    tr, got = _fit(kind, True, variables)
    assert not counters["graph_break"], dict(counters["graph_break"])
    (step,) = tr._precompile_report["steps"]
    assert step["kind"] == "train" and step.get("dispatchable") and "skipped" not in step, step
    assert [k for k, _ in tr._compiled] == ["train"]
    eager, want = _fit(kind, False, variables)
    assert len(got) == len(want) == 3 and got == want
    assert all(torch.equal(a, b) for a, b in zip(tr.state.model.parameters(),
                                                 eager.state.model.parameters()))
    assert got == pytest.approx(_jax_losses(jm, js), rel=1e-5)


def _stub(model, axes: dict):
    plan = types.SimpleNamespace(axis_size=lambda a: axes.get(a, 1), zero_stage=0,
                                 fsdp_axis="fsdp", offload_optimizer=False)
    return types.SimpleNamespace(plan=plan, zero=None, comms={}, model=model)


@pytest.mark.parametrize("kind, axes, dropout, why", [
    ("moe", {"expert": 2}, 0.0, "the expert axis above 1"),
    ("blockwise", {"seq": 2}, 0.0, "the seq axis above 1"),
    ("blockwise", {}, 0.1, "dropout"),
    ("moe", {}, 0.0, None),
    ("remat", {}, 0.0, None),
])
def test_unsupported_skips_the_splits_and_dropout_only(kind, axes, dropout, why):
    model = TransformerLM(**SMALL, **KINDS[kind], dropout=dropout, device="cpu")
    got = pc._unsupported(make_train_step(), _stub(model, axes))
    assert got == why if why is None else why in got
