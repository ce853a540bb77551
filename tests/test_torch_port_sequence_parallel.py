"""The LM under sequence and expert parallelism on gloo ranks
(``tests/torch_ranks.py``) against the JAX package's ``TransformerLM`` on
the virtual CPU devices of ``conftest.py`` over a mesh with the same
``seq`` or ``expert`` size (``data`` takes the rest of the 8 devices; the
global batch is the same), with the same numpy-seeded weights and batch.

- ``TransformerLM`` (2 layers, 4 heads x 16, seq 64, JAX's weights) at
  ``seq=2`` with the ring, with Ulysses and with MoE blocks (4 experts,
  top 2, the ring), and with MoE blocks at ``expert=2`` (``moe_rules``):
  one train step through ``make_train_step`` under the runtime's plan.
  Its reported loss (the data loss, summed over the token group) within
  1e-5 relative of JAX's, and every gradient, gathered whole with
  ``full_tensor`` after the token group's mean, within 1e-5 relative (plus
  1e-6 of the tensor's largest gradient, absolute) of ``jax.grad`` of JAX's
  loss plus its ``aux_loss`` collection, the objective of JAX's train
  step.
- At ``expert=2``, a step of SGD under a global-norm clip that engages (a
  quarter of the gradient's norm): the clipped gradients (the norm summed
  over the split experts) and the parameters after the step; that state
  saved, then restored into one process's plan bit-exact.
- Example 06 through its main with ``--simulate-devices 1``: ``--attn
  ulysses --seq-shards 2`` and ``--attn ring --moe-experts 2
  --expert-shards 1``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

REPO = Path(__file__).resolve().parents[1]
LM = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=16, max_len=64)
BATCH = 4  # divides JAX's data axis of 4 (8 devices over seq or expert 2)
SGD_LR = 0.1
VARIANTS = {  # name -> (attn_impl, moe_experts, port mesh)
    "ring": ("ring", 0, {"data": 1, "seq": 2}),
    "ulysses": ("ulysses", 0, {"data": 1, "seq": 2}),
    "moe_seq2": ("ring", 4, {"data": 1, "seq": 2}),
    "moe_expert2": ("full", 4, {"data": 1, "expert": 2}),
}


def _batch() -> dict:
    toks = np.random.default_rng(7).integers(0, LM["vocab_size"], (BATCH, LM["max_len"] + 1))
    return {"input": toks[:, :-1].astype(np.int32), "label": toks[:, 1:].astype(np.int32)}


# -- the ranks' jobs (no JAX here) -------------------------------------------------


def _whole(model, attr: str) -> dict:
    from tpuframe_torch.parallel.tensor import full_tensor

    layout = getattr(model, "tp_layout", None) or {}
    out = {}
    for name, p in model.named_parameters():
        t = getattr(p, attr)
        out[name] = (full_tensor(t, layout[name]) if name in layout else t).numpy().copy()
    return out


def _lm_job(rank, world, name, variables, clip=None, ck_dir=None):
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.core import initialize
    from tpuframe_torch.models import TransformerLM, from_jax_variables, moe_rules
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.parallel import ParallelPlan, full_precision
    from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step

    impl, experts, mesh = VARIANTS[name]
    rt = initialize(mesh, device="cpu")
    model = TransformerLM(**LM, attn_impl=impl, moe_experts=experts, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    plan = ParallelPlan(mesh=rt.mesh, rules=moe_rules() if experts else ())
    tx = fused_adamw(1e-3) if clip is None else make_optimizer("sgd", SGD_LR, clip)
    state = create_train_state(model, tx, plan=plan)
    step = make_train_step(full_precision(), plan=plan)
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    state, m = step(state, b)
    out = {"loss": float(m["loss_sum"]) / float(m["count"]), "count": float(m["count"]),
           "grads": _whole(model, "grad"), "params": _whole(model, "data"),
           "layout": dict(getattr(model, "tp_layout", None) or {})}
    if ck_dir is not None:
        with Checkpointer(ck_dir) as ck:
            ck.save(state, step=1, plan=plan)
    return out


def _jobs(rank, world, jobs):
    return {name: fn(rank, world, *args) for name, (fn, args) in jobs.items()}


# -- the JAX side -------------------------------------------------------------------


def _np(tree):
    import jax

    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _jax_lm(name: str) -> dict:
    """JAX's initial weights, data loss and ``jax.grad`` of loss + aux for
    ``name`` over a mesh with the variant's seq or expert axis."""
    import jax
    import jax.numpy as jnp

    from tpuframe.core import runtime as jax_runtime
    from tpuframe.core.runtime import MeshSpec
    from tpuframe.models.transformer import TransformerLM as JaxLM
    from tpuframe.train.step import cross_entropy as jax_ce

    impl, experts, mesh = VARIANTS[name]
    axes = {k: v for k, v in mesh.items() if k != "data"}
    before = jax_runtime._CURRENT
    jax_runtime.reset_runtime()
    try:
        jax_runtime.initialize(MeshSpec(data=-1, **axes))
        jm = JaxLM(**LM, attn_impl=impl, moe_experts=experts)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        params = jm.init(jax.random.PRNGKey(1), batch["input"][:1])["params"]

        def objective(p):
            logits, upd = jm.apply({"params": p}, batch["input"], train=True,
                                   mutable=["aux_loss"])
            loss = jnp.mean(jax_ce(logits, batch["label"]))
            aux = sum(jnp.sum(a) for a in jax.tree.leaves(upd.get("aux_loss", {})))
            return loss + aux, loss

        (_, loss), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
        return {"start": _np(params), "loss": float(loss), "grads": _np(grads)}
    finally:
        jax_runtime.reset_runtime()
        jax_runtime._CURRENT = before


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k], np.float32)


def _norm(tree) -> float:
    return float(np.sqrt(sum((leaf ** 2).sum() for _, leaf in _leaves(tree))))


def _flax(flat: dict) -> dict:
    from tpuframe_torch.models import import_torch_transformer

    return dict(_leaves(import_torch_transformer(
        {k: torch.from_numpy(v) for k, v in flat.items()})["params"]))


@pytest.fixture(scope="module")
def reference():
    ref = {name: _jax_lm(name) for name in VARIANTS}
    ref["clip"] = _norm(ref["moe_expert2"]["grads"]) / 4
    return ref


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    ck_dir = str(tmp_path_factory.mktemp("ep2_ck") / "ck")
    jobs = {name: (_lm_job, (name, {"params": reference[name]["start"]})) for name in VARIANTS}
    jobs["clip"] = (_lm_job, ("moe_expert2", {"params": reference["moe_expert2"]["start"]},
                              reference["clip"], ck_dir))
    return {"results": run_ranks(_jobs, 2, tmp_path_factory.mktemp("sp_lm"), jobs, timeout=420),
            "ck_dir": ck_dir}


# -- the tests ------------------------------------------------------------------------


def _check_grads(have: dict, want: dict, scale: float = 1.0) -> None:
    assert set(have) == set(want)
    for k, w in want.items():
        w = w * scale
        np.testing.assert_allclose(have[k], w, rtol=1e-5, atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_lm_step_matches_jax(reference, ranks, name):
    want = reference[name]
    got = [r[name] for r in ranks["results"]]
    for r in got:
        assert r["count"] == BATCH * LM["max_len"]  # the token group's sum
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        _check_grads(_flax(r["grads"]), dict(_leaves(want["grads"])))
    for k in got[0]["params"]:  # every rank ends with the same whole parameters
        np.testing.assert_array_equal(got[1]["params"][k], got[0]["params"][k], err_msg=k)
    if name == "moe_expert2":
        assert got[0]["layout"]["block0.moe.w_in"] == [(0, "expert")]


def test_expert_split_clipped_step_matches_jax(reference, ranks):
    want = reference["moe_expert2"]
    norm, clip = _norm(want["grads"]), reference["clip"]
    assert norm > clip  # the clip engages
    scale = clip / norm
    start, grads = dict(_leaves(want["start"])), dict(_leaves(want["grads"]))
    for r in ranks["results"]:
        got = r["clip"]
        _check_grads(_flax(got["grads"]), grads, scale)  # the port clips its gradients in place
        after = _flax(got["params"])
        for k in start:  # SGD's first step with momentum: p - lr * g
            np.testing.assert_allclose(after[k], start[k] - SGD_LR * scale * grads[k],
                                       atol=1e-6, rtol=1e-5, err_msg=k)


def test_expert_split_save_restores_into_one_process_bit_exact(ranks):
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.core.runtime import MeshSpec
    from tpuframe_torch.models import TransformerLM, moe_rules
    from tpuframe_torch.parallel import ParallelPlan
    from tpuframe_torch.train import create_train_state, make_optimizer

    saved = ranks["results"][0]["clip"]
    plan = ParallelPlan(mesh=MeshSpec(data=1).build(1), rules=moe_rules())
    model = TransformerLM(**LM, attn_impl="full", moe_experts=4, device="cpu", seed=9)
    state = create_train_state(model, make_optimizer("sgd", SGD_LR, 1.0), plan=plan)
    with Checkpointer(ranks["ck_dir"]) as ck:
        state, _ = ck.restore(state, step=1, plan=plan)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), saved["params"][name], err_msg=name)
    assert state.step == 1


@pytest.mark.parametrize("argv", [
    ["--attn", "ulysses", "--seq-shards", "2"],
    ["--attn", "ring", "--seq-shards", "2", "--moe-experts", "2", "--expert-shards", "1"],
], ids=["ulysses", "ring_moe"])
def test_example_06_runs(tmp_path, argv):
    script = REPO / "tpuframe_torch" / "examples" / "06_lm_sequence_parallel.py"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    out = subprocess.run(
        [sys.executable, str(script), *argv, "--seq-len", "64", "--heads", "4", "--layers", "1",
         "--epochs", "1", "--batch-size", "8", "--train-samples", "16", "--simulate-devices",
         "1", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"attn={argv[1]}" in out.stdout
