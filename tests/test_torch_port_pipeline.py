"""The GPipe pipeline (``tpuframe_torch.parallel.pipeline``) on gloo ranks
against the JAX package's SPMD schedule on the virtual CPU devices, with
the same numpy-seeded inputs and weights.

- ``gpipe_spmd`` at ``pipe=2`` (world 2) over ``tests/test_pipeline.py``'s
  MLP stages: outputs and stage gradients against JAX's within 1e-5
  absolute (its own tolerance against the sequential stages); the three
  schedules bit-equal to each other, outputs and gradients; fewer
  microbatches than stages raising; the one-stage path (no pipe axis) in
  process within 1e-6.
- ``PipelinedTransformerLM`` under ``compose(tp=2, pp=2)`` (world 4: the
  vocab-parallel embedding and head over ``model``, two layers a stage):
  logits against JAX's pipelined model on a ``pipe=2 x model=2`` mesh
  within 2e-4 (``tests/test_pipeline.py:112-139``); the first step's
  whole gradient of every parameter (each rank's shards gathered, on every
  rank) against ``jax.grad`` of JAX's model within 1e-5 relative plus
  1e-6 of the largest element of its tensor, absolute (the rule of
  ``test_torch_port_tensor_parallel.py``), so the pipeline's ends (the
  input's copy over ``pipe``, the outputs' sum) scale nothing by the
  stage count; every schedule's first loss and gradients bit-equal; one
  step of SGD under a global-norm clip that engages (a quarter of the
  gradient's norm) against optax's clip and SGD on JAX's gradient: the
  clipped gradients within the same tolerance (so the norm summed over
  the split parameters is JAX's) and the parameters within 1e-4 of the
  update's norm; three train steps whose loss falls (``:141-157``).
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.core import MeshSpec, initialize
from tpuframe_torch.parallel import (
    PP_SCHEDULES,
    PipelinedTransformerLM,
    compose,
    full_precision,
    gpipe_spmd,
    stack_stage_params,
)

PLM = dict(vocab_size=64, num_layers=4, num_heads=2, head_dim=8, max_len=32, n_microbatches=4)
SGD_LR = 0.1  # the clipped step's: large enough that its update is far above f32 rounding


def _mlp_stage(params, y):
    return torch.tanh(y @ params["w"] + params["b"])


def _stage_arrays(n_stages, d, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)).astype(np.float32) * 0.3),
             "b": (rng.standard_normal((d,)).astype(np.float32) * 0.1)} for _ in range(n_stages)]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens():
    return np.random.default_rng(5).integers(0, 64, (8, 16)).astype(np.int64)


def _whole(model, attr: str) -> dict:
    """Every parameter's ``attr`` (``data`` or ``grad``) whole, by name
    (every rank calls this)."""
    from tpuframe_torch.parallel.tensor import full_tensor

    layout = model.tp_layout
    return {n: full_tensor(getattr(p, attr), layout[n], model.tp_mesh).numpy().copy()
            if n in layout else getattr(p, attr).detach().numpy().copy()
            for n, p in model.named_parameters()}


# -- the ranks' jobs (no JAX here) -------------------------------------------------


def _gpipe_job(rank, world):
    from tpuframe_torch.parallel.tensor import full_tensor

    rt = initialize({"pipe": world, "data": 1}, device="cpu")
    stages = _stage_arrays(world, 8, seed=2)
    x = torch.from_numpy(_x((4, 2, 8), 3))
    out = {}
    for schedule in PP_SCHEDULES:
        mine = {k: torch.from_numpy(v)[None].requires_grad_(True)
                for k, v in stages[rank].items()}
        y = gpipe_spmd(_mlp_stage, mine, x, schedule=schedule)
        (y ** 2).mean().backward()
        out[schedule] = {"y": y.detach().numpy(),
                         **{k: full_tensor(v.grad, [(0, "pipe")]).numpy()
                            for k, v in mine.items()}}
    try:
        gpipe_spmd(_mlp_stage, {k: torch.from_numpy(v)[None] for k, v in stages[rank].items()},
                   x[:1], mesh=rt.mesh)
        out["too_few"] = None
    except ValueError as e:
        out["too_few"] = str(e)
    return out


def _plm_job(rank, world, variables, tokens, clip):
    from tpuframe_torch.models import from_jax_variables
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.parallel.tensor import full_tensor
    from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step

    initialize(device="cpu")
    toks = torch.from_numpy(tokens)
    batch = {"input": toks, "label": torch.roll(toks, -1, 1)}
    out = {"first": {}, "grads": {}}
    for schedule in PP_SCHEDULES:
        plan = compose(tp=2, pp=2)
        model = PipelinedTransformerLM(**PLM, schedule=schedule, device="cpu")
        state = create_train_state(model, fused_adamw(1e-3), plan=plan)
        model.load_state_dict(from_jax_variables(variables, model))
        if schedule == "interleaved":
            with torch.no_grad():
                out["logits"] = full_tensor(model(toks), [(2, "model")], model.tp_mesh).numpy()
            out["layout"] = dict(model.tp_layout)
        step = make_train_step(full_precision(), plan=plan)
        losses = []
        for _ in range(3 if schedule == "interleaved" else 1):
            state, m = step(state, batch)
            losses.append(float(m["loss_sum"]) / float(m["count"]))
            if len(losses) == 1:  # the first step's gradients, unclipped
                out["grads"][schedule] = _whole(model, "grad")
        out["first"][schedule] = losses[0]
        if schedule == "interleaved":
            out["losses"] = losses
    # one SGD step under a clip that engages
    plan = compose(tp=2, pp=2)
    model = PipelinedTransformerLM(**PLM, device="cpu")
    state = create_train_state(model, make_optimizer("sgd", SGD_LR, clip), plan=plan)
    model.load_state_dict(from_jax_variables(variables, model))
    state, _ = make_train_step(full_precision(), plan=plan)(state, batch)
    out["clipped"] = {"grads": _whole(model, "grad"), "params": _whole(model, "data")}
    return out


def _jobs(rank, world, jobs):
    return {name: fn(rank, world, *args) for name, (fn, args) in jobs.items()}


# -- the JAX side -------------------------------------------------------------------


def _jax_gpipe():
    import jax
    import jax.numpy as jnp

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.parallel import gpipe_spmd as jax_gpipe
    from tpuframe.parallel import stack_stage_params as jax_stack

    def stage(params, y):
        return jnp.tanh(y @ params["w"] + params["b"])

    mesh = JaxMeshSpec(pipe=2, data=1).build(jax.devices()[:2])
    stacked = jax_stack([jax.tree.map(jnp.asarray, s) for s in _stage_arrays(2, 8, seed=2)])
    x = jnp.asarray(_x((4, 2, 8), 3))
    y = jax_gpipe(stage, stacked, x, mesh=mesh)
    grads = jax.grad(lambda p: jnp.mean(jax_gpipe(stage, p, x, mesh=mesh) ** 2))(stacked)
    return {"y": np.asarray(y), "w": np.asarray(grads["w"]), "b": np.asarray(grads["b"])}


def _jax_plm():
    """JAX's pipelined LM: its variables, logits, the first step's
    gradients, and one step of optax's global-norm clip (at a quarter of
    the gradient's norm) and SGD from them, the last two in the port's
    names and layout."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpuframe.core import MeshSpec as JaxMeshSpec
    from tpuframe.core import runtime as jax_rt
    from tpuframe.parallel import PipelinedTransformerLM as JaxPLM
    from tpuframe.train.step import cross_entropy as jax_ce
    from tpuframe_torch.models import from_jax_variables

    jax_rt.reset_runtime()
    jax_rt.initialize(JaxMeshSpec(pipe=2, data=2, model=2))
    try:
        model = JaxPLM(**PLM)
        tokens = jnp.asarray(_tokens().astype(np.int32))
        labels = jnp.roll(tokens, -1, 1)
        variables = model.init({"params": jax.random.PRNGKey(0)}, tokens)
        logits = np.asarray(model.apply(variables, tokens))
        params = variables["params"]
        grads = jax.grad(lambda p: jnp.mean(jax_ce(model.apply({"params": p}, tokens),
                                                   labels)))(params)
    finally:
        jax_rt.reset_runtime()
    norm = float(optax.global_norm(grads))
    clip = norm / 4
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.sgd(SGD_LR, momentum=0.9))
    updates, _ = tx.update(grads, tx.init(params), params)

    def port(tree):
        return {k: v.numpy() for k, v in from_jax_variables(
            {"params": jax.tree.map(np.asarray, tree)}).items()}

    return {"variables": jax.tree.map(np.asarray, variables), "logits": logits,
            "grads": port(grads), "norm": norm, "clip": clip,
            "clipped_grads": port(jax.tree.map(lambda g: g * (clip / norm), grads)),
            "clipped_params": port(optax.apply_updates(params, updates)),
            "start": port(params)}


@pytest.fixture(scope="module")
def reference():
    return {"gpipe": _jax_gpipe(), "plm": _jax_plm()}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's results at worlds 2 and 4, one spawn each."""
    two = run_ranks(_jobs, 2, tmp_path_factory.mktemp("pp2"), {"gpipe": (_gpipe_job, ())},
                    timeout=300)
    four = run_ranks(_jobs, 4, tmp_path_factory.mktemp("pp4"),
                     {"plm": (_plm_job, (reference["plm"]["variables"], _tokens(),
                                         reference["plm"]["clip"]))},
                     timeout=400)
    return {2: [r["gpipe"] for r in two], 4: [r["plm"] for r in four]}


# -- the tests ------------------------------------------------------------------------


def test_gpipe_matches_jax_forward_and_gradients(reference, ranks):
    want = reference["gpipe"]
    for r in ranks[2]:
        got = r["interleaved"]
        np.testing.assert_allclose(got["y"], want["y"], atol=1e-5)
        np.testing.assert_allclose(got["w"], want["w"], atol=1e-5)
        np.testing.assert_allclose(got["b"], want["b"], atol=1e-5)


def test_gpipe_schedules_are_bit_equal(ranks):
    for r in ranks[2]:
        for schedule in PP_SCHEDULES[1:]:
            for k in ("y", "w", "b"):
                np.testing.assert_array_equal(r[schedule][k], r["interleaved"][k],
                                              err_msg=f"{schedule} {k}")


def test_gpipe_too_few_microbatches_raises(ranks):
    for r in ranks[2]:
        assert r["too_few"] is not None and "must be >= pipeline stages" in r["too_few"]
    with pytest.raises(ValueError, match="schedule must be one of"):
        gpipe_spmd(_mlp_stage, {}, torch.zeros(2, 2, 8), schedule="gpipe")


def test_gpipe_single_stage_runs_the_stages_in_order(reference):
    """No pipe axis: every stage here, in order, per microbatch (JAX's
    one-stage path), against JAX's pipelined result."""
    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                                  for s in _stage_arrays(2, 8, seed=2)])
    got = gpipe_spmd(_mlp_stage, stacked, torch.from_numpy(_x((4, 2, 8), 3)),
                     mesh=MeshSpec(data=-1).build(1))
    np.testing.assert_allclose(got.numpy(), reference["gpipe"]["y"], atol=1e-6)


def test_pipelined_lm_under_tp2_pp2_matches_jax(reference, ranks):
    for r in ranks[4]:
        np.testing.assert_allclose(r["logits"], reference["plm"]["logits"], atol=2e-4)
    layout = ranks[4][0]["layout"]
    assert layout["blocks.attn.query.weight"] == [(0, "pipe")]
    assert layout["embed_head.embed.weight"] == [(0, "model")]
    assert layout["embed_head.lm_head.weight"] == [(0, "model")]
    assert "embed_head.pos_embed.weight" not in layout


def test_pipelined_lm_schedules_agree_and_train(ranks):
    first = {s: [r["first"][s] for r in ranks[4]] for s in PP_SCHEDULES}
    for s in PP_SCHEDULES:
        assert first[s] == first["interleaved"], first  # bit-equal, every rank
    losses = ranks[4][0]["losses"]
    assert losses[-1] < losses[0], losses
    assert all(r["losses"] == losses for r in ranks[4])


def _close(have: dict, want: dict, what: str) -> None:
    """Every tensor of ``want`` within 1e-5 relative plus 1e-6 of its own
    largest element, absolute."""
    assert set(have) == set(want), what
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want[k]).max()),
                                   err_msg=f"{what} {k}")


def test_pipelined_lm_gradients_match_jax(reference, ranks):
    for r, got in enumerate(ranks[4]):
        _close(got["grads"]["interleaved"], reference["plm"]["grads"], f"rank {r}")


def test_pipelined_lm_schedules_give_bit_equal_gradients(ranks):
    for r, got in enumerate(ranks[4]):
        for s in PP_SCHEDULES[1:]:
            for k, g in got["grads"]["interleaved"].items():
                np.testing.assert_array_equal(got["grads"][s][k], g, err_msg=f"rank {r} {s} {k}")


def test_pipelined_lm_clipped_step_matches_jax(reference, ranks):
    want = reference["plm"]
    assert want["norm"] > want["clip"]  # the clip engages
    for r, got in enumerate(ranks[4]):
        _close(got["clipped"]["grads"], want["clipped_grads"], f"rank {r}")
        have, ref, start = got["clipped"]["params"], want["clipped_params"], want["start"]
        diff = np.sqrt(sum(((have[k] - ref[k]) ** 2).sum() for k in ref))
        update = np.sqrt(sum(((ref[k] - start[k]) ** 2).sum() for k in ref))
        assert diff <= 1e-4 * update, (r, diff, update)
