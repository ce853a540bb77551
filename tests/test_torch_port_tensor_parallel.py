"""Tensor parallelism on gloo ranks (``tests/torch_ranks.py``) against the
JAX package's GSPMD step under the same plan on the virtual CPU devices of
``conftest.py``, with the same numpy-seeded weights and batches.

- ``TransformerLM`` under ``transformer_tp_rules`` at ``model=2`` (world
  2) and at ``data=2 x model=2`` (world 4): the first loss, every whole
  gradient (each rank's shards gathered) and the parameters after one
  ``fused_adamw`` step.
- ``ViT`` under ``vit_tp_rules`` at ``model=2``: the logits of
  ``tests/test_models.py::test_vit_tp_rules_shard_and_match``'s setup
  (the classes split over the ranks, gathered here), atol 2e-5 as there,
  and one train step's loss and gradients.
- ``parallel.tensor.vocab_parallel_cross_entropy`` on logits split over
  two ranks against the JAX package's cross entropy and its gradient.
- The LM at ``model=2`` with one SGD step under a global-norm clip that
  engages (a quarter of the gradient's norm), against JAX's step with
  optax's clip and SGD: the clipped gradients (so the norm summed over the
  split parameters is JAX's) and the parameters after the step.

Tolerances (float32 on the CPU): losses within 1e-5 relative; gradients
within 1e-5 relative plus 1e-6 of the largest gradient of their tensor,
absolute (the partial sums of a row-parallel product and of the cotangent's
all-reduce run in another order than XLA's); parameters after the step
within 1e-4 of the update's norm and 1e-4 absolute, the rule of
``test_torch_port_ddp.py`` (Adam's first step divides by the gradient's
own size, so a gradient near zero moves its element by up to the whole
learning rate either way).  Every rank of a data shard ends bit-equal.
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.core import initialize
from tpuframe_torch.models import TransformerLM, ViT, from_jax_variables, transformer_tp_rules
from tpuframe_torch.models import vit_tp_rules
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.parallel import ParallelPlan, full_precision
from tpuframe_torch.parallel.tensor import full_tensor, vocab_parallel_cross_entropy
from tpuframe_torch.train import create_train_state, make_train_step

LM = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8, max_len=16)
VIT = dict(num_classes=8, patch_size=4, hidden_dim=32, num_layers=2, num_heads=4)
LR = 1e-3
SGD_LR = 0.1  # the clipped step's: large enough that its update is far above f32 rounding


def _lm_batch() -> dict:
    rng = np.random.default_rng(7)
    toks = rng.integers(0, LM["vocab_size"], (8, 16)).astype(np.int32)
    return {"image": toks, "label": np.roll(toks, -1, 1).astype(np.int32)}


def _vit_batch() -> dict:
    x = np.random.default_rng(0).standard_normal((4, 16, 16, 3)).astype(np.float32)
    return {"image": x, "label": np.array([1, 5, 2, 7], np.int32)}


def _ce_inputs():
    rng = np.random.default_rng(3)
    return (rng.normal(0, 3, (24, 40)).astype(np.float32),
            rng.integers(0, 40, 24).astype(np.int64), rng.uniform(0.5, 1.5, 24).astype(np.float32))


def _local(batch: dict, index: int, count: int) -> dict:
    n = len(batch["label"]) // count
    return {k: torch.from_numpy(np.ascontiguousarray(v[index * n:(index + 1) * n]))
            for k, v in batch.items()}


# -- the ranks' jobs (no JAX here) -------------------------------------------------


def _whole(model) -> dict:
    """Every parameter whole, and every gradient whole, by name."""
    layout = model.tp_layout
    params, grads = {}, {}
    for name, p in model.named_parameters():
        params[name] = full_tensor(p.data, layout[name]) if name in layout else p.data
        grads[name] = full_tensor(p.grad, layout[name]) if name in layout else p.grad
    return ({k: v.numpy().copy() for k, v in params.items()},
            {k: v.numpy().copy() for k, v in grads.items()})


def _step_job(rt, model, rules, batch, tx=None) -> dict:
    plan = ParallelPlan(mesh=rt.mesh, rules=rules)
    tx = fused_adamw(LR, weight_decay=1e-4) if tx is None else tx
    state = create_train_state(model, tx, plan=plan)
    step = make_train_step(full_precision(), plan=plan)
    state, m = step(state, _local(batch, rt.data_index, rt.data_count))
    params, grads = _whole(model)
    return {"loss": float(m["loss_sum"]) / float(m["count"]), "params": params,
            "grads": grads, "layout": {k: v for k, v in model.tp_layout.items()},
            # each shard owns its storage: a kept view would hold the whole
            "storage": {n: (p.untyped_storage().nbytes(), p.numel() * p.element_size())
                        for n, p in model.named_parameters()},
            "heads": model.block0.attn.tp_heads is not None
            if hasattr(model, "block0") else None}


def _lm_job(rank, world, mesh, variables, clip=None):
    """One step of the LM: ``fused_adamw``, or SGD clipped at ``clip``."""
    from tpuframe_torch.train import make_optimizer

    rt = initialize(mesh, device="cpu")
    model = TransformerLM(**LM, attn_impl="full", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    tx = None if clip is None else make_optimizer("sgd", SGD_LR, clip)
    return _step_job(rt, model, transformer_tp_rules(), _lm_batch(), tx)


def _vit_job(rank, world, variables):
    rt = initialize({"data": 1, "model": world}, device="cpu")
    model = ViT(**VIT, attn_impl="full", image_size=16, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    plan = ParallelPlan(mesh=rt.mesh, rules=vit_tp_rules(), min_shard_elems=1)
    create_train_state(model, fused_adamw(LR), plan=plan)
    with torch.no_grad():
        local = model(torch.from_numpy(_vit_batch()["image"]))
    logits = full_tensor(local, [(1, "model")]).numpy()
    out = _step_job(rt, model, vit_tp_rules(), _vit_batch())
    out.update(logits=logits, local_classes=local.shape[-1],
               forms={n: getattr(m, "tp", None).kind for n, m in model.named_modules()
                      if getattr(m, "tp", None) is not None})
    return out


def _ce_job(rank, world):
    from tpuframe_torch.parallel.tensor import axis

    initialize({"data": 1, "model": world}, device="cpu")
    x, labels, g = _ce_inputs()
    n = x.shape[1] // world
    local = torch.from_numpy(x[:, rank * n:(rank + 1) * n].copy()).requires_grad_(True)
    losses = vocab_parallel_cross_entropy(local, torch.from_numpy(labels), axis("model"))
    (losses * torch.from_numpy(g)).sum().backward()
    return {"losses": losses.detach().numpy(), "grad": local.grad.numpy()}


def _jobs(rank, world, jobs):
    return {name: fn(rank, world, *args) for name, (fn, args) in jobs.items()}


# -- the JAX side -------------------------------------------------------------------


def _np(tree):
    import jax

    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _jax_step(jm, plan, batch, x0, tx):
    """(initial params, first loss, whole gradients, params after one step)
    of the JAX step under ``plan``."""
    import jax
    import jax.numpy as jnp

    from tpuframe.parallel.precision import full_precision as jax_f32
    from tpuframe.train.state import create_train_state as jax_create_train_state
    from tpuframe.train.step import cross_entropy as jax_ce
    from tpuframe.train.step import make_train_step as jax_make_train_step

    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, tx, plan=plan,
                                init_kwargs={"train": False})
    start = _np(js.params)
    sharded = plan.shard_batch(batch)

    def loss(p):
        return jnp.mean(jax_ce(jm.apply({"params": p}, sharded["image"]), sharded["label"]))

    grads = _np(jax.grad(loss)(js.params))
    step = jax_make_train_step(jax_f32(), donate=False, plan=plan)
    js, m = step(js, sharded)
    return {"start": start, "loss": float(m["loss_sum"]) / float(m["count"]),
            "grads": grads, "params": _np(js.params)}


def _jax_plan(mesh_kw, rules, **kw):
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.parallel import ParallelPlan as JaxPlan

    n = int(np.prod(list(mesh_kw.values())))
    return JaxPlan(mesh=JaxMeshSpec(**mesh_kw).build(jax.devices()[:n]), rules=rules, **kw)


def _jax_lm(mesh_kw, clip=None):
    """JAX's step of the LM: its fused AdamW, or optax's clip at ``clip``
    and SGD."""
    import optax

    from tpuframe.models.transformer import TransformerLM as JaxLM
    from tpuframe.models.transformer import transformer_tp_rules as jax_rules
    from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw

    tx = jax_fused_adamw(LR, weight_decay=1e-4) if clip is None else optax.chain(
        optax.clip_by_global_norm(clip), optax.sgd(SGD_LR, momentum=0.9))
    return _jax_step(JaxLM(**LM, attn_impl="full"), _jax_plan(mesh_kw, jax_rules()),
                     _lm_batch(), _lm_batch()["image"][:1], tx)


def _jax_vit():
    import jax.numpy as jnp

    from tpuframe.models import ViT as JaxViT
    from tpuframe.models import vit_tp_rules as jax_vit_rules
    from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw

    jm = JaxViT(**VIT, attn_impl="full")
    x = jnp.asarray(_vit_batch()["image"])
    out = _jax_step(jm, _jax_plan({"data": 1, "model": 2}, jax_vit_rules(), min_shard_elems=1),
                    _vit_batch(), _vit_batch()["image"][:1], jax_fused_adamw(LR))
    out["logits"] = np.asarray(jm.apply({"params": out["start"]}, x))
    return out


def _jax_ce():
    import jax
    import jax.numpy as jnp

    from tpuframe.train.step import cross_entropy as jax_ce

    x, labels, g = _ce_inputs()
    losses, vjp = jax.vjp(lambda z: jax_ce(z, jnp.asarray(labels, jnp.int32)), jnp.asarray(x))
    return {"losses": np.asarray(losses), "grad": np.asarray(vjp(jnp.asarray(g))[0])}


def _norm(tree) -> float:
    return float(np.sqrt(sum((leaf ** 2).sum() for _, leaf in _leaves(tree))))


@pytest.fixture(scope="module")
def reference():
    lm2 = _jax_lm({"data": 1, "model": 2})
    clip = _norm(lm2["grads"]) / 4
    return {"lm2": lm2, "lm4": _jax_lm({"data": 2, "model": 2}),
            "lm2_clip": dict(_jax_lm({"data": 1, "model": 2}, clip), clip=clip,
                             norm=_norm(lm2["grads"])),
            "vit": _jax_vit(), "ce": _jax_ce()}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's results at worlds 2 and 4, one spawn each."""
    lm = {"params": reference["lm2"]["start"]}
    two = {"lm": (_lm_job, ({"data": 1, "model": 2}, lm)),
           "vit": (_vit_job, ({"params": reference["vit"]["start"]},)),
           "ce": (_ce_job, ()),
           "lm_clip": (_lm_job, ({"data": 1, "model": 2}, lm, reference["lm2_clip"]["clip"]))}
    four = {"lm": (_lm_job, ({"data": 2, "model": 2}, {"params": reference["lm4"]["start"]}))}
    return {2: run_ranks(_jobs, 2, tmp_path_factory.mktemp("tp2"), two, timeout=300),
            4: run_ranks(_jobs, 4, tmp_path_factory.mktemp("tp4"), four, timeout=300)}


# -- the tests ------------------------------------------------------------------------


def _torch_tree(flat: dict) -> dict:
    from tpuframe_torch.models import import_torch_transformer

    return import_torch_transformer({k: torch.from_numpy(v) for k, v in flat.items()})


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k], np.float32)


def _check_step(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    have_g = dict(_leaves(_torch_tree(got["grads"])["params"]))
    want_g = dict(_leaves(want["grads"]))
    assert set(have_g) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(have_g[k], want_g[k], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want_g[k]).max()), err_msg=k)
    have, ref, s0 = (dict(_leaves(t)) for t in (
        _torch_tree(got["params"])["params"], want["params"], want["start"]))
    diff = np.sqrt(sum(((have[k] - ref[k]) ** 2).sum() for k in ref))
    update = np.sqrt(sum(((ref[k] - s0[k]) ** 2).sum() for k in ref))
    assert diff <= 1e-4 * update, (diff, update)
    for k in ref:
        np.testing.assert_allclose(have[k], ref[k], atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("world", [2, 4], ids=["model2", "data2_model2"])
def test_transformer_tp_step_matches_jax(reference, ranks, world):
    want = reference["lm2" if world == 2 else "lm4"]
    got = [r["lm"] for r in ranks[world]]
    _check_step(got[0], want)
    for r in got[1:]:  # every rank holds the same whole state after the step
        for k in got[0]["params"]:
            np.testing.assert_array_equal(r["params"][k], got[0]["params"][k], err_msg=k)
    # the rules split what they name, on the torch layout's dims
    layout = got[0]["layout"]
    assert layout["block0.attn.query.weight"] == [(0, "model")]  # kernel (in, out) -> dim 0
    assert layout["block0.mlp_out.weight"] == [(1, "model")]
    assert layout["embed.weight"] == [(1, "model")] and layout["lm_head.weight"] == [(0, "model")]
    assert "block0.mlp_in.bias" not in layout and got[0]["heads"]
    for name, (held, shard) in got[0]["storage"].items():
        assert held == shard, name


def test_vit_tp_rules_forward_and_step_match_jax(reference, ranks):
    want = reference["vit"]
    got = [r["vit"] for r in ranks[2]]
    for r in got:
        assert r["local_classes"] == VIT["num_classes"] // 2
        np.testing.assert_allclose(r["logits"], want["logits"], atol=2e-5)
    forms = got[0]["forms"]
    assert forms["patch_embed"] == "col" and forms["head"] == "col"
    assert forms["block0.attn.query"] == "col" and forms["block0.mlp_out"] == "row"
    assert got[0]["layout"]["patch_embed.weight"] == [(0, "model")]  # HWIO dim 3 -> OIHW 0
    _check_step(got[0], want)


def test_vocab_parallel_cross_entropy_matches_jax(reference, ranks):
    want = reference["ce"]
    got = [r["ce"] for r in ranks[2]]
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-6, atol=1e-6)
    grad = np.concatenate([r["grad"] for r in got], axis=1)
    np.testing.assert_allclose(grad, want["grad"], rtol=1e-5, atol=1e-7)


def test_tp_rules_are_jax_rules():
    from tpuframe.models import transformer_tp_rules as jax_lm_rules
    from tpuframe.models import vit_tp_rules as jax_vit_rules
    from tpuframe.parallel.sharding import spec_to_json as jax_spec_to_json
    from tpuframe_torch.parallel import spec_to_json

    for port, jax_rules in ((transformer_tp_rules(), jax_lm_rules()),
                            (vit_tp_rules(), jax_vit_rules())):
        assert [(p, spec_to_json(s)) for p, s in port] == \
            [(p, jax_spec_to_json(s)) for p, s in jax_rules]


def test_transformer_tp_clipped_step_matches_jax(reference, ranks):
    want = reference["lm2_clip"]
    assert want["norm"] > want["clip"]  # the clip engages
    scale = want["clip"] / want["norm"]
    for r, got in enumerate(r["lm_clip"] for r in ranks[2]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        have_g = dict(_leaves(_torch_tree(got["grads"])["params"]))
        for k, g in _leaves(want["grads"]):  # the port clips its gradients in place
            np.testing.assert_allclose(have_g[k], g * scale, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(g * scale).max()),
                                       err_msg=f"rank {r} {k}")
        have, ref, s0 = (dict(_leaves(t)) for t in (
            _torch_tree(got["params"])["params"], want["params"], want["start"]))
        diff = np.sqrt(sum(((have[k] - ref[k]) ** 2).sum() for k in ref))
        update = np.sqrt(sum(((ref[k] - s0[k]) ** 2).sum() for k in ref))
        assert diff <= 1e-4 * update, (r, diff, update)
