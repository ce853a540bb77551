"""The port's ``ViT`` (``models/vit.py``) against the JAX package's, on the
JAX model's own weights carried across with ``from_jax_variables``: logits,
the weight tree both ways, one train step, the standard sizes and the
errors.

Tolerances, each with its reason:

- float32 logits within 1e-4 of the largest logit (relative): the convs,
  products and sums run in another order in XLA and ATen.
- bf16 logits within 3e-2 of the largest logit: both sides round every
  product, LayerNorm output, softmax and residual add to bf16, but keep
  float32 inside other ops at other places, so a value near a rounding
  boundary lands one bf16 step apart and carries through the blocks (as
  the LM's bf16 test).
- One f32 train step with fused AdamW (lr 1e-3): the loss within 1e-5
  relative, the parameters within 1e-4 of the update's norm and every
  element within 1e-4 absolute, as the LM's train test holds them and for
  the same reason (Adam's first update is about ``lr * g / |g|``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuframe.models.vit import ViT as JaxViT
from tpuframe.models.vit import ViT_B16 as JaxViT_B16
from tpuframe.models.vit import ViT_S16 as JaxViT_S16
from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw
from tpuframe.parallel.precision import full_precision as jax_f32
from tpuframe.train.state import create_train_state as jax_create_train_state
from tpuframe.train.step import make_train_step as jax_make_train_step
from tpuframe_torch.models import (
    ViT,
    ViT_B16,
    ViT_S16,
    export_torch_transformer,
    from_jax_variables,
    import_torch_transformer,
    vit_tp_rules,
)
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.parallel import align_model_dtype, bf16_compute, full_precision
from tpuframe_torch.train import create_train_state, make_predict_fn, make_train_step

SMALL = dict(num_classes=10, patch_size=4, hidden_dim=32, num_layers=2, num_heads=4)
IMAGE = 16


def _images(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, IMAGE, IMAGE, 3)).astype(np.float32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_variables(pool, seed=0, **kw):
    jm = JaxViT(**SMALL, pool=pool, **kw)
    return jm, _np(dict(jm.init(jax.random.PRNGKey(seed), jnp.asarray(_images()))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_logits_match_jax_on_jax_weights(pool, dtype):
    jm, variables = _jax_variables(pool, dtype=getattr(jnp, dtype))
    x = _images(seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)), np.float32)
    tm = ViT(**SMALL, pool=pool, image_size=IMAGE, device="cpu")
    tm.load_state_dict(from_jax_variables(variables))
    policy = bf16_compute() if dtype == "bfloat16" else full_precision()
    align_model_dtype(tm, policy)
    got = make_predict_fn(policy)(tm, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel <= (1e-4 if dtype == "float32" else 3e-2), rel


def test_tree_round_trip_and_parameter_names():
    _, variables = _jax_variables("cls")
    state = from_jax_variables(variables)
    tm = ViT(**SMALL, pool="cls", image_size=IMAGE, device="cpu")
    assert set(state) == set(tm.state_dict())
    assert tuple(state["patch_embed.weight"].shape) == (32, 3, 4, 4)  # OIHW
    assert tuple(state["pos_embed"].shape) == (1, 17, 32)
    assert tuple(state["cls_token"].shape) == (1, 1, 32)
    assert tuple(state["head.weight"].shape) == (10, 32)
    np.testing.assert_array_equal(state["patch_embed.weight"].numpy(),
                                  variables["params"]["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    back = _flat(import_torch_transformer(state))
    want = _flat({"params": variables["params"]})
    assert back.keys() == want.keys()
    for k, leaf in want.items():
        np.testing.assert_array_equal(back[k], leaf, err_msg=k)
    assert set(export_torch_transformer(variables)) == set(state)


def test_train_step_matches_jax():
    jm = JaxViT(**SMALL)
    x0 = jnp.asarray(_images())
    tx = jax_fused_adamw(1e-3, weight_decay=1e-4)
    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, tx, init_kwargs={"train": False})
    start = _flat({"params": _np(js.params)})
    tm = ViT(**SMALL, image_size=IMAGE, device="cpu")
    tm.load_state_dict(from_jax_variables({"params": _np(js.params)}))
    ts = create_train_state(tm, fused_adamw(1e-3, weight_decay=1e-4))
    batch = {"image": _images(8, seed=2),
             "label": np.random.default_rng(3).integers(0, 10, 8).astype(np.int32)}
    js, jmet = jax_make_train_step(jax_f32(), donate=False)(js, batch)
    ts, tmet = make_train_step(full_precision())(ts, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    assert float(tmet["loss_sum"]) == pytest.approx(float(jmet["loss_sum"]), rel=1e-5)
    assert float(tmet["correct"]) == float(jmet["correct"])
    got = _flat(import_torch_transformer(ts.model.state_dict()))
    want = _flat({"params": _np(js.params)})
    assert got.keys() == want.keys()
    diff = np.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in want))
    update = np.sqrt(sum(((want[k] - start[k]) ** 2).sum() for k in want))
    assert diff <= 1e-4 * update, (diff, update)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("size", ["S16", "B16"])
def test_standard_sizes_have_the_jax_parameter_count(size):
    jax_cls, port_cls = {"S16": (JaxViT_S16, ViT_S16), "B16": (JaxViT_B16, ViT_B16)}[size]
    shapes = jax.eval_shape(lambda: jax_cls().init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 224, 224, 3))))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    model = port_cls(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want
    assert model.block0.attn.query.out_features == {"S16": 384, "B16": 768}[size]


@pytest.mark.parametrize("kw,x_size,match", [
    (dict(hidden_dim=30), IMAGE, "must divide into 4 heads"),
    (dict(pool="max"), IMAGE, "unknown pool 'max'"),
    (dict(), 18, "image 18x18 not divisible by patch size 4"),
])
def test_errors_match_jax(kw, x_size, match):
    cfg = {**SMALL, **kw}
    x = jnp.zeros((1, x_size, x_size, 3))
    with pytest.raises(ValueError, match=match):
        JaxViT(**cfg).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match=match):
        ViT(**cfg, image_size=x_size, device="cpu")
    if not kw:  # a model built for 16 px, fed 18 px
        with pytest.raises(ValueError, match=match):
            ViT(**cfg, image_size=IMAGE, device="cpu")(torch.zeros(1, x_size, x_size, 3))


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_names_its_slice(attn_impl):
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        ViT(**SMALL, attn_impl=attn_impl, image_size=IMAGE, device="cpu")


def test_tp_rules_name_their_slice():
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        vit_tp_rules()


def test_dropout_and_remat_train_as_without_remat():
    """A train step with dropout draws masks after the position embedding
    and in every block; with ``remat`` it gives the same bits; eval mode
    drops nothing."""
    batch = {"image": torch.from_numpy(_images(4, seed=4)),
             "label": torch.from_numpy(np.arange(4, dtype=np.int64))}
    out = []
    for remat in (False, True):
        model = ViT(**SMALL, dropout=0.2, remat=remat, image_size=IMAGE, device="cpu", seed=5)
        state, m = make_train_step(full_precision())(
            create_train_state(model, fused_adamw(1e-2)), batch)
        out.append((float(m["loss_sum"]), [p.detach().clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    plain = ViT(**SMALL, image_size=IMAGE, device="cpu", seed=5)
    plain.load_state_dict(model.state_dict())
    assert torch.equal(plain(batch["image"]), model(batch["image"]))
