"""K4, the fused AdamW, in the PyTorch port.

The port's plain update (what a CPU tensor takes) against the JAX
package's Pallas kernel run in interpret mode, as ``tests/test_ops.py``
runs it, and the port's optimizer (``FusedAdamW`` through ``fused_adamw``,
the ``Trainer``'s ``tx``) against the JAX ``optax`` transform, on the same
numpy inputs.  Tolerance: float32 parameters and moments within 1e-6
absolute (values O(1); both sides run the same float32 expression, JAX
with ``exp(t log b)`` of a float32 ``t``, and the transform adds the
update ``p' - p`` back onto ``p``, one more rounding); bf16 parameters
within one bf16 step (2**-8 relative) of JAX's.  The CUDA kernel runs only
on the card (``tests/test_torch_port_cuda.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw
from tpuframe.ops.fused_adamw import fused_adamw_update as jax_update
from tpuframe_torch.ops import (
    FusedAdamW,
    build,
    fused_adamw,
    fused_adamw_multi_update_,
    fused_adamw_update,
    fused_adamw_update_,
)
from tpuframe_torch.ops.fused_adamw import TABLE_CAPACITY
from tpuframe_torch.train import OptimizerSpec, create_train_state

# the module (the package exports its function of the same name)
fused_adamw_mod = importlib.import_module("tpuframe_torch.ops.fused_adamw")

# (name, shape, param dtype, hyperparameters, step): the ragged 257 x 130
# leaf (a partial 128-lane row and a partial row tile in JAX), momentum-free
# Adam (b1 = 0), a bf16 parameter, a later step with every knob set
UPDATES = [
    ("ragged_257x130", (257, 130), "float32", dict(lr=1e-2, weight_decay=0.01), 1),
    ("b1_zero", (33, 7), "float32", dict(lr=1e-2, b1=0.0), 1),
    ("bf16_param", (16, 24), "bfloat16", dict(lr=1e-2, weight_decay=1e-4), 1),
    ("step_5_all_knobs", (64, 3), "float32",
     dict(lr=3e-3, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.05), 5),
]


def _leaf(shape, seed, warm):
    rng = np.random.default_rng(seed)
    p, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32) if warm else np.zeros(shape, np.float32)
    v = (rng.uniform(0, 0.1, shape)).astype(np.float32) if warm else np.zeros(shape, np.float32)
    return p, g, m, v


@pytest.mark.parametrize("case", UPDATES, ids=[c[0] for c in UPDATES])
def test_update_matches_jax_kernel(case):
    _, shape, dtype, hp, step = case
    p, g, m, v = _leaf(shape, seed=len(shape) + shape[0], warm=step > 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, jm, jv = jax_update(jnp.asarray(p).astype(jdt), jnp.asarray(g).astype(jdt),
                            jnp.asarray(m), jnp.asarray(v), jnp.asarray(step, jnp.int32),
                            interpret=True, **hp)
    tp, tm, tv = fused_adamw_update(torch.from_numpy(p).to(tdt), torch.from_numpy(g).to(tdt),
                                    torch.from_numpy(m), torch.from_numpy(v),
                                    torch.tensor(step, dtype=torch.int32), **hp)
    assert tp.dtype == tdt and tm.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    want = np.asarray(jp, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(tp.numpy(), want, atol=1e-6, rtol=0)
    else:
        assert (np.abs(tp.float().numpy() - want) <= 2.0**-8 * np.abs(want)).all()


def test_in_place_update_matches_the_functional_form():
    p, g, m, v = (torch.from_numpy(a) for a in _leaf((5, 6), seed=1, warm=True))
    count = torch.tensor(3, dtype=torch.int32)
    want = fused_adamw_update(p, g, m, v, count, lr=1e-2)
    before = fused_adamw_update_.launches
    fused_adamw_update_(p, g, m, v, count, lr=1e-2)
    for got, w in zip((p, m, v), want):
        torch.testing.assert_close(got, w, atol=0, rtol=0)
    assert fused_adamw_update_.launches == before  # no kernel on the CPU
    assert "fused_adamw" in build.KERNELS


def test_transform_over_three_steps_matches_jax():
    rng = np.random.default_rng(5)
    shapes = {"w": (5, 9), "b": (9,), "emb": (257, 130)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4)

    tx = jax_fused_adamw(3e-3, **hp)
    jp = {k: jnp.asarray(a) for k, a in p0.items()}
    jstate = tx.init(jp)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(a) for k, a in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)

    spec = fused_adamw(3e-3, **hp)
    assert isinstance(spec, OptimizerSpec) and spec.max_grad_norm is None
    model = torch.nn.Module()
    for k, a in p0.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(a.copy())))
    ts = create_train_state(model, spec)
    assert isinstance(ts.optimizer, FusedAdamW)
    for g in grads:
        for k, a in g.items():
            getattr(model, k).grad = torch.from_numpy(a.copy())
        ts.apply_gradients()
    for k in shapes:
        st = ts.optimizer.state[getattr(model, k)]
        assert st["count"].dtype == torch.int32 and int(st["count"]) == int(jstate.count) == 3
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(st["mu"].numpy(), np.asarray(jstate.mu[k]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(st["nu"].numpy(), np.asarray(jstate.nu[k]), atol=1e-6, rtol=0)


def _jax_leaf_update(p, g, m, v, step, dtype, hp):
    jdt = getattr(jnp, dtype)
    jp, jm, jv = jax_update(jnp.asarray(p).astype(jdt), jnp.asarray(g).astype(jdt),
                            jnp.asarray(m), jnp.asarray(v), jnp.asarray(step, jnp.int32),
                            interpret=True, **hp)
    return np.asarray(jp.astype(jnp.float32)), np.asarray(jm), np.asarray(jv)


def _assert_close_to_jax(got, want, dtype):
    """f32 within 1e-6 absolute; a bf16 parameter within one bf16 step."""
    tp, tm, tv = got
    jp, jm, jv = want
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-6, rtol=0)
    if dtype == "float32":
        np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6, rtol=0)
    else:
        assert (np.abs(tp.float().numpy() - jp) <= 2.0**-8 * np.abs(jp)).all()


# (name, [(shape, element offset)], param dtype, hyperparameters, step): one
# list per case, as one launch takes it on the card.  LM-like leaves (a
# (768,) bias, a (3, 768) weight) beside the ragged 257 x 130 and a view at
# element offset 1; a bf16 list; momentum-free Adam
MULTI = [
    ("lm_like_f32", [((768,), 0), ((3, 768), 0), ((257, 130), 0), ((1001,), 1)], "float32",
     dict(lr=3e-4, weight_decay=1e-4), 3),
    ("bf16", [((768,), 0), ((16, 24), 0), ((1001,), 1)], "bfloat16",
     dict(lr=1e-2, weight_decay=1e-4), 1),
    ("b1_zero", [((257, 130), 0), ((33, 7), 1)], "float32", dict(lr=1e-2, b1=0.0), 2),
]


@pytest.mark.parametrize("case", MULTI, ids=[c[0] for c in MULTI])
def test_multi_update_matches_jax_kernel_per_leaf(case):
    _, leaves, dtype, hp, step = case
    tdt = getattr(torch, dtype)

    def placed(a, offset, dt):
        flat = torch.zeros(a.size + offset, dtype=dt)
        t = flat[offset:].view(a.shape)
        t.copy_(torch.from_numpy(a).to(dt))
        return t

    inputs, lists = [], ([], [], [], [], [])
    for i, (shape, offset) in enumerate(leaves):
        arrays = _leaf(shape, seed=10 + i, warm=step > 1)
        inputs.append(arrays)
        p, g, m, v = (placed(a, offset, tdt if k < 2 else torch.float32)
                      for k, a in enumerate(arrays))
        assert p.storage_offset() == offset
        for col, t in zip(lists, (p, g, m, v, torch.tensor(step, dtype=torch.int32))):
            col.append(t)
    fused_adamw_multi_update_(*lists, **hp)
    for (p, g, m, v), tp, tm, tv in zip(inputs, lists[0], lists[2], lists[3]):
        assert tp.dtype == tdt and tm.dtype == tv.dtype == torch.float32
        _assert_close_to_jax((tp, tm, tv), _jax_leaf_update(p, g, m, v, step, dtype, hp), dtype)


def test_optimizer_makes_one_multi_update_per_group_and_dtype(monkeypatch):
    """Two parameter groups, the second with a float32 and a bf16 tensor:
    three multi-update calls a step.  Three steps against the JAX
    transform of each float32 group and the JAX kernel chained on the
    bf16 leaf."""
    rng = np.random.default_rng(7)
    shapes = {"w": (5, 9), "b": (9,), "emb": (257, 130), "h": (16, 24)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    hp = dict(b1=0.9, b2=0.95, eps=1e-8)
    wd = {"w": 1e-4, "b": 1e-4, "emb": 0.0, "h": 0.0}

    params = {k: torch.nn.Parameter(torch.from_numpy(a.copy())) for k, a in p0.items()}
    params["h"] = torch.nn.Parameter(params["h"].detach().bfloat16())
    opt = FusedAdamW([{"params": [params["w"], params["b"]]},
                      {"params": [params["emb"], params["h"]], "weight_decay": 0.0}],
                     lr=3e-3, weight_decay=1e-4, **hp)
    calls = []
    real = fused_adamw_mod.fused_adamw_multi_update_

    def counting(ps, *args, **kw):
        calls.append((len(ps), ps[0].dtype, kw["weight_decay"]))
        return real(ps, *args, **kw)

    monkeypatch.setattr(fused_adamw_mod, "fused_adamw_multi_update_", counting)
    for g in grads:
        for k, a in g.items():
            params[k].grad = torch.from_numpy(a.copy()).to(params[k].dtype)
        opt.step()
    assert calls == [(2, torch.float32, 1e-4), (1, torch.float32, 0.0),
                     (1, torch.bfloat16, 0.0)] * 3

    for keys, decay in ((("w", "b"), 1e-4), (("emb",), 0.0)):
        tx = jax_fused_adamw(3e-3, weight_decay=decay, **hp)
        jp = {k: jnp.asarray(p0[k]) for k in keys}
        jstate = tx.init(jp)
        for g in grads:
            upd, jstate = tx.update({k: jnp.asarray(g[k]) for k in keys}, jstate, jp)
            jp = optax.apply_updates(jp, upd)
        for k in keys:
            st = opt.state[params[k]]
            assert int(st["count"]) == 3
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=0, err_msg=k)
            np.testing.assert_allclose(st["mu"].numpy(), np.asarray(jstate.mu[k]), atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(st["nu"].numpy(), np.asarray(jstate.nu[k]), atol=1e-6,
                                       rtol=0)
    p, m, v = p0["h"], np.zeros(shapes["h"], np.float32), np.zeros(shapes["h"], np.float32)
    for step, g in enumerate(grads, start=1):  # p is cast to bf16, as the port holds it
        p, m, v = _jax_leaf_update(p, g["h"], m, v, step, "bfloat16",
                                   dict(lr=3e-3, weight_decay=0.0, **hp))
    st = opt.state[params["h"]]
    _assert_close_to_jax((params["h"].detach(), st["mu"], st["nu"]), (p, m, v), "bfloat16")


def test_long_list_is_split_into_table_sized_groups(monkeypatch):
    """A list of 2 * TABLE_CAPACITY + 5 tensors: three groups on the CPU, as
    three launches on the card, each tensor as if updated alone."""
    n = 2 * TABLE_CAPACITY + 5
    rng = np.random.default_rng(8)
    leaves = [tuple(torch.from_numpy(a) for a in _leaf((int(k),), seed=i, warm=True))
              for i, k in enumerate(rng.integers(1, 40, n))]
    counts = [torch.tensor(4, dtype=torch.int32)] * n
    hp = dict(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-3)
    want = [fused_adamw_update(p, g, m, v, counts[0], **hp) for p, g, m, v in leaves]
    groups = []
    real = fused_adamw_mod._plain_
    monkeypatch.setattr(fused_adamw_mod, "_plain_",
                        lambda ps, *a: (groups.append(len(ps)), real(ps, *a)))
    ps, gs, ms, vs = (list(col) for col in zip(*leaves))
    fused_adamw_multi_update_(ps, gs, ms, vs, counts, **hp)
    assert groups == [TABLE_CAPACITY, TABLE_CAPACITY, 5]
    assert -(-n // TABLE_CAPACITY) == len(groups)
    for (p, _, m, v), w in zip(leaves, want):
        for got, exp in zip((p, m, v), w):
            torch.testing.assert_close(got, exp, atol=0, rtol=0)


def test_loaded_state_keeps_its_dtypes_and_matches_jax():
    """A state saved after step 1 and loaded into a new optimizer keeps the
    int32 count and float32 moments of JAX's ``FusedAdamWState`` (torch's
    ``load_state_dict`` casts state to the parameter's dtype): step 2 of a
    bf16 leaf then matches the JAX kernel chained over both steps."""
    rng = np.random.default_rng(9)
    p0 = rng.standard_normal((16, 24)).astype(np.float32)
    grads = [rng.standard_normal((16, 24)).astype(np.float32) for _ in range(2)]
    hp = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-4)
    first = torch.nn.Parameter(torch.from_numpy(p0).bfloat16())
    opt = FusedAdamW([first], **hp)
    first.grad = torch.from_numpy(grads[0]).bfloat16()
    opt.step()
    second = torch.nn.Parameter(first.detach().clone())
    loaded = FusedAdamW([second], **hp)
    loaded.load_state_dict(opt.state_dict())
    st = loaded.state[second]
    assert (st["count"].dtype, st["mu"].dtype, st["nu"].dtype) == (
        torch.int32, torch.float32, torch.float32)
    second.grad = torch.from_numpy(grads[1]).bfloat16()
    loaded.step()
    p, m, v = p0, np.zeros_like(p0), np.zeros_like(p0)
    for step, g in enumerate(grads, start=1):
        p, m, v = _jax_leaf_update(p, g, m, v, step, "bfloat16", hp)
    assert int(st["count"]) == 2
    _assert_close_to_jax((second.detach(), st["mu"], st["nu"]), (p, m, v), "bfloat16")


def test_multi_update_refuses_lists_of_other_lengths():
    t = torch.zeros(3)
    with pytest.raises(ValueError, match="1 p, 2 g"):
        fused_adamw_multi_update_([t], [t, t], [t], [t], [torch.tensor(1, dtype=torch.int32)],
                                  lr=1e-3)
    fused_adamw_multi_update_([], [], [], [], [], lr=1e-3)  # nothing to do
    with pytest.raises(ValueError, match="meta"):  # never a plain step off the CPU
        fused_adamw_multi_update_([t, t.to("meta")], [t, t], [t, t], [t, t],
                                  [torch.tensor(1, dtype=torch.int32)] * 2, lr=1e-3)


def test_refuses_what_it_does_not_take():
    opt = FusedAdamW([torch.nn.Parameter(torch.ones(3))], lr=1e-3)
    opt.param_groups[0]["lr"] = torch.tensor(1e-3)
    opt.param_groups[0]["params"][0].grad = torch.ones(3)
    with pytest.raises(TypeError, match="float lr"):
        opt.step()
    with pytest.raises(ValueError, match="closure"):
        opt.step(lambda: 0.0)
