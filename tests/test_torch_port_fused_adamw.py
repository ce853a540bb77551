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
    fused_adamw_update,
    fused_adamw_update_,
)
from tpuframe_torch.train import OptimizerSpec, create_train_state

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


def test_refuses_what_it_does_not_take():
    opt = FusedAdamW([torch.nn.Parameter(torch.ones(3))], lr=1e-3)
    opt.param_groups[0]["lr"] = torch.tensor(1e-3)
    opt.param_groups[0]["params"][0].grad = torch.ones(3)
    with pytest.raises(TypeError, match="float lr"):
        opt.step()
    with pytest.raises(ValueError, match="closure"):
        opt.step(lambda: 0.0)
