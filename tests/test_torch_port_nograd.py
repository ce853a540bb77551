"""A parameter without a gradient steps as optax steps it.

optax updates every leaf of the parameter tree on every step: a leaf that
the loss does not reach gets a zero gradient, so its moments decay, its
weight decay applies and the shared count advances.  torch's optimizers
(and the port's ``FusedAdamW``) skip a parameter whose ``.grad`` is None,
so the port's train steps hand every parameter a gradient, a zero one
where autograd left none.

The model has four parameters: ``w`` and ``b`` always in the loss, ``u``
never in it, ``z`` only from the second step on and ``y`` only in the
first.  ``u`` shows the weight decay on a zero gradient, ``z`` the count
that must not lag (Adam's bias correction), ``y`` the momentum that must
keep moving the parameter after its gradient is gone (SGD).  Three steps
through the port's ``make_train_step`` and ``make_grad_accum_step`` (two
micro-batches) are held against ``tpuframe.train.step``'s, on the same
numpy weights and batches.  Tolerance: 1e-6 absolute in float32 (values
O(1); both sides run the same float32 update, the sums of the tiny
forward in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw
from tpuframe.parallel.precision import full_precision as jax_f32
from tpuframe.train.state import create_train_state as jax_create_train_state
from tpuframe.train.step import make_grad_accum_step as jax_make_grad_accum_step
from tpuframe.train.step import make_train_step as jax_make_train_step
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.parallel import full_precision
from tpuframe_torch.train.optim import make_optimizer, optimizer_from_config
from tpuframe_torch.train.state import create_train_state
from tpuframe_torch.train.step import make_grad_accum_step, make_train_step

FEATURES, CLASSES, BATCH, STEPS = 6, 5, 8, 3
NAMES = ("w", "b", "z", "y", "u")


class JaxGated(fnn.Module):
    """``x[:, :-2] @ w + b + x[:, -2:-1] * z + x[:, -1:] * y``; ``u`` is
    never used.  A gate column of zeros gives its parameter a zero
    gradient."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        zeros = fnn.initializers.zeros
        w = self.param("w", zeros, (FEATURES, CLASSES))
        b = self.param("b", zeros, (CLASSES,))
        z = self.param("z", zeros, (CLASSES,))
        y = self.param("y", zeros, (CLASSES,))
        self.param("u", zeros, (3,))
        return x[:, :-2] @ w + b + x[:, -2:-1] * z + x[:, -1:] * y


class Gated(torch.nn.Module):
    """The same function; a parameter whose gate column is all zero stays
    out of the graph, so autograd leaves it without a gradient."""

    def __init__(self, weights: dict):
        super().__init__()
        for name in NAMES:
            setattr(self, name, torch.nn.Parameter(torch.from_numpy(weights[name].copy())))

    def forward(self, x):
        out = x[:, :-2] @ self.w + self.b
        if bool(x[:, -2].any()):
            out = out + x[:, -2:-1] * self.z
        if bool(x[:, -1].any()):
            out = out + x[:, -1:] * self.y
        return out


def _weights(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"w": (FEATURES, CLASSES), "b": (CLASSES,), "z": (CLASSES,), "y": (CLASSES,),
              "u": (3,)}
    return {n: rng.normal(0.0, 1.0, s).astype(np.float32) for n, s in shapes.items()}


def _batches(seed=1) -> list[dict]:
    """Step 1 gates ``y`` in and ``z`` out; steps 2 and 3 the reverse."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(STEPS):
        x = rng.normal(0.0, 1.0, (BATCH, FEATURES + 2)).astype(np.float32)
        x[:, -2] = 0.0 if step == 0 else 1.0
        x[:, -1] = 1.0 if step == 0 else 0.0
        out.append({"image": x, "label": rng.integers(0, CLASSES, (BATCH,)).astype(np.int32)})
    return out


# (name, port OptimizerSpec, optax transform)
OPTIMIZERS = [
    ("fused_adamw", lambda: fused_adamw(1e-2, weight_decay=0.1),
     lambda: jax_fused_adamw(1e-2, weight_decay=0.1)),
    ("adamw", lambda: optimizer_from_config(
        {"optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.1}}}),
     lambda: optax.adamw(1e-2, weight_decay=0.1)),
    ("sgd_momentum", lambda: make_optimizer("sgd", 0.1), lambda: optax.sgd(0.1, momentum=0.9)),
]


def _run(make_t, make_j, accum: bool):
    """Three steps on both sides: (JAX params, port params, port optimizer)."""
    weights = _weights()
    jm, tx = JaxGated(), make_j()
    x0 = np.zeros((BATCH, FEATURES + 2), np.float32)
    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, tx, init_kwargs={"train": False})
    params = {n: jnp.asarray(weights[n]) for n in NAMES}
    js = js.replace(params=params, opt_state=tx.init(params))
    ts = create_train_state(Gated(weights), make_t())
    if accum:
        jstep = jax_make_grad_accum_step(2, jax_f32(), donate=False)
        tstep = make_grad_accum_step(2, full_precision())
    else:
        jstep = jax_make_train_step(jax_f32(), donate=False)
        tstep = make_train_step(full_precision())
    for b in _batches():
        if accum:
            b = {k: v.reshape((2, BATCH // 2) + v.shape[1:]) for k, v in b.items()}
        js, _ = jstep(js, b)
        ts, _ = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    assert ts.step == int(js.step) == STEPS
    return js.params, ts


@pytest.mark.parametrize("accum", [False, True], ids=["train_step", "grad_accum_2"])
@pytest.mark.parametrize("name,make_t,make_j", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_parameter_without_gradient_steps_as_in_jax(name, make_t, make_j, accum):
    jparams, ts = _run(make_t, make_j, accum)
    for n in NAMES:
        np.testing.assert_allclose(getattr(ts.model, n).detach().numpy(),
                                   np.asarray(jparams[n]), atol=1e-6, rtol=0, err_msg=n)


def test_fused_adamw_counts_every_parameter_every_step():
    """JAX keeps one count for the tree; the port one per parameter, so
    each must reach the number of steps, and ``u``'s weight decay on a zero
    gradient makes it exactly ``(1 - lr * wd) ** 3`` of its start."""
    _, ts = _run(OPTIMIZERS[0][1], OPTIMIZERS[0][2], accum=False)
    assert [int(ts.optimizer.state[getattr(ts.model, n)]["count"]) for n in NAMES] == [STEPS] * 5
    u0 = torch.from_numpy(_weights()["u"])
    torch.testing.assert_close(ts.model.u.detach(), u0 * (1 - 1e-2 * 0.1) ** STEPS,
                               atol=1e-6, rtol=0)
