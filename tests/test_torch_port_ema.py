"""The parameters' moving average against ``tpuframe.train.ema``.

- ``with_ema`` / ``ema_params`` over four updates of SGD with momentum and
  of AdamW, on the same numpy weights and gradients as JAX's ``with_ema``
  around the same optax transform: the average and the parameters within
  1e-6 absolute (O(1) float32 values; ``d * e + (1 - d) * p`` in JAX's
  order).
- Both packages refuse the same inputs: ``decay`` outside (0, 1), and
  ``ema_params`` of a state without an average (``ValueError``).
- ``Trainer(ema_decay=0.9)``: predict and evaluate read the average, not
  the live weights.
- The average is part of the state: a checkpoint restore into a fresh
  state gives it back bit for bit, and a step the health sentinel skips
  leaves it as it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuframe.train.ema import ema_params as jax_ema_params
from tpuframe.train.ema import with_ema as jax_with_ema
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.fault.health import HealthPolicy, unpack_health_stats
from tpuframe_torch.models import MnistNet
from tpuframe_torch.train import (
    EmaState,
    Trainer,
    create_train_state,
    ema_params,
    make_optimizer,
    make_predict_fn,
    make_train_step,
    with_ema,
)
from tpuframe_torch.train.optim import optimizer_from_config

ADAMW = {"optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 1e-2}}}
TXS = {
    "sgd": (lambda: make_optimizer("sgd", 0.1), lambda: optax.sgd(0.1, momentum=0.9)),
    "adamw": (lambda: optimizer_from_config(ADAMW),
              lambda: optax.adamw(1e-2, weight_decay=1e-2)),
}


@pytest.mark.parametrize("opt", sorted(TXS))
@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_ema_matches_jax_over_four_updates(opt, decay):
    model = MnistNet(device="cpu", seed=3)
    p0 = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    rng = np.random.default_rng(0)
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32) for n, v in p0.items()}
             for _ in range(4)]
    port_spec, jax_tx = TXS[opt]
    tx = jax_with_ema(jax_tx(), decay)
    params = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(params)
    state = create_train_state(model, with_ema(port_spec(), decay))
    assert isinstance(state.ema, EmaState) and state.ema.decay == decay
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        state.apply_gradients()
    got, want = ema_params(state), jax_ema_params(opt_state)
    live = dict(model.named_parameters())
    for n in p0:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), atol=1e-6, rtol=0,
                                   err_msg=n)
        np.testing.assert_allclose(live[n].detach().numpy(), np.asarray(params[n]), atol=1e-6,
                                   rtol=0, err_msg=n)
        assert not np.array_equal(got[n].numpy(), p0[n])
        assert not torch.equal(got[n], live[n])
    assert ema_params(state.ema) is got


@pytest.mark.parametrize("decay", [0.0, 1.0, -0.5, 1.5])
def test_both_refuse_a_decay_outside_the_open_unit_interval(decay):
    with pytest.raises(ValueError, match="decay must be in"):
        jax_with_ema(optax.sgd(0.1), decay)
    with pytest.raises(ValueError, match="decay must be in"):
        with_ema(make_optimizer("sgd", 0.1), decay)


def test_both_refuse_ema_params_without_an_average():
    params = {"w": jnp.ones(3)}
    with pytest.raises(ValueError, match="carries no EMA"):
        jax_ema_params(optax.sgd(0.1).init(params))
    state = create_train_state(MnistNet(device="cpu"), make_optimizer("sgd", 0.1))
    assert state.ema is None
    for arg in (state, state.optimizer, None):
        with pytest.raises(ValueError, match="carries no EMA"):
            ema_params(arg)


def _loader(n=32):
    ds = SyntheticImageDataset(n=n, image_size=28, channels=1, num_classes=10, seed=0)
    return DataLoader(ds, 8, shuffle=True, seed=0, drop_last=False)


def test_trainer_predicts_and_evaluates_with_the_average():
    trainer = Trainer(MnistNet(device="cpu"), optimizer="sgd", lr=1e-4, ema_decay=0.9,
                      train_dataloader=_loader(), eval_dataloader=_loader(16),
                      max_duration="3ba", eval_interval=0)
    trainer.fit()
    state = trainer.state
    x = np.random.default_rng(1).uniform(0, 255, (4, 28, 28, 1)).astype(np.float32)
    predict = make_predict_fn()
    xt = torch.from_numpy(x)
    want = predict(state.model, xt, ema_params(state)).numpy()
    live = predict(state.model, xt).numpy()
    assert not np.allclose(want, live)
    np.testing.assert_array_equal(trainer.predict(x), want)
    got_eval = trainer.evaluate()
    # the same eval over the live weights differs
    trainer.ema_decay = None
    assert trainer.evaluate()["eval_loss"] != got_eval["eval_loss"]


def _state_with_ema(seed: int):
    model = MnistNet(device="cpu", seed=seed)
    return create_train_state(model, with_ema(make_optimizer("sgd", 0.1), 0.9))


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.uniform(0, 1, (8, 28, 28, 1)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 10, 8).astype(np.int64))}


def test_a_checkpoint_restore_keeps_the_average_bit_equal(tmp_path):
    state = _state_with_ema(0)
    step = make_train_step()
    for i in range(3):
        state, _ = step(state, _batch(i))
    ck = Checkpointer(tmp_path / "ck")
    ck.save(state)
    ck.wait()
    fresh = _state_with_ema(1)
    assert not all(torch.equal(fresh.ema.ema[n], v) for n, v in state.ema.ema.items())
    Checkpointer(tmp_path / "ck").restore(fresh)
    for n, v in state.ema.ema.items():
        assert torch.equal(fresh.ema.ema[n], v), n
    assert fresh.step == state.step == 3
    # both go on alike
    state, _ = step(state, _batch(5))
    fresh, _ = step(fresh, _batch(5))
    for n, v in state.ema.ema.items():
        assert torch.equal(fresh.ema.ema[n], v), n
    plain = create_train_state(MnistNet(device="cpu"), make_optimizer("sgd", 0.1))
    with pytest.raises(ValueError, match="EMA"):
        plain.load_state_dict(state.state_dict())


def test_a_skipped_step_leaves_the_average_alone():
    state = _state_with_ema(0)
    step = make_train_step(health=HealthPolicy(warmup_steps=0))
    state, _ = step(state, _batch(0))
    before = {n: v.clone() for n, v in state.ema.ema.items()}
    bad = _batch(1)
    bad["image"][0, 0, 0, 0] = float("nan")
    state, metrics = step(state, bad)
    assert unpack_health_stats(metrics["health_stats"])["health_bad"] == 1.0
    for n, v in before.items():
        assert torch.equal(state.ema.ema[n], v), n
