"""``lion``, ``lamb`` and ``adafactor`` against optax.

The port writes them in plain PyTorch (``train/optim.py``: ``Lion``,
``Lamb``, ``Adafactor``); optax computes them outside any Pallas kernel.
Five steps on one tree with one leaf of each kind (a vector, a 100x50
matrix that adafactor does not factor, a 256x512 matrix it factors, a
3x130x140 tensor it factors over its two largest dims, a 3x3x64x128 conv
kernel whose second-largest dim is below 128), the same numpy
gradients on both sides, a few of them zero (``sign(0) = 0``, and a zero
update norm in LAMB's trust ratio).  Tolerance: each leaf within 1e-6
relative to its largest value (the float32 updates in another order
move the last bit of an O(1) parameter; observed ~6e-8).

The three are held through each route that builds them: the bare
``torch.optim`` classes at optax's constructor defaults, the Trainer's
names (``Trainer(optimizer=name)``: bare optax defaults,
``tpuframe/train/trainer.py:1646-1649``) and ``optimizer_from_config``
(the JAX package's config defaults, on the same config dicts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuframe.train.optim import optimizer_from_config as jax_optimizer_from_config
from tpuframe.train.trainer import _make_optimizer as jax_make_optimizer
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.models import MnistNet
from tpuframe_torch.train import Trainer
from tpuframe_torch.train.optim import (
    Adafactor,
    Lamb,
    Lion,
    _factored_dims,
    make_optimizer,
    optimizer_from_config,
)

SHAPES = {"vec": (37,), "mat": (100, 50), "fac": (256, 512), "t3": (3, 130, 140),
          "conv": (3, 3, 64, 128)}
STEPS = 5


def _tree_and_grads(seed: int = 0):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    grads[1]["vec"][:7] = 0.0  # sign(0) and a partly zero moment
    grads[2]["mat"][:] = 0.0  # a zero gradient: Lion's update is its moment's sign
    return p0, grads


def _run_optax(tx, p0, grads) -> dict:
    params = jax.tree.map(jnp.asarray, p0)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(build, p0, grads) -> dict:
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = build(list(params.values()))
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return {k: p.detach().numpy() for k, p in params.items()}


def _assert_close(got: dict, want: dict, p0: dict) -> None:
    for k in SHAPES:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6 * scale, err_msg=k)
        assert not np.array_equal(want[k], p0[k]), f"{k} did not move"


CLASSES = {
    "lion": (lambda ps: Lion(ps, lr=1e-3), optax.lion(1e-3)),
    "lion_b": (lambda ps: Lion(ps, lr=3e-4, b1=0.95, b2=0.98, weight_decay=0.0),
               optax.lion(3e-4, b1=0.95, b2=0.98, weight_decay=0.0)),
    "lamb": (lambda ps: Lamb(ps, lr=1e-3), optax.lamb(1e-3)),
    "lamb_wd": (lambda ps: Lamb(ps, lr=1e-3, weight_decay=1e-2),
                optax.lamb(1e-3, weight_decay=1e-2)),
    "adafactor": (lambda ps: Adafactor(ps, lr=1e-2), optax.adafactor(1e-2)),
    "adafactor_wd": (lambda ps: Adafactor(ps, lr=1e-2, decay_rate=0.7, weight_decay_rate=1e-3,
                                          min_dim_size_to_factor=64),
                     optax.adafactor(1e-2, decay_rate=0.7, weight_decay_rate=1e-3,
                                     min_dim_size_to_factor=64)),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_optimizer_matches_optax_over_five_steps(case):
    build, tx = CLASSES[case]
    p0, grads = _tree_and_grads()
    _assert_close(_run_port(build, p0, grads), _run_optax(tx, p0, grads), p0)


def test_adafactor_factors_as_optax():
    assert _factored_dims(SHAPES["vec"], 128) is None
    assert _factored_dims(SHAPES["mat"], 128) is None
    assert _factored_dims(SHAPES["fac"], 128) == (0, 1)
    assert _factored_dims(SHAPES["t3"], 128) == (1, 2)
    assert _factored_dims(SHAPES["conv"], 128) is None
    assert _factored_dims(SHAPES["conv"], 64) == (2, 3)
    opt = Adafactor([torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()])
    state = [opt.state[p] for p in opt.param_groups[0]["params"]]
    assert [sorted(st) for st in state] == [["step", "v"], ["step", "v"],
                                           ["step", "v_col", "v_row"],
                                           ["step", "v_col", "v_row"], ["step", "v"]]
    assert tuple(state[2]["v_row"].shape) == (256,) and tuple(state[2]["v_col"].shape) == (512,)
    assert tuple(state[3]["v_row"].shape) == (3, 130) and tuple(state[3]["v_col"].shape) == (3, 140)


@pytest.mark.parametrize("name", ["lion", "lamb", "adafactor"])
def test_trainer_names_take_bare_optax_defaults(name):
    p0, grads = _tree_and_grads(1)
    model = MnistNet(device="cpu")
    trainer = Trainer(model, optimizer=name, lr=1e-3)
    got = _run_port(trainer.spec.build, p0, grads)
    _assert_close(got, _run_optax(jax_make_optimizer(name, 1e-3), p0, grads), p0)


CONFIGS = [
    {"optimizer": {"type": "Lion", "params": {"lr": 1e-3}}},
    {"optimizer": {"type": "lion", "params": {"lr": 1e-3, "betas": [0.8, 0.9],
                                              "weight_decay": 0.1}}},
    {"optimizer": {"type": "LAMB", "params": {"lr": 1e-3}}},
    {"optimizer": {"type": "lamb", "params": {"lr": 1e-3, "weight_decay": 1e-2,
                                              "betas": [0.5, 0.5], "eps": 1e-3}}},
    {"optimizer": {"type": "Adafactor", "params": {"lr": 1e-2}}},
    {"optimizer": {"type": "adafactor", "params": {"lr": 1e-2, "decay_rate": 0.6,
                                                   "min_dim_size_to_factor": 100,
                                                   "weight_decay": 1e-3}}},
    {"optimizer": {"type": "Adafactor", "params": {"lr": "auto"}},
     "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0, "warmup_max_lr": 1e-2,
                                                  "warmup_num_steps": 3}}},
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["lion", "lion_params", "lamb", "lamb_params",
                                              "adafactor", "adafactor_params",
                                              "adafactor_schedule"])
def test_optimizer_from_config_matches_jax(cfg):
    p0, grads = _tree_and_grads(2)
    spec = optimizer_from_config(cfg)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = spec.build(list(params.values()))
    for i, g in enumerate(grads):
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        lr = spec.lr(i) if callable(spec.lr) else spec.lr
        for group in opt.param_groups:
            group["lr"] = lr  # as TrainState.apply_gradients sets it
        opt.step()
    got = {k: p.detach().numpy() for k, p in params.items()}
    _assert_close(got, _run_optax(jax_optimizer_from_config(cfg), p0, grads), p0)


@pytest.mark.parametrize("name", ["lion", "lamb", "adafactor"])
def test_trainer_fits_with_each_optimizer(name):
    ds = SyntheticImageDataset(n=32, image_size=28, channels=1, num_classes=10, seed=0)
    trainer = Trainer(MnistNet(device="cpu"), optimizer=name, lr=1e-3,
                      train_dataloader=DataLoader(ds, 8, shuffle=True, seed=0),
                      max_duration="2ba", log_interval=1)
    result = trainer.fit()
    assert result.error is None and np.isfinite(result.metrics["train_loss"])
    assert trainer.state.updates.item() == 2
    counts = {float(st["step"]) for st in trainer.state.optimizer.state.values()}
    assert counts == {2.0}
