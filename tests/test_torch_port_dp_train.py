"""Data-parallel training through the compressed wire on two gloo ranks
(spawned processes, ``FileStore`` rendezvous), against the JAX package.

- ``DataLoader(process_index=r, process_count=2)``: each process's indices
  and ``valid`` (genuine) masks equal JAX's, byte for byte.
- The compressed train step (``make_train_step(plan=..., grad_compression=
  CommsConfig("int8", one bucket))``): a small f32 ResNet18 with BatchNorm,
  the JAX model's weights carried in by ``from_jax_variables``, SGD lr 0.1
  momentum 0.9, two steps of a global batch of 8 split 4 + 4, against JAX's
  ``make_train_step(plan=ParallelPlan(mesh of 2 devices), grad_compression=
  ...)``.  One bucket: the scale is the global abs-max, so every other op
  is element-wise.  Losses within 1e-5 relative.  Parameters and the
  averaged running statistics within 2e-4 (the f32 step tolerance of
  ``test_torch_port_train.py``: convolution sums run in another order) plus
  one quantum of the wire a step (lr x (1 + momentum) x amax / 127 / 2 by
  the second step): a gradient the two frameworks round a few ulps apart
  may land on either side of a rounding edge of the int8 grid.  Both ranks
  end with the same parameters, bit for bit.
- Error feedback: 30 steps of a small MLP at world 2 through the int8 and
  the fp8 wire track the port's own uncompressed fit of the same global
  batches in one process within 5 % of the final loss, and learn (as the
  JAX ``test_ef_fit_tracks_f32``).
- ``Trainer(grad_compression="int8").fit()`` at world 2 with the default
  plan: both ranks end with the same parameters, the eval sums the ranks'
  shards (each genuine sample once), only rank 0 logs, and
  ``comms/bytes_on_wire`` grows by JAX's ``wire_plan`` bytes a step for the
  same named tree.
"""

import numpy as np
import pytest
import torch
from torch import nn

from torch_ranks import run_ranks
from tpuframe_torch.core import initialize
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.models import ResNet18, from_jax_variables
from tpuframe_torch.models.interop import import_torch_resnet
from tpuframe_torch.parallel import CommsConfig, ParallelPlan, full_precision, init_comms_state
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train import Trainer, create_train_state, make_optimizer, make_train_step

# -- the loader's per-process shard ---------------------------------------------

LOADERS = [
    ("ordered_padded", dict(shuffle=False, drop_last=False), 29),
    ("shuffled_padded", dict(shuffle=True, drop_last=False), 29),
    ("shuffled_drop_last", dict(shuffle=True, drop_last=True), 29),
    ("tiny_dataset_wraps", dict(shuffle=True, drop_last=False), 3),
]


@pytest.mark.parametrize("name,kw,n", LOADERS, ids=[c[0] for c in LOADERS])
def test_loader_shards_equal_jax(name, kw, n):
    from tpuframe.data import DataLoader as JaxDataLoader
    from tpuframe.data.datasets import SyntheticImageDataset as JaxSynthetic

    for rank in range(2):
        jl = JaxDataLoader(JaxSynthetic(n=n, image_size=4, seed=3), 8, seed=5,
                           process_index=rank, process_count=2, **kw)
        tl = DataLoader(SyntheticImageDataset(n=n, image_size=4, seed=3), 8, seed=5,
                        process_index=rank, process_count=2, **kw)
        assert tl.local_batch_size == jl.local_batch_size == 4 and len(tl) == len(jl)
        for epoch in (0, 1):
            ji, jg = jl._indices(epoch)
            ti, tg = tl._indices(epoch)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tg, jg)
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            for got, want in zip(tl, jl, strict=True):
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert tl.state_dict()["process_count"] == 2
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(SyntheticImageDataset(n=8), 9, process_index=0, process_count=2)


# -- the ranks' work -------------------------------------------------------------

STEP_CONFIG = dict(mode="int8", bucket_mb=64.0)  # one bucket over the whole gradient
LR, MOMENTUM = 0.1, 0.9


def _step_batches() -> list[dict]:
    rng = np.random.default_rng(0)
    return [{"image": rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (8,)).astype(np.int32)} for _ in range(2)]


class TinyMLP(nn.Module):
    """The JAX test's ``Tiny``: Dense(16) -> relu -> Dense(4) over a
    flattened 6 x 6 x 1 image."""

    def __init__(self, seed: int = 0):
        super().__init__()
        torch.manual_seed(seed)
        self.fc1 = nn.Linear(36, 16)
        self.fc2 = nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.reshape(x.shape[0], -1))))


_W_TRUE = np.random.default_rng(7).standard_normal((36, 4)).astype(np.float32)


def _fit_batches(n: int = 30, b: int = 16) -> list[dict]:
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        img = rng.standard_normal((b, 6, 6, 1)).astype(np.float32)
        lab = np.argmax(img.reshape(b, -1) @ _W_TRUE, axis=1).astype(np.int64)
        out.append({"image": img, "label": lab})
    return out


def _fit(step, state, rank: int = 0, world: int = 1) -> list[float]:
    losses = []
    for b in _fit_batches():
        local = {k: torch.from_numpy(v[rank::world]) for k, v in b.items()}
        state, m = step(state, local)
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    return losses


def _flat_params(model: nn.Module) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


class RecordingLogger:
    def __init__(self):
        self.calls = 0

    def log_metrics(self, metrics, step=None):
        self.calls += 1


def _dp_worker(rank: int, world: int, variables: dict) -> dict:
    """On each rank: the compressed ResNet18 steps, the two EF fits, and a
    Trainer fit."""
    rt = initialize(device="cpu")
    plan = ParallelPlan(mesh=rt.mesh)
    out = {}

    # -- the compressed step against JAX --
    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    config = CommsConfig(**STEP_CONFIG)
    state = create_train_state(model, make_optimizer("sgd", LR))
    state.comms = init_comms_state(dict(model.named_parameters()), plan, config)
    step = make_train_step(full_precision(), plan=plan, grad_compression=config)
    losses, amax = [], []
    for b in _step_batches():
        local = {k: torch.from_numpy(v[4 * rank:4 * rank + 4]) for k, v in b.items()}
        grads_abs = []

        hooks = [p.register_hook(lambda g: grads_abs.append(float(g.abs().max())))
                 for p in model.parameters()]
        state, m = step(state, local)
        for h in hooks:
            h.remove()
        amax.append(max(grads_abs))
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    tree = import_torch_resnet(model.state_dict())
    out["step"] = {"losses": losses, "local_amax": amax, "wire": step.wire,
                   "params": tree["params"], "batch_stats": tree["batch_stats"],
                   "flat": _flat_params(model),
                   "residual_max": float(state.comms["flat"].abs().max())}

    # -- error feedback fits through both wires --
    for mode in ("int8", "fp8"):
        mlp = TinyMLP()
        cfg = CommsConfig(mode=mode)
        st = create_train_state(mlp, make_optimizer("adam", 1e-2))
        st.comms = init_comms_state(dict(mlp.named_parameters()), plan, cfg)
        out[f"fit_{mode}"] = {
            "losses": _fit(make_train_step(plan=plan, grad_compression=cfg), st, rank, world),
            "residual_max": float(st.comms["flat"].abs().max()), "flat": _flat_params(mlp)}

    # -- Trainer.fit with the default plan --
    tele = get_telemetry()
    before = tele.registry.counter("comms/bytes_on_wire").value
    logger = RecordingLogger()
    trainer_model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu", seed=1)
    train = DataLoader(SyntheticImageDataset(n=48, image_size=16, num_classes=10), 16,
                       shuffle=True, seed=2)
    evl = DataLoader(SyntheticImageDataset(n=21, image_size=16, num_classes=10, seed=4), 8,
                     drop_last=False)
    trainer = Trainer(trainer_model, train_dataloader=train, eval_dataloader=evl,
                      optimizer="sgd", lr=0.05, max_duration="3ba", grad_compression="int8",
                      log_interval=1, loggers=[logger])
    eval_counts = []
    trainer._eval_step = _counting(trainer._eval_step, eval_counts)
    result = trainer.fit()
    out["trainer"] = {
        "wire": trainer._train_step.wire, "batches": trainer.batches_seen,
        "metered": tele.registry.counter("comms/bytes_on_wire").value - before,
        "history": result.history, "log_calls": logger.calls,
        "eval_count": sum(eval_counts), "flat": _flat_params(trainer_model),
        "shapes": {n: tuple(p.shape) for n, p in trainer_model.named_parameters()},
        "plan_world": trainer.plan.dp_size, "local_batch": train.local_batch_size,
    }
    return out


def _counting(eval_step, counts: list):
    def step(state, batch):
        m = eval_step(state, batch)
        counts.append(float(m["count"]))
        return m
    return step


# -- the JAX side ------------------------------------------------------------------


def _jax_reference():
    """The JAX compressed step over a 2-device mesh: (variables, losses,
    params, batch_stats)."""
    import jax
    import optax

    from test_torch_port_train import _variables
    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.models import ResNet18 as JaxResNet18
    from tpuframe.parallel import ParallelPlan as JaxPlan
    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import init_comms_state as jax_init_comms
    from tpuframe.parallel.precision import full_precision as jax_f32
    from tpuframe.train.state import create_train_state as jax_create_train_state
    from tpuframe.train.step import make_train_step as jax_make_train_step

    jm = JaxResNet18(num_classes=10, num_filters=4, stem="cifar")
    x0 = np.zeros((8, 16, 16, 3), np.float32)
    v = _variables(jm, x0, 11)
    plan = JaxPlan(mesh=JaxMeshSpec(data=2).build(jax.devices()[:2]))
    tx = optax.sgd(LR, momentum=MOMENTUM)
    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, tx, plan=plan,
                                init_kwargs={"train": False})
    params = jax.tree.map(jax.numpy.asarray, v["params"])
    config = JaxConfig(**STEP_CONFIG)
    js = js.replace(params=params, batch_stats=jax.tree.map(jax.numpy.asarray, v["batch_stats"]),
                    opt_state=tx.init(params), comms=jax_init_comms(params, plan, config))
    step = jax_make_train_step(jax_f32(), donate=False, plan=plan, grad_compression=config)
    losses = []
    for b in _step_batches():
        js, m = step(js, plan.shard_batch(b))
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    as_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return v, losses, as_np(js.params), as_np(js.batch_stats), step.wire


@pytest.fixture(scope="module")
def jax_ref():
    return _jax_reference()


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    return run_ranks(_dp_worker, 2, tmp_path_factory.mktemp("dp"), jax_ref[0], timeout=400)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k], np.float32)


def test_compressed_step_matches_jax_on_two_ranks(jax_ref, ranks):
    _, jlosses, jparams, jstats, jwire = jax_ref
    got = [r["step"] for r in ranks]
    np.testing.assert_allclose(got[0]["losses"], jlosses, rtol=1e-5)
    np.testing.assert_array_equal(got[0]["flat"], got[1]["flat"])  # one model on both ranks
    np.testing.assert_array_equal(got[0]["losses"], got[1]["losses"])
    # one quantum of the wire a step, carried by the momentum (module docstring)
    quantum = max(max(r["local_amax"]) for r in got) / 127 / 2
    tol = 2e-4 + LR * (1 + MOMENTUM) * quantum
    want = dict(_leaves({"params": jparams, "batch_stats": jstats}))
    have = dict(_leaves({"params": got[0]["params"], "batch_stats": got[0]["batch_stats"]}))
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=tol, err_msg=k)
    assert got[0]["residual_max"] > 0
    for key in ("bytes_per_step", "f32_bytes_per_step", "n_buckets", "world", "mode"):
        assert got[0]["wire"][key] == jwire[key], key


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_error_feedback_fit_tracks_the_uncompressed_fit(ranks, mode):
    mlp = TinyMLP()
    exact = _fit(make_train_step(), create_train_state(mlp, make_optimizer("adam", 1e-2)))
    got = [r[f"fit_{mode}"] for r in ranks]
    lc = got[0]["losses"]
    np.testing.assert_array_equal(got[0]["flat"], got[1]["flat"])
    assert np.isfinite(lc).all()
    assert lc[-1] < lc[0] * 0.7, lc  # it learns
    assert abs(lc[-1] / exact[-1] - 1.0) < 0.05, (lc[-1], exact[-1])
    assert got[0]["residual_max"] > 0  # the residual carries deferred mass


def test_trainer_fit_on_two_ranks(ranks):
    import jax
    import jax.numpy as jnp

    from tpuframe.parallel import ParallelPlan as JaxPlan
    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import grad_layout as jax_layout
    from tpuframe.parallel.compression import wire_plan as jax_wire_plan
    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec

    t0, t1 = (r["trainer"] for r in ranks)
    np.testing.assert_array_equal(t0["flat"], t1["flat"])
    assert t0["plan_world"] == 2 and t0["local_batch"] == 8 and t0["batches"] == 3
    tree = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in t0["shapes"].items()}
    want = jax_wire_plan(jax_layout(tree, JaxConfig(mode="int8"),
                                    JaxPlan(mesh=JaxMeshSpec(data=2).build(jax.devices()[:2]))),
                         JaxConfig(mode="int8"))
    assert t0["wire"] == want and want["bytes_per_step"] > 0
    for t in (t0, t1):
        assert t["metered"] == want["bytes_per_step"] * t["batches"]
        assert t["eval_count"] == 21  # each genuine sample once, in every rank's sums
        assert t["history"][0]["eval_loss"] == pytest.approx(t0["history"][0]["eval_loss"])
    assert t0["log_calls"] > 0 and t1["log_calls"] == 0
