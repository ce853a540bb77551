"""ZeRO stages 1-3 in the port, against the JAX package and against the
port's own stage 0.

- The plan's placement: ``param_spec``, ``_state_spec`` and
  ``update_shard_specs`` equal JAX's for the same shapes and meshes (the
  port's specs are tuples, JAX's ``PartitionSpec``s compared as tuples);
  ``ZeroConfig.from_dict``, ``signature()``, ``describe_topology()`` and
  ``rebind`` equal JAX's; ``MeshSpec(fsdp=k)`` lays ranks out in JAX's
  device order.
- The shard dimension: a 64 -> 64 conv and a square linear take JAX's
  logical axis (the input channels, picked on the flax layout) where the
  torch layout alone would take the output one.
- Two gloo ranks (mesh fsdp 2): a small MLP under stages 1, 2 and 3
  updates bit for bit as stage 0 does (fused AdamW, SGD with momentum,
  AdamW; three steps); with the clip, within 1e-6 relative (the
  plan-global norm sums the owned slices' squares in another order), and
  the health verdict's norm equals the unsliced one within 1e-6; the JAX
  ``TestZeroEndToEnd`` setup (its weights and batch, adam 1e-2) within its
  rtol 1e-5; lamb and adafactor raise ``NotImplementedError``.
- A small ResNet18 (JAX's weights carried in) takes two steps under
  ``zero_2`` and ``zero_3`` against JAX's ``make_train_step(plan=...)``,
  and one compressed int8 ``zero_2`` step against JAX's compressed step,
  at ``test_torch_port_dp_train.py``'s tolerances; the compressed
  ``zero_3`` step equals ``zero_2``'s bit for bit.
- ``Trainer.fit`` under ``zero_2`` and ``zero_3`` resumes bit-equal from
  a mid-run snapshot; the manifest records the stage and the plan's
  signature, and the optimizer leaves at the parameters' full shapes.
- Four gloo ranks (data 2 x fsdp 2): stages 1 and 3 within 1e-6 of stage 0
  (the owned chunk's sum runs (a + b) + (c + d) where stage 0's all-reduce
  runs gloo's order), and the JAX setup within rtol 1e-5.

The rank functions live here and import no JAX (the JAX side stays in the
test functions), as ``tests/torch_ranks.py`` asks.
"""

import types
import warnings

import numpy as np
import pytest
import torch
from torch import nn

from torch_ranks import run_ranks
from tpuframe_torch.core.runtime import MeshSpec
from tpuframe_torch.parallel import ParallelPlan, ZeroConfig, flax_orders, infer_shard_dim

# -- the plan against JAX's ------------------------------------------------------

MESHES = [dict(data=1, fsdp=2), dict(data=2, fsdp=2), dict(data=4, fsdp=1), dict(data=1, fsdp=4)]
#: flax-layout shapes: conv HWIO, dense (in, out), biases, norms, embeddings
SHAPES = [(3, 3, 64, 64), (3, 3, 64, 128), (1, 1, 256, 64), (768, 3072), (3072, 768),
          (768, 768), (32768, 768), (1000,), (64,), (7, 5), (128, 3), (2, 2, 2, 2048)]


def _jax_plan(mesh: dict, **kw):
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.parallel import ParallelPlan as JaxPlan

    n = mesh["data"] * mesh["fsdp"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # offload on the CPU backend downgrades loudly
        return JaxPlan(mesh=JaxMeshSpec(**mesh).build(jax.devices()[:n]), **kw)


def _port_plan(mesh: dict, **kw):
    n = mesh["data"] * mesh["fsdp"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ParallelPlan(mesh=MeshSpec(**mesh).build(n), **kw)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"d{m['data']}f{m['fsdp']}")
def test_plan_specs_match_jax(mesh, stage):
    import jax

    for kw in ({}, {"min_shard_elems": 64}):
        jp, tp = _jax_plan(mesh, zero_stage=stage, **kw), _port_plan(mesh, zero_stage=stage, **kw)
        for i, shape in enumerate(SHAPES):
            path = f"layer{i}/kernel"
            assert tp.param_spec(path, shape) == tuple(jp.param_spec(path, shape)), shape
            assert tp._state_spec(path, shape) == tuple(jp._state_spec(path, shape)), shape
        tree = {f"layer{i}": {"kernel": jax.ShapeDtypeStruct(s, jax.numpy.float32)}
                for i, s in enumerate(SHAPES)}
        port_tree = {f"layer{i}": {"kernel": types.SimpleNamespace(shape=s)}
                     for i, s in enumerate(SHAPES)}
        assert tp.update_shard_specs(port_tree) == jp.update_shard_specs(tree)
        assert tp.dp_size == jp.dp_size and tuple(tp.batch_spec()) == tuple(jp.batch_spec())
        assert set(tp.describe(port_tree)) == set(jp.describe(tree))


def test_mesh_lays_ranks_out_in_jax_device_order():
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec

    for mesh in MESHES:
        n = mesh["data"] * mesh["fsdp"]
        jm = JaxMeshSpec(**mesh).build(jax.devices()[:n])
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        tm = MeshSpec(**mesh).build(n)
        np.testing.assert_array_equal(tm.devices, ids)
        assert dict(tm.shape) == {k: int(v) for k, v in jm.shape.items()}
        for rank in range(n):
            assert tm.coords(rank)["fsdp"] == rank % mesh["fsdp"]
            assert tm.coords(rank)["data"] == rank // mesh["fsdp"]
    # the model and seq axes are ported; seq beside model still raises
    assert MeshSpec(fsdp=2, model=2).build(4).shape["model"] == 2
    assert MeshSpec(fsdp=2, seq=2).build(4).shape["seq"] == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MeshSpec(seq=2, model=2).build(4)


class ConvAndLinear(nn.Module):
    """A 64 -> 64 conv and a square linear, where the torch layout's largest
    divisible dim (the first on a tie) is the output one."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(64, 64, 3, bias=False)
        self.proj = nn.Linear(256, 256)
        self.table = nn.Embedding(256, 128)


def test_the_shard_dim_is_jax_logical_axis():
    import jax

    model = ConvAndLinear()
    orders = flax_orders(model)
    assert orders == {"conv.weight": (2, 3, 1, 0), "proj.weight": (1, 0)}
    # on the flax layout JAX picks the input channels (dim 2 of HWIO, dim 0
    # of a dense kernel): the torch dim 1 of both
    assert infer_shard_dim((64, 64, 3, 3), 2) == 0  # the torch layout alone: the output
    assert infer_shard_dim((64, 64, 3, 3), 2, order=orders["conv.weight"]) == 1
    assert infer_shard_dim((256, 256), 2, order=orders["proj.weight"]) == 1
    plan = _port_plan(dict(data=1, fsdp=2), zero_stage=2, min_shard_elems=64)
    specs = plan.update_shard_specs(dict(model.named_parameters()), orders)
    jtree = {"conv": {"kernel": jax.ShapeDtypeStruct((3, 3, 64, 64), jax.numpy.float32)},
             "proj": {"kernel": jax.ShapeDtypeStruct((256, 256), jax.numpy.float32),
                      "bias": jax.ShapeDtypeStruct((256,), jax.numpy.float32)},
             "table": {"embedding": jax.ShapeDtypeStruct((256, 128), jax.numpy.float32)}}
    jspecs = _jax_plan(dict(data=1, fsdp=2), zero_stage=2,
                       min_shard_elems=64).update_shard_specs(jtree)
    # each torch dim maps to the flax dim JAX chose
    assert orders["conv.weight"][jspecs["conv/kernel"][0]] == specs["conv.weight"][0] == 1
    assert orders["proj.weight"][jspecs["proj/kernel"][0]] == specs["proj.weight"][0] == 1
    assert jspecs["table/embedding"][0] == specs["table.weight"][0] == 0
    assert specs["proj.bias"] == jspecs["proj/bias"] == (0, ("fsdp",))
    assert plan.param_spec("conv.weight", (64, 64, 3, 3), orders["conv.weight"]) == ()
    assert _port_plan(dict(data=1, fsdp=2), zero_stage=3, min_shard_elems=64).param_spec(
        "conv.weight", (64, 64, 3, 3), orders["conv.weight"]) == (None, "fsdp", None, None)


ZERO_DICTS = [
    {"zero_optimization": {"stage": 2}},
    {"zero_optimization": {"stage": 3, "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_optimizer": {"device": "none"}}},
    {"stage": 1, "min_shard_elems": 1024},
    {"stage": 3, "offload_optimizer": True},
    {},
]


@pytest.mark.parametrize("cfg", ZERO_DICTS, ids=range(len(ZERO_DICTS)))
def test_zero_config_from_dict_matches_jax(cfg):
    from tpuframe.parallel.zero import ZeroConfig as JaxZeroConfig

    want = JaxZeroConfig.from_dict(cfg)
    got = ZeroConfig.from_dict(cfg)
    assert (got.stage, got.offload_optimizer, got.min_shard_elems) == (
        want.stage, want.offload_optimizer, want.min_shard_elems)
    mesh = dict(data=1, fsdp=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = want.plan(_jax_plan(mesh).mesh)
        tp = got.plan(MeshSpec(**mesh).build(2))
    assert tp.signature() == jp.signature()


SIGNATURES = [dict(zero_stage=s) for s in range(4)] + [
    dict(zero_stage=3, offload_optimizer=True), dict(zero_stage=2, comms_groups=4),
    dict(zero_stage=1, comms_groups=1), dict(zero_stage=2, comms_fused=True),
    dict(zero_stage=0, comms_fused=False), dict(zero_stage=3, min_shard_elems=64),
]


@pytest.mark.parametrize("kw", SIGNATURES, ids=[str(sorted(k.items())) for k in SIGNATURES])
@pytest.mark.parametrize("mesh", MESHES[:3], ids=lambda m: f"d{m['data']}f{m['fsdp']}")
def test_signature_matches_jax(mesh, kw):
    assert _port_plan(mesh, **kw).signature() == _jax_plan(mesh, **kw).signature()


def test_topology_and_rebind_match_jax():
    from tpuframe.track.telemetry import get_telemetry as jax_telemetry
    from tpuframe_torch.track.telemetry import get_telemetry

    jp, tp = _jax_plan(dict(data=1, fsdp=4), zero_stage=3), _port_plan(dict(data=1, fsdp=4),
                                                                       zero_stage=3)
    assert tp.describe_topology() == jp.describe_topology()
    jsmall, tsmall = _jax_plan(dict(data=2, fsdp=1)), _port_plan(dict(data=2, fsdp=1))
    events = []
    tele = get_telemetry()
    real = tele.event
    tele.event = lambda name, **kw: events.append((name, kw))
    try:
        with pytest.warns(UserWarning, match="collapsed"):
            trebound = tp.rebind(tsmall.mesh)
    finally:
        tele.event = real
    jevents = []
    jtele = jax_telemetry()
    jreal = jtele.event
    jtele.event = lambda name, **kw: jevents.append((name, kw))
    try:
        with pytest.warns(UserWarning, match="collapsed"):
            jrebound = jp.rebind(jsmall.mesh)
    finally:
        jtele.event = jreal
    assert trebound.signature() == jrebound.signature() and trebound.zero_stage == 3
    assert events == jevents


def test_a_zero_plan_builds_and_offload_applies_only_on_the_card():
    mesh = MeshSpec(data=1, fsdp=2).build(2)
    for stage in (1, 2, 3):
        assert ParallelPlan(mesh=mesh, zero_stage=stage).zero_stage == stage
    with pytest.warns(UserWarning, match="downgrading"):
        plan = ParallelPlan(mesh=mesh, zero_stage=3, offload_optimizer=True)
    assert not plan._offload_active()  # the CPU has no host space apart from its device
    from tpuframe_torch.parallel import host_offload_sharding, supports_host_offload

    assert not supports_host_offload()
    with pytest.raises(RuntimeError, match="pinned host"):
        host_offload_sharding(torch.zeros(3))
    # the compressed step refuses offload, as JAX's does
    from tpuframe_torch.train import make_train_step

    with pytest.raises(ValueError, match="offload_optimizer"):
        make_train_step(plan=plan, grad_compression="int8")


# -- the ranks' work ---------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, seed: int = 0):
        super().__init__()
        torch.manual_seed(seed)
        self.fc1 = nn.Linear(16, 32)
        self.fc2 = nn.Linear(32, 8)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class Tiny(nn.Module):
    """JAX ``TestZeroEndToEnd``'s two dense layers, no activation."""

    def __init__(self, params: dict):
        super().__init__()
        self.dense = nn.Linear(64, 512)
        self.out = nn.Linear(512, 16)
        with torch.no_grad():
            for name in ("dense", "out"):
                getattr(self, name).weight.copy_(torch.from_numpy(params[name]["kernel"].T))
                getattr(self, name).bias.copy_(torch.from_numpy(params[name]["bias"]))

    def forward(self, x):
        return self.out(self.dense(x))


def _tiny_inputs():
    """``tests/test_parallel.py``'s ``tiny_params`` and batch."""
    params = {"dense": {"kernel": np.ones((64, 512), np.float32),
                        "bias": np.ones(512, np.float32)},
              "out": {"kernel": np.ones((512, 16), np.float32), "bias": np.ones(16, np.float32)}}
    return params, np.random.RandomState(0).randn(16, 64).astype(np.float32)


def _square_loss(y, labels):
    return (y.float() ** 2).mean(-1)


def _optimizer(name: str, clip=None):
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import make_optimizer

    if name == "fused_adamw":
        return fused_adamw(1e-2, weight_decay=1e-4, max_grad_norm=clip)
    return make_optimizer(name, 1e-2, clip)


def _mlp_run(plan, opt: str, rank: int, world: int, clip=None, health=None) -> dict:
    from tpuframe_torch.train import create_train_state, make_train_step

    model = MLP()
    state = create_train_state(model, _optimizer(opt, clip), plan=plan)
    step = make_train_step(plan=plan, health=health)
    g = torch.Generator().manual_seed(1)
    norms = []
    for _ in range(3):
        x = torch.randn(8 * world, 16, generator=g)
        y = torch.randint(0, 8, (8 * world,), generator=g)
        state, m = step(state, {"input": x[rank * 8:(rank + 1) * 8],
                                "label": y[rank * 8:(rank + 1) * 8]})
        if health is not None:
            norms.append(float(m["health_stats"][3]))
    data = state.state_dict()
    return {"params": {k: v.numpy().copy() for k, v in data["model"].items()},
            "optimizer": {n: {k: v.numpy().copy() for k, v in st.items()}
                          for n, st in data["optimizer"].items()},
            "norms": norms, "sliced": sorted(state.zero.opt) if state.zero else []}


def _tiny_run(plan, params, x, rank, world) -> dict:
    from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step

    model = Tiny(params)
    state = create_train_state(model, make_optimizer("adam", 1e-2), plan=plan)
    step = make_train_step(loss_fn=_square_loss, plan=plan)
    n = x.shape[0] // world
    local = torch.from_numpy(x[rank * n:(rank + 1) * n])
    step(state, {"input": local, "label": torch.zeros(n, dtype=torch.int64)})
    data = state.state_dict()["model"]
    return {k: v.numpy().copy() for k, v in data.items()}


RESNET_MIN = 64  # min_shard_elems of the ResNet18 plans (num_filters 4)


def _resnet_run(plan, variables, batches, rank, world, wire=None) -> dict:
    from tpuframe_torch.models import ResNet18, from_jax_variables
    from tpuframe_torch.models.interop import import_torch_resnet
    from tpuframe_torch.parallel import CommsConfig, full_precision, init_comms_state
    from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step
    from tpuframe_torch.train.step import trainable_parameters

    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    config = CommsConfig(**wire) if wire else None
    state = create_train_state(model, make_optimizer("sgd", 0.1), plan=plan,
                               grad_compression=config)
    if config is not None:
        state.comms = init_comms_state(trainable_parameters(model), plan, config)
    step = make_train_step(full_precision(), plan=plan, grad_compression=config)
    losses, amax = [], []
    n = batches[0]["image"].shape[0] // world
    for b in batches:
        local = {k: torch.from_numpy(v[n * rank:n * (rank + 1)]) for k, v in b.items()}
        grads = []
        hooks = [p.register_hook(lambda g: grads.append(float(g.abs().max())))
                 for p in model.parameters()]
        state, m = step(state, local)
        for h in hooks:
            h.remove()
        amax.append(max(grads))
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    tree = import_torch_resnet(state.state_dict()["model"])
    return {"losses": losses, "local_amax": amax, "params": tree["params"],
            "batch_stats": tree["batch_stats"], "wire": step.wire,
            "sliced": sorted(state.zero.opt) if state.zero else []}


def _trainer(directory, plan, duration, callbacks=()):
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet18
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import Trainer

    loader = DataLoader(SyntheticImageDataset(n=64, image_size=8, num_classes=4), 16,
                        shuffle=True, seed=5)
    return Trainer(ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu"),
                   train_dataloader=loader, max_duration=duration,
                   tx=fused_adamw(1e-2, weight_decay=1e-4, max_grad_norm=1.0),
                   num_classes=4, log_interval=0, plan=plan, callbacks=list(callbacks),
                   checkpointer=None if directory is None else Checkpointer(directory),
                   checkpoint_interval_batches=2 if directory is not None else None)


def _resume_run(rt, directory: str, stage: int) -> dict:
    from tpuframe_torch.train.callbacks import Callback

    class Bomb(Callback):
        def on_step_end(self, trainer):
            if trainer.batches_seen >= 3:
                raise RuntimeError("boom")

    plan = ZeroConfig(stage=stage, min_shard_elems=RESNET_MIN).plan(rt.mesh)
    first = _trainer(directory, plan, "4ba", [Bomb()])
    try:
        first.fit()
    except RuntimeError as e:
        assert "boom" in str(e)
    resumed = _trainer(directory, plan, "4ba")
    resumed.fit()
    straight = _trainer(None, plan, "4ba")
    straight.fit()
    out = {"step": resumed.state.step, "sliced": len(resumed.state.zero.opt)}
    a, b = resumed.state.state_dict(), straight.state.state_dict()
    out["params_equal"] = all(torch.equal(a["model"][k], b["model"][k]) for k in b["model"])
    out["optimizer_equal"] = all(torch.equal(a["optimizer"][n][k], b["optimizer"][n][k])
                                 for n in b["optimizer"] for k in b["optimizer"][n])
    out["optimizer_shapes"] = {n: tuple(st["mu"].shape) for n, st in a["optimizer"].items()}
    out["param_shapes"] = {n: tuple(p.shape) for n, p in resumed.model.named_parameters()}
    out["signature"] = plan.signature()
    out["directory"] = directory
    return out


def _two_ranks(rank: int, world: int, tiny, resnet, tmp: str) -> dict:
    from tpuframe_torch.core import initialize
    from tpuframe_torch.fault.health import HealthPolicy

    warnings.simplefilter("ignore")
    rt = initialize({"data": 1, "fsdp": world}, device="cpu")
    plans = {s: ZeroConfig(stage=s, min_shard_elems=64).plan(rt.mesh) for s in range(4)}
    out = {"ladder": {}, "clip": {}, "tiny": {}, "resnet": {}, "raises": {}, "resume": {}}
    for opt in ("fused_adamw", "sgd", "adamw"):
        for s in range(4):
            out["ladder"][(opt, s)] = _mlp_run(plans[s], opt, rank, world)
    policy = HealthPolicy(warmup_steps=100)
    for s in (0, 1, 3):
        out["clip"][s] = _mlp_run(plans[s], "fused_adamw", rank, world, clip=0.05,
                                  health=policy)
    tiny_plans = {s: ZeroConfig(stage=s, min_shard_elems=1).plan(rt.mesh) for s in (0, 1, 3)}
    for s, plan in tiny_plans.items():
        out["tiny"][s] = _tiny_run(plan, *tiny, rank, world)
    from tpuframe_torch.train import create_train_state, make_optimizer

    for name in ("lamb", "adafactor"):
        try:
            create_train_state(MLP(), make_optimizer(name, 1e-3), plan=plans[2])
            out["raises"][name] = None
        except NotImplementedError as e:
            out["raises"][name] = str(e)
    variables, batches = resnet
    rplans = {s: ZeroConfig(stage=s, min_shard_elems=RESNET_MIN).plan(rt.mesh) for s in (2, 3)}
    for s, plan in rplans.items():
        out["resnet"][s] = _resnet_run(plan, variables, batches, rank, world)
    for s in (2, 3):
        out["resnet"][f"int8_{s}"] = _resnet_run(rplans[s], variables, batches[:1], rank, world,
                                                 wire=dict(mode="int8", bucket_mb=64.0))
    for s in (2, 3):
        out["resume"][s] = _resume_run(rt, f"{tmp}/ck{s}", s)
    return out


def _four_ranks(rank: int, world: int, tiny) -> dict:
    from tpuframe_torch.core import initialize

    warnings.simplefilter("ignore")
    rt = initialize({"data": 2, "fsdp": 2}, device="cpu")
    out = {"ladder": {}, "tiny": {}}
    for s in (0, 1, 3):
        out["ladder"][s] = _mlp_run(ZeroConfig(stage=s, min_shard_elems=64).plan(rt.mesh),
                                    "fused_adamw", rank, world)
        out["tiny"][s] = _tiny_run(ZeroConfig(stage=s, min_shard_elems=1).plan(rt.mesh),
                                   *tiny, rank, world)
    return out


# -- the JAX side ------------------------------------------------------------------


def _jax_tiny(params, x) -> dict:
    """JAX ``TestZeroEndToEnd``'s reference: one adam update on one device
    (the JAX test holds every stage to it at rtol 1e-5)."""
    import jax
    import jax.numpy as jnp
    import optax

    def loss_fn(p, xb):
        h = xb @ p["dense"]["kernel"] + p["dense"]["bias"]
        y = h @ p["out"]["kernel"] + p["out"]["bias"]
        return jnp.mean(y ** 2)

    p = jax.tree.map(jnp.asarray, params)
    tx = optax.adam(1e-2)
    updates, _ = tx.update(jax.grad(loss_fn)(p, x), tx.init(p), p)
    return jax.tree.map(np.asarray, optax.apply_updates(p, updates))


def _resnet_batches(n_steps=2):
    rng = np.random.default_rng(0)
    return [{"image": rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (8,)).astype(np.int32)} for _ in range(n_steps)]


def _jax_resnet(variables, batches, stage, wire=None):
    """JAX's step over a (data 1, fsdp 2) mesh under ``zero_k``: the GSPMD
    step, or the compressed one with ``wire``."""
    import jax
    import optax

    from tpuframe.models import ResNet18 as JaxResNet18
    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import init_comms_state as jax_init_comms
    from tpuframe.parallel.precision import full_precision as jax_f32
    from tpuframe.train.state import create_train_state as jax_create_train_state
    from tpuframe.train.step import make_train_step as jax_make_train_step

    plan = _jax_plan(dict(data=1, fsdp=2), zero_stage=stage, min_shard_elems=RESNET_MIN)
    jm = JaxResNet18(num_classes=10, num_filters=4, stem="cifar")
    x0 = np.zeros((8, 16, 16, 3), np.float32)
    tx = optax.sgd(0.1, momentum=0.9)
    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, tx, plan=plan,
                                init_kwargs={"train": False})
    params = jax.device_put(jax.tree.map(jax.numpy.asarray, variables["params"]),
                            plan.param_shardings(js.params))
    stats = jax.tree.map(jax.numpy.asarray, variables["batch_stats"])
    opt = jax.device_put(tx.init(params), plan.state_shardings(js.opt_state, params))
    js = js.replace(params=params, batch_stats=stats, opt_state=opt)
    kw = {}
    if wire:
        config = JaxConfig(**wire)
        js = js.replace(comms=jax_init_comms(params, plan, config))
        kw = dict(grad_compression=config)
    step = jax_make_train_step(jax_f32(), donate=False, plan=plan, **kw)
    losses = []
    for b in batches:
        js, m = step(js, plan.shard_batch(b))
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    as_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return losses, as_np(js.params), as_np(js.batch_stats), getattr(step, "wire", None)


@pytest.fixture(scope="module")
def resnet_inputs():
    import jax

    from test_torch_port_train import _variables
    from tpuframe.models import ResNet18 as JaxResNet18

    jm = JaxResNet18(num_classes=10, num_filters=4, stem="cifar")
    v = _variables(jm, np.zeros((8, 16, 16, 3), np.float32), 11)
    return jax.tree.map(np.asarray, v), _resnet_batches()


@pytest.fixture(scope="module")
def two(resnet_inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero2")
    return run_ranks(_two_ranks, 2, tmp, _tiny_inputs(), resnet_inputs, str(tmp), timeout=400)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks(_four_ranks, 4, tmp_path_factory.mktemp("zero4"), _tiny_inputs(),
                     timeout=300)


def _equal_trees(a: dict, b: dict, what: str):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k], f"{what}/{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}/{k}")


# -- two ranks ---------------------------------------------------------------------


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("opt", ["fused_adamw", "sgd", "adamw"])
def test_stages_update_bit_equal_to_stage_0(two, opt, stage):
    ref = two[0]["ladder"][(opt, 0)]
    for r in two:
        got = r["ladder"][(opt, stage)]
        assert got["sliced"] == ["fc1.weight", "fc2.weight"]  # 512 and 256 elements >= 64
        _equal_trees(got["params"], ref["params"], f"{opt} stage {stage} params")
        _equal_trees(got["optimizer"], ref["optimizer"], f"{opt} stage {stage} optimizer")


@pytest.mark.parametrize("stage", [1, 3])
def test_the_clip_and_the_health_norm_are_plan_global(two, stage):
    ref, got = two[0]["clip"][0], two[0]["clip"][stage]
    np.testing.assert_allclose(got["norms"], ref["norms"], rtol=1e-6)
    assert min(ref["norms"]) > 0.05  # the clip engaged on every step
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k], ref["params"][k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    _equal_trees(two[1]["clip"][stage]["params"], got["params"], "rank 1")


@pytest.mark.parametrize("stage", [0, 1, 3])
def test_the_jax_zero_end_to_end_setup(two, stage):
    params, x = _tiny_inputs()
    want = _jax_tiny(params, x)
    for r in two:
        got = r["tiny"][stage]
        for name in ("dense", "out"):
            np.testing.assert_allclose(got[f"{name}.weight"].T, want[name]["kernel"], rtol=1e-5)
            np.testing.assert_allclose(got[f"{name}.bias"], want[name]["bias"], rtol=1e-5)
    _equal_trees(two[0]["tiny"][stage], two[0]["tiny"][0], f"stage {stage}")


@pytest.mark.parametrize("name", ["lamb", "adafactor"])
def test_per_tensor_optimizers_raise_under_zero(two, name):
    assert "ROADMAP" in (two[0]["raises"][name] or "")


def _resnet_against_jax(got, want_losses, want_params, want_stats, lr, momentum, quantum=0.0):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    tol = 2e-4 + lr * (1 + momentum) * quantum
    from test_torch_port_dp_train import _leaves

    want = dict(_leaves({"params": want_params, "batch_stats": want_stats}))
    have = dict(_leaves({"params": got["params"], "batch_stats": got["batch_stats"]}))
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("stage", [2, 3])
def test_resnet18_steps_match_jax_zero_step(two, resnet_inputs, stage):
    variables, batches = resnet_inputs
    losses, params, stats, _ = _jax_resnet(variables, batches, stage)
    got = two[0]["resnet"][stage]
    assert len(got["sliced"]) > 10
    _resnet_against_jax(got, losses, params, stats, 0.1, 0.9)
    _equal_trees(two[1]["resnet"][stage]["params"], got["params"], "rank 1")


def test_compressed_zero_2_step_matches_jax(two, resnet_inputs):
    variables, batches = resnet_inputs
    wire = dict(mode="int8", bucket_mb=64.0)
    losses, params, stats, jwire = _jax_resnet(variables, batches[:1], 2, wire)
    got = [r["resnet"]["int8_2"] for r in two]
    quantum = max(max(r["local_amax"]) for r in got) / 127 / 2
    _resnet_against_jax(got[0], losses, params, stats, 0.1, 0.9, quantum)
    _equal_trees(got[1]["params"], got[0]["params"], "rank 1")
    assert got[0]["wire"]["sliced_leaves"] == jwire["sliced_leaves"] > 0
    for key in ("bytes_per_step", "f32_bytes_per_step", "n_buckets", "world", "mode"):
        assert got[0]["wire"][key] == jwire[key], key


def test_compressed_zero_3_step_equals_zero_2(two):
    """Under the wire stage 3's resting shards are the optimizer's: the
    step is stage 2's, bit for bit."""
    for r in two:
        _equal_trees(r["resnet"]["int8_3"]["params"], r["resnet"]["int8_2"]["params"], "zero_3")
        assert r["resnet"]["int8_3"]["losses"] == r["resnet"]["int8_2"]["losses"]


@pytest.mark.parametrize("stage", [2, 3])
def test_trainer_resumes_bit_equal_under_zero(two, stage):
    import tpuframe.ckpt.meta as jax_meta

    for r in two:
        got = r["resume"][stage]
        assert got["step"] == 4 and got["sliced"] > 0
        assert got["params_equal"] and got["optimizer_equal"]
        # the optimizer leaves at their parameters' full shapes
        assert got["optimizer_shapes"] == got["param_shapes"]
    manifest = jax_meta.read_manifest(two[0]["resume"][stage]["directory"])
    assert manifest["zero_stage"] == stage
    assert manifest["plan_signature"] == two[0]["resume"][stage]["signature"]
    leaves = manifest["leaves"]
    assert leaves["optimizer/conv1.weight/mu"]["shape"] == list(
        two[0]["resume"][stage]["param_shapes"]["conv1.weight"])


# -- four ranks --------------------------------------------------------------------


@pytest.mark.parametrize("stage", [1, 3])
def test_four_ranks_data_by_fsdp(four, stage):
    ref = four[0]["ladder"][0]
    for r in four:
        got = r["ladder"][stage]
        for k in ref["params"]:
            np.testing.assert_allclose(got["params"][k], ref["params"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        _equal_trees(got["params"], four[0]["ladder"][stage]["params"], "ranks")
    params, x = _tiny_inputs()
    want = _jax_tiny(params, x)
    got = four[0]["tiny"][stage]
    for name in ("dense", "out"):
        np.testing.assert_allclose(got[f"{name}.weight"].T, want[name]["kernel"], rtol=1e-5)
