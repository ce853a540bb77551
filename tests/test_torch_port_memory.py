"""The port's memory estimator (``tpuframe_torch.parallel.memory``) against
the JAX package's, and against the bytes ZeRO ranks really hold.

- ``plan_memory`` and ``suggest_fit`` return the JAX package's dicts,
  exactly, for the same plan and templates: ZeRO stages 0-3, optimizer
  offload, grad-accum microbatches, an optimizer-state template and an
  error-feedback template, on four meshes.  The templates are ``(shape,
  dtype)`` pairs, the dtype a name on the JAX side and a torch dtype or a
  tensor on the port's.
- ``zero_stage_default`` and ``offload_optimizer_default`` read the env
  as JAX's do.
- Two gloo ranks (mesh fsdp 2) under stages 0-3: the bytes each rank holds
  in parameters (every distinct storage, shards and resting tensors
  included) and in optimizer-state slots (AdamW's moments; the scalar
  counts are not slots) equal ``plan_memory``'s ``params`` and
  ``opt_state`` exactly.
"""

import warnings

import numpy as np
import pytest
import torch
from torch import nn

from torch_ranks import run_ranks
from tpuframe_torch.core.runtime import MeshSpec
from tpuframe_torch.parallel import ParallelPlan, ZeroConfig, plan_memory, suggest_fit
from tpuframe_torch.parallel.comms_env import offload_optimizer_default, zero_stage_default

MESHES = [dict(data=1, fsdp=2), dict(data=2, fsdp=2), dict(data=4, fsdp=1), dict(data=1, fsdp=8)]

#: a ResNet-ish and a transformer-ish set of (flax) shapes
MODEL = {
    "conv1": {"kernel": ((7, 7, 3, 64), "float32")},
    "layer1": {"conv": {"kernel": ((3, 3, 64, 64), "float32")},
               "bn": {"scale": ((64,), "float32"), "bias": ((64,), "float32")}},
    "layer4": {"conv": {"kernel": ((3, 3, 512, 512), "float32")}},
    "embed": {"embedding": ((32768, 768), "float32")},
    "attn": {"kernel": ((768, 2304), "float32"), "bias": ((2304,), "float32")},
    "odd": {"kernel": ((7, 5), "float32")},
    "head": {"kernel": ((2048, 1000), "bfloat16"), "bias": ((1000,), "bfloat16")},
}
BATCH = {"image": ((64, 224, 224, 3), "uint8"), "label": ((64,), "int32")}


def _opt_template(model: dict) -> dict:
    """optax adam's state over ``model``: the count, ``mu`` and ``nu``."""
    return {"0": {"count": ((), "int32"), "mu": model, "nu": model}}


COMMS = {"flat": ((2, 6, 8192), "float32"), "leaf.layer4.conv.kernel": ((2, 3, 3, 512, 512),
                                                                        "float32")}


def _torch_dtypes(tree):
    """The template with torch dtypes in place of the names."""
    if isinstance(tree, dict):
        return {k: _torch_dtypes(v) for k, v in tree.items()}
    shape, name = tree
    return (shape, getattr(torch, name))


def _plans(mesh: dict, **kw):
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.parallel import ParallelPlan as JaxPlan

    n = mesh["data"] * mesh["fsdp"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # offload off a host memory space downgrades loudly
        return (JaxPlan(mesh=JaxMeshSpec(**mesh).build(jax.devices()[:n]), **kw),
                ParallelPlan(mesh=MeshSpec(**mesh).build(n), **kw))


CASES = [
    ("adam", {}),
    ("opt_template", {"opt_template": True}),
    ("ef_template", {"comms_template": COMMS}),
    ("micro4", {"microbatches": 4}),
    ("sgd_factor", {"optimizer": "sgd", "activation_factor": 3.5, "top_leaves": 3}),
    ("hypothetical", {"zero_stage": 3, "offload_optimizer": True}),
]


@pytest.mark.parametrize("case,kw", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("stage,offload", [(0, False), (1, False), (2, False), (3, False),
                                           (3, True)])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"d{m['data']}f{m['fsdp']}")
def test_plan_memory_equals_jax(mesh, stage, offload, case, kw):
    from tpuframe.parallel.memory import plan_memory as jax_plan_memory

    jp, tp = _plans(mesh, zero_stage=stage, offload_optimizer=offload)
    kw = dict(kw)
    if kw.pop("opt_template", False):
        kw["opt_template"] = _opt_template(MODEL)
    want = jax_plan_memory(jp, MODEL, BATCH, **kw)
    assert plan_memory(tp, MODEL, BATCH, **kw) == want
    if "opt_template" in kw:
        kw["opt_template"] = _torch_dtypes(kw["opt_template"])
    assert plan_memory(tp, _torch_dtypes(MODEL), _torch_dtypes(BATCH), **kw) == want


@pytest.mark.parametrize("budget", [None, 4000.0, 1500.0, 10.0])
@pytest.mark.parametrize("stage", [0, 1, 3])
@pytest.mark.parametrize("mesh", MESHES[:2], ids=lambda m: f"d{m['data']}f{m['fsdp']}")
def test_suggest_fit_equals_jax(mesh, stage, budget):
    from tpuframe.parallel.memory import suggest_fit as jax_suggest_fit

    jp, tp = _plans(mesh, zero_stage=stage)
    for kw in ({}, {"comms_template": COMMS, "microbatches": 2}):
        want = jax_suggest_fit(jp, MODEL, BATCH, budget_mb=budget, **kw)
        assert suggest_fit(tp, MODEL, BATCH, budget_mb=budget, **kw) == want


def test_tensors_price_as_their_shapes():
    """Live tensors (and a torch dtype's itemsize) price as the pairs do."""
    from tpuframe.parallel.memory import plan_memory as jax_plan_memory

    jp, tp = _plans(MESHES[0], zero_stage=3)
    rng = np.random.default_rng(0)
    tensors = {"w": torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)),
               "b": torch.zeros(128, dtype=torch.bfloat16)}
    pairs = {"w": ((256, 128), "float32"), "b": ((128,), "bfloat16")}
    assert plan_memory(tp, tensors) == jax_plan_memory(jp, pairs)


@pytest.mark.parametrize("raw", [None, "", "2", "3", "7", "-1", "x", "0", "1", "true", "off",
                                 "no", "FALSE"])
def test_zero_env_knobs_read_as_jax(raw):
    from tpuframe.parallel.comms_env import offload_optimizer_default as jax_offload
    from tpuframe.parallel.comms_env import zero_stage_default as jax_stage

    env = {} if raw is None else {"TPUFRAME_ZERO_STAGE": raw, "TPUFRAME_OFFLOAD_OPTIMIZER": raw}
    assert zero_stage_default(env) == jax_stage(env)
    assert offload_optimizer_default(env) == jax_offload(env)


# -- the bytes two ranks hold ----------------------------------------------------------


class Net(nn.Module):
    """Sliced and whole leaves: a conv (channels_last, as the port's ResNet
    keeps them), a linear, an odd-sized linear and the biases."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.conv = nn.Conv2d(64, 128, 3, bias=False).to(memory_format=torch.channels_last)
        self.fc = nn.Linear(128, 512)
        self.odd = nn.Linear(512, 7)

    def forward(self, x):
        h = self.conv(x.permute(0, 3, 1, 2)).mean((2, 3))
        return self.odd(torch.relu(self.fc(h)))


def _held(rank: int, world: int) -> dict:
    from tpuframe_torch.core import initialize
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import create_train_state, make_train_step

    warnings.simplefilter("ignore")
    rt = initialize({"data": 1, "fsdp": world}, device="cpu")
    out = {}
    for stage in range(4):
        model = Net()
        plan = ZeroConfig(stage=stage, min_shard_elems=64).plan(rt.mesh)
        state = create_train_state(model, fused_adamw(1e-3), plan=plan)
        step = make_train_step(plan=plan, loss_fn=lambda y, lab: (y.float() ** 2).mean(-1))
        x = torch.randn(4, 6, 6, 64, generator=torch.Generator().manual_seed(rank))
        state, _ = step(state, {"input": x, "label": torch.zeros(4, dtype=torch.int64)})
        tensors = [p for p in model.parameters()]
        if state.zero is not None:
            tensors += list(state.zero.shards.values()) + list(state.zero.resting.values())
        storages = {}
        for t in tensors:
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
        slots = sum(v.numel() * v.element_size() for st in state.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v) and v.ndim > 0)
        est = plan_memory(plan, {n: p for n, p in model.named_parameters()}, optimizer="adamw")
        out[stage] = {"params": sum(storages.values()), "slots": slots,
                      "estimate": est["per_device_mb"]}
    return out


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    return run_ranks(_held, 2, tmp_path_factory.mktemp("held"), timeout=240)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_ranks_hold_the_bytes_plan_memory_prices(held, stage):
    mb = 1024.0 * 1024.0
    for r in held:
        got, est = r[stage], r[stage]["estimate"]
        assert round(got["params"] / mb, 3) == est["params"]
        assert round(got["slots"] / mb, 3) == est["opt_state"]
    if stage == 3:  # resting shards: half of the sliced leaves' bytes
        assert held[0][3]["params"] < held[0][0]["params"]
    if stage >= 1:
        assert held[0][stage]["slots"] < held[0][0]["slots"]
