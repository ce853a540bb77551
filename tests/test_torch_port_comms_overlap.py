"""The data-parallel stages fired from the backward (``train.step``'s
gradient hooks), and the compressed wire's bucket groups, on gloo ranks
(``tests/torch_ranks.py``; one spawn of 2 ranks runs every 2-rank case,
one spawn of 4 the 4-rank one).

- ``sync_gradients`` in 1, 3 and 4 bucket groups equals the single shot
  bit for bit: int8 and fp8, error feedback on and off, and stochastic
  rounding (one draw over all buckets); the residual of a fit in 2 groups
  round-trips a checkpoint bit for bit (as ``tests/test_comms_overlap.py``
  holds JAX's).
- The train steps with their hooks armed against the same steps with the
  hooks left unarmed (every bucket taken after the backward, the
  non-overlapped order): parameters and buffers bit-equal after two steps,
  for ``_MeanSync`` with sync BatchNorm (its backward all-reduces share
  the process group with the buckets), ``_WireSync`` in 4 groups, a
  parameter the loss leaves without a gradient under both stages, a
  frozen backbone under both, and grad accumulation over 2 microbatches
  under both.  The armed runs issue their collectives from inside the
  backward, in bucket (fire) order; the unarmed ones issue none there.
- Eval, predict and a backward of the caller's own after a train step
  fire no hook and issue no collective.
- At world 4, ``_MeanSync`` armed against unarmed within 1e-6 relative.
- A step that meets another model moves its hooks there.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from torch_ranks import run_ranks
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.core import initialize
from tpuframe_torch.models import ResNet18, TransferClassifier, freeze
from tpuframe_torch.parallel import (
    CommsConfig,
    ParallelPlan,
    grad_layout,
    init_comms_state,
    sync_gradients,
)
from tpuframe_torch.parallel import compression as C
from tpuframe_torch.train import (
    create_train_state,
    make_eval_step,
    make_grad_accum_step,
    make_optimizer,
    make_predict_fn,
    make_train_step,
)
from tpuframe_torch.train import step as S
from tpuframe_torch.train.step import trainable_parameters

#: small buckets, so even the small models here fill several
SMALL_BUCKET_BYTES = 256
WIRE = dict(mode="int8", bucket_mb=0.0005)  # buckets of at most 131 float32 elements


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


@contextlib.contextmanager
def _collectives(log: list):
    """Every ``all_reduce`` issued, as (inside a backward, async)."""
    real = dist.all_reduce

    def spy(tensor, *args, **kwargs):
        log.append((_in_backward(), bool(kwargs.get("async_op"))))
        return real(tensor, *args, **kwargs)

    with mock.patch.object(dist, "all_reduce", spy):
        yield


@contextlib.contextmanager
def _unarmed():
    """The stages with their hooks never armed: every gradient is taken
    after the backward, the non-overlapped order."""
    with mock.patch.object(S._FiredStage, "arm", lambda self, state, n_microbatches=1: None):
        yield


class TinyNoGrad(nn.Module):
    """Dense(16) -> relu -> Dense(4), with a parameter the loss never
    reaches: registered between them (``_MeanSync``'s third bucket) and
    named first (the wire's first bucket, in its last group)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.fc1 = nn.Linear(36, 16)
        self.bias_idle = nn.Parameter(torch.linspace(-1, 1, 40))
        self.fc2 = nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.reshape(x.shape[0], -1))))


def _batches(rank: int, world: int, image: int, classes: int, n: int = 2, micro: int = 0):
    """Rank ``rank``'s rows of ``n`` global batches of 4 a rank."""
    gen = torch.Generator().manual_seed(21)
    out = []
    for _ in range(n):
        x = torch.randn(4 * world, image, image, 3 if image > 6 else 1, generator=gen)
        y = torch.randint(0, classes, (4 * world,), generator=gen)
        b = {"image": x[4 * rank:4 * rank + 4], "label": y[4 * rank:4 * rank + 4]}
        if micro:
            b = {k: v.reshape((micro, 4 // micro) + v.shape[1:]) for k, v in b.items()}
        out.append(b)
    return out


def _model(kind: str) -> nn.Module:
    if kind == "resnet":
        return ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu", seed=3)
    if kind == "nograd":
        return TinyNoGrad()
    model = TransferClassifier(ResNet18(num_classes=0, num_filters=4, stem="cifar",
                                        device="cpu", seed=3), 5, device="cpu")
    return freeze(model)


#: (case, model, wire config or None, microbatches)
STEP_CASES = [
    ("mean_sync_bn", "resnet", None, 0),
    ("wire_groups4", "resnet", dict(WIRE, groups=4), 0),
    ("mean_nograd", "nograd", None, 0),
    ("wire_nograd", "nograd", dict(WIRE, bucket_mb=0.0001, groups=3), 0),
    ("mean_frozen", "frozen", None, 0),
    ("wire_frozen", "frozen", dict(WIRE, bucket_mb=0.00002, groups=2), 0),
    ("mean_accum2", "resnet", None, 2),
    ("wire_accum2", "resnet", dict(WIRE, groups=3), 2),
]


def _train(case: str, rank: int, world: int, plan, armed: bool) -> dict:
    """Two steps of ``case`` on this rank: the state's bits, what was issued
    and when."""
    _, kind, wire, micro = next(c for c in STEP_CASES if c[0] == case)
    model = _model(kind)
    state = create_train_state(model, make_optimizer("adam", 1e-2))
    config = None if wire is None else CommsConfig(**wire)
    if config is not None:
        state.comms = init_comms_state(trainable_parameters(model), plan, config)
    if micro:
        step = make_grad_accum_step(micro, plan=plan, grad_compression=config)
    else:
        step = make_train_step(plan=plan, grad_compression=config)
    image, classes = (6, 4) if kind == "nograd" else (16, 10 if kind == "resnet" else 5)
    log, issued = [], []
    real_issue = C._WireRound._issue

    def issue(self, s, e):
        issued.append((s, _in_backward()))
        return real_issue(self, s, e)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(S._MeanSync, "bucket_bytes", SMALL_BUCKET_BYTES))
        stack.enter_context(mock.patch.object(C._WireRound, "_issue", issue))
        stack.enter_context(_collectives(log))
        if not armed:
            stack.enter_context(_unarmed())
        for batch in _batches(rank, world, image, classes, micro=micro):
            state, _ = step(state, batch)
    out = {"state": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
           "async_in_backward": sum(1 for inside, a in log if inside and a),
           "async": sum(1 for _, a in log if a), "issued": issued}
    if config is not None:
        layout = grad_layout(trainable_parameters(model), config, plan)
        out["fire_order"] = [s for s, _ in layout.group_bounds]
        out["residual"] = state.comms["flat"].numpy().copy()
    else:
        stage = S._MeanSync(plan)
        with mock.patch.object(S._MeanSync, "bucket_bytes", SMALL_BUCKET_BYTES):
            stage._build(state)
        out["buckets"] = len(stage._buckets)
    if case == "mean_sync_bn":
        out["after_step"] = _quiet_after_step(model, state, plan)
    return out


def _quiet_after_step(model, state, plan) -> dict:
    """Eval, predict and a backward of the caller's own after the steps:
    the hooks' calls and the collectives they issue."""
    calls, log = [], []
    real = S._FiredStage._on_grad

    def on_grad(self, name, p):
        calls.append(name)
        return real(self, name, p)

    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(5))
    with mock.patch.object(S._FiredStage, "_on_grad", on_grad), _collectives(log):
        make_eval_step(plan=plan)(state, {"image": x, "label": torch.zeros(4, dtype=torch.long)})
        make_predict_fn()(model, x)
        model.zero_grad(set_to_none=True)
        model.train()
        model(x).float().sum().backward()
    return {"hook_calls": len(calls), "async": sum(1 for _, a in log if a),
            "grads": sum(p.grad is not None for p in model.parameters())}


def _grouped_sync(rank: int, plan) -> dict:
    """sync_gradients of one tree in 1, 3 and 4 groups (and the stochastic
    rounding in 1 and 4), each mode with and without error feedback."""
    rng = np.random.default_rng(70 + rank)
    tree = {"a/w": torch.from_numpy((rng.standard_normal((40, 17)) * 2).astype(np.float32)),
            "b/k": torch.from_numpy((rng.standard_normal((3000,)) * 1e-3).astype(np.float32)),
            "c/s": torch.from_numpy(rng.standard_normal((7,)).astype(np.float32))}
    out = {}
    for mode in ("int8", "fp8"):
        for ef in (True, False):
            for sr in ((False, True) if mode == "int8" else (False,)):
                for groups in (1, 3, 4):
                    config = CommsConfig(mode=mode, bucket_mb=0.002, error_feedback=ef,
                                         stochastic_rounding=sr)
                    layout = grad_layout(tree, config, plan, group_buckets=groups)
                    comms = init_comms_state(tree, plan, config)
                    if comms:
                        comms["flat"].normal_(0, 1e-3, generator=torch.Generator().manual_seed(
                            rank))
                    gen = torch.Generator().manual_seed(9 + rank) if sr else None
                    synced, new = sync_gradients(tree, comms, layout, config, gen)
                    out[(mode, ef, sr, groups)] = (
                        {k: v.numpy().copy() for k, v in synced.items()},
                        {k: v.numpy().copy() for k, v in new.items()}, layout.n_groups)
    return out


def _residual_round_trip(rank: int, world: int, plan_groups, directory: str) -> dict:
    config = CommsConfig(mode="int8", bucket_mb=0.0001)
    model = _model("nograd")
    state = create_train_state(model, make_optimizer("adam", 1e-2))
    state.comms = init_comms_state(trainable_parameters(model), plan_groups, config)
    step = make_train_step(plan=plan_groups, grad_compression=config)
    for batch in _batches(rank, world, 6, 4, n=4):
        state, _ = step(state, batch)
    saved = state.comms["flat"].clone()
    ck = Checkpointer(directory)
    ck.save(state, plan=plan_groups)
    fresh = create_train_state(_model("nograd"), make_optimizer("adam", 1e-2))
    fresh.comms = init_comms_state(trainable_parameters(fresh.model), plan_groups, config)
    ck.restore(fresh)
    return {"saved": saved.numpy(), "restored": fresh.comms["flat"].numpy(),
            "groups": step.wire["overlap_groups"]}


def _overlap_worker(rank: int, world: int, directory: str) -> dict:
    rt = initialize(device="cpu")
    plan = ParallelPlan(mesh=rt.mesh)
    if world == 4:
        return {armed: _train("mean_sync_bn", rank, world, plan, armed)
                for armed in (True, False)}
    out = {(case, armed): _train(case, rank, world, plan, armed)
           for case, _, _, _ in STEP_CASES for armed in (True, False)}
    out["grouped"] = _grouped_sync(rank, plan)
    out["round_trip"] = _residual_round_trip(
        rank, world, ParallelPlan(mesh=rt.mesh, comms_groups=2), directory)
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap2")
    return run_ranks(_overlap_worker, 2, tmp, str(tmp / "ck"), timeout=400)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_armed_steps_equal_the_non_overlapped_order(two, case):
    for rank in range(2):
        armed, unarmed = two[rank][(case, True)], two[rank][(case, False)]
        assert set(armed["state"]) == set(unarmed["state"])
        for k in armed["state"]:
            assert _bits_equal(armed["state"][k], unarmed["state"][k]), (rank, k)
        if "residual" in armed:
            assert _bits_equal(armed["residual"], unarmed["residual"])
    for k in two[0][(case, True)]["state"]:  # one model on both ranks
        assert _bits_equal(two[0][(case, True)]["state"][k], two[1][(case, True)]["state"][k]), k


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_armed_steps_issue_from_the_backward_in_fire_order(two, case):
    _, kind, wire, micro = next(c for c in STEP_CASES if c[0] == case)
    for rank in range(2):
        armed, unarmed = two[rank][(case, True)], two[rank][(case, False)]
        assert unarmed["async_in_backward"] == 0
        assert not any(inside for _, inside in unarmed["issued"])
        if wire is None:
            n = armed["buckets"]
            assert n > 1 and armed["async"] == unarmed["async"] == 2 * n  # two steps
        else:
            order = armed["fire_order"]
            assert len(order) == wire["groups"]
            assert [s for s, _ in armed["issued"]] == order * 2  # fire order, every step
            assert [s for s, _ in unarmed["issued"]] == order * 2
            n = len(order)
        inside = armed["async_in_backward"] if wire is None else sum(
            1 for _, i in armed["issued"] if i)
        if kind == "nograd":
            # the idle parameter's zero gradient comes after the backward: the
            # buckets or groups behind it in fire order wait for it
            assert 0 < inside < 2 * n, (case, inside, n)
        else:
            assert inside == 2 * n, (case, inside, n)


def test_eval_predict_and_a_callers_backward_fire_nothing(two):
    for rank in range(2):
        quiet = two[rank][("mean_sync_bn", True)]["after_step"]
        assert quiet == {"hook_calls": 0, "async": 0, "grads": quiet["grads"]}
        assert quiet["grads"] > 0


def test_groups_equal_the_single_shot(two):
    for rank in range(2):
        got = two[rank]["grouped"]
        for (mode, ef, sr, groups), (synced, new, n_groups) in got.items():
            assert n_groups == groups
            one_synced, one_new, _ = got[(mode, ef, sr, 1)]
            for k in synced:
                assert _bits_equal(synced[k], one_synced[k]), (mode, ef, sr, groups, k)
            assert set(new) == set(one_new) == ({"flat"} if ef else set())
            for k in new:
                assert _bits_equal(new[k], one_new[k]), (mode, ef, sr, groups)
        # stochastic rounding rounds elsewhere than round half to even
        assert not _bits_equal(got[("int8", True, True, 1)][0]["a/w"],
                               got[("int8", True, False, 1)][0]["a/w"])


def test_grouped_residual_round_trips_a_checkpoint(two):
    for rank in range(2):
        rt = two[rank]["round_trip"]
        assert rt["groups"] == 2 and np.abs(rt["saved"]).max() > 0
        assert _bits_equal(rt["restored"], rt["saved"])
    assert not _bits_equal(two[0]["round_trip"]["saved"], two[1]["round_trip"]["saved"])


def test_mean_sync_on_four_ranks_within_1e_6_of_the_non_overlapped_order(tmp_path):
    ranks = run_ranks(_overlap_worker, 4, tmp_path, str(tmp_path / "ck"), timeout=300)
    for rank, got in enumerate(ranks):
        armed, unarmed = got[True], got[False]
        assert armed["async_in_backward"] > 0 and unarmed["async_in_backward"] == 0
        for k, a in armed["state"].items():
            b = unarmed["state"][k]
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                           err_msg=f"rank {rank} {k}")
            else:
                np.testing.assert_array_equal(a, b)
    for k in ranks[0][True]["state"]:
        np.testing.assert_array_equal(ranks[0][True]["state"][k], ranks[3][True]["state"][k])


def test_a_step_rebuilds_its_hooks_for_another_model():
    """One compressed step (world 1, no process group) used on one model,
    then on another: the groups fire from the second model's backward, and
    the first model's backward fires nothing after the switch."""
    from tpuframe_torch.core import MeshSpec

    plan = ParallelPlan(mesh=MeshSpec().build(1))
    config = CommsConfig(mode="int8", bucket_mb=0.0001, groups=3)
    step = make_train_step(plan=plan, grad_compression=config)
    issued = []
    real_issue = C._WireRound._issue

    def issue(self, s, e):
        issued.append(_in_backward())
        return real_issue(self, s, e)

    batch = _batches(0, 1, 6, 4, n=1)[0]
    models = [TinyNoGrad(), TinyNoGrad()]
    with mock.patch.object(C._WireRound, "_issue", issue):
        for model in models:
            del model.bias_idle  # every parameter in the loss: every group fires inside
            state = create_train_state(model, make_optimizer("sgd", 0.1))
            state.comms = init_comms_state(trainable_parameters(model), plan, config)
            issued.clear()
            step(state, batch)
            assert issued == [True] * 3
        issued.clear()
        models[0](batch["image"]).sum().backward()
        models[1](batch["image"]).sum().backward()  # not armed outside a step
    assert issued == []
    # the first model's hooks were removed when the step met the second
    assert all(not p._post_accumulate_grad_hooks for p in models[0].parameters())
    assert all(len(p._post_accumulate_grad_hooks) == 1 for p in models[1].parameters())
