"""The port's ``launch.elastic`` and ``MeshSpec.shrink_to`` against the JAX
package's (the counterparts of ``tests/test_elastic.py``'s shrink-to
survivors cases and ``tests/test_launch.py``'s restart-loop cases).

Exact, on the same inputs: ``MeshSpec.shrink_to``'s sizes and error
types, ``rederive_batch_split`` over a grid (its values, its
``fault/batch_resplit`` events and its errors).

The supervised 4 -> 2 shrink runs the port's way: the ranks are processes,
so each attempt of ``run_elastic`` starts a ``Distributor`` of
``ctx.world_size`` CPU workers over ``ctx.plan`` (ZeRO-1 over ``fsdp``).
``LoseRank((2, 3))`` fires in the workers at step 5; the launcher surfaces
their ``RankLostError`` and ``run_elastic`` registers ranks 2 and 3 before
the next probe.  Expected: worlds ``[4, 2]``, one ``fault/world_resized``,
a ``fault/reshard`` in the restarted workers, no quarantine, the restored
state bit-equal to the snapshot read back in the launching process, the
full step count, and a final loss within 1e-5 relative of the
uninterrupted 4-rank run.  The JAX imports stay inside the test functions:
the workers import this module.
"""

import hashlib
import itertools
import os

import numpy as np
import pytest
import torch

from tpuframe_torch.core.runtime import MeshSpec
from tpuframe_torch.fault import (
    ChaosPlan,
    LoseRank,
    RankLostError,
    RestartPolicy,
    WorldTooSmall,
    lost_ranks,
)
from tpuframe_torch.launch import (
    Distributor,
    ElasticContext,
    WorkerLostError,
    rederive_batch_split,
    run_elastic,
    simulated_survivor_probe,
)
from tpuframe_torch.parallel import ParallelPlan
from tpuframe_torch.track.telemetry import get_telemetry

LOSS_RTOL = 1e-5  # the shrunk run's final loss against the uninterrupted 4-rank run
_MARKS = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads in this test process: the suite runs several
    files at once, and spawned ranks share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mark(tele) -> str:
    token = f"elastic-test-{next(_MARKS)}"
    tele.event("test/mark", token=token)
    return token


def _since(tele, token: str, name: str) -> list[dict]:
    ev = tele.recent_events(10**6)
    idx = max(i for i, e in enumerate(ev)
              if e.get("name") == "test/mark" and e.get("token") == token)
    return [e for e in ev[idx + 1:] if e.get("name") == name]


SPECS = [dict(data=4), dict(data=2, model=2), dict(data=2, fsdp=2), dict(data=1, fsdp=4),
         dict(pipe=2, data=2), dict(data=8, model=2)]


@pytest.mark.parametrize("axes", SPECS, ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
def test_shrink_to_matches_jax(axes):
    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec

    port, jax_spec = MeshSpec(**axes), JaxMeshSpec(**axes)
    for axis in ("data", "fsdp"):
        for n in range(0, 18):
            got = want = None
            try:
                want = jax_spec.shrink_to(n, elastic_axis=axis).sizes()
            except Exception as e:  # noqa: BLE001 - the type is compared
                want = type(e)
            try:
                got = port.shrink_to(n, elastic_axis=axis).sizes()
            except Exception as e:  # noqa: BLE001
                got = type(e)
            assert got == want, (axes, axis, n)
    with pytest.raises(ValueError, match="fully-resolved"):
        MeshSpec(data=2, fsdp=-1).shrink_to(2)
    built = MeshSpec(**axes).build(int(np.prod(list(MeshSpec(**axes).sizes().values()))))
    assert MeshSpec.from_mesh(built).sizes() == built.shape


def test_rederive_batch_split_matches_jax():
    from tpuframe.launch import rederive_batch_split as jax_split
    from tpuframe.track.telemetry import get_telemetry as jax_telemetry

    port_tele, jax_tele = get_telemetry(), jax_telemetry()
    for gb, dp, ga, pc in itertools.product((1, 10, 64, 96, 256), (1, 2, 3, 4, 8, 16),
                                            (1, 2, 4), (1, 2, 4)):
        out = {}
        for side, fn, tele in (("port", rederive_batch_split, port_tele),
                               ("jax", jax_split, jax_tele)):
            token = _mark(tele)
            try:
                value = fn(gb, dp_size=dp, grad_accum=ga, process_count=pc)
            except ValueError as e:
                value = ("ValueError", str(e))
            events = [{k: v for k, v in e.items() if k in ("global_batch", "dp_size",
                                                           "from_grad_accum", "to_grad_accum")}
                      for e in _since(tele, token, "fault/batch_resplit")]
            out[side] = (value, events)
        assert out["port"] == out["jax"], (gb, dp, ga, pc)
    with pytest.raises(ValueError, match=">= 1"):
        rederive_batch_split(0, dp_size=1)


def test_probe_context_and_the_lost_ranks_a_worker_reports():
    """run_elastic in process: an attempt that fails with a worker's
    RankLostError (or the launcher's WorkerLostError) shrinks the next
    world; the ranks it registered leave the lost set on its way out."""
    plan = ParallelPlan(mesh=MeshSpec(data=4).build(4))
    probe = simulated_survivor_probe(4)
    assert probe() == 4
    worlds, plans = [], []
    errors = [RankLostError("peer gone", ranks=[3]), None]

    def lost_one(ctx: ElasticContext):
        worlds.append((ctx.world_size, ctx.resized, ctx.attempt))
        plans.append(ctx.plan)
        err = errors.pop(0)
        if err is not None:
            try:
                raise RuntimeError("worker failed") from err
            except RuntimeError as wrapped:
                raise RankLostError("root cause") from wrapped
        return "done"

    tele = get_telemetry()
    token = _mark(tele)
    assert run_elastic(lost_one, plan=plan, policy=RestartPolicy(backoff_base_s=0.0)) == "done"
    assert worlds == [(4, False, 1), (3, True, 2)]
    assert dict(plans[1].mesh.shape)["data"] == 3 and plans[0] is plan
    (resized,) = _since(tele, token, "fault/world_resized")
    assert (resized["from_world"], resized["to_world"]) == (4, 3)
    assert lost_ranks() == frozenset()

    def lost_worker(ctx):
        raise WorkerLostError(1, 20.0)

    with pytest.raises(WorldTooSmall):
        run_elastic(lost_worker, plan=ParallelPlan(mesh=MeshSpec(data=2).build(2)),
                    policy=RestartPolicy(backoff_base_s=0.0), min_world_size=2)
    assert lost_ranks() == frozenset()
    with pytest.raises(ValueError, match="only spans 4"):
        run_elastic(lambda ctx: None, plan=plan, capacity_probe=lambda: 5)
    with pytest.raises(ValueError, match="multiple of 2"):  # a TP group cannot shrink by one
        run_elastic(lambda ctx: None, plan=ParallelPlan(mesh=MeshSpec(data=2, model=2)
                                                        .build(4)), capacity_probe=lambda: 3)


# -- the supervised 4 -> 2 shrink on CPU workers --------------------------------


def _digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t, prefix=""):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif torch.is_tensor(v):
                h.update(f"{prefix}{k}".encode())
                flat = v.detach().cpu().contiguous().reshape(-1)
                h.update(flat.view(torch.uint8).numpy().tobytes())
    walk(tree)
    return h.hexdigest()


def _elastic_worker(plan, ckpt_dir: str, lose: bool):
    """A Distributor worker: the ZeRO-1 fit over ``plan``; with ``lose``,
    LoseRank((2, 3)) at step 5.  Rank 0 returns its numbers."""
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.core import initialize
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet18
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import Callback, Trainer

    torch.set_num_threads(2)  # four ranks share the host's cores
    rt = initialize(MeshSpec.from_mesh(plan.mesh))
    seen = {}

    class Rec(Callback):
        def on_fit_start(self, trainer):
            seen["step"] = trainer.state.step
            seen["digest"] = _digest(trainer.state.state_dict())  # every rank gathers

    torch.manual_seed(0)
    model = ResNet18(num_classes=4, num_filters=4, stem="cifar", device=rt.device, seed=0)
    loader = DataLoader(SyntheticImageDataset(n=64, image_size=8, num_classes=4, seed=0), 16,
                        shuffle=True, seed=3)
    tr = Trainer(model, tx=fused_adamw(1e-2), train_dataloader=loader, plan=plan,
                 max_duration="2ep", eval_interval=0, log_interval=0, health=False,
                 checkpointer=Checkpointer(ckpt_dir), checkpoint_interval_batches=2,
                 callbacks=[Rec()])
    reshards = get_telemetry().registry.counter("fault/reshards")
    with ChaosPlan([LoseRank((2, 3), 5)] if lose else []).active():
        res = tr.fit()
    return {"loss": res.metrics["train_loss"], "step": tr.state.step,
            "resume_step": seen["step"], "resume_digest": seen["digest"],
            "reshards": reshards.value, "world": rt.process_count}


def _reference_digest(plan, ckpt_dir: str) -> str:
    """The snapshot the restarted attempt resumes from, read back in this
    process (every tensor is saved whole)."""
    from tpuframe_torch.ckpt import Checkpointer, latest_step
    from tpuframe_torch.models import ResNet18
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import create_train_state

    intra = ckpt_dir + "_intra"
    src = intra if (latest_step(intra) or -1) > (latest_step(ckpt_dir) or -1) else ckpt_dir
    model = ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu", seed=9)
    template = create_train_state(model, fused_adamw(1e-2), seed=9)
    state, _ = Checkpointer(src).restore(template)
    return _digest(state.state_dict())


@pytest.mark.chaos
def test_supervised_shrink_resumes_bit_exact_and_matches_the_uninterrupted_loss(tmp_path):
    plan4 = ParallelPlan(mesh=MeshSpec(data=1, fsdp=4).build(4), zero_stage=1,
                         min_shard_elems=64)
    ckpt_dir = str(tmp_path / "ck")
    worlds, refs = [], []

    def train(ctx):
        worlds.append(ctx.world_size)
        if ctx.resized:
            refs.append(_reference_digest(ctx.plan, ckpt_dir))
        return Distributor(num_processes=ctx.world_size, simulate_devices=1,
                           timeout_s=240.0).run(_elastic_worker, ctx.plan, ckpt_dir,
                                                ctx.attempt == 1)

    tele = get_telemetry()
    token = _mark(tele)
    got = run_elastic(train, plan=plan4, elastic_axis="fsdp", checkpoint_dir=ckpt_dir,
                      policy=RestartPolicy(max_restarts=2, backoff_base_s=0.0),
                      min_world_size=2)
    assert worlds == [4, 2] and got["world"] == 2
    assert got["resume_step"] == 4 and got["step"] == 8  # the full 2 epochs of 4
    assert got["resume_digest"] == refs[0]  # bit-equal at the boundary
    assert got["reshards"] >= 1
    (resized,) = _since(tele, token, "fault/world_resized")
    assert (resized["from_world"], resized["to_world"]) == (4, 2)
    assert _since(tele, token, "fault/quarantine") == []
    assert lost_ranks() == frozenset()

    ref = Distributor(num_processes=4, simulate_devices=1, timeout_s=240.0).run(
        _elastic_worker, plan4, str(tmp_path / "ref"), False)
    assert ref["step"] == 8 and ref["reshards"] == 0
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL), (got["loss"], ref["loss"])
    assert os.path.isdir(ckpt_dir) and not os.path.isdir(os.path.join(ckpt_dir, "_quarantine"))
