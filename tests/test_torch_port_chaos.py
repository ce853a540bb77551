"""The port's ``fault.chaos`` against the JAX package's (the counterparts of
``tests/test_fault.py``'s chaos cases and ``tests/test_elastic.py``'s
``TestLoseRank``).

- ``ChaosPlan.scheduled(seed)`` draws the same schedule as JAX's, exactly,
  for seeds 0-31, with classes and with instances.
- Injectors fire once at their step, a raising injector leaves the later
  ones their budget, ``times`` counts visits, plans do not nest, a stall
  sleeps; ``NaNAt``'s poison window covers the same steps as JAX's and
  leaves the same bytes; a non-float batch or payload is refused with
  JAX's ``ValueError``.
- ``TornCheckpoint`` tears the port's commit marker, and auto-resume falls
  back to the newest committed step; through the Trainer under the
  supervisor, a torn snapshot is quarantined and the fit resumed from the
  committed step before it ends bit-equal to its uninterrupted run, its
  final loss within 1e-5 relative of the JAX Trainer's same torn run on
  the same weights (``models.interop``).
- ``LoseRank`` registers its ranks, raises ``RankLostError`` (which pickles
  with them), and the loss is plan-scoped.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

from tpuframe.fault import chaos as jax_chaos
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.fault import (
    ChaosError,
    ChaosPlan,
    FailureClass,
    KillWorker,
    LoseRank,
    NaNAt,
    PoisonRequest,
    RaiseAt,
    RankLostError,
    SpikeAt,
    StallAt,
    TornCheckpoint,
    chaos,
    classify_failure,
    lost_ranks,
)

SITES = ("ckpt/save", "loader", "serve/infer", "step")


def _schedule(plan):
    return [(type(i).__name__, i.site, i.step, i.times) for i in plan.injectors]


@pytest.mark.parametrize("seed", range(32))
def test_scheduled_draws_the_jax_schedule(seed):
    for kw in (dict(max_step=100, sites=SITES), dict(max_step=9, min_step=5, sites=("loader",)),
               dict(max_step=3, min_step=3, sites=("step",))):
        assert _schedule(ChaosPlan.scheduled(seed, **kw)) == _schedule(
            jax_chaos.ChaosPlan.scheduled(seed, **kw))
    mixed = lambda m: {"step": m.LoseRank(1), "ckpt/saved": m.TornCheckpoint,  # noqa: E731
                       "batch": m.NaNAt(times=3), "serve/infer": m.StallAt}
    got = ChaosPlan.scheduled(seed, max_step=50, sites=mixed(chaos))
    want = jax_chaos.ChaosPlan.scheduled(seed, max_step=50, sites=mixed(jax_chaos))
    assert _schedule(got) == _schedule(want)


def test_injector_fires_once_at_its_step():
    plan = ChaosPlan([RaiseAt("loader", step=3)])
    with plan.active():
        for step in range(3):
            chaos.maybe_fire("loader", step=step)
        chaos.maybe_fire("step", step=3)  # another site
        with pytest.raises(ChaosError):
            chaos.maybe_fire("loader", step=3)
        chaos.maybe_fire("loader", step=3)  # times=1: spent
    assert plan.fired_count() == 1
    chaos.maybe_fire("loader", step=3)  # no plan: a no-op


def test_plans_do_not_nest_and_a_stall_sleeps():
    with ChaosPlan([]).active():
        with pytest.raises(RuntimeError, match="already active"):
            with ChaosPlan([]).active():
                pass
    plan = ChaosPlan([StallAt("step", step=0, stall_s=0.05)])
    t0 = time.perf_counter()
    with plan.active(), chaos.site("step", step=0):
        pass
    assert time.perf_counter() - t0 >= 0.05 and plan.fired_count() == 1


def test_a_raising_injector_leaves_later_ones_their_budget_and_times_counts_visits():
    raiser, stall = RaiseAt("step", step=5), StallAt("step", step=5, stall_s=0.0)
    with ChaosPlan([raiser, stall]).active():
        with pytest.raises(ChaosError):
            chaos.maybe_fire("step", step=5)
        assert raiser.fired == 1 and stall.fired == 0
        chaos.maybe_fire("step", step=5)
    assert stall.fired == 1
    multi = StallAt("step", stall_s=0.0, times=3)
    with ChaosPlan([multi]).active():
        for step in range(4):
            chaos.maybe_fire("step", step=step)
    assert multi.fired == 3


def test_raise_at_takes_a_type_or_an_instance_and_fatal_types_classify_fatal():
    with ChaosPlan([RaiseAt("step", exc=ValueError), RaiseAt("loader", exc=KeyError("k"))]) \
            .active():
        with pytest.raises(ValueError, match="chaos: injected ValueError at step") as e:
            chaos.maybe_fire("step", step=0)
        assert classify_failure(e.value) is FailureClass.FATAL
        with pytest.raises(KeyError):
            chaos.maybe_fire("loader", step=0)


@pytest.mark.parametrize("kind,kw", [("NaNAt", {}), ("SpikeAt", {"scale": 100.0})])
def test_batch_poison_window_and_bytes_match_jax(kind, kw):
    """An explicit step with times=3 poisons the three batches [4, 7) on
    both sides, the same bytes."""
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(10)]
    out = {}
    for name, mod in (("port", chaos), ("jax", jax_chaos)):
        imgs = [b.copy() for b in batches]
        fired = []
        plan = mod.ChaosPlan([getattr(mod, kind)(step=4, times=3, **kw)])
        with plan.active():
            for step, x in enumerate(imgs):
                before = plan.fired_count()
                mod.maybe_fire("batch", step=step, images=x)
                if plan.fired_count() > before:
                    fired.append(step)
        out[name] = (fired, b"".join(x.tobytes() for x in imgs))
    assert out["port"] == out["jax"] and out["port"][0] == [4, 5, 6]


@pytest.mark.parametrize("inj", [NaNAt(step=0), SpikeAt(step=0)])
def test_batch_poison_refuses_a_uint8_batch_as_jax_does(inj):
    x = np.zeros((2, 4, 4, 3), np.uint8)
    with ChaosPlan([inj]).active():
        with pytest.raises(ValueError, match="cannot poison a uint8 batch") as got:
            chaos.maybe_fire("batch", step=0, images=x)
    with jax_chaos.ChaosPlan([getattr(jax_chaos, type(inj).__name__)(step=0)]).active():
        with pytest.raises(ValueError) as want:
            jax_chaos.maybe_fire("batch", step=0, images=x)
    assert str(got.value) == str(want.value)
    assert classify_failure(got.value) is FailureClass.FATAL
    with ChaosPlan([NaNAt(site="step")]).active():
        with pytest.raises(ValueError, match="carries no host image batch"):
            chaos.maybe_fire("step", step=0)


def test_poison_request_writes_nan_into_a_float_payload_only():
    x = np.ones((3, 2), np.float32)[:, ::2]  # not contiguous: poisoned in place all the same
    with ChaosPlan([PoisonRequest(step=1)]).active():
        chaos.maybe_fire("serve/submit", 0, payload=x)
        assert np.isfinite(x).all()
        chaos.maybe_fire("serve/submit", 1, payload=x)
    assert np.isnan(x.flat[0]) and np.isfinite(x.flat[1:]).all()
    with ChaosPlan([PoisonRequest()]).active():
        with pytest.raises(ValueError, match="cannot poison a uint8 payload"):
            chaos.maybe_fire("serve/submit", 0, payload=np.zeros(3, np.uint8))


def test_torn_checkpoint_tears_the_port_marker_and_resume_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    state = {"w": torch.arange(4, dtype=torch.float32)}
    plan = ChaosPlan([TornCheckpoint(step=3)])
    with plan.active():
        ck = Checkpointer(d)
        for s in (1, 2, 3):
            ck.save({"w": state["w"] * s}, step=s)
        assert plan.fired_count() == 1
        assert ck.latest_step() == 2 and os.path.isdir(os.path.join(d, "3"))
        restored, _ = ck.maybe_restore({"w": torch.zeros(4)})
    assert torch.equal(restored["w"], state["w"] * 2)
    # the JAX package's readers agree that step 3 is torn
    from tpuframe.ckpt.meta import is_committed, latest_step

    assert latest_step(d) == 2 and not is_committed(os.path.join(d, "3"))


def test_torn_checkpoint_refuses_an_async_save(tmp_path, monkeypatch):
    """The background commit is held until the site has fired, as a real
    write of any size is, so the drill finds no marker and raises."""
    import threading

    gate, commit = threading.Event(), Checkpointer._commit

    def held_commit(self, *args):
        gate.wait(30)
        return commit(self, *args)

    monkeypatch.setattr(Checkpointer, "_commit", held_commit)
    ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
    with ChaosPlan([TornCheckpoint(step=1)]).active():
        with pytest.raises(RuntimeError, match="async_save=True"):
            ck.save({"w": torch.zeros(2)}, step=1)
    gate.set()
    ck.wait()
    assert ck.latest_step() == 1  # committed after the drill, untorn


class TestLoseRank:
    def test_fires_at_step_registers_and_raises(self):
        plan = ChaosPlan([LoseRank((2, 3), 5)])
        with plan.active():
            chaos.maybe_fire("step", step=4)
            assert lost_ranks() == frozenset()
            with pytest.raises(RankLostError, match=r"rank\(s\) \[2, 3\]") as e:
                chaos.maybe_fire("step", step=5)
            assert lost_ranks() == frozenset({2, 3}) and e.value.ranks == (2, 3)
            chaos.maybe_fire("step", step=5)  # spent
            assert plan.fired_count() == 1
        assert lost_ranks() == frozenset()  # plan-scoped

    def test_seeded_schedule_determinism(self):
        a = ChaosPlan.scheduled(11, max_step=50, sites={"step": LoseRank(1)})
        b = jax_chaos.ChaosPlan.scheduled(11, max_step=50, sites={"step": jax_chaos.LoseRank(1)})
        assert isinstance(a.injectors[0], LoseRank)
        assert a.injectors[0].step == b.injectors[0].step
        assert "ranks=[1]" in a.injectors[0].describe()

    def test_classified_retryable_and_pickled_with_its_ranks(self):
        e = RankLostError("gone", ranks=[1])
        assert classify_failure(e) is FailureClass.RETRYABLE
        back = pickle.loads(pickle.dumps(e))
        assert type(back) is RankLostError and back.ranks == (1,) and str(back) == "gone"


def test_kill_worker_fires_its_signal(monkeypatch):
    sent = []
    monkeypatch.setattr(chaos.os, "kill", lambda pid, sig: sent.append((pid, sig)))
    with ChaosPlan([KillWorker("step", step=0, sig=15)]).active():
        chaos.maybe_fire("step", step=0)
    assert sent == [(os.getpid(), 15)]


def test_every_firing_is_counted_and_logged():
    from tpuframe_torch.track.telemetry import get_telemetry

    tele = get_telemetry()
    before = tele.registry.counter("fault/chaos_injections").value
    with ChaosPlan([StallAt("loader", step=2, stall_s=0.0)]).active():
        chaos.maybe_fire("loader", step=2)
    assert tele.registry.counter("fault/chaos_injections").value == before + 1
    ev = [e for e in tele.recent_events(50) if e.get("name") == "fault/chaos_injected"][-1]
    assert (ev["site"], ev["step"], ev["injector"]) == ("loader", 2, "StallAt")


MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LOSS_RTOL = 1e-5  # the port's torn-and-resumed fit against JAX's, f32 on the CPU


def _torn_story(side: str, directory: str, variables=None):
    """Three epochs of one batch, a checkpoint at each epoch's end: the one
    of step 2 is torn, the next step raises; under the supervisor the torn
    step is quarantined and the fit resumes from step 1.  Returns (trainer,
    result, supervisor, resumed steps, variables)."""
    if side == "jax":
        import jax

        from tpuframe.ckpt import Checkpointer as Ck
        from tpuframe.data import DataLoader as Dl
        from tpuframe.data.datasets import SyntheticImageDataset as Ds
        from tpuframe.fault import RestartPolicy as Policy
        from tpuframe.fault import Supervisor as Sup
        from tpuframe.models import ResNet18 as Net
        from tpuframe.train import Callback as Cb
        from tpuframe.train.trainer import Trainer as Tr
        mod, extra = jax_chaos, dict(precompile=False)
        loader_kw = dict(process_index=0, process_count=1)
    else:
        from tpuframe_torch.ckpt import Checkpointer as Ck
        from tpuframe_torch.data import DataLoader as Dl
        from tpuframe_torch.data import SyntheticImageDataset as Ds
        from tpuframe_torch.fault import RestartPolicy as Policy
        from tpuframe_torch.fault import Supervisor as Sup
        from tpuframe_torch.models import ResNet18 as Net
        from tpuframe_torch.models import from_jax_variables
        from tpuframe_torch.train import Callback as Cb
        from tpuframe_torch.train import Trainer as Tr
        mod, extra, loader_kw = chaos, {}, {}
    resumed, box = [], {"variables": variables}

    class Probe(Cb):
        def on_fit_start(self, trainer):
            resumed.append(int(trainer.init_state().step))

    def attempt():
        if side == "jax":
            model = Net(num_classes=10, num_filters=4, stem="cifar")
        else:
            model = Net(num_classes=10, num_filters=4, stem="cifar", device="cpu")
            model.load_state_dict(from_jax_variables(box["variables"]))
        tr = Tr(model, train_dataloader=Dl(Ds(n=8, image_size=16, num_classes=10, seed=1), 8,
                                           shuffle=True, seed=2, transfer_dtype="uint8",
                                           **loader_kw),
                optimizer="sgd", lr=0.05, max_duration="3ba", normalize=(MEAN, STD), seed=0,
                eval_interval=0, log_interval=0, checkpointer=Ck(directory),
                callbacks=[Probe()], **extra)
        if side == "jax" and box["variables"] is None:
            st = tr.init_state()
            box["variables"] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                            {"params": st.params,
                                             "batch_stats": st.batch_stats})
        res = tr.fit()
        if side == "jax":
            tr.checkpointer.wait()
        return tr, res

    sup = Sup(Policy(max_restarts=1, backoff_base_s=0.0), checkpoint_dir=directory)
    with mod.ChaosPlan([mod.TornCheckpoint(step=2), mod.RaiseAt("step", step=2)]).active():
        tr, res = sup.run(attempt)
    return tr, res, sup, resumed, box["variables"]


@pytest.mark.chaos
def test_torn_snapshot_is_quarantined_and_the_fit_resumes_bit_equal(tmp_path):
    """The torn checkpoint of step 2 is quarantined before the restart, the
    fit resumes from the committed step 1 and ends bit-equal to the
    uninterrupted port fit, its final loss within LOSS_RTOL of the JAX
    Trainer's same torn run (three steps: the two frameworks' float32
    sums drift apart by about 1e-5 relative within five)."""
    from tpuframe_torch.models import ResNet18, from_jax_variables
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import Trainer

    jtr, want, jsup, jresumed, variables = _torn_story("jax", str(tmp_path / "jax"))
    tele = get_telemetry()
    q0 = tele.registry.counter("fault/quarantined_steps").value
    tr, got, sup, resumed, _ = _torn_story("port", str(tmp_path / "port"), variables)
    assert sup.retries == jsup.retries == 1 and resumed == jresumed == [0, 1]
    assert tele.registry.counter("fault/quarantined_steps").value == q0 + 1
    assert os.listdir(tmp_path / "port" / "_quarantine") == ["2"]
    assert tr.state.step == 3 and got.error is None

    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset

    straight = Trainer(model, train_dataloader=DataLoader(
        SyntheticImageDataset(n=8, image_size=16, num_classes=10, seed=1), 8, shuffle=True,
        seed=2, transfer_dtype="uint8"), optimizer="sgd", lr=0.05, max_duration="3ba",
        normalize=(MEAN, STD), seed=0, eval_interval=0, log_interval=0)
    straight.fit()
    for (name, a), b in zip(straight.model.state_dict().items(),
                            tr.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.state.optimizer.state.values(),
                    tr.state.optimizer.state.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    g, w = got.history[-1]["train_loss"], want.history[-1]["train_loss"]
    assert g == pytest.approx(w, rel=LOSS_RTOL), (g, w)
