"""``tpuframe_torch.track.analyze`` (and ``python -m tpuframe_torch.track``)
against ``tpuframe.track.analyze``.

- One telemetry dir written by a port CPU fit, and JAX's four-rank golden
  fleet (``tests/fixtures/analyze_fleet/``), through both packages'
  ``skew_report``, ``build_trace`` and ``format_report``: equal but for
  the trace's tool name.  The CLI's exit codes are JAX's (0, the
  regression exit 3 against a faster baseline, 2 for a missing dir and an
  unknown command).
- ``StragglerMonitor`` fed the same step times, in self mode and in
  fleet mode: the same detections, ``train/straggler`` events and
  ``train/skew_ratio`` gauges.  The Trainer's ``straggler_sync_steps`` /
  ``straggler_factor`` reach it, and a planted slowdown emits JAX's event.
- The fleet gather's ladder: a gather past ``TPUFRAME_FLEET_TIMEOUT_S``
  emits JAX's ``fault/peer_lost`` event and degrades every later gather
  to local; one process, or no group, is the self-baseline.
- Two gloo ranks, rank 1 planted slow: the real ``all_gather_into_tensor``
  gather, and rank 0 alone emits the fleet's event naming rank 1.

The module imports no JAX at its top: the ranks import it.
"""

import json
import os

import pytest

from torch_ranks import run_ranks
from tpuframe_torch.track import analyze, telemetry

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "analyze_fleet")


@pytest.fixture()
def jax_side():
    from tpuframe.track import analyze as jax_analyze
    from tpuframe.track import telemetry as jax_telemetry

    telemetry.reset()
    jax_telemetry.reset()
    yield jax_analyze, jax_telemetry
    telemetry.reset()
    jax_telemetry.reset()
    analyze.reset_fleet_degraded()


class _Clock:
    """The monitor's clock: each step takes 0.1 s, from step ``after`` on
    ``slow`` s (advanced by the Trainer's ``on_step_end``), so the planted
    slowdown does not hang on the host's load."""

    def __init__(self, after: int, slow: float):
        self.t, self.after, self.slow = 1000.0, after, slow

    def monotonic(self) -> float:
        return self.t

    def __getattr__(self, hook):
        if not hook.startswith("on_"):
            raise AttributeError(hook)
        return lambda trainer, *a: None

    def on_step_end(self, trainer):
        self.t += self.slow if trainer.batches_seen >= self.after else 0.1


@pytest.fixture(scope="module")
def port_fit_dir(tmp_path_factory):
    """A telemetry dir of a port CPU fit: 12 steps of a small ResNet with a
    slowdown planted from step 8 on the monitor's clock, the straggler
    monitor at cadence 2."""
    import torch

    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet18
    from tpuframe_torch.train import Trainer

    d = tmp_path_factory.mktemp("tele")
    clock, real_time, threads = _Clock(8, 0.4), analyze.time, torch.get_num_threads()
    telemetry.configure(jsonl_dir=str(d), rank=0)
    analyze.time = clock
    torch.set_num_threads(1)
    try:
        model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
        tr = Trainer(model, train_dataloader=DataLoader(SyntheticImageDataset(n=96, image_size=8),
                                                        8),
                     max_duration="12ba", straggler_sync_steps=2, straggler_factor=1.5,
                     callbacks=[clock])
        tr.fit()
        gauge = telemetry.get_telemetry().registry.gauge("train/skew_ratio").value
    finally:
        analyze.time = real_time
        torch.set_num_threads(threads)
        telemetry.reset()
    return str(d), gauge


def _masked_trace(trace: dict) -> dict:
    return {**trace, "otherData": {**trace["otherData"], "tool": "<tool>"}}


@pytest.mark.parametrize("which", ["port fit", "golden fleet"])
def test_reports_and_traces_are_jaxs(which, port_fit_dir, jax_side):
    jax_analyze, _ = jax_side
    d = port_fit_dir[0] if which == "port fit" else FIXTURE
    mine, theirs = analyze.load_dir(d), jax_analyze.load_dir(d)
    for kw in ({}, {"straggler_factor": 1.2, "warmup_steps": 0}):
        rep, want = analyze.skew_report(mine, **kw), jax_analyze.skew_report(theirs, **kw)
        assert rep == want
        assert analyze.format_report(rep) == jax_analyze.format_report(want)
    got_trace = analyze.build_trace(mine)
    assert got_trace["otherData"]["tool"] == "tpuframe_torch.track.analyze"
    assert _masked_trace(got_trace) == _masked_trace(jax_analyze.build_trace(theirs))


def test_the_fit_emitted_jaxs_straggler_events(port_fit_dir, jax_side):
    jax_analyze, jax_telemetry = jax_side
    d, gauge = port_fit_dir
    events = [e for e in analyze.load_dir(d)[0].events if e.get("name") == "train/straggler"]
    assert events and all(e["mode"] == "self" and e["factor"] == 1.5 for e in events)
    # the keys JAX's monitor puts on the event
    tele = jax_telemetry.configure()
    mon = jax_analyze.StragglerMonitor(factor=1.5, sync_steps=1, min_steps=1, skip_first=0,
                                       gather=lambda v: [v], rank=0, telemetry=tele)
    for s in (0.1, 0.1, 0.1, 0.9):
        mon.observe(step_s=s)
    (want,) = [e for e in tele.recent_events(50) if e["name"] == "train/straggler"]
    assert set(events[0]) == set(want)
    assert gauge > 1.5


def _cli(main, args) -> int:
    try:
        return main(args)
    except SystemExit as e:  # argparse's own exits
        return e.code


def test_the_cli_exit_codes_are_jaxs(port_fit_dir, jax_side, tmp_path, capsys):
    from tpuframe.track.__main__ import main as jax_main
    from tpuframe_torch.track.__main__ import main as port_main

    d = port_fit_dir[0]
    fast = tmp_path / "fast"
    fast.mkdir()
    (fast / "fast.json").write_text(json.dumps({"step_time": {"p50": 1e-4, "p95": 2e-4}}))
    slow = tmp_path / "slow.json"
    slow.write_text(json.dumps({"step_time": {"p50": 100.0, "p95": 200.0}}))
    cases = [["analyze", d], ["analyze", d, "--report", "--baseline", str(fast)],
             ["analyze", d, "--json", "--baseline", str(slow)], ["analyze", str(tmp_path / "no")],
             ["analyze", FIXTURE, "--trace", str(tmp_path / "t.json")], ["bogus"], ["--help"],
             []]
    got = [_cli(port_main, c) for c in cases]
    want = [_cli(jax_main, c) for c in cases]
    assert got == want == [0, 3, 0, 2, 0, 2, 0, 2]
    capsys.readouterr()


def _feed(mon, times):
    return [mon.observe(step_s=s) for s in times]


STEP_TIMES = {
    "steady": [0.1] * 24,
    "going slow": [0.1] * 12 + [0.35] * 12,
    "one spike": [0.1] * 10 + [2.0] + [0.1] * 13,
    "jitter": [0.1 + 0.02 * ((i * 7) % 5) for i in range(30)],
}


@pytest.mark.parametrize("case", sorted(STEP_TIMES))
@pytest.mark.parametrize("mode", ["self", "fleet rank 0", "fleet rank 1"])
def test_the_straggler_monitor_is_jaxs_on_the_same_step_times(case, mode, jax_side):
    jax_analyze, jax_telemetry = jax_side
    rank = 1 if mode.endswith("rank 1") else 0

    def gather(v):
        return [v] if mode == "self" else [0.1, v, 0.1]

    outs, teles = [], []
    for mod, tmod in ((analyze, telemetry), (jax_analyze, jax_telemetry)):
        tele = tmod.configure(rank=rank)
        mon = mod.StragglerMonitor(factor=1.8, sync_steps=4, min_steps=8, gather=gather,
                                   rank=rank, telemetry=tele)
        outs.append(_feed(mon, STEP_TIMES[case]))
        teles.append(tele)
    assert outs[0] == outs[1]
    ev = [[{k: v for k, v in e.items() if k not in ("ts", "mono", "pid", "thread")}
           for e in t.recent_events(200) if e["name"] == "train/straggler"] for t in teles]
    assert ev[0] == ev[1]
    names = ("train/skew_ratio", "train/step_ewma_s")
    assert ({n: teles[0].registry.gauge(n).value for n in names}
            == {n: teles[1].registry.gauge(n).value for n in names})


def test_the_gather_ladder_is_jaxs(jax_side, monkeypatch):
    import threading

    import torch.distributed as dist

    jax_analyze, jax_telemetry = jax_side
    # one process, or no group: the self-baseline, no gather
    assert analyze.fleet_allgather(0.5) == [0.5]
    calls, hang = [], threading.Event()

    def stuck(v, device=None):
        calls.append(v)
        hang.wait(5)
        return [v, v]

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    for mod in (analyze, jax_analyze):
        monkeypatch.setattr(mod, "_gather_values", stuck)
    monkeypatch.setenv("TPUFRAME_FLEET_TIMEOUT_S", "0.2")
    try:
        assert analyze.fleet_allgather(0.5) == [0.5] and analyze.fleet_degraded()
        assert analyze.fleet_allgather(0.7) == [0.7] and len(calls) == 1  # sticky: no new gather
        assert jax_analyze._bounded_gather(0.5) == [0.5]
    finally:
        hang.set()
        jax_analyze.reset_fleet_degraded()
    mine, theirs = ([{k: e[k] for k in ("name", "timeout_s", "error", "degraded_to")}
                     for e in t.get_telemetry().recent_events(20) if e["name"] == "fault/peer_lost"]
                    for t in (telemetry, jax_telemetry))
    assert mine == theirs and len(mine) == 1
    assert telemetry.get_telemetry().registry.counter("fault/peer_losses").value == 1
    analyze.reset_fleet_degraded()
    assert not analyze.fleet_degraded()


def test_the_nccl_gather_runs_on_the_callers_card(monkeypatch):
    """CUDA's current device is a thread's own and a new thread starts on
    card 0: the bounded gather's worker must put its tensors on the card
    of the rank that called it (here card 1), not on card 0."""
    import threading

    import torch
    import torch.distributed as dist

    local = threading.local()
    local.card = 1  # the caller's thread, after initialize()'s set_device
    seen = []

    def make(real):
        def fake(*a, device=None, **kw):
            seen.append((threading.current_thread().name, torch.device(device),
                         getattr(local, "card", 0)))
            return real(*a, **kw)
        return fake

    def gather(out, mine):
        out.fill_(float(mine[0]))

    monkeypatch.setattr(torch.cuda, "current_device", lambda: getattr(local, "card", 0))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: setattr(local, "card", torch.device(d).index))
    monkeypatch.setattr(torch, "tensor", make(torch.tensor))
    monkeypatch.setattr(torch, "empty", make(torch.empty))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "all_gather_into_tensor", gather)
    monkeypatch.setenv("TPUFRAME_FLEET_TIMEOUT_S", "5")
    try:
        assert analyze.fleet_allgather(0.25) == [0.25, 0.25]
        assert not analyze.fleet_degraded()
    finally:
        analyze.reset_fleet_degraded()
    assert seen == [("tpuframe-fleet-gather", torch.device("cuda", 1), 1)] * 2


def _slow_rank(rank, world):
    """Rank 1 steps 3x slower than rank 0 (its EWMA 1.5x the median of two);
    the monitor gathers over gloo."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.track import analyze as A
    from tpuframe_torch.track import telemetry as T

    initialize(device="cpu")
    tele = T.configure(rank=rank)
    mon = A.StragglerMonitor(factor=1.4, sync_steps=4, min_steps=4, skip_first=0)
    dets = [mon.observe(step_s=0.3 if rank == 1 else 0.1) for _ in range(8)]
    gathered = A.fleet_allgather(float(rank))
    return {"dets": [d for d in dets if d], "gathered": gathered,
            "events": [e for e in tele.recent_events(50) if e["name"] == "train/straggler"],
            "ratio": tele.registry.gauge("train/skew_ratio").value}


def test_two_gloo_ranks_name_the_planted_slow_rank(tmp_path):
    r0, r1 = run_ranks(_slow_rank, 2, tmp_path, timeout=120)
    assert r0["gathered"] == r1["gathered"] == [0.0, 1.0]
    for r in (r0, r1):
        assert [(d["rank"], d["mode"], d["step"]) for d in r["dets"]] == [
            (1, "fleet", 4), (1, "fleet", 8)]
        assert r["ratio"] == pytest.approx(0.3 / 0.2)  # worst over the median of two
    assert len(r0["events"]) == 2 and not r1["events"]  # rank 0 speaks for the fleet
    assert r0["events"][0]["ewma_s"] == pytest.approx(0.3)
