"""``tpuframe_torch.track.profiler`` against ``tpuframe.track.profiler``.

- ``ProfilerCallback.from_env`` over a table of ``TPUFRAME_PROFILE_*``
  values arms (or not) the callback JAX's arms.
- The callback's schedule, one-shot and on a cadence with rotation, with
  both profilers stubbed (JAX's ``start_trace``/``stop_trace``, the port's
  ``torch.profiler`` session): the same windows, capture dirs, rotation,
  artifacts and ``profile/capture`` events (the port's event adds
  ``device_events``).
- A real ``torch.profiler`` capture on the CPU: ``trace_step_window``
  writes torch.profiler's layout, a raising region still closes the
  session, and an env-armed Trainer fit emits one ``profile/capture``
  event that says it saw 0 device events (the CPU has no card), which
  no report passes off as an empty window.
- ``StepTimer``'s summary over the same samples is JAX's.
"""

import os
import time

import pytest

from tpuframe.track import profiler as jax_profiler
from tpuframe.track import telemetry as jax_telemetry
from tpuframe_torch.track import device_time, profiler, telemetry


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    for var in device_time.PROFILE_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    for t in (telemetry, jax_telemetry):
        t.reset()
    yield
    for t in (telemetry, jax_telemetry):
        t.reset()


@pytest.mark.parametrize("env", [
    {}, {"TPUFRAME_PROFILE_STEPS": "0"}, {"TPUFRAME_PROFILE_STEPS": "4"},
    {"TPUFRAME_PROFILE_STEPS": "4", "TPUFRAME_PROFILE_EVERY": "50",
     "TPUFRAME_PROFILE_KEEP": "2", "TPUFRAME_PROFILE_DIR": "/tmp/prof"},
    {"TPUFRAME_PROFILE_STEPS": "x", "TPUFRAME_PROFILE_EVERY": "5"},
    {"TPUFRAME_PROFILE_STEPS": "3", "TPUFRAME_PROFILE_KEEP": "0"},
])
def test_from_env_arms_what_jax_arms(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, theirs = profiler.ProfilerCallback.from_env(), jax_profiler.ProfilerCallback.from_env()
    assert (mine is None) == (theirs is None)
    if mine is not None:
        attrs = ("logdir", "skip_steps", "num_steps", "every_steps", "keep", "rank0_only",
                 "cadence")
        assert {a: getattr(mine, a) for a in attrs} == {a: getattr(theirs, a) for a in attrs}


class _Trainer:
    """What the callback reads of a Trainer."""

    def __init__(self, loggers=()):
        self.batches_seen = 0
        self.is_main = True
        self.state = None
        self.loggers = list(loggers)


class _Logger:
    def __init__(self):
        self.artifacts = []

    def log_artifact(self, path, artifact_path=None):
        self.artifacts.append((os.path.basename(path), artifact_path))
        return f"{artifact_path}/{os.path.basename(path)}"


def _stub_engines(monkeypatch, calls):
    import jax

    class Session:
        def stop(self):
            calls.append("port stop")

    monkeypatch.setattr(profiler, "_start", lambda d: calls.append("port start") or Session())
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: calls.append("jax start"))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls.append("jax stop"))


def _drive(cb, steps: int, logger) -> None:
    tr = _Trainer([logger])
    for _ in range(steps):
        cb.on_step_start(tr)
        tr.batches_seen += 1
        cb.on_step_end(tr)
    cb.on_fit_end(tr)


def _captures(tele, base) -> list[dict]:
    return [{k: v for k, v in e.items() if k in ("steps", "partial", "bytes")}
            | {"dir": os.path.relpath(str(e["dir"]), base)}
            for e in tele.recent_events(200) if e["name"] == "profile/capture"]


@pytest.mark.parametrize("kw,steps", [
    (dict(skip_steps=2, num_steps=3), 10),
    (dict(skip_steps=2, num_steps=3), 4),  # the fit ends inside the window
    (dict(skip_steps=0, num_steps=2, every_steps=5, keep=2), 23),
    (dict(skip_steps=1, num_steps=4, every_steps=3, keep=1), 14),
])
def test_the_schedule_dirs_rotation_and_events_are_jaxs(kw, steps, tmp_path, monkeypatch):
    calls: list = []
    _stub_engines(monkeypatch, calls)
    runs = {}
    for name, mod in (("port", profiler), ("jax", jax_profiler)):
        logdir = tmp_path / name
        cb = mod.ProfilerCallback(logdir=str(logdir), **kw)
        logger = _Logger()
        _drive(cb, steps, logger)
        runs[name] = (cb, logger, sorted(os.listdir(logdir)) if logdir.exists() else [])
    (mine, my_log, my_dirs), (theirs, their_log, their_dirs) = runs["port"], runs["jax"]
    assert calls.count("port start") == calls.count("jax start") == calls.count("port stop")
    assert [{k: c[k] for k in ("steps", "partial")} for c in mine.captures] == [
        {k: c[k] for k in ("steps", "partial")} for c in theirs.captures]
    assert [os.path.relpath(c["dir"], tmp_path / "port") for c in mine.captures] == [
        os.path.relpath(c["dir"], tmp_path / "jax") for c in theirs.captures]
    assert my_dirs == their_dirs and mine.partial == theirs.partial
    assert [a for _, a in my_log.artifacts] == [a for _, a in their_log.artifacts]
    assert _captures(telemetry.get_telemetry(), tmp_path / "port") == _captures(
        jax_telemetry.get_telemetry(), tmp_path / "jax")
    events = [e for e in telemetry.get_telemetry().recent_events(200)
              if e["name"] == "profile/capture"]
    assert all(e["device_events"] == 0 for e in events)
    assert telemetry.get_telemetry().registry.counter("profile/captures").value == len(events)


def test_a_real_capture_on_the_cpu(tmp_path):
    import torch

    x = torch.randn(64, 64)
    logdir = profiler.trace_step_window(lambda: torch.tanh(x @ x), 3, str(tmp_path / "t"))
    files = device_time.find_trace_files(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    trace = device_time.load_trace(files[0])
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])
    # the CPU has no card: no device event, so no report
    assert device_time.count_device_events(logdir) == 0
    assert device_time.device_time_report(logdir) is None
    with pytest.raises(RuntimeError, match="boom"):
        with profiler.trace(str(tmp_path / "u")):
            raise RuntimeError("boom")
    with profiler.trace(str(tmp_path / "v")):  # the raising session was stopped
        torch.tanh(x)
    assert device_time.find_trace_files(str(tmp_path / "v"))


def test_an_env_armed_fit_says_how_many_device_events_it_saw(tmp_path, monkeypatch):
    import torch

    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import MnistNet
    from tpuframe_torch.train import Trainer

    monkeypatch.setenv("TPUFRAME_PROFILE_STEPS", "1")
    monkeypatch.setenv("TPUFRAME_PROFILE_DIR", str(tmp_path / "prof"))
    model = MnistNet(device="cpu")
    tr = Trainer(model, train_dataloader=DataLoader(
        SyntheticImageDataset(n=32, image_size=28, channels=1), 8), max_duration="4ba")
    (cb,) = [c for c in tr.callbacks if isinstance(c, profiler.ProfilerCallback)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr.fit()
    finally:
        torch.set_num_threads(threads)
    (ev,) = [e for e in telemetry.get_telemetry().recent_events(500)
             if e["name"] == "profile/capture"]
    assert ev["steps"] == 1 and ev["partial"] is False and ev["device_events"] == 0
    assert ev["dir"] == str(tmp_path / "prof") and ev["bytes"] > 0
    assert cb.captures[0]["device_events"] == 0 and cb.trace_dir == str(tmp_path / "prof")
    assert device_time.device_time_report(ev["dir"]) is None


@pytest.mark.parametrize("n", [1, 7, 100])
def test_step_timer_summary_is_jaxs(n, monkeypatch):
    samples = [0.01 * ((i * 7919) % 13 + 1) for i in range(n)]
    timers = (profiler.StepTimer(max_samples=64), jax_profiler.StepTimer(max_samples=64))
    for t in timers:
        for s in samples:
            clock = iter([100.0, 100.0 + s])
            monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
            t.on_step_start(None)
            t.on_step_end(None)
    monkeypatch.undo()
    assert timers[0].summary() == timers[1].summary()
