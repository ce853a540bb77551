"""The TensorBoard and system-metrics loggers and the telemetry bridge
against the JAX package's.

- ``TensorBoardLogger``: the same calls write the same event file, byte
  for byte, under the same file name, once wall time and host name are
  pinned (the only inputs that differ between two runs); the
  ``tensorboard`` package's own reader reads the records back;
  ``from_deepspeed_config`` follows the same config block.
- ``publish_to_loggers`` and ``MetricsExportCallback``: on registries
  holding the same counters, gauges and histograms, the same calls on a
  recording logger (and through a trainer's ``_log_metrics``).
- ``SystemMetricsMonitor``: on the CPU both packages' ``device_memory_stats``
  are empty and a sample has the same keys, the same registry gauges and
  the two watermark gauges; ``TPUFRAME_MEMORY_SAMPLE_S`` and
  ``TPUFRAME_MEMORY_LIVE`` read as JAX's memory plane reads them.
- ``MLflowLogger(system_metrics=True)`` starts the monitor with the run and
  writes its metrics into the run, as JAX's does.

Tolerance: exact (bytes, keys and the values handed to the loggers).
"""

import socket
import time
from pathlib import Path

import pytest

from tpuframe.track import memory as jax_memory
from tpuframe.track import system_metrics as jax_system_metrics
from tpuframe.track import telemetry as jax_telemetry
from tpuframe.track import tensorboard as jax_tensorboard
from tpuframe.track.mlflow_store import MLflowLogger as JaxMLflowLogger
from tpuframe_torch.track import (
    MLflowLogger,
    MetricsExportCallback,
    SystemMetricsMonitor,
    TensorBoardLogger,
    publish_to_loggers,
    system_metrics,
    telemetry,
    tensorboard,
)


def _drive(tb) -> None:
    tb.log_params({"lr": 0.1, "name": "resnet", "epochs": 3, "flag": True})
    for step in (1, 2, 300, 70_000):
        tb.log_metrics({"loss": 1.0 / step, "acc": step % 7 / 7, "note": "x", "ok": False,
                        "count": step}, step=step)
    tb.log_metrics({}, step=5)  # nothing numeric: no record
    tb.log_metrics({"neg_step": -1.5}, step=-3)
    tb.flush()
    tb.close()


def test_the_event_file_is_jaxs_up_to_wall_time_and_host(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host-a")
    mine = TensorBoardLogger(str(tmp_path / "port"), job_name="run")
    theirs = jax_tensorboard.TensorBoardLogger(str(tmp_path / "jax"), job_name="run")
    for tb in (mine, theirs):
        _drive(tb)
    assert Path(mine.path).name == Path(theirs.path).name
    assert Path(mine.path).name.startswith("events.out.tfevents.1700000000.host-a.")
    assert Path(mine.path).read_bytes() == Path(theirs.path).read_bytes()


def test_tensorboards_reader_reads_the_records_back(tmp_path):
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    tb = TensorBoardLogger(str(tmp_path))
    _drive(tb)
    events = list(EventFileLoader(tb.path).Load())
    assert events[0].file_version == "brain.Event:2"
    scalars = [(e.step, v.tag, v.simple_value if v.HasField("simple_value")
                else float(v.tensor.float_val[0]))
               for e in events[1:] for v in e.summary.value]
    assert (0, "params/lr", pytest.approx(0.1)) in scalars
    assert (0, "params/epochs", 3.0) in scalars
    assert not any(tag in ("params/name", "params/flag", "note", "ok") for _, tag, _ in scalars)
    assert [(s, t) for s, t, _ in scalars if t == "count"] == [
        (1, "count"), (2, "count"), (300, "count"), (70_000, "count")]
    assert (70_000, "loss", pytest.approx(1 / 70_000)) in scalars
    assert (-3, "neg_step", -1.5) in scalars


@pytest.mark.parametrize("block", [
    {}, {"tensorboard": {"enabled": False}}, {"tensorboard": {"enabled": True}},
    {"tensorboard": {"enabled": True, "output_path": "tb", "job_name": "ds"}}])
def test_from_deepspeed_config_follows_the_block(block, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mine = tensorboard.from_deepspeed_config(block)
    theirs = jax_tensorboard.from_deepspeed_config(block)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert mine.logdir == theirs.logdir
        mine.close()
        theirs.close()


class Recorder:
    def __init__(self):
        self.calls = []

    def log_metrics(self, metrics, step=0):
        self.calls.append((dict(metrics), step))


def _fill(registry) -> None:
    registry.counter("data/batches").inc(3)
    registry.counter("data/bad_samples")
    registry.gauge("comms/bytes_per_step").set(1.5e6)
    h = registry.histogram("span/train/step")
    for v in (0.25, 0.5, 0.125, 1.0, 0.75):
        h.observe(v)


def test_publish_to_loggers_makes_jaxs_calls():
    mine, theirs = telemetry.MetricsRegistry(), jax_telemetry.MetricsRegistry()
    _fill(mine)
    _fill(theirs)
    assert mine.snapshot() == theirs.snapshot()
    calls = []
    for fn, reg in ((publish_to_loggers, mine), (jax_telemetry.publish_to_loggers, theirs)):
        rec_a, rec_b = Recorder(), Recorder()
        snap = fn([rec_a, rec_b], 7, registry=reg)
        assert rec_a.calls == rec_b.calls == [(snap, 7)]
        calls.append(rec_a.calls)
        # an empty snapshot calls no logger
        empty = Recorder()
        assert fn([empty], 8, prefix="t/", registry=type(reg)()) == {} and empty.calls == []
    assert calls[0] == calls[1]
    assert "telemetry/span/train/step_p50" in calls[0][0][0]


class FakeTrainer:
    def __init__(self):
        self.logged = []

    def _log_metrics(self, metrics, step):
        self.logged.append((dict(metrics), step))


@pytest.fixture
def fresh_telemetry():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    telemetry.reset()
    jax_telemetry.reset()


def test_metrics_export_callback_makes_jaxs_calls(fresh_telemetry):
    _fill(telemetry.get_telemetry().registry)
    _fill(jax_telemetry.get_telemetry().registry)
    logged = []
    for cb in (MetricsExportCallback(), jax_telemetry.MetricsExportCallback()):
        trainer = FakeTrainer()
        for hook, args in (("on_fit_start", ()), ("on_epoch_start", (0,)), ("on_step_start", ()),
                           ("on_step_end", ()), ("on_batch_end", ({},)),
                           ("on_eval_end", (0, {})), ("on_epoch_end", (2, {"loss": 1.0})),
                           ("on_fit_end", ())):
            getattr(cb, hook)(trainer, *args)
        logged.append(trainer.logged)
    assert logged[0] == logged[1] and len(logged[0]) == 1 and logged[0][0][1] == 2


def test_system_metrics_sample_as_jax_on_the_cpu(fresh_telemetry, monkeypatch):
    monkeypatch.delenv("TPUFRAME_MEMORY_LIVE", raising=False)
    assert system_metrics.device_memory_stats() == jax_system_metrics.device_memory_stats() == {}
    mine, theirs = SystemMetricsMonitor(), jax_system_metrics.SystemMetricsMonitor()
    assert mine.interval_s == theirs.interval_s == 10.0
    a, b = mine.sample(), theirs.sample()
    assert sorted(a) == sorted(b) == ["system/cpu_utilization", "system/memory_rss_mb"]
    assert a["system/memory_rss_mb"] > 0
    gauges = [sorted(t.get_telemetry().registry.snapshot())
              for t in (telemetry, jax_telemetry)]
    assert gauges[0] == gauges[1] == ["memory/hbm_peak_mb", "memory/host_peak_mb",
                                      "system/cpu_util", "system/rss_mb"]
    assert telemetry.get_telemetry().registry.gauge("memory/host_peak_mb").value > 0


@pytest.mark.parametrize("env", [
    {}, {"TPUFRAME_MEMORY_SAMPLE_S": "2.5"}, {"TPUFRAME_MEMORY_SAMPLE_S": "0.01"},
    {"TPUFRAME_MEMORY_SAMPLE_S": "soon"}, {"TPUFRAME_MEMORY_LIVE": "off"},
    {"TPUFRAME_MEMORY_LIVE": "yes"}, {"TPUFRAME_MEMORY_LIVE": " FALSE "}])
def test_the_memory_knobs_read_as_jaxs_memory_plane(env):
    # the monitor reads the memory plane's knobs (track/memory.py), whole
    from tpuframe_torch.track import memory as port_memory

    assert port_memory.memory_env(env) == jax_memory.memory_env(env)


def test_memory_live_off_skips_the_watermarks(fresh_telemetry, monkeypatch):
    monkeypatch.setenv("TPUFRAME_MEMORY_LIVE", "0")
    SystemMetricsMonitor().sample()
    assert sorted(telemetry.get_telemetry().registry.snapshot()) == ["system/cpu_util",
                                                                     "system/rss_mb"]


def _metric_keys(root: Path) -> list[str]:
    run = next(p for p in (root / "0").iterdir() if p.is_dir())
    return sorted(str(p.relative_to(run / "metrics")) for p in (run / "metrics").rglob("*")
                  if p.is_file())


def test_mlflow_logger_with_system_metrics_logs_them_into_the_run(tmp_path, fresh_telemetry):
    keys = []
    for cls, sub in ((MLflowLogger, "port"), (JaxMLflowLogger, "jax")):
        logger = cls("e", tracking_uri=str(tmp_path / sub), system_metrics=True)
        logger.log_metrics({"loss": 1.0}, step=0)
        assert logger._monitor is not None and logger._monitor._thread is not None
        logger.flush()  # stops the monitor: its final sample lands in the run
        assert logger._monitor is None
        keys.append(_metric_keys(tmp_path / sub))
    assert keys[0] == keys[1] == ["loss", "system/cpu_utilization", "system/memory_rss_mb"]
