"""The launcher: heartbeat, Distributor, TPUTrainer and the ported examples.

Against ``tpuframe/launch`` and ``tpuframe/core/native.py``'s heartbeat,
on CPU workers (``simulate_devices=1``: ``TPUFRAME_SIMULATE_DEVICES`` in
each worker's env, gloo groups of one CPU device a process).

- The heartbeat monitor and beacon (``csrc/heartbeat.cpp``, built with
  ``g++`` at first use) in one process: a beacon with the run's token is
  heard, one with another token is not, a closed one goes stale.
- ``Distributor(2, simulate_devices=1)``: the JAX launcher's env contract
  in each worker, a working gloo group of two, rank 0's value back.
- A raising rank: its own exception re-raised, with a ``DistributorError``
  (its rank, exit code and the stderr tail holding its traceback) as
  ``__cause__``.  The exit code is pinned at 1: the port's worker has no
  preemption watcher (ROADMAP Queue 3), even with
  ``TPUFRAME_PREEMPT_SIGNALS`` set.
- A rank lost mid-run: it freezes whole (SIGSTOP, as a hung or cut-off
  host: its process handle still looks alive, its beacon falls silent),
  and the run fails as ``WorkerLostError`` within the 2 s heartbeat
  timeout, long before ``timeout_s``.  (A local rank that is SIGKILLed
  exits, and the launcher sees its exit code -9 first: a
  ``DistributorError``, as in JAX.)
- ``TPUTrainer`` runs example 05's ``train_func`` on two CPU workers: one
  report per epoch, rank 0's last metrics, the checkpoint bundle.
- The ported examples 01 (through the Distributor), 03 and 04 (in this
  process) at tiny sizes with ``--simulate-devices 1``.

Six spawned runs in all (the Distributor test, the raising rank, the lost
rank, TPUTrainer, and example 01's two runs), each with a timeout of at
most 90 s.  This module imports no JAX: the workers import it.
"""

import functools
import importlib
import json
import os
import signal
import socket
import sys
import time

import pytest
import torch

from tpuframe_torch.core import native
from tpuframe_torch.core.runtime import SIMULATE_ENV, reset_runtime, resolve_device
from tpuframe_torch.launch import (
    Checkpoint,
    Distributor,
    DistributorError,
    RunConfig,
    ScalingConfig,
    TPUTrainer,
    WorkerLostError,
    get_context,
    report,
)

TIMEOUT_S = 90.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_heartbeat_monitor_and_beacon_in_one_process():
    assert native.heartbeat_available(), native.build_error
    port = _free_port()
    with native.HeartbeatMonitor(port, 3, token="run-token") as monitor:
        assert monitor.ms_since(0) == -1 and monitor.stale_ranks(0.1) == []
        assert monitor.stale_ranks(0.1, include_unseen=True) == [0, 1, 2]
        good = native.HeartbeatBeacon("127.0.0.1", port, 1, token="run-token", interval_ms=100)
        stranger = native.HeartbeatBeacon("127.0.0.1", port, 2, token="other", interval_ms=100)
        deadline = time.monotonic() + 10
        while monitor.ms_since(1) < 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        assert 0 <= monitor.ms_since(1) < 1000
        assert monitor.ms_since(2) == -1  # the wrong token is turned away
        good.close()
        time.sleep(1.2)
        assert monitor.stale_ranks(1.0) == [1] and monitor.ms_since(1) > 1000
        stranger.close()


def test_maybe_start_beacon_follows_the_env(monkeypatch):
    monkeypatch.delenv("TPUFRAME_HB_PORT", raising=False)
    assert native.maybe_start_beacon() is None
    port = _free_port()
    with native.HeartbeatMonitor(port, 1) as monitor:
        monkeypatch.setenv("TPUFRAME_HB_PORT", str(port))
        monkeypatch.setenv("TPUFRAME_HB_ADDR", "127.0.0.1")
        monkeypatch.setenv("RANK", "0")
        beacon = native.maybe_start_beacon()
        assert beacon is not None
        deadline = time.monotonic() + 10
        while monitor.ms_since(0) < 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert monitor.ms_since(0) >= 0
        beacon.close()


def _contract():
    """Rank-0 result of the env-contract run: the env, the device the
    runtime picks, and a sum over the gloo group."""
    from tpuframe_torch.core import initialize, shutdown

    names = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "TPUFRAME_PROCESS_ID",
             "TPUFRAME_NUM_PROCESSES", "TPUFRAME_COORDINATOR", "TPUFRAME_CP_TOKEN",
             "TPUFRAME_HB_PORT", SIMULATE_ENV)
    env = {n: os.environ.get(n) for n in names}
    rt = initialize()
    total = torch.tensor([rt.process_index + 1.0])
    torch.distributed.all_reduce(total)
    out = {"env": env, "device": str(rt.device), "world": rt.process_count,
           "sum": float(total), "rank": rt.process_index, "ctx": (
               get_context().get_world_size(), get_context().get_world_rank())}
    shutdown()
    return out


def test_distributor_runs_two_cpu_ranks_and_returns_rank_0s_value():
    dist = Distributor(2, simulate_devices=1, timeout_s=TIMEOUT_S)
    out = dist.run(_contract)
    env = out["env"]
    assert out["rank"] == 0 and out["world"] == 2 and out["sum"] == 3.0
    assert out["device"] == "cpu" and out["ctx"] == (2, 0)
    assert env["RANK"] == env["LOCAL_RANK"] == env["TPUFRAME_PROCESS_ID"] == "0"
    assert env["WORLD_SIZE"] == env["TPUFRAME_NUM_PROCESSES"] == "2"
    assert env["MASTER_ADDR"] == "127.0.0.1"
    assert env["TPUFRAME_COORDINATOR"].startswith("127.0.0.1:")
    assert len(env["TPUFRAME_CP_TOKEN"]) == 32 and env["TPUFRAME_HB_PORT"]
    assert env[SIMULATE_ENV] == "1" and dist.heartbeat_active is True


def test_the_launchers_refusals():
    with pytest.raises(NotImplementedError, match="gloo processes"):
        Distributor(2, simulate_devices=4)
    with pytest.raises(ValueError, match="hosts"):
        Distributor(2, local_mode=False)
    with pytest.raises(ValueError, match="one rank per host"):
        Distributor(3, local_mode=False, hosts=["a", "b"])
    with pytest.raises(ValueError, match="remote_kwargs"):
        Distributor(2, remote_kwargs={"cp_port": 1})
    with pytest.raises(ValueError, match="num_processes"):
        Distributor(0)
    with pytest.raises(ValueError, match="simulate_devices=1"):
        ScalingConfig(use_gpu=False)
    report({"loss": 1.0})  # outside a TPUTrainer: nothing happens
    assert get_context().get_world_size() >= 1


def test_resolve_device_reads_the_request_only_without_a_device(monkeypatch):
    monkeypatch.setenv(SIMULATE_ENV, "1")
    assert resolve_device() == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")  # a named device is not overridden
    monkeypatch.setenv(SIMULATE_ENV, "2")
    with pytest.raises(NotImplementedError, match="gloo processes"):
        resolve_device()
    monkeypatch.setenv(SIMULATE_ENV, "")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()


class RankOneFailed(RuntimeError):
    pass


def _rank_one_raises():
    if os.environ["RANK"] == "1":
        raise RankOneFailed("rank one failed at step 3")
    time.sleep(60)  # rank 0 hangs, as at a collective: the grace ends it
    return "unreachable"


def test_a_raising_rank_surfaces_with_its_traceback_and_exit_code_1():
    t0 = time.monotonic()
    with pytest.raises(RankOneFailed, match="step 3") as info:
        Distributor(2, simulate_devices=1, timeout_s=TIMEOUT_S,
                    env={"TPUFRAME_PREEMPT_SIGNALS": "1"}).run(_rank_one_raises)
    cause = info.value.__cause__
    assert isinstance(cause, DistributorError) and not isinstance(cause, WorkerLostError)
    assert cause.rank == 1 and cause.returncode == 1
    assert "Traceback" in cause.stderr_tail and "RankOneFailed" in cause.stderr_tail
    assert "_rank_one_raises" in cause.stderr_tail
    assert time.monotonic() - t0 < 45  # the hung rank 0 got only the grace


def _rank_one_is_lost():
    if os.environ["RANK"] == "1":
        time.sleep(1.5)  # its beacon is heard first
        os.kill(os.getpid(), signal.SIGSTOP)
    time.sleep(60)


def test_a_lost_rank_surfaces_as_worker_lost_within_the_heartbeat_timeout():
    dist = Distributor(2, simulate_devices=1, timeout_s=TIMEOUT_S, heartbeat_timeout_s=2.0)
    t0 = time.monotonic()
    with pytest.raises(WorkerLostError) as info:
        dist.run(_rank_one_is_lost)
    elapsed = time.monotonic() - t0
    assert dist.heartbeat_active is True
    assert info.value.rank == 1 and 2.0 <= info.value.silent_s < 10.0
    assert elapsed < 45, elapsed


def _example(name: str):
    """A ported example as a module (``tpuframe_torch.examples.<name>``),
    with its ``_common`` the port's."""
    sys.modules.pop("_common", None)
    return importlib.import_module(f"tpuframe_torch.examples.{name}")


@pytest.fixture
def cpu_examples(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv(SIMULATE_ENV, "")  # restored after: the in-process examples set it
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.delitem(sys.modules, "_common", raising=False)
    yield
    reset_runtime()


TINY = ["--image-size", "16", "--batch-size", "16", "--train-samples", "32",
        "--eval-samples", "20", "--epochs", "1", "--simulate-devices", "1"]


def test_tpu_trainer_runs_example_05_on_two_cpu_workers(tmp_path, cpu_examples):
    ex = _example("05_ray_fashion_mnist")
    trainer = TPUTrainer(
        ex.train_func,
        train_loop_config={"epochs": 2, "batch_size": 16, "train_samples": 64, "lr": 1e-3,
                           "seed": 0},
        scaling_config=ScalingConfig(num_workers=2, simulate_devices=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="fashion"))
    result = trainer.fit()
    assert result.error is None, result.error
    assert len(result.metrics_dataframe) == 2
    assert [m["epoch"] for m in result.metrics_dataframe] == [0.0, 1.0]
    assert result.metrics["world_size"] == 2.0 and result.metrics["train_loss"] > 0
    with result.checkpoint.as_directory() as d:
        assert json.load(open(os.path.join(d, "meta.json"))) == {"epoch": 1}
        tree = torch.load(os.path.join(d, "model.msgpack"), weights_only=True)
    assert sorted(tree["params"]) == sorted(n for n, _ in
                                            ex.MnistNet(device="cpu").named_parameters())
    assert isinstance(result.checkpoint, Checkpoint)
    # rank 1 reported too, without a bundle
    lines = open(os.path.join(result.path, "rank_1.jsonl")).read().splitlines()
    assert len(lines) == 2 and all(json.loads(x)["checkpoint"] is None for x in lines)


def test_example_01_runs_through_the_distributor(tmp_path, cpu_examples, monkeypatch, capsys):
    ex = _example("01_distributor_cifar_resnet")
    monkeypatch.setattr(ex, "Distributor", functools.partial(Distributor, timeout_s=TIMEOUT_S))
    ex.main(["--num-processes", "1", "--workdir", str(tmp_path), *TINY])
    out = capsys.readouterr().out
    assert "1 epoch:" in out and "1 epochs:" in out and "demo_pred" in out
    assert (tmp_path / "cifar" / "mlruns" / "0").is_dir()


@pytest.mark.parametrize("name", ["03_composer_cifar_resnet", "04_accelerate_cifar"])
def test_examples_03_and_04_run_in_process_on_the_cpu(name, tmp_path, cpu_examples, capsys):
    ex = _example(name)
    ex.main(["--workdir", str(tmp_path), *TINY])
    out = capsys.readouterr().out
    assert os.environ[SIMULATE_ENV] == "1"
    if name.startswith("03"):
        assert "registered=v1@champion" in out
        assert (tmp_path / "composer" / "mlruns" / "models" / "cifar-composer-resnet").is_dir()
    else:
        assert "epoch 0 [" in out and "eval_loss" in out
        runs = list((tmp_path / "accelerate" / "mlruns" / "0").iterdir())
        assert any((r / "artifacts" / "best_model" / "model.msgpack").is_file() for r in runs)
