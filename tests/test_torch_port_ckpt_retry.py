"""A write that fails inside ``torch.distributed.checkpoint`` reaches the
save's retry window (ROADMAP Queue 3 item 29).

DCP wraps every rank's write failure in ``CheckpointException``, a
``BaseException``.  The port's ``Checkpointer.save`` unwraps it to the
first failing rank's own exception, as ``tpuframe.ckpt.checkpoint.
Checkpointer.save`` sees orbax's: an ``OSError`` is retried
``TPUFRAME_CKPT_SAVE_RETRIES`` times, one ``ckpt/save_retries`` tick and one
``ckpt/save_retry`` event a retry, and the step commits; a ``ValueError``
classifies FATAL.  Exact: one flake, one retry.

The failure is planted in ``FileSystemWriter.write_data``, below
``dcp.save``, so DCP's own wrapping is what the save sees.
"""

import os

import pytest
import torch
from torch.distributed.checkpoint.filesystem import FileSystemWriter

from torch_ranks import run_ranks
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.fault.supervisor import FailureClass, classify_failure
from tpuframe_torch.track.telemetry import get_telemetry


def _fail_writes(monkeypatch, error, times=1, only_rank=None):
    """``write_data`` raises ``error`` on its first ``times`` calls (on
    ``only_rank`` alone when given); returns the list of calls."""
    real, calls = FileSystemWriter.write_data, []

    def flaky(self, plan, planner):
        calls.append(1)
        rank = int(os.environ.get("RANK", "0"))
        if len(calls) <= times and (only_rank is None or rank == only_rank):
            raise error
        return real(self, plan, planner)

    monkeypatch.setattr(FileSystemWriter, "write_data", flaky)
    return calls


def _retry_events(tele, error):
    """The ``ckpt/save_retry`` events whose error names ``error``."""
    return [e for e in tele.recent_events(10_000)
            if e.get("name") == "ckpt/save_retry" and error in e.get("error", "")]


def test_one_oserror_in_the_write_retries_once_and_commits(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFRAME_CKPT_SAVE_RETRIES", "2")
    calls = _fail_writes(monkeypatch, OSError("disk flake"))
    tele = get_telemetry()
    counter = tele.registry.counter("ckpt/save_retries")
    before = counter.value
    with Checkpointer(tmp_path / "ck") as ck:
        path = ck.save({"w": torch.arange(4.0)}, step=3)
        assert ck.all_steps() == [3]
        out, _ = ck.restore({"w": torch.zeros(4)})
    assert path == str(tmp_path / "ck" / "3")
    assert torch.equal(out["w"], torch.arange(4.0))
    assert counter.value == before + 1 and len(calls) == 2
    events = _retry_events(tele, "disk flake")
    assert len(events) == 1 and events[0]["step"] == 3 and events[0]["attempt"] == 1


def test_a_wrapped_value_error_is_not_retried_and_classifies_fatal(tmp_path, monkeypatch):
    calls = _fail_writes(monkeypatch, ValueError("a bug in the writer"))
    counter = get_telemetry().registry.counter("ckpt/save_retries")
    before = counter.value
    with Checkpointer(tmp_path / "ck") as ck, \
            pytest.raises(ValueError, match="a bug in the writer") as info:
        ck.save({"w": torch.ones(2)}, step=1)
    assert classify_failure(info.value) is FailureClass.FATAL
    assert type(info.value.__cause__).__name__ == "CheckpointException"
    assert counter.value == before and len(calls) == 1


def test_retries_spent_raise_the_oserror_itself(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFRAME_CKPT_SAVE_RETRIES", "1")
    calls = _fail_writes(monkeypatch, OSError("disk gone"), times=5)
    with Checkpointer(tmp_path / "ck") as ck, pytest.raises(OSError, match="disk gone") as info:
        ck.save({"w": torch.ones(2)}, step=1)
    assert classify_failure(info.value) is FailureClass.RETRYABLE
    assert len(calls) == 2 and ck.all_steps() == []


def test_async_wait_raises_the_unwrapped_oserror(tmp_path, monkeypatch):
    _fail_writes(monkeypatch, OSError("async flake"))
    ck = Checkpointer(tmp_path / "ck", async_save=True)
    ck.save({"w": torch.ones(2)}, step=1)
    with pytest.raises(OSError, match="async flake") as info:
        ck.wait()
    assert type(info.value.__cause__).__name__ == "CheckpointException"
    assert ck.all_steps() == []
    ck.save({"w": torch.ones(2)}, step=2)  # the next save commits
    ck.close()
    assert ck.all_steps() == [2]


def _two_rank_save(rank, world, directory):
    import pytest as _pytest

    from tpuframe_torch.core import initialize

    initialize(device="cpu")
    with _pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUFRAME_CKPT_SAVE_RETRIES", "2")
        calls = _fail_writes(mp, OSError(f"flake on rank {rank}"), only_rank=1)
        tele = get_telemetry()
        counter = tele.registry.counter("ckpt/save_retries")
        before = counter.value
        with Checkpointer(directory) as ck:
            ck.save({"w": torch.full((4,), float(rank + 1))}, step=5)
            steps = ck.all_steps()
    return {"retries": counter.value - before, "writes": len(calls), "steps": steps,
            "events": len(_retry_events(tele, "flake on rank 1"))}


def test_two_gloo_ranks_retry_together_when_rank_1_fails(tmp_path):
    r0, r1 = run_ranks(_two_rank_save, 2, tmp_path, str(tmp_path / "ck"), timeout=180)
    for r in (r0, r1):
        assert r == {"retries": 1, "events": 1, "writes": 2, "steps": [5]}, (r0, r1)
