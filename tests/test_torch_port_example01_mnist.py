"""Example 01 (MNIST) under the restart loop, and ``run_with_restarts``
itself (the counterparts of ``tests/test_launch.py``'s restart-loop cases
and ``tests/test_fault.py``'s ``test_chaos_killworker_through_distributor_
recovers``).

- ``run_with_restarts`` retries infrastructure failures and never a bug.
- A fit that crashes mid-run, relaunched by ``run_with_restarts``, resumes
  from its checkpoint instead of recomputing.
- The port's example 01 runs its train fn on two CPU workers of a
  ``Distributor`` under ``run_with_restarts``; ``KillWorker(SIGKILL)`` on
  rank 1 at step 6 (in epoch 2) takes the first attempt down, the run
  restarts once (RETRYABLE), resumes from the epoch-1 checkpoint and
  returns ``"finished"``.

The worker fn lives here and the JAX imports stay inside the test
functions: the workers import this module.
"""

import importlib
import os
import signal

import pytest
import torch

from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.ckpt.meta import _read_meta_doc, latest_step
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.fault import ChaosPlan, KillWorker
from tpuframe_torch.launch import Distributor, run_with_restarts
from tpuframe_torch.models import ResNet18
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train import Callback, Trainer

EXAMPLE = "tpuframe_torch.examples.01_distributor_mnist"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads in this test process: the suite runs several
    files at once, and spawned ranks share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_run_with_restarts_recovers_and_never_retries_a_bug():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "done"

    assert run_with_restarts(flaky, max_restarts=3, backoff_s=0.0) == "done"
    assert len(calls) == 3
    bugs = []

    def buggy():
        bugs.append(1)
        raise ValueError("a code bug")

    with pytest.raises(ValueError):
        run_with_restarts(buggy, max_restarts=5, backoff_s=0.0)
    assert len(bugs) == 1


def test_restart_resumes_training_from_checkpoint(tmp_path):
    """A fit that crashes after epoch 1 is relaunched by run_with_restarts
    and resumes at epoch 2 instead of recomputing epoch 1."""
    crashes, epoch_starts = [], []

    class CrashOnce(Callback):
        def on_epoch_start(self, trainer, epoch):
            epoch_starts.append(epoch)

        def on_epoch_end(self, trainer, epoch, metrics):
            if epoch == 0 and not crashes:
                crashes.append(1)
                raise OSError("node lost")

    def fit():
        loader = DataLoader(SyntheticImageDataset(n=32, image_size=8, num_classes=4), 16,
                            shuffle=True, seed=1)
        return Trainer(ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu"),
                       train_dataloader=loader, max_duration="2ep", eval_interval=0,
                       log_interval=0, checkpointer=Checkpointer(tmp_path / "ck"),
                       checkpoint_interval=1, callbacks=[CrashOnce()]).fit()

    # the crash lands in on_epoch_end, before epoch 1's save: the retry
    # replays epoch 0 once, then epoch 1 resumes from epoch 0's save
    result = run_with_restarts(fit, max_restarts=1, backoff_s=0.0)
    assert result.error is None and crashes == [1]
    assert epoch_starts == [0, 0, 1]


def _mnist_killed_once(cfg: dict, flag: str):
    """The example's worker fn; on the first attempt rank 1 runs it under
    KillWorker(SIGKILL) at step 6.  Returns its value and the epoch the
    checkpoint directory held when it started."""
    torch.set_num_threads(2)  # two ranks share the host's cores
    held = latest_step(cfg["ckpt_dir"])
    resume_epoch = _read_meta_doc(cfg["ckpt_dir"], held)["meta"]["epoch"] if held else 0
    train_mnist = importlib.import_module(EXAMPLE).train_mnist
    if os.environ["RANK"] == "1" and not os.path.exists(flag):
        with open(flag, "w") as f:
            f.write("armed")
        with ChaosPlan([KillWorker("step", step=6, sig=signal.SIGKILL)]).active():
            return train_mnist(cfg), resume_epoch
    return train_mnist(cfg), resume_epoch


@pytest.mark.chaos
def test_example01_recovers_from_a_killed_worker(tmp_path):
    cfg = {"epochs": 2, "batch_size": 16, "train_samples": 64, "eval_samples": 20,
           "lr": 0.01, "seed": 42, "tracking_uri": str(tmp_path / "mlruns"),
           "ckpt_dir": str(tmp_path / "ckpt")}
    flag = str(tmp_path / "killed_once")
    restarts = []
    tele = get_telemetry()
    before = tele.registry.counter("fault/restarts").value
    dist = Distributor(num_processes=2, simulate_devices=1, timeout_s=240.0,
                       heartbeat_timeout_s=None)
    value, resume_epoch = run_with_restarts(
        lambda: dist.run(_mnist_killed_once, cfg, flag), max_restarts=1, backoff_s=0.0,
        on_restart=lambda attempt, e: restarts.append((attempt, type(e).__name__,
                                                       getattr(e, "returncode", None))))
    assert value == "finished" and os.path.exists(flag)
    assert restarts == [(1, "DistributorError", -signal.SIGKILL)]
    assert tele.registry.counter("fault/restarts").value == before + 1
    assert resume_epoch == 1  # from the epoch-1 checkpoint, not from scratch
    assert latest_step(cfg["ckpt_dir"]) == 8
