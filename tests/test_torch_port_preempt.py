"""The port's ``fault.preempt`` and the Trainer's preemption exit against the
JAX package's (the counterparts of ``tests/test_fault.py``'s preemption,
watcher and worker-exit cases).

- The watcher: request and clear, signals merged into an installed one,
  a poller attached, the maintenance poller over an injected fetch,
  ``reraise_for_exit``, and ``agree`` (local, and on two gloo ranks).
- A launcher worker whose fn raises ``Preempted`` exits 143 with its
  typed outcome frame still written; the bootstrap installs the watcher
  unless ``TPUFRAME_PREEMPT_SIGNALS=0``.
- The Trainer: a ``PreemptNotice`` at step 2 writes the last-chance
  snapshot of step 3 into ``<dir>_intra`` and raises ``Preempted``;
  ``preemption=False`` ignores a set flag; True installs; bad values
  raise; an explicit watcher is consumed on a supervised restart.
- The preempted run resumed under the supervisor ends bit-equal (the
  parameters, BatchNorm buffers and SGD momentum) to its own
  uninterrupted run on the CPU, and its final loss lies within 1e-5
  relative of the JAX Trainer's same preempted run, started from JAX's
  weights carried across by ``models.interop``.
"""

import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.ckpt import Checkpointer, latest_step
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.fault import (
    PREEMPTED_EXIT,
    ChaosPlan,
    Preempted,
    PreemptionWatcher,
    PreemptNotice,
    RestartPolicy,
    Supervisor,
    gce_maintenance_poller,
    preemption_requested,
)
from tpuframe_torch.fault import preempt as preempt_mod
from tpuframe_torch.models import ResNet18, from_jax_variables
from tpuframe_torch.train import Callback, Trainer

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LOSS_RTOL = 1e-5  # the port's preempted fit against JAX's, f32 on the CPU


@pytest.fixture(autouse=True)
def _clean_preempt_state():
    yield
    preempt_mod.uninstall()


def _loader(ds_cls=SyntheticImageDataset, dl_cls=DataLoader, **extra):
    return dl_cls(ds_cls(n=40, image_size=16, num_classes=10, seed=1), 8, shuffle=True, seed=2,
                  transfer_dtype="uint8", **extra)


COMMON = dict(optimizer="sgd", lr=0.05, max_duration="3ba", normalize=(MEAN, STD), seed=0,
              eval_interval=0, log_interval=0)


def _trainer(ck=None, variables=None, **kw):
    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables))
    return Trainer(model, train_dataloader=_loader(), checkpointer=ck, **{**COMMON, **kw})


# -- the watcher --------------------------------------------------------------


def test_watcher_request_and_clear():
    w = PreemptionWatcher()
    assert not w.requested
    w.request("maintenance")
    assert w.requested and w.reason == "maintenance"
    w.request("second")  # the first reason wins
    assert w.reason == "maintenance"
    w.clear()
    assert not w.requested and w.reason is None


def test_install_merges_signals_and_attaches_a_poller():
    w = preempt_mod.install()  # bootstrap-style: SIGTERM only
    assert signal.SIGUSR1 not in w.signals and w.poller is None
    assert preempt_mod.install(signals=(signal.SIGTERM, signal.SIGUSR1)) is w
    assert preempt_mod.install(poller=lambda: False, poll_interval_s=60.0) is w
    assert w._poll_thread is not None and w._poll_thread.is_alive()
    os.kill(os.getpid(), signal.SIGUSR1)
    assert w.wait(timeout=5.0) and w.reason == "signal:SIGUSR1" and preemption_requested()


def test_the_maintenance_poller_reads_its_endpoint():
    seen = []

    def fetch(url, timeout_s):
        seen.append((url, timeout_s))
        return answers.pop(0)

    answers = ["NONE\n", "", "TERMINATE_ON_HOST_MAINTENANCE"]
    poll = gce_maintenance_poller(url="http://metadata.test/event", timeout_s=0.5, fetch=fetch)
    assert [poll(), poll(), poll()] == [False, False, True]
    assert seen[0] == ("http://metadata.test/event", 0.5)

    def down(url, timeout_s):
        raise OSError("unreachable")

    assert gce_maintenance_poller(fetch=down)() is False
    w = PreemptionWatcher(poller=lambda: True, poll_interval_s=0.01).install()
    assert w.wait(timeout=5.0) and w.reason == "maintenance-poll"
    w.uninstall()


def test_reraise_for_exit_and_local_agreement():
    with pytest.raises(SystemExit) as e:
        preempt_mod.reraise_for_exit(Preempted("spot"))
    assert e.value.code == PREEMPTED_EXIT == 143
    with pytest.raises(KeyError):
        preempt_mod.reraise_for_exit(KeyError("k"))
    assert preempt_mod.agree(True) is True and preempt_mod.agree(False) is False


def _agree_rank(rank, world):
    from tpuframe_torch.core import initialize

    initialize(device="cpu")
    return preempt_mod.agree(rank == 1), preempt_mod.agree(False)


def test_agree_on_two_gloo_ranks(tmp_path):
    assert run_ranks(_agree_rank, 2, tmp_path) == [(True, False), (True, False)]


def _boom():
    """Raises Preempted, its step saying whether the bootstrap installed
    the watcher (7) or not (-1)."""
    from tpuframe_torch.fault import Preempted, preempt

    raise Preempted("spot reclaim", step=7 if preempt.active_watcher() is not None else -1)


def _run_worker(tmp_path, name, env=None):
    import cloudpickle

    payload, result = str(tmp_path / f"{name}.pkl"), str(tmp_path / f"{name}_out.pkl")
    with open(payload, "wb") as f:
        cloudpickle.dump((_boom, (), {}), f)
    proc = subprocess.run([sys.executable, "-m", "tpuframe_torch.launch._worker", payload,
                           result], capture_output=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path),
                               **(env or {})})
    with open(result, "rb") as f:
        return proc, pickle.load(f)


def test_worker_exits_preempted_exit_code(tmp_path):
    """A worker whose fn raises Preempted exits 143, not 1, and its typed
    frame still rides along; the bootstrap installed the watcher, unless
    TPUFRAME_PREEMPT_SIGNALS=0."""
    proc, outcome = _run_worker(tmp_path, "on")
    assert proc.returncode == PREEMPTED_EXIT, proc.stderr.decode()[-500:]
    assert not outcome["ok"] and isinstance(outcome["error"], Preempted)
    assert outcome["error"].step == 7 and outcome["error"].reason == "spot reclaim"
    proc, outcome = _run_worker(tmp_path, "off", {"TPUFRAME_PREEMPT_SIGNALS": "0"})
    assert proc.returncode == PREEMPTED_EXIT and outcome["error"].step == -1


# -- the Trainer --------------------------------------------------------------


@pytest.mark.chaos
def test_preemption_notice_saves_and_raises_preempted(tmp_path):
    tr = _trainer(Checkpointer(str(tmp_path / "ck")))
    with ChaosPlan([PreemptNotice("step", step=2)]).active():
        with pytest.raises(Preempted) as info:
            tr.fit()
    e = info.value
    assert e.step == 3  # the notice at step 2's dispatch, the exit at its boundary
    intra = str(tmp_path / "ck") + "_intra"
    assert e.checkpoint == os.path.join(intra, "3") and latest_step(intra) == 3
    assert tr._stop_reason.startswith("preempted")
    meta = Checkpointer(intra).restore(tr.state)[1]
    assert meta["preempted"] and meta["loader_state"]["batches_yielded"] == 3
    assert not preempt_mod.active_watcher().requested  # consumed


def test_preemption_false_ignores_a_set_flag_and_true_installs(tmp_path):
    preempt_mod.install().request("test")
    assert _trainer(Checkpointer(str(tmp_path / "a")), preemption=False).fit().error is None
    preempt_mod.uninstall()
    with pytest.raises(ValueError, match="preemption must be"):
        _trainer(preemption="yes please")
    with pytest.raises(ValueError, match="preempt_sync_steps must be >= 1"):
        _trainer(preempt_sync_steps=0)
    assert _trainer(Checkpointer(str(tmp_path / "b")), preemption=True).fit().error is None
    assert preempt_mod.active_watcher() is not None


@pytest.mark.chaos
def test_explicit_watcher_consumed_on_supervised_restart(tmp_path):
    ckpt_dir = str(tmp_path / "ck")
    watcher = PreemptionWatcher()
    fired = []

    class TripOnce(Callback):
        def on_step_end(self, trainer):
            if not fired and trainer.batches_seen == 2:
                fired.append(1)
                watcher.request("explicit")

    def attempt():
        tr = _trainer(Checkpointer(ckpt_dir), preemption=watcher, callbacks=[TripOnce()])
        return tr, tr.fit()

    sup = Supervisor(RestartPolicy(max_restarts=0, max_preemptions=2, backoff_base_s=0.0),
                     checkpoint_dir=ckpt_dir)
    tr, res = sup.run(attempt)
    assert sup.preemptions == 1 and res.error is None and tr.state.step == 3


@pytest.mark.chaos
def test_preempted_run_resumes_bit_equal_and_matches_jax(tmp_path):
    """Notice at step 1 -> snapshot of step 2 -> Preempted -> supervised
    restart (its own budget, no backoff) -> resume at step 2 -> the fit
    completes its 3 steps: bit-equal to the uninterrupted port fit, and its final loss
    within LOSS_RTOL of the JAX Trainer's same preempted run."""
    import jax

    from tpuframe.ckpt import Checkpointer as JaxCheckpointer
    from tpuframe.data import DataLoader as JaxDataLoader
    from tpuframe.data.datasets import SyntheticImageDataset as JaxSynthetic
    from tpuframe.fault import ChaosPlan as JaxPlan
    from tpuframe.fault import PreemptNotice as JaxNotice
    from tpuframe.fault import RestartPolicy as JaxPolicy
    from tpuframe.fault import Supervisor as JaxSupervisor
    from tpuframe.fault import preempt as jax_preempt
    from tpuframe.models import ResNet18 as JaxResNet18
    from tpuframe.train.trainer import Trainer as JaxTrainer

    jdir, box = str(tmp_path / "jax"), {}

    def jax_attempt():
        jtr = JaxTrainer(JaxResNet18(num_classes=10, num_filters=4, stem="cifar"),
                         train_dataloader=_loader(JaxSynthetic, JaxDataLoader, process_index=0,
                                                  process_count=1),
                         precompile=False, checkpointer=JaxCheckpointer(jdir), **COMMON)
        if "variables" not in box:
            st = jtr.init_state()
            box["variables"] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                            {"params": st.params,
                                             "batch_stats": st.batch_stats})
        res = jtr.fit()
        jtr.checkpointer.wait()
        return res

    try:
        with JaxPlan([JaxNotice("step", step=1)]).active():
            want = JaxSupervisor(JaxPolicy(max_restarts=0, backoff_base_s=0.0),
                                 checkpoint_dir=jdir).run(jax_attempt)
    finally:
        jax_preempt.uninstall()

    tdir, resumed = str(tmp_path / "port"), []

    class Probe(Callback):
        def on_fit_start(self, trainer):
            resumed.append(trainer.state.step)

    def attempt():
        tr = _trainer(Checkpointer(tdir), box["variables"], callbacks=[Probe()])
        return tr, tr.fit()

    sup = Supervisor(RestartPolicy(max_restarts=0, max_preemptions=2, backoff_base_s=0.0),
                     checkpoint_dir=tdir)
    with ChaosPlan([PreemptNotice("step", step=1)]).active():
        tr, got = sup.run(attempt)
    assert got.error is None and sup.preemptions == 1 and sup.retries == 0
    assert resumed == [0, 2] and tr.state.step == 3

    straight = _trainer(variables=box["variables"])
    straight.fit()
    for (name, a), b in zip(straight.model.state_dict().items(),
                            tr.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.state.optimizer.state.values(),
                    tr.state.optimizer.state.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    g, w = got.history[-1]["train_loss"], want.history[-1]["train_loss"]
    assert g == pytest.approx(w, rel=LOSS_RTOL), (g, w)
