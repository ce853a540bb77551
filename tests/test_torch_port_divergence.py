"""The divergence ladder through the port's Trainer and Supervisor (the
counterpart of ``tests/test_health.py``'s ``TestTrainerLadder``): a NaN
batch is skipped and counted; a poison window longer than ``max_bad``
raises ``Divergence``; under the supervisor the run rolls back to the last
healthy committed step (the unhealthy snapshot quarantined, one
``fault/rollback``), re-enters at the escalated ``lr_scale`` and completes
the full schedule with every parameter finite.

The poison is ``NaNAt`` at the ``batch`` site, on the float host batch
before its copy to the device, drawn from the same seeded schedule as the
JAX test's (``ChaosPlan.scheduled(23, ...)``, pinned at step 9).
"""

import itertools
import math
import os

import pytest
import torch

from tpuframe_torch.ckpt import Checkpointer, latest_step
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.fault import (
    ChaosPlan,
    Divergence,
    HealthPolicy,
    NaNAt,
    RestartPolicy,
    Supervisor,
    recovery_directive,
)
from tpuframe_torch.models import ResNet18
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train import Callback, Trainer

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
_MARKS = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads in this test process: the suite runs several
    files at once, and spawned ranks share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mark() -> str:
    token = f"divergence-test-{next(_MARKS)}"
    get_telemetry().event("test/mark", token=token)
    return token


def _since(token: str) -> list[dict]:
    ev = get_telemetry().recent_events(10**6)
    idx = max(i for i, e in enumerate(ev)
              if e.get("name") == "test/mark" and e.get("token") == token)
    return ev[idx + 1:]


def _trainer(ck=None, *, n=64, **kw):
    kw.setdefault("max_duration", "2ep")
    # float transfer: NaNAt poisons the host batch, which uint8 cannot hold
    loader = DataLoader(SyntheticImageDataset(n=n, image_size=8, num_classes=4, seed=0),
                        batch_size=8, shuffle=True, seed=3, transfer_dtype="float32")
    return Trainer(ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu"),
                   train_dataloader=loader, checkpointer=ck, optimizer="sgd", lr=0.02,
                   normalize=(MEAN, STD), eval_interval=0, log_interval=0, **kw)


@pytest.mark.chaos
def test_a_nan_step_is_skipped_and_counted():
    reg = get_telemetry().registry
    n0 = reg.counter("health/bad_steps").value
    tr = _trainer(n=32, max_duration="1ep",
                  health=HealthPolicy(window=2, max_bad=99, warmup_steps=2))
    before = [p.detach().clone() for p in tr.model.parameters()]
    with ChaosPlan([NaNAt(step=1)]).active():
        res = tr.fit()
    assert res.metrics["health_bad_steps"] == 1.0
    assert reg.counter("health/bad_steps").value == n0 + 1
    assert float(tr.state.health["last_bad_step"]) == 1.0
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before, tr.model.parameters()))


@pytest.mark.chaos
def test_divergence_raised_at_window():
    tr = _trainer(max_duration="1ep", health=HealthPolicy(window=4, max_bad=2, warmup_steps=1))
    token = _mark()
    with ChaosPlan([NaNAt(step=2, times=3)]).active():
        with pytest.raises(Divergence) as info:
            tr.fit()
    assert info.value.bad_in_window >= 2
    assert "health/divergence" in [e["name"] for e in _since(token)]


@pytest.mark.chaos
def test_nan_window_skips_escalates_rolls_back_and_completes(tmp_path):
    """Seeded NaN window at steps 9-11 -> skips -> Divergence -> rollback to
    the epoch-end step 8 (the unhealthy snapshot of step 10 quarantined) ->
    re-entry at lr_scale 0.5 -> the full 16 steps, every parameter finite."""
    pol = HealthPolicy(window=4, max_bad=2, warmup_steps=2, lr_backoff=0.5)
    ckpt_dir = str(tmp_path / "ck")
    resumed, expected, scales = [], [], []

    class Probe(Callback):
        def on_fit_start(self, trainer):
            resumed.append(trainer.state.step)
            scales.append(recovery_directive().lr_scale)

    def on_restart(attempt, error):
        # after the rollback: the newest committed step is the frontier
        expected.append(max(latest_step(ckpt_dir) or 0, latest_step(ckpt_dir + "_intra") or 0))

    def attempt():
        tr = _trainer(Checkpointer(ckpt_dir), health=pol, checkpoint_interval_batches=2,
                      callbacks=[Probe()])
        res = tr.fit()
        return tr, res

    plan = ChaosPlan.scheduled(23, sites={"batch": NaNAt(times=3)}, min_step=9, max_step=9)
    assert plan.injectors[0].step == 9
    sup = Supervisor(RestartPolicy(max_restarts=0, max_divergences=2, backoff_base_s=0.0),
                     checkpoint_dir=ckpt_dir, on_restart=on_restart)
    token = _mark()
    with plan.active():
        tr, res = sup.run(attempt)
    assert sup.divergences == 1 and sup.retries == 0
    assert tr.state.step == 16 and res.error is None
    assert plan.fired_count() >= 2
    assert resumed[1] == expected[0] == 8 and scales == [1.0, 0.5]
    intra = ckpt_dir + "_intra"
    assert os.listdir(os.path.join(intra, "_quarantine")) == ["10"]
    events = _since(token)
    names = [e["name"] for e in events]
    assert "health/bad_step" in names and "health/divergence" in names
    rollbacks = [e for e in events if e["name"] == "fault/rollback"]
    assert len(rollbacks) == 1 and rollbacks[0]["directory"] == intra
    (restart,) = [e for e in events if e["name"] == "fault/restart"]
    assert restart["failure_class"] == "divergence"
    assert restart["rollback"] == {"lr_scale": 0.5, "skip_batches": 0, "rolled_back_to": 8}
    (backoff,) = [e for e in events if e["name"] == "health/lr_backoff"]
    assert backoff["lr_scale"] == 0.5
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())
    assert math.isfinite(res.metrics["train_loss"])


@pytest.mark.chaos
def test_skip_batches_moves_the_restored_position_once(tmp_path):
    """A directive with skip_batches advances the first fit after the
    rollback past the window, once (health/skip_batches)."""
    from tpuframe_torch.fault import health

    health.reset_recovery()
    health.escalate_recovery(HealthPolicy(lr_backoff=1.0, skip_batches=3))
    seen = []

    class Positions(Callback):
        def on_step_end(self, trainer):
            seen.append(trainer._train_prefetcher.state_dict()["batches_yielded"])

    token = _mark()
    _trainer(n=48, max_duration="1ep", health=HealthPolicy(),
             callbacks=[Positions()]).fit()
    assert seen == [4, 5, 6]
    (ev,) = [e for e in _since(token) if e["name"] == "health/skip_batches"]
    assert ev["skip"] == 3 and ev["batches_yielded"] == 3
    assert health.consume_skip_batches() == 0
    health.reset_recovery()
