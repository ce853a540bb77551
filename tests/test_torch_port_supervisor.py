"""The port's ``fault.supervisor`` and the recovery directive against the JAX
package's (the counterparts of ``tests/test_fault.py``'s backoff,
classification and supervisor cases).

Exact, on the same inputs:
- ``backoff_delay`` with a seeded ``random.Random``, and ``RestartPolicy``'s
  seeded delays;
- ``escalate_recovery``'s ``lr_scale`` and ``skip_batches`` after one and
  two escalations, and the one-shot ``consume_skip_batches``;
- the sequence of ``fault/*`` events (name, ``failure_class``, ``attempt``,
  ``budget``, ``delay_s`` with ``jitter=False``, the rollback's
  perturbation) of a ``Supervisor`` run through the same scripted
  failures as JAX's stdlib ``Supervisor``.

torch's ``DistBackendError`` and ``torch.cuda.OutOfMemoryError`` are
``RuntimeError``s, so they classify RETRYABLE as JAX's infra errors do.
"""

import itertools
import os
import random

import pytest
import torch

from tpuframe.fault import health as jax_health
from tpuframe.fault import supervisor as jax_sup
from tpuframe.fault.health import Divergence as JaxDivergence
from tpuframe.fault.health import HealthPolicy as JaxHealthPolicy
from tpuframe.fault.preempt import Preempted as JaxPreempted
from tpuframe.track.telemetry import get_telemetry as jax_telemetry
from tpuframe_torch.ckpt import Checkpointer, latest_step
from tpuframe_torch.fault import (
    ChaosError,
    Divergence,
    FailureClass,
    HealthPolicy,
    Preempted,
    RestartPolicy,
    Supervisor,
    backoff_delay,
    classify_failure,
    health,
    recovery_directive,
    reset_recovery,
    run_supervised,
)
from tpuframe_torch.launch import run_with_restarts
from tpuframe_torch.track.telemetry import get_telemetry

_MARKS = itertools.count()


def _mark(tele) -> str:
    token = f"supervisor-test-{next(_MARKS)}"
    tele.event("test/mark", token=token)
    return token


def _since(tele, token: str, prefix: str = "fault/") -> list[dict]:
    ev = tele.recent_events(10**6)
    idx = max(i for i, e in enumerate(ev)
              if e.get("name") == "test/mark" and e.get("token") == token)
    return [e for e in ev[idx + 1:] if e.get("name", "").startswith(prefix)]


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_backoff_delay_is_jax_exactly(seed):
    for base, cap in ((1.0, 60.0), (0.25, 4.0), (2.0, 8.0)):
        a, b = random.Random(seed), random.Random(seed)
        for attempt in range(1, 9):
            assert backoff_delay(attempt, base_s=base, max_s=cap, rng=a) == \
                jax_sup.backoff_delay(attempt, base_s=base, max_s=cap, rng=b)
            assert backoff_delay(attempt, base_s=base, max_s=cap, jitter=False) == \
                jax_sup.backoff_delay(attempt, base_s=base, max_s=cap, jitter=False)
    p, q = RestartPolicy(seed=seed), jax_sup.RestartPolicy(seed=seed)
    assert [p.delay_s(a) for a in range(1, 6)] == [q.delay_s(a) for a in range(1, 6)]
    assert [backoff_delay(a, base_s=1.0, max_s=8.0, jitter=False) for a in range(1, 7)] == \
        [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]
    with pytest.raises(ValueError, match="counts from 1"):
        backoff_delay(0)


def test_classify_failure_matches_jax_and_torch_errors_are_retryable():
    cases = [(Preempted(), JaxPreempted()), (Divergence("d"), JaxDivergence("d"))] + [
        (e, e) for e in (ValueError("bug"), TypeError("bug"), AttributeError("a"),
                         ImportError("i"), KeyboardInterrupt(), SystemExit(2), OSError("io"),
                         RuntimeError("xla"), ChaosError("chaos"), TimeoutError("t"))]
    for port_e, jax_e in cases:
        assert classify_failure(port_e).value == jax_sup.classify_failure(jax_e).value
    assert issubclass(torch.distributed.DistBackendError, RuntimeError)
    assert issubclass(torch.cuda.OutOfMemoryError, RuntimeError)
    for e in (torch.distributed.DistBackendError("nccl"), torch.cuda.OutOfMemoryError("oom")):
        assert classify_failure(e) is FailureClass.RETRYABLE


def test_escalate_recovery_matches_jax():
    pol = dict(lr_backoff=0.3, skip_batches=5)
    for port_policy, jax_policy in ((HealthPolicy(**pol), JaxHealthPolicy(**pol)),
                                    (None, None)):
        reset_recovery()
        jax_health.reset_recovery()
        for _ in range(2):
            got = health.escalate_recovery(port_policy)
            want = jax_health.escalate_recovery(jax_policy)
            assert (got.lr_scale, got.skip_batches, got.divergences) == \
                (want.lr_scale, want.skip_batches, want.divergences)
        assert health.consume_skip_batches() == jax_health.consume_skip_batches()
        assert health.consume_skip_batches() == 0  # one-shot
        assert recovery_directive().lr_scale == jax_health.recovery_directive().lr_scale
    reset_recovery()
    jax_health.reset_recovery()
    assert recovery_directive() == health.RecoveryDirective()


def _scripted(seq):
    seq = list(seq)

    def fn():
        e = seq.pop(0)
        if e is not None:
            raise e
        return "done"

    return fn


SCRIPTS = {
    "mixed": lambda m: [m["Preempted"](), OSError("infra"), m["Divergence"]("d"),
                        m["Preempted"](), OSError("again"), None],
    "retry_budget": lambda m: [OSError("a"), OSError("b"), OSError("c"), None],
    "divergence_budget": lambda m: [m["Divergence"]("d")] * 3 + [None],
    "fatal": lambda m: [OSError("io"), ValueError("bug"), None],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_supervisor_event_sequence_matches_jax(script):
    """The same scripted failures under both supervisors: the same fault/*
    events, field for field, and the same outcome."""
    kinds = {"port": {"Preempted": Preempted, "Divergence": Divergence},
             "jax": {"Preempted": JaxPreempted, "Divergence": JaxDivergence}}
    runs = {}
    for side, sup_mod, tele in (("port", None, get_telemetry()),
                                ("jax", jax_sup, jax_telemetry())):
        policy = (RestartPolicy if sup_mod is None else sup_mod.RestartPolicy)(
            max_restarts=2, max_preemptions=3, max_divergences=2, backoff_base_s=0.5,
            backoff_max_s=4.0, jitter=False)
        slept, seen = [], []
        sup = (Supervisor if sup_mod is None else sup_mod.Supervisor)(
            policy, sleep=slept.append, on_restart=lambda a, e: seen.append(a))
        token = _mark(tele)
        try:
            outcome = sup.run(_scripted(SCRIPTS[script](kinds[side])))
        except BaseException as e:  # noqa: BLE001 - the outcome is compared
            outcome = type(e).__name__
        events = [{k: e.get(k) for k in ("name", "failure_class", "attempt", "budget",
                                         "delay_s", "rollback", "reason", "attempts")}
                  for e in _since(tele, token)]
        runs[side] = (outcome, events, slept, seen,
                      (sup.retries, sup.preemptions, sup.divergences))
    assert runs["port"] == runs["jax"]
    assert runs["port"][1], "no fault/* events"
    reset_recovery()
    jax_health.reset_recovery()


def test_supervisor_budgets_and_backoff():
    calls = []

    def buggy():
        calls.append(1)
        raise ValueError("a code bug")

    with pytest.raises(ValueError):
        Supervisor(RestartPolicy(max_restarts=5, backoff_base_s=0.0)).run(buggy)
    assert len(calls) == 1
    sup = Supervisor(RestartPolicy(max_restarts=2, backoff_base_s=0.0))
    with pytest.raises(OSError):
        sup.run(_scripted([OSError("x")] * 5))
    assert sup.retries == 3
    slept = []
    sup = Supervisor(RestartPolicy(max_restarts=1, max_preemptions=5, backoff_base_s=0.0),
                     sleep=slept.append)
    assert sup.run(_scripted([Preempted(), OSError("i"), Preempted(), None])) == "done"
    assert (sup.preemptions, sup.retries, slept) == (2, 1, [])
    slept = []
    sup = Supervisor(RestartPolicy(max_restarts=5, backoff_base_s=1.0, jitter=False),
                     sleep=slept.append)
    assert sup.run(_scripted([OSError("t")] * 3 + [None])) == "done"
    assert slept == [1.0, 2.0, 4.0]
    assert run_supervised(_scripted([OSError("t"), None]),
                          policy=RestartPolicy(backoff_base_s=0.0)) == "done"


def test_prevalidation_quarantines_torn_steps_before_each_attempt(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d)
    for s in (1, 2):
        ck.save({"w": torch.arange(4.0)}, step=s)
    os.remove(os.path.join(d, "2", "_CHECKPOINT_METADATA"))
    seen = []
    tele = get_telemetry()
    token = _mark(tele)
    sup = Supervisor(RestartPolicy(backoff_base_s=0.0), checkpoint_dir=d)
    assert sup.run(lambda: seen.append(latest_step(d)) or "ok") == "ok"
    assert seen == [1] and os.path.isdir(os.path.join(d, "_quarantine", "2"))
    assert [e["step"] for e in _since(tele, token) if e["name"] == "fault/quarantine"] == [2]


def test_restart_event_carries_a_null_compile_cache(monkeypatch):
    """With the cache disabled the restart carries null."""
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", "0")
    tele = get_telemetry()
    token = _mark(tele)
    Supervisor(RestartPolicy(backoff_base_s=0.0)).run(_scripted([OSError("x"), None]))
    (restart,) = [e for e in _since(tele, token) if e["name"] == "fault/restart"]
    assert "compile_cache" in restart and restart["compile_cache"] is None


def test_restart_event_carries_the_compile_cache_dir(monkeypatch, tmp_path):
    """The supervisor enables the persistent compile cache before the
    first attempt (JAX's ``_ensure_compile_cache``): the restart carries
    its directory."""
    from tpuframe_torch.compile import cache

    prev = cache.enabled_dir()
    d = str(tmp_path / "cc")
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", d)
    tele = get_telemetry()
    token = _mark(tele)
    try:
        Supervisor(RestartPolicy(backoff_base_s=0.0)).run(_scripted([OSError("x"), None]))
    finally:
        cache.enable(prev) if prev else cache.disable()
    (restart,) = [e for e in _since(tele, token) if e["name"] == "fault/restart"]
    assert restart["compile_cache"] == d and os.path.isdir(d)


def test_run_with_restarts_classifies_preemption_separately_and_takes_an_override():
    assert run_with_restarts(_scripted([Preempted(), OSError("infra"), None]),
                             max_restarts=1, backoff_s=0.0) == "done"
    seen = []
    out = run_with_restarts(_scripted([KeyError("k"), None]), backoff_s=0.0,
                            retryable=lambda e: isinstance(e, KeyError),
                            on_restart=lambda a, e: seen.append(a))
    assert out == "done" and seen == [1]
    with pytest.raises(OSError):
        run_with_restarts(_scripted([OSError("io"), None]), retryable=lambda e: False)
