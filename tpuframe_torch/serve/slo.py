"""The serving SLO plane: declared objectives + rolling burn-rate gauges.

The port's copy of ``tpuframe/serve/slo.py``.  An SLO is a declared
contract — "p99 under ``TPUFRAME_SLO_P99_MS``, availability at least
``TPUFRAME_SLO_AVAILABILITY``" — and :class:`SloTracker` keeps a rolling
window of request outcomes and exports two gauges on the telemetry spine:

- ``slo/burn_rate`` — the rate the error budget is being consumed,
  normalized so 1.0 means "burning exactly the allowed budget".
- ``slo/error_budget`` — the remaining budget fraction over the window,
  ``max(0, 1 - burn_rate)``.

A request is bad when it failed (shed/rejected/errored) or was served
over the p99 objective.  Every tracker announces its contract as one
``slo/objectives`` event at construction.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from tpuframe_torch.fault.health import _env_float
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = ["SloObjectives", "SloTracker"]


@dataclasses.dataclass(frozen=True)
class SloObjectives:
    """The declared serving objectives (env-tunable, live-apply).

    Attributes:
      p99_ms: served-latency objective — a request slower than this is
        an SLO violation even though the client got an answer.
      availability: minimum good-request fraction; ``1 - availability``
        is the error budget the burn rate is normalized against.
    """

    p99_ms: float = 500.0
    availability: float = 0.999

    @classmethod
    def from_env(cls) -> "SloObjectives":
        """Tolerant: malformed or out-of-range env reads as the default — a
        typo'd objective must not take a serving box down."""
        d = cls()
        p99_ms = _env_float("TPUFRAME_SLO_P99_MS", d.p99_ms)
        availability = _env_float("TPUFRAME_SLO_AVAILABILITY", d.availability)
        if not p99_ms >= 1.0:
            p99_ms = d.p99_ms
        if not 0.0 < availability <= 1.0:
            availability = d.availability
        return cls(p99_ms=p99_ms, availability=availability)


class SloTracker:
    """Rolling-window burn-rate/error-budget gauges for one vantage point.

    ``observe()`` is called once per request outcome (served, shed,
    rejected or errored) and is cheap enough for
    the hot path — one deque append + two gauge stores under a lock.
    """

    def __init__(self, objectives: SloObjectives | None = None, *,
                 window_s: float = 60.0, source: str | None = None):
        self.objectives = objectives or SloObjectives.from_env()
        self.window_s = float(window_s)
        self._samples: collections.deque = collections.deque()  # (mono, bad)
        self._bad = 0
        self._lock = threading.Lock()
        tele = get_telemetry()
        self._g_burn = tele.registry.gauge("slo/burn_rate")
        self._g_budget = tele.registry.gauge("slo/error_budget")
        # announce the contract in force — the analyzer scores the dir
        # against this record, not the analyzing host's env
        tele.event(
            "slo/objectives",
            p99_ms=self.objectives.p99_ms,
            availability=self.objectives.availability,
            window_s=self.window_s,
            **({"source": source} if source else {}),
        )

    def observe(self, latency_s: float | None = None, *,
                ok: bool = True) -> None:
        """Record one request outcome: ``ok=False`` for shed/rejected/
        errored, otherwise bad iff the served latency broke the p99
        objective."""
        bad = (not ok) or (
            latency_s is not None
            and latency_s * 1e3 > self.objectives.p99_ms
        )
        now = time.monotonic()
        with self._lock:
            self._samples.append((now, bad))
            if bad:
                self._bad += 1
            self._evict_locked(now)
            burn, budget = self._rates_locked()
        self._g_burn.set(burn)
        self._g_budget.set(budget)

    def _evict_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            _, bad = self._samples.popleft()
            if bad:
                self._bad -= 1

    def _rates_locked(self) -> tuple[float, float]:
        total = len(self._samples)
        if total == 0:
            return 0.0, 1.0
        allowed = max(1e-9, 1.0 - self.objectives.availability)
        burn = (self._bad / total) / allowed
        return burn, max(0.0, 1.0 - burn)

    def snapshot(self) -> dict:
        """Current window state: objectives + counts +
        the two gauge values."""
        with self._lock:
            self._evict_locked(time.monotonic())
            total = len(self._samples)
            bad = self._bad
            burn, budget = self._rates_locked()
        return {
            "p99_ms": self.objectives.p99_ms,
            "availability": self.objectives.availability,
            "window_s": self.window_s,
            "requests": total,
            "violations": bad,
            "burn_rate": round(burn, 4),
            "error_budget_remaining": round(budget, 4),
        }
