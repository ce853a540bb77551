"""Deterministic chaos injection: seeded faults at named call sites.

Port of ``tpuframe/fault/chaos.py``, name for name.  Instrumented call
sites ask the active :class:`ChaosPlan` whether a fault is scheduled for
``(site, step)`` and the plan fires it: raise, stall, tear a checkpoint,
kill the process, lose a rank, poison a batch, flood the serve queue, or
trip the preemption watcher.  Plans come from explicit injector lists or
from a seed (:meth:`ChaosPlan.scheduled`, the same ``random.Random`` draws
as the JAX package's), so a failing chaos run reproduces exactly.

The sites the port instruments are :data:`CHAOS_SITES`; with no active
plan a site costs one global read.  A test of the port holds the table
against every literal ``maybe_fire``/``site`` call under
``tpuframe_torch/`` (an AST scan), as the JAX package's linter does.  Every
firing ticks ``fault/chaos_injections`` and emits one
``fault/chaos_injected`` event before the fault acts.

Processes: a plan lives in the process that activated it.  A
:class:`LoseRank` fired inside a launcher's worker registers its ranks in
that worker's lost set and raises :class:`RankLostError`, which carries
them (``ranks``); ``launch.elastic.run_elastic`` registers them in the
launching process from the error the launcher surfaces.

Stdlib only; imports neither torch nor numpy.
"""

from __future__ import annotations

import contextlib
import os
import random
import signal
import threading
import time
from typing import Any, Iterable, Iterator, Mapping, Sequence

from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "CHAOS_SITES",
    "ChaosError",
    "ChaosPlan",
    "Injector",
    "KillWorker",
    "LoseRank",
    "NaNAt",
    "OomAt",
    "OomError",
    "PoisonRequest",
    "PreemptNotice",
    "QueueFlood",
    "RaiseAt",
    "RankLostError",
    "ReplicaKill",
    "SlowConsumer",
    "SpikeAt",
    "StallAt",
    "TornCheckpoint",
    "UnhealthyPromotion",
    "active_plan",
    "lost_ranks",
    "maybe_fire",
    "reset_lost_ranks",
    "site",
]


#: The sites the port instruments, each with where it asks the active plan.
#: The JAX package's ``fleet/*`` rows come with the port's serving fleet.
CHAOS_SITES = {
    "loader": "Trainer._run_epoch, before pulling the next host batch",
    "batch": (
        "Trainer host pipeline, on the assembled numpy train batch (ctx: "
        "images) before its copy to the device: where NaNAt/SpikeAt poison "
        "the data the step eats"
    ),
    "step": (
        "Trainer._run_epoch (and example 01 MNIST's step loop), before "
        "dispatching the train step"
    ),
    "ckpt/save": (
        "Checkpointer.save, before the write (inside the transient-IO retry "
        "window)"
    ),
    "ckpt/saved": (
        "Checkpointer.save, after the commit (ctx: path): where "
        "TornCheckpoint tears the commit marker"
    ),
    "serve/submit": (
        "ServeEngine.submit, before door validation (ctx: payload, engine): "
        "where PoisonRequest corrupts the payload validation must reject"
    ),
    "serve/enqueue": (
        "ServeEngine.submit, after validation and before admission (ctx: "
        "engine): where QueueFlood floods the bounded queue"
    ),
    "serve/batch": "ServeEngine batcher, before batch assembly (ctx: n, bucket, engine)",
    "serve/infer": (
        "ServeEngine batcher, inside the backend-call span: where "
        "SlowConsumer wedges the backend under the serve watchdog lease"
    ),
}


class ChaosError(OSError):
    """The default injected failure: an OSError, so the stock classifier
    treats it as retryable infrastructure."""


class RankLostError(ChaosError):
    """A peer rank died under the fleet, as the survivors' next collective
    surfaces it.  ``ranks`` names the lost ranks (empty when unknown), so a
    process that did not fire the injector can register them."""

    def __init__(self, *args: Any, ranks: Iterable[int] = ()):
        super().__init__(*args)
        self.ranks = tuple(int(r) for r in ranks)


class Injector:
    """One scheduled fault.

    Args:
      site: instrumented call-site name (:data:`CHAOS_SITES`).
      step: fire when the site reports this step; None = first visit.
      times: how many visits fire (default 1).
    """

    def __init__(self, site: str, step: int | None = None, *, times: int = 1):
        self.site = site
        self.step = step
        self.times = times
        self.fired = 0

    def matches(self, site: str, step: int | None) -> bool:
        if self.fired >= self.times or site != self.site:
            return False
        return self.step is None or step == self.step

    def fire(self, ctx: Mapping[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def describe(self) -> str:
        return f"{type(self).__name__}(site={self.site!r}, step={self.step})"


class RaiseAt(Injector):
    """Raise at the site (default :class:`ChaosError`, retryable).  ``exc``
    may be an exception instance or type; a fatal type (``ValueError``...)
    drives the no-retry path."""

    def __init__(self, site: str, step: int | None = None, *,
                 exc: BaseException | type = None, times: int = 1):
        super().__init__(site, step, times=times)
        self.exc = exc

    def fire(self, ctx: Mapping[str, Any]) -> None:
        exc = self.exc
        if exc is None:
            exc = ChaosError(f"chaos: injected failure at {self.site} step {ctx.get('step')}")
        elif isinstance(exc, type):
            exc = exc(f"chaos: injected {exc.__name__} at {self.site}")
        raise exc


class OomError(ChaosError):
    """Synthetic allocation failure whose message carries XLA's
    ``RESOURCE_EXHAUSTED`` status name, as the JAX package's does; still a
    :class:`ChaosError` (retryable)."""


class OomAt(Injector):
    """Raise a synthetic ``RESOURCE_EXHAUSTED`` at the site (default
    ``step``)."""

    def __init__(self, site: str = "step", step: int | None = None, *, times: int = 1):
        super().__init__(site, step, times=times)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        raise OomError(
            "chaos: RESOURCE_EXHAUSTED: injected out-of-memory at "
            f"{self.site} step {ctx.get('step')} (synthetic, OomAt)")


class StallAt(Injector):
    """Sleep ``stall_s`` at the site: a wedged step or collective in
    miniature, for the stall watchdog."""

    def __init__(self, site: str, step: int | None = None, *, stall_s: float = 1.0,
                 times: int = 1):
        super().__init__(site, step, times=times)
        self.stall_s = float(stall_s)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        time.sleep(self.stall_s)


class TornCheckpoint(Injector):
    """Tear the just-written step: remove its commit marker (what a kill
    between the data write and the commit leaves).  Fires at
    ``ckpt/saved`` (ctx ``path``).  A save with ``async_save=True`` has
    no marker yet when the site fires, so the drill raises rather than
    passing vacuously."""

    def __init__(self, step: int | None = None, *, times: int = 1):
        super().__init__("ckpt/saved", step, times=times)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        from tpuframe_torch.ckpt.meta import COMMIT_MARKERS

        path = ctx.get("path")
        if not path:
            return
        torn = False
        for marker in COMMIT_MARKERS:
            try:
                os.remove(os.path.join(path, marker))
                torn = True
            except FileNotFoundError:
                pass
        if not torn:
            raise RuntimeError(
                f"TornCheckpoint fired at {path} but found no commit marker to tear: "
                "async_save=True? (the marker lands after this site fires; tear a "
                "synchronous save instead)")


class KillWorker(Injector):
    """Kill this process at the site (default SIGKILL: no handlers, no
    atexit).  For launcher workers; in process use :class:`RaiseAt`."""

    def __init__(self, site: str, step: int | None = None, *, sig: int = signal.SIGKILL,
                 times: int = 1):
        super().__init__(site, step, times=times)
        self.sig = sig

    def fire(self, ctx: Mapping[str, Any]) -> None:
        os.kill(os.getpid(), self.sig)


class LoseRank(Injector):
    """Lose rank(s) from the fleet at a step, from the survivors' point of
    view: the ranks join the process-wide lost set (which the capacity
    probes of ``launch.elastic`` subtract) and :class:`RankLostError` is
    raised at the site.  The loss persists across supervised restarts and
    is cleared when the plan deactivates.  ``rank`` is an int or an
    iterable of ints."""

    def __init__(self, rank: int | Sequence[int], at_step: int | None = None, *,
                 site: str = "step", times: int = 1):
        super().__init__(site, at_step, times=times)
        self.ranks = (tuple(rank) if isinstance(rank, (tuple, list, set, frozenset))
                      else (int(rank),))

    def fire(self, ctx: Mapping[str, Any]) -> None:
        register_lost_ranks(self.ranks)
        raise RankLostError(
            f"chaos: rank(s) {sorted(self.ranks)} lost at {self.site} step {ctx.get('step')}",
            ranks=self.ranks)

    def describe(self) -> str:
        return f"LoseRank(ranks={sorted(self.ranks)}, site={self.site!r}, step={self.step})"


class _BatchPoison(Injector):
    """Base of :class:`NaNAt` and :class:`SpikeAt`: fire at ``batch`` and
    corrupt the host numpy batch in place, before its copy to the device.

    Poison window: an explicit ``step`` with ``times=n`` poisons the ``n``
    consecutive batches ``[step, step + n)``."""

    def matches(self, site: str, step: int | None) -> bool:
        if self.fired >= self.times or site != self.site:
            return False
        if self.step is None:
            return True
        return step is not None and self.step <= step < self.step + self.times

    def _images(self, ctx: Mapping[str, Any]):
        images = ctx.get("images")
        # ValueError: a misconfigured drill is FATAL-class, surfaced at once
        if images is None:
            raise ValueError(
                f"{type(self).__name__} fired at site {self.site!r} which carries no host "
                "image batch — schedule it at the 'batch' site")
        if getattr(images.dtype, "kind", None) != "f":
            raise ValueError(
                f"{type(self).__name__} cannot poison a {images.dtype} batch (uint8 "
                "transfer can't represent the poison) — use a float transfer_dtype for this "
                "chaos run instead of letting the test pass vacuously")
        return images

    def describe(self) -> str:
        span = (f"steps [{self.step}, {self.step + self.times})" if self.step is not None
                else f"first {self.times} visit(s)")
        return f"{type(self).__name__}(site={self.site!r}, {span})"


class NaNAt(_BatchPoison):
    """Write NaN into the host batch's first sample: the step's loss and
    gradients go non-finite and the sentinel skips the update."""

    def __init__(self, site: str = "batch", step: int | None = None, *, times: int = 1):
        super().__init__(site, step, times=times)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        self._images(ctx)[0].fill(float("nan"))


class SpikeAt(_BatchPoison):
    """Scale the host batch by ``scale``: a finite, blown-up loss for the
    EWMA spike test."""

    def __init__(self, site: str = "batch", step: int | None = None, *, scale: float = 1e4,
                 times: int = 1):
        super().__init__(site, step, times=times)
        self.scale = float(scale)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        images = self._images(ctx)
        images *= self.scale


class QueueFlood(Injector):
    """Flood the serve engine's bounded queue with ``n`` synthetic requests
    (``ServeEngine.flood``).  Fires at ``serve/enqueue`` (ctx ``engine``);
    ``step`` counts submitted requests."""

    def __init__(self, n: int = 64, step: int | None = None, *, site: str = "serve/enqueue",
                 deadline_ms: float | None = None, times: int = 1):
        super().__init__(site, step, times=times)
        self.n = int(n)
        self.deadline_ms = deadline_ms

    def fire(self, ctx: Mapping[str, Any]) -> None:
        engine = ctx.get("engine")
        if engine is None or not hasattr(engine, "flood"):
            raise ValueError(
                f"QueueFlood fired at site {self.site!r} which carries no serve engine — "
                "schedule it at the 'serve/enqueue' site")
        engine.flood(self.n, deadline_ms=self.deadline_ms)

    def describe(self) -> str:
        return f"QueueFlood(n={self.n}, site={self.site!r}, step={self.step})"


class SlowConsumer(Injector):
    """Sleep ``stall_s`` inside the ``serve/infer`` span: a hung model call
    under the serve watchdog lease."""

    def __init__(self, step: int | None = None, *, stall_s: float = 1.0,
                 site: str = "serve/infer", times: int = 1):
        super().__init__(site, step, times=times)
        self.stall_s = float(stall_s)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        time.sleep(self.stall_s)


class PoisonRequest(Injector):
    """Write NaN into one submitted payload before door validation, which
    must reject it.  Fires at ``serve/submit`` (ctx ``payload``); float
    payloads only."""

    def __init__(self, step: int | None = None, *, site: str = "serve/submit",
                 times: int = 1):
        super().__init__(site, step, times=times)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        payload = ctx.get("payload")
        if payload is None:
            raise ValueError(
                f"PoisonRequest fired at site {self.site!r} which carries no request "
                "payload — schedule it at the 'serve/submit' site")
        if getattr(payload.dtype, "kind", None) != "f":
            raise ValueError(
                f"PoisonRequest cannot poison a {payload.dtype} payload (integer transfer "
                "can't represent NaN) — use a float request dtype for this chaos run")
        # .flat writes in place on any layout
        payload.flat[0] = float("nan")


class PreemptNotice(Injector):
    """Trip the process-wide preemption watcher (installing one if none
    is): a deterministic SIGTERM.  The Trainer takes its last-chance
    snapshot at the next step boundary."""

    def __init__(self, site: str = "step", step: int | None = None, *, times: int = 1):
        super().__init__(site, step, times=times)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        from tpuframe_torch.fault import preempt

        watcher = preempt.active_watcher()
        if watcher is None:
            watcher = preempt.install()
        watcher.request("chaos:PreemptNotice")


class ReplicaKill(Injector):
    """Kill one live serving replica (ctx ``replicas``, the live slots):
    the fleet's site, which comes with the port's serving fleet."""

    def __init__(self, step: int | None = None, *, replica: int = 0,
                 site: str = "fleet/replica", times: int = 1):
        super().__init__(site, step, times=times)
        self.replica = int(replica)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        replicas = ctx.get("replicas")
        if not replicas:
            raise ValueError(
                f"ReplicaKill fired at site {self.site!r} with no live replicas — schedule "
                "it at the 'fleet/replica' site of a started ReplicaSet")
        slot = replicas[self.replica % len(replicas)]
        slot.kill(ChaosError(
            f"chaos: ReplicaKill took replica {slot.idx} (gen {slot.gen}) at tick "
            f"{ctx.get('step')}"))

    def describe(self) -> str:
        return f"ReplicaKill(replica={self.replica}, site={self.site!r}, step={self.step})"


class UnhealthyPromotion(Injector):
    """Taint the promotion candidate (ctx ``candidate``, a mutable gate
    dict): the fleet's site, which comes with the port's serving fleet."""

    def __init__(self, step: int | None = None, *, site: str = "fleet/promote",
                 times: int = 1):
        super().__init__(site, step, times=times)

    def fire(self, ctx: Mapping[str, Any]) -> None:
        candidate = ctx.get("candidate")
        if candidate is None:
            raise ValueError(
                f"UnhealthyPromotion fired at site {self.site!r} which carries no "
                "promotion candidate — schedule it at the 'fleet/promote' site")
        candidate["taint"] = "chaos: UnhealthyPromotion drill (dirty health stamp)"


class ChaosPlan:
    """An ordered set of injectors and their activation.

    Explicit: ``ChaosPlan([RaiseAt("loader", step=5)])``.  Seeded:
    :meth:`scheduled` draws the steps from a seed.
    """

    def __init__(self, injectors: Sequence[Injector] = ()):
        self.injectors = list(injectors)
        self._lock = threading.Lock()

    @classmethod
    def scheduled(cls, seed: int, *, max_step: int,
                  sites: Mapping[str, type | Injector] | Sequence[str] = ("loader",),
                  min_step: int = 1) -> "ChaosPlan":
        """One injector per site at a seed-determined step in ``[min_step,
        max_step)``, drawn in sorted site order.  ``sites`` maps a site to an
        injector class (default :class:`RaiseAt`) or instance (which keeps
        its other knobs and moves to the site and the drawn step)."""
        rng = random.Random(seed)
        if not isinstance(sites, Mapping):
            sites = {s: RaiseAt for s in sites}
        injectors: list[Injector] = []
        for name, kind in sorted(sites.items()):
            step = rng.randrange(min_step, max(max_step, min_step + 1))
            if isinstance(kind, Injector):
                kind.site = name
                kind.step = step
                injectors.append(kind)
            else:
                injectors.append(kind(name, step) if kind is not TornCheckpoint else kind(step))
        return cls(injectors)

    def maybe_fire(self, site_name: str, step: int | None = None, **ctx: Any) -> None:
        """Fire every matching injector, each at most once a visit.  The
        telemetry precedes each fire (a KillWorker leaves its event first),
        and an injector is charged only as it fires: when one raises, the
        later ones keep their budget."""
        with self._lock:
            matched = [i for i in self.injectors if i.matches(site_name, step)]
        for inj in matched:
            with self._lock:
                if not inj.matches(site_name, step):  # its budget raced away
                    continue
                inj.fired += 1
            tele = get_telemetry()
            tele.registry.counter("fault/chaos_injections").inc()
            tele.event("fault/chaos_injected", site=site_name, step=step,
                       injector=type(inj).__name__)
            inj.fire({"site": site_name, "step": step, **ctx})

    def fired_count(self) -> int:
        with self._lock:
            return sum(inj.fired for inj in self.injectors)

    @contextlib.contextmanager
    def active(self) -> Iterator["ChaosPlan"]:
        """Activate for the block, process-wide.  Plans do not nest; the lost
        set is cleared when the block ends."""
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a ChaosPlan is already active")
            _ACTIVE = self
        try:
            yield self
        finally:
            with _ACTIVE_LOCK:
                _ACTIVE = None
            reset_lost_ranks()


# -- lost-rank registry (LoseRank's world damage) -----------------------------

_LOST_RANKS: set[int] = set()
_LOST_LOCK = threading.Lock()


def lost_ranks() -> frozenset[int]:
    """Ranks removed from the fleet by :class:`LoseRank`: what a simulated
    capacity probe subtracts from the original world."""
    with _LOST_LOCK:
        return frozenset(_LOST_RANKS)


def register_lost_ranks(ranks: Iterable[int]) -> None:
    """Add ranks to the lost set (:class:`LoseRank`, and ``run_elastic``
    for a loss a worker process reported)."""
    with _LOST_LOCK:
        _LOST_RANKS.update(int(r) for r in ranks)


def forget_lost_ranks(ranks: Iterable[int]) -> None:
    """Take ranks out of the lost set (``run_elastic`` on its way out, for
    the ranks it registered)."""
    with _LOST_LOCK:
        _LOST_RANKS.difference_update(int(r) for r in ranks)


def reset_lost_ranks() -> None:
    """Clear the lost set (plan deactivation does this)."""
    with _LOST_LOCK:
        _LOST_RANKS.clear()


# -- call-site hooks ----------------------------------------------------------

_ACTIVE: ChaosPlan | None = None
_ACTIVE_LOCK = threading.Lock()


def active_plan() -> ChaosPlan | None:
    return _ACTIVE


def maybe_fire(site_name: str, step: int | None = None, **ctx: Any) -> None:
    """The call-site hook: one global read unless a plan is active."""
    plan = _ACTIVE
    if plan is not None:
        plan.maybe_fire(site_name, step, **ctx)


@contextlib.contextmanager
def site(site_name: str, step: int | None = None, **ctx: Any) -> Iterator[None]:
    """Context-manager form of :func:`maybe_fire` for wrapping a region."""
    maybe_fire(site_name, step, **ctx)
    yield
