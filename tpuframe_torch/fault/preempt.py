"""Preemption watcher: signals and a pluggable maintenance poller, one flag.

Port of ``tpuframe/fault/preempt.py``, name for name:

- :class:`PreemptionWatcher` owns a cross-thread flag.  ``install()``
  traps SIGTERM (chaining the previous callable handler) and, with a
  ``poller``, starts a daemon thread that polls it
  (:func:`gce_maintenance_poller`, or any ``() -> bool``).
- The Trainer reads the flag at step boundaries, takes one synchronous
  last-chance snapshot and raises :class:`Preempted`, a ``BaseException``
  so that ``except Exception`` recovery code cannot swallow it.
- :func:`agree` makes every rank act on the same step: one
  ``all_reduce(MAX)`` of the 0/1 flag over the default process group
  (the JAX package gathers it through its analyzer, which is not ported).

Everything but :func:`agree` is stdlib only: a notice must keep working
while the device runtime is wedged.
"""

from __future__ import annotations

import signal
import threading
from typing import Any, Callable, Iterable

from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "PREEMPTED_EXIT",
    "Preempted",
    "PreemptionWatcher",
    "active_watcher",
    "agree",
    "gce_maintenance_poller",
    "install",
    "preemption_requested",
    "reraise_for_exit",
    "uninstall",
]

#: The exit code of a preempted worker: 128 + SIGTERM, apart from a crash
#: (1) and a SIGKILL (-9), so a restart policy that sees only the process
#: can tell "the platform took the machine" from "the code broke".
PREEMPTED_EXIT = 143


class Preempted(BaseException):
    """Raised at a step boundary after the last-chance checkpoint landed.
    A control signal, not an error: the supervisor restarts it from its own
    budget, without backoff."""

    def __init__(self, reason: str = "preempted", *, step: int | None = None,
                 checkpoint: str | None = None):
        super().__init__(reason)
        self.reason = reason
        self.step = step
        self.checkpoint = checkpoint

    def __repr__(self):
        return f"Preempted({self.reason!r}, step={self.step}, checkpoint={self.checkpoint!r})"


class PreemptionWatcher:
    """Cross-thread preemption flag fed by signals and/or a poller.

    Args:
      signals: signal numbers trapped by :meth:`install` (default SIGTERM).
      poller: optional ``() -> bool`` polled from a daemon thread every
        ``poll_interval_s`` until it first returns True; its exceptions are
        swallowed (a flaky metadata server must not end training).
      poll_interval_s: the poller's cadence.
    """

    def __init__(self, *, signals: Iterable[int] = (signal.SIGTERM,),
                 poller: Callable[[], bool] | None = None, poll_interval_s: float = 5.0):
        self.signals = tuple(signals)
        self.poller = poller
        self.poll_interval_s = float(poll_interval_s)
        self.reason: str | None = None
        self._event = threading.Event()
        self._notice_pending = False  # telemetry owed for a signal's notice
        self._prev_handlers: dict[int, Any] = {}
        self._poll_thread: threading.Thread | None = None
        self._stop_poll = threading.Event()
        self._installed = False

    # -- the flag ------------------------------------------------------------
    @property
    def requested(self) -> bool:
        if self._event.is_set():
            self._flush_notice()
        return self._event.is_set()

    def request(self, reason: str = "requested") -> None:
        """Set the flag (poller thread, chaos injector, orchestrator); the
        first reason wins."""
        if self._event.is_set():
            return
        self.reason = reason
        self._event.set()
        tele = get_telemetry()
        tele.registry.counter("fault/preempt_notices").inc()
        tele.event("fault/preempt_notice", reason=reason)

    def _flush_notice(self) -> None:
        """Emit the telemetry a signal's notice deferred (in ordinary thread
        context, never inside the handler)."""
        if self._notice_pending:
            self._notice_pending = False
            tele = get_telemetry()
            tele.registry.counter("fault/preempt_notices").inc()
            tele.event("fault/preempt_notice", reason=self.reason)

    def wait(self, timeout: float | None = None) -> bool:
        hit = self._event.wait(timeout)
        if hit:
            self._flush_notice()
        return hit

    def clear(self) -> None:
        """Re-arm after the notice was acted on; restarts the poll thread,
        which ends on its first positive poll."""
        self._flush_notice()
        self._event.clear()
        self.reason = None
        if self._installed and self.poller is not None:
            self._start_poll_thread()

    # -- wiring --------------------------------------------------------------
    def install(self) -> "PreemptionWatcher":
        """Trap the signals (on the main thread only; elsewhere skipped) and
        start the poll thread; registers as the process-wide watcher when
        there is none, so the supervisor can clear its flag.  Idempotent."""
        global _ACTIVE
        if self._installed:
            return self
        for sig in self.signals:
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread
                break
        if self.poller is not None:
            self._start_poll_thread()
        self._installed = True
        with _LOCK:
            if _ACTIVE is None:
                _ACTIVE = self
        return self

    def _start_poll_thread(self) -> None:
        if self._poll_thread is not None and self._poll_thread.is_alive():
            return
        self._stop_poll.clear()
        self._poll_thread = threading.Thread(target=self._poll_loop,
                                             name="tpuframe-torch-preempt-poll", daemon=True)
        self._poll_thread.start()

    def uninstall(self) -> None:
        """Restore the previous handlers and stop the poller."""
        global _ACTIVE
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers.clear()
        self._stop_poll.set()
        self._installed = False
        with _LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def _on_signal(self, signum, frame) -> None:
        # The handler runs between bytecodes on the main thread, possibly
        # inside a frame that holds the telemetry's locks: it only sets the
        # flag and leaves the telemetry to the first ordinary reader.
        if not self._event.is_set():
            self.reason = self.reason or f"signal:{signal.Signals(signum).name}"
            self._notice_pending = True
            self._event.set()
        prev = self._prev_handlers.get(signum)
        if callable(prev) and prev not in (signal.default_int_handler,):
            prev(signum, frame)

    def add_signals(self, signals: Iterable[int]) -> None:
        """Trap more signals on an installed watcher."""
        for sig in signals:
            if sig in self._prev_handlers:
                continue
            try:
                prev = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread
                return
            self._prev_handlers[sig] = prev
            if sig not in self.signals:
                self.signals = self.signals + (sig,)

    def add_poller(self, poller: Callable[[], bool],
                   poll_interval_s: float | None = None) -> None:
        """Attach (or replace) the poller; starts polling when installed."""
        self.poller = poller
        if poll_interval_s is not None:
            self.poll_interval_s = float(poll_interval_s)
        if self._installed:
            self._start_poll_thread()

    def _poll_loop(self) -> None:
        while not self._stop_poll.wait(self.poll_interval_s):
            if self._event.is_set():
                return
            try:
                if self.poller():
                    self.request("maintenance-poll")
                    return
            except Exception:
                pass  # a flaky endpoint: keep polling


def gce_maintenance_poller(
    url: str = "http://metadata.google.internal/computeMetadata/v1/instance/maintenance-event",
    timeout_s: float = 1.0,
    fetch: Callable[[str, float], str] | None = None,
) -> Callable[[], bool]:
    """Poller of a GCE-style metadata server's maintenance event: True when
    the value is anything but ``NONE``; an unreachable server reads as no
    event.  ``fetch(url, timeout_s) -> str`` replaces the HTTP read (a
    test, another provider's endpoint)."""

    def http_fetch(u: str, t: float) -> str:
        import urllib.request

        req = urllib.request.Request(u, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=t) as resp:
            return resp.read().decode()

    read = fetch or http_fetch

    def poll() -> bool:
        try:
            return read(url, timeout_s).strip().upper() not in ("", "NONE")
        except Exception:
            return False

    return poll


# -- the process-wide watcher -------------------------------------------------

_ACTIVE: PreemptionWatcher | None = None
_LOCK = threading.Lock()


def install(*, signals: Iterable[int] = (signal.SIGTERM,),
            poller: Callable[[], bool] | None = None,
            poll_interval_s: float = 5.0) -> PreemptionWatcher:
    """Install (or return) the process-wide watcher; a request to an
    existing one is merged into it (extra signals trapped, the poller
    attached)."""
    w = _ACTIVE
    if w is None:
        w = PreemptionWatcher(signals=signals, poller=poller,
                              poll_interval_s=poll_interval_s).install()
        return _ACTIVE or w
    w.add_signals(signals)
    if poller is not None and poller is not w.poller:
        w.add_poller(poller, poll_interval_s)
    return w


def active_watcher() -> PreemptionWatcher | None:
    """The installed process-wide watcher, if any (never creates one)."""
    return _ACTIVE


def uninstall() -> None:
    """Drop the process-wide watcher."""
    global _ACTIVE
    with _LOCK:
        w, _ACTIVE = _ACTIVE, None
    if w is not None:
        w.uninstall()


def preemption_requested() -> bool:
    w = _ACTIVE
    return w is not None and w.requested


def reraise_for_exit(e: BaseException) -> None:
    """Worker epilogue, after its outcome frame is written: :class:`Preempted`
    becomes ``SystemExit(PREEMPTED_EXIT)``; anything else re-raises as it
    is."""
    if isinstance(e, Preempted):
        raise SystemExit(PREEMPTED_EXIT) from e
    raise e


def agree(local_flag: bool) -> bool:
    """True on every rank iff the flag is set on any: one ``all_reduce(MAX)``
    of a 0/1 flag over the default process group when one is initialized
    with more than one rank, the local flag otherwise.  Every rank calls it
    at the same step boundary."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return bool(local_flag)
    device = "cpu"
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    flag = torch.tensor([1 if local_flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())
