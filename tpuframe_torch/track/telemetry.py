"""Process-wide telemetry spine: spans, metrics registry, JSONL event log.

The port's copy of the part of ``tpuframe/track/telemetry.py`` that the
serve and train paths use, with the same event names, metric names and
JSONL schema, so the JAX package's ``track analyze`` reads logs from either
side:

- :meth:`Telemetry.span` — nestable, thread-safe ``with`` regions on the
  monotonic clock; each feeds a ``span/<name>`` duration histogram and,
  with a sink, one rank-tagged JSONL record.
- :class:`MetricsRegistry` — counters, gauges and bounded-reservoir
  histograms, exported as a Prometheus text page.
- The JSONL event log, one file per rank (``events-rank<N>.jsonl``),
  enabled by ``TPUFRAME_TELEMETRY_DIR`` or :func:`configure`.  It opens
  with a ``meta`` record holding a wall/monotonic clock anchor pair.

The logger bridge: :func:`publish_to_loggers` and
:class:`MetricsExportCallback` hand the registry's snapshot to any logger
with ``log_metrics(dict, step=)`` (the TensorBoard and MLflow loggers).
Log rotation waits for a later slice.

Env knobs::

    TPUFRAME_TELEMETRY_DIR       write events-rank<N>.jsonl under this dir
    TPUFRAME_WATCHDOG_S          attach a stall watchdog; default deadline
    TPUFRAME_WATCHDOG_DEADLINES  per-activity overrides, "serve/infer=30"
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Iterator, Mapping, Sequence

from tpuframe_torch.track.watchdog import Watchdog

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsExportCallback",
    "MetricsRegistry",
    "Span",
    "Telemetry",
    "configure",
    "get_telemetry",
    "publish_to_loggers",
    "reset",
]

#: the JSONL record shape, shared with the JAX package
SCHEMA_VERSION = 1

#: the observability and fault knobs the port reads, shipped by the remote
#: launcher to every host (``launch.all_env_vars``): the JAX package's list
#: less the straggler and serving-fleet knobs, which nothing in the port
#: reads yet
OBSERVABILITY_ENV_VARS = (
    "TPUFRAME_TELEMETRY_DIR",
    "TPUFRAME_WATCHDOG_S",
    "TPUFRAME_WATCHDOG_DEADLINES",
    "TPUFRAME_PREEMPT_SIGNALS",
)


def _env_rank() -> int:
    """Process rank from the launch env."""
    for var in ("TPUFRAME_PROCESS_ID", "RANK"):
        v = os.environ.get(var, "")
        if v.isdigit():
            return int(v)
    return 0


# -- metrics registry ---------------------------------------------------------


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Lifetime count/sum + a ring of the most recent ``max_samples``
    observations for percentiles."""

    __slots__ = ("name", "max_samples", "count", "total", "_ring", "_lock")

    def __init__(self, name: str, max_samples: int = 2048):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.name = name
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self._ring: list[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = self.count % self.max_samples
            self.count += 1
            self.total += v
            if len(self._ring) < self.max_samples:
                self._ring.append(v)
            else:
                self._ring[i] = v  # overwrite oldest: insertion-order ring

    def window(self) -> list[float]:
        """The retained (most recent) observations, unordered."""
        with self._lock:
            return list(self._ring)

    @staticmethod
    def _quantile(sorted_vals: Sequence[float], q: float) -> float:
        return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]

    def summary(self) -> dict[str, float]:
        """count/mean over the lifetime, p50/p95/p99 over the recent window."""
        with self._lock:
            vals, count, total = sorted(self._ring), self.count, self.total
        if not vals:
            return {}
        return {
            "count": float(count),
            "mean": total / count,
            "p50": self._quantile(vals, 0.50),
            "p95": self._quantile(vals, 0.95),
            "p99": self._quantile(vals, 0.99),
        }


class MetricsRegistry:
    """Name -> instrument table; get-or-create, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, max_samples: int = 2048) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, max_samples)
            return h

    def snapshot(self, prefix: str = "") -> dict[str, float]:
        """Flat ``{name: value}`` dict, the shape ``log_metrics`` takes.

        Histograms expand to ``<name>_count/_mean/_p50/_p95/_p99``.
        """
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        out: dict[str, float] = {}
        for c in counters:
            out[f"{prefix}{c.name}"] = c.value
        for g in gauges:
            out[f"{prefix}{g.name}"] = g.value
        for h in hists:
            for k, v in h.summary().items():
                out[f"{prefix}{h.name}_{k}"] = v
        return out

    @staticmethod
    def _prom_name(name: str) -> str:
        sane = "".join(ch if ch.isalnum() else "_" for ch in name)
        return f"tpuframe_{sane}"

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version=0.0.4);
        histograms export as summaries over the recent window."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        lines: list[str] = []
        for c in counters:
            n = self._prom_name(c.name)
            lines += [f"# TYPE {n} counter", f"{n} {c.value}"]
        for g in gauges:
            n = self._prom_name(g.name)
            lines += [f"# TYPE {n} gauge", f"{n} {g.value}"]
        for h in hists:
            n = self._prom_name(h.name)
            s = h.summary()
            if not s:
                continue
            lines.append(f"# TYPE {n} summary")
            for q in ("p50", "p95", "p99"):
                lines.append(f'{n}{{quantile="0.{q[1:]}"}} {s[q]}')
            lines += [f"{n}_sum {h.total}", f"{n}_count {int(s['count'])}"]
        return "\n".join(lines) + "\n"


# -- spans --------------------------------------------------------------------


class Span:
    """Handle yielded by :meth:`Telemetry.span`; ``elapsed`` is valid after
    the ``with`` block exits."""

    __slots__ = ("name", "attrs", "stack", "elapsed", "ok", "error", "_t0")

    def __init__(self, name: str, attrs: Mapping[str, Any]):
        self.name = name
        self.attrs = dict(attrs)
        self.stack: list[str] = []
        self.elapsed = 0.0
        self.ok = True
        self.error: str | None = None
        self._t0 = 0.0

    def __repr__(self):
        return f"Span({self.name!r}, elapsed={self.elapsed:.6f}, ok={self.ok})"


class Telemetry:
    """One process-wide spine: span stacks, registry, ring buffer, JSONL sink.

    Args:
      jsonl_path: event-log file (appended, one JSON object per line).
        None = memory-only (ring buffer + registry, no file I/O).
      rank: tag on every record; defaults to the launch env's rank.
      max_events: ring-buffer length (the watchdog dumps its tail).
      registry: share an existing :class:`MetricsRegistry`.
      watchdog: a ``track.watchdog.Watchdog`` to attach.
      span_histograms: observe every span duration into ``span/<name>``.
    """

    def __init__(
        self,
        jsonl_path: str | None = None,
        *,
        rank: int | None = None,
        max_events: int = 512,
        registry: MetricsRegistry | None = None,
        watchdog: Any = None,
        span_histograms: bool = True,
    ):
        self.jsonl_path = jsonl_path
        self.rank = _env_rank() if rank is None else int(rank)
        self.registry = registry or MetricsRegistry()
        self.span_histograms = span_histograms
        self.anchor_wall = time.time()
        self.anchor_mono = time.monotonic()
        self._recent: deque[dict] = deque(maxlen=max_events)
        # _lock guards in-memory state only and is never held across file
        # I/O, so a stall report never waits on a hung sink; _io_lock
        # serializes the writes alone
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._file: Any = None
        # live span stacks by thread ident, readable by the watchdog thread
        self._active: dict[int, list[Span]] = {}
        self.watchdog = None
        if watchdog is not None:
            self.attach_watchdog(watchdog)
        if self.jsonl_path is not None:
            self._write(self._meta_fields())

    def _meta_fields(self) -> dict:
        try:
            hostname = socket.gethostname()
        except OSError:
            hostname = ""
        return {
            "kind": "meta",
            "name": "telemetry/meta",
            "schema": SCHEMA_VERSION,
            "hostname": hostname,
            "anchor_wall": round(self.anchor_wall, 6),
            "anchor_mono": round(self.anchor_mono, 6),
        }

    def attach_watchdog(self, watchdog: Any) -> Any:
        """Adopt ``watchdog``: it reads this telemetry's spans and events for
        its reports, and :meth:`guard` routes through it."""
        self.watchdog = watchdog
        watchdog.telemetry = self
        return watchdog

    @contextlib.contextmanager
    def span(self, name: str, *, emit: bool = True, **attrs: Any) -> Iterator[Span]:
        """Time a region; nestable, exception-transparent.  ``emit=False``
        keeps the histogram and live-stack visibility but writes no record."""
        sp = Span(name, attrs)
        ident = threading.get_ident()
        with self._lock:
            stack = self._active.setdefault(ident, [])
            stack.append(sp)
            sp.stack = [s.name for s in stack]
        sp._t0 = time.perf_counter()
        try:
            yield sp
        except BaseException as e:
            sp.ok = False
            sp.error = f"{type(e).__name__}: {e}"[:300]
            raise
        finally:
            sp.elapsed = time.perf_counter() - sp._t0
            with self._lock:
                stack = self._active.get(ident)
                if stack:
                    if stack[-1] is sp:
                        stack.pop()
                    elif sp in stack:  # mis-nested exit: drop just this span
                        stack.remove(sp)
                    if not stack:
                        del self._active[ident]
            if self.span_histograms:
                self.registry.histogram(f"span/{name}").observe(sp.elapsed)
            if emit:
                rec = {
                    "kind": "span",
                    "name": name,
                    "stack": sp.stack,
                    "dur_s": round(sp.elapsed, 6),
                    "ok": sp.ok,
                }
                if sp.error:
                    rec["error"] = sp.error
                if attrs:
                    rec["attrs"] = attrs
                self._write(rec)

    def active_spans(self) -> dict[str, list[str]]:
        """``{thread_name (ident): [span names, outermost first]}``."""
        names = {t.ident: t.name for t in threading.enumerate()}
        with self._lock:
            return {
                f"{names.get(ident, '?')} ({ident})": [s.name for s in stack]
                for ident, stack in self._active.items()
                if stack
            }

    def guard(self, name: str, deadline_s: float | None = None):
        """Watchdog lease for a bounded activity (no-op without a watchdog
        or a resolvable deadline)."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.guard(name, deadline_s)

    def event(self, name: str, *, kind: str = "event", **fields: Any) -> None:
        """Append a free-form record."""
        self._write({"kind": kind, "name": name, **fields})

    def recent_events(self, n: int = 50) -> list[dict]:
        with self._lock:
            return list(self._recent)[-n:]

    def _envelope(self, rec: dict) -> dict:
        return {
            "v": SCHEMA_VERSION,
            "ts": round(time.time(), 6),
            "mono": round(time.monotonic(), 6),
            "rank": self.rank,
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
            **rec,
        }

    def _write(self, rec: dict) -> None:
        rec = self._envelope(rec)
        with self._lock:
            self._recent.append(rec)
        if self.jsonl_path is None:
            return
        line = json.dumps(rec, default=str) + "\n"
        with self._io_lock:
            if self.jsonl_path is None:  # closed while we waited
                return
            try:
                if self._file is None:
                    d = os.path.dirname(self.jsonl_path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    self._file = open(self.jsonl_path, "a")
                self._file.write(line)
                self._file.flush()
            except OSError:
                # a full or read-only disk must not take the serve loop
                # down with it; drop to memory-only
                self._file, self.jsonl_path = None, None

    def close(self) -> None:
        """Terminal: later writes stay memory-only."""
        if self.watchdog is not None:
            self.watchdog.stop()
        with self._io_lock:
            self.jsonl_path = None
            if self._file is not None:
                self._file.close()
                self._file = None


# -- the process-wide instance ------------------------------------------------

_GLOBAL: Telemetry | None = None
_GLOBAL_LOCK = threading.Lock()


def _default_jsonl_path() -> str | None:
    d = os.environ.get("TPUFRAME_TELEMETRY_DIR")
    if not d:
        return None
    return os.path.join(d, f"events-rank{_env_rank()}.jsonl")


def _parse_deadlines(spec: str) -> dict[str, float]:
    """``"serve/infer=30,ckpt/save=600"`` -> dict (bad entries skipped)."""
    out: dict[str, float] = {}
    for part in spec.split(","):
        name, sep, val = part.strip().partition("=")
        if not sep or not name:
            continue
        try:
            out[name] = float(val)
        except ValueError:
            continue
    return out


def _watchdog_from_env():
    default_s = os.environ.get("TPUFRAME_WATCHDOG_S")
    per_name = os.environ.get("TPUFRAME_WATCHDOG_DEADLINES")
    if not default_s and not per_name:
        return None
    try:
        default = float(default_s) if default_s else None
    except ValueError:
        default = None
    return Watchdog(
        default_deadline_s=default,
        deadlines=_parse_deadlines(per_name) if per_name else None,
    )


def get_telemetry() -> Telemetry:
    """The process-wide telemetry (lazily created from env knobs)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Telemetry(
                    _default_jsonl_path(), watchdog=_watchdog_from_env()
                )
    return _GLOBAL


def configure(
    jsonl_path: str | None = None,
    *,
    jsonl_dir: str | None = None,
    watchdog: Any = None,
    rank: int | None = None,
    max_events: int = 512,
    registry: MetricsRegistry | None = None,
) -> Telemetry:
    """Replace the process-wide telemetry.  ``jsonl_dir`` gives the
    conventional per-rank filename."""
    global _GLOBAL
    if jsonl_path is None and jsonl_dir is not None:
        r = _env_rank() if rank is None else rank
        jsonl_path = os.path.join(jsonl_dir, f"events-rank{r}.jsonl")
    tele = Telemetry(
        jsonl_path,
        rank=rank,
        max_events=max_events,
        registry=registry,
        watchdog=watchdog,
    )
    with _GLOBAL_LOCK:
        old, _GLOBAL = _GLOBAL, tele
    if old is not None:
        old.close()
    return tele


def reset() -> None:
    """Drop the process-wide instance (tests)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        old, _GLOBAL = _GLOBAL, None
    if old is not None:
        old.close()


# -- exporters ----------------------------------------------------------------


def publish_to_loggers(
    loggers: Sequence[Any],
    step: int,
    *,
    prefix: str = "telemetry/",
    registry: MetricsRegistry | None = None,
) -> dict[str, float]:
    """Bridge the registry into the logger contract (``log_metrics(dict,
    step=)``: ``TensorBoardLogger``, ``MLflowLogger``, any duck-typed
    tracker).  Returns the published snapshot."""
    snap = (registry or get_telemetry().registry).snapshot(prefix=prefix)
    if snap:
        for lg in loggers:
            lg.log_metrics(dict(snap), step=step)
    return snap


class MetricsExportCallback:
    """Trainer callback publishing the registry to the run's loggers at
    every epoch end (rank 0, through the Trainer's own ``_log_metrics``).

    Duck-typed against ``tpuframe_torch.train.callbacks.Callback`` rather
    than subclassing it, so the telemetry module imports nothing of the
    train package.
    """

    def __init__(self, prefix: str = "telemetry/"):
        self.prefix = prefix

    # the Trainer calls every hook by name, so all of them must exist
    def on_fit_start(self, trainer) -> None: ...
    def on_epoch_start(self, trainer, epoch) -> None: ...
    def on_step_start(self, trainer) -> None: ...
    def on_step_end(self, trainer) -> None: ...
    def on_batch_end(self, trainer, metrics) -> None: ...
    def on_eval_end(self, trainer, epoch, metrics) -> None: ...
    def on_fit_end(self, trainer) -> None: ...

    def on_epoch_end(self, trainer, epoch, metrics) -> None:
        snap = get_telemetry().registry.snapshot(prefix=self.prefix)
        if snap:
            trainer._log_metrics(snap, step=epoch)
