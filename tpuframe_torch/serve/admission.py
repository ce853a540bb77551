"""Admission control for the serve path: bounded queue, explicit
load-shedding verdicts, deadline bookkeeping, door-side input validation.

The port's copy of ``tpuframe/serve/admission.py``.  An inference server
under overload has three honest options per request: serve it within its
deadline, shed it loudly, or reject it at the door.  Everything here is
host-side policy on the standard library.

- :data:`SERVE_ENV_VARS` / :class:`ServeKnobs` — the serve knobs, with the
  same tolerant env parsing as the JAX package.
- :class:`AdmissionController` — the bounded request queue.  ``offer``
  returns an explicit verdict (``admitted`` / ``rejected-queue-full`` /
  ``rejected-draining``) and, under ``shed-oldest``, the oldest request it
  evicted; ``pop`` feeds the batcher.  Queue depth rides the
  ``serve/queue_depth`` gauge.
- :func:`validate_payload` — shape/dtype/pixel-budget/finiteness checks at
  the door, so a poison request cannot NaN its batch.

The export-artifact header reader waits for the export slice.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Any

import numpy as np

from tpuframe_torch.fault.health import _env_float, _env_int
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = [
    "SERVE_ENV_VARS",
    "AdmissionController",
    "InvalidRequest",
    "RequestRejected",
    "RequestShed",
    "ServeKnobs",
    "read_export_meta",
    "sanitize_trace_id",
    "validate_payload",
]

#: charset a request-path trace id may use — the id is echoed into
#: telemetry JSONL and response headers, so a hostile ``X-Trace-Id``
#: must not smuggle newlines/control bytes through the front door
_TRACE_ID_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_."
)


def sanitize_trace_id(raw: Any) -> str | None:
    """A usable trace id (bounded length, safe charset) or None — the
    door check :class:`~tpuframe_torch.serve.server.ServingServer` applies
    to a client-supplied ``X-Trace-Id``."""
    if not isinstance(raw, str):
        return None
    raw = raw.strip()
    if 0 < len(raw) <= 64 and all(c in _TRACE_ID_CHARS for c in raw):
        return raw
    return None


#: every env knob the port's serve path reads
SERVE_ENV_VARS = (
    "TPUFRAME_SERVE_BUCKETS",
    "TPUFRAME_SERVE_SLO_MS",
    "TPUFRAME_SERVE_QUEUE_CAP",
    "TPUFRAME_SERVE_SHED_POLICY",
    "TPUFRAME_SERVE_BATCH_WAIT_MS",
    "TPUFRAME_SERVE_MAX_PIXELS",
    "TPUFRAME_SERVE_WATCHDOG_S",
    # SLO plane (read by serve.slo.SloObjectives.from_env)
    "TPUFRAME_SLO_P99_MS",
    "TPUFRAME_SLO_AVAILABILITY",
)

#: pixel budget default — PIL's ``MAX_IMAGE_PIXELS``, as in the JAX package
_DEFAULT_MAX_PIXELS = 178_956_970

_SHED_POLICIES = ("reject-new", "shed-oldest")


class RequestRejected(RuntimeError):
    """The request never entered the queue — overload (queue full under
    ``reject-new``) or drain (the server is finishing in-flight work
    before exit).  ``verdict`` says which; clients should back off or
    retry against another replica."""

    def __init__(self, msg: str, *, verdict: str):
        super().__init__(msg)
        self.verdict = verdict


class RequestShed(RuntimeError):
    """The request was admitted but dropped before serving — evicted by
    a newer request under ``shed-oldest``, or its deadline expired in
    the queue (shed *before* wasting a batch slot on an answer the
    client has already abandoned)."""

    def __init__(self, msg: str, *, verdict: str):
        super().__init__(msg)
        self.verdict = verdict


class InvalidRequest(ValueError):
    """The payload failed door-side validation (shape/dtype/pixel
    budget/non-finite values) — a malformed or poison request, rejected
    before it can reach a batch.  A ValueError: this is a client bug,
    not a load condition."""


@dataclasses.dataclass(frozen=True)
class ServeKnobs:
    """Serve-spine policy, env-tunable via ``TPUFRAME_SERVE_*``.

    Attributes:
      buckets: padded batch shapes the engine warms up — every
        request batch pads up to the smallest bucket that fits, so the
        backend only ever sees this closed set of shapes (the armed
        ShapeGuard makes anything else loud).
      slo_ms: the latency objective; also the default per-request
        deadline when a client sends none.
      queue_cap: bounded admission queue length — the knee of the
        latency curve under overload (queue wait is ~cap/throughput).
      shed_policy: ``reject-new`` (full queue refuses arrivals — fair
        to waiters) or ``shed-oldest`` (evict the request most likely
        to be past caring — better p99 for the served).
      batch_wait_ms: how long the batcher holds an underfull batch open
        for more arrivals (the classic latency/occupancy trade).
      max_pixels: door-side payload size budget (elements per request),
        defaulting to the decode guard's PIL ceiling.
      watchdog_s: stall-watchdog deadline on each backend inference
        call — a wedged backend produces an attributed stall report,
        not a silent hang (0 disables).
    """

    buckets: tuple = (1, 4, 16)
    slo_ms: float = 500.0
    queue_cap: int = 256
    shed_policy: str = "reject-new"
    batch_wait_ms: float = 2.0
    max_pixels: int = _DEFAULT_MAX_PIXELS
    watchdog_s: float = 30.0

    @classmethod
    def from_env(cls) -> "ServeKnobs":
        """Tolerant like every observability knob: malformed env reads
        as the default, never as a crash in the serving loop."""
        d = cls()
        raw = os.environ.get("TPUFRAME_SERVE_BUCKETS", "").strip()
        buckets = d.buckets
        if raw:
            try:
                parsed = tuple(sorted({int(p) for p in raw.split(",") if p.strip()}))
                if parsed and all(b > 0 for b in parsed):
                    buckets = parsed
            except ValueError:
                pass
        policy = os.environ.get("TPUFRAME_SERVE_SHED_POLICY", "").strip().lower()
        if policy not in _SHED_POLICIES:
            policy = d.shed_policy
        return cls(
            buckets=buckets,
            slo_ms=max(1.0, _env_float("TPUFRAME_SERVE_SLO_MS", d.slo_ms)),
            queue_cap=max(1, _env_int("TPUFRAME_SERVE_QUEUE_CAP", d.queue_cap)),
            shed_policy=policy,
            batch_wait_ms=max(
                0.0, _env_float("TPUFRAME_SERVE_BATCH_WAIT_MS", d.batch_wait_ms)
            ),
            max_pixels=max(1, _env_int("TPUFRAME_SERVE_MAX_PIXELS",
                                       d.max_pixels)),
            watchdog_s=max(0.0, _env_float("TPUFRAME_SERVE_WATCHDOG_S",
                                           d.watchdog_s)),
        )


def validate_payload(x: Any, *, item_shape: tuple, dtype: str,
                     max_pixels: int = _DEFAULT_MAX_PIXELS) -> None:
    """Door-side request validation; raises :class:`InvalidRequest`.

    Checks, in cheapest-first order: the payload is array-like with the
    expected trailing shape and dtype (one clear message naming the
    expected signature, instead of an opaque XLA error three layers
    down), its element count is inside the pixel budget (the decode
    guard's ceiling, applied before any batch buffer is touched), and —
    for float payloads — every value is finite, so one poison request
    cannot NaN the batch it would have shared with innocent neighbors.
    """
    shape = getattr(x, "shape", None)
    got_dtype = getattr(x, "dtype", None)
    if shape is None or got_dtype is None:
        raise InvalidRequest(
            f"payload must be an array of shape {tuple(item_shape)} "
            f"{dtype}; got {type(x).__name__}"
        )
    expected = tuple(int(s) for s in item_shape)
    if tuple(shape) != expected:
        raise InvalidRequest(
            f"payload shape {tuple(shape)} != expected per-request shape "
            f"{expected} (one request = one item; the engine batches)"
        )
    if str(got_dtype) != str(dtype):
        raise InvalidRequest(
            f"payload dtype {got_dtype} != expected {dtype} (the exported "
            "signature is fixed; cast at the client)"
        )
    n = 1
    for s in expected:
        n *= s
    if n > max_pixels:
        raise InvalidRequest(
            f"payload has {n} elements, over the {max_pixels}-element "
            "budget (TPUFRAME_SERVE_MAX_PIXELS)"
        )
    kind = getattr(got_dtype, "kind", None)
    if kind == "f":
        if not bool(np.isfinite(x).all()):
            raise InvalidRequest(
                "payload contains non-finite values (NaN/Inf) — rejected "
                "at the door so it cannot poison its batch-mates"
            )


class AdmissionController:
    """Bounded FIFO of admitted requests + the explicit-verdict door.

    Thread-safe: the server's request threads ``offer`` while the
    engine's batcher thread ``pop``s.  The queue-depth gauge is updated
    on both sides, so ``/metrics`` shows the backlog live.
    """

    def __init__(self, *, cap: int, policy: str = "reject-new"):
        if policy not in _SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {_SHED_POLICIES}, got {policy!r}"
            )
        self.cap = max(1, int(cap))
        self.policy = policy
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._draining = False
        self._depth_gauge = get_telemetry().registry.gauge("serve/queue_depth")

    @property
    def draining(self) -> bool:
        return self._draining

    def start_drain(self) -> None:
        """Flip the door to reject-new-forever; queued requests still
        serve (the graceful-drain contract: zero dropped in-flight)."""
        with self._lock:
            self._draining = True
            self._nonempty.notify_all()

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def offer(self, req: Any) -> tuple[str, Any]:
        """Admit ``req`` or say exactly why not.

        Returns ``(verdict, shed)``: verdict is ``admitted`` /
        ``rejected-draining`` / ``rejected-queue-full``; ``shed`` is the
        evicted oldest request under ``shed-oldest`` (the caller owns
        failing its future), else None.
        """
        with self._lock:
            if self._draining:
                return "rejected-draining", None
            shed = None
            if len(self._q) >= self.cap:
                if self.policy == "reject-new":
                    return "rejected-queue-full", None
                shed = self._q.popleft()
            self._q.append(req)
            self._depth_gauge.set(len(self._q))
            self._nonempty.notify()
            return "admitted", shed

    def pop(self, timeout: float | None = None) -> Any:
        """Oldest admitted request, or None on timeout/empty-drain."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._q:
                if self._draining:
                    return None
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return None
                self._nonempty.wait(remaining)
            req = self._q.popleft()
            self._depth_gauge.set(len(self._q))
            return req

    def pop_nowait(self) -> Any:
        with self._lock:
            if not self._q:
                return None
            req = self._q.popleft()
            self._depth_gauge.set(len(self._q))
            return req


# -- stdlib artifact-meta reader ---------------------------------------------

_MAX_HEADER = 1 << 20  # far above any real meta; rejects garbage lengths


def read_export_meta(path: str | os.PathLike) -> dict:
    """An export artifact's meta header (an 8-byte little-endian length,
    then that many bytes of JSON with ``"magic": "tpuframe-export"``),
    parsed with the stdlib alone, as the JAX package's reader does.  The
    first 8 bytes of an arbitrary file decode to an arbitrary length, so
    the length is bounds-checked and every parse failure is a
    ``ValueError``, never a ``MemoryError``.  ``_blob_offset`` in the
    result is where the payload starts."""
    path = os.fspath(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        if not 2 <= header_len <= min(_MAX_HEADER, size):
            raise ValueError(f"{path} is not a tpuframe export artifact")
        try:
            meta = json.loads(f.read(header_len).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path} is not a tpuframe export artifact") from e
    if not isinstance(meta, dict) or meta.get("magic") != "tpuframe-export":
        raise ValueError(f"{path} is not a tpuframe export artifact")
    meta["_blob_offset"] = 8 + header_len
    return meta
