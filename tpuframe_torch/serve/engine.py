"""Deadline-aware dynamic-batching inference engine over a torch callable.

The port of ``tpuframe/serve/engine.py``.  :class:`ServeEngine` turns a
callable taking one batched tensor (for ResNet: ``make_predict_fn`` bound
to the model) into a bounded-latency server component:

- **Bucketed dynamic batching.**  Requests batch into a small closed set
  of padded bucket shapes (``ServeKnobs.buckets``).  :meth:`start` runs
  every bucket once on the batcher thread (cuDNN picks its algorithms,
  the kernels build) and arms a :class:`~tpuframe_torch.compile.precompile.
  ShapeGuard`.  Host-side assembly reuses pinned
  :class:`~tpuframe_torch.data.loader.BatchBufferPool` leases, one small
  pool per bucket.
- **The device path.**  Each batch is copied host-to-device with
  ``non_blocking=True``, run through the callable, and read back with
  ``.cpu()``.  The lease goes back to its pool with the copy's CUDA event,
  so it is reused only after that copy completed.
- **Deadlines propagated into scheduling.**  A request whose deadline
  expired in the queue is shed before it takes a batch slot.
- **Admission control** and **door-side validation** from
  :mod:`~tpuframe_torch.serve.admission`.
- **Graceful drain.**  ``drain()`` flips admission to reject-new, finishes
  every in-flight request, and stops: zero dropped in-flight work.
- **Watchdog lease.**  Each backend call runs under a ``serve/infer``
  watchdog guard.
- **Isolation.**  A backend error fails only the requests of that batch
  (``serve/errors``); the loop keeps serving.

Telemetry names are the JAX engine's: ``serve/latency`` and
``serve/batch_occupancy`` histograms, ``serve/queue_depth`` and
``serve/draining`` gauges, admit/shed/reject/invalid/error counters, one
``serve/request`` event per served request, rate-limited
``serve/rejected``/``serve/shed`` events, and per-hop ``serve/door``,
``serve/queue_wait``, ``serve/assemble`` and ``serve/infer`` spans for
traced requests.  Every outcome feeds a :class:`~tpuframe_torch.serve.slo.
SloTracker`.

Not in the port yet: the chaos sites (``serve/submit``, ``serve/enqueue``,
``serve/batch``, ``serve/infer``) and ``flood``, the preemption auto-drain,
OOM forensics, and the autotune hooks.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from tpuframe_torch.compile.precompile import ShapeGuard, batch_signature
from tpuframe_torch.core.runtime import resolve_device
from tpuframe_torch.data.loader import BatchBufferPool
from tpuframe_torch.serve.admission import (
    AdmissionController,
    InvalidRequest,
    RequestRejected,
    RequestShed,
    ServeKnobs,
    validate_payload,
)
from tpuframe_torch.serve.slo import SloTracker
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = ["ServeEngine", "ServeResult"]


class ServeResult:
    """Future-like handle for one submitted request.

    ``result(timeout)`` blocks for the value (this request's row of the
    model output, a CPU tensor); a shed request raises
    :class:`RequestShed`, a backend failure re-raises the batch's error.
    """

    __slots__ = ("id", "verdict", "latency_s", "_event", "_value", "_error")

    def __init__(self, rid: int):
        self.id = rid
        self.verdict: str | None = None
        self.latency_s: float | None = None
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not completed in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def _complete(self, value, verdict: str, latency_s: float) -> None:
        self._value = value
        self.verdict = verdict
        self.latency_s = latency_s
        self._event.set()

    def _fail(self, error: BaseException, verdict: str) -> None:
        self._error = error
        self.verdict = verdict
        self._event.set()


class _Request:
    __slots__ = ("payload", "res", "t_submit", "deadline", "trace")

    def __init__(self, payload, res: ServeResult, t_submit: float,
                 deadline: float, trace: str | None = None):
        self.payload = payload
        self.res = res
        self.t_submit = t_submit
        self.deadline = deadline
        # request-path trace id; None means untraced — the hot path emits
        # nothing extra
        self.trace = trace


class _RateLimitedEvents:
    """At most one JSONL event per (name, verdict) per ``interval_s``:
    counters carry the volume, the first event carries the news."""

    def __init__(self, interval_s: float = 1.0):
        self.interval_s = interval_s
        self._last: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def emit(self, tele, name: str, **fields) -> None:
        key = (name, fields.get("verdict"))
        now = time.monotonic()
        with self._lock:
            if now - self._last.get(key, -1e9) < self.interval_s:
                return
            self._last[key] = now
        tele.event(name, **fields)


class ServeEngine:
    """Dynamic-batching engine over a torch callable.

    Args:
      model: callable taking one batched tensor on ``device`` (leading
        batch axis, then ``item_shape``) and returning a tensor whose
        leading axis is the batch.
      knobs: :class:`ServeKnobs` (default: from env).
      item_shape / dtype: per-request payload signature (numpy shape and
        dtype); requests are numpy arrays of exactly this signature.
      device: where batches run; None means ``cuda``, which raises without
        CUDA.
      replica: fleet identity tagged on every ``serve/request`` event.

    Lifecycle: ``start()`` warms every bucket and starts the batcher
    thread; ``submit()`` returns a :class:`ServeResult`; ``drain()``
    finishes in-flight work and stops.  Context-managed::

        with ServeEngine(fn, item_shape=(224, 224, 3), dtype="uint8") as eng:
            out = eng.submit(x).result(timeout=5)
    """

    def __init__(
        self,
        model: Callable[[torch.Tensor], torch.Tensor],
        *,
        knobs: ServeKnobs | None = None,
        item_shape: tuple | None = None,
        dtype: Any = None,
        device=None,
        replica: int | str | None = None,
    ):
        if item_shape is None or dtype is None:
            raise ValueError(
                "item_shape= and dtype= are required (the request signature "
                "the engine validates and batches)"
            )
        self.device = resolve_device(device)
        self.knobs = knobs or ServeKnobs.from_env()
        self.replica = replica
        self.item_shape = tuple(int(s) for s in item_shape)
        self.dtype = np.dtype(dtype)
        # the request signature is fixed per engine, so the pixel budget is
        # decidable once, here
        n_elems = 1
        for s in self.item_shape:
            n_elems *= s
        if n_elems > self.knobs.max_pixels:
            raise ValueError(
                f"request shape {self.item_shape} has {n_elems} elements, "
                f"over the {self.knobs.max_pixels}-element budget "
                "(TPUFRAME_SERVE_MAX_PIXELS)"
            )
        self._fn = model
        self._guard = ShapeGuard()
        self.buckets = tuple(sorted(self.knobs.buckets))
        on_cuda = self.device.type == "cuda"
        self._pools = {
            b: BatchBufferPool(2, pin_memory=on_cuda) for b in self.buckets
        }
        self._admission = AdmissionController(
            cap=self.knobs.queue_cap, policy=self.knobs.shed_policy
        )
        self._rid = itertools.count()
        self._batches = 0
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._thread: threading.Thread | None = None
        self._started = False
        self._limited = _RateLimitedEvents()
        reg = get_telemetry().registry
        self._c_admitted = reg.counter("serve/admitted")
        self._c_rejected = reg.counter("serve/rejected")
        self._c_shed = reg.counter("serve/shed")
        self._c_invalid = reg.counter("serve/invalid")
        self._c_served = reg.counter("serve/requests_served")
        self._c_batches = reg.counter("serve/batches")
        self._c_errors = reg.counter("serve/errors")
        self._h_latency = reg.histogram("serve/latency")
        self._h_occupancy = reg.histogram("serve/batch_occupancy")
        self._g_draining = reg.gauge("serve/draining")
        self._slo = SloTracker(source="engine")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServeEngine":
        """Start the batcher thread, which first runs every bucket once and
        arms the shape guard; returns when that warm-up is done (re-raising
        its error).  Idempotent.

        The warm-up runs on the batcher thread itself: cuDNN and cuBLAS keep
        handles and plans per thread, so a bucket warmed on the caller's
        thread still paid 111-173 ms on its first served batch (ResNet50 on
        an H100)."""
        if self._started:
            return self
        tele = get_telemetry()
        warmed = threading.Event()
        failure: list[BaseException] = []

        def run() -> None:
            try:
                self._warm_up()
            except BaseException as e:  # re-raised by start() on the caller's thread
                failure.append(e)
                return
            finally:
                warmed.set()
            self._loop()

        self._thread = threading.Thread(
            target=run, name="tpuframe-torch-serve-batcher", daemon=True
        )
        self._thread.start()
        warmed.wait()
        if failure:
            self._thread.join()
            raise failure[0]
        self._started = True
        tele.event(
            "serve/started",
            buckets=list(self.buckets),
            slo_ms=self.knobs.slo_ms,
            queue_cap=self.knobs.queue_cap,
            shed_policy=self.knobs.shed_policy,
            device=str(self.device),
        )
        return self

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()

    @property
    def draining(self) -> bool:
        return self._admission.draining

    def queue_depth(self) -> int:
        return self._admission.depth()

    # -- door ----------------------------------------------------------------
    def submit(self, x: Any, *, deadline_ms: float | None = None,
               trace: str | None = None) -> ServeResult:
        """Validate, admit, and enqueue one request (a numpy array of the
        engine's item shape and dtype).

        Raises :class:`InvalidRequest` (malformed or poison payload) or
        :class:`RequestRejected` (queue full under reject-new, or
        draining) synchronously; otherwise returns a :class:`ServeResult`.
        Under ``shed-oldest`` an admission may evict the oldest queued
        request — *that* request's future fails with :class:`RequestShed`.
        ``trace`` arms per-hop spans for this request.
        """
        if not self._started:
            raise RuntimeError("ServeEngine.start() first")
        tele = get_telemetry()
        door = (tele.span("serve/door", trace=trace)
                if trace is not None else contextlib.nullcontext())
        try:
            with door:
                validate_payload(
                    x, item_shape=self.item_shape, dtype=self.dtype,
                    max_pixels=self.knobs.max_pixels,
                )
        except InvalidRequest as e:
            self._c_invalid.inc()
            self._slo.observe(ok=False)
            self._limited.emit(
                tele, "serve/rejected", verdict="invalid", error=str(e)[:300]
            )
            raise
        now = time.monotonic()
        slo_s = (self.knobs.slo_ms if deadline_ms is None
                 else float(deadline_ms)) / 1e3
        res = ServeResult(next(self._rid))
        req = _Request(x, res, now, now + slo_s, trace=trace)
        verdict, shed = self._admission.offer(req)
        if shed is not None:
            self._shed(shed, "shed-oldest")
        if verdict != "admitted":
            self._c_rejected.inc()
            self._slo.observe(ok=False)
            self._limited.emit(tele, "serve/rejected", verdict=verdict)
            raise RequestRejected(
                f"request rejected: {verdict} (queue_cap="
                f"{self.knobs.queue_cap}, policy={self.knobs.shed_policy})",
                verdict=verdict,
            )
        self._c_admitted.inc()
        return res

    # -- drain / stop --------------------------------------------------------
    def drain(self, timeout: float | None = 30.0, *,
              reason: str = "drain") -> bool:
        """Graceful exit: reject new requests, finish every in-flight one.
        Returns True when the queue fully drained inside ``timeout``."""
        if not self._started:
            return True
        tele = get_telemetry()
        if not self._admission.draining:
            self._g_draining.set(1.0)
            tele.event("serve/drain", reason=reason,
                       queue_depth=self._admission.depth())
            self._admission.start_drain()
        ok = self._drained.wait(timeout)
        if ok and self._thread is not None:
            self._thread.join(timeout=5.0)
        tele.event(
            "serve/drained",
            ok=ok,
            served=int(self._c_served.value),
            shed=int(self._c_shed.value),
            rejected=int(self._c_rejected.value),
        )
        return ok

    def stop(self) -> None:
        """Hard stop: no new batches after the current one; queued requests
        are shed, not silently dropped."""
        self._stop.set()
        self._admission.start_drain()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        while True:
            req = self._admission.pop_nowait()
            if req is None:
                break
            self._shed(req, "shed-stopped")

    # -- internals -----------------------------------------------------------
    def _warm_up(self) -> None:
        """Run every bucket once on zeros and arm the shape guard."""
        tele = get_telemetry()
        for b in self.buckets:
            with tele.span("serve/warmup", bucket=b):
                pool = self._pools[b]
                lease = pool.acquire(b, self.item_shape, self.dtype)
                lease.images.zero_()
                out, copied = self._run(lease.images)
                pool.release(lease, copy_done=copied)
                out.cpu()
            self._guard.expect(
                "serve", batch_signature({"image": lease.images}))

    def _run(self, images: torch.Tensor):
        """H2D copy and the backend call; returns (output on device, the
        copy's CUDA event or None)."""
        x = images.to(self.device, non_blocking=True)
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(self.device))
        return self._fn(x), copied

    def _shed(self, req: _Request, verdict: str) -> None:
        self._c_shed.inc()
        self._slo.observe(ok=False)
        self._limited.emit(get_telemetry(), "serve/shed", verdict=verdict)
        req.res._fail(
            RequestShed(f"request shed: {verdict}", verdict=verdict), verdict
        )

    def _gather(self) -> list[_Request] | None:
        """One batch's worth of live requests (deadline-expired ones shed on
        the way), or None when idle or drained."""
        req = self._admission.pop(timeout=0.05)
        if req is None:
            return None
        now = time.monotonic()
        if now >= req.deadline:
            self._shed(req, "shed-deadline")
            return []
        batch = [req]
        max_bucket = self.buckets[-1]
        hold_until = now + self.knobs.batch_wait_ms / 1e3
        while len(batch) < max_bucket:
            remaining = hold_until - time.monotonic()
            nxt = (self._admission.pop_nowait() if remaining <= 0
                   else self._admission.pop(timeout=min(remaining, 0.005)))
            if nxt is None:
                if remaining <= 0:
                    break
                continue
            if time.monotonic() >= nxt.deadline:
                self._shed(nxt, "shed-deadline")
                continue
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        tele = get_telemetry()
        while True:
            if self._stop.is_set():
                break  # hard stop: stop() sheds the queued remainder
            batch = self._gather()
            if batch is None:
                if self._admission.draining and self._admission.depth() == 0:
                    break
                continue
            if not batch:
                continue
            bidx = self._batches
            self._batches += 1
            n = len(batch)
            bucket = next(b for b in self.buckets if b >= n)
            # queue wait ends when this batch starts assembling, so
            # queue_wait + assemble + infer tile the request path
            traces = [r.trace for r in batch if r.trace is not None]
            if traces:
                t_asm = time.monotonic()
                for r in batch:
                    if r.trace is not None:
                        tele.event(
                            "serve/queue_wait", kind="span",
                            dur_s=round(max(0.0, t_asm - r.t_submit), 6),
                            trace=r.trace, batch=bidx,
                        )
            try:
                asm = (tele.span("serve/assemble", batch=bidx, n=n,
                                 traces=traces)
                       if traces else contextlib.nullcontext())
                with asm:
                    pool = self._pools[bucket]
                    lease = pool.acquire(bucket, self.item_shape, self.dtype)
                    for i, r in enumerate(batch):
                        np.copyto(lease.images_np[i], r.payload,
                                  casting="same_kind")
                    for i in range(n, bucket):  # pad by cycling live payloads
                        np.copyto(lease.images_np[i], batch[i % n].payload,
                                  casting="same_kind")
                    self._guard.check(
                        "serve", batch_signature({"image": lease.images}))
                # watchdog_s=0 means disabled, including any process-wide
                # default deadline
                wd = (tele.guard("serve/infer", self.knobs.watchdog_s)
                      if self.knobs.watchdog_s > 0 else contextlib.nullcontext())
                with tele.span("serve/infer", batch=bidx, bucket=bucket, n=n,
                               **({"traces": traces} if traces else {})), \
                        wd:
                    out, copied = self._run(lease.images)
                    pool.release(lease, copy_done=copied)
                    out = out.cpu()
            except Exception as e:  # noqa: BLE001 - batch-scoped isolation
                self._c_errors.inc()
                tele.event("serve/batch_error", batch=bidx,
                           error=f"{type(e).__name__}: {e}"[:300])
                for r in batch:
                    self._slo.observe(ok=False)
                    r.res._fail(e, "error")
                continue
            done = time.monotonic()
            self._h_occupancy.observe(n / bucket)
            self._c_batches.inc()
            for i, r in enumerate(batch):
                lat = done - r.t_submit
                self._h_latency.observe(lat)
                self._c_served.inc()
                self._slo.observe(lat)
                tele.event("serve/request", latency_s=round(lat, 6),
                           batch=bidx, verdict="ok",
                           **({"replica": self.replica}
                              if self.replica is not None else {}),
                           **({"trace": r.trace}
                              if r.trace is not None else {}))
                r.res._complete(out[i], "ok", lat)
        self._drained.set()


# one import surface for the typed errors callers catch around submit()
ServeEngine.InvalidRequest = InvalidRequest
ServeEngine.RequestRejected = RequestRejected
ServeEngine.RequestShed = RequestShed
