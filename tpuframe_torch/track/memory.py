"""Memory plane: live watermarks, the captured step's footprint, and OOM
forensics.

Port of ``tpuframe/track/memory.py``.  Three sources of memory truth,
cheapest first, all landing in one telemetry namespace:

- **estimate**: ``parallel.plan_memory`` (math off the ``ParallelPlan``);
  the Trainer registers it here via :func:`set_context` so a crash can
  attribute bytes without recomputing anything.
- **compiled**: :func:`record_executable_memory` reads a precompiled
  step (``compile.precompile.StepExecutable``).  torch has no
  ``memory_analysis()``: the record's arguments are the bytes of the
  state and the batch template, its outputs the captured step's static
  outputs, and its temporaries the bytes of the CUDA graph's private
  memory pool less the outputs, so ``peak_mb`` is what a replay holds
  (ROADMAP Queue 3, difference 37).  One ``memory/executable`` event, and the record is
  persisted under ``<compile cache>/memory/`` as the JAX package does.
- **live**: :func:`update_watermarks` folds the ``SystemMetricsMonitor``
  sample into process-wide card and host peaks (gauges
  ``memory/hbm_peak_mb`` / ``memory/host_peak_mb``), emitting a ratcheted
  ``memory/watermark`` event only when the card's peak grows more than
  5 %.

:func:`maybe_oom_event` is the forensics seam: the Trainer's step loop,
its precompile and the serve batcher call it from their except blocks;
an allocation failure (``torch.OutOfMemoryError``, "CUDA out of memory",
XLA's ``RESOURCE_EXHAUSTED`` as the chaos injector raises it) becomes one
``memory/oom`` event carrying the three-way table (estimate, compiled
records, live peaks with the caching allocator's ``memory_stats``), the
top leaves and the ``suggest_fit`` ladder.  Callers always re-raise.

``launch.remote.all_env_vars()`` imports :data:`MEMORY_ENV_VARS` from
here; nothing here imports torch at module import.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any

from tpuframe_torch.parallel.memory import plan_memory, suggest_fit

__all__ = [
    "MEMORY_ENV_VARS",
    "MEMORY_ENV_DOMAINS",
    "memory_env",
    "record_executable_memory",
    "executable_records",
    "update_watermarks",
    "peaks",
    "reset_peaks",
    "is_oom",
    "set_context",
    "clear_context",
    "maybe_oom_event",
]

#: every env knob the memory plane reads, shipped to every worker by
#: ``launch.remote.all_env_vars()``
MEMORY_ENV_VARS = (
    "TPUFRAME_MEMORY_SAMPLE_S",
    "TPUFRAME_MEMORY_TOP_LEAVES",
    "TPUFRAME_MEMORY_LIVE",
    "TPUFRAME_MEMORY_BUDGET_MB",
)

#: machine-readable value domains
MEMORY_ENV_DOMAINS = {
    # watermark sample cadence: SystemMetricsMonitor's default interval,
    # resolved at construction
    "TPUFRAME_MEMORY_SAMPLE_S": {
        "type": "float", "range": (0.1, None), "apply": "restart"},
    # attribution-table depth in memory/oom events
    "TPUFRAME_MEMORY_TOP_LEAVES": {
        "type": "int", "range": (1, 64), "apply": "live"},
    # falsy = estimator-only: no live sampling fold-in, no OOM forensics
    # emission (the classifying seams stay pass-through)
    "TPUFRAME_MEMORY_LIVE": {"type": "bool", "apply": "restart"},
    # planning budget per device; 0/unset = the card's memory
    "TPUFRAME_MEMORY_BUDGET_MB": {
        "type": "float", "range": (0, None), "apply": "live"},
}

_MEMORY_DEFAULTS = {
    "TPUFRAME_MEMORY_SAMPLE_S": 10.0,
    "TPUFRAME_MEMORY_TOP_LEAVES": 8,
    "TPUFRAME_MEMORY_LIVE": True,
    "TPUFRAME_MEMORY_BUDGET_MB": 0.0,
}

_FALSY = ("0", "false", "no", "off", "disabled")


def memory_env(environ: dict | None = None) -> dict:
    """Parsed ``TPUFRAME_MEMORY_*`` knobs + defaults; malformed values
    are *reported* (an ``errors`` dict), never raised."""
    env = os.environ if environ is None else environ
    out: dict = dict(_MEMORY_DEFAULTS)
    errors: dict[str, str] = {}
    for knob, lo in (("TPUFRAME_MEMORY_SAMPLE_S", 0.1),
                     ("TPUFRAME_MEMORY_BUDGET_MB", 0.0)):
        raw = env.get(knob, "").strip()
        if not raw:
            continue
        try:
            v = float(raw)
            if v < lo:
                raise ValueError("below minimum")
        except ValueError:
            errors[knob] = f"not a float >= {lo}: {raw!r}"
            continue
        out[knob] = v
    raw = env.get("TPUFRAME_MEMORY_TOP_LEAVES", "").strip()
    if raw:
        try:
            v = int(raw)
            if not 1 <= v <= 64:
                raise ValueError("out of range")
            out["TPUFRAME_MEMORY_TOP_LEAVES"] = v
        except ValueError:
            errors["TPUFRAME_MEMORY_TOP_LEAVES"] = f"not an int in [1, 64]: {raw!r}"
    raw = env.get("TPUFRAME_MEMORY_LIVE", "").strip().lower()
    if raw:
        out["TPUFRAME_MEMORY_LIVE"] = raw not in _FALSY
    out["errors"] = errors
    return out


def _tele():
    from tpuframe_torch.track.telemetry import get_telemetry

    return get_telemetry()


# -- live watermarks ----------------------------------------------------------

_RATCHET = 1.05  # emit memory/watermark only on >5% card-peak growth

_PEAK_LOCK = threading.Lock()
_PEAKS = {
    "hbm_peak_mb": 0.0,
    "host_peak_mb": 0.0,
    "hbm_limit_mb": 0.0,
    "_emitted_mb": 0.0,
}


def update_watermarks(device_stats: dict[str, float], rss_mb: float,
                      registry: Any = None) -> dict[str, float]:
    """Fold one monitor sample into the process-wide peaks.

    ``device_stats`` is ``system_metrics.device_memory_stats()`` output
    (already sampled by the caller); ``rss_mb`` the host RSS.  Sets the
    ``memory/hbm_peak_mb`` / ``host_peak_mb`` gauges every call; emits the
    ``memory/watermark`` event only when the card's peak ratchets up more
    than 5 %.  Returns the current peaks.
    """
    hbm = 0.0
    limit = 0.0
    for k, v in device_stats.items():
        if k.endswith("_mem_used_mb") and v > hbm:
            hbm = v
            util = device_stats.get(k.replace("_mem_used_mb", "_mem_util"), 0)
            if util:
                limit = v / util
    emit = False
    with _PEAK_LOCK:
        if rss_mb > _PEAKS["host_peak_mb"]:
            _PEAKS["host_peak_mb"] = rss_mb
        if limit > _PEAKS["hbm_limit_mb"]:
            _PEAKS["hbm_limit_mb"] = limit
        if hbm > _PEAKS["hbm_peak_mb"]:
            _PEAKS["hbm_peak_mb"] = hbm
            if hbm > _PEAKS["_emitted_mb"] * _RATCHET:
                _PEAKS["_emitted_mb"] = hbm
                emit = True
        snap = {k: v for k, v in _PEAKS.items() if not k.startswith("_")}
    tele = _tele()
    reg = registry if registry is not None else tele.registry
    reg.gauge("memory/hbm_peak_mb").set(snap["hbm_peak_mb"])
    reg.gauge("memory/host_peak_mb").set(snap["host_peak_mb"])
    if emit:
        tele.event("memory/watermark", **snap)
    return snap


def peaks() -> dict[str, float]:
    """Current process-wide peaks (keys without the ratchet internals)."""
    with _PEAK_LOCK:
        return {k: v for k, v in _PEAKS.items() if not k.startswith("_")}


def reset_peaks() -> None:
    """Zero the watermarks (tests; a fresh fit in a reused process)."""
    with _PEAK_LOCK:
        for k in _PEAKS:
            _PEAKS[k] = 0.0


# -- the captured step's footprint --------------------------------------------

#: the record's keys, the JAX package's (``CompiledMemoryStats`` fields);
#: torch fills the argument, output and temporary bytes, the rest are 0
_STAT_KEYS = ("argument_mb", "output_mb", "temp_mb", "alias_mb", "generated_code_mb",
              "host_argument_mb", "host_output_mb", "host_temp_mb")

_MB = 1024.0 * 1024.0

#: in-process registry of compiled records, by label
_EXECUTABLES: dict[str, dict] = {}


def _memory_dir(cache_dir: str | None = None) -> str | None:
    if cache_dir is None:
        from tpuframe_torch.compile.cache import cache_dir_from_env, enabled_dir

        # an explicitly set TPUFRAME_COMPILE_CACHE is authoritative;
        # otherwise records live next to the cache this process enabled
        if os.environ.get("TPUFRAME_COMPILE_CACHE", "").strip():
            cache_dir = cache_dir_from_env()
        else:
            cache_dir = enabled_dir() or cache_dir_from_env()
    return os.path.join(cache_dir, "memory") if cache_dir else None


def _bytes(tensors) -> int:
    return sum(int(t.numel()) * int(t.element_size()) for t in tensors
               if hasattr(t, "element_size"))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _template_bytes(template) -> int:
    total = 0
    for spec in (template or {}).values():
        n = 1
        for d in spec.shape:
            n *= int(d)
        total += n * spec.dtype.itemsize
    return total


def record_executable_memory(compiled: Any, label: str | None = None, *,
                             persist: bool = True) -> dict | None:
    """Record a precompiled step's footprint under ``label`` (default its
    own).

    ``compiled`` is a ``StepExecutable``: its state's tensors and its
    batch template are the arguments, its static outputs (on the card)
    the outputs, and ``pool_bytes`` (its graph's private pool, measured
    by ``precompile_step`` on the card) less the outputs the
    temporaries.  Without a graph (the CPU) the temporaries are 0.
    Emits one ``memory/executable`` event and (by default) persists the
    record next to the compile cache.  Returns the record, or None for
    an object with no state; never raises.
    """
    state = getattr(compiled, "state", None)
    if state is None:
        return None
    label = label or getattr(compiled, "label", "")
    try:
        from tpuframe_torch.compile.precompile import _state_tensors

        args = _bytes(_state_tensors(state).values()) + _template_bytes(
            getattr(compiled, "template", None))
        outs = _bytes(_leaves(getattr(compiled, "static_out", None)))
        pool = getattr(compiled, "pool_bytes", None)
    except Exception:
        return None
    rec: dict[str, Any] = {"label": label}
    for key in _STAT_KEYS:
        rec[key] = 0.0
    rec["argument_mb"] = round(args / _MB, 3)
    rec["output_mb"] = round(outs / _MB, 3)
    if pool is not None:
        rec["temp_mb"] = round(max(0, pool - outs) / _MB, 3)
    rec["peak_mb"] = round(rec["argument_mb"] + rec["temp_mb"] + rec["output_mb"], 3)
    rec["peak_source"] = "graph_pool" if pool is not None else "arguments"
    _EXECUTABLES[label] = rec
    _tele().event("memory/executable", **rec)
    if persist:
        path = _record_path(label)
        if path:
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(rec, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
            except OSError:
                pass  # a full disk must not fail the compile either
    return rec


def _record_path(label: str, cache_dir: str | None = None) -> str | None:
    d = _memory_dir(cache_dir)
    if not d:
        return None
    name = hashlib.sha256(label.encode()).hexdigest()[:16]
    return os.path.join(d, f"{name}.json")


def executable_records(cache_dir: str | None = None) -> dict[str, dict]:
    """All known executable-memory records, by compile label: persisted
    ones (from runs sharing the compile cache), then this process's."""
    out: dict[str, dict] = {}
    d = _memory_dir(cache_dir)
    if d and os.path.isdir(d):
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name)) as f:
                    rec = json.loads(f.read())
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict) and rec.get("label"):
                out[rec["label"]] = rec
    out.update(_EXECUTABLES)
    return out


# -- OOM forensics ------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "OUT OF MEMORY",
                "OUTOFMEMORYERROR")


def is_oom(exc: BaseException) -> bool:
    """Is this an allocation failure?  ``torch.OutOfMemoryError`` ("CUDA
    out of memory"), XLA's ``RESOURCE_EXHAUSTED`` status by name, and the
    synthetic ``fault.chaos.OomError`` that carries it."""
    text = f"{type(exc).__name__}: {exc}".upper()
    return any(m in text for m in _OOM_MARKERS) or "RESOURCEEXHAUSTED" in text


def _allocator() -> dict:
    """The caching allocator's live figures on the current card, in MB
    (empty where this process has no card)."""
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        s = torch.cuda.memory_stats()
        total = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory
    except Exception:
        return {}
    return {
        "allocated_mb": round(s.get("allocated_bytes.all.current", 0) / _MB, 3),
        "allocated_peak_mb": round(s.get("allocated_bytes.all.peak", 0) / _MB, 3),
        "reserved_mb": round(s.get("reserved_bytes.all.current", 0) / _MB, 3),
        "reserved_peak_mb": round(s.get("reserved_bytes.all.peak", 0) / _MB, 3),
        "num_alloc_retries": int(s.get("num_alloc_retries", 0)),
        "num_ooms": int(s.get("num_ooms", 0)),
        "device_total_mb": round(total / _MB, 3),
    }


_CTX_LOCK = threading.Lock()
_CONTEXT: dict[str, Any] = {}


def set_context(*, plan: Any = None, model_template: Any = None,
                batch_spec: Any = None, opt_template: Any = None,
                comms_template: Any = None, microbatches: int | None = None,
                estimate: dict | None = None) -> dict | None:
    """Register what's running so an OOM can attribute bytes.

    The Trainer calls this once a fit.  When ``estimate`` is omitted and
    a plan + model template are given, ``plan_memory`` is computed here,
    once.  Returns the estimate in effect.
    """
    est = estimate
    if est is None and plan is not None and model_template is not None:
        try:
            est = plan_memory(
                plan, model_template, batch_spec,
                opt_template=opt_template, comms_template=comms_template,
                microbatches=microbatches,
                top_leaves=memory_env()["TPUFRAME_MEMORY_TOP_LEAVES"],
            )
        except Exception:
            est = None  # forensics context must never fail the fit
    with _CTX_LOCK:
        _CONTEXT.clear()
        _CONTEXT.update(
            plan=plan, model_template=model_template, batch_spec=batch_spec,
            opt_template=opt_template, comms_template=comms_template,
            microbatches=microbatches, estimate=est,
        )
    return est


def clear_context() -> None:
    with _CTX_LOCK:
        _CONTEXT.clear()


def maybe_oom_event(exc: BaseException, *, where: str,
                    step: int | None = None) -> bool:
    """Classify ``exc``; emit ONE ``memory/oom`` event if it's an OOM.

    The event carries the three-way attribution (estimate vs compiled
    records vs live peaks, the latter with the caching allocator's
    figures), the top-N leaves, and the ``suggest_fit`` ladder against
    the resolved budget (``TPUFRAME_MEMORY_BUDGET_MB``, else the card's
    memory).  Returns True iff classified; the caller ALWAYS re-raises.
    Never raises itself.
    """
    if not is_oom(exc):
        return False
    env = memory_env()
    if not env["TPUFRAME_MEMORY_LIVE"]:
        return False
    try:
        with _CTX_LOCK:
            ctx = dict(_CONTEXT)
        live = peaks()
        live.update(_allocator())
        if not live.get("hbm_limit_mb") and live.get("device_total_mb"):
            live["hbm_limit_mb"] = live["device_total_mb"]
        budget = env["TPUFRAME_MEMORY_BUDGET_MB"] or live.get("hbm_limit_mb") or None
        execs = executable_records()
        compiled = sorted(
            ({"label": k, "peak_mb": v.get("peak_mb", 0)} for k, v in execs.items()),
            key=lambda r: -r["peak_mb"],
        )[:4]
        estimate = ctx.get("estimate")
        suggestion = None
        if ctx.get("plan") is not None and ctx.get("model_template") is not None:
            try:
                fit = suggest_fit(
                    ctx["plan"], ctx["model_template"], ctx.get("batch_spec"),
                    budget_mb=budget,
                    opt_template=ctx.get("opt_template"),
                    comms_template=ctx.get("comms_template"),
                    microbatches=ctx.get("microbatches"),
                )
                suggestion = {k: v for k, v in fit.items() if k != "candidates"}
                if suggestion.get("suggestion"):
                    # keep the event bounded: the rung, not its full estimate
                    suggestion["suggestion"] = {
                        k: v for k, v in suggestion["suggestion"].items()
                        if k != "estimate"
                    }
            except Exception:
                suggestion = None
        tele = _tele()
        tele.event(
            "memory/oom",
            where=where,
            step=step,
            error=str(exc)[:500],
            estimate_total_mb=(estimate or {}).get("per_device_mb", {}).get("total"),
            estimate=estimate,
            compiled_peaks=compiled,
            live=live,
            budget_mb=budget,
            fit=suggestion,
        )
        tele.registry.counter("memory/oom_total").inc()
    except Exception:
        pass  # narration must never mask the original error
    return True
