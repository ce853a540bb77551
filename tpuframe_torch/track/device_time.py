"""Device-time attribution: parsed ``torch.profiler`` traces -> exposed comms.

Port of ``tpuframe/track/device_time.py``.  The skew report
(``track/analyze.py``) sees only host-side spans; this module is the
device half: a stdlib-only parser over the Chrome Trace Event JSON that
``torch.profiler`` writes through ``tensorboard_trace_handler``
(``<dir>/<worker>.<ts>.pt.trace.json[.gz]``), reducing a captured window
to one ``device_time`` record:

- per-class device wall (**compute** / **collective** / **transfer** /
  **idle**) over the device tracks only.  A device event is one Kineto
  records on the card, chosen by its ``cat`` (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), one timeline a device (its ``pid``), whatever stream
  (``tid``) ran it.  NCCL kernels are collectives, copies and memsets
  transfers, every other kernel compute: the port's own kernels, cuBLAS
  and CUTLASS products and Inductor's ``triton_*`` alike;
- **exposed_comms_s**: collective wall not overlapped by compute,
  ``union(collective) - union(compute)`` on the device timeline;
- **overlap_efficiency**: ``1 - exposed/collective``;
- a **top-k op table** by base kernel name (template arguments, the
  parameter list and Inductor's numbered suffixes folded), count, total
  seconds and share of device time.

Stdlib only: the analyzer reads traces without the card.  The capture
side is ``track/profiler.py``; the ``TPUFRAME_PROFILE_*`` knobs are
declared here so the parser, the capture callback and the launcher's
env shipping (``launch.remote.all_env_vars``) read one list.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Any, Iterable, Sequence

__all__ = [
    "PROFILE_ENV_VARS",
    "PROFILE_ENV_DOMAINS",
    "DEVICE_TIME_VERSION",
    "DEVICE_CATEGORIES",
    "classify_op",
    "count_device_events",
    "device_time_report",
    "device_trace_events",
    "find_trace_files",
    "interval_subtract",
    "interval_union",
    "list_captures",
    "load_trace",
    "profile_env",
]

#: every env knob the profile capture path reads, shipped to every worker
#: by ``launch.remote.all_env_vars()``
PROFILE_ENV_VARS = (
    "TPUFRAME_PROFILE_STEPS",
    "TPUFRAME_PROFILE_EVERY",
    "TPUFRAME_PROFILE_KEEP",
    "TPUFRAME_PROFILE_DIR",
)

#: machine-readable value domains.  All "restart": the callback resolves
#: its cadence at construction.
PROFILE_ENV_DOMAINS = {
    "TPUFRAME_PROFILE_STEPS": {
        "type": "int", "range": (1, None), "apply": "restart"},
    "TPUFRAME_PROFILE_EVERY": {
        "type": "int", "range": (0, None), "apply": "restart"},
    "TPUFRAME_PROFILE_KEEP": {
        "type": "int", "range": (1, None), "apply": "restart"},
    "TPUFRAME_PROFILE_DIR": {"type": "path", "apply": "restart"},
}

_PROFILE_DEFAULTS = {
    "TPUFRAME_PROFILE_STEPS": 0,   # 0 = capture disarmed
    "TPUFRAME_PROFILE_EVERY": 0,   # 0 = one capture, no cadence
    "TPUFRAME_PROFILE_KEEP": 3,    # capture dirs retained per rank
    "TPUFRAME_PROFILE_DIR": "",
}


def profile_env(environ: dict | None = None) -> dict:
    """Parsed ``TPUFRAME_PROFILE_*`` knobs + defaults, with malformed
    values *reported* (an ``errors`` dict), never raised."""
    env = os.environ if environ is None else environ
    out: dict = dict(_PROFILE_DEFAULTS)
    errors: dict[str, str] = {}
    for knob in ("TPUFRAME_PROFILE_STEPS", "TPUFRAME_PROFILE_EVERY",
                 "TPUFRAME_PROFILE_KEEP"):
        raw = env.get(knob, "").strip()
        if not raw:
            continue
        try:
            v = int(raw)
            if v < 0:
                raise ValueError("negative")
        except ValueError:
            errors[knob] = f"not a non-negative int: {raw!r}"
            continue
        out[knob] = v
    if env.get("TPUFRAME_PROFILE_DIR", "").strip():
        out["TPUFRAME_PROFILE_DIR"] = env["TPUFRAME_PROFILE_DIR"].strip()
    out["errors"] = errors
    return out


# -- trace file discovery -----------------------------------------------------

#: ``tensorboard_trace_handler``'s file name: ``<worker>.<ns>.pt.trace.json``
_KINETO_FILE = re.compile(r"^(?P<worker>.+)\.(?P<ts>\d+)\.pt\.trace\.json(\.gz)?$")


def _newest_per_worker(files: list[str]) -> list[str]:
    """Of torch.profiler's files, the newest of each worker (every stop
    writes one more into the same dir); other trace files stay."""
    newest: dict[str, tuple[int, str]] = {}
    out = []
    for p in files:
        m = _KINETO_FILE.match(os.path.basename(p))
        if m is None:
            out.append(p)
            continue
        ts = int(m.group("ts"))
        if m.group("worker") not in newest or ts > newest[m.group("worker")][0]:
            newest[m.group("worker")] = (ts, p)
    return sorted(out + [p for _, p in newest.values()])


def find_trace_files(logdir: str) -> list[str]:
    """The trace files of the **newest** capture in ``logdir``: one a
    worker of torch.profiler's ``<worker>.<ts>.pt.trace.json[.gz]``.
    Empty list when nothing parseable exists."""
    files = sorted(glob.glob(os.path.join(logdir, "*.trace.json.gz")))
    files += sorted(glob.glob(os.path.join(logdir, "*.trace.json")))
    return _newest_per_worker(files)


def list_captures(profile_dir: str) -> list[str]:
    """Capture dirs under a ``TPUFRAME_PROFILE_DIR``, oldest-first: the
    rotation order the cadence callback maintains (newest last)."""
    out = []
    try:
        names = sorted(os.listdir(profile_dir))
    except OSError:
        return []
    for name in names:
        p = os.path.join(profile_dir, name)
        if os.path.isdir(p) and name.startswith("capture-"):
            out.append(p)
    return out


def load_trace(path: str) -> dict:
    """One Chrome Trace Event JSON file (gzipped or plain)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        return json.load(f)


# -- op classification --------------------------------------------------------

#: Kineto's categories of the events that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_TRANSFER_CATEGORIES = ("gpu_memcpy", "gpu_memset")

#: base-name prefixes that put an op on the wire.  Matched against the
#: op name lowercased with its instance suffix stripped.  ``nccl`` covers
#: NCCL's kernels (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``).
_COLLECTIVE_PREFIXES = (
    "all-reduce", "allreduce", "all-gather", "allgather",
    "reduce-scatter", "reducescatter", "all-to-all", "alltoall",
    "collective", "partial-reduce", "ncclallreduce", "send", "recv",
    "nccl",
)

#: host<->device transfers (infeed/outfeed, explicit copies, CUDA's
#: ``Memcpy HtoD (...)`` and ``Memset (Device)``).
_TRANSFER_PREFIXES = (
    "infeed", "outfeed", "copy", "memcpy", "h2d", "d2h",
    "transfer", "device-to-host", "host-to-device", "memset",
)

_TRAILING_ID = re.compile(r"\.\d+$")
_INDUCTOR_ID = re.compile(r"_\d+$")


def _base_name(name: str) -> str:
    """The top-op table's key: ``dot.42`` -> ``dot`` (JAX's HLO instance
    id); ``void at::native::vectorized_elementwise_kernel<4, ...>(int,
    ...)`` -> ``at::native::vectorized_elementwise_kernel`` (a CUDA
    kernel's template arguments and parameters); ``triton_poi_fused_add_3``
    -> ``triton_poi_fused_add`` (Inductor's numbered kernels)."""
    n = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    n = re.split(r"[<(]", n, maxsplit=1)[0].strip() or n
    n = _TRAILING_ID.sub("", n)
    if n.startswith("triton_"):
        n = _INDUCTOR_ID.sub("", n)
    return n


def classify_op(name: str, cat: str | None = None) -> str | None:
    """``"collective"`` / ``"transfer"`` / ``"compute"``, or None for
    runtime infra that is not device work.

    With Kineto's ``cat`` of a device event: a copy or memset is a
    transfer, a kernel whose name is a collective's (NCCL's) a collective,
    every other kernel compute.  Without it, JAX's rules over the name:
    ``::`` bookkeeping spans (``ThunkExecutor::Execute``) and ``$``
    computations are None, unless the name is a demangled CUDA kernel
    (``void ns::kernel<...>(...)``)."""
    if cat in _TRANSFER_CATEGORIES:
        return "transfer"
    if not name:
        return None
    kernel = cat == "kernel" or name.startswith("void ")
    if not kernel and ("::" in name or name.startswith("$")):
        return None
    base = _base_name(name).lower()
    for p in _COLLECTIVE_PREFIXES:
        if base.startswith(p):
            return "collective"
    if kernel:
        return "compute"
    for p in _TRANSFER_PREFIXES:
        if base.startswith(p):
            return "transfer"
    return "compute"


# -- device-track selection ---------------------------------------------------


def _tracks(trace: dict) -> dict[tuple[Any, Any], dict]:
    """(pid, tid) -> {"process", "thread", "events": [(name, ts, dur,
    cat)]} for the device tracks of one trace file (ts/dur in µs).

    A Kineto trace's device events are those whose ``cat`` is in
    :data:`DEVICE_CATEGORIES` (``pid`` the device, named ``GPU <pid>``;
    ``tid`` the stream); host events never count, nor Kineto's
    ``gpu_user_annotation`` ranges (``nccl:all_reduce``, ``gloo:all_reduce``),
    which frame device work rather than being it."""
    events = trace.get("traceEvents") or []
    tnames = {(ev.get("pid"), ev.get("tid")): str((ev.get("args") or {}).get("name", ""))
              for ev in events if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    tracks: dict[tuple[Any, Any], dict] = {}
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat not in DEVICE_CATEGORIES:
            continue
        key = (ev.get("pid"), ev.get("tid"))
        # Kineto names every pid after the host process; a device
        # event's pid is the card, its tid the stream
        pname, tname = f"GPU {key[0]}", (tnames.get(key, "").strip() or f"stream {key[1]}")
        try:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        if dur <= 0:
            continue
        tr = tracks.setdefault(key, {"process": pname, "thread": tname,
                                     "events": []})
        tr["events"].append((str(ev.get("name", "")), ts, dur, cat))
    return tracks


def count_device_events(source: str | dict) -> int:
    """Device events of a capture (a dir, a file or a loaded trace) that
    classify as device work: 0 says the profiler saw the card do
    nothing, which no report may pass off as an empty window."""
    if isinstance(source, dict):
        traces = [source]
    else:
        files = [source] if os.path.isfile(source) else find_trace_files(source)
        traces = []
        for p in files:
            try:
                traces.append(load_trace(p))
            except (OSError, ValueError):
                continue
    return sum(1 for trace in traces for tr in _tracks(trace).values()
               for name, _ts, _dur, cat in tr["events"] if classify_op(name, cat))


# -- interval math ------------------------------------------------------------


def interval_union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted, non-overlapping union of ``(start, end)`` pairs."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: list[tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def interval_subtract(a: Sequence[tuple[float, float]],
                      b: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    """``a - b`` where both are merged unions: the parts of ``a`` not
    covered by ``b`` (the exposed-comms primitive: collective time with
    the compute union carved out)."""
    out: list[tuple[float, float]] = []
    j = 0
    for a0, a1 in a:
        lo = a0
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < a1:
            b0, b1 = b[k]
            if b0 > lo:
                out.append((lo, min(b0, a1)))
            lo = max(lo, b1)
            if lo >= a1:
                break
            k += 1
        if lo < a1:
            out.append((lo, a1))
    return out


def _union_len(union: Sequence[tuple[float, float]]) -> float:
    return sum(b - a for a, b in union)


# -- the device_time record ---------------------------------------------------

#: the record's version, the JAX package's (its keys are the same)
DEVICE_TIME_VERSION = "1.1"

_CLASSES = ("compute", "collective", "transfer")


def device_time_report(source: str | dict, *, steps: int | None = None,
                       top_k: int = 10) -> dict | None:
    """Reduce a capture to the ``device_time`` record, or None when the
    source holds no parseable device events.

    ``source`` is a capture dir (discovery via :func:`find_trace_files`),
    a single trace file path, or an already-loaded trace dict.  ``steps``
    (when the capture side knows how many train steps the window covered)
    adds the per-step divisions ``device_step_s`` /
    ``exposed_comms_per_step_s``.

    All aggregate seconds are **per device** means, so ``window_s`` stays
    comparable across topologies; ``device_tracks`` records the fan-in.
    The identity ``busy_s + idle_s == window_s`` holds exactly per
    device; per-class walls are interval unions, so they only sum above
    ``busy_s`` where classes genuinely overlapped.
    """
    if isinstance(source, dict):
        traces = [source]
        trace_dir = None
    elif os.path.isfile(source):
        traces, trace_dir = [load_trace(source)], os.path.dirname(source)
    else:
        files = find_trace_files(source)
        if not files:
            return None
        traces, trace_dir = [], os.path.dirname(files[0])
        for p in files:
            try:
                traces.append(load_trace(p))
            except (OSError, ValueError):
                continue  # torn/partial capture file: parse what exists

    # one timeline per device: merge a device's streams (or a CPU thread
    # pool's threads) into per-class interval unions
    per_device: dict[tuple[int, Any], dict] = {}
    op_totals: dict[str, dict] = {}
    for i, trace in enumerate(traces):
        for (pid, _tid), tr in _tracks(trace).items():
            dev = per_device.setdefault(
                (i, pid),
                {cls: [] for cls in _CLASSES} | {"events": 0},
            )
            for name, ts, dur, cat in tr["events"]:
                cls = classify_op(name, cat)
                if cls is None:
                    continue
                dev[cls].append((ts, ts + dur))
                dev["events"] += 1
                agg = op_totals.setdefault(
                    _base_name(name), {"count": 0, "total_us": 0.0, "class": cls}
                )
                agg["count"] += 1
                agg["total_us"] += dur

    per_device = {k: d for k, d in per_device.items() if d["events"]}
    if not per_device:
        return None

    n_dev = len(per_device)
    window_s = busy_s = idle_s = exposed_s = 0.0
    classes = {cls: {"wall_s": 0.0, "events": 0} for cls in _CLASSES}
    for dev in per_device.values():
        unions = {cls: interval_union(dev[cls]) for cls in _CLASSES}
        all_union = interval_union(
            iv for cls in _CLASSES for iv in unions[cls]
        )
        if not all_union:
            continue
        span = all_union[-1][1] - all_union[0][0]
        busy = _union_len(all_union)
        window_s += span / 1e6
        busy_s += busy / 1e6
        idle_s += (span - busy) / 1e6
        exposed_s += _union_len(
            interval_subtract(unions["collective"], unions["compute"])
        ) / 1e6
        for cls in _CLASSES:
            classes[cls]["wall_s"] += _union_len(unions[cls]) / 1e6
            classes[cls]["events"] += len(dev[cls])

    window_s /= n_dev
    busy_s /= n_dev
    idle_s /= n_dev
    exposed_s /= n_dev
    for cls in _CLASSES:
        classes[cls]["wall_s"] = round(classes[cls]["wall_s"] / n_dev, 6)

    collective_wall = classes["collective"]["wall_s"]
    total_device_us = sum(a["total_us"] for a in op_totals.values())
    top = sorted(op_totals.items(), key=lambda kv: -kv[1]["total_us"])[:top_k]
    top_ops = [
        {
            "name": name,
            "class": agg["class"],
            "count": agg["count"],
            "total_s": round(agg["total_us"] / 1e6, 6),
            "pct": round(100.0 * agg["total_us"] / total_device_us, 2)
            if total_device_us > 0 else 0.0,
        }
        for name, agg in top
    ]
    out: dict = {
        "schema_version": DEVICE_TIME_VERSION,
        "trace_dir": trace_dir,
        "device_tracks": n_dev,
        "steps": steps,
        "window_s": round(window_s, 6),
        "busy_s": round(busy_s, 6),
        "idle_s": round(idle_s, 6),
        "classes": classes,
        "exposed_comms_s": round(exposed_s, 6),
        "overlap_efficiency": (
            round(1.0 - exposed_s / collective_wall, 4)
            if collective_wall > 0 else None
        ),
        "device_step_s": (
            round(window_s / steps, 6) if steps else None
        ),
        "exposed_comms_per_step_s": (
            round(exposed_s / steps, 6) if steps else None
        ),
        "top_ops": top_ops,
    }
    return out


def device_trace_events(source: str, *, limit: int = 200_000) -> list[dict]:
    """Flat device op events for Perfetto merging: ``{device, thread,
    name, class, ts_us, dur_us}``.  ``ts_us`` is the µs offset from the
    trace file's first event (Kineto writes absolute microseconds); the
    analyzer anchors it on the capture's recorded wall start so host spans
    and device ops share one timeline.  Bounded by ``limit``."""
    out: list[dict] = []
    if os.path.isfile(source):
        files = [source]
    else:
        files = find_trace_files(source)
    for p in files:
        try:
            trace = load_trace(p)
        except (OSError, ValueError):
            continue
        starts = [float(ev["ts"]) for ev in trace.get("traceEvents") or []
                  if ev.get("ph") == "X" and isinstance(ev.get("ts"), (int, float))]
        t0 = min(starts, default=0.0)
        for (pid, tid), tr in sorted(_tracks(trace).items(),
                                     key=lambda kv: str(kv[0])):
            dev = tr["process"] or str(pid)
            for name, ts, dur, cat in tr["events"]:
                cls = classify_op(name, cat)
                if cls is None:
                    continue
                out.append({
                    "device": dev,
                    "thread": tr["thread"] or str(tid),
                    "name": name,
                    "class": cls,
                    "ts_us": ts - t0,
                    "dur_us": dur,
                })
                if len(out) >= limit:
                    return out
    return out
