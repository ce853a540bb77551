"""Fleet-level trace analysis: cross-rank JSONL merge, skew, stragglers.

Port of ``tpuframe/track/analyze.py``, a stdlib copy over the port's
telemetry (the same ``events-rank<N>.jsonl`` schema) and its device-time
parser (``track/device_time.py``, torch.profiler's traces):

- :func:`load_dir` merges a ``TPUFRAME_TELEMETRY_DIR`` of per-rank logs
  (rotated segments included, oldest-first) and aligns ranks on the
  wall/monotonic **anchor pair** from each log's ``meta`` first line.
- :func:`build_trace` renders the merged fleet as a Chrome/Perfetto
  ``trace.json``: one process track per rank (named ``rank N @ host``),
  one thread track per instrumented thread, spans as complete events,
  stalls/faults/stragglers as instant events, and a rank's newest
  profiler capture as device tracks under its pid.
- :func:`skew_report` builds the per-step cross-rank skew table: for
  each ``train/step`` batch index, min/median/max wall time, the
  slowest rank, time lost to the straggler, and an input-bound vs
  compute-bound vs checkpoint-bound classification.
- :func:`baseline_diff` compares the run's step-time distribution
  against the JSON records at a path the caller names (any record
  carrying a ``step_time`` block).
- :class:`StragglerMonitor` is the *live* counterpart, wired into the
  Trainer: each rank keeps a rolling step-time EWMA in the registry
  (``train/step_ewma_s``), and every ``sync_steps`` steps the fleet
  compares EWMAs through one float64 ``all_gather_into_tensor`` on the
  default process group, bounded by ``TPUFRAME_FLEET_TIMEOUT_S``.  A
  rank exceeding the fleet median by ``factor`` emits a
  ``train/straggler`` event and the ``train/skew_ratio`` gauge.  One
  process (or no group) degrades to a self-baseline: the current EWMA
  against the rank's own median step time.

CLI: ``python -m tpuframe_torch.track analyze <dir> [--trace out.json]
[--report] [--baseline results/]``: stdlib only, never imports torch
(analyzing a wedged fleet's logs must not need the card).
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import re
import statistics
import sys
import time
from collections import deque
from typing import Any, Callable, Iterable, Sequence

from tpuframe_torch.track.device_time import device_time_report, device_trace_events
from tpuframe_torch.track.telemetry import Histogram, get_telemetry

__all__ = [
    "RankLog",
    "StragglerMonitor",
    "baseline_diff",
    "build_trace",
    "fleet_allgather",
    "fleet_degraded",
    "format_report",
    "load_dir",
    "load_dirs",
    "load_rank",
    "main",
    "reset_fleet_degraded",
    "skew_report",
]

_RANK_RE = re.compile(r"events-rank(\d+)\.jsonl$")

#: envelope keys every record carries; everything else is event payload
_ENVELOPE = ("v", "ts", "mono", "rank", "pid", "thread", "kind", "name")

#: span names that mark checkpoint I/O for boundedness classification
_CKPT_SPANS = ("ckpt/save", "ckpt/restore", "fault/preempt_checkpoint")

#: records that carry compile wall: AOT spans from the precompiler plus
#: the cache listener's per-real-compile events (the listener suppresses
#: its event inside an explicit compile span, so summing both never
#: double-counts one compile)
_COMPILE_RECORDS = ("compile/lower", "compile/backend_compile")


# -- loading + clock alignment ------------------------------------------------


class RankLog:
    """One rank's merged event stream + its clock-alignment offsets.

    ``meta`` is the log's first ``meta`` record (or None for pre-meta
    logs).  With a meta anchor pair, :meth:`end_time` places a record at
    ``mono + (anchor_wall - anchor_mono)`` — the rank's steady monotonic
    clock mapped onto the wall timeline fixed at configure time, immune
    to mid-run wall-clock steps.  Anchors are kept **per pid**: a
    restarted process appending to the same log brings a fresh monotonic
    epoch (near zero after a host reboot), so its events must align with
    *its own* meta, not the dead predecessor's.  Records with no usable
    anchor fall back to their raw ``ts``.
    """

    def __init__(self, rank: int, events: list[dict], *,
                 meta: dict | None = None, path: str | None = None,
                 metas: Sequence[dict] = ()):
        self.rank = rank
        self.events = events
        self.meta = meta
        self.path = path
        # pid -> (anchor_wall - anchor_mono); the newest meta per pid
        # wins (a re-configure within one process is a re-calibration)
        self.pid_offsets: dict[Any, float] = {}
        for m in list(metas) or ([meta] if meta else []):
            aw, am = m.get("anchor_wall"), m.get("anchor_mono")
            if aw is not None and am is not None:
                self.pid_offsets[m.get("pid")] = float(aw) - float(am)
        self.mono_offset: float | None = None
        if meta is not None:
            aw, am = meta.get("anchor_wall"), meta.get("anchor_mono")
            if aw is not None and am is not None:
                self.mono_offset = float(aw) - float(am)

    @property
    def hostname(self) -> str:
        return (self.meta or {}).get("hostname", "") or ""

    def end_time(self, rec: dict) -> float:
        """Fleet-aligned wall-clock time a record was written at."""
        mono = rec.get("mono")
        offset = self.pid_offsets.get(rec.get("pid"), self.mono_offset)
        if mono is not None and offset is not None:
            return float(mono) + offset
        return float(rec.get("ts", 0.0))

    def __repr__(self):
        return (f"RankLog(rank={self.rank}, events={len(self.events)}, "
                f"host={self.hostname!r})")


def _segments(base: str) -> list[str]:
    """A log's files oldest-first: ``base.K`` .. ``base.1``, then ``base``
    (the rotation order `telemetry.Telemetry._rotate_locked` produces)."""
    suffixes = []
    for p in glob.glob(base + ".*"):
        suf = p[len(base) + 1:]
        if suf.isdigit():
            suffixes.append(int(suf))
    return [f"{base}.{n}" for n in sorted(suffixes, reverse=True)] + [base]


def load_rank(base: str) -> RankLog:
    """Parse one rank's log (rotated segments in order).  Torn trailing
    lines (a crash mid-write) and blank lines are skipped, not fatal —
    the analyzer's whole job is reading logs of runs that died."""
    events: list[dict] = []
    metas: list[dict] = []
    for path in _segments(base):
        try:
            f = open(path)
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn line
                if not isinstance(rec, dict):
                    continue
                if rec.get("kind") == "meta":
                    # every meta kept: a restarted process appended its
                    # own anchors, and RankLog aligns per pid
                    metas.append(rec)
                else:
                    events.append(rec)
    meta = metas[0] if metas else None
    m = _RANK_RE.search(base)
    if m:
        rank = int(m.group(1))
    elif meta is not None:
        rank = int(meta.get("rank", 0))
    else:
        rank = int(events[0].get("rank", 0)) if events else 0
    return RankLog(rank, events, meta=meta, path=base, metas=metas)


def load_dir(d: str) -> list[RankLog]:
    """All ranks under a telemetry dir, rank-ordered."""
    bases = sorted(
        p for p in glob.glob(os.path.join(d, "events-rank*.jsonl"))
        if _RANK_RE.search(p)
    )
    if not bases:
        raise FileNotFoundError(
            f"no events-rank*.jsonl under {d!r} — is this a "
            "TPUFRAME_TELEMETRY_DIR?"
        )
    ranks = [load_rank(b) for b in bases]
    ranks.sort(key=lambda r: r.rank)
    return ranks


def load_dirs(dirs: Sequence[str]) -> list[RankLog]:
    """Multiple telemetry dirs stitched into one rank list.

    The multi-process serve topology (router + N replica servers, each
    its own process with its own ``TPUFRAME_TELEMETRY_DIR``) logs rank 0
    in every dir; loading them together must not collapse those onto one
    Perfetto track.  Colliding rank numbers from later dirs are offset
    by +1000 per collision — each process keeps its own pid lane — while
    the per-pid wall/mono anchors (which travel inside each log) do the
    cross-process time alignment, so one trace id lines up across all of
    them.  A single dir loads exactly like :func:`load_dir`.
    """
    all_ranks: list[RankLog] = []
    used: set[int] = set()
    for d in dirs:
        for rl in load_dir(d):
            r = rl.rank
            while r in used:
                r += 1000
            rl.rank = r
            used.add(r)
            all_ranks.append(rl)
    all_ranks.sort(key=lambda r: r.rank)
    return all_ranks


# -- Perfetto / Chrome trace --------------------------------------------------


def _fleet_t0(ranks: Sequence[RankLog]) -> float:
    """Earliest aligned instant across the fleet (span starts included)."""
    t0 = None
    for rl in ranks:
        for rec in rl.events:
            t = rl.end_time(rec)
            if rec.get("kind") == "span":
                t -= float(rec.get("dur_s", 0.0))
            if t0 is None or t < t0:
                t0 = t
    return t0 or 0.0


def _clip(v: Any, cap: int = 400) -> Any:
    return v[:cap] if isinstance(v, str) and len(v) > cap else v


def build_trace(ranks: Sequence[RankLog]) -> dict:
    """Chrome Trace Event JSON (Perfetto/chrome://tracing loadable).

    One ``pid`` per rank, one ``tid`` per thread; spans become complete
    ("X") events at microsecond resolution, everything else becomes an
    instant ("i") event — stalls, faults, stragglers, bench attempts.
    """
    t0 = _fleet_t0(ranks)
    out: list[dict] = []
    for rl in ranks:
        pid = rl.rank
        label = f"rank {rl.rank}" + (f" @ {rl.hostname}" if rl.hostname else "")
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": label}})
        out.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                    "args": {"sort_index": rl.rank}})
        tids: dict[str, int] = {}

        def tid_for(thread: str) -> int:
            if thread not in tids:
                # MainThread pinned to tid 0; helpers in appearance order
                tids[thread] = 0 if thread == "MainThread" else len(tids) + 1
            return tids[thread]

        for rec in rl.events:
            t_end = rl.end_time(rec)
            tid = tid_for(str(rec.get("thread", "?")))
            name = str(rec.get("name", "?"))
            payload = {k: _clip(v) for k, v in rec.items()
                       if k not in _ENVELOPE and k != "attrs"}
            payload.update(
                {k: _clip(v) for k, v in (rec.get("attrs") or {}).items()}
            )
            if rec.get("kind") == "span":
                dur = float(rec.get("dur_s", 0.0))
                ev = {
                    "ph": "X", "pid": pid, "tid": tid, "name": name,
                    "cat": name.split("/")[0],
                    "ts": round((t_end - dur - t0) * 1e6, 1),
                    "dur": round(dur * 1e6, 1),
                    "args": {k: v for k, v in payload.items()
                             if k not in ("dur_s", "stack", "ok")},
                }
                if not rec.get("ok", True):
                    ev["cname"] = "terrible"  # failed spans read red
            else:
                ev = {
                    "ph": "i", "pid": pid, "tid": tid, "name": name,
                    "cat": str(rec.get("kind", "event")),
                    "ts": round((t_end - t0) * 1e6, 1),
                    "s": "t",  # thread-scoped flag
                    "args": payload,
                }
            out.append(ev)
        for thread, tid in tids.items():
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": thread}})
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
        # device tracks: the rank's newest surviving profiler capture
        # merges under the SAME pid, so host spans and device ops share
        # one timeline.  Trace timestamps are µs offsets from capture
        # start; the profile/capture event recorded that start as a
        # wall/mono anchor pair, aligned exactly like any other record.
        cap = None
        for rec in rl.events:
            if rec.get("name") == "profile/capture" and rec.get("dir"):
                if os.path.isdir(str(rec["dir"])):
                    cap = rec
        if cap is not None:
            cap_t0 = rl.end_time({
                "mono": cap.get("mono_start"),
                "ts": cap.get("wall_start") or 0.0,
                "pid": cap.get("pid"),
            })
            dev_tids: dict[str, int] = {}
            for dev_ev in device_trace_events(str(cap["dir"])):
                key = f"{dev_ev['device']} {dev_ev['thread']}"
                # device tids live above 1000: no collision with the
                # appearance-ordered host thread tids
                tid = dev_tids.setdefault(key, 1000 + len(dev_tids))
                out.append({
                    "ph": "X", "pid": pid, "tid": tid,
                    "name": dev_ev["name"],
                    "cat": f"device/{dev_ev['class']}",
                    "ts": round(
                        (cap_t0 + dev_ev["ts_us"] / 1e6 - t0) * 1e6, 1
                    ),
                    "dur": round(dev_ev["dur_us"], 1),
                    "args": {"class": dev_ev["class"]},
                })
            for key, tid in dev_tids.items():
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name", "args": {"name": key}})
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_sort_index",
                            "args": {"sort_index": tid}})
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "tpuframe_torch.track.analyze",
            "ranks": len(ranks),
            "t0_unix_s": round(t0, 6),
        },
    }


# -- cross-rank skew ----------------------------------------------------------


# ONE quantile convention repo-wide: whatever the registry histograms
# report on /metrics is what baseline_diff ratios against — a fix to the
# index rule must land in telemetry.Histogram and flow here
_pctl = Histogram._quantile


def _step_rows(rl: RankLog) -> dict[int, dict]:
    """This rank's ``train/step`` spans keyed by batch index, with the
    inter-step period (``wall_s``) that captures everything between step
    boundaries — data wait, dispatch, mid-epoch checkpoints, GC pauses,
    callbacks.  However large: a 10 s checkpoint stall between 0.1 s
    steps is exactly what the skew report exists to surface, so the
    period is only rejected on *structural* grounds — a different pid
    (restart appended to the same log) or an epoch boundary in between
    (eval/epoch turnover time is not one step's cost) — never because
    it is "too big"."""
    epoch_ends = sorted(
        rl.end_time(rec) for rec in rl.events
        if rec.get("kind") == "span" and rec.get("name") == "train/epoch"
    )

    def crosses_epoch_boundary(a: float, b: float) -> bool:
        i = bisect.bisect_right(epoch_ends, a)
        return i < len(epoch_ends) and epoch_ends[i] < b

    rows: dict[int, dict] = {}
    prev_end: float | None = None
    prev_batch: int | None = None
    prev_pid: Any = None
    for rec in rl.events:
        if rec.get("kind") != "span" or rec.get("name") != "train/step":
            continue
        attrs = rec.get("attrs") or {}
        batch = attrs.get("batch")
        if batch is None:
            continue
        batch = int(batch)
        end = rl.end_time(rec)
        dur = float(rec.get("dur_s", 0.0))
        wait = float(attrs.get("data_wait_s", 0.0))
        wall = dur + wait
        if (
            prev_end is not None
            and prev_batch == batch - 1
            and rec.get("pid") == prev_pid
            and not crosses_epoch_boundary(prev_end, end)
        ):
            period = end - prev_end
            if period >= wall:
                wall = period
        rows[batch] = {"dur_s": dur, "data_wait_s": wait, "end": end,
                       "wall_s": wall}
        prev_end, prev_batch = end, batch
        prev_pid = rec.get("pid")
    return rows


def _ckpt_windows(rl: RankLog) -> list[tuple[float, float]]:
    wins = []
    for rec in rl.events:
        if rec.get("kind") == "span" and rec.get("name") in _CKPT_SPANS:
            end = rl.end_time(rec)
            wins.append((end - float(rec.get("dur_s", 0.0)), end))
    return wins


def _classify(entry: dict, ckpt_wins: list[tuple[float, float]]) -> str:
    """Why was the slowest rank's step slow?  Checkpoint overlap beats
    input wait beats the compute default."""
    start = entry["end"] - entry["wall_s"]
    for a, b in ckpt_wins:
        if b > start and a < entry["end"]:
            return "checkpoint"
    if entry["data_wait_s"] >= 0.5 * max(entry["wall_s"], 1e-12):
        return "input"
    return "compute"


def _compile_wall(rl: RankLog) -> dict:
    """Measured compile wall in this rank's log: ``compile/lower`` +
    ``compile/backend_compile`` spans (the AOT path) and
    ``compile/backend_compile`` events (implicit runtime compiles, each
    a real backend compile — persistent-cache hits emit none)."""
    wall, n = 0.0, 0
    for rec in rl.events:
        if rec.get("name") not in _COMPILE_RECORDS:
            continue
        try:
            wall += float(rec.get("dur_s", 0.0))
        except (TypeError, ValueError):
            continue
        n += 1
    return {"wall_s": round(wall, 6), "records": n}


def _health_info(rl: RankLog) -> dict:
    """Training-health sentinel records in this rank's log: skipped
    (bad) steps, divergences raised, rollbacks performed — the
    skip -> escalate -> rollback ladder's event trail."""
    bad_steps, bad_events, divergences = 0, 0, 0
    rollbacks: list[dict] = []
    for rec in rl.events:
        name = rec.get("name")
        if name == "health/bad_step":
            bad_events += 1
            try:
                bad_steps += int(rec.get("bad_in_window", 1) or 1)
            except (TypeError, ValueError):
                bad_steps += 1
        elif name == "health/divergence":
            divergences += 1
        elif name == "fault/rollback":
            rollbacks.append({
                "to_step": rec.get("to_step"),
                "quarantined": rec.get("quarantined"),
            })
    return {
        "bad_steps": bad_steps,
        "bad_step_events": bad_events,
        "divergences": divergences,
        "rollbacks": rollbacks,
    }


def _device_time_info(ranks: Sequence[RankLog]) -> dict | None:
    """The parsed ``device_time`` block: the NEWEST ``profile/capture``
    event whose trace dir still exists on disk (the cadence callback
    rotates old captures away; a one-shot temp capture is zipped into an
    artifact and its dir deleted — both read as "no parseable capture",
    not an error).  Parsing is the stdlib gzip+json path in
    `track/device_time.py`, no torch, so a wedged fleet's capture still
    attributes.  A capture whose trace holds no device event reads as no
    block, and its ``profile/capture`` event says ``device_events: 0``."""
    best: tuple[int, dict] | None = None
    captures = 0
    for rl in ranks:
        for rec in rl.events:
            if rec.get("name") != "profile/capture":
                continue
            captures += 1
            d = rec.get("dir")
            if d and os.path.isdir(str(d)):
                best = (rl.rank, rec)
    if best is None:
        return None
    rank, rec = best
    try:
        steps = int(rec.get("steps") or 0) or None
    except (TypeError, ValueError):
        steps = None
    dt = device_time_report(str(rec["dir"]), steps=steps)
    if dt is None:
        return None
    dt["rank"] = rank
    dt["captures"] = captures
    dt["partial"] = bool(rec.get("partial"))
    return dt


def _time_to_first_step(rl: RankLog) -> float | None:
    """Seconds from this rank's first telemetry record to the end of its
    first ``train/step`` span — what a cold start actually cost the rank
    (loader spin-up, compile, restore, the step itself)."""
    t0: float | None = None
    first_step: float | None = None
    for rec in rl.events:
        t = rl.end_time(rec)
        if rec.get("kind") == "span":
            t -= float(rec.get("dur_s", 0.0))
        if t0 is None or t < t0:
            t0 = t
        if (
            first_step is None
            and rec.get("kind") == "span"
            and rec.get("name") == "train/step"
        ):
            first_step = rl.end_time(rec)
    if t0 is None or first_step is None:
        return None
    return max(0.0, first_step - t0)


# -- request-path trace attribution -------------------------------------------

#: serve_trace block schema (versioned like device_time: additive ->
#: minor bump, rename/removal -> major bump + consumer update)
SERVE_TRACE_VERSION = "1.0"

#: span name -> hop key, in request-path order.  fleet/route and
#: fleet/hop come from the router (route = total front-door time, hop =
#: one forward attempt); door/queue_wait are per-request engine spans;
#: assemble/infer are batch-scoped (a ``traces`` list fans the one span
#: out to every member request); respond is the server's response write.
_TRACE_HOP_SPANS = {
    "fleet/route": "route",
    "fleet/hop": "hop",
    "serve/door": "door",
    "serve/queue_wait": "queue_wait",
    "serve/assemble": "assemble",
    "serve/infer": "infer",
    "serve/respond": "respond",
}

_TRACE_HOP_ORDER = (
    "route", "hop", "door", "queue_wait", "assemble", "infer", "respond",
)


def _span_field(rec: dict, key: str) -> Any:
    """A span attribute wherever it lives: ``tele.span`` nests kwargs in
    the ``attrs`` sub-dict, synthetic span records (``tele.event(...,
    kind="span")`` — cross-thread hops whose outcome is only known after
    the fact) carry them top-level."""
    v = rec.get(key)
    if v is None:
        v = (rec.get("attrs") or {}).get(key)
    return v


def _quantile_block(vals: list[float]) -> dict:
    vals = sorted(vals)
    return {
        "count": len(vals),
        "p50": round(_pctl(vals, 0.50), 6),
        "p95": round(_pctl(vals, 0.95), 6),
        "p99": round(_pctl(vals, 0.99), 6),
    }


def _serve_trace_info(ranks: Sequence[RankLog]) -> dict | None:
    """Per-hop request-path attribution from the trace-tagged spans the
    router/server/engine emit; None when the run traced nothing.

    Durations accumulate **per trace id** first (a retried request's two
    ``fleet/hop`` spans sum; a batch-scoped ``serve/infer`` charges its
    full duration to every member trace — the batch is the unit of
    device work each rider waits for), then quantile per hop, so the
    hop p50/p95/p99 are distributions over *requests*, comparable with
    the end-to-end latency distribution: ``queue_wait + assemble +
    infer`` tiles the engine-side path, and e2e minus the hop sum is
    unattributed transport/scheduling time.
    """
    per_trace: dict[str, dict[str, float]] = {}
    route_spans = 0
    hop_spans = 0
    objectives: dict | None = None
    for rl in ranks:
        for rec in rl.events:
            if rec.get("name") == "slo/objectives":
                objectives = rec
                continue
            if rec.get("kind") != "span":
                continue
            hop = _TRACE_HOP_SPANS.get(rec.get("name"))
            if hop is None:
                continue
            try:
                dur = float(rec.get("dur_s", 0.0))
            except (TypeError, ValueError):
                continue
            traces = _span_field(rec, "traces")
            if not isinstance(traces, (list, tuple)):
                t = _span_field(rec, "trace")
                traces = [t] if t is not None else []
            if not traces:
                continue
            if hop == "route":
                route_spans += 1
            elif hop == "hop":
                hop_spans += 1
            for t in traces:
                hops = per_trace.setdefault(str(t), {})
                hops[hop] = hops.get(hop, 0.0) + dur
    if not per_trace:
        return None

    # end-to-end + breakouts from the serve/request events that carry a
    # trace id (engine-side served latency, replica/model tagged)
    e2e: dict[str, float] = {}
    by_replica: dict[str, list[float]] = {}
    by_model: dict[str, list[float]] = {}
    all_lats: list[float] = []
    for rl in ranks:
        for rec in rl.events:
            if rec.get("name") != "serve/request":
                continue
            lat = rec.get("latency_s")
            if not isinstance(lat, (int, float)):
                continue
            all_lats.append(float(lat))
            t = rec.get("trace")
            if t is None:
                continue
            e2e[str(t)] = float(lat)
            rep = rec.get("replica")
            if rep is not None:
                by_replica.setdefault(str(rep), []).append(float(lat))
            mdl = rec.get("model")
            if mdl is not None:
                by_model.setdefault(str(mdl), []).append(float(lat))

    hops_block = {
        hop: _quantile_block(
            [v[hop] for v in per_trace.values() if hop in v]
        )
        for hop in _TRACE_HOP_ORDER
        if any(hop in v for v in per_trace.values())
    }
    e2e_vals = list(e2e.values())
    e2e_sum = sum(e2e_vals)
    qw_sum = sum(v.get("queue_wait", 0.0) for t, v in per_trace.items()
                 if t in e2e)

    # SLO scoring against the objectives that were in force during the
    # run (the slo/objectives event), over every served request
    slo_block = None
    if objectives is not None and all_lats:
        p99_ms = objectives.get("p99_ms")
        availability = objectives.get("availability")
        if isinstance(p99_ms, (int, float)) \
                and isinstance(availability, (int, float)):
            bad = sum(1 for v in all_lats if v * 1e3 > p99_ms)
            frac = bad / len(all_lats)
            burn = frac / max(1e-9, 1.0 - float(availability))
            slo_block = {
                "p99_ms": p99_ms,
                "availability": availability,
                "requests": len(all_lats),
                "violations": bad,
                "violation_fraction": round(frac, 6),
                "burn_rate": round(burn, 4),
                "error_budget_remaining": round(max(0.0, 1.0 - burn), 4),
            }

    return {
        "version": SERVE_TRACE_VERSION,
        "traces": len(per_trace),
        "hops": hops_block,
        "e2e": _quantile_block(e2e_vals) if e2e_vals else None,
        # fraction of traced end-to-end time spent waiting in the queue
        # — the autoscaler's "add capacity" signal
        "queue_wait_share": (
            round(qw_sum / e2e_sum, 4) if e2e_sum > 0 else None
        ),
        # forward attempts per routed request; 1.0 = no retries
        "retry_amplification": (
            round(hop_spans / route_spans, 4) if route_spans else None
        ),
        "per_replica": {
            rep: _quantile_block(ls)
            for rep, ls in sorted(by_replica.items())
        } or None,
        "per_model": {
            mdl: _quantile_block(ls)
            for mdl, ls in sorted(by_model.items())
        } or None,
        "slo": slo_block,
    }


# -- skew_report as a library API ---------------------------------------------
# The baseline differ consumes skew_report's dict as a stable contract,
# the JAX package's (its autotuner too).  The key sets below ARE that
# contract: adding a key is backwards-compatible (bump the minor),
# removing or renaming one breaks consumers (bump the major).
# 1.1: + device_time (parsed profiler capture)
# 1.2: + serve_trace (per-hop request-path attribution + SLO scoring)
# 1.3: + memory (watermarks, compiled executables, OOM forensics)
SKEW_REPORT_VERSION = "1.3"

# Top-level keys, always present (value may be None for the optional
# blocks: time_to_first_step, health, comms, serve_latency, serve_trace,
# device_time, memory, slowest).
SKEW_REPORT_KEYS = (
    "schema_version", "ranks", "hosts", "steps", "warmup_steps_skipped",
    "compile", "time_to_first_step", "health", "straggler_factor",
    "comms", "serve_latency", "serve_trace", "device_time", "memory",
    "step_time", "step_wall", "total_lost_s", "straggler_lost_s",
    "straggling_steps", "lost_by_bound", "slowest", "per_rank", "per_step",
)

# Memory block keys (1.3) — built from memory/watermark,
# memory/executable, and memory/oom events; the block is None when the
# run emitted none of them (memory plane off = incomparable, not zero).
SKEW_REPORT_MEMORY_KEYS = (
    "hbm_peak_mb", "host_peak_mb", "hbm_limit_mb", "hbm_peak_util",
    "peak_executable_mb", "executables", "ooms", "last_oom", "budget_mb",
)

# Row contracts for the two per-entity tables.
SKEW_REPORT_PER_RANK_KEYS = (
    "rank", "host", "steps", "excess_s", "straggling_steps",
    "data_wait_total_s",
)
SKEW_REPORT_PER_STEP_KEYS = (
    "batch", "n_ranks", "min_s", "median_s", "max_s", "slowest_rank",
    "lost_s", "bound", "straggling",
)

# The decomposition classes lost_by_bound always carries.
SKEW_REPORT_BOUNDS = ("input", "compute", "checkpoint")


def skew_report(ranks: Sequence[RankLog], *,
                straggler_factor: float = 1.5,
                warmup_steps: int = 1) -> dict:
    """The per-step cross-rank skew table + fleet aggregates.

    For every ``train/step`` batch index: min/median/max per-rank wall
    time, the slowest rank, ``lost_s`` (max - median: wall-clock the
    fleet spent waiting on the straggler that step, under synchronous
    data parallelism), and the boundedness class of the slowest rank.

    The first ``warmup_steps`` batch indices are dropped, for the same
    reason the live monitor's ``skip_first`` exists: they carry a
    compile (Inductor's under precompile, the kernels' first build), whose cross-rank jitter would read as a spurious
    compute straggler and whose hundreds-of-ms duration would pollute
    the ``step_time`` distribution committed as a regression baseline.
    """
    per_rank_rows = {rl.rank: _step_rows(rl) for rl in ranks}
    ckpt_wins = {rl.rank: _ckpt_windows(rl) for rl in ranks}
    all_batches = sorted({b for rows in per_rank_rows.values() for b in rows})
    all_batches = all_batches[max(0, int(warmup_steps)):]

    per_step: list[dict] = []
    excess: dict[int, float] = {rl.rank: 0.0 for rl in ranks}
    slow_count: dict[int, int] = {rl.rank: 0 for rl in ranks}
    lost_by_bound = {"input": 0.0, "compute": 0.0, "checkpoint": 0.0}
    all_durs: list[float] = []
    all_walls: list[float] = []

    for b in all_batches:
        walls = {r: rows[b]["wall_s"] for r, rows in per_rank_rows.items()
                 if b in rows}
        for r in walls:
            all_durs.append(per_rank_rows[r][b]["dur_s"])
            all_walls.append(walls[r])
        slowest = max(walls, key=lambda r: walls[r])
        med = statistics.median(walls.values())
        lost = max(0.0, walls[slowest] - med)
        bound = _classify(per_rank_rows[slowest][b], ckpt_wins[slowest])
        row = {
            "batch": b,
            "n_ranks": len(walls),
            "min_s": round(min(walls.values()), 6),
            "median_s": round(med, 6),
            "max_s": round(walls[slowest], 6),
            "slowest_rank": slowest,
            "lost_s": round(lost, 6),
            "bound": bound,
            "straggling": walls[slowest] > straggler_factor * max(med, 1e-12),
        }
        per_step.append(row)
        excess[slowest] += lost
        if row["straggling"]:
            slow_count[slowest] += 1
            lost_by_bound[bound] += lost

    durs = sorted(all_durs)
    walls = sorted(all_walls)
    step_time = {}
    if durs:
        step_time = {
            "count": len(durs),
            "mean": round(sum(durs) / len(durs), 6),
            "p50": round(_pctl(durs, 0.50), 6),
            "p95": round(_pctl(durs, 0.95), 6),
            "p99": round(_pctl(durs, 0.99), 6),
        }
    # serve-path latency: present only when the run served requests
    # (ServeEngine emits one serve/request event per served request).
    # Shaped like step_time so baseline_diff gates a p99 latency
    # regression with the same exit-3 discipline as a step-time one.
    serve_recs = [
        rec
        for rl in ranks for rec in rl.events
        if rec.get("name") == "serve/request"
        and isinstance(rec.get("latency_s"), (int, float))
    ]
    serve_lats = sorted(float(rec["latency_s"]) for rec in serve_recs)
    serve_latency = None
    if serve_lats:
        serve_latency = {
            "count": len(serve_lats),
            "mean": round(sum(serve_lats) / len(serve_lats), 6),
            "p50": round(_pctl(serve_lats, 0.50), 6),
            "p95": round(_pctl(serve_lats, 0.95), 6),
            "p99": round(_pctl(serve_lats, 0.99), 6),
        }
        # fleet runs tag each serve/request with the replica that served
        # it (ServeEngine(replica=...)); break the aggregate out so a
        # skewed replica is visible, while the gate stays on the
        # fleet-wide p99 above
        by_rep: dict = {}
        for rec in serve_recs:
            rep = rec.get("replica")
            if rep is not None:
                by_rep.setdefault(str(rep), []).append(
                    float(rec["latency_s"])
                )
        if by_rep:
            serve_latency["replicas"] = len(by_rep)
            serve_latency["per_replica"] = {
                rep: {
                    "count": len(ls),
                    "p50": round(_pctl(sorted(ls), 0.50), 6),
                    "p99": round(_pctl(sorted(ls), 0.99), 6),
                }
                for rep, ls in sorted(by_rep.items())
            }
    # comms block: present only when the run declared a wire plan (the
    # compressed train step emits one comms/wire_plan event at build).
    # bytes_per_step is static per signature; the run total multiplies
    # by the steps each rank dispatched.  allreduce_s quantiles appear
    # when the run timed standalone compressed collectives
    # (make_compressed_pmean / bench_collectives emit comms/allreduce
    # spans) — fused train steps carry the collective inside the step
    # program, so no per-collective wall exists to report there.
    comms_info = None
    wire_events = [
        rec for rl in ranks for rec in rl.events
        if rec.get("name") == "comms/wire_plan"
    ]
    if wire_events:
        w = wire_events[-1]
        steps_total = sum(len(rows) for rows in per_rank_rows.values())
        ar_durs = sorted(
            float(rec.get("dur_s", 0.0))
            for rl in ranks for rec in rl.events
            if rec.get("kind") == "span" and rec.get("name") == "comms/allreduce"
        )
        comms_info = {
            "mode": w.get("mode"),
            "world": w.get("world"),
            "error_feedback": w.get("error_feedback"),
            "bytes_per_step": w.get("bytes_per_step"),
            "f32_bytes_per_step": w.get("f32_bytes_per_step"),
            "reduction_x": w.get("reduction_x"),
            # the declared collective schedule (bucket groups fired in
            # reverse-backward order); bytes are invariant under it,
            # exposed-comms in the device_time block is what it moves
            "overlap_groups": w.get("overlap_groups"),
            "steps": steps_total,
            "bytes_on_wire": (
                (w.get("bytes_per_step") or 0) * steps_total
            ),
            "allreduce_s": {
                "count": len(ar_durs),
                "p50": round(_pctl(ar_durs, 0.50), 6),
                "p95": round(_pctl(ar_durs, 0.95), 6),
                "p99": round(_pctl(ar_durs, 0.99), 6),
            } if ar_durs else None,
        }
    # memory block: present only when the memory plane left a trail —
    # ratcheted memory/watermark events (live HBM/host peaks),
    # memory/executable records (AOT compiled truth), or memory/oom
    # forensics.  A run with the plane off keeps its report byte-stable.
    memory_info = None
    mem_execs: dict[str, float] = {}
    mem_hbm = mem_host = mem_limit = 0.0
    mem_ooms = 0
    mem_last_oom = None
    mem_budget = None
    for rl in ranks:
        for rec in rl.events:
            name = rec.get("name")
            if name == "memory/executable" and rec.get("label"):
                mem_execs[rec["label"]] = float(rec.get("peak_mb") or 0.0)
            elif name == "memory/watermark":
                mem_hbm = max(mem_hbm, float(rec.get("hbm_peak_mb") or 0.0))
                mem_host = max(mem_host, float(rec.get("host_peak_mb") or 0.0))
                mem_limit = max(mem_limit, float(rec.get("hbm_limit_mb") or 0.0))
            elif name == "memory/oom":
                mem_ooms += 1
                if rec.get("budget_mb"):
                    mem_budget = rec["budget_mb"]
                mem_last_oom = {
                    "where": rec.get("where"),
                    "step": rec.get("step"),
                    "estimate_total_mb": rec.get("estimate_total_mb"),
                    "suggestion": (rec.get("fit") or {}).get("suggestion"),
                }
    if mem_execs or mem_ooms or mem_hbm or mem_host:
        peak_exec = max(mem_execs.values(), default=0.0)
        memory_info = {
            "hbm_peak_mb": round(mem_hbm, 3) or None,
            "host_peak_mb": round(mem_host, 3) or None,
            "hbm_limit_mb": round(mem_limit, 3) or None,
            "hbm_peak_util": (
                round(mem_hbm / mem_limit, 4) if mem_hbm and mem_limit
                else None
            ),
            "peak_executable_mb": round(peak_exec, 3) or None,
            "executables": {
                label: round(v, 3) for label, v in sorted(mem_execs.items())
            },
            "ooms": mem_ooms,
            "last_oom": mem_last_oom,
            "budget_mb": mem_budget,
        }
    worst = max(excess, key=lambda r: excess[r]) if excess else None
    # measured compile wall: the warmup skip exists because the first
    # step carries the compile — report WHAT it carried instead of
    # silently dropping it ("first step cost X s of compile")
    per_rank_compile = {rl.rank: _compile_wall(rl) for rl in ranks}
    compile_info = {
        "wall_s": round(
            sum(c["wall_s"] for c in per_rank_compile.values()), 6
        ),
        "records": sum(c["records"] for c in per_rank_compile.values()),
        "per_rank": {r: c["wall_s"] for r, c in per_rank_compile.items()},
    }
    ttfs = {rl.rank: _time_to_first_step(rl) for rl in ranks}
    ttfs_vals = [t for t in ttfs.values() if t is not None]
    # training-health block: present only when the sentinel left a trail
    # (skipped steps / divergences / rollbacks) — a healthy run's report
    # stays exactly as it was
    per_rank_health = {rl.rank: _health_info(rl) for rl in ranks}
    health_info = None
    if any(
        h["bad_step_events"] or h["divergences"] or h["rollbacks"]
        for h in per_rank_health.values()
    ):
        health_info = {
            "bad_steps": sum(h["bad_steps"] for h in per_rank_health.values()),
            "divergences": sum(
                h["divergences"] for h in per_rank_health.values()
            ),
            "rollbacks": [
                rb for h in per_rank_health.values() for rb in h["rollbacks"]
            ],
            "per_rank": {
                r: h["bad_steps"] for r, h in per_rank_health.items()
            },
        }
    return {
        "schema_version": SKEW_REPORT_VERSION,
        "ranks": len(ranks),
        "hosts": sorted({rl.hostname for rl in ranks if rl.hostname}),
        "steps": len(per_step),
        "warmup_steps_skipped": max(0, int(warmup_steps)),
        "compile": compile_info,
        # the fleet is up when its SLOWEST rank takes its first step —
        # baseline-diffable like step_time (compile regressions gate)
        "time_to_first_step": {
            "s": round(max(ttfs_vals), 6),
            "per_rank": {
                r: (None if t is None else round(t, 6))
                for r, t in ttfs.items()
            },
        } if ttfs_vals else None,
        "health": health_info,
        "straggler_factor": straggler_factor,
        "comms": comms_info,             # wire traffic (baseline diffs)
        "serve_latency": serve_latency,  # request path (baseline diffs)
        # per-hop request-path attribution from trace-tagged spans
        # (queue-wait p99 + SLO burn rate gate via baseline diffs)
        "serve_trace": _serve_trace_info(ranks),
        # parsed profiler capture: per-class device wall, exposed comms,
        # the top-op table (baseline diffs on exposed/device-step)
        "device_time": _device_time_info(ranks),
        # watermarks + compiled executables + OOM forensics (baseline
        # diffs on ratio_peak_hbm)
        "memory": memory_info,
        "step_time": step_time,          # dispatch-only (baseline diffs)
        "step_wall": {                   # boundary-to-boundary
            "p50": round(_pctl(walls, 0.50), 6) if walls else None,
            "p95": round(_pctl(walls, 0.95), 6) if walls else None,
        },
        # total skew (max-median summed over EVERY step: jitter included)
        # vs the straggler share (only over-factor steps — this is the
        # number lost_by_bound decomposes, so the two always agree)
        "total_lost_s": round(sum(r["lost_s"] for r in per_step), 6),
        "straggler_lost_s": round(
            sum(r["lost_s"] for r in per_step if r["straggling"]), 6),
        "straggling_steps": sum(1 for r in per_step if r["straggling"]),
        "lost_by_bound": {k: round(v, 6) for k, v in lost_by_bound.items()},
        "slowest": None if worst is None else {
            "rank": worst,
            "excess_s": round(excess[worst], 6),
            "times_slowest": slow_count[worst],
        },
        "per_rank": [
            {
                "rank": rl.rank,
                "host": rl.hostname,
                "steps": len(per_rank_rows[rl.rank]),
                "excess_s": round(excess[rl.rank], 6),
                "straggling_steps": slow_count[rl.rank],
                "data_wait_total_s": round(
                    sum(e["data_wait_s"]
                        for e in per_rank_rows[rl.rank].values()), 6),
            }
            for rl in ranks
        ],
        "per_step": per_step,
    }


# -- baseline regression diff -------------------------------------------------


def baseline_diff(report: dict, baseline: str, *,
                  threshold: float = 1.25, backend: str | None = None) -> dict:
    """Compare this run's step-time distribution against bench records:
    any ``*.json`` file at ``baseline`` (a dir, or one file) whose
    top-level object carries a ``step_time`` block with ``p50``.

    ``ratio_p50 > threshold`` lands the pair in ``regressions``.
    Records carrying a ``time_to_first_step`` block diff the same way against the report's measured
    time-to-first-step — a compile-time regression gates exactly like a
    step-time regression (exit 3).  Records carrying a ``serve_latency``
    block with ``p99`` diff against the
    report's serve-path latency distribution: a p99 latency regression
    on the request path gates the same way.  Records carrying a
    ``serve_trace`` block diff
    the per-hop queue-wait p99 (``ratio_queue_wait_p99``) and the SLO
    burn rate (``ratio_burn_rate``) under the same discipline.  Records
    carrying a ``memory`` block diff
    the peak card-memory watermark — live when the backend reports device
    stats, else the compiled ``peak_executable_mb`` — as
    ``ratio_peak_hbm``: a plan whose footprint grew past threshold
    gates exactly like a slower step (exit 3).  ``backend`` filters the baselines
    compared (``"cpu"``/``"gpu"``): without it a CPU run diffed against
    a results dir that also holds card records would read ~10x "slower"
    and trip the regression exit code spuriously — pass the backend the
    run actually used (records with no ``backend`` field are always
    compared).
    """
    if os.path.isfile(baseline):
        paths = [baseline]
    else:
        paths = sorted(glob.glob(os.path.join(baseline, "*.json")))
    cur = report.get("step_time") or {}
    cur_ttfs = (report.get("time_to_first_step") or {}).get("s")
    cur_serve = (report.get("serve_latency") or {}).get("p99")
    cur_comms = report.get("comms") or {}
    cur_bytes = cur_comms.get("bytes_per_step")
    cur_ar = (cur_comms.get("allreduce_s") or {}).get("p50")
    cur_dt = report.get("device_time") or {}
    # per-step values when the capture knew its step count, else the
    # whole-window values (both sides of a diff commit the same shape)
    cur_exposed = (cur_dt.get("exposed_comms_per_step_s")
                   or cur_dt.get("exposed_comms_s"))
    cur_dstep = cur_dt.get("device_step_s")
    cur_st_block = report.get("serve_trace") or {}
    cur_qw = ((cur_st_block.get("hops") or {}).get("queue_wait")
              or {}).get("p99")
    cur_burn = (cur_st_block.get("slo") or {}).get("burn_rate")
    cur_mem = report.get("memory") or {}
    # live watermark when the backend reports device stats, else the
    # compiled peak (CPU: memory_analysis works, memory_stats doesn't) —
    # both sides of a diff commit the same shape
    cur_hbm = cur_mem.get("hbm_peak_mb") or cur_mem.get("peak_executable_mb")
    out: dict = {"threshold": threshold, "backend": backend,
                 "baselines": [], "regressions": []}
    for p in paths:
        try:
            with open(p) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(rec, dict):
            continue
        st = rec.get("step_time")
        st = st if isinstance(st, dict) and st.get("p50") else None
        tt = rec.get("time_to_first_step")
        tt = tt if isinstance(tt, dict) and tt.get("s") else None
        sv = rec.get("serve_latency")
        sv = sv if isinstance(sv, dict) and sv.get("p99") else None
        cm = rec.get("comms")
        cm = cm if isinstance(cm, dict) and (
            cm.get("bytes_per_step") or (cm.get("allreduce_s") or {}).get("p50")
        ) else None
        dt = rec.get("device_time")
        dt = dt if isinstance(dt, dict) and (
            dt.get("exposed_comms_per_step_s") or dt.get("exposed_comms_s")
            or dt.get("device_step_s")
        ) else None
        tr = rec.get("serve_trace")
        tr = tr if isinstance(tr, dict) and (
            ((tr.get("hops") or {}).get("queue_wait") or {}).get("p99")
            or (tr.get("slo") or {}).get("burn_rate")
        ) else None
        mm = rec.get("memory")
        mm = mm if isinstance(mm, dict) and (
            mm.get("hbm_peak_mb") or mm.get("peak_executable_mb")
        ) else None
        if st is None and tt is None and sv is None and cm is None \
                and dt is None and tr is None and mm is None:
            continue
        if backend and rec.get("backend") and rec["backend"] != backend:
            continue
        entry: dict = {"file": os.path.basename(p),
                       "backend": rec.get("backend")}
        if st is not None:
            entry["baseline_p50_s"] = st["p50"]
            entry["current_p50_s"] = cur.get("p50")
            for q in ("p50", "p95"):
                if cur.get(q) and st.get(q):
                    entry[f"ratio_{q}"] = round(cur[q] / st[q], 4)
        if tt is not None and cur_ttfs:
            entry["baseline_ttfs_s"] = tt["s"]
            entry["current_ttfs_s"] = cur_ttfs
            entry["ratio_ttfs"] = round(cur_ttfs / tt["s"], 4)
        if sv is not None and cur_serve:
            entry["baseline_serve_p99_s"] = sv["p99"]
            entry["current_serve_p99_s"] = cur_serve
            entry["ratio_serve_p99"] = round(cur_serve / sv["p99"], 4)
        if cm is not None:
            # wire regressions gate like step-time ones: a compressed
            # run that puts more bytes on the wire than its baseline
            # (bucket layout ballooned, mode downgraded) or whose
            # standalone collective wall grew past threshold exits 3.
            # A run with NO comms block is incomparable, not a
            # regression — every f32 run diffs against a results dir
            # that also holds the comms record, and flagging those
            # would make the gate useless; compression-off shows as
            # the comms line missing from --report instead
            base_bytes = cm.get("bytes_per_step")
            if base_bytes and cur_bytes:
                entry["baseline_bytes_per_step"] = base_bytes
                entry["current_bytes_per_step"] = cur_bytes
                entry["ratio_bytes_on_wire"] = round(cur_bytes / base_bytes, 4)
            base_ar = (cm.get("allreduce_s") or {}).get("p50")
            if base_ar and cur_ar:
                entry["baseline_allreduce_p50_s"] = base_ar
                entry["current_allreduce_p50_s"] = cur_ar
                entry["ratio_allreduce_p50"] = round(cur_ar / base_ar, 4)
        if dt is not None:
            # device-time regressions gate like step-time ones: comms
            # time that STOPPED hiding behind compute (exposed grew past
            # threshold at flat bytes-on-wire) or a slower device step.
            # A run with NO device_time block — capture off — is
            # incomparable, not a regression, same discipline as comms.
            base_exp = (dt.get("exposed_comms_per_step_s")
                        or dt.get("exposed_comms_s"))
            if base_exp and cur_exposed:
                entry["baseline_exposed_comms_s"] = base_exp
                entry["current_exposed_comms_s"] = cur_exposed
                entry["ratio_exposed_comms"] = round(
                    cur_exposed / base_exp, 4
                )
            base_dstep = dt.get("device_step_s")
            if base_dstep and cur_dstep:
                entry["baseline_device_step_s"] = base_dstep
                entry["current_device_step_s"] = cur_dstep
                entry["ratio_device_step"] = round(
                    cur_dstep / base_dstep, 4
                )
        if tr is not None:
            # request-path regressions gate like step-time ones: queue
            # wait growing past threshold at flat load (capacity eroded
            # — the autoscaler's signal regressed) or the SLO burn rate
            # growing past it (the fleet is spending budget faster than
            # its baseline).  A run with NO serve_trace block — tracing
            # off — is incomparable, not a regression, same discipline
            # as comms/device_time; a zero-burn baseline is likewise
            # incomparable (no budget was being spent to ratio against).
            base_qw = ((tr.get("hops") or {}).get("queue_wait")
                       or {}).get("p99")
            if base_qw and cur_qw:
                entry["baseline_queue_wait_p99_s"] = base_qw
                entry["current_queue_wait_p99_s"] = cur_qw
                entry["ratio_queue_wait_p99"] = round(cur_qw / base_qw, 4)
            base_burn = (tr.get("slo") or {}).get("burn_rate")
            if base_burn and cur_burn:
                entry["baseline_burn_rate"] = base_burn
                entry["current_burn_rate"] = cur_burn
                entry["ratio_burn_rate"] = round(cur_burn / base_burn, 4)
        if mm is not None:
            # memory regressions gate like step-time ones: the peak HBM
            # watermark (or, backends without device stats, the compiled
            # executable peak) growing past threshold means the plan's
            # footprint ballooned — the capacity headroom the estimator
            # promised eroded.  A run with NO memory block — plane off —
            # is incomparable, not a regression, same discipline as
            # comms/device_time.
            base_hbm = mm.get("hbm_peak_mb") or mm.get("peak_executable_mb")
            if base_hbm and cur_hbm:
                entry["baseline_peak_hbm_mb"] = base_hbm
                entry["current_peak_hbm_mb"] = cur_hbm
                entry["ratio_peak_hbm"] = round(cur_hbm / base_hbm, 4)
        out["baselines"].append(entry)
        if (entry.get("ratio_p50") and entry["ratio_p50"] > threshold) or (
            entry.get("ratio_ttfs") and entry["ratio_ttfs"] > threshold
        ) or (
            entry.get("ratio_serve_p99")
            and entry["ratio_serve_p99"] > threshold
        ) or (
            entry.get("ratio_bytes_on_wire")
            and entry["ratio_bytes_on_wire"] > threshold
        ) or (
            entry.get("ratio_allreduce_p50")
            and entry["ratio_allreduce_p50"] > threshold
        ) or (
            entry.get("ratio_exposed_comms")
            and entry["ratio_exposed_comms"] > threshold
        ) or (
            entry.get("ratio_device_step")
            and entry["ratio_device_step"] > threshold
        ) or (
            entry.get("ratio_queue_wait_p99")
            and entry["ratio_queue_wait_p99"] > threshold
        ) or (
            entry.get("ratio_burn_rate")
            and entry["ratio_burn_rate"] > threshold
        ) or (
            entry.get("ratio_peak_hbm")
            and entry["ratio_peak_hbm"] > threshold
        ):
            out["regressions"].append(entry)
    return out


# -- human-readable report ----------------------------------------------------


def format_report(report: dict, diff: dict | None = None, *,
                  max_rows: int = 20) -> str:
    """The ``--report`` text: fleet summary, the worst skew rows, per-rank
    attribution, optional baseline verdicts (runbook: OBSERVABILITY.md
    "Reading a skew report")."""
    lines = []
    hosts = f" on {len(report['hosts'])} host(s)" if report.get("hosts") else ""
    warm = report.get("warmup_steps_skipped", 0)
    comp = report.get("compile") or {}
    warm_note = ""
    if warm:
        warm_note = f" ({warm} warmup/compile step(s) skipped"
        if comp.get("records"):
            # the skipped first step's cost, measured, not dropped
            warm_note += (
                f"; measured compile wall {comp['wall_s']:.3f}s "
                f"across {comp['records']} compile record(s)"
            )
        warm_note += ")"
    lines.append(
        f"fleet skew report: {report['ranks']} rank(s){hosts}, "
        f"{report['steps']} step(s)" + warm_note
    )
    ttfs = report.get("time_to_first_step") or {}
    if ttfs.get("s") is not None:
        # compile wall is summed fleet-wide (ranks compile in parallel),
        # so label it that way — printing 8s of compile inside a 3s
        # startup would read as inconsistent otherwise
        lines.append(
            f"  time to first step: {ttfs['s']:.3f}s (slowest rank; "
            f"fleet compile wall {comp.get('wall_s', 0.0):.3f}s)"
        )
    st = report.get("step_time") or {}
    if st:
        lines.append(
            f"  step time (dispatch): p50={st['p50'] * 1e3:.1f}ms "
            f"p95={st['p95'] * 1e3:.1f}ms mean={st['mean'] * 1e3:.1f}ms "
            f"over {st['count']} rank-steps"
        )
    sv = report.get("serve_latency") or {}
    if sv:
        lines.append(
            f"  serve latency: p50={sv['p50'] * 1e3:.1f}ms "
            f"p95={sv['p95'] * 1e3:.1f}ms p99={sv['p99'] * 1e3:.1f}ms "
            f"over {sv['count']} served request(s)"
        )
    tr = report.get("serve_trace") or {}
    if tr:
        hops = tr.get("hops") or {}
        hop_parts = [
            f"{h}={hops[h]['p99'] * 1e3:.1f}ms"
            for h in _TRACE_HOP_ORDER if h in hops
        ]
        lines.append(
            f"  request path ({tr['traces']} traced request(s)), "
            "p99 by hop: " + " ".join(hop_parts)
        )
        extras = []
        if tr.get("queue_wait_share") is not None:
            extras.append(f"queue-wait share {tr['queue_wait_share']:.0%}")
        if tr.get("retry_amplification") is not None:
            extras.append(
                f"retry amplification x{tr['retry_amplification']:.2f}"
            )
        if extras:
            lines.append("    " + ", ".join(extras))
        slo = tr.get("slo") or {}
        if slo:
            lines.append(
                f"  slo: p99 objective {slo['p99_ms']:.0f}ms, "
                f"availability {slo['availability']}, "
                f"{slo['violations']}/{slo['requests']} violation(s), "
                f"burn rate {slo['burn_rate']:.2f} "
                f"(budget remaining {slo['error_budget_remaining']:.0%})"
            )
    cm = report.get("comms") or {}
    if cm:
        red = (
            f" ({cm['reduction_x']}x under f32)"
            if cm.get("reduction_x") else ""
        )
        og = cm.get("overlap_groups")
        grp = (
            f", {og} bucket group(s) (reverse-backward fire order)"
            if og and og > 1 else ""
        )
        lines.append(
            f"  comms: {cm.get('mode')} wire, "
            f"{(cm.get('bytes_per_step') or 0) / 1e6:.3f} MB/step{red}, "
            f"{(cm.get('bytes_on_wire') or 0) / 1e6:.1f} MB over "
            f"{cm.get('steps', 0)} rank-step(s)"
            + grp
            + (
                f", allreduce p50="
                f"{cm['allreduce_s']['p50'] * 1e3:.2f}ms"
                if cm.get("allreduce_s") else ""
            )
        )
    dt = report.get("device_time") or {}
    if dt:
        cls = dt.get("classes") or {}

        def _ms(c):
            return ((cls.get(c) or {}).get("wall_s") or 0.0) * 1e3

        part = "" if not dt.get("partial") else ", partial"
        lines.append(
            f"  device time (rank {dt.get('rank')}, "
            f"{dt.get('steps') or '?'} step(s), "
            f"{dt.get('device_tracks')} track(s){part}): "
            f"window={dt['window_s'] * 1e3:.1f}ms "
            f"compute={_ms('compute'):.1f}ms "
            f"collective={_ms('collective'):.1f}ms "
            f"transfer={_ms('transfer'):.1f}ms "
            f"idle={dt['idle_s'] * 1e3:.1f}ms"
        )
        oe = dt.get("overlap_efficiency")
        exposed = (
            f"  exposed comms: {dt['exposed_comms_s'] * 1e3:.2f}ms"
        )
        if dt.get("exposed_comms_per_step_s") is not None:
            exposed += (
                f" ({dt['exposed_comms_per_step_s'] * 1e3:.2f}ms/step)"
            )
        if oe is not None:
            exposed += f", overlap efficiency {oe:.0%}"
        lines.append(exposed)
        if dt.get("top_ops"):
            lines.append(
                "  top device ops (the fused-kernel target list):"
            )
            lines.append("      pct   total_ms  count  op")
            for op in dt["top_ops"]:
                lines.append(
                    f"    {op['pct']:>5.1f} {op['total_s'] * 1e3:>10.2f} "
                    f"{op['count']:>6}  {op['name']} [{op['class']}]"
                )
    mem = report.get("memory") or {}
    if mem:
        parts = []
        if mem.get("hbm_peak_mb"):
            util = (
                f" ({mem['hbm_peak_util']:.0%} of "
                f"{mem['hbm_limit_mb']:.0f}MB)"
                if mem.get("hbm_peak_util") else ""
            )
            parts.append(f"hbm peak {mem['hbm_peak_mb']:.1f}MB{util}")
        if mem.get("host_peak_mb"):
            parts.append(f"host peak {mem['host_peak_mb']:.1f}MB")
        if mem.get("peak_executable_mb"):
            parts.append(
                f"compiled peak {mem['peak_executable_mb']:.1f}MB over "
                f"{len(mem.get('executables') or {})} executable(s)"
            )
        lines.append("  memory: " + ", ".join(parts or ["(no samples)"]))
        if mem.get("ooms"):
            oom = mem.get("last_oom") or {}
            sug = oom.get("suggestion") or {}
            sug_txt = ""
            if sug:
                knobs = ", ".join(
                    f"{k}={v}" for k, v in sug.items()
                    if k in ("zero_stage", "microbatches", "offload_optimizer")
                )
                sug_txt = (
                    f"; nearest fitting plan: {knobs} "
                    f"(est {sug.get('total_mb', 0):.1f}MB)"
                )
            lines.append(
                f"  OOM: {mem['ooms']} event(s), last at "
                f"{oom.get('where')} step {oom.get('step')}" + sug_txt
            )
    lines.append(
        f"  time lost to stragglers: {report['straggler_lost_s']:.3f}s "
        f"across {report['straggling_steps']} straggling step(s) "
        f"(factor > {report['straggler_factor']}); total cross-rank skew "
        f"incl. jitter: {report['total_lost_s']:.3f}s"
    )
    lb = report["lost_by_bound"]
    lines.append(
        "  straggler time by cause: "
        + "  ".join(f"{k}={v:.3f}s" for k, v in lb.items())
    )
    if report.get("slowest"):
        s = report["slowest"]
        lines.append(
            f"  slowest rank: {s['rank']} (excess {s['excess_s']:.3f}s, "
            f"slowest on {s['times_slowest']} straggling step(s))"
        )
    rows = report["per_step"]
    shown = sorted(rows, key=lambda r: r["lost_s"], reverse=True)[:max_rows]
    shown.sort(key=lambda r: r["batch"])
    if len(rows) > len(shown):
        lines.append(f"  -- worst {len(shown)} of {len(rows)} steps by lost_s --")
    lines.append(
        "  batch   min_s   med_s   max_s  slowest  lost_s  bound"
    )
    for r in shown:
        flag = " *" if r["straggling"] else ""
        lines.append(
            f"  {r['batch']:>5} {r['min_s']:>7.3f} {r['median_s']:>7.3f} "
            f"{r['max_s']:>7.3f}  rank {r['slowest_rank']:<3} "
            f"{r['lost_s']:>6.3f}  {r['bound']}{flag}"
        )
    lines.append("  per-rank:")
    for pr in report["per_rank"]:
        host = f" @ {pr['host']}" if pr["host"] else ""
        lines.append(
            f"    rank {pr['rank']}{host}: {pr['steps']} steps, "
            f"excess {pr['excess_s']:.3f}s, straggling "
            f"{pr['straggling_steps']}, data_wait {pr['data_wait_total_s']:.3f}s"
        )
    if diff is not None:
        lines.append(
            f"  baseline diff (regression = ratio_p50 > {diff['threshold']}):"
        )
        if not diff["baselines"]:
            lines.append("    no comparable step_time baselines found")
        for b in diff["baselines"]:
            verdict = (
                "REGRESSION" if b in diff["regressions"] else "ok"
            )
            parts = []
            if b.get("ratio_p50") is not None:
                parts.append(
                    f"p50 {b['baseline_p50_s'] * 1e3:.1f}ms -> "
                    f"{(b.get('current_p50_s') or 0) * 1e3:.1f}ms "
                    f"(x{b['ratio_p50']:.2f})"
                )
            if b.get("ratio_ttfs") is not None:
                parts.append(
                    f"ttfs {b['baseline_ttfs_s']:.3f}s -> "
                    f"{b['current_ttfs_s']:.3f}s (x{b['ratio_ttfs']:.2f})"
                )
            if b.get("ratio_bytes_on_wire") is not None:
                parts.append(
                    f"bytes/step {b['baseline_bytes_per_step'] / 1e6:.3f}MB -> "
                    f"{b['current_bytes_per_step'] / 1e6:.3f}MB "
                    f"(x{b['ratio_bytes_on_wire']:.2f})"
                )
            if b.get("ratio_allreduce_p50") is not None:
                parts.append(
                    f"allreduce_p50 {b['baseline_allreduce_p50_s'] * 1e3:.2f}ms -> "
                    f"{b['current_allreduce_p50_s'] * 1e3:.2f}ms "
                    f"(x{b['ratio_allreduce_p50']:.2f})"
                )
            if b.get("ratio_serve_p99") is not None:
                parts.append(
                    f"serve_p99 {b['baseline_serve_p99_s'] * 1e3:.1f}ms -> "
                    f"{b['current_serve_p99_s'] * 1e3:.1f}ms "
                    f"(x{b['ratio_serve_p99']:.2f})"
                )
            if b.get("ratio_exposed_comms") is not None:
                parts.append(
                    f"exposed_comms "
                    f"{b['baseline_exposed_comms_s'] * 1e3:.2f}ms -> "
                    f"{b['current_exposed_comms_s'] * 1e3:.2f}ms "
                    f"(x{b['ratio_exposed_comms']:.2f})"
                )
            if b.get("ratio_device_step") is not None:
                parts.append(
                    f"device_step {b['baseline_device_step_s'] * 1e3:.2f}ms"
                    f" -> {b['current_device_step_s'] * 1e3:.2f}ms "
                    f"(x{b['ratio_device_step']:.2f})"
                )
            if b.get("ratio_queue_wait_p99") is not None:
                parts.append(
                    f"queue_wait_p99 "
                    f"{b['baseline_queue_wait_p99_s'] * 1e3:.2f}ms -> "
                    f"{b['current_queue_wait_p99_s'] * 1e3:.2f}ms "
                    f"(x{b['ratio_queue_wait_p99']:.2f})"
                )
            if b.get("ratio_burn_rate") is not None:
                parts.append(
                    f"burn_rate {b['baseline_burn_rate']:.2f} -> "
                    f"{b['current_burn_rate']:.2f} "
                    f"(x{b['ratio_burn_rate']:.2f})"
                )
            lines.append(
                f"    vs {b['file']} [{b.get('backend')}]: "
                + " ".join(parts) + f" {verdict}" if parts else
                f"    vs {b['file']}: incomparable"
            )
    return "\n".join(lines)


# -- live straggler detection -------------------------------------------------


#: Wall bound (seconds) on the fleet gather when a peer is dead — a lost
#: rank must degrade the ladder, not hang every healthy survivor at the
#: step boundary forever.  ``TPUFRAME_FLEET_TIMEOUT_S``; 0 disables.
FLEET_TIMEOUT_ENV = "TPUFRAME_FLEET_TIMEOUT_S"
_FLEET_TIMEOUT_DEFAULT_S = 60.0

#: Sticky local-only mode after a gather timed out: the wedged collective
#: left a dangling thread inside the runtime, and re-entering it every
#: boundary would leak one thread per step while the fleet is broken.
_FLEET_DEGRADED = False


def fleet_degraded() -> bool:
    """True once a fleet gather timed out on a lost peer (local-only mode
    until :func:`reset_fleet_degraded` — typically the supervised restart
    into a rebuilt world)."""
    return _FLEET_DEGRADED


def reset_fleet_degraded() -> None:
    """Re-arm fleet gathers (a restart into a rebuilt/shrunken world has
    a live fleet again; tests)."""
    global _FLEET_DEGRADED
    _FLEET_DEGRADED = False


def _gather_device():
    """Where the gather's tensors live: this thread's card under NCCL, the
    host under gloo.  Read on the caller's thread: CUDA's current device
    is a thread's own, and the bounded gather's worker starts on card 0."""
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_values(value: float, device=None) -> list[float]:
    """The real cross-process gather (factored for bounding + tests): one
    float64 a rank through ``all_gather_into_tensor`` on the default
    group, on ``device`` (default :func:`_gather_device`)."""
    import torch
    import torch.distributed as dist

    device = _gather_device() if device is None else device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mine = torch.tensor([value], dtype=torch.float64, device=device)
    out = torch.empty(dist.get_world_size(), dtype=torch.float64, device=device)
    dist.all_gather_into_tensor(out, mine)
    return [float(v) for v in out.cpu().tolist()]


def _fleet_timeout_s() -> float:
    raw = os.environ.get(FLEET_TIMEOUT_ENV, "").strip()
    if not raw:
        return _FLEET_TIMEOUT_DEFAULT_S
    try:
        return float(raw)
    except ValueError:
        return _FLEET_TIMEOUT_DEFAULT_S


def _bounded_gather(value: float, timeout_s: float | None = None) -> list[float]:
    """Run the gather with a wall bound: on timeout (or a transport
    error — a dead peer surfaces as either), emit ONE ``fault/peer_lost``
    event, flip the ladder to sticky local-only, and return the local
    value so the step boundary completes instead of hanging.  The
    timed-out gather thread is a daemon parked inside the runtime; it
    dies with the process (which the supervisor is about to restart
    anyway — a hung collective means the fleet is already broken)."""
    global _FLEET_DEGRADED
    timeout_s = _fleet_timeout_s() if timeout_s is None else float(timeout_s)
    if timeout_s <= 0:
        return _gather_values(value)
    import threading

    box: dict[str, Any] = {}
    device = _gather_device()

    def work() -> None:
        try:
            box["result"] = _gather_values(value, device)
        except BaseException as e:  # noqa: BLE001 - reported, not swallowed
            box["error"] = e

    t = threading.Thread(target=work, name="tpuframe-fleet-gather", daemon=True)
    t.start()
    t.join(timeout_s)
    if "result" in box:
        return box["result"]
    _FLEET_DEGRADED = True
    tele = get_telemetry()
    tele.registry.counter("fault/peer_losses").inc()
    tele.event(
        "fault/peer_lost",
        timeout_s=timeout_s,
        error=(repr(box["error"])[:300] if "error" in box
               else f"gather exceeded {timeout_s}s wall bound"),
        degraded_to="local",
    )
    return [float(value)]


def fleet_allgather(value: float) -> list[float]:
    """All ranks' values, rank-ordered: THE tiny fleet collective, with
    JAX's degradation ladder.  A process that never imported
    ``torch.distributed``, or has no initialized default group, or a
    group of one, is local-only (the self-baseline); past a timed-out
    gather the sticky degraded flag keeps every later call local (an
    abandoned NCCL collective cannot be cancelled); otherwise the gather
    is wall-bounded (``TPUFRAME_FLEET_TIMEOUT_S``, default 60 s): a dead
    peer degrades the ladder to local with one ``fault/peer_lost`` event
    instead of stalling every healthy survivor's step boundary."""
    if _FLEET_DEGRADED:
        return [float(value)]
    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return [float(value)]
    if dist.get_world_size() == 1:
        return [float(value)]
    return _bounded_gather(float(value))


class StragglerMonitor:
    """Rolling step-time EWMA + periodic fleet comparison.

    Call :meth:`mark` at a loop boundary (epoch start) and
    :meth:`observe` after every step: with no explicit duration it
    measures boundary-to-boundary wall time, which charges the straggler
    whatever actually slowed it — input wait, dispatch, a checkpoint, a
    GC pause, a chaos stall.

    Every ``sync_steps`` observed steps (after ``min_steps`` warmup) the
    fleet's EWMAs cross ranks through ``gather``:

    - **fleet mode** (>1 rank): ``skew_ratio = max(ewma) / median(ewma)``;
      when the worst rank exceeds ``factor``x the median, rank 0 emits
      one ``train/straggler`` event naming it (rank-0 discipline — one
      event per fleet verdict, in rank 0's log).
    - **self mode** (gather degraded to this rank alone):
      ``skew_ratio = ewma / median(own recent step times)`` — detects a
      rank *becoming* slow against its own history; the event is emitted
      locally.

    Knobs default from the env so launch propagation is free:
    ``TPUFRAME_STRAGGLER_STEPS`` (cadence, 0 disables, default 32) and
    ``TPUFRAME_STRAGGLER_FACTOR`` (default 2.0).  The first observed
    interval after construction is discarded (``skip_first``): under
    precompile or a cold cache it carries the compile, and an 800x compile outlier would poison the
    EWMA for the whole warmup window.
    """

    def __init__(
        self,
        *,
        factor: float | None = None,
        sync_steps: int | None = None,
        alpha: float = 0.25,
        min_steps: int = 8,
        skip_first: int = 1,
        baseline_window: int = 512,
        gather: Callable[[float], Iterable[float]] | None = None,
        rank: int | None = None,
        telemetry: Any = None,
    ):
        if factor is None:
            try:
                factor = float(os.environ.get("TPUFRAME_STRAGGLER_FACTOR", 2.0))
            except ValueError:
                factor = 2.0
        if sync_steps is None:
            try:
                sync_steps = int(os.environ.get("TPUFRAME_STRAGGLER_STEPS", 32))
            except ValueError:
                sync_steps = 32
        self.factor = float(factor)
        self.sync_steps = int(sync_steps)
        self.alpha = float(alpha)
        self.min_steps = int(min_steps)
        self.skip_first = int(skip_first)
        self._gather = gather or fleet_allgather
        self._telemetry = telemetry
        self._rank = rank
        self._times: deque[float] = deque(maxlen=baseline_window)
        self._t_last: float | None = None
        self._skipped = 0
        self.ewma: float | None = None
        self.steps = 0
        self.last: dict | None = None  # most recent detection

    @property
    def enabled(self) -> bool:
        return self.sync_steps > 0 and self.factor > 0

    def _tele(self):
        return self._telemetry if self._telemetry is not None else get_telemetry()

    @property
    def rank(self) -> int:
        return self._tele().rank if self._rank is None else self._rank

    def mark(self) -> None:
        """Reset the interval boundary (epoch start: the gap spanning
        eval/checkpoint/epoch turnover must not read as a slow step)."""
        self._t_last = time.monotonic()

    def observe(self, step_s: float | None = None) -> dict | None:
        """Record one step; returns the detection dict when this call's
        fleet check fired, else None."""
        now = time.monotonic()
        if step_s is None:
            if self._t_last is None:
                self._t_last = now
                return None
            step_s = now - self._t_last
        self._t_last = now
        if self._skipped < self.skip_first:
            self._skipped += 1
            return None
        self.steps += 1
        self._times.append(float(step_s))
        self.ewma = (
            float(step_s) if self.ewma is None
            else self.alpha * float(step_s) + (1 - self.alpha) * self.ewma
        )
        tele = self._tele()
        tele.registry.gauge("train/step_ewma_s").set(self.ewma)
        if (
            not self.enabled
            or self.steps < self.min_steps
            or self.steps % self.sync_steps
        ):
            return None
        return self._check(tele)

    def _check(self, tele) -> dict | None:
        fleet = [float(v) for v in self._gather(self.ewma)]
        if len(fleet) > 1:
            med = statistics.median(fleet)
            worst = max(range(len(fleet)), key=fleet.__getitem__)
            worst_ewma = fleet[worst]
            mode = "fleet"
        else:
            med = statistics.median(self._times)
            worst = self.rank
            worst_ewma = self.ewma
            mode = "self"
        ratio = worst_ewma / max(med, 1e-12)
        tele.registry.gauge("train/skew_ratio").set(ratio)
        if ratio <= self.factor:
            self.last = None
            return None
        det = {
            "rank": worst,
            "ewma_s": round(worst_ewma, 6),
            "median_s": round(med, 6),
            "ratio": round(ratio, 4),
            "mode": mode,
            "step": self.steps,
            "factor": self.factor,
        }
        self.last = det
        # one event per fleet verdict: rank 0 speaks for the fleet; in
        # self mode the verdict only exists on this rank, so it speaks
        if mode == "self" or self.rank == 0:
            tele.registry.counter("train/stragglers").inc()
            tele.event("train/straggler", **det)
        return det


# -- CLI ----------------------------------------------------------------------


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpuframe_torch.track analyze",
        description=(
            "Fleet-level telemetry analysis: merge a dir of per-rank "
            "events-rank*.jsonl logs into a Perfetto timeline and a "
            "cross-rank skew report."
        ),
    )
    ap.add_argument("dir", nargs="+",
                    help="TPUFRAME_TELEMETRY_DIR of a finished run; give "
                         "several (router + replicas of a multi-process "
                         "serve fleet) to stitch them onto one timeline "
                         "keyed by trace id")
    ap.add_argument("--trace", metavar="OUT.json",
                    help="write a Chrome/Perfetto trace.json here")
    ap.add_argument("--report", action="store_true",
                    help="print the human-readable skew report")
    ap.add_argument("--baseline", metavar="DIR_OR_FILE",
                    help="diff step times vs the JSON bench records in "
                         "this dir (or one such file)")
    ap.add_argument("--baseline-backend", metavar="BACKEND",
                    help="only diff against baselines recorded on this "
                         "backend (cpu/gpu) — a CPU run vs a card record "
                         "is not a regression")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report (+diff) as JSON instead")
    ap.add_argument("--straggler-factor", type=float, default=1.5,
                    help="a step straggles when max > FACTOR * median "
                         "(default 1.5)")
    ap.add_argument("--warmup-steps", type=int, default=1,
                    help="drop the first N batch indices (compile; "
                         "default 1)")
    ap.add_argument("--regression-threshold", type=float, default=1.25,
                    help="baseline diff flags ratio_p50 above this "
                         "(default 1.25)")
    args = ap.parse_args(argv)

    try:
        ranks = load_dirs(args.dir)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    report = skew_report(ranks, straggler_factor=args.straggler_factor,
                         warmup_steps=args.warmup_steps)
    diff = None
    if args.baseline:
        diff = baseline_diff(report, args.baseline,
                             threshold=args.regression_threshold,
                             backend=args.baseline_backend)
    # regressions are an actionable exit code for CI rungs — decided
    # BEFORE printing, so `... | head` closing the pipe mid-report
    # cannot swallow the verdict
    rc = 3 if diff and diff["regressions"] else 0
    try:
        if args.trace:
            trace = build_trace(ranks)
            with open(args.trace, "w") as f:
                json.dump(trace, f)
            print(
                f"wrote {args.trace}: {len(trace['traceEvents'])} events, "
                f"{report['ranks']} rank track(s) — load in ui.perfetto.dev "
                "or chrome://tracing"
            )
        if args.json:
            print(json.dumps({"report": report, "diff": diff}, indent=2))
        elif args.report or not args.trace:
            print(format_report(report, diff))
    except BrokenPipeError:
        # normal CLI usage, not an error; silence the interpreter's
        # close-time complaint about the dead stdout
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return rc


if __name__ == "__main__":  # pragma: no cover - exercised via track.__main__
    raise SystemExit(main())
