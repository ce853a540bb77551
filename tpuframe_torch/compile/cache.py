"""Persistent compile cache: the warm-start half of the compile spine.

Port of ``tpuframe/compile/cache.py``.  The JAX package points XLA's
persistent compilation cache at a directory; the port points Inductor's
on-disk caches there: the FX-graph cache (one compiled graph per key),
the AOTAutograd cache (a forward and backward pair per key) and Triton's
kernel cache.  A supervised restart, or a new rank on the same host, then
reads a repeat compile from disk instead of generating code again.

- :func:`enable` sets ``TORCHINDUCTOR_CACHE_DIR`` and ``TRITON_CACHE_DIR``
  (Inductor reads them at every lookup, so a call after ``import torch``
  takes effect) and turns both caches on, installs the listeners and runs
  a :func:`trim` pass.
- :func:`trim` is the size-capped keep-K eviction of the JAX package.  An
  entry is a flat ``<key>-cache`` file with its ``<key>-atime`` sidecar
  (JAX's layout, trimmed exactly as JAX trims it), a key directory of
  Inductor's (``fxgraph/<xx>/<key>/``, ``aotautograd/<key>/``,
  ``triton/<device>/<key>/``: any directory two levels down or deeper with
  no directory in it), evicted whole by one rename before its removal, or
  the files of one key stem in a bucket of generated code
  (``<xx>/<key>.cpp``, ``<key>.so``, ...).  ``locks/`` is never touched.
- The **listeners** hang on TorchDynamo's compile callbacks
  (``torch._dynamo.callback``) and read the deltas of Inductor's and
  AOTAutograd's cache counters across each compile: ``compile/cache_hits``,
  ``compile/cache_misses`` and ``compile/backend_compiles`` counters,
  ``compile/backend_compile_s`` and ``compile/lower_s`` histograms, and one
  ``compile/backend_compile`` JSONL event per real compile (an FX-graph
  cache miss or bypass, or a compile that consulted no cache), none inside
  an explicit compile span.  A cache hit is a retrieval: counted, not
  shouted.

Env knobs (:data:`COMPILE_ENV_VARS`, shipped to every remote worker by
``launch.remote``), JAX's list::

    TPUFRAME_COMPILE_CACHE         cache dir; 0/off/false disables; unset
                                   = <local scratch>/compile_cache
    TPUFRAME_COMPILE_CACHE_MAX_MB  trim() size cap (default 1024; junk =
                                   unbounded)
    TPUFRAME_COMPILE_CACHE_KEEP    newest entries never evicted (default 16)
    TPUFRAME_COMPILE_MIN_COMPILE_S accepted and ignored: Inductor caches
                                   every compile (ROADMAP Queue 3)
    TPUFRAME_PRECOMPILE            1 turns the Trainer's and the serve
                                   engine's precompile on (the port's
                                   default is off, ROADMAP Queue 3)

The module imports no torch at import time: the launcher reads
:data:`COMPILE_ENV_VARS` and :func:`cache_info` works without a backend.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Iterator

logger = logging.getLogger(__name__)

__all__ = [
    "COMPILE_ENV_VARS",
    "cache_dir_from_env",
    "cache_info",
    "compile_label",
    "disable",
    "enable",
    "enable_from_env",
    "enabled_dir",
    "install_listeners",
    "trim",
]

#: every env knob the compile spine reads (JAX's list)
COMPILE_ENV_VARS = (
    "TPUFRAME_COMPILE_CACHE",
    "TPUFRAME_COMPILE_CACHE_MAX_MB",
    "TPUFRAME_COMPILE_CACHE_KEEP",
    "TPUFRAME_COMPILE_MIN_COMPILE_S",
    "TPUFRAME_PRECOMPILE",
)

#: value domains for the knobs above (JAX's table)
COMPILE_ENV_DOMAINS = {
    "TPUFRAME_COMPILE_CACHE": {"type": "path", "apply": "restart"},
    "TPUFRAME_COMPILE_CACHE_MAX_MB": {
        "type": "float", "range": (0, None), "apply": "live"},
    "TPUFRAME_COMPILE_CACHE_KEEP": {
        "type": "int", "range": (0, None), "apply": "live"},
    "TPUFRAME_COMPILE_MIN_COMPILE_S": {
        "type": "float", "range": (0, None), "apply": "restart"},
    "TPUFRAME_PRECOMPILE": {"type": "bool", "apply": "restart"},
}

_FALSY = ("0", "false", "no", "off", "disabled")

#: the Inductor and AOTAutograd counters a compile moves:
#: (group, name) -> "hit" or "miss"
_CACHE_COUNTERS = {
    ("inductor", "fxgraph_cache_hit"): "hit",
    ("aot_autograd", "autograd_cache_hit"): "hit",
    ("inductor", "fxgraph_cache_miss"): "miss",
    ("inductor", "fxgraph_cache_bypass"): "miss",
}

#: process-wide state: the enabled cache dir (None = not enabled here)
_STATE: dict[str, Any] = {"dir": None}

#: per-thread compile attribution (label, explicit span) and the open
#: compile's start (time, counters)
_TLS = threading.local()


def _tele():
    from tpuframe_torch.track.telemetry import get_telemetry

    return get_telemetry()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def cache_dir_from_env() -> str | None:
    """Resolve the cache directory from ``TPUFRAME_COMPILE_CACHE``: unset
    gives the host-shared default under the local scratch (no per-rank
    subdir: every rank on a host shares one cache), a falsy value
    disables it."""
    v = os.environ.get("TPUFRAME_COMPILE_CACHE", "").strip()
    if v and v.lower() in _FALSY:
        return None
    if v:
        return v
    base = os.environ.get("TPUFRAME_LOCAL_SCRATCH") or os.path.join(
        tempfile.gettempdir(), "tpuframe_scratch"
    )
    return os.path.join(base, "compile_cache")


def enabled_dir() -> str | None:
    """The cache dir this process enabled (None when disabled)."""
    return _STATE["dir"]


def _point_torch(cache_dir: str | None) -> None:
    """Inductor's and Triton's cache directories (env vars, read at every
    lookup) and the two caches' switches, on at ``cache_dir`` or off
    (None).  The switches are set on the config modules once torch is
    loaded (their env vars would pin them for the process); before that
    they keep their defaults, which are on."""
    on = cache_dir is not None
    if on:
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.abspath(cache_dir)
        os.environ["TRITON_CACHE_DIR"] = os.path.join(os.path.abspath(cache_dir), "triton")
    if "torch" in sys.modules:
        import torch._functorch.config as functorch
        import torch._inductor.config as inductor

        inductor.fx_graph_cache = on
        functorch.enable_autograd_cache = on


def enable(cache_dir: str | None = None, *,
           min_compile_s: float | None = None) -> str | None:
    """Point Inductor's FX-graph and AOTAutograd caches and Triton's cache
    at ``cache_dir`` (default :func:`cache_dir_from_env`) and turn them on.

    Idempotent; returns the enabled directory, or None when the env
    disables it or the directory cannot be made (a broken cache degrades
    to cold compiles, never takes training down).  ``min_compile_s`` is
    accepted for the JAX signature and ignored: Inductor has no floor of
    compile time.  Installs the listeners once torch's compiler is loaded
    (``precompile`` installs them before it compiles) and runs a
    :func:`trim` pass."""
    del min_compile_s  # no Inductor counterpart (ROADMAP Queue 3)
    cache_dir = cache_dir or cache_dir_from_env()
    if cache_dir is None:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        _point_torch(cache_dir)
    except OSError as e:  # readonly or uncreatable dir
        logger.warning("compile cache disabled: %s", e)
        return None
    _STATE["dir"] = cache_dir
    if "torch._dynamo" in sys.modules:
        install_listeners()
    try:
        trim(cache_dir)
    except OSError:
        pass  # a concurrent trimmer or a vanishing entry is not an error
    return cache_dir


def enable_from_env() -> str | None:
    """Enable unless the env disables it: the hook ``core.runtime.
    initialize`` and the fault supervisor call."""
    return enable()


def disable() -> None:
    """Turn the persistent caches off again (tests, cold windows).  The
    listeners stay installed; they are harmless without a cache."""
    _STATE["dir"] = None
    _point_torch(None)


# -- telemetry listeners ------------------------------------------------------


@contextlib.contextmanager
def compile_label(label: str, *, span: bool = False) -> Iterator[None]:
    """Attribute any compile on this thread to ``label`` (what shows on the
    ``compile/backend_compile`` event).  ``span=True`` marks that an
    explicit compile span records the region, so the listener emits no
    duplicate JSONL event."""
    prev_label = getattr(_TLS, "label", None)
    prev_span = getattr(_TLS, "in_span", False)
    _TLS.label = label
    _TLS.in_span = bool(span) or prev_span
    try:
        yield
    finally:
        _TLS.label = prev_label
        _TLS.in_span = prev_span


def _counts() -> dict:
    """The cache counters' current values, by (group, name)."""
    from torch._dynamo.utils import counters

    return {key: counters[key[0]][key[1]] for key in _CACHE_COUNTERS}


def _user_compiler_s() -> float:
    """Seconds spent in the backend so far (Dynamo's timing of
    ``OutputGraph.call_user_compiler``); 0 where this torch keeps none."""
    try:
        from torch._dynamo.utils import compilation_time_metrics

        return float(sum(compilation_time_metrics.get("OutputGraph.call_user_compiler", ())))
    except Exception:
        return 0.0


def _on_start(args: Any = None) -> None:
    try:
        _TLS.open = (time.perf_counter(), _counts(), _user_compiler_s())
    except Exception:  # a metrics hiccup must never break a compile
        _TLS.open = None


def _on_end(args: Any = None) -> None:
    opened = getattr(_TLS, "open", None)
    _TLS.open = None
    if opened is None:
        return
    try:
        t0, before, backend0 = opened
        dur = time.perf_counter() - t0
        after = _counts()
        hits = sum(after[k] - before[k] for k, v in _CACHE_COUNTERS.items() if v == "hit")
        misses = sum(after[k] - before[k] for k, v in _CACHE_COUNTERS.items() if v == "miss")
        tele = _tele()
        reg = tele.registry
        reg.histogram("compile/backend_compile_s").observe(dur)
        backend = _user_compiler_s() - backend0
        if backend > 0.0:
            reg.histogram("compile/lower_s").observe(max(dur - backend, 0.0))
        if hits:
            reg.counter("compile/cache_hits").inc(hits)
        if misses:
            reg.counter("compile/cache_misses").inc(misses)
        if misses or not hits:
            # the real thing: code generated (a miss, a bypass, or a
            # compile that consulted no cache), counted per graph
            reg.counter("compile/backend_compiles").inc(max(misses, 1))
            if not getattr(_TLS, "in_span", False):
                tele.event(
                    "compile/backend_compile",
                    dur_s=round(dur, 6),
                    label=getattr(_TLS, "label", None),
                    persistent_cache=("miss" if misses else "hit" if hits else "disabled")
                    if _STATE["dir"] else "disabled",
                )
    except Exception:
        pass


def install_listeners() -> None:
    """Register the compile listeners on TorchDynamo's callbacks, once (twice
    would double every counter); again after ``torch._dynamo.reset()``,
    which clears them."""
    try:
        from torch._dynamo import callback

        handler = callback.callback_handler
        if _on_start in getattr(handler, "start_callbacks", ()):
            return
        callback.on_compile_start(_on_start)
        callback.on_compile_end(_on_end)
    except Exception as e:
        logger.debug("compile listeners unavailable: %s", e)


# -- keep-K / size-cap eviction ----------------------------------------------


def _stat(path: str):
    try:
        return os.stat(path)
    except OSError:
        return None  # concurrent eviction


def _key_dir(path: str) -> tuple[float, int] | None:
    """(recency, bytes) of a key directory, None where it holds a
    directory (then it is not a key), nothing (a bucket its keys left) or
    vanished."""
    recency, size = 0.0, 0
    try:
        names = os.listdir(path)
    except OSError:
        return None
    if not names:
        return None
    for name in names:
        sub = os.path.join(path, name)
        if os.path.isdir(sub):
            return None
        st = _stat(sub)
        if st is not None:
            recency = max(recency, st.st_mtime, st.st_atime)
            size += st.st_size
    return recency, size


def _walk(cache_dir: str, rel: str, depth: int, out: list) -> None:
    """Entries under ``cache_dir/rel`` (a directory ``depth`` levels down)."""
    here = os.path.join(cache_dir, rel) if rel else cache_dir
    try:
        names = sorted(os.listdir(here))
    except OSError:
        return
    stems: dict[str, list] = {}
    for name in names:
        path = os.path.join(here, name)
        if os.path.isdir(path):
            if depth == 0 and name == "locks":
                continue
            keyed = _key_dir(path) if depth >= 1 else None
            if keyed is not None:
                out.append(([path], keyed[0], keyed[1], True))
            else:
                _walk(cache_dir, os.path.join(rel, name) if rel else name, depth + 1, out)
            continue
        if name.endswith(".lock"):
            continue
        st = _stat(path)
        if st is None:
            continue
        if depth == 0:
            # JAX's flat layout: <key>-cache with its <key>-atime sidecar
            if name.endswith("-atime"):
                continue
            recency = st.st_mtime
            if name.endswith("-cache"):
                side = _stat(os.path.join(here, name[: -len("-cache")] + "-atime"))
                if side is not None:
                    recency = side.st_mtime
            out.append(([path], recency, st.st_size, False))
        else:
            group = stems.setdefault(name.split(".", 1)[0], [[], 0.0, 0])
            group[0].append(path)
            group[1] = max(group[1], st.st_mtime, st.st_atime)
            group[2] += st.st_size
    for paths, recency, size in stems.values():
        out.append((paths, recency, size, False))


def _entries(cache_dir: str) -> list[tuple[list[str], float, int, bool]]:
    """(paths, recency, bytes, is a key directory) per cache entry, newest
    first."""
    out: list = []
    _walk(cache_dir, "", 0, out)
    out.sort(key=lambda e: e[1], reverse=True)
    return out


def _evict(paths: list[str], is_dir: bool) -> bool:
    """Remove one entry; False where nothing of it could be removed (a
    foreign-owned entry in a shared dir keeps its bytes)."""
    if is_dir:
        # one rename first: a reader sees the whole key or none of it
        gone = f"{paths[0]}.evicting-{os.getpid()}-{threading.get_ident()}"
        try:
            os.rename(paths[0], gone)
        except FileNotFoundError:
            return True  # a concurrent trimmer won the race: it IS gone
        except OSError:
            return False
        shutil.rmtree(gone, ignore_errors=True)
        return True
    removed = False
    for i, path in enumerate(paths):
        try:
            os.remove(path)
            removed = True
        except FileNotFoundError:
            removed = removed or i == 0
        except OSError:
            if i == 0:
                return False
    if paths[0].endswith("-cache"):
        try:
            os.remove(paths[0][: -len("-cache")] + "-atime")
        except OSError:
            pass
    return removed


def trim(cache_dir: str | None = None, *, max_bytes: int | None = None,
         keep: int | None = None) -> list[str]:
    """Size-capped keep-K eviction: the newest ``keep`` entries always
    survive; beyond them, the oldest are evicted until the directory fits
    ``max_bytes``.  Evictions are counted (``compile/cache_evictions``),
    announced (``compile/cache_evict``) and returned (each entry's first
    path).  Junk in ``TPUFRAME_COMPILE_CACHE_MAX_MB`` reads as no cap."""
    cache_dir = cache_dir or _STATE["dir"] or cache_dir_from_env()
    if cache_dir is None or not os.path.isdir(cache_dir):
        return []
    if max_bytes is None:
        mb = _env_float("TPUFRAME_COMPILE_CACHE_MAX_MB", 1024.0)
        max_bytes = int(mb * 2**20) if 0 < mb < 2**40 else 0
    if keep is None:
        v = os.environ.get("TPUFRAME_COMPILE_CACHE_KEEP", "")
        keep = int(v) if v.isdigit() else 16
    if not max_bytes:
        return []
    entries = _entries(cache_dir)
    total = sum(e[2] for e in entries)
    evicted: list[str] = []
    # walk oldest-first past the protected keep-K prefix
    for paths, _, size, is_dir in reversed(entries[max(0, int(keep)):]):
        if total <= max_bytes:
            break
        if not _evict(paths, is_dir):
            continue
        total -= size
        evicted.append(paths[0])
    if evicted:
        tele = _tele()
        tele.registry.counter("compile/cache_evictions").inc(len(evicted))
        tele.event("compile/cache_evict", n=len(evicted), dir=cache_dir)
    return evicted


def cache_info(cache_dir: str | None = None) -> dict:
    """Where the cache is (or would be), its entries and size, and the
    knobs bounding it (JAX's keys).  Imports no torch."""
    cache_dir = cache_dir or _STATE["dir"] or cache_dir_from_env()
    info: dict[str, Any] = {
        "dir": cache_dir,
        "enabled_in_process": _STATE["dir"] is not None,
        "entries": 0,
        "total_mb": 0.0,
    }
    if cache_dir and os.path.isdir(cache_dir):
        entries = _entries(cache_dir)
        info["entries"] = len(entries)
        info["total_mb"] = round(sum(e[2] for e in entries) / 2**20, 3)
    mb = _env_float("TPUFRAME_COMPILE_CACHE_MAX_MB", 1024.0)
    info["max_mb"] = mb if 0 < mb < 2**40 else None
    v = os.environ.get("TPUFRAME_COMPILE_CACHE_KEEP", "")
    info["keep"] = int(v) if v.isdigit() else 16
    return info
