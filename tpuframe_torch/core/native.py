"""Native (C++) heartbeat for the launcher: a ``g++`` build at first use,
``ctypes`` bindings.

Port of the heartbeat half of ``tpuframe/core/native.py``
(:class:`HeartbeatMonitor`, :class:`HeartbeatBeacon`,
:func:`maybe_start_beacon`) over the port's own source,
``tpuframe_torch/csrc/heartbeat.cpp``.  It compiles with ``g++`` into
``build/tpuframe_torch/`` beside the package, named by a hash of the
source, and never loads the JAX package's library.  Without a toolchain
:func:`heartbeat_available` is False and the classes raise
``RuntimeError``; the launcher then runs without liveness detection and
logs that, as the JAX launcher treats the monitor as best-effort.

The JAX module's ``ZstdCodec``, ``JpegDecoder`` and ``ControlPlane`` are
not here: the codec and the decoder come with the data remainder, and the
port sends its small host values (the run id) over the process group.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["HeartbeatBeacon", "HeartbeatMonitor", "heartbeat_available", "maybe_start_beacon"]

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "heartbeat.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuframe_torch"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB: list = []  # [] until the first load; then [CDLL or None]
#: why the last build or load failed (None when it did not)
build_error: str | None = None


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libtfhb-{digest[:16]}.so"


def _hb_lib() -> ctypes.CDLL | None:
    """The built library with its signatures declared; None when ``g++``
    is missing or the build fails (:data:`build_error` says why)."""
    global build_error
    with _LOCK:
        if _LIB:
            return _LIB[0]
        lib = None
        try:
            so = _library_path()
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp), "-lpthread"],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)  # atomic against a concurrent builder
            lib = ctypes.CDLL(str(so))
            lib.tfhb_monitor_create.restype = ctypes.c_void_p
            lib.tfhb_monitor_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_uint64]
            lib.tfhb_last_seen_ms.restype = ctypes.c_int64
            lib.tfhb_last_seen_ms.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.tfhb_monitor_destroy.argtypes = [ctypes.c_void_p]
            lib.tfhb_beacon_create.restype = ctypes.c_void_p
            lib.tfhb_beacon_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_uint64, ctypes.c_int]
            lib.tfhb_beacon_destroy.argtypes = [ctypes.c_void_p]
            build_error = None
        except (OSError, subprocess.SubprocessError) as e:
            stderr = getattr(e, "stderr", b"") or b""
            build_error = f"{type(e).__name__}: {e} {stderr.decode(errors='replace')[-2000:]}"
            lib = None
        _LIB.append(lib)
        return lib


def heartbeat_available() -> bool:
    """Whether the heartbeat library builds and loads here."""
    return _hb_lib() is not None


def _token_u64(token: str) -> int:
    """The run's token as the 64-bit handshake value (the JAX package's
    hash, so either side's beacon can join the other's monitor)."""
    if not token:
        return 0
    return int.from_bytes(hashlib.sha256(token.encode()).digest()[:8], "little")


def _require() -> ctypes.CDLL:
    lib = _hb_lib()
    if lib is None:
        raise RuntimeError(f"the heartbeat library did not build: {build_error}")
    return lib


class HeartbeatMonitor:
    """Driver-side liveness tracker: workers run a :class:`HeartbeatBeacon`,
    and the monitor answers how long ago rank k last beat.  It sees worker,
    host and network death; a wedged main thread of a live worker keeps
    beating (the beacon is a thread of its own) and is the run deadline's
    case."""

    def __init__(self, port: int, world: int, *, token: str = "", bind: str = ""):
        lib = _require()
        self._lib = lib
        self.world = world
        self._h = lib.tfhb_monitor_create(bind.encode(), port, world, _token_u64(token))
        if not self._h:
            raise OSError(f"heartbeat monitor failed to bind port {port}")

    def ms_since(self, rank: int) -> int:
        """Milliseconds since ``rank``'s last beat; -1 if never seen."""
        return int(self._lib.tfhb_last_seen_ms(self._h, rank))

    def stale_ranks(self, timeout_s: float, *, include_unseen: bool = False) -> list[int]:
        """Ranks whose last beat is older than ``timeout_s`` (ranks never
        seen only with ``include_unseen``: start-up takes a while)."""
        out = []
        for r in range(self.world):
            ms = self.ms_since(r)
            if (ms < 0 and include_unseen) or ms > timeout_s * 1000:
                out.append(r)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.tfhb_monitor_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HeartbeatBeacon:
    """Worker-side beat: a background thread that sends one byte per
    interval to the monitor and reconnects forever on failure."""

    def __init__(self, address: str, port: int, rank: int, *, token: str = "",
                 interval_ms: int = 1000):
        lib = _require()
        self._lib = lib
        self._h = lib.tfhb_beacon_create(address.encode(), port, rank, _token_u64(token),
                                         interval_ms)

    def close(self) -> None:
        if self._h:
            self._lib.tfhb_beacon_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maybe_start_beacon() -> HeartbeatBeacon | None:
    """A beacon from the launcher's env contract when one is asked for
    (``TPUFRAME_HB_PORT``; ``TPUFRAME_HB_ADDR`` or ``MASTER_ADDR``,
    ``RANK`` and ``TPUFRAME_CP_TOKEN``); None when it is not, or when the
    library is missing (liveness never blocks training)."""
    port = os.environ.get("TPUFRAME_HB_PORT")
    if not port:
        return None
    try:
        return HeartbeatBeacon(
            os.environ.get("TPUFRAME_HB_ADDR") or os.environ.get("MASTER_ADDR", "127.0.0.1"),
            int(port), int(os.environ.get("RANK", "0")),
            token=os.environ.get("TPUFRAME_CP_TOKEN", ""))
    except (RuntimeError, OSError, ValueError):
        return None
