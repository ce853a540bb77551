"""Native (C++) extensions: a ``g++`` build at first use, ``ctypes``
bindings.

Port of ``tpuframe/core/native.py`` over the port's own sources under
``tpuframe_torch/csrc/``:

- the launcher's heartbeat (:class:`HeartbeatMonitor`,
  :class:`HeartbeatBeacon`, :func:`maybe_start_beacon`;
  ``heartbeat.cpp``);
- :class:`ZstdCodec`: the shard codec, batch decompression on a GIL-free
  thread pool (``codec.cpp``, ``-lzstd``, or libzstd's runtime library
  by its soname where the development files are missing);
- :class:`JpegDecoder`: batch JPEG decode through libjpeg(-turbo) on the
  same pool shape, with decode-at-scale and the decompression-bomb guard
  (``jpegdec.cpp``, ``-ljpeg``).

Each source compiles with ``g++`` into ``build/tpuframe_torch/`` beside
the package, named by a hash of the source and flags, and the port never
loads the JAX package's libraries.  Without a toolchain or the library
headers, :func:`heartbeat_available`, :func:`native_available` and
:func:`jpeg_native_available` are False, the classes raise
``RuntimeError``, and :data:`build_errors` (and :data:`build_error`, the
last failure) say why.  The launcher then runs without liveness detection,
the shards fall back to the ``zstandard`` module and the decoder to PIL,
as in the JAX package.

The JAX module's ``ControlPlane`` is not here: the port sends its small
host values (the run id) over the process group.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

__all__ = ["HeartbeatBeacon", "HeartbeatMonitor", "JpegDecoder", "ZstdCodec",
           "heartbeat_available", "jpeg_native_available", "maybe_start_beacon",
           "native_available"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuframe_torch"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}  # library name -> CDLL, None if it failed
#: library name (``tfhb``, ``tfscodec``, ``tfjpeg``) -> why its build or
#: load failed, None when it did not
build_errors: dict[str, str | None] = {}
#: why the last failed build or load failed (None while none has)
build_error: str | None = None


def _library_path(name: str, source: Path, libs: Sequence[str]) -> Path:
    flags = " ".join(_FLAGS + tuple(f"-l{x}" for x in libs))
    digest = hashlib.sha256(source.read_bytes() + flags.encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _load(name: str, source: str, link: Sequence[Sequence[str]], declare) -> ctypes.CDLL | None:
    """``csrc/<source>`` built (once), loaded, its signatures declared by
    ``declare(lib)``.  ``link`` lists the ``-l`` libraries to try, one
    set after the other, until a build links and loads.  None when ``g++``
    or a library is missing or every build fails (:data:`build_errors`
    says why)."""
    global build_error
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        lib, errors = None, []
        src = _CSRC / source
        for libs in link:
            try:
                so = _library_path(name, src, libs)
                if not so.exists():
                    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                    subprocess.run(["g++", *_FLAGS, str(src), "-o", str(tmp), "-lpthread",
                                    *(f"-l{x}" for x in libs)],
                                   check=True, capture_output=True, timeout=120)
                    os.replace(tmp, so)  # atomic against a concurrent build
                lib = ctypes.CDLL(str(so))
                declare(lib)
                break
            except (OSError, subprocess.SubprocessError) as e:
                stderr = getattr(e, "stderr", b"") or b""
                errors.append(f"{type(e).__name__}: {e} "
                              f"{stderr.decode(errors='replace')[-1000:]}")
                lib = None
        if lib is None:
            build_error = build_errors[name] = f"lib{name} ({source}): " + " | ".join(errors)
        else:
            build_errors[name] = None
        _LIBS[name] = lib
        return lib


def _declare_heartbeat(lib: ctypes.CDLL) -> None:
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


def _hb_lib() -> ctypes.CDLL | None:
    return _load("tfhb", "heartbeat.cpp", [()], _declare_heartbeat)


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
        raise RuntimeError(f"the heartbeat library did not build: {build_errors.get('tfhb')}")
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


# -- the shard codec ------------------------------------------------------------


def _declare_codec(lib: ctypes.CDLL) -> None:
    lib.tfs_compress_bound.restype = ctypes.c_size_t
    lib.tfs_compress_bound.argtypes = [ctypes.c_size_t]
    lib.tfs_frame_content_size.restype = ctypes.c_uint64
    lib.tfs_frame_content_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.tfs_compress.restype = ctypes.c_int
    lib.tfs_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
    ]
    lib.tfs_batch_decompress.restype = ctypes.c_int


def _codec_lib() -> ctypes.CDLL | None:
    # libzstd's development link, else its runtime library by soname (where
    # zstd.h is missing too, codec.cpp declares the entry points it uses)
    return _load("tfscodec", "codec.cpp", [("zstd",), (":libzstd.so.1",)], _declare_codec)


def native_available() -> bool:
    """True when the C++ codec built (toolchain + libzstd present)."""
    return _codec_lib() is not None


class ZstdCodec:
    """Batch zstd codec backed by the C++ thread pool.

    ``decompress_batch`` releases the GIL for the whole batch: shard
    blocks decode in parallel while Python goes on prefetching.
    """

    def __init__(self, n_threads: int | None = None):
        self._lib = _codec_lib()
        if self._lib is None:
            raise RuntimeError(f"native codec unavailable: {build_errors.get('tfscodec')}")
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)

    def compress(self, data: bytes, level: int = 3) -> bytes:
        lib = self._lib
        cap = lib.tfs_compress_bound(len(data))
        out = ctypes.create_string_buffer(cap)
        out_size = ctypes.c_size_t()
        rc = lib.tfs_compress(data, len(data), out, cap, ctypes.byref(out_size), level)
        if rc != 0:
            raise RuntimeError("zstd compress failed")
        return out.raw[: out_size.value]

    def decompress(self, data: bytes, max_output_size: int | None = None) -> bytes:
        return self.decompress_batch([data], [max_output_size] if max_output_size else None)[0]

    def decompress_batch(self, blobs: Sequence[bytes],
                         raw_sizes: Sequence[int] | None = None) -> list[bytes]:
        """Decompress many frames at once (one C call, GIL released)."""
        lib = self._lib
        n = len(blobs)
        if n == 0:
            return []
        caps = []
        unknown = (1 << 64) - 1  # codec.cpp's unknown/error sentinel
        for i, blob in enumerate(blobs):
            if raw_sizes is not None and raw_sizes[i]:
                caps.append(int(raw_sizes[i]))
            else:
                size = lib.tfs_frame_content_size(blob, len(blob))
                if size == unknown:
                    raise ValueError(f"frame {i}: unknown content size")
                caps.append(int(size))
        src_arr = (ctypes.c_char_p * n)(*blobs)
        src_sizes = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
        outs = [ctypes.create_string_buffer(max(1, c)) for c in caps]
        dst_arr = (ctypes.c_void_p * n)(*[ctypes.addressof(o) for o in outs])
        dst_caps = (ctypes.c_size_t * n)(*caps)
        dst_sizes = (ctypes.c_size_t * n)()
        rc = lib.tfs_batch_decompress(
            ctypes.cast(src_arr, ctypes.POINTER(ctypes.c_char_p)), src_sizes,
            ctypes.cast(dst_arr, ctypes.POINTER(ctypes.c_char_p)), dst_caps, dst_sizes, n,
            self.n_threads)
        if rc != 0:
            raise RuntimeError(f"zstd decompress failed on frame {rc - 1}")
        return [outs[i].raw[: dst_sizes[i]] for i in range(n)]


# -- the JPEG decoder -------------------------------------------------------------


def _declare_jpeg(lib: ctypes.CDLL) -> None:
    pp = ctypes.POINTER(ctypes.c_char_p)
    lib.tfj_dims.restype = ctypes.c_int
    lib.tfj_dims.argtypes = [pp, ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
                             ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.tfj_decode_batch.restype = ctypes.c_int
    lib.tfj_decode_batch.argtypes = [pp, ctypes.POINTER(ctypes.c_size_t), pp,
                                     ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                                     ctypes.c_int32, ctypes.c_int32, ctypes.c_int]


def _jpeg_lib() -> ctypes.CDLL | None:
    return _load("tfjpeg", "jpegdec.cpp", [("jpeg",)], _declare_jpeg)


def jpeg_native_available() -> bool:
    """True when the C++ JPEG decoder built (toolchain + libjpeg)."""
    return _jpeg_lib() is not None


#: decompression-bomb budget when PIL isn't importable: PIL's own default
#: MAX_IMAGE_PIXELS (0.25 GiB of 32-bit pixels)
_DEFAULT_MAX_PIXELS = 178956970


def _pil_max_pixels() -> int:
    try:
        from PIL import Image

        # a user's Image.MAX_IMAGE_PIXELS = None disables PIL's guard;
        # mirror that as "no budget"
        return Image.MAX_IMAGE_PIXELS or (1 << 62)
    except ImportError:
        return _DEFAULT_MAX_PIXELS


class JpegDecoder:
    """Batch JPEG decode backed by libjpeg(-turbo) on a C++ thread pool.

    Returns HWC uint8 arrays: RGB for color images, HW for grayscale (PIL's
    ``np.asarray(Image.open(...))`` shapes, so the two decode paths are
    interchangeable).  Exotic color spaces (CMYK/YCCK) fail the item;
    callers fall back to PIL for those.

    ``max_pixels`` (default: PIL's ``Image.MAX_IMAGE_PIXELS``) bounds the
    header-declared size *before* any allocation: a few-hundred-byte JPEG
    claiming 65500x65500 would otherwise force a ~12.8 GB allocation per
    item.  Oversized items raise ``ValueError``; callers fall back to PIL,
    whose own bomb limit then decides.
    """

    def __init__(self, n_threads: int | None = None, max_pixels: int | None = None):
        self._lib = _jpeg_lib()
        if self._lib is None:
            raise RuntimeError(
                f"native jpeg decoder unavailable: {build_errors.get('tfjpeg')}")
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self.max_pixels = _pil_max_pixels() if max_pixels is None else int(max_pixels)

    def decode_batch(self, blobs: Sequence[bytes], min_hw: tuple | None = None) -> list:
        """Decode many JPEGs in one GIL-free C call.

        ``min_hw=(h, w)`` decodes each image at the smallest DCT scale M/8
        whose output still covers (h, w): most of a downstream ``Resize``
        happens inside the IDCT.  The output is the scaled size (>= min_hw
        per dimension, never upscaled); an exact-size finisher is the
        caller's.
        """
        import numpy as np

        n = len(blobs)
        if n == 0:
            return []
        min_h, min_w = (int(min_hw[0]), int(min_hw[1])) if min_hw else (0, 0)
        src_arr = (ctypes.c_char_p * n)(*blobs)
        src_p = ctypes.cast(src_arr, ctypes.POINTER(ctypes.c_char_p))
        sizes = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
        dims = (ctypes.c_int32 * (3 * n))()
        rc = self._lib.tfj_dims(src_p, sizes, n, min_h, min_w, dims)
        if rc != 0:
            raise ValueError(f"invalid JPEG header at item {rc - 1}")
        # the bomb guard, before any allocation: it budgets the header's
        # declared size (PIL's Image.open rule), not the scaled output,
        # since the entropy decode's cost tracks the declared size
        if self.max_pixels:
            decl = dims
            if min_h or min_w:  # dims above are at the covering M/8 scale
                decl = (ctypes.c_int32 * (3 * n))()
                self._lib.tfj_dims(src_p, sizes, n, 0, 0, decl)
            for i in range(n):
                h, w = int(decl[3 * i]), int(decl[3 * i + 1])
                if h * w > self.max_pixels:
                    raise ValueError(
                        f"image {i}: header declares {h}x{w} = {h * w} pixels, over the "
                        f"{self.max_pixels}-pixel budget (decompression-bomb guard)")
        outs = []
        for i in range(n):
            h, w, c = dims[3 * i], dims[3 * i + 1], dims[3 * i + 2]
            outs.append(np.empty((h, w, 3) if c == 3 else (h, w), np.uint8))
        dst_arr = (ctypes.c_void_p * n)(*[out.ctypes.data for out in outs])
        rc = self._lib.tfj_decode_batch(
            src_p, sizes, ctypes.cast(dst_arr, ctypes.POINTER(ctypes.c_char_p)), dims, n,
            min_h, min_w, self.n_threads)
        if rc != 0:
            raise ValueError(f"JPEG decode failed at item {rc - 1}")
        return outs

    def decode(self, blob: bytes, min_hw: tuple | None = None):
        return self.decode_batch([blob], min_hw=min_hw)[0]
