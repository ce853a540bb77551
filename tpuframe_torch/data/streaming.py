"""Compressed streaming shard format ("TFS"), the MDS-equivalent pipeline.

The port's own copy of ``tpuframe/data/streaming.py`` (numpy, msgpack and
the stdlib): the same file format, byte for byte, so a volume written by
either package reads in the other.  Against the reference's
mosaicml-streaming recipe:

- ``MDSWriter(columns={'image': 'pil', 'label': 'int'}, compression='zstd')``
  loop -> :class:`ShardWriter`
- a ``StreamingDataset`` subclass streaming remote shards into a local
  cache -> :class:`StreamingDataset`
- the ``clean_stale_shared_memory()`` guard -> :func:`clean_stale_cache`

A shard is a zstd-compressed msgpack record block with an uncompressed JSON
index (``index.json``) listing shard files, sample counts and sha256
checksums.  Readers pull shards remote->local on first touch (a filesystem
copy by default; any fetcher callable plugs in), decode whole shards at
once (sequential multi-MB reads and batch decompression keep the host CPU
ahead of the card) and keep a small decoded-shard LRU.  The zstd codec is
the port's C++ batch codec (``core.native.ZstdCodec``) where it builds,
else the ``zstandard`` module; JPEG columns decode through the port's
libjpeg decoder (``core.native.JpegDecoder``) where it builds, else PIL.
:func:`_codec_name` and :func:`_decoder_name` say which ran.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from collections import OrderedDict
from typing import Any, Callable, Mapping

import msgpack

import numpy as np

from tpuframe_torch.data.datasets import item_rng

INDEX_NAME = "index.json"
FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# column codecs
# ---------------------------------------------------------------------------

def _enc_ndarray(v: Any) -> dict:
    arr = np.ascontiguousarray(v)
    return {"d": arr.dtype.str, "s": list(arr.shape), "b": arr.tobytes()}


def _dec_ndarray(v: dict) -> np.ndarray:
    return np.frombuffer(v[b"b"], dtype=np.dtype(v[b"d"].decode())).reshape(v[b"s"])


def _enc_image(fmt: str):
    def enc(v: Any) -> bytes:
        from PIL import Image

        if isinstance(v, np.ndarray):
            v = Image.fromarray(v)
        buf = io.BytesIO()
        v.save(buf, format=fmt)
        return buf.getvalue()

    return enc


_JPEG_DECODER: Any = "unset"  # tri-state lazy singleton


def _native_jpeg():
    """The C++ libjpeg decoder, or None (no toolchain / disabled).

    GIL-free, where Pillow's decoders hold the GIL and so cap
    thread-worker scaling at about one core; built once, one thread by
    default because the DataLoader's worker pool already provides the
    parallelism (a nested pool would oversubscribe).
    ``TPUFRAME_JPEG_THREADS=N`` widens the decoder's own pool for
    low-worker setups.  Kill switch: ``TPUFRAME_NATIVE_JPEG=0``.
    """
    global _JPEG_DECODER
    if _JPEG_DECODER == "unset":
        _JPEG_DECODER = None
        if os.environ.get("TPUFRAME_NATIVE_JPEG", "1") != "0":
            # parse the knob OUTSIDE the build try: a typo'd value must
            # warn and fall back to 1, not silently disable the native
            # decoder the variable exists to tune
            raw = os.environ.get("TPUFRAME_JPEG_THREADS", "1")
            try:
                n_threads = max(1, int(raw))
            except ValueError:
                import warnings

                warnings.warn(
                    f"TPUFRAME_JPEG_THREADS={raw!r} is not an integer; "
                    "using 1", stacklevel=2,
                )
                n_threads = 1
            try:
                from tpuframe_torch.core.native import JpegDecoder

                _JPEG_DECODER = JpegDecoder(n_threads=n_threads)
            except Exception:
                _JPEG_DECODER = None
    return _JPEG_DECODER


def _dec_image(v: bytes, min_hw: tuple | None = None) -> np.ndarray:
    """Decode an encoded image file to HWC uint8 (HW for grayscale).

    ``min_hw=(h, w)`` fuses most of a downstream Resize into the decode:
    JPEGs decode at the smallest DCT scale M/8 still covering (h, w) —
    3-14x cheaper than decode-full-then-resize — and the PIL fallback
    uses ``Image.draft`` (1/2, 1/4, 1/8 scales) for the same contract.
    Output is always >= min_hw per dimension, never upscaled; an exact
    Resize finisher downstream stays correct and becomes nearly free.
    """
    if v[:2] == b"\xff\xd8":  # JPEG magic
        dec = _native_jpeg()
        if dec is not None:
            try:
                return dec.decode(v, min_hw=min_hw)
            except ValueError:
                pass  # exotic color space (CMYK/YCCK) -> PIL handles it
    from PIL import Image

    img = Image.open(io.BytesIO(v))
    if min_hw is not None:
        # draft-mode DCT scaling never undershoots the requested size
        img.draft(None, (int(min_hw[1]), int(min_hw[0])))
    return np.asarray(img)


CODECS: dict[str, tuple[Callable, Callable]] = {
    "ndarray": (_enc_ndarray, _dec_ndarray),
    "jpg": (_enc_image("JPEG"), _dec_image),
    "png": (_enc_image("PNG"), _dec_image),
    "int": (int, int),
    "float": (float, float),
    "str": (str, lambda v: v.decode() if isinstance(v, bytes) else v),
    "bytes": (bytes, bytes),
}


def _get_zstd():
    import zstandard

    return zstandard


_NATIVE_CODEC = None
_NATIVE_TRIED = False


def _native_codec():
    """The C++ batch codec (``core.native.ZstdCodec``), or None without a
    toolchain or libzstd (``core.native.build_errors`` says why)."""
    global _NATIVE_CODEC, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            from tpuframe_torch.core.native import ZstdCodec

            _NATIVE_CODEC = ZstdCodec()
        except Exception:
            _NATIVE_CODEC = None
    return _NATIVE_CODEC


def _codec_name() -> str:
    """Which zstd codec the shards use here: ``"native"`` (the port's C++
    codec), ``"zstandard"`` (the module) or ``"none"``."""
    if _native_codec() is not None:
        return "native"
    try:
        _get_zstd()
    except ImportError:
        return "none"
    return "zstandard"


def _decoder_name() -> str:
    """Which decoder JPEG columns take here: ``"native"`` (the port's
    libjpeg decoder), ``"pil"`` or ``"none"``."""
    if _native_jpeg() is not None:
        return "native"
    try:
        import PIL  # noqa: F401
    except ImportError:
        return "none"
    return "pil"


def _zstd_compress(raw: bytes, level: int) -> bytes:
    codec = _native_codec()
    if codec is not None:
        return codec.compress(raw, level)
    return _get_zstd().ZstdCompressor(level=level).compress(raw)


def _zstd_decompress(data: bytes, raw_bytes: int) -> bytes:
    codec = _native_codec()
    if codec is not None:
        return codec.decompress(data, max_output_size=raw_bytes)
    return _get_zstd().ZstdDecompressor().decompress(data, max_output_size=raw_bytes)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class ShardWriter:
    """Write samples into compressed shards + JSON index.

    >>> with ShardWriter(out, columns={"image": "ndarray", "label": "int"}) as w:
    ...     for img, lb in samples:
    ...         w.write({"image": img, "label": lb})
    """

    def __init__(
        self,
        out_dir: str,
        columns: Mapping[str, str],
        shard_size_limit: int = 1 << 26,
        compression: str = "zstd",
        compression_level: int = 3,
    ):
        unknown = set(columns.values()) - set(CODECS)
        if unknown:
            raise ValueError(f"unknown column codecs {unknown}; have {sorted(CODECS)}")
        if compression not in ("zstd", "none"):
            raise ValueError(f"compression must be 'zstd' or 'none', got {compression!r}")
        self.out_dir = out_dir
        self.columns = dict(columns)
        self.shard_size_limit = shard_size_limit
        self.compression = compression
        self.compression_level = compression_level
        os.makedirs(out_dir, exist_ok=True)
        self._buf: list[bytes] = []
        self._buf_bytes = 0
        self._shards: list[dict] = []
        self._closed = False

    def write(self, sample: Mapping[str, Any]) -> None:
        if self._closed:
            raise RuntimeError("writer is closed")
        if set(sample) != set(self.columns):
            raise ValueError(f"sample keys {set(sample)} != columns {set(self.columns)}")
        record = {
            key: CODECS[codec][0](sample[key]) for key, codec in self.columns.items()
        }
        packed = msgpack.packb(record, use_bin_type=True)
        self._buf.append(packed)
        self._buf_bytes += len(packed)
        if self._buf_bytes >= self.shard_size_limit:
            self._flush_shard()

    def _flush_shard(self) -> None:
        if not self._buf:
            return
        raw = msgpack.packb(self._buf, use_bin_type=True)
        if self.compression == "zstd":
            data = _zstd_compress(raw, self.compression_level)
        else:
            data = raw
        name = f"shard.{len(self._shards):05d}.tfs"
        with open(os.path.join(self.out_dir, name), "wb") as f:
            f.write(data)
        self._shards.append(
            {
                "file": name,
                "n": len(self._buf),
                "raw_bytes": len(raw),
                "stored_bytes": len(data),
                "sha256": hashlib.sha256(data).hexdigest(),
            }
        )
        self._buf, self._buf_bytes = [], 0

    def close(self) -> None:
        if self._closed:
            return
        self._flush_shard()
        index = {
            "version": FORMAT_VERSION,
            "columns": self.columns,
            "compression": self.compression,
            "shards": self._shards,
            "total": sum(s["n"] for s in self._shards),
        }
        with open(os.path.join(self.out_dir, INDEX_NAME), "w") as f:
            json.dump(index, f, indent=1)
        self._closed = True

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _default_fetcher(remote_path: str, local_path: str) -> None:
    """Remote->local 'download'.  For UC-volume/NFS-style remotes this is a
    copy; object-store fetchers plug in via StreamingDataset(fetcher=...)."""
    shutil.copyfile(remote_path, local_path)


def _fetch_atomic(fetcher: Callable[[str, str], None], remote_path: str,
                  local: str) -> None:
    """Fetch ``remote_path`` into ``local`` atomically and race-safely.

    Per-attempt tmp name (pid AND thread — the load paths are unlocked,
    so two workers missing the same file must not collide), cleanup on
    failure, and defer-to-racing-winner: a failed duplicate fetch (e.g.
    object-store 429) is forgiven when another worker already promoted
    the file.  KeyboardInterrupt/SystemExit always propagate after
    cleanup — never swallowed.
    """
    tmp = f"{local}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        fetcher(remote_path, tmp)
    except BaseException as e:
        try:
            os.remove(tmp)  # no orphaned partial downloads
        except OSError:
            pass
        if isinstance(e, Exception) and os.path.exists(local):
            return
        raise
    os.replace(tmp, local)  # atomic: concurrent workers see full files


class StreamingDataset:
    """Map-style dataset over a TFS shard directory with remote->local cache.

    Shards are fetched on first touch into ``local_cache`` (skipped when the
    remote is already local and ``cache_locally=False``), integrity-checked,
    decoded whole, and kept in a small decoded LRU.  Thread-safe; plugs
    directly into ``tpuframe_torch.data.DataLoader``, whose per-process
    index sharding means each process only touches its own shard subset.
    """

    def __init__(
        self,
        remote: str,
        local_cache: str | None = None,
        transform: Callable | None = None,
        image_key: str = "image",
        label_key: str = "label",
        decoded_cache_shards: int = 2,
        fetcher: Callable[[str, str], None] = _default_fetcher,
        validate_checksum: bool = True,
        rng_seed: int = 0,
        decode_min_hw: tuple | None = None,
    ):
        self.rng_seed = rng_seed
        self.remote = remote
        self.local_cache = local_cache
        self.transform = transform
        self.image_key = image_key
        self.label_key = label_key
        self.fetcher = fetcher
        self.validate_checksum = validate_checksum
        #: fused decode-at-scale hint for the image column (jpg codec):
        #: decode covers (h, w) without a full-size detour — see
        #: :func:`_dec_image`.  Pair with a Resize(h) transform finisher.
        self.decode_min_hw = (
            (int(decode_min_hw[0]), int(decode_min_hw[1]))
            if decode_min_hw is not None else None
        )
        self.epoch = 0

        index_path = os.path.join(remote, INDEX_NAME)
        if local_cache is not None:
            os.makedirs(local_cache, exist_ok=True)
            local_index = os.path.join(local_cache, INDEX_NAME)
            if not os.path.exists(local_index):
                _fetch_atomic(fetcher, index_path, local_index)
            index_path = local_index
        with open(index_path) as f:
            self.index = json.load(f)
        if self.index.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported TFS version {self.index.get('version')}")
        self.columns = self.index["columns"]
        self._starts = np.cumsum([0] + [s["n"] for s in self.index["shards"]])
        self._lock = threading.Lock()
        self._decoded: OrderedDict[int, list] = OrderedDict()
        self._decoded_cap = max(1, decoded_cache_shards)

    def __getstate__(self):
        # dataset handles, not dataset bytes, cross the process boundary:
        # the handle pickles; the lock and decoded-shard LRU are per-process
        # and rebuilt on arrival
        state = self.__dict__.copy()
        state["_lock"] = None
        state["_decoded"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._decoded = OrderedDict()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return int(self._starts[-1])

    def _shard_path(self, shard: dict) -> str:
        if self.local_cache is None:
            return os.path.join(self.remote, shard["file"])
        local = os.path.join(self.local_cache, shard["file"])
        if not os.path.exists(local):
            _fetch_atomic(
                self.fetcher, os.path.join(self.remote, shard["file"]), local
            )
        return local

    def _load_shard(self, shard_idx: int) -> list:
        with self._lock:
            if shard_idx in self._decoded:
                self._decoded.move_to_end(shard_idx)
                return self._decoded[shard_idx]
        shard = self.index["shards"][shard_idx]
        with open(self._shard_path(shard), "rb") as f:
            data = f.read()
        if self.validate_checksum:
            digest = hashlib.sha256(data).hexdigest()
            if digest != shard["sha256"]:
                raise IOError(
                    f"checksum mismatch on {shard['file']}: {digest} != {shard['sha256']}"
                )
        if self.index["compression"] == "zstd":
            data = _zstd_decompress(data, shard["raw_bytes"])
        records = msgpack.unpackb(data, raw=True)
        with self._lock:
            self._decoded[shard_idx] = records
            while len(self._decoded) > self._decoded_cap:
                self._decoded.popitem(last=False)
        return records

    def _decode_record(self, packed: bytes) -> dict:
        rec = msgpack.unpackb(packed, raw=True)
        out = {}
        for key, codec in self.columns.items():
            raw = rec[key.encode()]
            if (codec == "jpg" and key == self.image_key
                    and self.decode_min_hw is not None):
                out[key] = _dec_image(raw, min_hw=self.decode_min_hw)
            else:
                out[key] = CODECS[codec][1](raw)
        return out

    def sample(self, idx: int) -> dict:
        """Full decoded sample dict at global index."""
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        shard_idx = int(np.searchsorted(self._starts, idx, side="right") - 1)
        records = self._load_shard(shard_idx)
        return self._decode_record(records[idx - self._starts[shard_idx]])

    def __getitem__(self, idx: int):
        rec = self.sample(int(idx))
        image = rec[self.image_key]
        if self.transform is not None:
            image = self.transform(image, item_rng(self.rng_seed, self.epoch, int(idx)))
        return np.asarray(image), int(rec[self.label_key])


def clean_stale_cache(local_cache: str) -> int:
    """Remove partial downloads left by a killed run.

    ≈ mosaicml-streaming's ``clean_stale_shared_memory()``: here the
    failure mode is stale ``*.tmp`` shard files, not POSIX shared memory.
    Returns how many it removed.
    """
    removed = 0
    if not os.path.isdir(local_cache):
        return 0
    for name in os.listdir(local_cache):
        if name.endswith(".tmp"):
            os.remove(os.path.join(local_cache, name))
            removed += 1
    return removed
