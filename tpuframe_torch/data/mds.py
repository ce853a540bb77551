"""MosaicML MDS shard interop: read existing volumes, write compatible ones.

The port's own copy of ``tpuframe/data/mds.py`` (numpy and the stdlib):
the same on-disk layout, byte for byte.  A reference user's MDS volumes
(``MDSWriter`` with columns ``{'image': 'pil', 'label': 'int'}`` and
``compression='zstd'``) are read directly by :class:`MDSDataset` (a
map-style dataset for ``tpuframe_torch.data.DataLoader``) or converted
once with :func:`mds_to_tfs` into the TFS format of
``tpuframe_torch.data.streaming``.  :class:`MDSWriter` is the write half:
it produces volumes in the same layout, so data prepared here stays
readable by mosaicml-streaming loaders.

This implements the public MDS on-disk layout (mosaicml-streaming's
``format/mds``, Apache-2.0; re-implemented from the format, not copied):

- ``index.json``: ``{"version": 2, "shards": [entry...]}``; each entry
  carries ``column_names/column_encodings/column_sizes``, ``samples``,
  ``raw_data {basename, bytes}`` and optionally ``zip_data`` +
  ``compression`` (e.g. ``"zstd:7"``).
- shard file: ``uint32 n`` | ``uint32 offsets[n+1]`` (absolute file
  positions) | concatenated sample bytes.
- sample: one ``uint32`` size per *variable-width* column (in column
  order), then each column's bytes in column order.
- encodings: fixed-width ints/floats are little-endian numpy scalars;
  ``str`` is utf-8; ``bytes`` raw; ``jpeg``/``png`` are the encoded image
  file bytes; ``pil`` is ``uint32[3] = (width, height, len(mode))`` +
  mode + ``Image.tobytes()`` raw pixels.

Decode-on-access only: no shared memory, no background workers.  Shard
files are whole-file reads and the DataLoader's process sharding already
keeps each process on its own subset.  Stock mosaicml-streaming has not
been run against bytes written here (it is not installed where this was
built); the JAX package's tests hold the layout against an independent
from-spec generator, and the port's tests hold the port's bytes equal to
the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
from typing import Any, Callable, Mapping

import numpy as np

from tpuframe_torch.data.datasets import item_rng

INDEX_NAME = "index.json"

# fixed-width scalar encodings: name -> numpy dtype (little-endian)
_SCALARS = {
    "int": "<i8",
    "int8": "<i1",
    "int16": "<i2",
    "int32": "<i4",
    "int64": "<i8",
    "uint8": "<u1",
    "uint16": "<u2",
    "uint32": "<u4",
    "uint64": "<u8",
    "float16": "<f2",
    "float32": "<f4",
    "float64": "<f8",
}


def _decode_pil(data: bytes) -> np.ndarray:
    from PIL import Image

    width, height, mode_len = struct.unpack("<III", data[:12])
    mode = data[12 : 12 + mode_len].decode("utf-8")
    img = Image.frombytes(mode, (int(width), int(height)), data[12 + mode_len :])
    return np.asarray(img)


def _decode_image_file(data: bytes, min_hw: tuple | None = None) -> np.ndarray:
    # shares streaming's decode path (native libjpeg fast path with fused
    # decode-at-scale, PIL fallback) so MDS jpeg columns get the same
    # GIL-free decode
    from tpuframe_torch.data.streaming import _dec_image

    return _dec_image(data, min_hw=min_hw)


def _decode_value(encoding: str, data: bytes,
                  min_hw: tuple | None = None) -> Any:
    if encoding in _SCALARS:
        return np.frombuffer(data, dtype=_SCALARS[encoding])[0].item()
    if encoding == "str":
        return data.decode("utf-8")
    if encoding == "bytes":
        return data
    if encoding == "pil":
        return _decode_pil(data)
    if encoding in ("jpeg", "png", "jpeg_array"):
        return _decode_image_file(data, min_hw=min_hw)
    raise ValueError(
        f"unsupported MDS column encoding {encoding!r}; supported: "
        f"{sorted(_SCALARS) + ['str', 'bytes', 'pil', 'jpeg', 'png']}"
    )


def _decode_sample(
    data: bytes, names: list[str], encodings: list[str],
    sizes: list[int | None], min_hw_cols: Mapping[str, tuple] | None = None,
) -> dict:
    # one uint32 per variable-width column leads the sample, in order
    widths: list[int] = []
    head = 0
    for size in sizes:
        if size is None:
            widths.append(struct.unpack_from("<I", data, head)[0])
            head += 4
        else:
            widths.append(int(size))
    out = {}
    pos = head
    for name, encoding, width in zip(names, encodings, widths):
        out[name] = _decode_value(
            encoding, data[pos : pos + width],
            min_hw=(min_hw_cols or {}).get(name),
        )
        pos += width
    return out


def _default_fetcher(remote_path: str, local_path: str) -> None:
    shutil.copyfile(remote_path, local_path)


def _encode_pil(img) -> bytes:
    import numpy as _np

    from PIL import Image

    if isinstance(img, _np.ndarray):
        img = Image.fromarray(img)
    mode = img.mode.encode("utf-8")
    w, h = img.size
    return struct.pack("<III", w, h, len(mode)) + mode + img.tobytes()


def _encode_value(encoding: str, value: Any) -> bytes:
    if encoding in _SCALARS:
        return np.asarray(value, dtype=_SCALARS[encoding]).tobytes()
    if encoding == "str":
        return str(value).encode("utf-8")
    if encoding == "bytes":
        return bytes(value)
    if encoding == "pil":
        return _encode_pil(value)
    if encoding in ("jpeg", "png"):
        from tpuframe_torch.data.streaming import _enc_image

        return _enc_image(encoding.upper())(value)
    raise ValueError(f"unsupported MDS column encoding {encoding!r}")


class MDSWriter:
    """Write an MDS directory mosaicml-streaming loaders can read.

    The write-side counterpart of :class:`MDSDataset` — same on-disk
    layout (module docstring), so shards produced here round-trip through
    the reader and through stock ``streaming.StreamingDataset``.  The API
    mirrors the reference's ``MDSWriter(out, columns, compression)``
    context-manager loop.

    Args:
      out_dir: output directory (created; index.json written on close).
      columns: name -> encoding (pil/jpeg/png/int*/uint*/float*/str/bytes).
      compression: ``"zstd"``/``"zstd:<level>"`` or None.
      size_limit: raw bytes per shard before rolling to the next one.
    """

    def __init__(
        self,
        out_dir: str,
        columns: Mapping[str, str],
        compression: str | None = "zstd",
        size_limit: int = 1 << 26,
    ):
        for enc in columns.values():
            if enc not in _SCALARS and enc not in (
                "str", "bytes", "pil", "jpeg", "png",
            ):
                raise ValueError(f"unsupported MDS column encoding {enc!r}")
        if compression is not None:
            algo, _, level = compression.partition(":")
            if algo != "zstd":
                raise ValueError(f"unsupported MDS compression {compression!r}")
            self._zstd_level = int(level) if level else 3
        self.out_dir = out_dir
        self.columns = dict(columns)
        self.compression = compression
        self.size_limit = size_limit
        os.makedirs(out_dir, exist_ok=True)
        self._names = list(self.columns)
        self._encodings = [self.columns[n] for n in self._names]
        self._sizes = [
            int(np.dtype(_SCALARS[e]).itemsize) if e in _SCALARS else None
            for e in self._encodings
        ]
        self._samples: list[bytes] = []
        self._bytes = 0
        self._entries: list[dict] = []
        self._closed = False

    def write(self, sample: Mapping[str, Any]) -> None:
        if self._closed:
            raise RuntimeError("writer is closed")
        if set(sample) != set(self._names):
            raise ValueError(
                f"sample keys {set(sample)} != columns {set(self._names)}"
            )
        head = b""
        body = b""
        for name, enc, size in zip(self._names, self._encodings, self._sizes):
            datum = _encode_value(enc, sample[name])
            if size is None:
                head += struct.pack("<I", len(datum))
            elif len(datum) != size:
                raise ValueError(
                    f"column {name!r} ({enc}): {len(datum)} bytes != {size}"
                )
            body += datum
        packed = head + body
        # roll-first (mosaicml-streaming semantics): a shard never exceeds
        # size_limit unless a single sample alone does.  The limit counts
        # the FULL shard file like mosaicml's accounting does — the
        # 8-byte header (uint32 n + offsets[0]) and 4 bytes/sample of
        # offset table — not just sample payloads.
        n_after = len(self._samples) + 1
        shard_bytes = 8 + 4 * n_after + self._bytes + len(packed)
        if self._samples and shard_bytes > self.size_limit:
            self._flush_shard()
        self._samples.append(packed)
        self._bytes += len(packed)

    def _flush_shard(self) -> None:
        if not self._samples:
            return
        n = len(self._samples)
        header = 4 + 4 * (n + 1)
        ends = header + np.cumsum([len(s) for s in self._samples])
        if int(ends[-1]) >= 1 << 32:
            # the format's offsets are uint32; assigning larger values
            # would silently wrap and corrupt the shard
            raise ValueError(
                f"MDS shard would be {int(ends[-1])} bytes; the format "
                "caps shards at 4 GiB — lower size_limit or split samples"
            )
        offsets = np.empty(n + 1, dtype="<u4")
        offsets[0] = header
        offsets[1:] = ends
        raw = struct.pack("<I", n) + offsets.tobytes() + b"".join(self._samples)
        si = len(self._entries)
        basename = f"shard.{si:05d}.mds"
        entry = {
            "column_encodings": list(self._encodings),
            "column_names": list(self._names),
            "column_sizes": list(self._sizes),
            "compression": None,
            "format": "mds",
            "hashes": ["sha256"],
            "raw_data": {
                "basename": basename,
                "bytes": len(raw),
                "hashes": {"sha256": hashlib.sha256(raw).hexdigest()},
            },
            "samples": n,
            "size_limit": self.size_limit,
            "version": 2,
            "zip_data": None,
        }
        if self.compression is None:
            with open(os.path.join(self.out_dir, basename), "wb") as f:
                f.write(raw)
        else:
            from tpuframe_torch.data.streaming import _zstd_compress

            comp = _zstd_compress(raw, self._zstd_level)
            zip_name = basename + ".zstd"
            with open(os.path.join(self.out_dir, zip_name), "wb") as f:
                f.write(comp)
            entry["compression"] = f"zstd:{self._zstd_level}"
            entry["zip_data"] = {
                "basename": zip_name,
                "bytes": len(comp),
                "hashes": {"sha256": hashlib.sha256(comp).hexdigest()},
            }
        self._entries.append(entry)
        self._samples, self._bytes = [], 0

    def close(self) -> None:
        if self._closed:
            return
        self._flush_shard()
        with open(os.path.join(self.out_dir, INDEX_NAME), "w") as f:
            json.dump(
                {"shards": self._entries, "version": 2}, f, sort_keys=True
            )
        self._closed = True

    def __enter__(self) -> "MDSWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Shard:
    """One MDS shard: lazily-cached (raw bytes, offsets table)."""

    def __init__(self, entry: dict, reader: "MDSDataset"):
        self.entry = entry
        self.reader = reader
        self.samples = int(entry["samples"])
        # cache slot, mutated only under the reader's lock; readers take a
        # local reference first, so eviction can never null it mid-slice
        self._data: tuple[bytes, np.ndarray] | None = None

    def read(self) -> tuple[bytes, np.ndarray]:
        """Fetch + decompress + verify from storage (no caching here).
        Verification (incl. the header sample count) lives in
        ``_shard_bytes`` so a bad cached download is evicted+retried."""
        raw = self.reader._shard_bytes(self.entry)
        offsets = np.frombuffer(raw, dtype="<u4", count=self.samples + 1,
                                offset=4)
        return raw, offsets


class MDSDataset:
    """Map-style dataset over a MosaicML-MDS shard directory.

    The read-side counterpart of the reference's ``StreamingDataset``
    subclass: ``__getitem__`` returns ``(image, label)`` numpy pairs,
    ready for ``tpuframe_torch.data.DataLoader``.  Remote directories are
    cached shard-by-shard into ``local_cache`` on first touch (the
    contract of ``tpuframe_torch.data.StreamingDataset``).

    Args:
      remote: directory containing ``index.json`` + shard files.
      local_cache: optional local dir; shards are fetched there on first
        touch (``fetcher`` pluggable for object stores).
      transform: ``(image_ndarray, np.random.Generator) -> image`` applied
        per item with epoch-aware rng (call :meth:`set_epoch` each epoch).
      image_key/label_key: column names (reference uses image/label).
      keep_decoded_shards: small LRU of fully-read shard bytes.
    """

    def __init__(
        self,
        remote: str,
        local_cache: str | None = None,
        transform: Callable | None = None,
        image_key: str = "image",
        label_key: str = "label",
        keep_decoded_shards: int = 2,
        fetcher: Callable[[str, str], None] = _default_fetcher,
        rng_seed: int = 0,
        decode_min_hw: tuple | None = None,
    ):
        self.remote = remote
        # normalized so the evict-on-corruption guard's prefix compare
        # can't be defeated by a trailing slash
        self.local_cache = (
            os.path.normpath(local_cache) if local_cache is not None else None
        )
        local_cache = self.local_cache
        self.transform = transform
        self.image_key = image_key
        self.label_key = label_key
        self.fetcher = fetcher
        self.rng_seed = rng_seed
        #: fused decode-at-scale hint for the image column (jpeg/png
        #: encodings; jpeg decodes at the covering M/8 DCT scale) — see
        #: ``streaming._dec_image``.  Pair with a Resize finisher.
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
                # same per-attempt tmp + cleanup discipline as shard
                # fetches: concurrent constructors over one cache must not
                # collide, and a failed fetch must not orphan a .tmp
                tmp = (f"{local_index}.{os.getpid()}"
                       f".{threading.get_ident()}.tmp")
                try:
                    fetcher(index_path, tmp)
                except BaseException:
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
                    if not os.path.exists(local_index):  # racing winner?
                        raise
                else:
                    os.replace(tmp, local_index)
            index_path = local_index
        with open(index_path) as f:
            self.index = json.load(f)
        version = self.index.get("version")
        if version != 2:
            raise ValueError(f"unsupported MDS index version {version!r} (want 2)")
        self.shards = [_Shard(e, self) for e in self.index["shards"]]
        for e in self.index["shards"]:
            if e.get("format", "mds") != "mds":
                raise ValueError(f"unsupported shard format {e.get('format')!r}")
        self._starts = np.cumsum([0] + [s.samples for s in self.shards])
        self._lock = threading.Lock()
        self._lru: list[int] = []
        self._lru_cap = max(1, keep_decoded_shards)
        self._fetch_errors: dict[str, str] = {}

    # -- io -----------------------------------------------------------------
    def _local_path(self, basename: str) -> str | None:
        """Fetch-or-find ``basename``; None when absent at the source too."""
        remote_path = os.path.join(self.remote, basename)
        if self.local_cache is None:
            return remote_path if os.path.exists(remote_path) else None
        local = os.path.join(self.local_cache, basename)
        if os.path.exists(local):
            return local
        # always *attempt* the fetch: ``remote`` may be an object-store URI
        # a custom fetcher understands but os.path.exists never will; a
        # failed fetch means "absent here" and the caller falls back to the
        # sibling file — but the error is RECORDED so a final
        # FileNotFoundError can surface the real cause (auth failure vs
        # genuinely missing).  The tmp name is unique per ATTEMPT (pid AND
        # thread id): the load path is deliberately unlocked, so two thread
        # workers missing the same shard must not collide on one tmp file.
        tmp = f"{local}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            self.fetcher(remote_path, tmp)
        except BaseException as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            if not isinstance(e, Exception):
                raise  # KeyboardInterrupt/SystemExit: clean up, propagate
            with self._lock:
                self._fetch_errors[basename] = repr(e)
            # a racing worker may have installed the file while our
            # duplicate fetch failed (e.g. object-store 429): the shard
            # being present trumps our fetch error
            return local if os.path.exists(local) else None
        with self._lock:
            self._fetch_errors.pop(basename, None)
        os.replace(tmp, local)  # atomic: a racing winner's file is complete
        return local

    @staticmethod
    def _check_hash(info: dict, data: bytes) -> None:
        """Verify the entry's recorded sha256 when present (the format's
        optional ``hashes`` field); zstd frames carry no content checksum
        by default, so this is the only mid-stream corruption detector."""
        want = (info.get("hashes") or {}).get("sha256")
        if want is not None:
            got = hashlib.sha256(data).hexdigest()
            if got != want:
                raise IOError(
                    f"shard {info['basename']}: sha256 {got} != "
                    f"index.json's {want}"
                )

    def _shard_bytes(self, entry: dict, _retry: bool = True) -> bytes:
        """Raw (decompressed) shard bytes.  A compressed volume normally
        ships ONLY ``zip_data`` (MDSWriter's layout), so that file is
        probed first — probing raw first would pay a guaranteed failed
        remote fetch on every shard (re)load; an uncompressed or
        keep-raw volume falls through to ``raw_data``.  A verification
        failure (length/sha256) evicts the cached copy — a corrupted
        download must not poison the cache forever — and retries the
        fetch once before surfacing the error."""
        raw_info = entry["raw_data"]
        zip_info = entry.get("zip_data")
        algo = (entry.get("compression") or "").split(":")[0]
        # a zip file under an unsupported codec is never a candidate — a
        # keep-raw volume (raw sibling present) must still be readable
        zip_usable = bool(zip_info) and algo == "zstd"
        candidates = ([("zip", zip_info)] if zip_usable else []) + [
            ("raw", raw_info)
        ]
        kind = path = None
        for kind, info in candidates:
            path = self._local_path(info["basename"])
            if path is not None:
                break
        if path is None:
            names = " nor ".join(i["basename"] for _, i in candidates)
            with self._lock:
                snapshot = dict(self._fetch_errors)
            errors = {
                b: e for b, e in snapshot.items()
                if any(b == i["basename"] for _, i in candidates)
            }
            detail = f"; fetch errors: {errors}" if errors else ""
            if zip_info and not zip_usable:
                detail += (
                    f"; zip_data exists but its compression {algo!r} is "
                    "unsupported (only zstd)"
                )
            raise FileNotFoundError(
                f"neither {names} present under {self.remote}{detail}"
            )
        with open(path, "rb") as f:
            data = f.read()
        try:
            if kind == "zip":
                from tpuframe_torch.data.streaming import _zstd_decompress

                self._check_hash(zip_info, data)
                data = _zstd_decompress(data, int(raw_info["bytes"]))
            expected = int(raw_info["bytes"])
            if len(data) != expected:
                raise IOError(
                    f"shard {raw_info['basename']}: {len(data)} bytes != "
                    f"index.json's {expected}"
                )
            if kind == "raw":
                # when kind == "zip" the download was already verified via
                # zip_data's hash and decompression is deterministic —
                # re-hashing the decompressed bytes would double the
                # per-reload hashing for nothing
                self._check_hash(raw_info, data)
            n = struct.unpack_from("<I", data, 0)[0]
            if n != int(entry["samples"]):
                raise IOError(
                    f"MDS shard {raw_info['basename']}: header says {n} "
                    f"samples, index.json says {entry['samples']}"
                )
        except Exception:
            # IOError (length/hash/count) OR a decompressor error on a
            # hash-less volume: either way this cached copy is bad
            if self.local_cache is not None and path.startswith(
                self.local_cache + os.sep
            ):
                try:
                    os.remove(path)  # don't let a bad download stick
                except OSError:
                    pass
                if _retry:
                    return self._shard_bytes(entry, _retry=False)
            raise
        return data

    # -- dataset protocol ---------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return int(self._starts[-1])

    def sample(self, idx: int) -> dict:
        """Full decoded sample dict at global index."""
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        si = int(np.searchsorted(self._starts, idx, side="right") - 1)
        shard = self.shards[si]
        entry = shard.entry
        # DataLoader's thread workers call this concurrently.  The lock
        # guards ONLY the cache slot + LRU bookkeeping; the expensive load
        # (fetch/decompress/hash) and decode run unlocked.  Two threads may
        # race-load the same shard once (harmless, last write wins); the
        # local ``cached`` reference keeps the bytes alive even if another
        # thread evicts the slot mid-slice.
        with self._lock:
            cached = shard._data
        if cached is None:
            cached = shard.read()
        with self._lock:
            shard._data = cached
            # bound memory: keep only the most recently touched shards' bytes
            if si in self._lru:
                self._lru.remove(si)
            self._lru.append(si)
            while len(self._lru) > self._lru_cap:
                self.shards[self._lru.pop(0)]._data = None
        raw, offsets = cached
        i = idx - int(self._starts[si])
        data = raw[int(offsets[i]) : int(offsets[i + 1])]
        return _decode_sample(
            data,
            entry["column_names"],
            entry["column_encodings"],
            entry["column_sizes"],
            min_hw_cols=(
                {self.image_key: self.decode_min_hw}
                if self.decode_min_hw is not None else None
            ),
        )

    def __getitem__(self, idx: int):
        rec = self.sample(int(idx))
        image = rec[self.image_key]
        if self.transform is not None:
            image = self.transform(
                image, item_rng(self.rng_seed, self.epoch, int(idx))
            )
        return np.asarray(image), int(rec[self.label_key])

    def __getstate__(self):
        # handles, not bytes, cross the process boundary
        state = self.__dict__.copy()
        state["shards"] = None
        state["_lru"] = []
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.shards = [_Shard(e, self) for e in self.index["shards"]]
        self._lock = threading.Lock()


def mds_to_tfs(
    mds_dir: str,
    out_dir: str,
    columns: Mapping[str, str] | None = None,
    shard_size_limit: int = 1 << 26,
    compression: str = "zstd",
) -> int:
    """One-shot conversion of an MDS directory into the TFS format.

    Column codecs are inferred (pil/jpeg/png -> ``png`` re-encode, ints ->
    ``int``, floats -> ``float``, str/bytes pass through) unless given
    explicitly.  Returns the number of samples written.
    """
    from tpuframe_torch.data.streaming import ShardWriter

    src = MDSDataset(mds_dir)
    entry = src.index["shards"][0]
    if columns is None:
        inferred = {}
        for name, enc in zip(entry["column_names"], entry["column_encodings"]):
            if enc in ("pil", "jpeg", "png", "jpeg_array"):
                inferred[name] = "png"
            elif enc in _SCALARS and _SCALARS[enc][1] in "iu":
                inferred[name] = "int"
            elif enc in _SCALARS:
                inferred[name] = "float"
            elif enc == "str":
                inferred[name] = "str"
            else:
                inferred[name] = "bytes"
        columns = inferred
    n = 0
    with ShardWriter(
        out_dir,
        columns=columns,
        shard_size_limit=shard_size_limit,
        compression=compression,
    ) as w:
        for i in range(len(src)):
            rec = src.sample(i)
            w.write({k: rec[k] for k in columns})
            n += 1
    return n
