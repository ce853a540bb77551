"""Batch loading: reusable host buffers, the :class:`DataLoader`, and the
:class:`DevicePrefetcher` that copies batches to the card.

Port of ``tpuframe/data/loader.py``:

- :class:`BatchBufferPool`: preallocated batch buffers (images, labels and
  the validity mask), pinned when they feed a CUDA device, so the copy to
  the card runs with ``non_blocking=True``.  A lease handed back with the
  CUDA event of its copy is handed out again only once that event has
  completed: the wait is on that one copy, never a device-wide sync.
- :class:`DataLoader`: the JAX loader's batch sequence, byte for byte —
  the permutation ``default_rng(seed * 1_000_003 + epoch).permutation(n)``,
  ``drop_last`` or a padded last batch with its ``valid`` mask,
  ``transfer_dtype``, ``set_epoch`` / ``state_dict`` / ``load_state_dict``
  resume, thread or process workers, the bad-sample quarantine, and the
  per-process shard of a multi-process run (every ``process_count``-th
  index from ``process_index``, the last share padded by wrapping around,
  with the pad flagged in the ``valid`` mask).  Process workers are one
  persistent pool (``fork`` by default, as in JAX) that fetches samples
  only: they return numpy samples and never touch CUDA; the parent writes
  them into the pinned buffers.
- :class:`DevicePrefetcher`: a background thread copies each batch from
  the pooled buffers on a side CUDA stream; the consuming stream waits on
  the copy's event, and every batch tensor is marked with
  ``record_stream`` on the consumer, so the allocator cannot hand its
  memory to the next copy while a step still reads it.  Leases go back to
  the pool in the order they were yielded (FIFO).

The JAX pool's aliasing guards are not needed here: ``Tensor.to("cuda")``
always copies, and on the CPU the prefetcher copies before it releases a
lease.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator

import numpy as np
import torch

from tpuframe_torch.core import runtime as rt
from tpuframe_torch.core.runtime import resolve_device
from tpuframe_torch.fault.health import _env_int
from tpuframe_torch.track.telemetry import get_telemetry

__all__ = ["BatchBufferPool", "DataLoader", "DevicePrefetcher"]


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class _BatchLease:
    """One pooled batch's buffers, outstanding until recycled.  ``images``,
    ``labels`` and ``valid`` are CPU tensors (labels and valid may be
    None); the ``*_np`` attributes are numpy views of them."""

    __slots__ = ("images", "images_np", "labels", "labels_np", "valid", "valid_np", "ready")

    def __init__(self, images: torch.Tensor, labels: torch.Tensor | None = None,
                 valid: torch.Tensor | None = None):
        self.images, self.images_np = images, images.numpy()
        self.labels, self.labels_np = labels, None if labels is None else labels.numpy()
        self.valid, self.valid_np = valid, None if valid is None else valid.numpy()
        # CUDA event of the last copy out of this lease (None: no copy pending)
        self.ready = None

    def spec(self) -> tuple:
        lab = None if self.labels is None else (tuple(self.labels.shape[1:]), self.labels_np.dtype)
        return (tuple(self.images.shape), self.images_np.dtype, lab, self.valid is not None)


class BatchBufferPool:
    """Small pool of preallocated, reusable batch buffers.

    ``pin_memory=True`` pins every buffer (needs CUDA).  Consumers that
    never release simply cause fresh allocations, counted by
    ``data/ring_allocs`` (steady-state zero when recycling works).
    """

    def __init__(self, size: int = 4, *, pin_memory: bool = False):
        self.size = max(1, int(size))
        self.pin_memory = bool(pin_memory)
        self._spec: tuple | None = None
        self._free: collections.deque[_BatchLease] = collections.deque()
        self._lock = threading.Lock()
        reg = get_telemetry().registry
        self._allocs = reg.counter("data/ring_allocs")
        self._recycled = reg.counter("data/ring_recycled")

    def acquire(self, batch: int, item_shape: tuple, dtype, *, with_valid: bool = False,
                label_shape: tuple | None = None, label_dtype=np.int32) -> _BatchLease:
        """A free pooled lease (after its last copy completed), or a freshly
        allocated one (counted).  ``label_shape`` None means no label buffer
        (the serve path); ``()`` is one label per sample."""
        shape = (int(batch),) + tuple(int(s) for s in item_shape)
        lab = None if label_shape is None else (tuple(label_shape), np.dtype(label_dtype))
        spec = (shape, np.dtype(dtype), lab, bool(with_valid))
        lease = None
        with self._lock:
            if spec != self._spec:  # shape/dtype change: old buffers useless
                self._spec = spec
                self._free.clear()
            if self._free:
                lease = self._free.popleft()
        if lease is not None:
            if lease.ready is not None:
                lease.ready.synchronize()  # that copy only
                lease.ready = None
            return lease
        self._allocs.inc()

        def alloc(shp, dt):
            return torch.empty(shp, dtype=_torch_dtype(dt), pin_memory=self.pin_memory)

        return _BatchLease(
            alloc(shape, dtype),
            None if lab is None else alloc((shape[0],) + lab[0], lab[1]),
            alloc((shape[0],), np.bool_) if with_valid else None,
        )

    def release(self, lease: _BatchLease, copy_done=None) -> bool:
        """Return ``lease`` to the pool.  ``copy_done`` is the CUDA event
        recorded after the last host-to-device copy out of it; the lease is
        not handed out again before that event completes."""
        lease.ready = copy_done
        with self._lock:
            if lease.spec() == self._spec and len(self._free) < self.size:
                self._free.append(lease)
                self._recycled.inc()
                return True
        return False


#: Sample-fetch failures that read as a bad record rather than a bug
_SKIPPABLE_SAMPLE_ERRORS = (ValueError, OSError, RuntimeError)


class _BadSample:
    """What a fetch returns instead of raising for a corrupt sample."""

    def __init__(self, index: int, error: str):
        self.index = index
        self.error = error


# Process workers inherit the dataset through fork (copy-on-write: only the
# returned samples are pickled).  A module global is the one channel that
# fork-inherited state can ride.
_WORKER_DATASET = None
_WORKER_EPOCH = None


def _pool_init(dataset) -> None:
    global _WORKER_DATASET, _WORKER_EPOCH
    _WORKER_DATASET = dataset
    _WORKER_EPOCH = None


def _pool_get(args):
    """One sample in a worker.  The epoch rides along with every request:
    the worker's copy of the dataset never sees the parent's ``set_epoch``,
    and the epoch keys per-item augmentation."""
    global _WORKER_EPOCH
    idx, epoch = args
    if epoch != _WORKER_EPOCH:
        if hasattr(_WORKER_DATASET, "set_epoch"):
            _WORKER_DATASET.set_epoch(epoch)
        _WORKER_EPOCH = epoch
    try:
        return _WORKER_DATASET[int(idx)]
    except _SKIPPABLE_SAMPLE_ERRORS as e:
        return _BadSample(int(idx), f"{type(e).__name__}: {e}")


class DataLoader:
    """Iterates this process's ``(images, labels[, valid])`` numpy batches.

    Args:
      dataset: map-style dataset (``__len__``/``__getitem__`` -> (img, label)).
      batch_size: the global batch size; each process yields
        ``batch_size // process_count`` rows (``local_batch_size``).
      shuffle: reshuffle per epoch from (seed, epoch).
      drop_last: drop the trailing ragged batch (train default).  When
        False, the last batch is padded to full size by cycling its samples
        and a boolean ``valid`` mask is yielded as third element.
      num_workers: worker pool size for item fetch (0 = inline); None reads
        ``TPUFRAME_LOADER_WORKERS`` (else 0).
      worker_mode: ``"thread"``, or ``"process"``: a persistent process pool
        made at construction (from the constructing thread), reused across
        epochs and ended by :meth:`close`; the workers fetch numpy samples
        only.
      mp_context: the process pool's start method (``"fork"``, as in JAX).
      process_index / process_count: this process's shard; None reads the
        runtime's data shard (``core.runtime.data_shard``: the process
        index and count where the mesh has only data axes; the ranks along
        ``pipe`` and ``model`` read the same rows).
      transfer_dtype: dtype of the batch buffers — what crosses to the card
        (``"uint8"`` pairs with ``Trainer(normalize=...)``); None reads
        ``TPUFRAME_LOADER_TRANSFER_DTYPE``, else the first sample's dtype.
        Samples are cast on write with ``casting="same_kind"``.
      ring_buffers: size of the buffer pool; None reads
        ``TPUFRAME_LOADER_RING_BUFFERS`` (else 4).  The buffers are pinned
        when CUDA is available.

    Batches are numpy views of pooled buffers, valid until the consumer
    hands them back with :meth:`release_oldest` (the
    :class:`DevicePrefetcher` does, after its copy).
    """

    def __init__(self, dataset: Any, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, num_workers: int | None = None,
                 worker_mode: str = "thread", mp_context: str = "fork",
                 process_index: int | None = None, process_count: int | None = None,
                 transfer_dtype: str | None = None, ring_buffers: int | None = None):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        multiprocessing.get_context(mp_context)  # fail at init, not mid-train
        if num_workers is None:
            num_workers = max(0, _env_int("TPUFRAME_LOADER_WORKERS", 0))
        if ring_buffers is None:
            ring_buffers = max(2, _env_int("TPUFRAME_LOADER_RING_BUFFERS", 4))
        if transfer_dtype is None:
            env_dtype = os.environ.get("TPUFRAME_LOADER_TRANSFER_DTYPE", "").strip().lower()
            if env_dtype in ("uint8", "float32"):
                transfer_dtype = env_dtype
        self.dataset = dataset
        self.global_batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.mp_context = mp_context
        self.transfer_dtype = np.dtype(transfer_dtype) if transfer_dtype is not None else None
        shard = rt.data_shard()
        self.process_index = shard[0] if process_index is None else process_index
        self.process_count = shard[1] if process_count is None else process_count
        if self.global_batch_size % self.process_count:
            raise ValueError(f"global batch size {batch_size} not divisible by "
                             f"{self.process_count} processes")
        self.local_batch_size = self.global_batch_size // self.process_count
        self._pool = BatchBufferPool(ring_buffers, pin_memory=torch.cuda.is_available())
        # FIFO of yielded-but-unreleased leases, released in yield order;
        # bounded, and a dropped lease swallows one future release so the
        # pairing never shifts onto a batch the consumer still holds
        self._outstanding: collections.deque = collections.deque()
        self._outstanding_cap = max(8, 4 * ring_buffers)
        self._dropped_leases = 0
        self._lease_lock = threading.Lock()
        self._iter_gen = 0
        # (epoch, batches_yielded) as one tuple: read from the prefetcher's
        # thread while set_epoch may run on the main thread
        self._pos = (0, 0)
        self._resume_offset = 0
        self._proc_pool = None
        if num_workers and worker_mode == "process":
            # fork now, from the constructing thread: a fork from the
            # prefetcher's thread while others hold locks can deadlock
            self._process_pool()

    def _process_pool(self):
        """The persistent worker pool, made once and reused across epochs."""
        if self._proc_pool is None:
            ctx = multiprocessing.get_context(self.mp_context)
            self._proc_pool = ctx.Pool(self.num_workers, initializer=_pool_init,
                                       initargs=(self.dataset,))
        return self._proc_pool

    def close(self) -> None:
        """End the process pool (nothing to do for thread workers)."""
        if self._proc_pool is not None:
            self._proc_pool.terminate()
            self._proc_pool.join()
            self._proc_pool = None

    def __del__(self):  # a pool must not outlive its loader
        try:
            self.close()
        except Exception:
            pass

    def set_epoch(self, epoch: int) -> None:
        """Change the shuffle order and rewind the position."""
        self._pos = (int(epoch), 0)
        self._resume_offset = 0
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def _epoch(self) -> int:
        return self._pos[0]

    @property
    def _batches_yielded(self) -> int:
        """Within the current epoch (the resume point)."""
        return self._pos[1]

    def state_dict(self) -> dict:
        """Mid-epoch resume point plus the iteration-order fingerprint."""
        epoch, batches = self._pos
        return {
            "epoch": epoch,
            "batches_yielded": batches,
            "global_batch_size": self.global_batch_size,
            "process_count": self.process_count,
            "dataset_len": len(self.dataset),
            "seed": self.seed,
            "shuffle": self.shuffle,
            "drop_last": self.drop_last,
        }

    def load_state_dict(self, state: dict) -> None:
        """Resume from :meth:`state_dict`: the next iteration skips the
        consumed batches by index arithmetic.  Raises ``ValueError`` when
        the fingerprint does not match this loader."""
        mine = self.state_dict()
        mismatched = {
            k: (state.get(k), mine[k])
            for k in ("global_batch_size", "process_count", "dataset_len", "seed",
                      "shuffle", "drop_last")
            if k in state and state[k] != mine[k]
        }
        if mismatched:
            raise ValueError(
                "loader state_dict fingerprint mismatch (saved != current): "
                + ", ".join(f"{k}: {a!r} != {b!r}" for k, (a, b) in mismatched.items()))
        offset = int(state["batches_yielded"])
        if not 0 <= offset <= len(self):
            raise ValueError(f"batches_yielded {offset} outside [0, {len(self)}]")
        self.set_epoch(int(state["epoch"]))
        self._resume_offset = offset
        self._pos = (int(state["epoch"]), offset)

    def _fetch_one(self, idx: int):
        try:
            return self.dataset[idx]
        except _SKIPPABLE_SAMPLE_ERRORS as e:
            return _BadSample(idx, f"{type(e).__name__}: {e}")

    def release_oldest(self, copy_done=None) -> bool:
        """Recycle the oldest outstanding batch's buffers (FIFO), once its
        copy (``copy_done``, a CUDA event, or None) has completed."""
        with self._lease_lock:
            if self._dropped_leases:
                self._dropped_leases -= 1
                return False
            try:
                gen, lease = self._outstanding.popleft()
            except IndexError:
                return False
        if gen != self._iter_gen:  # a lease of an abandoned iteration
            return False
        return self._pool.release(lease, copy_done)

    def _per_process_count(self) -> int:
        n = len(self.dataset)
        if not self.drop_last and n % self.process_count:
            return n // self.process_count + 1
        return n // self.process_count

    def _indices(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """This process's (indices, genuine) for ``epoch``: genuine=False
        marks the wrap-around duplicates that equalize the processes'
        shares, so eval never counts them twice."""
        n = len(self.dataset)
        order = (np.random.default_rng(self.seed * 1_000_003 + epoch).permutation(n)
                 if self.shuffle else np.arange(n))
        genuine = np.ones(n, bool)
        total = self._per_process_count() * self.process_count
        if total > n:
            # np.resize repeats cyclically, also past the dataset's size
            order = np.resize(order, total)
            genuine = np.zeros(total, bool)
            genuine[:n] = True
        else:
            order, genuine = order[:total], genuine[:total]
        sl = slice(self.process_index, None, self.process_count)
        return order[sl], genuine[sl]

    def __len__(self) -> int:
        per_proc = self._per_process_count()
        if self.drop_last:
            return per_proc // self.local_batch_size
        return -(-per_proc // self.local_batch_size)

    def __iter__(self) -> Iterator[tuple]:
        self._iter_gen += 1
        return self._iter_batches(self._iter_gen)

    def _iter_batches(self, gen: int) -> Iterator[tuple]:
        epoch = self._epoch
        indices, genuine = self._indices(epoch)
        nb_full = len(indices) // self.local_batch_size
        tail = len(indices) % self.local_batch_size
        pool = None
        if self.num_workers and self.worker_mode == "process":
            ppool = self._process_pool()
            # chunked map: one round trip per chunk of a worker, not per item
            chunk = max(1, self.local_batch_size // (self.num_workers * 2))
            fetch = lambda idxs: ppool.map(  # noqa: E731
                _pool_get, [(int(i), epoch) for i in idxs], chunksize=chunk)
        elif self.num_workers:
            pool = ThreadPoolExecutor(self.num_workers)
            fetch = lambda idxs: list(pool.map(lambda i: self._fetch_one(int(i)), idxs))  # noqa: E731
        else:
            fetch = lambda idxs: [self._fetch_one(int(i)) for i in idxs]  # noqa: E731
        start = min(self._resume_offset, len(self))
        self._resume_offset = 0
        self._pos = (epoch, start)
        tele = get_telemetry()
        max_bad = _env_int("TPUFRAME_MAX_BAD_SAMPLES", 8)
        bad_count = 0

        def screen(items: list, gen_rows, batch_idx: int) -> tuple:
            """Drop bad samples (and their flags), counted, up to the cap."""
            nonlocal bad_count
            bad = [it for it in items if isinstance(it, _BadSample)]
            if not bad:
                return items, gen_rows
            for b in bad:
                bad_count += 1
                tele.registry.counter("data/bad_samples").inc()
                tele.event("data/bad_sample", index=b.index, error=b.error[:300],
                           batch=batch_idx)
            if bad_count > max_bad:
                raise RuntimeError(
                    f"{bad_count} bad sample(s) this epoch exceed "
                    f"TPUFRAME_MAX_BAD_SAMPLES={max_bad}; the dataset is "
                    f"poisoned beyond skip-and-count (last: sample "
                    f"{bad[-1].index}: {bad[-1].error})")
            good = [(it, bool(g)) for it, g in zip(items, gen_rows)
                    if not isinstance(it, _BadSample)]
            if not good:
                raise RuntimeError(
                    f"every sample in batch {batch_idx} was bad "
                    f"(last: sample {bad[-1].index}: {bad[-1].error}); "
                    "nothing left to assemble")
            return [it for it, _ in good], np.asarray([g for _, g in good], bool)

        def assemble(items, gen_rows) -> tuple:
            """Write the samples into a leased buffer; pad the ragged tail by
            cycling the samples."""
            n = len(items)
            first = np.asarray(items[0][0])
            first_lb = np.asarray(items[0][1])
            lease = self._pool.acquire(
                self.local_batch_size, first.shape, self.transfer_dtype or first.dtype,
                with_valid=not self.drop_last,
                label_shape=first_lb.shape, label_dtype=first_lb.dtype)
            images, labels = lease.images_np, lease.labels_np
            for i, (im, lb) in enumerate(items):
                np.copyto(images[i], im, casting="same_kind")
                labels[i] = lb
            for i in range(n, self.local_batch_size):
                src = items[i % n]
                np.copyto(images[i], src[0], casting="same_kind")
                labels[i] = src[1]
            if lease.valid is None:
                out = (images, labels)
            else:
                lease.valid_np[:n] = gen_rows
                lease.valid_np[n:] = False
                out = (images, labels, lease.valid_np)
            with self._lease_lock:
                self._outstanding.append((gen, lease))
                if len(self._outstanding) > self._outstanding_cap:
                    self._outstanding.popleft()
                    self._dropped_leases += 1
            return out

        try:
            for b in range(start, nb_full):
                sl = slice(b * self.local_batch_size, (b + 1) * self.local_batch_size)
                with tele.span("data/assemble", batch=b):
                    out = assemble(*screen(fetch(indices[sl]), genuine[sl], b))
                self._pos = (epoch, b + 1)  # before the yield: the consumer has it
                yield out
            if tail and not self.drop_last and start <= nb_full:
                sl = slice(nb_full * self.local_batch_size, None)
                with tele.span("data/assemble", batch=nb_full):
                    out = assemble(*screen(fetch(indices[sl]), genuine[sl], nb_full))
                self._pos = (epoch, nb_full + 1)
                yield out
        finally:
            if pool:
                pool.shutdown(wait=False)


class DevicePrefetcher:
    """Wrap a host-batch iterable into device tensors, ``depth`` in flight.

    Each host batch (a tuple or dict of numpy arrays) becomes the same
    structure of tensors on ``device`` (default ``cuda``).  A background
    thread copies batch k+1 on a side CUDA stream while the consumer's step
    runs on batch k; ``span/data/h2d`` times each copy to its completion.
    ``recycler`` (default: the iterable's ``release_oldest``) gets one
    release per batch after its copy; ``track_loader`` gives
    :meth:`state_dict` the position of the batch the consumer last
    received.
    """

    _DONE = object()

    def __init__(self, it: Any, depth: int = 2, device=None,
                 track_loader: DataLoader | None = None, recycler: Any = None):
        self.it = it
        self.device = resolve_device(device)
        self.depth = max(1, depth)
        if recycler is None and hasattr(it, "release_oldest"):
            recycler = it
        self.recycler = recycler
        self.track_loader = track_loader
        self._position = track_loader.state_dict() if track_loader is not None else None

    def state_dict(self) -> dict:
        """Resume point of the last batch the consumer received (needs
        ``track_loader=``)."""
        if self.track_loader is None:
            raise ValueError(
                "DevicePrefetcher was built without track_loader=; no resume position")
        return dict(self._position)

    def _map(self, batch, fn):
        if isinstance(batch, dict):
            return {k: fn(v) for k, v in batch.items()}
        return type(batch)(fn(v) for v in batch)

    def _put(self, batch, stream):
        """(device batch, CUDA event of its copy or None)."""
        if self.device.type == "cpu":  # a private copy: the lease is recycled next
            return self._map(batch, lambda x: torch.from_numpy(np.array(x))), None
        with torch.cuda.stream(stream):
            out = self._map(batch, lambda x: torch.from_numpy(np.asarray(x)).to(
                self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list[BaseException] = []
        stop = threading.Event()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            tele = get_telemetry()
            prefetched = tele.registry.counter("data/batches_prefetched")
            try:
                it = iter(self.it)
                n = 0
                while True:
                    with tele.span("data/prefetch_fetch", emit=False):
                        try:
                            batch = next(it)
                        except StopIteration:
                            break
                    snap = (self.track_loader.state_dict()
                            if self.track_loader is not None else None)
                    with tele.span("data/h2d", batch=n):
                        device_batch, done = self._put(batch, stream)
                        if done is not None:
                            done.synchronize()  # this copy only: the span times the transfer
                    if self.recycler is not None:
                        self.recycler.release_oldest(done)
                    prefetched.inc()
                    n += 1
                    if not put((device_batch, done, snap)):
                        return  # consumer went away
            except BaseException as e:  # propagate to the consumer
                err.append(e)
            finally:
                put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if err:
                        raise err[0]
                    return
                batch, done, snap = item
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    self._map(batch, lambda x: x.record_stream(consumer))
                if snap is not None:
                    self._position = snap
                yield batch
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)
