"""Reusable host batch buffers for the serve path: :class:`BatchBufferPool`.

The port's copy of the pool in ``tpuframe/data/loader.py``, for image
batches alone (labels and validity masks come with the training slice's
``DataLoader``).  Buffers are CPU tensors, pinned when the pool feeds a
CUDA device, so the host-to-device copy can run with ``non_blocking=True``.
A lease handed back with the CUDA event recorded after its copy re-enters
the pool at once, and is handed out again only once that event has
completed: the wait is on that one copy, never a device-wide sync.

The JAX pool's aliasing guards are not needed here: ``Tensor.to("cuda")``
always copies, and a CPU consumer reads the buffer synchronously before it
releases the lease.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from tpuframe_torch.track.telemetry import get_telemetry

__all__ = ["BatchBufferPool"]


class _BatchLease:
    """One pooled batch buffer, outstanding until recycled.  ``images`` is
    a CPU tensor; ``images_np`` a numpy view of it for host-side
    assembly."""

    __slots__ = ("images", "images_np", "ready")

    def __init__(self, images: torch.Tensor):
        self.images = images
        self.images_np = images.numpy()
        # CUDA event of the last copy out of this buffer (None: no copy
        # pending)
        self.ready = None


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

    def acquire(self, batch: int, item_shape: tuple, dtype) -> _BatchLease:
        """A free pooled lease (after its last copy completed), or a freshly
        allocated one (counted)."""
        shape = (int(batch),) + tuple(int(s) for s in item_shape)
        spec = (shape, np.dtype(dtype))
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
        torch_dtype = torch.from_numpy(np.empty(0, spec[1])).dtype
        return _BatchLease(torch.empty(shape, dtype=torch_dtype,
                                       pin_memory=self.pin_memory))

    def release(self, lease: _BatchLease, copy_done=None) -> bool:
        """Return ``lease`` to the pool.  ``copy_done`` is the CUDA event
        recorded after the last host-to-device copy out of it; the lease is
        not handed out again before that event completes."""
        lease.ready = copy_done
        with self._lock:
            if ((tuple(lease.images.shape), lease.images_np.dtype) == self._spec
                    and len(self._free) < self.size):
                self._free.append(lease)
                self._recycled.inc()
                return True
        return False
