"""Batch-shape contract of the serve path: signatures and the loud miss.

The port's copy of ``batch_signature``, ``format_signature`` and
:class:`ShapeGuard` from ``tpuframe/compile/precompile.py``.  PyTorch runs
eagerly, so there is no AOT compile to warm; the serve engine's
``start()`` runs each bucket once instead, and the guard makes any batch
shape outside the bucket set one ``compile/recompile`` event.
"""

from __future__ import annotations

from tpuframe_torch.track.telemetry import get_telemetry

__all__ = ["ShapeGuard", "batch_signature", "format_signature"]


def _dtype_name(dtype) -> str:
    """``uint8`` for ``torch.uint8`` and for numpy's ``uint8`` alike."""
    return str(getattr(dtype, "name", dtype)).removeprefix("torch.")


def batch_signature(batch) -> tuple:
    """Hashable identity of a batch dict of tensors or numpy arrays: sorted
    (key, shape, dtype) triples."""
    return tuple(
        sorted(
            (k, tuple(int(s) for s in v.shape), _dtype_name(v.dtype))
            for k, v in batch.items()
        )
    )


def format_signature(sig: tuple) -> str:
    """``image:(32,28,28,1):float32`` — the grep-able form events carry."""
    return " ".join(
        f"{k}:({','.join(map(str, shape))}):{dtype}" for k, shape, dtype in sig
    )


class ShapeGuard:
    """Expected-signature set + the loud runtime-miss event.

    Disarmed (no :meth:`expect` yet) it only records.  Armed, any signature
    outside the expected set emits ONE ``compile/recompile`` event naming
    it, then adopts it.
    """

    def __init__(self, telemetry=None):
        self._telemetry = telemetry
        self._known: set[tuple] = set()
        self.armed = False

    def _tele(self):
        return self._telemetry if self._telemetry is not None else get_telemetry()

    def expect(self, kind: str, sig: tuple) -> None:
        """Register an expected signature; arms the guard."""
        self._known.add((kind, sig))
        self.armed = True

    def check(self, kind: str, sig: tuple) -> bool:
        """True when ``sig`` was expected; False (plus one loud event if
        armed) on a miss."""
        key = (kind, sig)
        if key in self._known:
            return True
        self._known.add(key)
        if self.armed:
            tele = self._tele()
            tele.registry.counter("compile/recompiles").inc()
            tele.event(
                "compile/recompile",
                step_kind=kind,
                signature=format_signature(sig),
            )
        return False
