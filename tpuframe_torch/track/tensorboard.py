"""TensorBoard event-file sink, with no tensorflow or tensorboard dependency.

The port's own copy of ``tpuframe/track/tensorboard.py`` (stdlib only):
the same records, byte for byte up to wall time and host name, and the
same event-file name pattern.  The reference's DeepSpeed base config asks
for TensorBoard output (``{"tensorboard": {"enabled": true,
"output_path": ..., "job_name": ...}}``).  This writes the real on-disk
format a stock TensorBoard reads:

- **TFRecord framing**: ``[len u64][masked crc32c(len)][payload]
  [masked crc32c(payload)]``
- **Event protobuf**, hand-encoded (the scalar subset is tiny): wall_time
  (field 1, double), step (field 2, varint), file_version (field 3) on
  the header record, summary (field 5) holding ``Summary.Value`` entries
  of tag (field 1) + simple_value (field 2, float).

Duck-types the Trainer's logger contract (``log_metrics(dict, step=)``,
``log_params``, ``flush``), so it drops into ``Trainer(loggers=[...])``
next to the MLflow logger.  :func:`from_deepspeed_config` wires the
reference's config block shape straight through.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Any, Mapping

__all__ = ["TensorBoardLogger", "from_deepspeed_config"]

# -- crc32c (Castagnoli), table-driven — zlib.crc32 is the wrong polynomial --

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding ------------------------------------------


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # proto int64 two's complement; also keeps a
    out = bytearray()        # negative input from looping forever
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(
    wall_time: float,
    step: int = 0,
    file_version: str | None = None,
    summary: bytes | None = None,
) -> bytes:
    out = _field_double(1, wall_time)
    if step:
        out += _field_varint(2, step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


def _scalar_summary(values: Mapping[str, float]) -> bytes:
    out = b""
    for tag, value in values.items():
        entry = _field_bytes(1, str(tag).encode()) + _field_float(2, float(value))
        out += _field_bytes(1, entry)
    return out


class TensorBoardLogger:
    """Scalar event writer; one ``events.out.tfevents.*`` file per run.

    >>> tb = TensorBoardLogger("./runs", job_name="cifar")
    >>> tb.log_metrics({"loss": 0.5, "acc": 0.9}, step=10)
    >>> tb.close()
    """

    def __init__(self, output_path: str, job_name: str = "tpuframe"):
        self.logdir = os.path.join(output_path, job_name)
        os.makedirs(self.logdir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            f".{os.getpid()}"
        )
        self._path = os.path.join(self.logdir, fname)
        self._f = open(self._path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    @property
    def path(self) -> str:
        return self._path

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    @staticmethod
    def _coerce(metrics: Mapping[str, Any]) -> dict[str, float]:
        """Anything float() accepts (numpy scalars and one-element tensors
        included) is a scalar; bools and non-numerics are skipped, like the
        MLflow logger's coercion."""
        out = {}
        for k, v in metrics.items():
            if isinstance(v, (bool, str)):
                continue
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                continue
        return out

    def log_metrics(self, metrics: Mapping[str, Any], step: int = 0) -> None:
        scalars = self._coerce(metrics)
        if scalars:
            self._record(
                _event(time.time(), step=int(step), summary=_scalar_summary(scalars))
            )
            # flush per call (one syscall per epoch/interval): a live
            # `tensorboard --logdir` must see curves mid-run, not at close
            self._f.flush()

    def log_params(self, params: Mapping[str, Any]) -> None:
        self.log_metrics(
            {f"params/{k}": v for k, v in self._coerce(params).items()}, step=0
        )

    def flush(self, status: str | None = None) -> None:
        self._f.flush()

    def finish(self, error: BaseException | None = None) -> None:
        self.close()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def from_deepspeed_config(cfg: Mapping[str, Any]) -> TensorBoardLogger | None:
    """Build a logger from the reference's DeepSpeed ``tensorboard`` block;
    None when absent/disabled."""
    tb = dict(cfg.get("tensorboard") or {})
    if not tb.get("enabled"):
        return None
    return TensorBoardLogger(
        tb.get("output_path", "./tensorboard"),
        job_name=tb.get("job_name", "tpuframe"),
    )
