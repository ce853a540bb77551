"""Composer-style time strings: ``"2ep"``, ``"500ba"``, ``"1000sp"``.

The port's own copy of ``tpuframe/train/duration.py``.

The reference passes ``max_duration="2ep"`` to Composer's Trainer
(`03_composer/01_cifar_composer_resnet.ipynb:cell-16`).
tpuframe keeps the same grammar, reduced to the units that make sense here:
epochs (ep), batches/steps (ba), samples (sp).
"""

from __future__ import annotations

import dataclasses
import re

_PATTERN = re.compile(r"^\s*(\d+)\s*(ep|ba|sp)\s*$")


@dataclasses.dataclass(frozen=True)
class Duration:
    value: int
    unit: str  # "ep" | "ba" | "sp"

    @classmethod
    def parse(cls, spec: "str | int | Duration") -> "Duration":
        if isinstance(spec, Duration):
            return spec
        if isinstance(spec, int):
            return cls(spec, "ep")
        m = _PATTERN.match(str(spec))
        if not m:
            raise ValueError(
                f"bad duration {spec!r}; expected '<N>ep' | '<N>ba' | '<N>sp' "
                "(e.g. '2ep', '500ba') or an int epoch count"
            )
        return cls(int(m.group(1)), m.group(2))

    def reached(self, *, epoch: int, batch: int, samples: int) -> bool:
        current = {"ep": epoch, "ba": batch, "sp": samples}[self.unit]
        return current >= self.value

    def __str__(self) -> str:
        return f"{self.value}{self.unit}"
