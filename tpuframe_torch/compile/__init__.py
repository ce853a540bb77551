"""Compile spine: the persistent compile cache, precompile, and
recompile-proof step shapes.

Port of ``tpuframe/compile/``.  Two modules:

- ``compile.cache``: Inductor's FX-graph and AOTAutograd caches and
  Triton's behind the ``TPUFRAME_COMPILE_CACHE`` knob, size-capped keep-K
  eviction, and listeners that surface every compile (hits, misses, real
  backend compiles) in telemetry.
- ``compile.precompile``: batch signatures derived from the loader spec,
  the step's model region compiled by Inductor with the hand kernels as
  ``tpuframe::`` custom ops, the whole step captured as a CUDA graph on
  the card (the Trainer overlaps it with loader spin-up on a background
  thread), and the :class:`~tpuframe_torch.compile.precompile.ShapeGuard`.

``compile.cache`` imports no torch (the remote launcher reads its knob
list); the names of ``compile.precompile`` load lazily for the same
reason, as in the JAX package.
"""

from tpuframe_torch.compile.cache import (
    COMPILE_ENV_VARS,
    cache_dir_from_env,
    cache_info,
    compile_label,
    disable,
    enable,
    enable_from_env,
    enabled_dir,
    trim,
)

_LAZY = {
    "ShapeGuard": "tpuframe_torch.compile.precompile",
    "abstract_state": "tpuframe_torch.compile.precompile",
    "batch_signature": "tpuframe_torch.compile.precompile",
    "format_signature": "tpuframe_torch.compile.precompile",
    "loader_batch_template": "tpuframe_torch.compile.precompile",
    "precompile_call": "tpuframe_torch.compile.precompile",
    "precompile_step": "tpuframe_torch.compile.precompile",
}

__all__ = [
    "COMPILE_ENV_VARS",
    "ShapeGuard",
    "abstract_state",
    "batch_signature",
    "cache_dir_from_env",
    "cache_info",
    "compile_label",
    "disable",
    "enable",
    "enable_from_env",
    "enabled_dir",
    "format_signature",
    "loader_batch_template",
    "precompile_call",
    "precompile_step",
    "trim",
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'tpuframe_torch.compile' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
