"""Checkpointing: save and restore of the port's ``TrainState`` with its
metadata.

Port of ``tpuframe/ckpt``: :class:`Checkpointer` step directories on
``torch.distributed.checkpoint`` (DCP), in the JAX package's on-disk
layout, with retention and best tracking; the metrics and meta JSON saved
inside every step; the stdlib readers and the quarantine and rollback
surgery of ``ckpt.meta``.  The reference saves raw per-epoch
``torch.save({'model', 'optimizer'})`` files
(``01_torch_distributor/01_basic_torch_distributor.py:109-124``), logs a
state dict per epoch with best tracking (Accelerate's
``log_state_dict``), and bundles metrics with Ray's
``Checkpoint.from_directory``.

Exports resolve lazily (PEP 562), so ``ckpt.meta`` stays importable
without loading DCP.
"""

_LAZY = {
    "Checkpointer": "tpuframe_torch.ckpt.checkpoint",
    "best_checkpoint_path": "tpuframe_torch.ckpt.checkpoint",
    "ckpt_health_verdict": "tpuframe_torch.ckpt.meta",
    "healthy_steps": "tpuframe_torch.ckpt.meta",
    "is_committed": "tpuframe_torch.ckpt.meta",
    "latest_healthy_step": "tpuframe_torch.ckpt.meta",
    "latest_step": "tpuframe_torch.ckpt.meta",
    "load_pytree": "tpuframe_torch.ckpt.checkpoint",
    "quarantine_torn_steps": "tpuframe_torch.ckpt.meta",
    "read_health": "tpuframe_torch.ckpt.meta",
    "read_manifest": "tpuframe_torch.ckpt.meta",
    "rollback_to_last_healthy": "tpuframe_torch.ckpt.meta",
    "save_pytree": "tpuframe_torch.ckpt.checkpoint",
    "topology_manifest": "tpuframe_torch.ckpt.checkpoint",
    "valid_steps": "tpuframe_torch.ckpt.meta",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'tpuframe_torch.ckpt' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
