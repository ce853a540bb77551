"""Checkpoint and resume through the port's ``Trainer.fit``, against the JAX
package's (the counterparts of ``tests/test_train.py``'s mid-epoch resume
tests).

- A crash mid-epoch resumes from the last snapshot with the next batch, not
  a replay, and the resumed fit ends on the uninterrupted fit's parameters
  bit for bit (one process on the CPU: the same ops in the same order).
- Snapshots live in ``<dir>_intra`` apart from the epoch-end steps; a
  leftover snapshot resumes even with the feature off; an untrackable loader
  with snapshots on, and a restore under another global batch, raise.
- The JAX ``Trainer`` (with ``tpuframe.ckpt.Checkpointer``) and the port's,
  on the same numpy weights and data with ``checkpoint_interval_batches=2``,
  write snapshot metas that ``tpuframe.ckpt.meta`` reads as equal, and
  health stamps with the same keys.
- Two gloo ranks through the compressed wire save their residuals as one
  global ``(2, ...)`` leaf; a world-1 restore folds them.

The rank function lives here and imports no JAX (the JAX side stays in the
test functions), as ``tests/torch_ranks.py`` asks.
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.models import ResNet18
from tpuframe_torch.train import Trainer
from tpuframe_torch.train.callbacks import Callback

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _loader(batch=16, n=128):
    ds = SyntheticImageDataset(n=n, image_size=16, num_classes=4)
    return DataLoader(ds, batch_size=batch, shuffle=True, seed=5)


def _trainer(directory=None, interval=3, duration="8ba", batch=16, **kw):
    return Trainer(ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu"),
                   train_dataloader=_loader(batch), max_duration=duration, optimizer="sgd",
                   lr=0.05, num_classes=4, log_interval=0,
                   checkpointer=None if directory is None else Checkpointer(directory),
                   checkpoint_interval_batches=interval if directory is not None else None, **kw)


class Bomb(Callback):
    """A hard crash after ``at`` batches (a duration stop would write an
    epoch-end checkpoint; a crash must not)."""

    def __init__(self, at):
        self.at = at

    def on_step_end(self, trainer):
        if trainer.batches_seen >= self.at:
            raise RuntimeError("boom")


class Positions(Callback):
    """The loader position of every batch the step consumed."""

    def __init__(self):
        self.seen = []

    def on_step_end(self, trainer):
        self.seen.append(trainer._train_prefetcher.state_dict()["batches_yielded"])


def test_crash_resumes_with_next_batch_not_replay(tmp_path):
    first = _trainer(tmp_path / "ck")
    first.callbacks = [Bomb(5)]
    with pytest.raises(RuntimeError, match="boom"):
        first.fit()
    assert first.batches_seen == 5  # crashed; the last snapshot was batch 3

    resumed = _trainer(tmp_path / "ck")
    positions = Positions()
    resumed.callbacks = [positions]
    result = resumed.fit()
    # restored at batch 3, trained batches 4..8 of the same epoch
    assert positions.seen == [4, 5, 6, 7, 8]
    assert resumed.batches_seen == 8 and resumed.epoch == 1 and resumed.state.step == 8
    assert result.error is None and result.checkpoint == str(tmp_path / "ck" / "8")

    straight = _trainer()
    straight.fit()
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.state.optimizer.state.values(),
                    resumed.state.optimizer.state.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])


def test_snapshots_isolated_from_epoch_checkpoints(tmp_path):
    """Snapshots at batches 2, 4, 6 into the sibling directory (8, the
    epoch's last, is skipped: the epoch-end save follows); the epoch-end
    save at step 8 drops the snapshot of step 6 it supersedes."""
    trainer = _trainer(tmp_path / "ck2", interval=2, duration="1ep")
    ck = trainer.checkpointer
    result = trainer.fit()
    assert ck.all_steps() == [8] and result.checkpoint == str(tmp_path / "ck2" / "8")
    _, meta = ck.restore(trainer.state)
    assert meta["epoch"] == 1 and "loader_state" not in meta
    intra = Checkpointer(str(tmp_path / "ck2") + "_intra")
    assert intra.all_steps() == []


def test_snapshot_cadence_reads_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFRAME_CKPT_INTERVAL_BATCHES", "3")
    trainer = _trainer(tmp_path / "ck", interval=None)
    assert trainer.checkpoint_interval_batches == 3
    trainer.callbacks = [Bomb(4)]  # before an epoch-end save drops the snapshot
    with pytest.raises(RuntimeError, match="boom"):
        trainer.fit()
    intra = Checkpointer(str(tmp_path / "ck") + "_intra")
    assert intra.all_steps() == [3]
    assert intra.restore(trainer.state)[1]["loader_state"]["batches_yielded"] == 3


def test_leftover_snapshot_resumes_even_with_feature_off(tmp_path):
    first = _trainer(tmp_path / "ck3", interval=3)
    first.callbacks = [Bomb(5)]
    with pytest.raises(RuntimeError, match="boom"):
        first.fit()
    resumed = _trainer(tmp_path / "ck3", interval=None)  # the feature off on the restart
    assert resumed.checkpoint_interval_batches is None
    resumed.fit()
    # restored at the snapshot (batch 3), not 0: only batches 4..8 retrained
    assert resumed.batches_seen == 8 and resumed.state.step == 8


def test_untrackable_loader_with_mid_epoch_ckpt_is_a_clear_error(tmp_path):
    class Duck:
        global_batch_size = 16
        process_count = 1

        def set_epoch(self, e):
            pass

        def __iter__(self):
            rng = np.random.default_rng(0)
            for _ in range(4):
                yield (rng.standard_normal((16, 16, 16, 3)).astype(np.float32),
                       rng.integers(0, 4, (16,)).astype(np.int64))

    trainer = Trainer(ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu"),
                      train_dataloader=Duck(), max_duration="1ep", num_classes=4,
                      log_interval=0, checkpointer=Checkpointer(tmp_path / "ck4"),
                      checkpoint_interval_batches=2)
    with pytest.raises(ValueError, match="checkpoint_interval_batches"):
        trainer.fit()


def test_global_batch_mismatch_raises(tmp_path):
    first = _trainer(tmp_path / "ck5", interval=2)
    first.callbacks = [Bomb(3)]
    with pytest.raises(RuntimeError, match="boom"):
        first.fit()
    with pytest.raises(ValueError, match="global batch 16"):
        _trainer(tmp_path / "ck5", interval=2, batch=8).fit()


def test_snapshot_meta_matches_the_jax_trainer(tmp_path):
    """Both Trainers, the same weights and data, snapshots every 2 batches,
    a crash after batch 3 of an epoch of 5: the snapshot of batch 2 stays on
    each side.
    Read by the JAX package's readers, its meta section is equal, and the
    health stamps have the same keys."""
    import jax

    import tpuframe.ckpt.meta as jax_meta
    from tpuframe.ckpt import Checkpointer as JaxCheckpointer
    from tpuframe.data import DataLoader as JaxDataLoader
    from tpuframe.data.datasets import SyntheticImageDataset as JaxSynthetic
    from tpuframe.models import ResNet18 as JaxResNet18
    from tpuframe.train.callbacks import Callback as JaxCallback
    from tpuframe.train.trainer import Trainer as JaxTrainer
    from tpuframe_torch.models import from_jax_variables

    class JaxBomb(JaxCallback):
        def on_step_end(self, trainer, *a):
            if trainer.batches_seen >= 3:
                raise RuntimeError("boom")

    def loader(ds_cls, dl_cls, **extra):
        return dl_cls(ds_cls(n=40, image_size=16, num_classes=10, seed=1), 8, shuffle=True,
                      seed=2, transfer_dtype="uint8", **extra)

    common = dict(optimizer="sgd", lr=0.05, max_duration="1ep", normalize=(MEAN, STD), seed=0,
                  checkpoint_interval_batches=2, log_interval=0)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jtr = JaxTrainer(JaxResNet18(num_classes=10, num_filters=4, stem="cifar"),
                     train_dataloader=loader(JaxSynthetic, JaxDataLoader, process_index=0,
                                             process_count=1),
                     precompile=False, checkpointer=JaxCheckpointer(jdir),
                     callbacks=[JaxBomb()], **common)
    state = jtr.init_state()
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             {"params": state.params, "batch_stats": state.batch_stats})
    with pytest.raises(RuntimeError, match="boom"):
        jtr.fit()
    jtr.checkpointer.wait()
    jtr._intra_checkpointer().wait()

    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    port = Trainer(model, train_dataloader=loader(SyntheticImageDataset, DataLoader),
                   checkpointer=Checkpointer(tdir), callbacks=[Bomb(3)], **common)
    with pytest.raises(RuntimeError, match="boom"):
        port.fit()

    jintra, tintra = f"{jdir}_intra", f"{tdir}_intra"
    assert jax_meta.valid_steps(jintra) == jax_meta.valid_steps(tintra) == [2]
    assert jax_meta.valid_steps(jdir) == jax_meta.valid_steps(tdir) == []  # no epoch end
    want, got = jax_meta._read_meta_doc(jintra, 2), jax_meta._read_meta_doc(tintra, 2)
    assert got["meta"] == want["meta"]
    assert set(got["meta"]) == {"epoch", "batches_seen", "samples_seen", "global_batch",
                                "loader_state"}
    jstamp, tstamp = jax_meta.read_health(jintra, 2), jax_meta.read_health(tintra, 2)
    assert set(tstamp) == set(jstamp)
    assert tstamp["step"] == jstamp["step"] == 2 and tstamp["healthy"] == jstamp["healthy"]
    assert set(got) == set(want) == {"meta", "metrics", "topology", "health"}


def _compressed_rank(rank, world, directory):
    """A compressed fit of one epoch at world 2 with an epoch-end save;
    returns this rank's residual row and parameters."""
    from tpuframe_torch.core import initialize

    initialize(device="cpu")
    ds = SyntheticImageDataset(n=32, image_size=16, num_classes=4)
    trainer = Trainer(ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu"),
                      train_dataloader=DataLoader(ds, 16, shuffle=True, seed=2),
                      optimizer="sgd", lr=0.05, max_duration="1ep", num_classes=4,
                      log_interval=0, grad_compression="int8",
                      checkpointer=Checkpointer(directory))
    result = trainer.fit()
    return {"residual": trainer.state.comms["flat"].numpy().copy(),
            "params": {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()},
            "checkpoint": result.checkpoint}


def test_compressed_residuals_save_globally_and_fold_onto_one_rank(tmp_path):
    import tpuframe.ckpt.meta as jax_meta
    from tpuframe_torch.core import current_runtime
    from tpuframe_torch.parallel import CommsConfig, ParallelPlan, init_comms_state
    from tpuframe_torch.train import create_train_state, make_optimizer

    directory = str(tmp_path / "ck")
    r0, r1 = run_ranks(_compressed_rank, 2, tmp_path, directory, timeout=240)
    assert r0["checkpoint"] == r1["checkpoint"] == f"{directory}/2"
    leaf = jax_meta.read_manifest(directory)["leaves"]["comms/flat"]
    assert leaf["shape"] == [2, *r0["residual"].shape[1:]] and leaf["dtype"] == "float32"
    assert not np.array_equal(r0["residual"], r1["residual"])  # each rank's own error

    model = ResNet18(num_classes=4, num_filters=4, stem="cifar", device="cpu", seed=9)
    state = create_train_state(model, make_optimizer("sgd", 0.05))
    plan = ParallelPlan(mesh=current_runtime(device="cpu").mesh)
    state.comms = init_comms_state(dict(model.named_parameters()), plan, CommsConfig("int8"))
    state, meta = Checkpointer(directory).restore(state)
    assert meta["epoch"] == 1 and state.step == 2
    # world 2 -> 1: the one group's sum, scaled by 1/2 (the mean correction)
    want = ((r0["residual"] + r1["residual"]) * np.float32(0.5))
    np.testing.assert_array_equal(state.comms["flat"].numpy(), want)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), r0["params"][k], err_msg=k)
