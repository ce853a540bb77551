"""The port's ``DataLoader`` and ``Trainer.fit`` against the JAX package's.

- The loader: the same dataset, seed and epoch give byte-identical
  batches on both sides (images, labels, the padded tail and its mask),
  and ``state_dict()`` resumes both at the same position.
- ``Trainer.fit``: a small f32 ResNet18 over ``SyntheticImageDataset``,
  two epochs of SGD (momentum 0.9) with uint8 images normalized on the
  device, from the JAX Trainer's own initial weights (carried across with
  ``from_jax_variables``).  Per-epoch ``train_loss``, ``eval_loss`` and
  ``eval_accuracy`` agree within 1e-3 relative (10 steps of f32 SGD whose
  convolution sums run in another order on each side; measured ~1e-5).
  The batch is 8, a multiple of the 8 virtual JAX devices of
  ``conftest.py``.
"""

import numpy as np
import pytest
import torch

from tpuframe.data import DataLoader as JaxDataLoader
from tpuframe.data.datasets import SyntheticImageDataset as JaxSynthetic
from tpuframe.models import ResNet18 as JaxResNet18
from tpuframe.train.trainer import Trainer as JaxTrainer
from tpuframe_torch.data import DataLoader, DevicePrefetcher, SyntheticImageDataset
from tpuframe_torch.core import MeshSpec
from tpuframe_torch.models import ResNet18, from_jax_variables
from tpuframe_torch.parallel import ParallelPlan
from tpuframe_torch.train import Trainer

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _collect(loader, n=None):
    out = []
    for i, batch in enumerate(loader):
        out.append(tuple(np.array(a) for a in batch))
        if n is not None and i + 1 == n:
            break
    return out


LOADERS = [
    ("shuffled_drop_last", dict(shuffle=True, drop_last=True)),
    ("ordered_padded_tail", dict(shuffle=False, drop_last=False)),
    ("shuffled_padded_tail_uint8", dict(shuffle=True, drop_last=False, transfer_dtype="uint8")),
]


@pytest.mark.parametrize("name,kw", LOADERS, ids=[c[0] for c in LOADERS])
def test_loader_batches_are_byte_identical_to_jax(name, kw):
    jl = JaxDataLoader(JaxSynthetic(n=29, image_size=8, seed=3), 8, seed=5,
                       process_index=0, process_count=1, **kw)
    tl = DataLoader(SyntheticImageDataset(n=29, image_size=8, seed=3), 8, seed=5, **kw)
    assert len(tl) == len(jl)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want, got = _collect(jl), _collect(tl)
        assert len(got) == len(want) == len(jl)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    if not kw["drop_last"]:
        assert got[-1][2].tolist() == [True] * 5 + [False] * 3


def test_loader_resumes_at_the_same_position_as_jax():
    jl = JaxDataLoader(JaxSynthetic(n=40, image_size=8), 8, shuffle=True, seed=1,
                       process_index=0, process_count=1)
    tl = DataLoader(SyntheticImageDataset(n=40, image_size=8), 8, shuffle=True, seed=1)
    jl.set_epoch(2)
    tl.set_epoch(2)
    _collect(jl, 2)
    _collect(tl, 2)
    js, ts = jl.state_dict(), tl.state_dict()
    assert ts == {k: js[k] for k in ts}
    jl2 = JaxDataLoader(JaxSynthetic(n=40, image_size=8), 8, shuffle=True, seed=1,
                        process_index=0, process_count=1)
    tl2 = DataLoader(SyntheticImageDataset(n=40, image_size=8), 8, shuffle=True, seed=1)
    jl2.load_state_dict(js)
    tl2.load_state_dict(ts)
    want, got = _collect(jl2), _collect(tl2)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert all(a.tobytes() == b.tobytes() for a, b in zip(g, w))
    with pytest.raises(ValueError, match="fingerprint"):
        DataLoader(SyntheticImageDataset(n=40, image_size=8), 4).load_state_dict(ts)


def test_prefetcher_on_the_cpu_copies_before_it_recycles():
    tl = DataLoader(SyntheticImageDataset(n=24, image_size=4), 8, ring_buffers=2)
    want = _collect(DataLoader(SyntheticImageDataset(n=24, image_size=4), 8))
    got = list(DevicePrefetcher(tl, depth=2, device="cpu", track_loader=tl))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) for t in g)
        assert all(t.numpy().tobytes() == a.tobytes() for t, a in zip(g, w))


def test_trainer_refuses_what_is_not_ported():
    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    mesh2 = MeshSpec(data=2).build(2)  # two ranks: no process group is needed to refuse
    # straggler detection is ported (test_torch_port_track_analyze.py holds
    # its events against JAX's): the knobs reach the monitor as JAX's do
    tr = Trainer(model, straggler_sync_steps=4, straggler_factor=3.0)
    assert (tr._straggler.sync_steps, tr._straggler.factor) == (4, 3.0)
    # preemption is ported (test_torch_port_preempt.py): it builds
    assert Trainer(model, preemption=True).preemption is True
    # tensor-parallel rules are ported: a plan with rules builds, and a
    # Trainer takes it (two ranks train ViT through it in
    # test_torch_port_tensor_parallel.py and example 07 with --tp 2); ZeRO
    # beside the model axis still raises, when the state is laid out
    from tpuframe_torch.models import vit_tp_rules
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import create_train_state

    tp2 = MeshSpec(data=1, model=2).build(2)
    rules = Trainer(model, plan=ParallelPlan(mesh=tp2, rules=vit_tp_rules()))
    assert rules.plan.rules == vit_tp_rules()
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        create_train_state(model, fused_adamw(1e-3),
                           plan=ParallelPlan(mesh=tp2, rules=vit_tp_rules(), zero_stage=1))
    # ZeRO is ported: a Trainer takes a ZeRO plan (two ranks train through
    # it in test_torch_port_zero.py)
    zero = Trainer(model, plan=ParallelPlan(mesh=mesh2, zero_stage=2), grad_compression="int8")
    assert zero.plan.zero_stage == 2 and zero.comms_config.mode == "int8"
    # the fused transport is ported: a fused plan builds (two ranks train
    # through it in test_torch_port_comms_overlap.py)
    fused = Trainer(model, plan=ParallelPlan(mesh=mesh2, comms_fused=True),
                    grad_compression="int8")
    assert fused.plan.comms_fused and fused.comms_config.mode == "int8"
    # EMA and lion/lamb/adafactor are ported now (test_torch_port_ema.py,
    # test_torch_port_optim.py): they build
    Trainer(model, optimizer="lion", ema_decay=0.99)
    # uncompressed over 2 ranks is ported; without a process group of 2 the
    # plan does not match the world
    with pytest.raises(ValueError, match="dp_size is 2 .* world size is 1"):
        Trainer(model, plan=ParallelPlan(mesh=mesh2))


def test_fit_matches_the_jax_trainer():
    def loaders(ds_cls, dl_cls, **extra):
        train = dl_cls(ds_cls(n=40, image_size=16, num_classes=10, seed=1), 8,
                       shuffle=True, seed=2, transfer_dtype="uint8", **extra)
        evl = dl_cls(ds_cls(n=20, image_size=16, num_classes=10, seed=7), 8,
                     drop_last=False, transfer_dtype="uint8", **extra)
        return train, evl

    common = dict(optimizer="sgd", lr=0.05, max_duration="2ep", normalize=(MEAN, STD),
                  health=False, seed=0)
    jtrain, jeval = loaders(JaxSynthetic, JaxDataLoader, process_index=0, process_count=1)
    jtr = JaxTrainer(JaxResNet18(num_classes=10, num_filters=4, stem="cifar"),
                     train_dataloader=jtrain, eval_dataloader=jeval, precompile=False, **common)
    state = jtr.init_state()
    variables = {"params": jax_to_numpy(state.params),
                 "batch_stats": jax_to_numpy(state.batch_stats)}
    want = jtr.fit().history

    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    train, evl = loaders(SyntheticImageDataset, DataLoader)
    got = Trainer(model, train_dataloader=train, eval_dataloader=evl, **common).fit().history
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train_loss", "train_accuracy", "eval_loss", "eval_accuracy"):
            assert g[key] == pytest.approx(w[key], rel=1e-3), (key, g[key], w[key])
        assert set(w) <= set(g) | {"grad_norm", "health_bad_steps"}


def jax_to_numpy(tree):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
