"""A frozen backbone trained on two gloo ranks (spawned processes,
``FileStore`` rendezvous): the transfer recipe of ``TransferClassifier``
under ``make_train_step(plan=...)``, once through the exact mean of the
gradients and once through the int8 compressed wire.

Each rank steps ``freeze(TransferClassifier(ResNet18(num_classes=0),
5))`` under AdamW with weight decay 1e-2 on its own half of two global
batches.  The frozen backbone ends bit-equal to its start on both ranks
(no gradient, no decay, no count), both ranks' heads end bit-equal to
each other and differ from their start, and the stages carry the head
alone: the wire's flat layout holds the head's elements and no more.
"""

import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.core import initialize
from tpuframe_torch.models import ResNet18, TransferClassifier, freeze
from tpuframe_torch.parallel import CommsConfig, ParallelPlan, init_comms_state
from tpuframe_torch.train import create_train_state, make_train_step
from tpuframe_torch.train.optim import optimizer_from_config
from tpuframe_torch.train.step import trainable_parameters

ADAMW = {"optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 1e-2}}}


def _frozen_worker(rank: int, world: int, wire: str | None) -> dict:
    rt = initialize(device="cpu")
    plan = ParallelPlan(mesh=rt.mesh)
    torch.manual_seed(0)
    model = TransferClassifier(ResNet18(num_classes=0, num_filters=4, stem="cifar",
                                        device="cpu", seed=3), 5, device="cpu")
    freeze(model)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, optimizer_from_config(ADAMW))
    config = CommsConfig(wire) if wire else None
    if config is not None:
        state.comms = init_comms_state(trainable_parameters(model), plan, config)
    step = make_train_step(plan=plan, grad_compression=config)
    gen = torch.Generator().manual_seed(11)
    for _ in range(2):
        image = torch.randn(2 * world, 16, 16, 3, generator=gen)
        label = torch.randint(0, 5, (2 * world,), generator=gen)
        state, _ = step(state, {"image": image[2 * rank:2 * rank + 2],
                                "label": label[2 * rank:2 * rank + 2]})
    return {
        "backbone_still": all(torch.equal(p, start[f"backbone.{n}"])
                              for n, p in model.backbone.named_parameters()),
        "backbone_grads": [n for n, p in model.backbone.named_parameters()
                           if p.grad is not None],
        "head_moved": not torch.equal(model.head.weight, start["head.weight"]),
        "head": {n: p.detach().clone() for n, p in model.head.named_parameters()},
        "head_elems": sum(p.numel() for p in model.head.parameters()),
        "flat_elems": None if step.wire is None else step.wire["flat_elems"],
    }


@pytest.mark.parametrize("wire", [None, "int8"], ids=["mean", "int8_wire"])
def test_frozen_backbone_on_two_ranks(tmp_path, wire):
    ranks = run_ranks(_frozen_worker, 2, tmp_path, wire, timeout=90.0)
    for r in ranks:
        assert r["backbone_still"] and r["backbone_grads"] == [] and r["head_moved"]
        if wire:
            assert r["flat_elems"] == r["head_elems"]
    for name, want in ranks[0]["head"].items():
        assert torch.equal(ranks[1]["head"][name], want), name
