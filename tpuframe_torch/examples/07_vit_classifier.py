"""ViT image classification through the high-level Trainer.

Port of ``examples/07_vit_classifier.py``, line for line: the other
standard image backbone beside the reference's ResNets, driven exactly
like the Composer recipe (``03_composer_cifar_resnet.py``): the
Composer-shaped Trainer with LabelSmoothing/MixUp algorithms, a cosine
schedule from the schedule library, and bf16 on the card.

``--tp`` above 1 shards QKV/MLP/patch-embed/head with ``vit_tp_rules``
over ``MeshSpec(data=-1, model=tp)``.  The port runs one process a device,
so it launches ``--num-processes`` workers (default: ``--tp``) through the
``Distributor``; ``--simulate-devices 1`` runs them on the CPU.

Run:  python 07_vit_classifier.py --epochs 2 --tp 2 --simulate-devices 1
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np

from _common import base_parser, make_datasets, simulate_in_process


def train(args) -> dict:
    from tpuframe_torch.core import runtime as rt
    from tpuframe_torch.core.runtime import MeshSpec
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import ViT, vit_tp_rules
    from tpuframe_torch.parallel import ParallelPlan
    from tpuframe_torch.train import LabelSmoothing, MixUp, Trainer, cosine_annealing

    runtime = rt.initialize(MeshSpec(data=-1, model=args.tp))
    plan = ParallelPlan(
        mesh=runtime.mesh,
        rules=vit_tp_rules() if args.tp > 1 else (),
        min_shard_elems=1,
    )

    train_ds, eval_ds = make_datasets(args)
    train_loader = DataLoader(
        train_ds, args.batch_size, shuffle=True, seed=args.seed
    )
    eval_loader = DataLoader(eval_ds, args.batch_size, drop_last=False)

    steps = args.epochs * max(len(train_loader), 1)
    trainer = Trainer(
        ViT(
            num_classes=args.num_classes,
            patch_size=args.patch_size,
            hidden_dim=args.hidden_dim,
            num_layers=args.layers,
            num_heads=args.heads,
            attn_impl="full",
            image_size=args.image_size,
            seed=args.seed,
        ),
        train_dataloader=train_loader,
        eval_dataloader=eval_loader,
        max_duration=args.epochs,
        optimizer="adamw",
        lr=cosine_annealing(args.lr, steps),
        algorithms=[LabelSmoothing(0.1), MixUp()],
        precision="bf16" if runtime.platform == "gpu" else "fp32",
        plan=plan,
        seed=args.seed,
        log_interval=0,
    )
    result = trainer.fit()
    if result.error is not None:
        raise result.error
    print(
        f"final: loss {result.metrics['train_loss']:.4f} "
        f"eval_acc {result.metrics.get('eval_accuracy', float('nan')):.3f} "
        f"(tp={args.tp})",
        flush=True,
    )
    return result.metrics


def main(argv=None):
    p = base_parser("ViT classifier via the high-level Trainer")
    p.add_argument("--patch-size", type=int, default=4)
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--num-processes", type=int, default=None,
                   help="workers, one device each (default: --tp)")
    args = p.parse_args(argv)
    workers = args.num_processes or args.tp
    if workers > 1:
        from tpuframe_torch.launch import Distributor

        metrics = Distributor(num_processes=workers,
                              simulate_devices=args.simulate_devices).run(train, args)
    else:
        simulate_in_process(args)
        metrics = train(args)
    assert np.isfinite(metrics["train_loss"])
    return metrics


if __name__ == "__main__":
    main()
