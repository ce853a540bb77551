"""Low-level step API with cross-process metrics — HF Accelerate family.

Port of ``examples/04_accelerate_cifar.py``, line for line: the manual
epoch loop over prepared model/loaders (cell-16), global metric reduction
(``accelerator.gather(...).sum()`` becomes summed metrics that aggregate
exactly across processes, cell-18), per-epoch rank-0 ``log_state_dict``
checkpoints with best-model tracking, the run-id broadcast to non-main
processes, cosine LR, and ``set_seed`` determinism.

Run:  python 04_accelerate_cifar.py --epochs 2
(``--simulate-devices 1`` runs it on the CPU)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from _common import base_parser, make_datasets, make_loaders, simulate_in_process
from tpuframe_torch import core
from tpuframe_torch.models import ResNet18
from tpuframe_torch.parallel import ParallelPlan
from tpuframe_torch.track import MLflowLogger, broadcast_run_id
from tpuframe_torch.train import (
    cosine_annealing,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument(
        "--grad-compression", default=None, choices=["int8"],
        help="int8-quantized gradient all-reduce (tpuframe_torch.parallel."
        "compression); omit for the exact all-reduce",
    )
    args = p.parse_args(argv)
    simulate_in_process(args)
    rt = core.initialize()
    plan = ParallelPlan(mesh=rt.mesh)  # ≈ accelerator.prepare

    train_ds, eval_ds = make_datasets(args)
    train_loader, eval_loader = make_loaders(args, train_ds, eval_ds)

    steps_per_epoch = max(len(train_loader), 1)
    schedule = cosine_annealing(  # CosineAnnealingLR (cell-16)
        args.lr, args.epochs * steps_per_epoch
    )
    state = create_train_state(
        ResNet18(num_classes=args.num_classes, stem="cifar", seed=args.seed),
        make_optimizer("adam", schedule), seed=args.seed,  # set_seed(42) (cell-3)
    )
    train_step = make_train_step(
        plan=plan, grad_compression=args.grad_compression
    )
    eval_step = make_eval_step(plan=plan)

    logger = MLflowLogger(
        "accelerate_cifar",
        tracking_uri=os.path.join(args.workdir, "accelerate", "mlruns"),
    )
    # run-id propagation: the reference broadcast it as a char tensor
    # (cell-18), as broadcast_run_id does over the process group
    run_id = broadcast_run_id(logger.run.run_id if rt.is_main else None)

    best = float("inf")
    for epoch in range(args.epochs):
        train_loader.set_epoch(epoch)
        acc = None
        for images, labels in train_loader:
            batch = plan.shard_batch({"image": images, "label": labels})
            state, metrics = train_step(state, batch)  # accelerator.backward
            acc = merge_metrics(acc, metrics)
        summary = summarize_metrics(acc or {}, "train_")

        eacc = None
        for images, labels, mask in eval_loader:
            batch = plan.shard_batch({"image": images, "label": labels, "weight": mask})
            eacc = merge_metrics(eacc, eval_step(state, batch))  # gather().sum()
        summary.update(summarize_metrics(eacc or {}, "eval_"))

        if rt.is_main:  # is_main_process discipline (cell-18)
            logger.log_metrics(summary, step=epoch)
            logger.run.log_state_dict(
                {"params": dict(state.model.named_parameters())},
                artifact_path=f"epoch_{epoch}",
            )
            if summary["eval_loss"] < best:
                best = summary["eval_loss"]
                logger.log_model(state, artifact_path="best_model")
            print(f"epoch {epoch} [{run_id[:8]}]: {summary}")
    if rt.is_main:
        logger.flush()


if __name__ == "__main__":
    main()
