"""ZeRO-sharded training through ZeroDistributor: the DeepSpeed family.

Port of ``examples/02_deepspeed_zero_cifar_resnet.py``, line for line:
``ZeroConfig`` travels through the launcher into the worker and becomes a
ParallelPlan; stages 1/2 shard the optimizer state over the fsdp axis (the
gradient of a sharded leaf is reduce-scattered, the owned slice updated by
the fused AdamW kernel, the new slices all-gathered), stage 3 shards the
parameters themselves.  AdamW with the reference's WarmupLR block, the
TensorBoard block, and per-epoch validation with early stopping
(patience).  The step takes its plan from the state
(``create_train_state(..., plan=)``), as the JAX step takes its shardings
from the sharded state.

Run:  python 02_deepspeed_zero_cifar_resnet.py --zero-stage 2 --fsdp 2 \\
          --num-processes 2 --simulate-devices 1
(two CPU workers), or without ``--simulate-devices`` on the card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from _common import base_parser
from tpuframe_torch import core
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.launch import ZeroDistributor
from tpuframe_torch.models import ResNet18
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.parallel import ZeroConfig
from tpuframe_torch.train import (
    schedule_from_config,
    create_train_state,
    make_eval_step,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)

#: The reference's config dicts, reduced to what the engine consumes.
ZERO_STAGES = {
    0: ZeroConfig(stage=0),
    1: ZeroConfig(stage=1),
    2: ZeroConfig(stage=2),
    3: ZeroConfig(stage=3),
}


def train_zero(cfg: dict, zero_config: ZeroConfig | None = None):
    """Worker fn; ``zero_config`` is injected by ZeroDistributor."""
    rt = core.initialize({"data": -1, "fsdp": cfg["fsdp"]})
    zero_config = zero_config or ZeroConfig(stage=0)
    plan = zero_config.plan(rt.mesh)

    train_ds = SyntheticImageDataset(
        n=cfg["train_samples"], image_size=cfg["image_size"],
        num_classes=cfg["num_classes"], seed=cfg["seed"],
    )
    val_ds = SyntheticImageDataset(
        n=cfg["eval_samples"], image_size=cfg["image_size"],
        num_classes=cfg["num_classes"], seed=cfg["seed"] + 1,
    )
    train_loader = DataLoader(train_ds, cfg["batch_size"], shuffle=True, seed=cfg["seed"])
    val_loader = DataLoader(val_ds, cfg["batch_size"], drop_last=False)

    model = ResNet18(num_classes=cfg["num_classes"], stem="cifar", seed=cfg["seed"])
    # AdamW + WarmupLR from the reference's scheduler block, resolved by
    # the schedule library; the fused AdamW kernel (optax.adamw's default
    # decay, 1e-4) steps the owned slices
    schedule = schedule_from_config({
        "scheduler": {
            "type": "WarmupLR",
            "params": {"warmup_min_lr": 0, "warmup_max_lr": cfg["lr"],
                       "warmup_num_steps": cfg["warmup_steps"],
                       "warmup_type": "linear"},
        }
    })
    state = create_train_state(model, fused_adamw(schedule, weight_decay=1e-4),
                               seed=cfg["seed"], plan=plan)
    train_step = make_train_step()
    eval_step = make_eval_step()

    # the reference's tensorboard block: rank 0 writes real event files
    from tpuframe_torch.track.tensorboard import from_deepspeed_config

    tb = None
    if rt.is_main:
        tb = from_deepspeed_config({
            "tensorboard": {
                "enabled": True,
                "output_path": os.path.join(cfg["workdir"], "tensorboard"),
                "job_name": f"zero{zero_config.stage}",
            }
        })

    best_val, patience_left = float("inf"), cfg["patience"]
    history = []
    try:
        for epoch in range(cfg["epochs"]):
            train_loader.set_epoch(epoch)
            acc = None
            for images, labels in train_loader:
                batch = plan.shard_batch({"image": images, "label": labels})
                state, metrics = train_step(state, batch)
                acc = merge_metrics(acc, metrics)
            summary = summarize_metrics(acc or {}, "train_")

            vacc = None
            for images, labels, mask in val_loader:
                batch = plan.shard_batch(
                    {"image": images, "label": labels, "weight": mask}
                )
                vacc = merge_metrics(vacc, eval_step(state, batch))
            summary.update(summarize_metrics(vacc or {}, "val_"))
            history.append(summary)
            if rt.is_main:
                print(f"epoch {epoch}: {summary}")
            if tb is not None:
                tb.log_metrics(summary, step=epoch)

            # early stopping with patience
            if summary["val_loss"] < best_val - cfg["min_delta"]:
                best_val, patience_left = summary["val_loss"], cfg["patience"]
            else:
                patience_left -= 1
                if patience_left <= 0:
                    break
    finally:
        # a crash mid-epoch must not lose the epochs already written
        if tb is not None:
            tb.close()
    return {"stage": zero_config.stage, "epochs_ran": len(history), **history[-1]}


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--zero-stage", type=int, default=2, choices=[0, 1, 2, 3])
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp mesh axis size inside each worker")
    p.add_argument("--patience", type=int, default=3)
    args = p.parse_args(argv)
    cfg = {
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "train_samples": args.train_samples,
        "eval_samples": args.eval_samples,
        "image_size": args.image_size,
        "num_classes": args.num_classes,
        "lr": args.lr,
        "warmup_steps": 10,
        "seed": args.seed,
        "patience": args.patience,
        "min_delta": 1e-4,
        "fsdp": args.fsdp,
        "workdir": os.path.join(args.workdir, "deepspeed"),
    }
    dist = ZeroDistributor(
        num_processes=args.num_processes,
        simulate_devices=args.simulate_devices,
        zero_config=ZERO_STAGES[args.zero_stage],
    )
    result = dist.run(train_zero, cfg)
    print("result:", result)
    assert result["stage"] == args.zero_stage
    return result


if __name__ == "__main__":
    main()
