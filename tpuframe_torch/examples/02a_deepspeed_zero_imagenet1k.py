"""ImageNet-1K-scale ZeRO training: ResNet50, 224px, 1000 classes.

Port of ``examples/02a_deepspeed_zero_imagenet1k.py``, line for line: the
ImageNet-1K workload shape (224 px, 1000 classes), ResNet50, AdamW with
warmup and ``gradient_clipping: 0.3`` from the base config, and the
stage-3 ladder:

- ``--zero-stage 3`` shards parameters and optimizer state over the fsdp
  axis; the fused AdamW kernel steps the owned slices and the clip takes
  the plan-global norm,
- ``--offload`` adds the stage-3-offload variant (optimizer state in
  pinned host memory on the card, copied in around each update; plain
  stage 3 with a warning on the CPU),
- ``--grad-accum N`` is ``gradient_accumulation_steps``.

Data is synthetic at the real tensor shapes.

Run:  python 02a_deepspeed_zero_imagenet1k.py --zero-stage 3 --fsdp 2 \\
          --num-processes 2 --simulate-devices 1 --train-samples 64 \\
          --batch-size 16 --image-size 64
(two CPU workers), or without ``--simulate-devices`` on the card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import torch

from _common import base_parser
from tpuframe_torch import core
from tpuframe_torch.data import DataLoader
from tpuframe_torch.launch import ZeroDistributor
from tpuframe_torch.models import ResNet50
from tpuframe_torch.parallel import ZeroConfig, align_model_dtype, bf16_compute, full_precision
from tpuframe_torch.train import (
    optimizer_from_config,
    create_train_state,
    make_eval_step,
    make_grad_accum_step,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)


def train_imagenet1k(cfg: dict, zero_config: ZeroConfig | None = None):
    """Worker fn; ``zero_config`` is injected by ZeroDistributor."""
    rt = core.initialize({"data": -1, "fsdp": cfg["fsdp"]})
    zero_config = zero_config or ZeroConfig(stage=0)
    plan = zero_config.plan(rt.mesh)

    from tpuframe_torch.data import SyntheticImageDataset

    train_ds = SyntheticImageDataset(
        n=cfg["train_samples"], image_size=cfg["image_size"],
        num_classes=cfg["num_classes"], seed=cfg["seed"],
    )
    val_ds = SyntheticImageDataset(
        n=cfg["eval_samples"], image_size=cfg["image_size"],
        num_classes=cfg["num_classes"], seed=cfg["seed"] + 1,
    )
    train_loader = DataLoader(
        train_ds, cfg["batch_size"], shuffle=True, seed=cfg["seed"], drop_last=True
    )
    val_loader = DataLoader(val_ds, cfg["batch_size"], drop_last=False)

    policy = bf16_compute() if rt.platform == "gpu" else full_precision()
    model = align_model_dtype(ResNet50(num_classes=cfg["num_classes"], seed=cfg["seed"]), policy)
    # the reference's base-config optimizer stack as one dict: AdamW betas
    # and eps, the WarmupLR schedule and the gradient_clipping knob (the
    # plan-global norm under ZeRO); AdamW through the fused kernel
    tx = optimizer_from_config({
        "gradient_clipping": 0.3,
        "optimizer": {
            "type": "AdamW",
            "params": {"lr": cfg["lr"], "betas": [0.9, 0.999], "eps": 1e-08},
        },
        "scheduler": {
            "type": "WarmupLR",
            "params": {"warmup_min_lr": 0, "warmup_max_lr": cfg["lr"],
                       "warmup_num_steps": cfg["warmup_steps"],
                       "warmup_type": "linear"},
        },
    }, fused=True)
    state = create_train_state(model, tx, seed=cfg["seed"], plan=plan)
    accum = cfg["grad_accum"]
    if accum > 1:
        train_step = make_grad_accum_step(accum, policy, plan=plan)
    else:
        train_step = make_train_step(policy, plan=plan)
    eval_step = make_eval_step(policy, plan=plan)

    history = []
    for epoch in range(cfg["epochs"]):
        train_loader.set_epoch(epoch)
        acc = None
        for images, labels in train_loader:
            if accum > 1:
                micro = images.shape[0] // accum
                images = images.reshape((accum, micro) + images.shape[1:])
                labels = labels.reshape((accum, micro) + labels.shape[1:])
            batch = plan.shard_batch(
                {"image": images, "label": labels}, leading_microbatch=accum > 1
            )
            state, metrics = train_step(state, batch)
            acc = merge_metrics(acc, metrics)
        summary = summarize_metrics(acc or {}, "train_")

        vacc = None
        for images, labels, mask in val_loader:
            batch = plan.shard_batch({"image": images, "label": labels, "weight": mask})
            vacc = merge_metrics(vacc, eval_step(state, batch))
        summary.update(summarize_metrics(vacc or {}, "val_"))
        history.append(summary)
        if rt.is_main:
            print(f"epoch {epoch}: {summary}")

    # where the optimizer state of at least one dim lives
    opt_kinds = sorted({
        "pinned_host" if leaf.is_pinned() else "device"
        for st in state.optimizer.state.values() for leaf in st.values()
        if torch.is_tensor(leaf) and leaf.ndim > 0
    })
    return {
        "stage": zero_config.stage,
        "offload_requested": zero_config.offload_optimizer,
        "opt_memory_kinds": opt_kinds,
        "grad_accum": accum,
        **history[-1],
    }


def main(argv=None):
    p = base_parser(__doc__)
    # ImageNet-1K shapes
    p.set_defaults(
        image_size=224, num_classes=1000, train_samples=64, eval_samples=32,
        batch_size=16,
    )
    p.add_argument("--zero-stage", type=int, default=3, choices=[0, 1, 2, 3])
    p.add_argument("--offload", action="store_true",
                   help="stage-3 optimizer offload to pinned host memory (the card)")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--fsdp", type=int, default=2,
                   help="fsdp mesh axis size inside each worker")
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
        "fsdp": args.fsdp,
        "grad_accum": args.grad_accum,
    }
    zero = ZeroConfig(stage=args.zero_stage, offload_optimizer=args.offload)
    dist = ZeroDistributor(
        num_processes=args.num_processes,
        simulate_devices=args.simulate_devices,
        zero_config=zero,
    )
    result = dist.run(train_imagenet1k, cfg)
    print("result:", result)
    assert result["stage"] == args.zero_stage
    return result


if __name__ == "__main__":
    main()
