"""CIFAR ResNet18 through the Distributor + single-image inference demo.

Port of ``examples/01_distributor_cifar_resnet.py``, line for line: the
launcher recipe, rank-0 metrics, the 1-epoch vs N-epoch timing comparison
and the post-hoc ``predict_image`` demo of the reference's
``01_torch_distributor/02_cifar_torch_distributor_resnet.py``.  Only the
config crosses the process boundary; the dataset is built in the worker,
and the step averages the gradients over the ranks (``plan=``).

Run:  python 01_distributor_cifar_resnet.py --num-processes 2 --simulate-devices 1
(two CPU workers), or without ``--simulate-devices`` on the card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import torch

from _common import base_parser
from tpuframe_torch import core
from tpuframe_torch.data import DataLoader, SyntheticImageDataset, Timer
from tpuframe_torch.launch import Distributor
from tpuframe_torch.models import ResNet18
from tpuframe_torch.parallel import ParallelPlan, align_model_dtype, bf16_compute, full_precision
from tpuframe_torch.track import MLflowLogger
from tpuframe_torch.train import (
    create_train_state,
    make_optimizer,
    make_predict_fn,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)


def train_cifar(cfg: dict):
    """Worker fn (≈ ``train_func``, `02_cifar_torch_distributor_resnet.py:165`).
    Returns (final metrics, elapsed seconds) — picklable, rank 0's copy wins."""
    rt = core.initialize()
    plan = ParallelPlan(mesh=rt.mesh)

    # dataset handles, not dataset bytes, cross the boundary
    train_ds = SyntheticImageDataset(
        n=cfg["train_samples"], image_size=cfg["image_size"],
        num_classes=cfg["num_classes"], seed=cfg["seed"],
    )
    loader = DataLoader(train_ds, cfg["batch_size"], shuffle=True, seed=cfg["seed"])

    policy = bf16_compute() if rt.platform == "gpu" else full_precision()
    # align the model's compute dtype with the policy (f32 model under a
    # bf16 policy would silently up-cast inside every layer)
    model = align_model_dtype(
        ResNet18(num_classes=cfg["num_classes"], stem="cifar", seed=cfg["seed"]), policy
    )
    state = create_train_state(model, make_optimizer("adam", cfg["lr"]), seed=cfg["seed"])
    train_step = make_train_step(policy, plan=plan)

    logger = MLflowLogger("cifar_distributor", tracking_uri=cfg["tracking_uri"])
    if rt.is_main:
        logger.log_params({"epochs": cfg["epochs"], "lr": cfg["lr"]})

    timer = Timer()
    summary = {}
    for epoch in range(cfg["epochs"]):
        loader.set_epoch(epoch)
        acc = None
        for images, labels in loader:
            batch = plan.shard_batch({"image": images, "label": labels})
            state, metrics = train_step(state, batch)
            acc = merge_metrics(acc, metrics)
        summary = summarize_metrics(acc or {}, "train_")
        if rt.is_main:
            logger.log_metrics(summary, step=epoch)  # `:258-260`
    elapsed = timer.stop()
    if rt.is_main:
        logger.flush()

    # single-image inference demo (`:370-387`): logits -> argmax class
    predict = make_predict_fn(policy)
    img, label = train_ds[0]
    x = torch.from_numpy(np.asarray(img)[None]).to(rt.device)
    pred = int(np.argmax(predict(state.model, x).cpu().numpy()))
    return {**summary, "demo_label": label, "demo_pred": pred}, elapsed


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--num-processes", type=int, default=2)
    args = p.parse_args(argv)
    cfg = {
        "epochs": 1,
        "batch_size": args.batch_size,
        "train_samples": args.train_samples,
        "image_size": args.image_size,
        "num_classes": args.num_classes,
        "lr": args.lr,
        "seed": args.seed,
        "tracking_uri": os.path.join(args.workdir, "cifar", "mlruns"),
    }
    dist = Distributor(
        num_processes=args.num_processes, simulate_devices=args.simulate_devices
    )

    # 1-epoch cheap run before the full run (`:337` "Single epoch for testing")
    _, one_epoch_s = dist.run(train_cifar, cfg)
    print(f"1 epoch: {one_epoch_s:.1f}s")

    cfg["epochs"] = args.epochs
    summary, full_s = dist.run(train_cifar, cfg)
    print(f"{args.epochs} epochs: {full_s:.1f}s  metrics: {summary}")


if __name__ == "__main__":
    main()
