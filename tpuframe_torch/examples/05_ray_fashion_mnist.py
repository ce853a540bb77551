"""TPUTrainer with per-epoch reports + checkpoint bundles — Ray Train family.

Port of ``examples/05_ray_fashion_mnist.py``, line for line: the
reference's ``TorchTrainer(train_func, ScalingConfig(num_workers),
RunConfig(storage))`` (cell-7), ``ray.train.report(metrics,
checkpoint=Checkpoint.from_directory)`` each epoch (cell-6), the
structured ``result.metrics/.checkpoint/.error`` (cell-8), and checkpoint
reload via ``as_directory()`` (cell-9).

Run:  python 05_ray_fashion_mnist.py --num-workers 2 --simulate-devices 1
(two CPU workers), or without ``--simulate-devices`` on the card.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(__file__))

import contextlib
import json

from _common import base_parser
from tpuframe_torch import core
from tpuframe_torch.ckpt import save_pytree
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.launch import (
    Checkpoint,
    RunConfig,
    ScalingConfig,
    TPUTrainer,
    get_context,
    report,
)
from tpuframe_torch.models import MnistNet
from tpuframe_torch.parallel import ParallelPlan
from tpuframe_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)


def train_func(config: dict):
    """Per-worker loop (≈ cell-6): prepare, epoch loop, report."""
    ctx = get_context()  # world size/rank (cell-6)
    rt = core.initialize()
    plan = ParallelPlan(mesh=rt.mesh)

    ds = SyntheticImageDataset(
        n=config["train_samples"], image_size=28, channels=1,
        num_classes=10, seed=config["seed"],
    )
    loader = DataLoader(ds, config["batch_size"], shuffle=True, seed=config["seed"])

    state = create_train_state(
        MnistNet(num_classes=10, seed=config["seed"]),
        make_optimizer("adam", config["lr"]), seed=config["seed"],
    )
    step_fn = make_train_step(plan=plan)

    for epoch in range(config["epochs"]):
        loader.set_epoch(epoch)  # sampler.set_epoch (cell-6)
        acc = None
        for images, labels in loader:
            batch = plan.shard_batch({"image": images, "label": labels})
            state, metrics = step_fn(state, batch)
            acc = merge_metrics(acc, metrics)
        summary = summarize_metrics(acc or {}, "train_")

        # report metrics + a checkpoint bundle each epoch (cell-6); report()
        # copies the bundle into run storage, so the temp dir is ephemeral
        # (≈ the reference's `with tempfile.TemporaryDirectory()`)
        with contextlib.ExitStack() as stack:
            ckpt_dir = None
            if ctx.get_world_rank() == 0:
                ckpt_dir = stack.enter_context(tempfile.TemporaryDirectory())
                save_pytree(
                    os.path.join(ckpt_dir, "model.msgpack"),
                    {"params": dict(state.model.named_parameters())},
                )
                with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
                    json.dump({"epoch": epoch}, f)
            report(
                {**summary, "epoch": epoch, "world_size": ctx.get_world_size()},
                checkpoint=Checkpoint.from_directory(ckpt_dir) if ckpt_dir else None,
            )


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--num-workers", type=int, default=2)
    args = p.parse_args(argv)

    trainer = TPUTrainer(
        train_func,
        train_loop_config={
            "epochs": args.epochs,
            "batch_size": args.batch_size,
            "train_samples": args.train_samples,
            "lr": args.lr,
            "seed": args.seed,
        },
        scaling_config=ScalingConfig(
            num_workers=args.num_workers, simulate_devices=args.simulate_devices
        ),
        run_config=RunConfig(
            storage_path=os.path.join(args.workdir, "ray_results"), name="fashion"
        ),
    )
    result = trainer.fit()  # cell-7
    print("metrics:", result.metrics)  # cell-8
    print("history:", len(result.metrics_dataframe), "reports")
    if result.error is not None:
        raise result.error

    # checkpoint reload (cell-9)
    with result.checkpoint.as_directory() as d:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        assert os.path.exists(os.path.join(d, "model.msgpack"))
    print("reloaded checkpoint from epoch", meta["epoch"])
    assert meta["epoch"] == args.epochs - 1


if __name__ == "__main__":
    main()
