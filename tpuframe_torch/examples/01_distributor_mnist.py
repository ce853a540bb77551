"""MNIST CNN through the Distributor, under the restart loop.

Port of ``examples/01_distributor_mnist.py`` (the reference's basic DDP
recipe, ``01_torch_distributor/01_basic_torch_distributor.py``):
a local smoke fit in this process first (`:185-201`), then the same train
fn in workers under the launcher (`:360-367`) with the rank-0 discipline:
a checkpoint every epoch, eval, experiment tracking and a picklable
"finished" (`:248-328`).  The launch runs under ``run_with_restarts``: a
killed or lost rank surfaces within seconds, the run relaunches, and
``train_mnist`` resumes from the last epoch's checkpoint.

The step averages the gradients over the ranks (``plan=``); every process
takes part in the checkpoint's save.  The step loop asks the active chaos
plan at the ``step`` site (``tpuframe_torch.fault.chaos``), so a drill can
kill a worker at a chosen batch.

Run:  python 01_distributor_mnist.py --num-processes 2 --simulate-devices 1
(two CPU workers), or without ``--simulate-devices`` on the card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

from _common import base_parser, simulate_in_process
from tpuframe_torch import core
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.fault import chaos
from tpuframe_torch.launch import Distributor, run_with_restarts
from tpuframe_torch.models import MnistNet
from tpuframe_torch.parallel import ParallelPlan
from tpuframe_torch.track import MLflowLogger
from tpuframe_torch.train import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)


def train_mnist(cfg: dict) -> str:
    """The worker fn (≈ ``main_fn``, `01_basic_torch_distributor.py:248`)."""
    rt = core.initialize()  # the injected rank and world env
    plan = ParallelPlan(mesh=rt.mesh)

    train_ds = SyntheticImageDataset(
        n=cfg["train_samples"], image_size=28, channels=1,
        num_classes=10, seed=cfg["seed"],
    )
    eval_ds = SyntheticImageDataset(
        n=cfg["eval_samples"], image_size=28, channels=1,
        num_classes=10, seed=cfg["seed"] + 1,
    )
    train_loader = DataLoader(train_ds, cfg["batch_size"], shuffle=True, seed=cfg["seed"])
    eval_loader = DataLoader(eval_ds, cfg["batch_size"], drop_last=False)

    model = MnistNet(num_classes=10, device=rt.device, seed=cfg["seed"])
    # momentum SGD like the reference (`01_basic_torch_distributor.py:283`)
    state = create_train_state(model, make_optimizer("sgd", cfg["lr"]), seed=cfg["seed"])
    train_step = make_train_step(plan=plan)
    eval_step = make_eval_step(plan=plan)

    logger = MLflowLogger("mnist_distributor", tracking_uri=cfg["tracking_uri"])
    ckpt = Checkpointer(cfg["ckpt_dir"], max_to_keep=3)
    # a relaunch continues from the last epoch's checkpoint
    state, meta = ckpt.maybe_restore(state)
    first_epoch = int(meta["epoch"]) if meta else 0
    if rt.is_main:
        logger.log_params({"epochs": cfg["epochs"], "lr": cfg["lr"],
                           "resumed_at_epoch": first_epoch})

    for epoch in range(first_epoch, cfg["epochs"]):
        train_loader.set_epoch(epoch)
        acc = None
        for images, labels in train_loader:
            chaos.maybe_fire("step", step=state.step)
            batch = plan.shard_batch({"image": images, "label": labels})
            state, metrics = train_step(state, batch)
            acc = merge_metrics(acc, metrics)
        summary = summarize_metrics(acc or {}, "train_")
        if rt.is_main:
            logger.log_metrics(summary, step=epoch)
        # every process takes part in the save (the reference's rank-0
        # torch.save, `:298-299`)
        ckpt.save(state, metrics=summary, meta={"epoch": epoch + 1})

    # rank-0 eval, like `:302-323`
    eacc = None
    for images, labels, mask in eval_loader:
        batch = plan.shard_batch({"image": images, "label": labels, "weight": mask})
        eacc = merge_metrics(eacc, eval_step(state, batch))
    esum = summarize_metrics(eacc or {}, "test_")
    if rt.is_main:
        logger.log_metrics(esum, step=cfg["epochs"])
        logger.flush()
        print(f"rank0 eval: {esum}")

    # checkpoint round trip (`:155-181`)
    restored, _ = ckpt.restore(state)
    assert restored.step == state.step
    ckpt.close()
    return "finished"  # picklable result, `:328`


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--num-processes", type=int, default=2)
    args = p.parse_args(argv)
    cfg = {
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "train_samples": args.train_samples,
        "eval_samples": args.eval_samples,
        "lr": args.lr,
        "seed": args.seed,
        "tracking_uri": os.path.join(args.workdir, "mnist", "mlruns"),
        "ckpt_dir": os.path.join(args.workdir, "mnist", "ckpt"),
    }

    # Local-first smoke: the reference trains 1 epoch in-process before
    # distributing (`01_basic_torch_distributor.py:185-201`).
    simulate_in_process(args)
    smoke = dict(cfg, epochs=1, ckpt_dir=cfg["ckpt_dir"] + "_local")
    print("local smoke:", train_mnist(smoke))

    dist = Distributor(
        num_processes=args.num_processes, simulate_devices=args.simulate_devices
    )
    # a killed or lost rank surfaces within seconds (the poll loop and the
    # heartbeat), the run relaunches, and train_mnist resumes from its
    # Checkpointer instead of recomputing
    result = run_with_restarts(
        lambda: dist.run(train_mnist, cfg), max_restarts=2
    )
    print("distributed:", result)
    assert result == "finished"


if __name__ == "__main__":
    main()
