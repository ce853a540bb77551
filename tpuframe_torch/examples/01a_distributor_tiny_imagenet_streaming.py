"""TinyImageNet-scale training from streamed TFS shards, end to end.

Port of ``examples/01a_distributor_tiny_imagenet_streaming.py``, line for
line: the reference's only streaming recipe (HF dataset -> MDS shards in
a volume, workers streaming shards remote->local cache with stale-cache
cleanup, transforms applied in ``__getitem__``, ResNet50 at 64 px and 200
classes, per-epoch validation with early stopping, and the five-image
inference spot check).

- The launching process writes TFS shards once (synthetic
  TinyImageNet-shaped data by default; ``--hf-dataset
  zh-plus/tiny-imagenet`` on a connected machine).
- Only the *shard directory path* crosses the process boundary: dataset
  handles, not dataset bytes.
- Each worker streams its shard subset into a local cache and feeds the
  train step on its card (bf16), or on the CPU with
  ``--simulate-devices 1``.

Run:  python 01a_distributor_tiny_imagenet_streaming.py \\
          --num-processes 2 --simulate-devices 1 --train-samples 512
(two CPU workers), or ``--num-processes 1`` without ``--simulate-devices``
on one card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import torch

from _common import base_parser
from tpuframe_torch import core
from tpuframe_torch.data import (
    Compose,
    DataLoader,
    Normalize,
    RandomHorizontalFlip,
    ShardWriter,
    StreamingDataset,
    SyntheticImageDataset,
    Timer,
    ToFloat,
    clean_stale_cache,
)
from tpuframe_torch.launch import Distributor
from tpuframe_torch.models import ResNet50
from tpuframe_torch.parallel import ParallelPlan, align_model_dtype, bf16_compute, full_precision
from tpuframe_torch.track import MLflowLogger
from tpuframe_torch.train import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_predict_fn,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def write_shards(args) -> tuple[str, str, int]:
    """Launcher-side conversion (≈ the reference's MDSWriter loop).

    Returns (train_remote, val_remote, num_classes).  A small shard limit,
    so even the smoke-scale run streams several shards.
    """
    root = os.path.join(args.workdir, "tiny_imagenet_tfs")
    columns = {"image": "ndarray", "label": "int"}
    splits = {}
    for split, n, seed in (
        ("train", args.train_samples, args.seed),
        ("val", args.eval_samples, args.seed + 1),
    ):
        out = os.path.join(root, split)
        if os.path.exists(os.path.join(out, "index.json")):
            splits[split] = out
            continue  # idempotent, like the reference's cached volume
        ds = _source_dataset(args, n, seed)
        with ShardWriter(out, columns, shard_size_limit=1 << 20) as w:
            for i in range(len(ds)):
                img, label = ds[i]
                w.write({"image": np.asarray(img, np.uint8), "label": int(label)})
        splits[split] = out
    return splits["train"], splits["val"], args.num_classes


def _source_dataset(args, n: int, seed: int):
    if args.hf_dataset:
        from tpuframe_torch.data import hfds_download, make_image_dataset

        raw = hfds_download(args.hf_dataset, cache_dir=f"{args.workdir}/hf_cache")
        split = "train" if seed == args.seed else (
            "valid" if "valid" in raw else "test"
        )
        return make_image_dataset(raw[split])
    # synthetic uint8 images in TinyImageNet shape: 64px, 200 classes
    base = SyntheticImageDataset(
        n=n, image_size=args.image_size, num_classes=args.num_classes, seed=seed
    )

    class AsUint8:
        def __len__(self):
            return len(base)

        def __getitem__(self, i):
            img, label = base[i]
            return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8), label

    return AsUint8()


def train_tiny_imagenet(cfg: dict):
    """Worker fn (≈ the reference's ``train_func``, which builds the
    datasets inside the worker).  Returns (final metrics with the spot
    check, elapsed seconds)."""
    rt = core.initialize()
    plan = ParallelPlan(mesh=rt.mesh)

    # stale partial downloads from a killed run must not poison the cache
    # (≈ clean_stale_shared_memory)
    local_cache = os.path.join(cfg["workdir"], "stream_cache", f"host{rt.process_index}")
    clean_stale_cache(local_cache)

    train_tf = Compose([
        RandomHorizontalFlip(0.5),
        ToFloat(),
        Normalize(IMAGENET_MEAN, IMAGENET_STD),
    ])
    eval_tf = Compose([ToFloat(), Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    # for jpg-column volumes (this example's shards store ndarray columns):
    # pass decode_min_hw=(px, px) and lead the transform with Resize(px);
    # jpeg then decodes at the covering M/8 DCT scale and Resize finishes
    # the exact size
    train_ds = StreamingDataset(
        cfg["train_remote"],
        local_cache=os.path.join(local_cache, "train"),
        transform=train_tf,
        rng_seed=cfg["seed"],
    )
    val_ds = StreamingDataset(
        cfg["val_remote"],
        local_cache=os.path.join(local_cache, "val"),
        transform=eval_tf,
    )
    train_loader = DataLoader(
        train_ds, cfg["batch_size"], shuffle=True, seed=cfg["seed"], drop_last=True
    )
    val_loader = DataLoader(val_ds, cfg["batch_size"], drop_last=False)

    policy = bf16_compute() if rt.platform == "gpu" else full_precision()
    model = align_model_dtype(
        ResNet50(num_classes=cfg["num_classes"], seed=cfg["seed"]), policy)
    state = create_train_state(model, make_optimizer("adamw", cfg["lr"]), seed=cfg["seed"])
    train_step = make_train_step(policy, plan=plan)
    eval_step = make_eval_step(policy, plan=plan)

    logger = MLflowLogger("tiny_imagenet_streaming", tracking_uri=cfg["tracking_uri"])
    if rt.is_main:
        logger.log_params({
            "epochs": cfg["epochs"], "lr": cfg["lr"],
            "image_size": cfg["image_size"], "classes": cfg["num_classes"],
            "train_shards": "streamed",
        })

    timer = Timer()
    best_val, patience_left = float("inf"), cfg["patience"]
    summary = {}
    for epoch in range(cfg["epochs"]):
        train_loader.set_epoch(epoch)
        train_ds.set_epoch(epoch)
        acc = None
        for images, labels in train_loader:
            batch = plan.shard_batch({"image": images, "label": labels})
            state, metrics = train_step(state, batch)
            acc = merge_metrics(acc, metrics)
        summary = summarize_metrics(acc or {}, "train_")

        vacc = None
        for images, labels, mask in val_loader:
            batch = plan.shard_batch({"image": images, "label": labels, "weight": mask})
            vacc = merge_metrics(vacc, eval_step(state, batch))
        summary.update(summarize_metrics(vacc or {}, "val_"))
        if rt.is_main:
            logger.log_metrics(summary, step=epoch)

        # early stopping (patience), the reference's scaffold made real
        if summary["val_loss"] < best_val - 1e-4:
            best_val, patience_left = summary["val_loss"], cfg["patience"]
        else:
            patience_left -= 1
            if patience_left <= 0:
                break
    elapsed = timer.stop()
    if rt.is_main:
        logger.flush()

    # five-image inference spot check
    predict = make_predict_fn(policy)
    images = torch.from_numpy(np.stack([val_ds[i][0] for i in range(5)])).to(rt.device)
    preds = np.argmax(predict(state.model, images).float().cpu().numpy(), axis=-1).tolist()
    labels = [val_ds[i][1] for i in range(5)]
    return {**summary, "spot_preds": preds, "spot_labels": labels}, elapsed


def main(argv=None):
    p = base_parser(__doc__)
    p.set_defaults(image_size=64, num_classes=200, train_samples=256, eval_samples=64)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--patience", type=int, default=3)
    args = p.parse_args(argv)

    train_remote, val_remote, num_classes = write_shards(args)
    cfg = {
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "image_size": args.image_size,
        "num_classes": num_classes,
        "lr": args.lr,
        "seed": args.seed,
        "patience": args.patience,
        "workdir": args.workdir,
        "train_remote": train_remote,
        "val_remote": val_remote,
        "tracking_uri": os.path.join(args.workdir, "tiny_imagenet", "mlruns"),
    }
    dist = Distributor(
        num_processes=args.num_processes, simulate_devices=args.simulate_devices
    )
    summary, elapsed = dist.run(train_tiny_imagenet, cfg)
    print(f"{cfg['epochs']} epochs in {elapsed:.1f}s: {summary}")
    return summary


if __name__ == "__main__":
    main()
