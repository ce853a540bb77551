"""Shared plumbing for the ported example suite.

Port of ``examples/_common.py``.  Default data is synthetic; the
``--hf-dataset`` path needs a download and is kept as the JAX example
has it.  ``--simulate-devices 1`` asks for CPU workers (the launcher's
``TPUFRAME_SIMULATE_DEVICES``); without it everything runs on the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

# the examples run from a source checkout; make the repo root importable
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from tpuframe_torch.core.runtime import SIMULATE_ENV, check_simulated_devices
from tpuframe_torch.data import DataLoader, SyntheticImageDataset


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64, help="global batch size")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--train-samples", type=int, default=512)
    p.add_argument("--eval-samples", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--hf-dataset",
        default=None,
        help="HF dataset path (e.g. uoft-cs/cifar10); default: synthetic",
    )
    p.add_argument(
        "--simulate-devices",
        type=int,
        default=None,
        help="1: run the workers on the CPU, one gloo process per device",
    )
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(), "tpuframe_torch_examples"))
    return p


def simulate_in_process(args) -> None:
    """``--simulate-devices 1`` for an example that runs in this process
    (no launcher): the same request the launcher puts in its workers."""
    if args.simulate_devices:
        os.environ[SIMULATE_ENV] = str(check_simulated_devices(args.simulate_devices))


def make_datasets(args, channels: int = 3):
    """(train_ds, eval_ds) — synthetic unless --hf-dataset is given."""
    if args.hf_dataset:
        from tpuframe_torch.data import hfds_download, make_image_dataset

        raw = hfds_download(args.hf_dataset, cache_dir=f"{args.workdir}/hf_cache")
        train = make_image_dataset(raw["train"])
        eval_split = "test" if "test" in raw else "validation"
        evl = make_image_dataset(raw[eval_split])
        return train, evl
    train = SyntheticImageDataset(
        n=args.train_samples,
        image_size=args.image_size,
        channels=channels,
        num_classes=args.num_classes,
        seed=args.seed,
    )
    evl = SyntheticImageDataset(
        n=args.eval_samples,
        image_size=args.image_size,
        channels=channels,
        num_classes=args.num_classes,
        seed=args.seed + 1,
    )
    return train, evl


def make_loaders(args, train_ds, eval_ds):
    train = DataLoader(
        train_ds, args.batch_size, shuffle=True, seed=args.seed, drop_last=True
    )
    evl = DataLoader(eval_ds, args.batch_size, drop_last=False)
    return train, evl
