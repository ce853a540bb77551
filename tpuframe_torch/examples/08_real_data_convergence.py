"""Real-data convergence recipes: the accuracy half of the north star.

Port of ``examples/08_real_data_convergence.py``.  The reference validates
by watching per-epoch test accuracy
(`02_deepspeed/02_tiny_imagenet_deepspeed_resnet.py:219-297`); this example
is that loop as a committed, asserted recipe through the full Trainer:
augmentation, linear-warmup + cosine schedule, checkpointing with
auto-resume, per-epoch held-out eval, and a ``--min-accuracy`` acceptance
gate (exit 1 below the threshold).

Two datasets:

- ``--dataset digits`` (default): sklearn's bundled 1,797 real scanned
  handwritten digits, which need no download.  Target >= 97% held-out
  top-1.
- ``--dataset cifar10``: the from-scratch ResNet18 >= 90% CIFAR-10 recipe
  (RandomCrop+flip, bf16 on the card, SGD momentum + warmup-cosine, label
  smoothing).  Needs real CIFAR-10 on disk: ``--data-npz`` with arrays
  ``x_train/y_train/x_test/y_test`` (uint8 HWC), or the HF cache populated
  for ``hfds_download("cifar10")``; without either it exits 2 with a clear
  message.

With no device named it runs on the card; ``--simulate-devices 1`` runs it
on the CPU.

Run:  python 08_real_data_convergence.py --dataset digits --epochs 25 \\
          --min-accuracy 0.97 --workdir /tmp/digits

Elastic mode (accuracy and fault tolerance in one measured run):
``--elastic`` supervises the recipe as a child process whose first attempt
hard-crashes mid-epoch (``os._exit(13)``, no cleanup), then restarts it;
the restart auto-resumes from the Trainer's mid-epoch snapshot and must
still clear the same accuracy gate:

      python 08_real_data_convergence.py --dataset digits --epochs 25 \\
          --min-accuracy 0.97 --elastic --workdir /tmp/digits_elastic
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import simulate_in_process
from tpuframe_torch import core
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.data import ArrayDataset, DataLoader
from tpuframe_torch.models import MnistNet, ResNet18
from tpuframe_torch.train import LabelSmoothing, Trainer, warmup_cosine
from tpuframe_torch.train.callbacks import Callback


class CrashAt(Callback):
    """A simulated hard failure: ``os._exit`` after N global batches (no
    exception, no checkpoint flush, no atexit), the crash the elastic
    restart must survive, driven across processes because a dead process
    cannot retry itself."""

    def __init__(self, at_batches: int):
        self.at = int(at_batches)

    def on_step_end(self, trainer: Trainer) -> None:
        # on_step_end fires every batch, so the kill lands mid-epoch: the
        # restart resumes from a snapshot, not an epoch boundary
        if trainer.batches_seen >= self.at:
            print(f"[crash-sim] hard exit at global batch {trainer.batches_seen}", flush=True)
            os._exit(13)


def load_digits_arrays(n_train: int = 1500, seed: int = 0):
    """sklearn digits -> bilinear-upscaled 28x28x1 floats in [0, 1]."""
    from PIL import Image
    from sklearn.datasets import load_digits

    digits = load_digits()
    X = digits.images.astype(np.float32)  # (1797, 8, 8), values 0..16
    y = digits.target.astype(np.int32)
    order = np.random.default_rng(seed).permutation(len(X))
    X, y = X[order], y[order]

    def up(a: np.ndarray) -> np.ndarray:
        img = Image.fromarray((a * (255.0 / 16.0)).astype(np.uint8))
        img = img.resize((28, 28), Image.BILINEAR)
        return (np.asarray(img, np.float32) / 255.0)[..., None]

    X = np.stack([up(x) for x in X])
    return (X[:n_train], y[:n_train]), (X[n_train:], y[n_train:])


def shift_crop(pad: int, size: int):
    """RandomCrop(size, padding=pad), the CIFAR augmentation idiom."""

    def aug(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        p = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
        dy, dx = rng.integers(0, 2 * pad + 1, 2)
        return p[dy: dy + size, dx: dx + size]

    return aug


def flip_and_crop(pad: int, size: int):
    crop = shift_crop(pad, size)

    def aug(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img = crop(img, rng)
        return img[:, ::-1] if rng.random() < 0.5 else img

    return aug


def _callbacks(args) -> list:
    return [CrashAt(args.simulate_crash_at_batch)] if args.simulate_crash_at_batch is not None \
        else []


def _checkpointer(args) -> Checkpointer:
    return Checkpointer(os.path.join(args.workdir, "ck"), best_metric="eval_accuracy",
                        best_mode="max")


def train_digits(args) -> float:
    (xtr, ytr), (xte, yte) = load_digits_arrays()
    lt = DataLoader(ArrayDataset(xtr, ytr, transform=shift_crop(2, 28)), batch_size=96,
                    shuffle=True, seed=args.seed)
    le = DataLoader(ArrayDataset(xte, yte), batch_size=96, drop_last=False)
    steps = args.epochs * len(lt)
    trainer = Trainer(
        MnistNet(num_classes=10, seed=args.seed),
        train_dataloader=lt,
        eval_dataloader=le,
        max_duration=f"{args.epochs}ep",
        optimizer="adamw",
        lr=warmup_cosine(2e-3, warmup_steps=len(lt), total_steps=steps),
        num_classes=10,
        # the compressed recipe must clear the same --min-accuracy as f32
        grad_compression=args.grad_compression,
        log_interval=0,
        eval_interval=args.eval_interval,
        callbacks=_callbacks(args),
        checkpoint_interval_batches=args.checkpoint_interval_batches,
        checkpointer=_checkpointer(args),
        seed=args.seed,
    )
    result = trainer.fit()
    return report(result, trainer, args.epochs)


def report(result, trainer, total_epochs: int) -> float:
    """Print the accuracy curve (absolute epochs: after an auto-resume the
    history covers only the resumed stretch) and return the final accuracy.
    A fit that resumed an already complete run has no fresh eval in its
    metrics; an explicit eval of the restored state stands in."""
    offset = total_epochs - len(result.history)
    for e, h in enumerate(result.history):
        if "eval_accuracy" in h:
            print(f"epoch {offset + e + 1}: eval_accuracy={h['eval_accuracy']:.4f}")
    if "eval_accuracy" not in result.metrics:
        return float(trainer.evaluate()["eval_accuracy"])
    return float(result.metrics["eval_accuracy"])


def load_cifar10_arrays(args):
    if args.data_npz:
        blob = np.load(args.data_npz)
        return ((blob["x_train"], blob["y_train"].astype(np.int32)),
                (blob["x_test"], blob["y_test"].astype(np.int32)))
    from tpuframe_torch.data import hfds_download

    ds = hfds_download("cifar10", os.path.join(args.workdir, "hf_cache"))
    to_np = lambda split: (  # noqa: E731
        np.stack([np.asarray(im) for im in split["img"]]),
        np.asarray(split["label"], np.int32))
    return to_np(ds["train"]), to_np(ds["test"])


CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def train_cifar10(args) -> float:
    (xtr, ytr), (xte, yte) = load_cifar10_arrays(args)
    norm = lambda x: (x.astype(np.float32) / 255.0 - CIFAR_MEAN) / CIFAR_STD  # noqa: E731
    xtr, xte = norm(xtr), norm(xte)
    lt = DataLoader(ArrayDataset(xtr, ytr, transform=flip_and_crop(4, 32)),
                    batch_size=args.batch_size, shuffle=True, seed=args.seed)
    le = DataLoader(ArrayDataset(xte, yte), batch_size=args.batch_size, drop_last=False)
    steps = args.epochs * len(lt)
    rt = core.initialize()
    trainer = Trainer(
        ResNet18(num_classes=10, stem="cifar", device=rt.device, seed=args.seed),
        train_dataloader=lt,
        eval_dataloader=le,
        max_duration=f"{args.epochs}ep",
        optimizer="sgd",
        lr=warmup_cosine(0.1 * args.batch_size / 128, warmup_steps=5 * len(lt),
                         total_steps=steps),
        algorithms=[LabelSmoothing(0.1, num_classes=10)],
        precision="bf16" if rt.platform == "gpu" else "f32",
        num_classes=10,
        grad_compression=args.grad_compression,
        log_interval=0,
        eval_interval=args.eval_interval,
        callbacks=_callbacks(args),
        checkpoint_interval_batches=args.checkpoint_interval_batches,
        checkpointer=_checkpointer(args),
        seed=args.seed,
    )
    result = trainer.fit()
    return report(result, trainer, args.epochs)


def run_elastic(args, argv: list[str]) -> None:
    """Supervise the recipe as a restartable child: attempt 1 gets
    ``--simulate-crash-at-batch`` and dies mid-epoch; each restart runs
    without it and auto-resumes from the Trainer's snapshots in
    ``--workdir``.  The exit code is the last child's, so the
    ``--min-accuracy`` gate still decides: 13 (the simulated crash)
    restarts, 1 (a rejected gate or a Python error: a bug, not the
    infrastructure) is terminal, and 3 says the crash never fired."""
    import subprocess

    def strip_flag(av: list[str], flag: str) -> list[str]:
        out, skip = [], False
        for a in av:
            if skip:
                skip = False
            elif a == flag:
                skip = True  # the flag and its value
            elif not a.startswith(flag + "="):
                out.append(a)
        return out

    # the supervisor owns these: the crash flag must not reach a restart
    # (it would crash again at the same batch), and the snapshot interval
    # is appended to every attempt below
    child_argv = [a for a in argv if a != "--elastic"]
    for flag in ("--simulate-crash-at-batch", "--checkpoint-interval-batches"):
        child_argv = strip_flag(child_argv, flag)
    base = [sys.executable, os.path.abspath(__file__)] + child_argv
    crash = 40 if args.simulate_crash_at_batch is None else args.simulate_crash_at_batch
    snap = 7 if args.checkpoint_interval_batches is None else args.checkpoint_interval_batches
    for attempt in range(args.max_restarts + 1):
        cmd = list(base)
        if attempt == 0:
            cmd += ["--simulate-crash-at-batch", str(crash)]
        cmd += ["--checkpoint-interval-batches", str(snap)]
        print(f"[elastic] attempt {attempt + 1}: {' '.join(cmd[2:])}", flush=True)
        rc = subprocess.call(cmd)
        if rc == 0:
            if attempt == 0:
                print("[elastic] simulated crash never fired: run shorter than "
                      f"--simulate-crash-at-batch {crash}? Nothing was validated.",
                      file=sys.stderr, flush=True)
                sys.exit(3)
            print(f"[elastic] recovered and finished after {attempt} restart(s)", flush=True)
            sys.exit(0)
        if rc == 1:
            # a rejected gate or an uncaught error: a restart would only
            # re-verify the same checkpoint (the restart loop's FATAL class)
            print(f"[elastic] child failed terminally rc={rc}; not restarting",
                  file=sys.stderr, flush=True)
            sys.exit(rc)
        if attempt == 0 and rc != 13:
            print(f"[elastic] expected simulated crash rc=13, got rc={rc}", file=sys.stderr,
                  flush=True)
            sys.exit(rc)
        if attempt == args.max_restarts:
            print(f"[elastic] retry budget exhausted (rc={rc})", file=sys.stderr, flush=True)
            sys.exit(rc if rc else 1)
        print(f"[elastic] child failed rc={rc}; restarting with auto-resume from "
              f"{args.workdir}/ck", flush=True)
    sys.exit(1)  # unreachable unless max_restarts < 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=["digits", "cifar10"], default="digits")
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--eval-interval", type=int, default=5)
    ap.add_argument("--min-accuracy", type=float, default=None)
    ap.add_argument("--grad-compression", choices=["int8", "fp8"], default=None,
                    help="train over the compressed gradient wire (error feedback on): the "
                    "convergence gate then proves wire parity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "tpuframe_torch_convergence"))
    ap.add_argument("--data-npz", default=None,
                    help="cifar10 arrays: x_train/y_train/x_test/y_test")
    ap.add_argument("--elastic", action="store_true",
                    help="supervise with a simulated mid-epoch crash + auto-resume restart")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--simulate-crash-at-batch", type=int, default=None,
                    help="hard os._exit(13) after N global batches")
    ap.add_argument("--checkpoint-interval-batches", type=int, default=None,
                    help="mid-epoch snapshot every N batches")
    ap.add_argument("--simulate-devices", type=int, default=None,
                    help="1: run on the CPU (the launcher's request for CPU workers)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    simulate_in_process(args)

    if args.elastic:
        run_elastic(args, argv)
        return

    if args.dataset == "digits":
        acc = train_digits(args)
    else:
        try:
            acc = train_cifar10(args)
        except RuntimeError as e:
            print(f"cifar10 data unavailable: {e}", file=sys.stderr)
            sys.exit(2)
    print(f"final eval_accuracy={acc:.4f}")
    if args.min_accuracy is not None:
        if acc < args.min_accuracy:
            print(f"REJECTED: {acc:.4f} < {args.min_accuracy}")
            sys.exit(1)
        print(f"ACCEPTED: {acc:.4f} >= {args.min_accuracy}")


if __name__ == "__main__":
    main()
