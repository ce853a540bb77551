"""High-level Trainer with algorithms + logger plugins — Composer family.

Port of ``examples/03_composer_cifar_resnet.py``, line for line: the
reference's ``Trainer(model, optimizers, train/eval dataloaders,
max_duration="2ep", algorithms=[LabelSmoothing(0.1), CutMix(1.0),
ChannelsLast()], loggers=[MLFlowLogger(...)])`` (cell-16), then the
model-registry log_model + reload + single-image inference (cell-16..18).

Run:  python 03_composer_cifar_resnet.py --epochs 2
(``--simulate-devices 1`` runs it on the CPU)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import torch

from _common import base_parser, make_datasets, make_loaders, simulate_in_process
from tpuframe_torch import core
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.models import ResNet50
from tpuframe_torch.track import MLflowLogger
from tpuframe_torch.train import ChannelsLast, CutMix, LabelSmoothing, Trainer


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    simulate_in_process(args)
    core.initialize()

    train_ds, eval_ds = make_datasets(args)
    train_loader, eval_loader = make_loaders(args, train_ds, eval_ds)

    tracking_uri = os.path.join(args.workdir, "composer", "mlruns")
    logger = MLflowLogger("composer_cifar", tracking_uri=tracking_uri)
    trainer = Trainer(
        ResNet50(num_classes=args.num_classes, stem="cifar", seed=args.seed),
        optimizer="adam",
        lr=args.lr,
        train_dataloader=train_loader,
        eval_dataloader=eval_loader,
        max_duration=f"{args.epochs}ep",  # Composer's duration grammar
        algorithms=[LabelSmoothing(0.1), CutMix(1.0), ChannelsLast()],
        loggers=[logger],
        checkpointer=Checkpointer(
            os.path.join(args.workdir, "composer", "ckpt"),
            best_metric="eval_loss", best_mode="min",
        ),
        # mid-epoch snapshots (sibling dir, deterministic resume): a crash
        # auto-resumes with the very next batch instead of the epoch start
        checkpoint_interval_batches=50,
        seed=args.seed,
    )
    result = trainer.fit()
    print("fit:", result.metrics)

    # model registry + reload + single-image inference (cell-16..18):
    # log -> register a named version -> alias -> reload by models:/ URI,
    # the MLFlowLogger(model_registry_uri='databricks-uc') capability
    model_dir = logger.log_model(trainer.state, artifact_path="model")
    run = logger.run  # flush() ends + detaches the run; keep the handle
    logger.flush()

    from tpuframe_torch.track import ModelRegistry, load_model

    reg = ModelRegistry(tracking_uri)
    version = reg.register_model(run, "cifar-composer-resnet")
    reg.set_alias("cifar-composer-resnet", "champion", version.version)
    reloaded = load_model(
        "models:/cifar-composer-resnet@champion",
        template=trainer.state,
        tracking_uri=tracking_uri,
    )
    assert torch.allclose(
        next(iter(reloaded["params"].values())).cpu(),
        next(iter(trainer.state.model.parameters())).detach().cpu(),
    )
    img, label = eval_ds[0]
    logits = trainer.predict(np.asarray(img)[None])
    print(
        f"demo: label={label} pred={int(np.argmax(logits))} "
        f"model@{model_dir} registered=v{version.version}@champion"
    )
    assert result.error is None


if __name__ == "__main__":
    main()
