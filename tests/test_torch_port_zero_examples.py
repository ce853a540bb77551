"""Examples 02 and 02a of the port (``tpuframe_torch/examples``) on two CPU
ranks: ``--num-processes 2 --simulate-devices 1 --fsdp 2``, through their
own ``main`` (ZeroDistributor, one gloo process a simulated device).

- Example 02 (ResNet18 CIFAR, fused AdamW with WarmupLR, the TensorBoard
  block, early stopping) under ``--zero-stage 2`` and ``--zero-stage 3``:
  the two runs end on the same metrics bit for bit (ZeRO is a memory
  layout; no clip, so the update is the same to the bit), the stage rides
  the result, rank 0 writes TensorBoard event files.
- Example 02a (ResNet50, 1,000 classes, stage 3, ``--grad-accum 2``, 64 px,
  clip 0.3 at the plan-global norm): finite metrics, the grad-accum count
  and ``opt_memory_kinds`` ``["device"]`` (offload downgrades on the CPU).
- ``ZeroDistributor`` hands the worker ``zero_config=``.
"""

import importlib
import math

import pytest

from tpuframe_torch.launch import ZeroDistributor
from tpuframe_torch.parallel import ZeroConfig

EX02 = ["--fsdp", "2", "--num-processes", "2", "--simulate-devices", "1", "--epochs", "2",
        "--batch-size", "16", "--train-samples", "32", "--eval-samples", "16",
        "--image-size", "8"]
EX02A = ["--zero-stage", "3", "--fsdp", "2", "--num-processes", "2", "--simulate-devices", "1",
         "--epochs", "1", "--batch-size", "8", "--train-samples", "16", "--eval-samples", "8",
         "--image-size", "64", "--grad-accum", "2", "--num-classes", "10"]


def _example(name: str):
    return importlib.import_module(f"tpuframe_torch.examples.{name}")


@pytest.fixture(scope="module")
def ex02(tmp_path_factory):
    ex = _example("02_deepspeed_zero_cifar_resnet")
    work = tmp_path_factory.mktemp("ex02")
    return {stage: ex.main(EX02 + ["--zero-stage", str(stage), "--workdir", str(work / str(stage))])
            for stage in (2, 3)}, work


@pytest.mark.parametrize("stage", [2, 3])
def test_example_02_trains_under_zero(ex02, stage):
    results, work = ex02
    got = results[stage]
    assert got["stage"] == stage and got["epochs_ran"] == 2
    assert all(math.isfinite(got[k]) for k in ("train_loss", "val_loss"))
    events = list((work / str(stage) / "deepspeed" / "tensorboard").rglob("events.out.*"))
    assert events, "rank 0 wrote no TensorBoard events"


def test_example_02_stages_2_and_3_end_on_the_same_metrics(ex02):
    results, _ = ex02
    a, b = results[2], results[3]
    assert {k: v for k, v in a.items() if k != "stage"} == {
        k: v for k, v in b.items() if k != "stage"}


def test_example_02a_stage_3_with_grad_accum(tmp_path):
    ex = _example("02a_deepspeed_zero_imagenet1k")
    got = ex.main(EX02A + ["--workdir", str(tmp_path)])
    assert got["stage"] == 3 and got["grad_accum"] == 2 and not got["offload_requested"]
    assert got["opt_memory_kinds"] == ["device"]
    assert all(math.isfinite(got[k]) for k in ("train_loss", "val_loss"))


def _takes_zero_config(cfg, zero_config=None):
    return {"cfg": cfg, "stage": zero_config.stage, "offload": zero_config.offload_optimizer}


def test_zero_distributor_hands_the_worker_its_config():
    dist = ZeroDistributor(num_processes=1, simulate_devices=1,
                           zero_config=ZeroConfig(stage=3, offload_optimizer=True))
    assert dist.run(_takes_zero_config, {"a": 1}) == {"cfg": {"a": 1}, "stage": 3,
                                                      "offload": True}
