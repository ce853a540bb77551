"""Launch layer: the Distributor's ``.run()`` and the Ray-style TPUTrainer.

Port of ``tpuframe/launch``:

- ``TorchDistributor(num_processes).run(fn, *args)`` ->
  :class:`Distributor`: spawns local worker processes, one device each,
  injects the rendezvous env (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
  ``WORLD_SIZE``), ships the function with cloudpickle and returns rank 0's
  result; a heartbeat finds lost ranks.  :class:`ZeroDistributor` hands the
  train fn its ``zero_config=``.
- Ray Train's ``TorchTrainer(train_func, ScalingConfig, RunConfig)`` with
  ``Result``/``report``/``get_context`` -> :class:`TPUTrainer`.

Not yet (ROADMAP.md, Queue 1): ``RemoteDistributor``, ``ssh_connect``,
``all_env_vars`` and the restart loops (``run_with_restarts``,
``run_elastic``) come with the platform planes (item 9).
"""

from tpuframe_torch.launch.distributor import (
    Distributor,
    DistributorError,
    WorkerLostError,
    ZeroDistributor,
    await_and_root_cause,
)
from tpuframe_torch.launch.trainer_api import (
    Checkpoint,
    Result,
    RunConfig,
    ScalingConfig,
    TPUTrainer,
    TrainContext,
    get_context,
    report,
)

__all__ = [
    "Checkpoint",
    "Distributor",
    "DistributorError",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TPUTrainer",
    "TrainContext",
    "WorkerLostError",
    "ZeroDistributor",
    "get_context",
    "report",
]
