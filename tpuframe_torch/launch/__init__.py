"""Launch layer: the Distributor's ``.run()`` and the Ray-style TPUTrainer.

Port of ``tpuframe/launch``:

- ``TorchDistributor(num_processes).run(fn, *args)`` ->
  :class:`Distributor`: spawns local worker processes, one device each,
  injects the rendezvous env (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
  ``WORLD_SIZE``), ships the function with cloudpickle and returns rank 0's
  result; a heartbeat finds lost ranks.  :class:`ZeroDistributor` hands the
  train fn its ``zero_config=``.
- Placement on other hosts (``Distributor(local_mode=False, hosts=...)``)
  -> :class:`RemoteDistributor`: one ``python -m
  tpuframe_torch.launch.agent`` a rank over an exec transport
  (:func:`ssh_connect` by default), the env contract and the function on
  the agent's stdin, the driver's knobs (:func:`all_env_vars`) shipped
  with them; a failure re-raises with a :class:`RemoteLaunchError` as its
  cause.
- Ray Train's ``TorchTrainer(train_func, ScalingConfig, RunConfig)`` with
  ``Result``/``report``/``get_context`` -> :class:`TPUTrainer`.
- Recovery: :func:`run_with_restarts` (the supervised restart loop) and
  :func:`run_elastic` (shrink-to-survivors), on ``tpuframe_torch.fault``.
  Workers install the preemption watcher at bootstrap
  (``TPUFRAME_PREEMPT_SIGNALS=0`` opts out) and exit 143 when preempted.
"""

from tpuframe_torch.launch.distributor import (
    Distributor,
    DistributorError,
    WorkerLostError,
    ZeroDistributor,
    await_and_root_cause,
)
from tpuframe_torch.launch.elastic import (
    ElasticContext,
    rederive_batch_split,
    run_elastic,
    run_with_restarts,
    simulated_survivor_probe,
)
from tpuframe_torch.launch.remote import (
    RemoteDistributor,
    RemoteLaunchError,
    all_env_vars,
    ssh_connect,
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
    "ElasticContext",
    "RemoteDistributor",
    "RemoteLaunchError",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TPUTrainer",
    "TrainContext",
    "WorkerLostError",
    "ZeroDistributor",
    "all_env_vars",
    "get_context",
    "rederive_batch_split",
    "report",
    "run_elastic",
    "run_with_restarts",
    "simulated_survivor_probe",
    "ssh_connect",
]
