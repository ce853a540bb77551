"""Training: state, steps, optimizers, schedules and the Trainer."""

from tpuframe_torch.train.algorithms import (
    Algorithm,
    ChannelsLast,
    CutMix,
    LabelSmoothing,
    MixUp,
    apply_algorithms,
    resolve_algorithms,
)
from tpuframe_torch.train.callbacks import Callback, EarlyStopping, ProgressLogger
from tpuframe_torch.train.duration import Duration
from tpuframe_torch.train.optim import OptimizerSpec, make_optimizer, optimizer_from_config
from tpuframe_torch.train.schedules import (
    cosine_annealing,
    step_decay,
    warmup_cosine,
    warmup_decay_lr,
    warmup_lr,
)
from tpuframe_torch.train.schedules import from_config as schedule_from_config
from tpuframe_torch.train.state import TrainState, create_train_state, param_count
from tpuframe_torch.train.step import (
    cross_entropy,
    make_eval_step,
    make_grad_accum_step,
    make_predict_fn,
    make_train_step,
    merge_metrics,
    summarize_metrics,
)
from tpuframe_torch.train.trainer import FitResult, Trainer

__all__ = [
    "Algorithm",
    "Callback",
    "ChannelsLast",
    "CutMix",
    "Duration",
    "EarlyStopping",
    "FitResult",
    "LabelSmoothing",
    "MixUp",
    "OptimizerSpec",
    "ProgressLogger",
    "TrainState",
    "Trainer",
    "apply_algorithms",
    "cosine_annealing",
    "create_train_state",
    "cross_entropy",
    "make_eval_step",
    "make_grad_accum_step",
    "make_optimizer",
    "make_predict_fn",
    "make_train_step",
    "merge_metrics",
    "optimizer_from_config",
    "param_count",
    "resolve_algorithms",
    "schedule_from_config",
    "step_decay",
    "summarize_metrics",
    "warmup_cosine",
    "warmup_decay_lr",
    "warmup_lr",
]
