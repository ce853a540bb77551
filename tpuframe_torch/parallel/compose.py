"""Plan composition: one declaration, one ``ParallelPlan``.

Port of ``tpuframe/parallel/compose.py``.  :func:`compose` builds the mesh
``pipe x data x fsdp x seq x model`` (or checks a given one against the
declared sizes, loudly) and returns a plain :class:`~tpuframe_torch.
parallel.sharding.ParallelPlan` whose rules place the vocab-parallel
embedding and head on ``model`` (:func:`default_tp_rules`) and the
layer-stacked pipeline blocks on ``pipe`` (:func:`pipeline_rules`), with
the pipeline pins resolved from the env into the plan, so its signature
names the program that runs and equals the JAX package's for the same
declaration.  One ``parallel/compose`` event carries the resolved sizes and
the signature.

What the port does not run yet raises at the step that would run it: a
``seq`` axis above 1 beside ``model`` or ``pipe`` above 1
(``MeshSpec.build``), and ZeRO, the compressed wire or offload beside
``model``, ``pipe`` or ``seq`` above 1 (``train.state.create_train_state``
and the train step): the rest of Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Sequence

from tpuframe_torch.core.runtime import (
    DATA_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    Mesh,
    MeshSpec,
    process_count,
)
from tpuframe_torch.parallel.comms_env import (
    offload_optimizer_default,
    pp_microbatches,
    pp_schedule,
    tp_size,
    zero_stage_default,
)
from tpuframe_torch.parallel.sharding import ParallelPlan, Rule, mesh_axes

__all__ = ["compose", "default_tp_rules", "pipeline_rules"]


def default_tp_rules(axis: str = MODEL_AXIS) -> tuple[Rule, ...]:
    """Vocab-parallel rules for the pipelined LM: the embedding table split
    on its vocabulary rows and the untied head on its vocabulary columns
    over ``axis``.  The blocks are not matched: inside the pipeline they
    are split over ``pipe`` and replicated over ``model``."""
    return (
        (r"embed_head/embed/embedding$", (axis, None)),
        (r"embed_head/lm_head/kernel$", (None, axis)),
    )


def pipeline_rules(axis: str = PIPELINE_AXIS) -> tuple[Rule, ...]:
    """The stage rule of the layer-stacked pipeline blocks: their leading
    (layer) dim over ``axis``."""
    return ((r"(^|/)blocks/", (axis,)),)


def compose(*, mesh: Mesh | None = None, dp: int = -1, fsdp: int = 1, tp: int | None = None,
            pp: int = 1, sp: int = 1, zero_stage: int | None = None,
            microbatches: int | None = None, schedule: str | None = None,
            rules: Sequence[Rule] = (), min_shard_elems: int = 2**14,
            offload_optimizer: bool | None = None, comms_groups: int | None = None,
            comms_fused: bool | None = None, devices: Any = None) -> ParallelPlan:
    """Declare "DP x ZeRO x TP x PP x SP over this topology"; get one plan.

    Args (the JAX function's):
      mesh: a built mesh to compose over; None builds ``MeshSpec(pipe=pp,
        data=dp, fsdp=fsdp, seq=sp, model=tp)`` over ``devices`` (a count or
        a sequence of ranks; default: the process count).  A given mesh must
        agree with the declared sizes (``ValueError``).
      dp / fsdp / tp / pp / sp: axis sizes (``dp=-1`` takes the rest;
        ``tp=None`` reads ``TPUFRAME_TP_SIZE``).
      zero_stage / offload_optimizer: None reads ``TPUFRAME_ZERO_STAGE`` /
        ``TPUFRAME_OFFLOAD_OPTIMIZER``.
      microbatches / schedule: the pipeline pins (None reads
        ``TPUFRAME_PP_MICROBATCHES`` / ``TPUFRAME_PP_SCHEDULE``), kept on the
        plan only where ``pp > 1``.
      rules: the caller's rules, matched before the derived ones.
    """
    from tpuframe_torch.track.telemetry import get_telemetry

    if tp is None:
        tp = tp_size()
    if zero_stage is None:
        zero_stage = zero_stage_default()
    if offload_optimizer is None:
        offload_optimizer = offload_optimizer_default()
    if mesh is None:
        mesh = MeshSpec(pipe=pp, data=dp, fsdp=fsdp, seq=sp, model=tp).build(
            process_count() if devices is None else devices)
    axes = mesh_axes(mesh)
    declared = {PIPELINE_AXIS: pp, FSDP_AXIS: fsdp, MODEL_AXIS: tp, SEQUENCE_AXIS: sp}
    if dp != -1:
        declared[DATA_AXIS] = dp
    mismatch = {name: (size, axes.get(name, 1)) for name, size in declared.items()
                if size != -1 and axes.get(name, 1) != size}
    if mismatch:
        raise ValueError(
            "composed dimensions disagree with the mesh: "
            + ", ".join(f"{name}={want} declared but mesh has {have}"
                        for name, (want, have) in sorted(mismatch.items()))
            + " — pass a matching mesh or let compose() build one")
    pp = int(axes.get(PIPELINE_AXIS, 1))
    tp = int(axes.get(MODEL_AXIS, 1))
    composed: list[Rule] = list(rules)
    if tp > 1:
        composed.extend(default_tp_rules())
    if pp > 1:
        composed.extend(pipeline_rules())
    if microbatches is None:
        microbatches = pp_microbatches() or None
    if schedule is None:
        schedule = pp_schedule()
    plan = ParallelPlan(
        mesh=mesh, zero_stage=zero_stage, rules=tuple(composed),
        min_shard_elems=min_shard_elems, offload_optimizer=offload_optimizer,
        comms_groups=comms_groups, comms_fused=comms_fused,
        # the pins exist only where there is a pipeline, so a pp=1 plan's
        # signature is that of every plan over the same mesh
        pp_microbatches=microbatches if pp > 1 else None,
        pp_schedule=schedule if pp > 1 else None)
    get_telemetry().event(
        "parallel/compose", mesh_axes=axes, world=int(mesh.devices.size),
        dp=int(axes.get(DATA_AXIS, 1)), fsdp=int(axes.get(FSDP_AXIS, 1)), tp=tp, pp=pp,
        sp=int(axes.get(SEQUENCE_AXIS, 1)), zero_stage=int(zero_stage),
        microbatches=plan.pp_microbatches, schedule=plan.pp_schedule, rules=len(composed),
        signature=plan.signature())
    return plan
