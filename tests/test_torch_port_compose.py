"""Plan composition (``tpuframe_torch.parallel.compose``), the cases of
``tests/test_compose.py`` held against the JAX package: the same
declaration over the same mesh gives the same rules, pins and
``signature()`` digest, byte for byte.  The port's mesh is built over a
count of ranks (``devices=8``, the eight virtual devices of
``conftest.py`` on the JAX side); no process group is needed to compose.
"""

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
from tpuframe.parallel import ParallelPlan as JaxPlan
from tpuframe.parallel.compose import compose as jax_compose
from tpuframe.parallel.sharding import spec_to_json as jax_spec_to_json
from tpuframe_torch.core import MeshSpec
from tpuframe_torch.parallel import ParallelPlan, spec_from_json, spec_to_json
from tpuframe_torch.parallel.comms_env import (
    COMMS_ENV_DOMAINS,
    COMMS_ENV_VARS,
    PP_SCHEDULE_CHOICES,
    pp_microbatches,
    pp_schedule,
    tp_size,
)
from tpuframe_torch.parallel.compose import compose, default_tp_rules, pipeline_rules
from tpuframe_torch.track.telemetry import get_telemetry

CASES = [dict(), dict(tp=2), dict(pp=2), dict(tp=2, pp=2), dict(tp=2, pp=2, zero_stage=3,
                                                                 microbatches=8),
         dict(pp=2, microbatches=4, schedule="barriered"), dict(tp=4, fsdp=2),
         dict(pp=2, schedule="1f1b", rules=((r"mlp_in/kernel", (None, "model")),))]


def _jax_rules(rules):
    return tuple((p, JP(*s)) for p, s in rules)


@pytest.mark.parametrize("kw", CASES, ids=[str(sorted(k)) for k in CASES])
def test_signature_is_jax_digest(kw):
    jkw = dict(kw)
    if "rules" in jkw:
        jkw["rules"] = _jax_rules(jkw["rules"])
    port, want = compose(devices=8, **kw), jax_compose(**jkw)
    assert port.signature() == want.signature()
    assert [(p, spec_to_json(s)) for p, s in port.rules] == \
        [(p, jax_spec_to_json(s)) for p, s in want.rules]
    assert (port.pp_microbatches, port.pp_schedule) == (want.pp_microbatches, want.pp_schedule)
    assert port.describe_topology() == want.describe_topology()
    assert port.comms_schedule() == want.comms_schedule()


def test_dp_only_matches_hand_built_plan():
    plan = compose(devices=8)
    assert plan.signature() == ParallelPlan(mesh=MeshSpec(data=-1).build(8)).signature()
    assert plan.pp_microbatches is None and plan.pp_schedule is None


def test_nd_composition_builds_the_declared_mesh():
    plan = compose(tp=2, pp=2, zero_stage=3, microbatches=8, devices=8)
    topo = plan.describe_topology()
    assert (topo["pipeline_stages"], topo["tp_size"], topo["zero_stage"]) == (2, 2, 3)
    assert plan.pp_microbatches == 8
    assert plan.rules == default_tp_rules() + pipeline_rules()


def test_pp_pins_ride_the_signature():
    a = compose(pp=2, microbatches=4, devices=8)
    b = compose(pp=2, microbatches=8, devices=8)
    c = compose(pp=2, microbatches=4, schedule="barriered", devices=8)
    assert len({a.signature(), b.signature(), c.signature()}) == 3
    d = compose(microbatches=8, devices=8)
    assert d.pp_microbatches is None and d.pp_schedule is None


def test_mesh_dimension_mismatch_is_loud():
    with pytest.raises(ValueError, match="composed dimensions disagree with the mesh"):
        compose(mesh=MeshSpec(data=-1).build(8), tp=4)


def test_user_rules_win_over_derived():
    mine = (r"embed_head/embed/embedding$", (None, "model"))
    plan = compose(tp=2, pp=2, rules=(mine,), devices=8)
    assert plan.param_spec("embed_head/embed/embedding", (64, 16)) == (None, "model")
    jplan = jax_compose(tp=2, pp=2, rules=((mine[0], JP(None, "model")),))
    assert plan.signature() == jplan.signature()


def test_compose_event_carries_signature():
    tele = get_telemetry()
    tele.event("test/mark", token="port-compose-ev")
    plan = compose(tp=2, pp=2, devices=8)
    events = tele.recent_events(10**6)
    idx = max(i for i, e in enumerate(events)
              if e.get("name") == "test/mark" and e.get("token") == "port-compose-ev")
    ev = [e for e in events[idx:] if e.get("name") == "parallel/compose"]
    assert len(ev) == 1 and ev[0]["signature"] == plan.signature()
    assert (ev[0]["tp"], ev[0]["pp"], ev[0]["dp"], ev[0]["world"]) == (2, 2, 2, 8)
    assert ev[0]["rules"] == 3 and ev[0]["mesh_axes"]["model"] == 2
    assert set(ev[0]) >= {"fsdp", "sp", "zero_stage", "microbatches", "schedule"}


def test_rebind_carries_pipeline_pins():
    plan = compose(pp=2, microbatches=4, schedule="1f1b", devices=8)
    small = plan.rebind(MeshSpec(pipe=2, data=2).build(4))
    assert small.pp_microbatches == 4 and small.pp_schedule == "1f1b"
    jsmall = jax_compose(pp=2, microbatches=4, schedule="1f1b").rebind(
        JaxMeshSpec(pipe=2, data=2).build(jax.devices()[:4]))
    assert small.signature() == jsmall.signature()


def test_plan_validates_pp_fields():
    mesh = MeshSpec(data=-1).build(8)
    with pytest.raises(ValueError, match="pp_microbatches"):
        ParallelPlan(mesh=mesh, pp_microbatches=0)
    with pytest.raises(ValueError, match="pp_schedule"):
        ParallelPlan(mesh=mesh, pp_schedule="gpipe")
    # sequence parallelism is ported (Queue 1 item 8); beside tensor
    # parallelism it is the rest of item 7
    assert compose(sp=2, devices=8).signature() == jax_compose(sp=2).signature()
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        compose(sp=2, tp=2, devices=8)


def test_spec_json_round_trips_as_jax():
    for spec in [(), (None, "model"), (("data", "fsdp"), None), ("pipe",)]:
        assert spec_to_json(spec) == jax_spec_to_json(JP(*spec))
        assert spec_from_json(spec_to_json(spec)) == spec


def test_plan_param_spec_maps_flax_dims_to_torch():
    plan = ParallelPlan(mesh=MeshSpec(data=1, model=2).build(2),
                        rules=((r"query/kernel", (None, "model")),
                               (r"patch_embed/kernel", (None, None, None, "model"))))
    jplan = JaxPlan(mesh=JaxMeshSpec(data=1, model=2).build(jax.devices()[:2]),
                    rules=_jax_rules(plan.rules))
    assert plan.signature() == jplan.signature()
    # a Dense kernel (in, out) is the torch weight (out, in); HWIO is OIHW
    assert plan.param_spec("a/query/kernel", (8, 4), (1, 0)) == ("model",)
    assert plan.param_spec("a/query/kernel", (4, 8)) == (None, "model")
    assert plan.param_spec("patch_embed/kernel", (6, 3, 2, 2), (2, 3, 1, 0)) == ("model",)


class TestKnobs:
    def test_registry_rows(self):
        for knob in ("TPUFRAME_PP_MICROBATCHES", "TPUFRAME_PP_SCHEDULE", "TPUFRAME_TP_SIZE"):
            assert knob in COMMS_ENV_VARS and knob in COMMS_ENV_DOMAINS
        from tpuframe.parallel.comms_env import COMMS_ENV_DOMAINS as JAX_DOMAINS

        for knob, domain in COMMS_ENV_DOMAINS.items():
            assert domain == JAX_DOMAINS[knob], knob

    def test_env_resolution_into_compose(self, monkeypatch):
        monkeypatch.setenv("TPUFRAME_PP_MICROBATCHES", "16")
        monkeypatch.setenv("TPUFRAME_PP_SCHEDULE", "barriered")
        plan = compose(pp=2, devices=8)
        assert (plan.pp_microbatches, plan.pp_schedule) == (16, "barriered")
        assert plan.signature() == jax_compose(pp=2).signature()

    def test_readers_are_tolerant(self):
        from tpuframe.parallel import comms_env as jax_env

        cases = [{"TPUFRAME_PP_MICROBATCHES": "junk"}, {"TPUFRAME_PP_MICROBATCHES": "999999"},
                 {"TPUFRAME_PP_SCHEDULE": "nope"}, {}, {"TPUFRAME_TP_SIZE": "0"},
                 {"TPUFRAME_TP_SIZE": "4"}, {"TPUFRAME_PP_SCHEDULE": "1F1B"}]
        for env in cases:
            assert pp_microbatches(env) == jax_env.pp_microbatches(env)
            assert pp_schedule(env) == jax_env.pp_schedule(env)
            assert tp_size(env) == jax_env.tp_size(env)
        assert PP_SCHEDULE_CHOICES == jax_env.PP_SCHEDULE_CHOICES

    def test_tp_env_fills_compose_default(self, monkeypatch):
        monkeypatch.setenv("TPUFRAME_TP_SIZE", "2")
        assert compose(pp=2, devices=8).describe_topology()["tp_size"] == 2
        assert compose(tp=1, pp=2, devices=8).describe_topology()["tp_size"] == 1


#: the flax shapes of a small pipelined LM (layer-stacked blocks) and of a
#: TP block: what the composed rules split
PLM_TEMPLATE = {
    "embed_head": {"embed": {"embedding": ((32768, 768), "float32")},
                   "pos_embed": {"embedding": ((1024, 768), "float32")},
                   "lm_head": {"kernel": ((768, 32768), "float32")}},
    "blocks": {"attn": {"query": {"kernel": ((12, 768, 768), "float32")}},
               "mlp_in": {"kernel": ((12, 768, 3072), "float32"),
                          "bias": ((12, 3072), "float32")}},
    "block0": {"attn": {"query": {"kernel": ((768, 768), "float32")}},
               "mlp_out": {"kernel": ((3072, 768), "float32")}},
}


@pytest.mark.parametrize("kw", [dict(tp=2, pp=2), dict(tp=4), dict(pp=2, microbatches=8),
                                dict(tp=2, pp=2, zero_stage=3)],
                         ids=["tp2_pp2", "tp4", "pp2_m8", "tp2_pp2_zero3"])
def test_plan_memory_prices_composed_plans_as_jax(kw):
    """``plan_memory`` and ``suggest_fit`` under composed TP/PP plans (and
    the transformer's own TP rules) return the JAX package's dicts."""
    from tpuframe.models.transformer import transformer_tp_rules as jax_lm_rules
    from tpuframe.parallel.memory import plan_memory as jax_plan_memory
    from tpuframe.parallel.memory import suggest_fit as jax_suggest_fit
    from tpuframe_torch.models import transformer_tp_rules
    from tpuframe_torch.parallel import plan_memory, suggest_fit

    port = compose(devices=8, rules=transformer_tp_rules(), **kw)
    want = jax_compose(rules=jax_lm_rules(), **kw)
    batch = {"input": ((16, 1024), "int32")}
    assert plan_memory(port, PLM_TEMPLATE, batch, optimizer="adamw") == \
        jax_plan_memory(want, PLM_TEMPLATE, batch, optimizer="adamw")
    assert suggest_fit(port, PLM_TEMPLATE, batch, budget_mb=400.0) == \
        jax_suggest_fit(want, PLM_TEMPLATE, batch, budget_mb=400.0)


@pytest.mark.parametrize("spec", [dict(pipe=2, data=1, model=2), dict(pipe=2, data=2, model=2),
                                  dict(data=2, model=4), dict(pipe=4, data=1, fsdp=2)],
                         ids=["pp2_tp2", "pp2_dp2_tp2", "dp2_tp4", "pp4_fsdp2"])
def test_mesh_coordinates_are_jax_device_ids(spec):
    """A rank's coordinates on the port's mesh are those of the JAX device
    with the same id under the same ``MeshSpec`` (``AXIS_ORDER``), and each
    axis's lines are the ranks JAX's mesh puts along it."""
    import numpy as np

    n = int(np.prod(list(spec.values())))
    jm = JaxMeshSpec(**spec).build(jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    tm = MeshSpec(**spec).build(n)
    np.testing.assert_array_equal(tm.devices, ids)
    for axis in ("pipe", "model"):
        moved = np.moveaxis(ids, jm.axis_names.index(axis), -1).reshape(-1, jm.shape[axis])
        assert tm.lines(axis) == moved.tolist()
