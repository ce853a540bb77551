"""The compressed gradient wire (``tpuframe_torch.parallel.compression``)
against the JAX package's, on the same numpy inputs.

- Layout: ``grad_layout``, ``comms_template``, ``_group_bounds`` and
  ``wire_plan`` equal JAX's for the same named tree.
- ``sync_gradients`` on two gloo ranks (spawned processes, ``FileStore``
  rendezvous) against JAX's ``sync_gradients`` under ``shard_map`` on a
  2-device mesh, each rank with its own gradient and residual: the means
  and the new residuals are bit-equal (int8 round half to even, one shot
  and 3 bucket groups, fp8, an inf gradient on one rank; integer leaves
  summed exactly).  The same float32 operations run in the same order on
  both sides, and the sums of the int32 (or e4m3-valued float32) payloads
  are exact.  JAX runs op by op here, as written: under ``jax.jit`` XLA
  turns a division by a constant (``/ 127``, ``/ 448``) into a
  multiplication by its float32 reciprocal and fuses ``v - q * deq`` into
  one multiply-add, which moves the scale and the residual by an ulp in
  some buckets; the port, like the JAX references and kernel tests,
  follows the expressions as written.
- A NaN gradient on one rank decodes to NaN in its bucket on every rank,
  and that bucket keeps no residual.  (XLA's CPU ``pmax`` drops the NaN, so
  JAX on the CPU decodes that bucket finite: the case is held to the
  contract, not to that run.)
- Stochastic rounding draws its uniforms once over all buckets, so 3 bucket
  groups give the one shot's bits (torch's generator, not JAX's: the port
  is held against itself here).
- Error feedback telescopes: the applied means plus the final residual
  equal the sum of the exact gradients (1e-4 relative, 1e-5 absolute, as
  the JAX test holds it).
- The plan features that are not ported raise ``NotImplementedError``; the
  fused transport's calls, which raised until it was ported, run on the two
  ranks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.core import MeshSpec, initialize
from tpuframe_torch.core.runtime import Mesh
from tpuframe_torch.parallel import ParallelPlan
from tpuframe_torch.parallel.compression import (
    CommsConfig,
    _group_bounds,
    comms_template,
    fused_active,
    grad_layout,
    init_comms_state,
    make_compressed_pmean,
    resolve_fused,
    sync_gradients,
    wire_plan,
)


def _mesh(world: int) -> Mesh:
    return MeshSpec(data=world).build(world)


def _tree(rank: int) -> dict:
    """A named gradient tree, different on every rank: leaves of several
    scales (so the buckets' scales differ), a scalar and an integer leaf."""
    rng = np.random.default_rng(100 + rank)
    f32 = np.float32
    return {
        "deep/w": (rng.standard_normal((8, 40, 17)) * 1.5).astype(f32),
        "mid/b": (rng.standard_normal((300,)) * 3e-4).astype(f32),
        "top/k": (rng.standard_normal((33, 7)) * 5).astype(f32),
        "a/scale": np.asarray(rng.standard_normal() * 0.1, f32),
        "step/count": rng.integers(0, 10, (3,)).astype(np.int32),
    }


#: (name, CommsConfig kwargs, residual on, poison): bucket_mb 0.001 gives
#: 23 buckets of 320 over the 5,972 float elements
CASES = [
    ("int8", dict(mode="int8", bucket_mb=0.001), True, False),
    ("int8_groups3", dict(mode="int8", bucket_mb=0.001, groups=3), True, False),
    ("int8_no_ef", dict(mode="int8", bucket_mb=0.001), False, False),
    ("fp8", dict(mode="fp8", bucket_mb=0.001), True, False),
    ("int8_inf", dict(mode="int8", bucket_mb=0.001), True, "inf"),
    ("int8_nan", dict(mode="int8", bucket_mb=0.001), True, "nan"),
]
#: the cases held bit-equal to JAX
JAX_CASES = [c[0] for c in CASES if c[0] != "int8_nan"]


#: where a poisoned gradient sits: bucket 0 for the inf (rank 1), bucket 17
#: for the NaN (rank 0; offset 5,749 of the sorted flat layout)
POISON = {"inf": (1, "deep/w", (0, 0, 0)), "nan": (0, "top/k", (1, 1))}


def _inputs(rank: int, residual: bool, poison: str | bool):
    """Rank ``rank``'s tree and residual row (all cases share the layout)."""
    tree = _tree(rank)
    if poison:
        where, leaf, idx = POISON[poison]
        if rank == where:
            tree[leaf][idx] = np.inf if poison == "inf" else np.nan
    resid = None
    if residual:
        layout = grad_layout({k: torch.from_numpy(v) for k, v in tree.items()},
                             CommsConfig(mode="int8", bucket_mb=0.001), None)
        rng = np.random.default_rng(200 + rank)
        resid = (rng.standard_normal((1, layout.n_buckets, layout.bucket_elems)) * 1e-3).astype(
            np.float32)
    return tree, resid


def _sync_worker(rank: int, world: int) -> dict:
    """Every case on this rank: {case: (synced, new residual)} as numpy; plus
    stochastic rounding in one shot and in 3 groups."""
    rt = initialize(device="cpu")
    plan = ParallelPlan(mesh=rt.mesh)
    out = {}
    for name, kw, residual, poison in CASES:
        tree, resid = _inputs(rank, residual, poison)
        config = CommsConfig(**kw)
        grads = {k: torch.from_numpy(v) for k, v in tree.items()}
        layout = grad_layout(grads, config, plan)
        comms = {} if resid is None else {"flat": torch.from_numpy(resid)}
        synced, new = sync_gradients(grads, comms, layout, config)
        out[name] = ({k: v.numpy() for k, v in synced.items()},
                     {k: v.numpy() for k, v in new.items()})
    for groups in (1, 3):
        config = CommsConfig(mode="int8", bucket_mb=0.001, groups=groups,
                             stochastic_rounding=True)
        grads = {k: torch.from_numpy(v) for k, v in _tree(rank).items()}
        layout = grad_layout(grads, config, plan)
        comms = init_comms_state(grads, plan, config)
        gen = torch.Generator().manual_seed(7 + rank)
        synced, new = sync_gradients(grads, comms, layout, config, gen)
        out[f"sr_groups{groups}"] = ({k: v.numpy() for k, v in synced.items()},
                                     {k: v.numpy() for k, v in new.items()})
    # the fused transport's calls, which ran only as refusals before it was ported
    fused_plan = ParallelPlan(mesh=rt.mesh, comms_fused=True)
    config = resolve_fused(fused_plan, CommsConfig())
    tree = {"w": torch.ones(10)}
    layout = grad_layout(tree, config, fused_plan)
    out["fused_calls"] = (fused_active(layout, config),
                          sync_gradients(tree, {}, layout, config)[0]["w"].numpy(),
                          make_compressed_pmean(fused_plan)(tree)[0]["w"].numpy())
    return out


@pytest.fixture(scope="module")
def port_ranks(tmp_path_factory):
    return run_ranks(_sync_worker, 2, tmp_path_factory.mktemp("sync"))


def _jax_sync(name: str):
    """JAX ``sync_gradients`` under ``shard_map`` on 2 CPU devices, rank r's
    tree and residual on device r: per-rank (synced, new residual)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.core.runtime import shard_map
    from tpuframe.parallel import ParallelPlan as JaxPlan
    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import grad_layout as jax_layout
    from tpuframe.parallel.compression import sync_gradients as jax_sync

    _, kw, residual, poison = next(c for c in CASES if c[0] == name)
    inputs = [_inputs(r, residual, poison) for r in range(2)]
    mesh = JaxMeshSpec(data=2).build(jax.devices()[:2])
    config = JaxConfig(**kw)
    layout = jax_layout({k: jnp.asarray(v) for k, v in inputs[0][0].items()}, config,
                        JaxPlan(mesh=mesh))
    stacked = {k: jnp.asarray(np.stack([t[k] for t, _ in inputs])) for k in inputs[0][0]}
    comms = {"flat": jnp.asarray(np.concatenate([r for _, r in inputs]))} if residual else {}

    def run(t, c):
        synced, new = jax_sync({k: v[0] for k, v in t.items()}, c, layout, config)
        return {k: v[None] for k, v in synced.items()}, new

    fn = shard_map(run, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")), check_vma=False)
    synced, new = fn(stacked, comms)
    return [({k: np.asarray(v[r]) for k, v in synced.items()},
             {k: np.asarray(v[r:r + 1]) for k, v in new.items()}) for r in range(2)]


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


@pytest.mark.parametrize("name", JAX_CASES)
def test_sync_gradients_on_two_ranks_is_bit_equal_to_jax(port_ranks, name):
    want = _jax_sync(name)
    for rank in range(2):
        got_synced, got_new = port_ranks[rank][name]
        want_synced, want_new = want[rank]
        assert set(got_synced) == set(want_synced) and set(got_new) == set(want_new)
        for k in want_synced:
            g, w = got_synced[k], want_synced[k]
            if name == "int8_inf":  # NaN payloads may differ: compare where, then the rest
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                g, w = np.where(np.isnan(g), 0, g), np.where(np.isnan(w), 0, w)
            assert _bits_equal(g, w), (name, rank, k)
        for k in want_new:
            assert _bits_equal(got_new[k], want_new[k]), (name, rank, k)
    # both ranks hold the same mean
    for k in port_ranks[0][name][0]:
        np.testing.assert_array_equal(port_ranks[0][name][0][k], port_ranks[1][name][0][k])


@pytest.mark.parametrize("poison,bucket", [("inf", 0), ("nan", 17)])
def test_nonfinite_gradients_decode_nan_in_their_bucket_on_every_rank(port_ranks, poison,
                                                                     bucket):
    tree = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    layout = grad_layout(tree, CommsConfig(mode="int8", bucket_mb=0.001), None)
    in_bucket = np.zeros(layout.padded_elems, bool)
    in_bucket[bucket * layout.bucket_elems:(bucket + 1) * layout.bucket_elems] = True
    for rank in range(2):
        synced, new = port_ranks[rank][f"int8_{poison}"]
        flat = np.full(layout.padded_elems, np.nan, np.float32)
        for path, shape, _, offset in layout.flat:
            flat[offset:offset + int(np.prod(shape))] = synced[path].ravel()
        nan = np.isnan(flat[:layout.flat_elems])
        np.testing.assert_array_equal(nan, in_bucket[:layout.flat_elems])
        resid = new["flat"].reshape(layout.n_buckets, layout.bucket_elems)
        assert not resid[bucket].any() and np.isfinite(resid).all()
        assert resid[bucket - 1 if bucket else 1].any()  # the others keep theirs
    exact = _tree(0)["step/count"] + _tree(1)["step/count"]
    np.testing.assert_array_equal(port_ranks[0]["int8"][0]["step/count"], exact)


def test_stochastic_rounding_groups_are_bit_equal_to_the_single_shot(port_ranks):
    for rank in range(2):
        one, three = port_ranks[rank]["sr_groups1"], port_ranks[rank]["sr_groups3"]
        for k in one[0]:
            assert _bits_equal(one[0][k], three[0][k]), (rank, k)
        assert _bits_equal(one[1]["flat"], three[1]["flat"])
    rne = port_ranks[0]["int8"][0]["deep/w"]
    assert not np.array_equal(port_ranks[0]["sr_groups1"][0]["deep/w"], rne)


# -- layout and accounting -----------------------------------------------------


def _jax_plan(world: int):
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.parallel import ParallelPlan as JaxPlan

    return JaxPlan(mesh=JaxMeshSpec(data=world).build(jax.devices()[:world]))


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("kw", [dict(mode="int8"), dict(mode="int8", bucket_mb=0.001),
                                dict(mode="fp8", bucket_mb=0.001, groups=3),
                                dict(mode="int8", bucket_mb=0.002, groups=40)],
                         ids=["default", "small_buckets", "fp8_groups3", "groups_clamped"])
def test_layout_template_and_wire_plan_equal_jax(world, kw):
    import jax.numpy as jnp

    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import comms_template as jax_template
    from tpuframe.parallel.compression import grad_layout as jax_layout
    from tpuframe.parallel.compression import wire_plan as jax_wire_plan

    tree = _tree(0)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jplan, tplan = _jax_plan(world), ParallelPlan(mesh=_mesh(world))
    jc, tc = JaxConfig(**kw), CommsConfig(**kw)
    want, got = jax_layout(jtree, jc, jplan), grad_layout(ttree, tc, tplan)
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert comms_template(ttree, tc, tplan) == jax_template(jtree, jc, jplan)
    assert wire_plan(got, tc) == jax_wire_plan(want, jc)
    assert wire_plan(got, tc, exact_bytes=12) == jax_wire_plan(want, jc, exact_bytes=12)
    assert tplan.comms_schedule(tc) == {
        k: v for k, v in jplan.comms_schedule(jc).items()}
    assert tplan.dp_size == jplan.dp_size == world


def test_group_bounds_equal_jax():
    from tpuframe.parallel.compression import _group_bounds as jax_bounds

    for n in (0, 1, 5, 25, 64):
        for g in (1, 2, 3, 7, 100):
            assert _group_bounds(n, g) == jax_bounds(n, g), (n, g)


def test_comms_config_reads_the_same_env_as_jax(monkeypatch):
    from tpuframe.parallel.comms_env import CommsConfig as JaxConfig

    assert CommsConfig.from_env() is None and JaxConfig.from_env() is None
    for env in ({"TPUFRAME_COMMS_COMPRESSION": "fp8", "TPUFRAME_COMMS_BUCKET_MB": "0.5",
                 "TPUFRAME_COMMS_STOCHASTIC": "1", "TPUFRAME_COMMS_EF": "0",
                 "TPUFRAME_COMMS_GROUPS": "4", "TPUFRAME_COMMS_FUSED": "yes"},
                {"TPUFRAME_COMMS_COMPRESSION": "INT8", "TPUFRAME_COMMS_BUCKET_MB": "x",
                 "TPUFRAME_COMMS_GROUPS": "-3"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert dataclasses.asdict(CommsConfig.from_env()) == dataclasses.asdict(
            JaxConfig.from_env())
        for k in env:
            monkeypatch.delenv(k)
    assert CommsConfig.from_env("fp8").mode == "fp8"
    with pytest.raises(ValueError, match="unknown grad_compression"):
        CommsConfig.from_env("int4")


def test_init_comms_state_holds_one_zero_row_a_rank():
    ttree = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    config = CommsConfig(mode="int8", bucket_mb=0.001)
    comms = init_comms_state(ttree, ParallelPlan(mesh=_mesh(2)), config)
    assert set(comms) == {"flat"} and comms["flat"].shape == (1, 23, 320)
    assert comms["flat"].dtype == torch.float32 and not comms["flat"].any()
    assert init_comms_state(ttree, None, CommsConfig(error_feedback=False)) == {}
    assert comms_template(ttree, None, ParallelPlan(mesh=_mesh(2))) == {}


def test_plan_shard_batch_moves_this_process_batch_to_its_device():
    plan = ParallelPlan(mesh=_mesh(2))
    batch = {"image": np.arange(48, dtype=np.uint8).reshape(4, 2, 2, 3), "label": np.arange(4)}
    out = plan.shard_batch(batch, device="cpu")
    assert set(out) == {"image", "label"}
    assert out["image"].dtype == torch.uint8 and out["image"].device.type == "cpu"
    np.testing.assert_array_equal(out["image"].numpy(), batch["image"])
    assert out["label"].tolist() == [0, 1, 2, 3]


def test_error_feedback_telescopes():
    """Applied means plus the final residual equal the exact gradient sum
    (one rank, no process group: the wire is the identity, the kernels'
    plain versions run)."""
    plan = ParallelPlan(mesh=_mesh(1))
    config = CommsConfig(mode="int8", bucket_mb=0.001)
    fn = make_compressed_pmean(plan, config)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(65).astype(np.float32)) * 0.02
    tree = {"g": g}
    residual = init_comms_state(tree, plan, config)
    applied = torch.zeros(65)
    for _ in range(20):
        out, residual = fn(tree, residual)
        applied += out["g"]
    drift = residual["flat"].ravel()[:65]
    np.testing.assert_allclose((applied + drift).numpy(), (20 * g).numpy(), rtol=1e-4, atol=1e-5)


def test_world_one_wire_meters_no_bytes_and_leaves_gradients_quantized():
    from tpuframe_torch.track.telemetry import get_telemetry

    plan = ParallelPlan(mesh=_mesh(1))
    fn = make_compressed_pmean(plan, "int8")
    tree = {"w": torch.linspace(-1, 1, 300)}
    tele = get_telemetry()
    before = (tele.registry.counter("comms/bytes_on_wire").value,
              tele.registry.histogram("comms/allreduce_s").count)
    out, resid = fn(tree, {})
    assert resid == {}
    assert tele.registry.counter("comms/bytes_on_wire").value == before[0]
    assert tele.registry.histogram("comms/allreduce_s").count == before[1] + 1
    # one bucket, amax 1: the mean is the value on the int8 grid
    torch.testing.assert_close(out["w"], torch.round(tree["w"] * 127) / 127, rtol=0, atol=1e-7)


def test_what_is_not_ported_raises(port_ranks):
    mesh2 = _mesh(2)
    # tensor-parallel rules are ported; the compressed wire beside the model
    # axis is not (a later part of Queue 1 item 7)
    from tpuframe_torch.train import make_train_step

    rules = ((r"mlp_in/kernel", (None, "model")),)
    tp = ParallelPlan(mesh=MeshSpec(data=1, model=2).build(2), rules=rules)
    assert tp.rules == rules and tp.split_axes == ("model",)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(plan=tp, grad_compression="int8")
    # ZeRO is ported: every stage builds, and offload builds (on the CPU it
    # warns and stays on the device, as JAX's does off a host memory space)
    for stage in (1, 2, 3):
        assert ParallelPlan(mesh=mesh2, zero_stage=stage).zero_stage == stage
    with pytest.warns(UserWarning, match="downgrading"):
        assert ParallelPlan(mesh=mesh2, zero_stage=3, offload_optimizer=True).offload_optimizer
    with pytest.raises(ValueError, match="zero_stage"):
        ParallelPlan(mesh=mesh2, zero_stage=4)
    assert MeshSpec(data=2, model=2).build(4).shape["model"] == 2  # the TP axis is ported
    sp = ParallelPlan(mesh=MeshSpec(data=2, seq=2).build(4))  # and the seq axis
    assert sp.token_size == 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # but not the wire beside it
        make_train_step(plan=sp, grad_compression="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # nor seq beside model
        MeshSpec(seq=2, model=2).build(4)
    assert MeshSpec(data=1, fsdp=2).build(2).shape["fsdp"] == 2
    assert MeshSpec().build(3).shape["data"] == 3
    # the fused transport, where it engages (world >= 2), is ported: the same
    # calls run on two ranks (the module's spawn) and give the staged mean
    config = resolve_fused(ParallelPlan(mesh=mesh2, comms_fused=True), CommsConfig())
    tree = {"w": torch.ones(10)}
    layout = grad_layout(tree, config, ParallelPlan(mesh=mesh2))
    assert fused_active(layout, config)
    for rank in range(2):
        active, synced, measured = port_ranks[rank]["fused_calls"]
        assert active
        np.testing.assert_array_equal(synced, np.ones(10, np.float32))
        np.testing.assert_array_equal(measured, np.ones(10, np.float32))
    # at world 1 the fused knob is inert, as in JAX
    one = grad_layout(tree, config, ParallelPlan(mesh=_mesh(1)))
    assert not fused_active(one, config)


def test_initialize_refuses_a_half_named_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    for name in ("MASTER_ADDR", "TPUFRAME_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="rendezvous"):
        initialize(device="cpu")
