"""The fused transport of the compressed wire and ``quantized_pmean``
(``tpuframe_torch.parallel.compression``) against the JAX package's, on
the same numpy inputs.

One spawn of gloo ranks a world size (2, 3 and 4; ``tests/torch_ranks.py``)
runs every case of that world; the JAX side runs in this process under
``shard_map`` on the virtual CPU devices, op by op as in
``test_torch_port_compression.py``.

- Each form of ``_fused_allreduce`` (``ring``, ``concurrent``, ``single``)
  and the staged all-reduce, on int32-held int8-grid and float32-held
  e4m3-grid payloads (one column -0.0 on every rank), equal JAX's
  ``_fused_allreduce(q, "data", W, form=...)`` bit for bit, the sign of a
  zero included; so do ``_reduce_scatter_chunks`` and
  ``_all_gather_chunks`` in each form.  World 3 pads the last chunk.
- ``sync_gradients`` through the fused transport (each form forced through
  ``_form_default``) equals the port's staged run at every world, and
  JAX's at world 2, bit for bit, for int8 round half to even, int8
  stochastic (JAX's uniforms handed to the port) and fp8, with error
  feedback on and off; a NaN on one rank decodes to NaN in its bucket on
  every rank in every form.
- The sign of a zero sum: an fp8 element whose every contribution
  underflows to -0.0 sums to +0.0 as JAX's ``psum`` does (gloo's sum keeps
  -0.0; the port makes a zero total +0.0, ``_canonical_zero``).
- ``make_compressed_pmean`` through the fused transport opens one
  ``comms/fused_hop`` span (hops, world, mode) inside ``comms/allreduce``
  and meters the staged run's bytes.
- ``quantized_pmean`` within 1e-6 of JAX's, its integer leaves exact
  (narrow ones widened for the sum and cast back), zero gradients zero.
- World 1, the fp8 bound (world 74) and a layout over two axes leave
  ``fused_active`` false, as in JAX; at world 1 every form is the
  identity.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.core import MeshSpec, initialize
from tpuframe_torch.parallel import CommsConfig, ParallelPlan, quantized_pmean
from tpuframe_torch.parallel import compression as C
from tpuframe_torch.track.telemetry import get_telemetry

FORMS = ("ring", "concurrent", "single")
WORLDS = (2, 3, 4)
#: 1,000 elements: chunks of 500 and 250 at world 2 and 4, 334 (padded) at 3
PAYLOAD_SHAPE = (8, 125)
CHUNK_ELEMS = 50  # each rank's chunk of the reduce-scatter and all-gather cases


def _payload(kind: str, rank: int) -> np.ndarray:
    """Rank ``rank``'s encoded payload: int8-grid values held in int32, or
    e4m3-grid values held in float32 with column 0 at -0.0."""
    rng = np.random.default_rng(300 + rank)
    if kind == "int8":
        return rng.integers(-127, 128, PAYLOAD_SHAPE).astype(np.int32)
    x = torch.from_numpy((rng.standard_normal(PAYLOAD_SHAPE) * 40).astype(np.float32))
    x = x.to(torch.float8_e4m3fn).to(torch.float32).numpy()
    x[:, 0] = -0.0
    return x


def _chunks(kind: str, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s (world, CHUNK_ELEMS) contribution to the
    reduce-scatter (the first rows of a payload of another seed)."""
    return _payload(kind, 50 + rank).reshape(-1)[:world * CHUNK_ELEMS].reshape(
        world, CHUNK_ELEMS).copy()


def _tree(rank: int) -> dict:
    """A named gradient tree, different on every rank (the compression
    test's leaves), with a tiny negative value at ``mid/b[0]`` on every rank:
    under fp8 its bucket's scale makes every contribution -0.0."""
    rng = np.random.default_rng(100 + rank)
    f32 = np.float32
    tree = {
        "deep/w": (rng.standard_normal((8, 40, 17)) * 1.5).astype(f32),
        "mid/b": (rng.standard_normal((300,)) * 3e-4).astype(f32),
        "top/k": (rng.standard_normal((33, 7)) * 5).astype(f32),
        "a/scale": np.asarray(rng.standard_normal() * 0.1, f32),
        "step/count": rng.integers(0, 10, (3,)).astype(np.int32),
    }
    tree["mid/b"][0] = -1e-30
    return tree


#: (name, CommsConfig kwargs, residual on, stochastic noise): bucket_mb
#: 0.001 gives 23 buckets of 320 over the 5,972 float elements, in 3 groups
SYNC_CASES = [
    ("int8", dict(mode="int8", bucket_mb=0.001, groups=3), True, False),
    ("int8_no_ef", dict(mode="int8", bucket_mb=0.001, groups=3), False, False),
    ("int8_stochastic", dict(mode="int8", bucket_mb=0.001, groups=3,
                             stochastic_rounding=True), True, True),
    ("fp8", dict(mode="fp8", bucket_mb=0.001, groups=3), True, False),
    ("fp8_no_ef", dict(mode="fp8", bucket_mb=0.001, groups=3), False, False),
]
#: the layout's shape for _tree under those configs
N_BUCKETS, BUCKET_ELEMS = 23, 320
#: where the NaN case poisons rank 1's tree: bucket 0
POISON = ("deep/w", (0, 0, 0))


def _residual(rank: int) -> np.ndarray:
    rng = np.random.default_rng(200 + rank)
    return (rng.standard_normal((1, N_BUCKETS, BUCKET_ELEMS)) * 1e-3).astype(np.float32)


def _jax_noise() -> np.ndarray:
    """The uniforms JAX's ``sync_gradients`` draws for stochastic rounding
    from ``PRNGKey(5)`` (its ``fold_in(rng, 0)``), handed to the port."""
    import jax

    return np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(5), 0),
                                         (N_BUCKETS, BUCKET_ELEMS)))


def _np(tree: dict) -> dict:
    return {k: v.numpy().copy() for k, v in tree.items()}


def _port_sync(rank: int, plan, kw: dict, residual: bool, noise, fused: bool,
               poison: bool = False) -> tuple:
    """``sync_gradients`` of this rank's tree; stochastic rounding draws
    ``noise`` (torch.rand patched for the call)."""
    tree = _tree(rank)
    if poison and rank == 1:
        tree[POISON[0]][POISON[1]] = np.nan
    grads = {k: torch.from_numpy(v) for k, v in tree.items()}
    config = C.CommsConfig(**kw, fused=fused)
    layout = C.grad_layout(grads, config, plan)
    assert (layout.n_buckets, layout.bucket_elems) == (N_BUCKETS, BUCKET_ELEMS)
    assert C.fused_active(layout, config) == fused
    comms = {"flat": torch.from_numpy(_residual(rank))} if residual else {}
    rng, draws = None, contextlib.nullcontext()
    if noise is not None:
        rng = torch.Generator().manual_seed(0)
        draws = mock.patch.object(torch, "rand", lambda *a, **k: torch.from_numpy(noise.copy()))
    with draws:
        synced, new = C.sync_gradients(grads, comms, layout, config, rng)
    return _np(synced), _np(new)


def _ranks_worker(rank: int, world: int, noise: np.ndarray) -> dict:
    """Every case of this world on this rank."""
    rt = initialize(device="cpu")
    plan = ParallelPlan(mesh=rt.mesh)
    out = {"backend": C._form_default()}
    # the transport's parts on encoded payloads
    for kind in ("int8", "fp8"):
        q = torch.from_numpy(_payload(kind, rank))
        out[("allreduce", kind, "staged")] = C._all_reduce_sum(q.clone()).numpy()
        own = torch.from_numpy(_chunks(kind, rank, world))
        for form in FORMS:
            out[("allreduce", kind, form)] = C._fused_allreduce(q, world, form=form).numpy()
            mine = C._reduce_scatter_chunks(own.clone(), form)
            out[("reduce_scatter", kind, form)] = mine.numpy().copy()
            out[("all_gather", kind, form)] = C._all_gather_chunks(mine, world, form).numpy()
        assert torch.equal(q, torch.from_numpy(_payload(kind, rank)))  # q left as it was
    # sync_gradients: staged, then fused in each form
    for name, kw, residual, sr in SYNC_CASES:
        nz = noise if sr else None
        out[("sync", name, "staged")] = _port_sync(rank, plan, kw, residual, nz, False)
        for form in FORMS:
            with mock.patch.object(C, "_form_default", lambda f=form: f):
                out[("sync", name, form)] = _port_sync(rank, plan, kw, residual, nz, True)
    kw = dict(mode="int8", bucket_mb=0.001, groups=3)
    out[("nan", "staged")] = _port_sync(rank, plan, kw, True, None, False, poison=True)
    for form in FORMS:
        with mock.patch.object(C, "_form_default", lambda f=form: f):
            out[("nan", form)] = _port_sync(rank, plan, kw, True, None, True, poison=True)
    if world == 2:
        out.update(_telemetry_case(rt))
        out.update(_quantized_pmean_case(rank))
    return out


def _telemetry_case(rt) -> dict:
    """``make_compressed_pmean`` staged and fused: the spans and bytes."""
    tele = get_telemetry()
    tree = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    out = {}
    for fused in (False, True):
        pmean = C.make_compressed_pmean(ParallelPlan(mesh=rt.mesh, comms_fused=fused),
                                        CommsConfig(mode="int8", bucket_mb=0.001))
        before = tele.registry.counter("comms/bytes_on_wire").value
        tele.event("test/mark", fused=fused)
        mean, _ = pmean(tree)
        events = tele.recent_events(10**6)
        mark = max(i for i, e in enumerate(events) if e.get("name") == "test/mark")
        spans = [(e["name"], e["stack"], e.get("attrs", {})) for e in events[mark + 1:]
                 if e.get("kind") == "span"]
        out[("telemetry", fused)] = {
            "spans": spans, "bytes": tele.registry.counter("comms/bytes_on_wire").value - before,
            "mean": _np(mean)}
    return out


def _qp_tree(rank: int) -> dict:
    rng = np.random.default_rng(400 + rank)
    return {"big": (rng.standard_normal(64) * 50).astype(np.float32),
            "small": (rng.standard_normal(32) * 1e-4).astype(np.float32),
            "nested": {"k": (rng.standard_normal((3, 5)) * 2).astype(np.float32)},
            "count": np.ones((1,), np.int32),
            "c8": np.full((4,), 127, np.int8), "c16": np.full((4,), 32000, np.int16),
            "c32": np.full((4,), 127, np.int32), "zero": np.zeros(16, np.float32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _quantized_pmean_case(rank: int) -> dict:
    out = {"qp": _numpy_tree(quantized_pmean(_torch_tree(_qp_tree(rank)), ("data",)))}
    poisoned = {"g": torch.tensor([1.0, float("nan") if rank else 2.0, 3.0])}
    out["qp_nan"] = quantized_pmean(poisoned, "data")["g"].numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    noise = _jax_noise()
    return {w: run_ranks(_ranks_worker, w, tmp_path_factory.mktemp(f"fused{w}"), noise,
                         timeout=300)
            for w in WORLDS}


# -- the JAX side ----------------------------------------------------------------


def _jax_mesh(world: int):
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec

    return JaxMeshSpec(data=world).build(jax.devices()[:world])


def _jax_per_rank(fn, stacked, world: int):
    """``fn`` (one rank's input -> output) under ``shard_map`` over
    ``world`` devices, eagerly; the per-rank outputs as numpy."""
    from jax.sharding import PartitionSpec as P

    from tpuframe.core.runtime import shard_map

    run = shard_map(lambda t: fn(t[0])[None], mesh=_jax_mesh(world), in_specs=P("data"),
                    out_specs=P("data"), check_vma=False)
    got = np.asarray(run(stacked))
    return [got[r] for r in range(world)]


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_fused_allreduce_forms_equal_jax_bit_for_bit(ranks, world, kind):
    import jax.numpy as jnp

    from tpuframe.parallel.compression import _fused_allreduce as jax_fused

    stacked = jnp.asarray(np.stack([_payload(kind, r) for r in range(world)]))
    want_psum = _jax_per_rank(lambda t: jax_fused(t, "data", world, form="single"), stacked,
                              world)
    if kind == "fp8":  # JAX's psum makes the all -0.0 column +0.0
        assert not np.signbit(want_psum[0][:, 0]).any()
    for form in FORMS:
        want = _jax_per_rank(lambda t, f=form: jax_fused(t, "data", world, form=f), stacked,
                             world)
        for r in range(world):
            assert _bits_equal(ranks[world][r][("allreduce", kind, form)], want[r]), (form, r)
            assert _bits_equal(want[r], want_psum[r])
    for r in range(world):
        assert _bits_equal(ranks[world][r][("allreduce", kind, "staged")], want_psum[r]), r


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_reduce_scatter_and_all_gather_forms_equal_jax(ranks, world, kind):
    import jax.numpy as jnp

    from tpuframe.parallel.compression import _all_gather_chunks as jax_gather
    from tpuframe.parallel.compression import _reduce_scatter_chunks as jax_scatter

    stacked = jnp.asarray(np.stack([_chunks(kind, r, world) for r in range(world)]))
    for form in FORMS:
        mine = _jax_per_rank(lambda t, f=form: jax_scatter(t, "data", f), stacked, world)
        gathered = _jax_per_rank(lambda t, f=form: jax_gather(t, "data", world, f),
                                 jnp.asarray(np.stack(mine)), world)
        for r in range(world):
            got = ranks[world][r]
            assert _bits_equal(got[("reduce_scatter", kind, form)], mine[r]), (form, r)
            assert _bits_equal(got[("all_gather", kind, form)], gathered[r]), (form, r)


def _jax_sync(world: int, kw: dict, residual: bool):
    """JAX ``sync_gradients`` under ``shard_map``, rank r's tree and
    residual on device r, stochastic rounding from ``PRNGKey(5)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpuframe.core.runtime import shard_map
    from tpuframe.parallel import ParallelPlan as JaxPlan
    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import grad_layout as jax_layout
    from tpuframe.parallel.compression import sync_gradients as jax_sync

    trees = [_tree(r) for r in range(world)]
    mesh = _jax_mesh(world)
    config = JaxConfig(**kw)
    layout = jax_layout({k: jnp.asarray(v) for k, v in trees[0].items()}, config,
                        JaxPlan(mesh=mesh))
    stacked = {k: jnp.asarray(np.stack([t[k] for t in trees])) for k in trees[0]}
    comms = ({"flat": jnp.asarray(np.concatenate([_residual(r) for r in range(world)]))}
             if residual else {})
    rng = jax.random.PRNGKey(5) if kw.get("stochastic_rounding") else None

    def run(t, c):
        synced, new = jax_sync({k: v[0] for k, v in t.items()}, c, layout, config, rng=rng)
        return {k: v[None] for k, v in synced.items()}, new

    fn = shard_map(run, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")), check_vma=False)
    synced, new = fn(stacked, comms)
    return [({k: np.asarray(v[r]) for k, v in synced.items()},
             {k: np.asarray(v[r:r + 1]) for k, v in new.items()}) for r in range(world)]


@pytest.fixture(scope="module")
def jax_sync2():
    """JAX's staged sync of every case at world 2, computed once."""
    return {name: _jax_sync(2, kw, residual) for name, kw, residual, _ in SYNC_CASES}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in SYNC_CASES])
def test_fused_sync_equals_staged_and_jax_bit_for_bit(ranks, jax_sync2, world, name):
    """Every form against the port's staged run at every world; the staged
    run against JAX's at world 2 (``test_torch_port_compression.py`` holds
    it at world 2 in other cases too)."""
    _, kw, residual, _ = next(c for c in SYNC_CASES if c[0] == name)
    for r in range(world):
        staged = ranks[world][r][("sync", name, "staged")]
        want = jax_sync2[name][r] if world == 2 else staged
        for how in ("staged",) + FORMS:
            synced, new = ranks[world][r][("sync", name, how)]
            assert set(synced) == set(want[0]) and set(new) == set(want[1])
            for k in synced:
                assert _bits_equal(synced[k], want[0][k]), (how, r, k)
            for k in new:
                assert _bits_equal(new[k], want[1][k]), (how, r, k)
    if residual:
        assert np.abs(ranks[world][0][("sync", name, "staged")][1]["flat"]).max() > 0


def test_a_sum_of_negative_zeros_is_positive_zero_as_in_jax(ranks, jax_sync2):
    """``mid/b[0]`` is -1e-30 on every rank (no residual added): under fp8
    each rank's payload there is -0.0.  JAX's staged ``psum`` sums to +0.0,
    so the mean is +0.0; a plain gloo sum keeps -0.0."""
    want = jax_sync2["fp8_no_ef"]
    for r in range(2):
        assert want[r][0]["mid/b"][0] == 0 and not np.signbit(want[r][0]["mid/b"][0])
        for how in ("staged",) + FORMS:
            got = ranks[2][r][("sync", "fp8_no_ef", how)][0]["mid/b"]
            assert _bits_equal(got[:1], want[r][0]["mid/b"][:1]), (how, r, got[0])


@pytest.mark.parametrize("world", WORLDS)
def test_a_nan_decodes_to_nan_in_its_bucket_in_every_form(ranks, world):
    tree = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    layout = C.grad_layout(tree, CommsConfig(mode="int8", bucket_mb=0.001), None)
    want = np.zeros(layout.flat_elems, bool)
    want[:BUCKET_ELEMS] = True  # bucket 0 holds deep/w[0, 0, 0]
    for r in range(world):
        for how in ("staged",) + FORMS:
            synced, new = ranks[world][r][("nan", how)]
            flat = np.concatenate([synced[p].ravel() for p, _, _, _ in layout.flat])
            np.testing.assert_array_equal(np.isnan(flat), want, err_msg=f"{how} rank {r}")
            resid = new["flat"].reshape(N_BUCKETS, BUCKET_ELEMS)
            assert not resid[0].any() and resid[1].any() and np.isfinite(resid).all()
            staged = ranks[world][r][("nan", "staged")][0]
            for k in synced:
                assert _bits_equal(np.nan_to_num(synced[k]), np.nan_to_num(staged[k])), (how, k)


def test_fused_span_and_bytes_on_wire(ranks):
    for r in range(2):
        staged, fused = ranks[2][r][("telemetry", False)], ranks[2][r][("telemetry", True)]
        assert staged["bytes"] == fused["bytes"] > 0
        assert [n for n, _, _ in staged["spans"]] == ["comms/allreduce"]
        names = [n for n, _, _ in fused["spans"]]
        assert names == ["comms/fused_hop", "comms/allreduce"]  # inner span ends first
        _, stack, attrs = fused["spans"][0]
        assert stack == ["comms/allreduce", "comms/fused_hop"]
        assert attrs == {"hops": 2, "world": 2, "mode": "int8"}
        for k in staged["mean"]:
            assert _bits_equal(staged["mean"][k], fused["mean"][k]), k


def test_form_default_goes_by_the_backend(ranks):
    assert ranks[2][0]["backend"] == "single"  # gloo
    assert C._form_default() == "single"  # no group: the world-1 identity


# -- quantized_pmean ---------------------------------------------------------------


def _jax_quantized_pmean(trees: list) -> list:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpuframe.core.runtime import shard_map
    from tpuframe.parallel.compression import quantized_pmean as jax_qp

    stacked = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *trees)
    fn = shard_map(lambda t: jax.tree.map(lambda v: v[None],
                                          jax_qp(jax.tree.map(lambda v: v[0], t), ("data",))),
                   mesh=_jax_mesh(len(trees)), in_specs=P("data"), out_specs=P("data"),
                   check_vma=False)
    out = fn(stacked)
    return [jax.tree.map(lambda v: np.asarray(v[r]), out) for r in range(len(trees))]


def test_quantized_pmean_matches_jax(ranks):
    want = _jax_quantized_pmean([_qp_tree(r) for r in range(2)])
    for r in range(2):
        got = ranks[2][r]["qp"]
        for key in ("big", "small", "zero"):
            np.testing.assert_allclose(got[key], want[r][key], rtol=1e-6, atol=0)
            assert got[key].dtype == np.float32
        np.testing.assert_allclose(got["nested"]["k"], want[r]["nested"]["k"], rtol=1e-6)
        for key in ("count", "c8", "c16", "c32"):  # summed exactly, widened, cast back
            assert got[key].dtype == want[r][key].dtype
            np.testing.assert_array_equal(got[key], want[r][key])
    got = ranks[2][0]["qp"]
    np.testing.assert_array_equal(got["c32"], 254)
    np.testing.assert_array_equal(got["count"], 2)
    np.testing.assert_array_equal(got["zero"], 0.0)  # no NaN from a zero scale
    exact = (_qp_tree(0)["big"] + _qp_tree(1)["big"]) / 2
    amax = max(np.abs(_qp_tree(r)["big"]).max() for r in range(2))
    np.testing.assert_allclose(got["big"], exact, atol=amax / 127)
    for r in range(2):  # a NaN on one rank: NaN everywhere on every rank
        assert np.isnan(ranks[2][r]["qp_nan"]).all()


def test_quantized_pmean_refuses_another_axis_and_is_the_grid_at_world_one():
    with pytest.raises(ValueError, match="Queue 1 item 7"):
        quantized_pmean({"g": torch.ones(3)}, ("data", "model"))
    g = torch.linspace(-1, 1, 300)
    out = quantized_pmean({"g": g, "n": torch.ones(2, dtype=torch.int8)}, "data")
    torch.testing.assert_close(out["g"], torch.round(g * 127) / 127, rtol=0, atol=1e-7)
    assert out["n"].dtype == torch.int8 and out["n"].tolist() == [1, 1]


# -- where the fused transport does not engage ---------------------------------------


def test_fused_active_edges_equal_jax():
    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import GradLayout as JaxLayout
    from tpuframe.parallel.compression import fused_active as jax_fused_active

    tree = {"w": torch.ones(100)}
    for world, mode, want in ((1, "int8", False), (2, "int8", True), (73, "fp8", True),
                              (74, "fp8", False), (74, "int8", True)):
        config = CommsConfig(mode=mode, fused=True)
        layout = C.grad_layout(tree, config, ParallelPlan(mesh=MeshSpec(data=world).build(world)))
        assert C.fused_active(layout, config) == want, (world, mode)
        jl = JaxLayout(**{f.name: getattr(layout, f.name) for f in dataclasses.fields(layout)})
        assert jax_fused_active(jl, JaxConfig(mode=mode, fused=True)) == want
        assert not C.fused_active(layout, dataclasses.replace(config, fused=False))
    two_axes = dataclasses.replace(layout, axes=("data", "fsdp"), world=4)
    assert not C.fused_active(two_axes, CommsConfig(fused=True))
    assert not jax_fused_active(JaxLayout(**{f.name: getattr(two_axes, f.name)
                                             for f in dataclasses.fields(two_axes)}),
                                JaxConfig(fused=True))


@pytest.mark.parametrize("form", FORMS)
def test_world_one_is_the_identity_in_every_form(form):
    for kind in ("int8", "fp8"):
        q = torch.from_numpy(_payload(kind, 0))
        out = C._fused_allreduce(q, 1, form=form)
        assert _bits_equal(out.numpy(), _payload(kind, 0))  # -0.0 kept, as JAX's W == 1
        assert C._fused_allreduce(q, 1, form=form, async_op=True).wait() is q
