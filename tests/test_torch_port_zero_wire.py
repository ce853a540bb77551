"""The compressed wire's ZeRO-sliced leaves (``parallel.compression``)
against the JAX package's ``sync_gradients``, on the same numpy inputs.

A ZeRO-2 plan over ``data = W`` (W = 2 and 4) slices every leaf of at
least ``min_shard_elems`` with a dim divisible by W; the port's leaves are
in torch layout (a conv OIHW, a linear (out, in)) and JAX's in flax layout
(HWIO, (in, out)), and the port picks the shard dim on the flax layout
(``sharding.flax_orders``), so both cut the same logical axis.  The flat
buckets' leaves have one layout on both sides (a transposed leaf would put
other elements in a bucket, under another scale).  One spawn
of gloo ranks a world runs every case; the JAX side runs in this process
under ``shard_map`` on the virtual CPU devices.

- int8 (round half to even) and fp8, with error feedback (random
  residuals, a row a rank), staged and through the fused transport
  in each form (``ring``, ``concurrent``, ``single``, forced through
  ``_form_default``): the flat buckets' means, each sliced leaf's owned
  chunk (JAX's slice, moved into torch layout) and every new residual
  equal JAX's bit for bit; under a grouped schedule too.
- A NaN on one rank makes its leaf's owned chunk NaN on every rank and
  resets the leaf's residual (JAX's ``pmax`` on its CPU backend drops the
  NaN here: a difference, ROADMAP.md Queue 3); every other leaf as JAX's.
- ``grad_layout``, ``comms_template`` and ``wire_plan`` equal JAX's.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.core import initialize
from tpuframe_torch.parallel import ZeroConfig
from tpuframe_torch.parallel import compression as C

WORLDS = (2, 4)
FORMS = ("ring", "concurrent", "single")
MIN_ELEMS = 4096
#: name -> (flax shape, the torch dims in flax order or None)
LEAVES = {
    "block/conv/kernel": ((3, 3, 64, 64), (2, 3, 1, 0)),  # a 64 -> 64 conv, OIHW in torch
    "block/dense/kernel": ((128, 128), (1, 0)),  # a square linear
    "norm/scale": ((3000,), None),  # below MIN_ELEMS: the flat buckets
}
#: (name, CommsConfig kwargs, residual on): 3 buckets of 1,024 (in 2 groups)
CASES = [
    ("int8", dict(mode="int8", bucket_mb=0.004), True),
    ("int8_grouped", dict(mode="int8", bucket_mb=0.004, groups=2), True),
    ("fp8", dict(mode="fp8", bucket_mb=0.004), True),
]
POISON = ("block/dense/kernel", (0, 0))


def _torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A flax-layout array in the port's layout."""
    order = LEAVES[name][1]
    if order is None:
        return a
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)


def _tree(rank: int) -> dict:
    rng = np.random.default_rng(700 + rank)
    tree = {n: (rng.standard_normal(s) * (0.5 + i)).astype(np.float32)
            for i, (n, (s, _)) in enumerate(LEAVES.items())}
    tree["norm/scale"][:5] *= 1e-6
    tree["block/conv/kernel"][..., 0, :] *= 1e-3  # one input channel: a chunk of small scale
    return tree


def _residuals(rank: int, layout_shapes: dict) -> dict:
    rng = np.random.default_rng(800 + rank)
    return {k: (rng.standard_normal((1,) + tuple(s[1:])) * 1e-3).astype(np.float32)
            for k, s in layout_shapes.items()}


def _orders() -> dict:
    return {n: o for n, (_, o) in LEAVES.items() if o is not None}


def _port_sync(rank, plan, kw, residual, jax_template, fused, poison=False):
    tree = _tree(rank)
    if poison and rank == 1:
        tree[POISON[0]][POISON[1]] = np.nan
    grads = {n: torch.from_numpy(_torch_layout(n, v)) for n, v in tree.items()}
    config = C.CommsConfig(**kw, fused=fused)
    layout = C.grad_layout(grads, config, plan, orders=_orders())
    comms = {}
    if residual:
        flax = _residuals(rank, jax_template)
        comms = {k: torch.from_numpy(v if k == "flat" else _torch_layout(
            k.removeprefix("leaf.").replace(".", "/"), v[0])[None]) for k, v in flax.items()}
    synced, new = C.sync_gradients(grads, comms, layout, config)
    return ({k: v.numpy().copy() for k, v in synced.items()},
            {k: v.numpy().copy() for k, v in new.items()},
            {"sliced": layout.sliced, "flat": len(layout.flat), "n_buckets": layout.n_buckets,
             "template": C.comms_template(grads, config, plan),
             "wire": C.wire_plan(layout, config)})


def _ranks_worker(rank: int, world: int, templates: dict) -> dict:
    rt = initialize(device="cpu")
    plan = ZeroConfig(stage=2, min_shard_elems=MIN_ELEMS).plan(rt.mesh)
    out = {}
    for name, kw, residual in CASES:
        out[(name, "staged")] = _port_sync(rank, plan, kw, residual, templates[name], False)
        for form in FORMS:
            with mock.patch.object(C, "_form_default", lambda f=form: f):
                out[(name, form)] = _port_sync(rank, plan, kw, residual, templates[name], True)
    if world == 2:
        out["nan"] = _port_sync(rank, plan, CASES[0][1], True, templates["int8"], False,
                                poison=True)
    return out


# -- the JAX side ----------------------------------------------------------------


def _jax_plan(world: int):
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.parallel import ParallelPlan as JaxPlan

    return JaxPlan(mesh=JaxMeshSpec(data=world).build(jax.devices()[:world]), zero_stage=2,
                   min_shard_elems=MIN_ELEMS)


def _nested(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return out


def _flat(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_layout_and_template(world: int, kw: dict):
    import jax.numpy as jnp

    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import comms_template, grad_layout

    config = JaxConfig(**kw)
    tree = _nested({n: jnp.asarray(v) for n, v in _tree(0).items()})
    plan = _jax_plan(world)
    return grad_layout(tree, config, plan), comms_template(tree, config, plan), config, plan


def _jax_sync(world: int, kw: dict, residual: bool, poison=False):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tpuframe.core.runtime import shard_map
    from tpuframe.parallel.compression import sync_gradients as jax_sync

    layout, template, config, plan = _jax_layout_and_template(world, kw)
    trees = [_tree(r) for r in range(world)]
    if poison:
        trees[1][POISON[0]][POISON[1]] = np.nan
    stacked = _nested({k: jnp.asarray(np.stack([t[k] for t in trees])) for k in trees[0]})
    comms = {}
    if residual:
        rows = [_residuals(r, template) for r in range(world)]
        comms = {k: jnp.asarray(np.concatenate([rw[k] for rw in rows])) for k in template}

    def run(t, c):
        synced, new = jax_sync(_strip(t), c, layout, config)
        return _lead(synced), new

    # eager, op by op (as ``test_torch_port_comms_fused.py`` runs it): a
    # jitted program may fuse a multiply-add, one rounding where the port has two
    fn = shard_map(run, mesh=plan.mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")), check_vma=False)
    synced, new = fn(stacked, comms)
    synced = _flat(synced)
    return [({k: np.asarray(v[r]) for k, v in synced.items()},
             {k: np.asarray(v[r:r + 1]) for k, v in new.items()}) for r in range(world)]


def _strip(t):
    return {k: _strip(v) if isinstance(v, dict) else v[0] for k, v in t.items()}


def _lead(t):
    return {k: _lead(v) if isinstance(v, dict) else v[None] for k, v in t.items()}


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for world in WORLDS:
        for name, kw, residual in CASES:
            layout, template, _, _ = _jax_layout_and_template(world, kw)
            out[(world, name)] = (layout, template, _jax_sync(world, kw, residual))
    out["nan"] = _jax_sync(2, CASES[0][1], True, poison=True)
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    return {w: run_ranks(_ranks_worker, w, tmp_path_factory.mktemp(f"zwire{w}"),
                         {name: jax_side[(w, name)][1] for name, _, _ in CASES}, timeout=300)
            for w in WORLDS}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


def _owned_in_torch_layout(name: str, jax_slice: np.ndarray, dim: int) -> np.ndarray:
    """JAX's owned slice (flax layout) as the port's owned chunk: torch
    layout, the shard dim moved to the front."""
    return np.moveaxis(_torch_layout(name, jax_slice), dim, 0)


def _check(port, jax_rank, sliced_dims):
    synced, new = port
    want_synced, want_new = jax_rank
    assert set(synced) == set(want_synced)
    for name, got in synced.items():
        want = want_synced[name]
        if name in sliced_dims:
            want = _owned_in_torch_layout(name, want, sliced_dims[name])
        else:
            want = _torch_layout(name, want)
        assert _bits_equal(got, want), name
    assert set(new) == set(want_new)
    for key, got in new.items():
        want = want_new[key]
        if key != "flat":
            want = _torch_layout(key.removeprefix("leaf.").replace(".", "/"), want[0])[None]
        assert _bits_equal(got, want), key


@pytest.mark.parametrize("transport", ("staged",) + FORMS)
@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_sliced_sync_equals_jax_bit_for_bit(ranks, jax_side, world, name, transport):
    layout, _, want = jax_side[(world, name)]
    got = ranks[world]
    sliced = {path: dim for path, _, _, dim in got[0][(name, transport)][2]["sliced"]}
    assert set(sliced) == {p for p, _, _, _ in layout.sliced} == {
        "block/conv/kernel", "block/dense/kernel"}
    # the logical axis: JAX's flax dim, mapped into torch layout
    for p, _, _, dim in layout.sliced:
        order = LEAVES[p][1]
        assert sliced[p] == (dim if order is None else order[dim]), p
    for r in range(world):
        _check(got[r][(name, transport)][:2], want[r], sliced)


def test_a_nan_poisons_its_sliced_leaf_on_every_rank(ranks, jax_side):
    """The port's rule: a NaN abs-max is mapped to +inf before the ``MAX``,
    so the poisoned leaf's owned chunk is NaN on every rank and its
    residual resets.  JAX's ``pmax`` on the CPU backend keeps the finite
    max here (the NaN dropped), so JAX decodes finite values for that leaf
    (ROADMAP.md Queue 3); every other leaf and residual equals JAX's bit
    for bit."""
    world = 2
    want = jax_side["nan"]
    got = ranks[world]
    sliced = {path: dim for path, _, _, dim in got[0]["nan"][2]["sliced"]}
    key = "leaf." + POISON[0].replace("/", ".")
    for r in range(world):
        synced, new = got[r]["nan"][:2]
        assert np.isnan(synced[POISON[0]]).all()
        assert not new[key].any()
        assert np.isfinite(want[r][0][POISON[0]]).all()  # JAX's pmax dropped the NaN
        _check(({k: v for k, v in synced.items() if k != POISON[0]},
                {k: v for k, v in new.items() if k != key}),
               ({k: v for k, v in want[r][0].items() if k != POISON[0]},
                {k: v for k, v in want[r][1].items() if k != key}), sliced)


@pytest.mark.parametrize("world", WORLDS)
def test_layout_template_and_wire_plan_equal_jax(ranks, jax_side, world):
    from tpuframe.parallel.compression import CommsConfig as JaxConfig
    from tpuframe.parallel.compression import wire_plan as jax_wire_plan

    for name, kw, _ in CASES:
        layout, template, _ = jax_side[(world, name)]
        meta = ranks[world][0][(name, "staged")][2]
        assert meta["flat"] == len(layout.flat) and meta["n_buckets"] == layout.n_buckets
        torch_shape = {k: (v if k == "flat" else (v[0],) + _torch_layout(
            k.removeprefix("leaf.").replace(".", "/"), np.empty(v[1:])).shape)
                       for k, v in template.items()}
        assert meta["template"] == {k: tuple(v) for k, v in torch_shape.items()}
        assert meta["wire"] == jax_wire_plan(layout, JaxConfig(**kw)), name
        fused = ranks[world][0][(name, "single")][2]["wire"]
        assert fused == jax_wire_plan(layout, dataclasses.replace(JaxConfig(**kw), fused=True))
