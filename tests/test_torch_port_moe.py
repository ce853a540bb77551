"""MoE gating (K9a-K9c's plain versions on the CPU) and ``MoEMLP`` against
the JAX package's ``tpuframe.ops.moe_gating`` and ``tpuframe.models.moe``,
with the same numpy-seeded inputs and weights.

- ``moe_dispatch_combine``: the port's row copies (``fused`` None) against
  JAX's fused path and the port's dense form (``fused=False``) against
  JAX's reference, at ``tests/test_moe.py``'s shapes, its tight capacity
  1 included, and at top 1, 4 (D = 100) and 8; the gradients of tokens,
  gate values, ``w_in`` and ``w_out`` against ``jax.grad``.  Float32
  within 1e-5.
- The dispatch's folded zero fill: the plain K9a into a NaN-filled buffer,
  and the plain K9c's ``dbuf``, are the zero-filled result bit for bit;
  K9c's plain path is the two plain versions (the scaled dispatch, the gate
  gradient) called apart; and ``_descriptors`` gives each
  expert's held slots its rows ``0 .. count_e - 1`` under a local routing,
  every expert split and the global routing.
- ``MoEMLP`` on JAX's weights: the output and the aux loss within 1e-5;
  with tied router columns, the experts ``lax.top_k`` picks (the lower
  index first).
- On gloo ranks (``tests/torch_ranks.py``): at ``expert=2`` the experts
  split by ``moe_rules`` give the unsharded output and gradients; at
  ``data=2 x seq=2`` with a capacity that drops tokens, each rank's rows
  are JAX's over the global batch (the same tokens dropped, the rows of a
  token whose choices were all dropped zero on both sides), the aux loss
  is the global one, and the router's gradient averaged over the token
  group is ``jax.grad`` of the global objective (so the aux loss's
  gradient survives the average).
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

D, E, K = 8, 4, 2
CAP = 0.5  # the ranks' capacity factor: drops tokens
X_SHAPE = (4, 8, D)  # the global batch of the rank tests


def _case(n=64, d=8, e=4, k=2, h=16, seed=0, capacity=None):
    """``tests/test_moe.py``'s ``_case``: tokens, top-k gates of random
    logits renormalized, expert weights; numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((n, d)).astype(np.float32)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k].astype(np.int32)
    vals = np.take_along_axis(probs, idx, -1)
    vals = (vals / vals.sum(-1, keepdims=True)).astype(np.float32)
    w_in = (rng.standard_normal((e, d, h)) * 0.1).astype(np.float32)
    w_out = (rng.standard_normal((e, h, d)) * 0.1).astype(np.float32)
    return tokens, vals, idx, w_in, w_out, capacity or max(1, (k * n) // e)


OP_CASES = {"seed0": dict(seed=0), "seed1": dict(seed=1), "seed2": dict(seed=2),
            "tight": dict(n=32, e=2, k=2, seed=7, capacity=1),
            "k1": dict(k=1, seed=3), "k4_d100": dict(d=100, e=6, k=4, seed=4),
            "k8_e8": dict(e=8, k=8, seed=5)}


def _moe_params(seed: int = 3, tied: bool = False) -> dict:
    """A JAX ``MoEMLP`` tree (numpy): router kernel (D, E), ``w_in``,
    ``w_out``; ``tied`` makes router columns 2 and 3 copies of 0 and 1."""
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((D, E)).astype(np.float32) * 0.5
    if tied:
        router[:, 2:] = router[:, :2]
    return {"router": {"kernel": router},
            "w_in": (rng.standard_normal((E, D, 4 * D)) * 0.2).astype(np.float32),
            "w_out": (rng.standard_normal((E, 4 * D, D)) * 0.2).astype(np.float32)}


def _x(seed: int = 4, shape=X_SHAPE) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _g(seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(X_SHAPE).astype(np.float32)


def _port_moe(params: dict, capacity_factor: float = 1.25):
    from tpuframe_torch.models import MoEMLP

    m = MoEMLP(D, num_experts=E, top_k=K, capacity_factor=capacity_factor, device="cpu")
    m.load_state_dict({"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
                       "w_in": torch.from_numpy(params["w_in"]),
                       "w_out": torch.from_numpy(params["w_out"])})
    return m


# -- the ranks' jobs (no JAX here) -------------------------------------------------


def _grads(m) -> dict:
    from tpuframe_torch.parallel.tensor import full_tensor

    layout = getattr(m, "tp_layout", None) or {}
    return {n: (full_tensor(p.grad, layout[n]) if n in layout else p.grad).numpy().copy()
            for n, p in m.named_parameters()}


def _expert_job(rank, world):
    """``expert=2``: the replicated batch through the experts split by
    ``moe_rules``."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.models import moe_rules
    from tpuframe_torch.parallel import ParallelPlan
    from tpuframe_torch.parallel.tensor import shard_model

    rt = initialize({"data": 1, "expert": world}, device="cpu")
    m = _port_moe(_moe_params())
    layout = shard_model(m, ParallelPlan(mesh=rt.mesh, rules=moe_rules(), min_shard_elems=1))
    x = torch.from_numpy(_x()).requires_grad_(True)
    out = m(x)
    ((out * torch.from_numpy(_g())).sum() + m.aux_loss).backward()
    return {"out": out.detach().numpy(), "aux": float(m.aux_loss.detach()),
            "dx": x.grad.numpy(), "grads": _grads(m), "layout": layout,
            "local": tuple(m.w_in.shape)}


def _token_job(rank, world):
    """``data=2 x seq=2``: each rank its rows and its run of positions,
    routed over the global batch at a capacity that drops tokens."""
    from tpuframe_torch.core import initialize

    rt = initialize({"data": 2, "seq": 2}, device="cpu")
    c = rt.mesh.coords(rank)
    b, l = X_SHAPE[0] // 2, X_SHAPE[1] // 2
    rows = slice(c["data"] * b, (c["data"] + 1) * b)
    cols = slice(c["seq"] * l, (c["seq"] + 1) * l)
    m = _port_moe(_moe_params(), CAP)
    x = torch.from_numpy(_x()[rows, cols].copy())
    out = m(x)
    ((out * torch.from_numpy(_g()[rows, cols].copy())).sum() + m.aux_loss).backward()
    return {"out": out.detach().numpy(), "aux": float(m.aux_loss.detach()), "rows": rows,
            "cols": cols, "router": m.router.weight.grad.numpy().copy()}


def _jobs(rank, world, jobs):
    return {name: fn(rank, world) for name, fn in jobs.items()}


# -- the JAX side -------------------------------------------------------------------


def _jax_moe(params, x, g=None, capacity_factor=1.25, scale=1.0):
    """JAX's ``MoEMLP`` on ``x``: (out, aux), and with ``g`` the gradients of
    ``scale * sum(out * g) + aux`` by x and by every parameter."""
    import jax
    import jax.numpy as jnp

    from tpuframe.models.moe import MoEMLP as JaxMoE

    jm = JaxMoE(num_experts=E, top_k=K, capacity_factor=capacity_factor)

    def run(p, x):
        out, upd = jm.apply({"params": p}, x, mutable=["aux_loss"])
        return out, sum(jnp.sum(a) for a in jax.tree.leaves(upd["aux_loss"]))

    p = jax.tree.map(jnp.asarray, params)
    out, aux = run(p, jnp.asarray(x))
    res = {"out": np.asarray(out), "aux": float(aux)}
    if g is not None:
        def loss(p, x):
            o, a = run(p, x)
            return scale * jnp.sum(o * g) + a

        gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
        res["grads"] = jax.tree.map(np.asarray, gp)
        res["dx"] = np.asarray(gx)
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {2: run_ranks(_jobs, 2, tmp_path_factory.mktemp("ep2"), {"expert": _expert_job},
                         timeout=300),
            4: run_ranks(_jobs, 4, tmp_path_factory.mktemp("dp2sp2"), {"token": _token_job},
                         timeout=300)}


# -- the op -----------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(OP_CASES))
@pytest.mark.parametrize("fused", [None, False], ids=["rows", "dense"])
def test_dispatch_combine_matches_jax(case, fused):
    import jax.numpy as jnp

    from tpuframe.ops.moe_gating import moe_dispatch_combine as jax_moe
    from tpuframe.ops.moe_gating import moe_dispatch_combine_reference as jax_ref
    from tpuframe_torch.ops import moe_dispatch_combine

    *inputs, capacity = _case(**OP_CASES[case])
    got = moe_dispatch_combine(*(torch.from_numpy(a) for a in inputs), capacity=capacity,
                               fused=fused)
    jin = [jnp.asarray(a) for a in inputs]
    want = (jax_moe(*jin, capacity=capacity, fused=True) if fused is None
            else jax_ref(*jin, capacity=capacity))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["seed0", "tight", "k1", "k4_d100", "k8_e8"])
@pytest.mark.parametrize("fused", [None, False], ids=["rows", "dense"])
def test_dispatch_combine_gradients_match_jax(case, fused):
    import jax
    import jax.numpy as jnp

    from tpuframe.ops.moe_gating import moe_dispatch_combine as jax_moe
    from tpuframe_torch.ops import moe_dispatch_combine

    tokens, vals, idx, w_in, w_out, capacity = _case(**OP_CASES[case])

    def loss(t, gv, wi, wo):
        return jnp.sum(jax_moe(t, gv, jnp.asarray(idx), wi, wo, capacity=capacity,
                               fused=fused is None) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a)
                                                  for a in (tokens, vals, w_in, w_out)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (tokens, vals, w_in, w_out)]
    t, gv, wi, wo = leaves
    (moe_dispatch_combine(t, gv, torch.from_numpy(idx), wi, wo, capacity=capacity,
                          fused=fused) ** 2).sum().backward()
    for name, got, w in zip(("tokens", "gate_vals", "w_in", "w_out"), leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def _slots(n, e, k, capacity, seed):
    """``(choice_exp, keep)`` of n tokens' k distinct random choices among e
    experts, routed at ``capacity`` (which may drop slots)."""
    from tpuframe_torch.ops.moe_gating import _routing

    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(np.argsort(rng.random((n, e)), -1)[:, :k].astype(np.int32))
    choice_exp, _, keep, _ = _routing(idx, e, capacity)
    return choice_exp, keep


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["scale1", "weights"])
def test_plain_dispatch_into_a_nan_buffer_is_the_zero_filled_result(dtype, scaled):
    """The plain K9a writes every row of the buffer it is given: into a
    NaN-filled ``torch.empty`` it gives, bit for bit, the rows of an
    ``index_put_`` into a zeroed buffer (the folded zero fill).  With the
    gate weights, the plain K9c (``moe_combine_backward`` into NaN-filled
    outputs) gives the scaled rows the same way, and its ``dgate`` is the
    plain gate gradient."""
    from tpuframe_torch.ops.moe_gating import (
        _descriptors,
        moe_combine_backward,
        moe_dispatch,
        moe_gate_grad_reference,
    )

    n, d, e, k, cap, e0, e_local = 40, 12, 6, 2, 16, 3, 3
    choice_exp, keep = _slots(n, e, k, cap, seed=11)
    e_loc, slot, count = _descriptors(choice_exp, keep, e0, e_local)
    # slots drop, and rows past the counts remain for the zero fill
    assert int(count.sum()) < e_local * cap and int((~keep).sum()) > 0
    rng = np.random.default_rng(12)
    src = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.random(n * k).astype(np.float32)) if scaled else None
    if scaled:
        fwd = torch.from_numpy(rng.standard_normal((e_local, cap, d)).astype(np.float32)).to(dtype)
        nan_out = (torch.empty((e_local, cap, d), dtype=dtype).fill_(float("nan")),
                   torch.empty(n * k).fill_(float("nan")))
        got, dgate = moe_combine_backward(src, fwd, w, e_loc, slot, count, *nan_out)
        assert got is nan_out[0] and dgate is nan_out[1]
        assert torch.equal(_bits(dgate), _bits(moe_gate_grad_reference(src, fwd, e_loc, slot)))
    else:
        got = moe_dispatch(src, torch.empty((e_local, cap, d), dtype=dtype).fill_(float("nan")),
                           e_loc, slot, count=count)
    want = torch.zeros((e_local, cap, d), dtype=dtype)
    sel = (e_loc >= 0).nonzero()[:, 0]
    rows = src[sel % n] if w is None else (w[sel, None] * src[sel % n].float()).to(dtype)
    want.index_put_((e_loc[sel].long(), slot[sel].long()), rows)
    assert not got.isnan().any()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("cap", [6, 40], ids=["drops", "fits"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_combine_backward_is_the_two_plain_versions(dtype, cap):
    """K9c's plain path (a CPU tensor) is, bit for bit, the two plain
    versions called apart: the scaled dispatch of the cotangent into a
    zeroed buffer and the gate gradient; and ``_Combine``'s backward
    returns just these."""
    from tpuframe_torch.ops.moe_gating import (
        _Combine,
        _descriptors,
        moe_combine_backward,
        moe_dispatch_reference,
        moe_gate_grad_reference,
    )

    n, d, e, k, e0, e_local = 48, 24, 8, 2, 4, 4
    choice_exp, keep = _slots(n, e, k, cap, seed=14)
    e_loc, slot, count = _descriptors(choice_exp, keep, e0, e_local)
    rows = min(cap, k * n)
    assert (int((~keep).sum()) > 0) == (cap == 6)
    rng = np.random.default_rng(15)
    g, w = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype),
            torch.from_numpy(rng.random(n * k).astype(np.float32)))
    buf = torch.from_numpy(rng.standard_normal((e_local, rows, d)).astype(np.float32)).to(dtype)
    dbuf, dgate = moe_combine_backward(g, buf, w, e_loc, slot, count, torch.empty_like(buf),
                                       torch.empty(n * k))
    want_dbuf = moe_dispatch_reference(g, torch.zeros_like(buf), e_loc, slot, w, count=count)
    want_dgate = moe_gate_grad_reference(g, buf, e_loc, slot)
    assert dbuf.dtype == dtype and dgate.dtype == torch.float32
    assert torch.equal(_bits(dbuf), _bits(want_dbuf))
    assert torch.equal(_bits(dgate), _bits(want_dgate))
    assert torch.equal(_bits(dgate[e_loc < 0]), torch.zeros(int((e_loc < 0).sum()),
                                                            dtype=torch.int32))
    leaf, wl = buf.clone().requires_grad_(True), w.clone().requires_grad_(True)
    _Combine.apply(leaf, wl, e_loc, slot, count, n).backward(g)
    assert torch.equal(_bits(leaf.grad), _bits(want_dbuf))
    assert torch.equal(_bits(wl.grad), _bits(want_dgate))


def _assert_compact(e_loc, slot, count, e_local, rows):
    """Each local expert's held slots, in slot (choice-major) order, are its
    rows ``0 .. count_e - 1``, and ``count_e`` fits the buffer."""
    assert count.dtype == torch.int32 and tuple(count.shape) == (e_local,)
    for ex in range(e_local):
        got = slot[e_loc == ex]
        assert torch.equal(got, torch.arange(int(count[ex]), dtype=torch.int32)), ex
        assert int(count[ex]) <= rows
    assert int(count.sum()) == int((e_loc >= 0).sum())


@pytest.mark.parametrize("cap", [6, 40], ids=["drops", "fits"])
def test_descriptors_give_each_expert_rows_zero_to_its_count(cap):
    """The property K9a's folded zero fill rests on: under a local routing,
    for every expert split (one process, halves, quarters), each expert's
    held slots take rows ``0 .. count_e - 1``."""
    from tpuframe_torch.ops.moe_gating import _descriptors

    n, e, k = 48, 8, 2
    choice_exp, keep = _slots(n, e, k, cap, seed=13)
    for parts in (1, 2, 4):
        e_local = e // parts
        for r in range(parts):
            e_loc, slot, count = _descriptors(choice_exp, keep, r * e_local, e_local)
            _assert_compact(e_loc, slot, count, e_local, min(cap, k * n))


def test_descriptors_under_the_global_routing_compact_each_ranks_rows():
    """``models.moe``'s global routing (``routed=``) over ``data=2 x seq=2``
    at a capacity that drops slots: each rank's descriptors, for each
    rank's experts under an ``expert=2`` split, keep the property."""
    from types import SimpleNamespace
    from unittest import mock

    from tpuframe_torch.models.moe import _global_routing
    from tpuframe_torch.ops.moe_gating import _descriptors

    b, l, k, e, world, seq = 2, 6, 2, 4, 4, 2
    rng = np.random.default_rng(14)
    idx = [torch.from_numpy(np.argsort(rng.random((b, l, e)), -1)[..., :k].astype(np.int32))
           for _ in range(world)]
    cap = 5  # below the global 2 * k * (world * b * l) / e = 24 a expert: slots drop
    gathered = torch.stack(idx)
    dropped = 0
    for rank in range(world):
        ax = SimpleNamespace(size=world, index=rank)
        with mock.patch("tpuframe_torch.parallel.tensor._all_gather",
                        lambda x, dim, axis: gathered):
            choice_exp, _, keep = _global_routing(idx[rank], e, cap, ax, seq)
        dropped += int((~keep).sum())
        for r in range(2):
            e_loc, slot, count = _descriptors(choice_exp, keep, r * (e // 2), e // 2)
            _assert_compact(e_loc, slot, count, e // 2, min(cap, k * b * l))
    assert dropped > 0


# -- the module ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True], ids=["router", "tied_router"])
def test_moe_mlp_on_jax_weights_matches_jax(tied):
    params = _moe_params(tied=tied)
    want = _jax_moe(params, _x())
    m = _port_moe(params)
    out = m(torch.from_numpy(_x()))
    np.testing.assert_allclose(out.detach().numpy(), want["out"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(m.aux_loss.detach()), want["aux"], rtol=1e-5)


def test_top_k_ties_break_as_lax_top_k():
    import jax

    from tpuframe_torch.models.moe import top_k

    probs = np.array([[0.3, 0.2, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    probs = np.concatenate([probs, np.random.default_rng(0).random((64, 4), np.float32)
                            .round(1)])  # many more ties
    for k in (1, 2, 3, 4):
        want_vals, want_idx = jax.lax.top_k(probs, k)
        vals, idx = top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx), err_msg=f"k={k}")
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


# -- on ranks -----------------------------------------------------------------------------


def test_expert_split_equals_unsharded(ranks):
    params = _moe_params()
    want = _jax_moe(params, _x(), _g())
    for r in ranks[2]:
        got = r["expert"]
        assert got["layout"] == {"w_in": [(0, "expert")], "w_out": [(0, "expert")]}
        assert got["local"] == (E // 2, D, 4 * D)
        np.testing.assert_allclose(got["out"], want["out"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        np.testing.assert_allclose(got["dx"], want["dx"], atol=1e-5, rtol=0)
        g = got["grads"]
        for name, w in (("router.weight", want["grads"]["router"]["kernel"].T),
                        ("w_in", want["grads"]["w_in"]), ("w_out", want["grads"]["w_out"])):
            np.testing.assert_allclose(g[name], w, atol=1e-5, rtol=1e-5, err_msg=name)


def test_seq_and_data_split_drop_the_tokens_jax_drops(ranks):
    params = _moe_params()
    got = [r["token"] for r in ranks[4]]
    # the objective each rank differentiates is its rows' sum plus the global
    # aux; the step averages over the 4 ranks: JAX's sum / 4 + aux
    want = _jax_moe(params, _x(), _g(), capacity_factor=CAP, scale=1 / len(got))
    zero_rows = 0
    for r in got:
        rows = want["out"][r["rows"], r["cols"]]
        np.testing.assert_allclose(r["out"], rows, atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5)
        zero_rows += int((np.abs(r["out"]).max(-1) == 0).sum())
    assert zero_rows == int((np.abs(want["out"]).max(-1) == 0).sum()) > 0  # tokens dropped
    router = np.mean([r["router"] for r in got], axis=0)
    np.testing.assert_allclose(router, want["grads"]["router"]["kernel"].T, atol=1e-6,
                               rtol=1e-5)
