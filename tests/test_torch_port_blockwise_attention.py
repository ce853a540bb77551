"""The port's blockwise attention (``ops/blockwise_attention.py``) on the
CPU, where it takes its plain version, against the JAX package's
``blockwise_attention`` (its ``custom_vjp`` forward and backward) and its
full-softmax ``attention_reference``, on the same numpy inputs.

Tolerances, each with its reason:

- float32: the output within 1e-5 and the three gradients within 1e-4,
  absolute, for O(1) inputs.  Both sides run the same schedule, but XLA and
  ATen sum the products in another order (measured below 1.2e-6).  Against
  the full softmax the sums also run over other blocks.
- Large logits (inputs scaled by 8, logits of a few hundred): the output
  within 1e-4 relative and 1e-3 absolute, as the JAX package's own test
  holds its blockwise path against the full softmax there: the softmax is
  then nearly an argmax, and a rounding at the top moves a row's weights.
- bfloat16: both sides round P, dS and the outputs to bf16 at the same
  places, but the float32 sums before each rounding may run in another
  order, so a value near a rounding boundary can land one bf16 step apart
  and carry on.  Held within 2 bf16 steps (2^-7 relative) of the largest
  value (measured 0: bit-equal), plus the JAX package's own bf16 bound
  against the float32 full softmax (5e-2; measured 3.0e-3).
"""

import ctypes
import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuframe.ops.blockwise_attention import blockwise_attention as jax_blockwise
from tpuframe.ops.ring_attention import attention_reference as jax_full
from tpuframe_torch.ops import (
    blockwise_attention,
    blockwise_attention_bwd_dkv,
    blockwise_attention_bwd_dq,
    blockwise_attention_bwd_reference,
    blockwise_attention_fwd,
    blockwise_attention_reference,
)
from tpuframe_torch.ops import build
from tpuframe_torch.ops.blockwise_attention import DEFAULT_BLOCK, _library


def _inputs(l, b=2, h=3, d=8, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, l, h, d)) * scale).astype(np.float32) for _ in range(4)]


def _jax(fn, q, k, v, g):
    """JAX output and (dq, dk, dv) for the upstream gradient g."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out, np.float32), [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g))]


def _port(q, k, v, g, dtype=torch.float32, **kw):
    """The port's output and (dq, dk, dv) through autograd."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    out = blockwise_attention(*ts, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g).to(dtype))
    return out.detach().float().numpy(), [t.float().numpy() for t in grads]


@pytest.mark.parametrize("l", [13, 48, 100])
@pytest.mark.parametrize("block", [16, 64, 512])
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_forward_and_gradients_match_jax(causal, block, l):
    q, k, v, g = _inputs(l, seed=l + block)
    want, want_g = _jax(lambda q, k, v: jax_blockwise(q, k, v, causal=causal, block_size=block),
                        q, k, v, g)
    full, full_g = _jax(lambda q, k, v: jax_full(q, k, v, causal=causal), q, k, v, g)
    got, got_g = _port(q, k, v, g, causal=causal, block_size=block)
    for ref, ref_g in ((want, want_g), (full, full_g)):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        for a, b_, name in zip(got_g, ref_g, ("dq", "dk", "dv")):
            np.testing.assert_allclose(a, b_, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_large_logits_stay_finite_and_match_jax(causal):
    q, k, v, g = _inputs(40, seed=5, scale=8.0)
    want, want_g = _jax(lambda q, k, v: jax_blockwise(q, k, v, causal=causal, block_size=16),
                        q, k, v, g)
    got, got_g = _port(q, k, v, g, causal=causal, block_size=16)
    assert np.isfinite(got).all() and all(np.isfinite(t).all() for t in got_g)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    for a, b_ in zip(got_g, want_g):
        scale = np.abs(b_).max()
        np.testing.assert_allclose(a, b_, rtol=1e-4, atol=1e-3 * scale)


@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_bf16_matches_jax_bf16(causal):
    q, k, v, g = _inputs(40, seed=6, scale=0.5)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    out, vjp = jax.vjp(lambda q, k, v: jax_blockwise(q, k, v, causal=causal, block_size=16),
                       bf(q), bf(k), bf(v))
    want = np.asarray(out, np.float32)
    want_g = [np.asarray(t, np.float32) for t in vjp(bf(g))]
    # the same bf16 inputs on both sides
    q, k, v, g = (np.asarray(bf(a), np.float32) for a in (q, k, v, g))
    got, got_g = _port(q, k, v, g, torch.bfloat16, causal=causal, block_size=16)
    full, full_g = _jax(lambda q, k, v: jax_full(q, k, v, causal=causal), q, k, v, g)
    for a, b_, f in zip([got, *got_g], [want, *want_g], [full, *full_g]):
        assert np.abs(a - b_).max() <= 2 * 2.0**-7 * np.abs(b_).max()
        np.testing.assert_allclose(a, f, atol=5e-2, rtol=5e-2)


def test_default_block_is_512_and_lse_matches_the_full_softmax():
    assert DEFAULT_BLOCK == 512
    q, k, v, _ = _inputs(600, b=1, h=2, seed=7)
    out, lse = blockwise_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                             causal=True)
    assert out.shape == (1, 600, 2, 8) and lse.shape == (1, 2, 600) and lse.dtype == torch.float32
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(8)
    s = np.where(np.tril(np.ones((600, 600), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_cpu_wrappers_take_the_plain_passes_and_count_no_launch():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(37, seed=8))
    before = (blockwise_attention_fwd.launches, blockwise_attention_bwd_dq.launches,
              blockwise_attention_bwd_dkv.launches)
    out, lse = blockwise_attention_fwd(q, k, v, causal=True, block_size=16)
    dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=True, block_size=16)
    dk, dv = blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=True, block_size=16)
    want = blockwise_attention_bwd_reference(q, k, v, out, lse, g, causal=True, block_size=16)
    for a, b_ in zip((dq, dk, dv), want):
        assert torch.equal(a, b_)
    np.testing.assert_allclose(delta.numpy(), np.einsum("bqhd,bqhd->bhq", out.numpy(), g.numpy()),
                               atol=1e-5)
    assert (blockwise_attention_fwd.launches, blockwise_attention_bwd_dq.launches,
            blockwise_attention_bwd_dkv.launches) == before


def test_fully_masked_rows_give_minus_inf_lse_and_zeros():
    """Where every key of a row is masked (a padded row of the schedule, or
    here a key-length cut at 0 through the tile function), the row's lse is
    -inf and its output and gradients exact zeros, never NaN."""
    from tpuframe_torch.ops.ring_attention import _block_update, _tile_grads

    q, k, v, g = (torch.from_numpy(a) for a in _inputs(8, b=1, h=1, seed=9, scale=30.0))
    pos = torch.arange(8)
    o, lsum, m = _block_update(q, k, v, torch.zeros(1, 8, 1, 8), torch.zeros(1, 1, 8),
                               torch.full((1, 1, 8), -math.inf), pos, pos, False, 0.35, kv_len=0)
    lse = m + torch.log(lsum.clamp_min(1e-30))
    assert torch.isneginf(lse).all() and torch.equal(o, torch.zeros_like(o))
    p, ds = _tile_grads(q, k, v, g, lse, torch.zeros(1, 1, 8), pos, pos, False, 0.35, kv_len=0)
    assert torch.equal(p, torch.zeros_like(p)) and torch.equal(ds, torch.zeros_like(ds))


def test_mismatched_shapes_rejected_as_in_jax():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(32))
    with pytest.raises(ValueError, match="must match"):
        blockwise_attention(q, k[:, :16], v)
    qj, kj, vj = (jnp.asarray(a) for a in _inputs(32)[:3])
    with pytest.raises(ValueError, match="must match"):
        jax_blockwise(qj, kj[:, :16], vj)


_SOURCE = Path(build.__file__).resolve().parents[1] / "csrc" / "blockwise_attention.cu"
_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}


@pytest.mark.parametrize("entry", ["fwd", "bwd_dq", "bwd_dkv"])
def test_kernel_interface_matches_its_source_without_a_build(entry, monkeypatch):
    """The C entry points of ``csrc/blockwise_attention.cu``, which cannot be
    built here, against the ``argtypes`` that ``_library()`` declares for
    them: the same number of parameters, each of the ctypes type its C type
    takes.  Read from the source text; ``build.load`` is replaced, so
    nothing is compiled or loaded."""
    src = _SOURCE.read_text()
    assert "tpuframe/ops/blockwise_attention.py" in src  # the function it replaces
    decls = dict(re.findall(r'extern "C" int (tf_blockwise_attention_\w+)\(([^)]*)\)', src))
    assert sorted(decls) == sorted(f"tf_blockwise_attention_{e}" for e in ("fwd", "bwd_dq",
                                                                           "bwd_dkv"))
    assert "blockwise_attention" in build.KERNELS
    fake = SimpleNamespace(**{name: SimpleNamespace() for name in decls})
    monkeypatch.setattr(build, "load", lambda name: fake)
    lib = _library.__wrapped__()  # the uncached body: the cache stays empty
    params = [" ".join(p.split()[:-1]) for p in decls[f"tf_blockwise_attention_{entry}"].split(",")]
    fn = getattr(lib, f"tf_blockwise_attention_{entry}")
    assert [_C_TYPES[p] for p in params] == fn.argtypes
    assert fn.restype is ctypes.c_int
