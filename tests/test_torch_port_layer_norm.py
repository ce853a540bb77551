"""K3a and K3b, the fused LayerNorm, in the PyTorch port.

The port's plain forward and backward (what a CPU tensor takes) against the
JAX package's Pallas kernels run in interpret mode and ``jax.grad`` through
their custom VJP, on the same numpy inputs.  Tolerances, each with its
reason:

- float32: y and dx within 1e-5 absolute (values O(1); the row sums run in
  another order), dscale and dbias within 1e-5 relative plus 1e-5 (column
  sums over the rows, in 16-row blocks in JAX and in one pass here).
- bfloat16 x, scale and bias: y and dx within one bf16 step of their
  magnitude (2**-8 relative, plus 1e-6): both sides compute in float32 and
  round once, so only a float32 difference at a rounding boundary moves a
  value by a step; dscale and dbias, cast to bf16 after a float32 sum, the
  same.

The CUDA kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuframe.ops.layer_norm import fused_layer_norm as jax_fused
from tpuframe_torch.ops import (
    FusedLayerNorm,
    build,
    fused_layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
)

# (name, rows, D, dtype): the path's width, a ragged D (not a multiple of
# 128, nor of the kernel's 16-byte chunk in bf16), rows not a multiple of 16
CASES = [
    ("f32_24x64", 24, 64, "float32"),
    ("f32_ragged_7x50", 7, 50, "float32"),
    ("bf16_20x96", 20, 96, "bfloat16"),
    ("bf16_ragged_5x300", 5, 300, "bfloat16"),
]


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = rng.normal(0, 0.3, d).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    return x, scale, bias, g


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _close(got: torch.Tensor, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        tol = 1e-5 + (1e-5 * np.abs(want) if what in ("dscale", "dbias") else 0.0)
    else:
        tol = 2.0**-8 * np.abs(want) + 1e-6
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_grads_match_jax_kernels(case):
    _, rows, d, dtype = case
    x, scale, bias, g = _inputs(rows, d, seed=rows + d)
    jx, js, jb, jg = (_to_jax(a, dtype) for a in (x, scale, bias, g))
    jy, vjp = jax.vjp(lambda a, s, b: jax_fused(a, s, b, interpret=True), jx, js, jb)
    jdx, jds, jdb = vjp(jg)

    tx = _to_torch(x, dtype).requires_grad_(True)
    ts = _to_torch(scale, dtype).requires_grad_(True)
    tb = _to_torch(bias, dtype).requires_grad_(True)
    y = fused_layer_norm(tx, ts, tb)
    y.backward(_to_torch(g, dtype))
    assert y.dtype == tx.dtype and tx.grad.dtype == tx.dtype and ts.grad.dtype == ts.dtype
    for what, got, want in (("y", y.detach(), jy), ("dx", tx.grad, jdx),
                            ("dscale", ts.grad, jds), ("dbias", tb.grad, jdb)):
        _close(got, want, dtype, what)


def test_plain_versions_are_the_wrappers_on_the_cpu():
    x, scale, bias, g = (torch.from_numpy(a) for a in _inputs(9, 40, seed=3))
    before = (layer_norm_fwd.launches, layer_norm_bwd.launches)
    torch.testing.assert_close(layer_norm_fwd(x, scale, bias),
                               layer_norm_reference(x, scale, bias), atol=0, rtol=0)
    for a, b in zip(layer_norm_bwd(x, scale, g), layer_norm_bwd_reference(x, scale, g)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (layer_norm_fwd.launches, layer_norm_bwd.launches) == before  # no kernel on the CPU
    assert "layer_norm" in build.KERNELS


def test_eps_is_flax_default_not_torchs():
    """A row of near-constant values: eps 1e-6 (flax) against torch's 1e-5
    changes the output by far more than the tolerance."""
    x = torch.tensor([[1.0, 1.001, 0.999, 1.0]])
    ones, zeros = torch.ones(4), torch.zeros(4)
    want = jax_fused(jnp.asarray(x.numpy()), jnp.ones(4), jnp.zeros(4), interpret=True)
    got = fused_layer_norm(x, ones, zeros)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float((torch.nn.functional.layer_norm(x, (4,), eps=1e-5) - got).abs().max()) > 1e-2


def test_stride_0_gradient_of_a_sum_and_3d_input():
    """The backward of ``y.sum()`` hands over an expanded (stride-0) g; a
    (B, L, D) input normalizes its last axis."""
    x, scale, bias, _ = _inputs(6, 32, seed=5)
    x3 = x.reshape(2, 3, 32)
    jgrads = jax.grad(lambda a, s, b: jnp.sum(jax_fused(a, s, b, interpret=True)),
                      argnums=(0, 1, 2))(jnp.asarray(x3), jnp.asarray(scale), jnp.asarray(bias))
    tx = torch.from_numpy(x3).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    fused_layer_norm(tx, ts, tb).sum().backward()
    for got, want in zip((tx.grad, ts.grad, tb.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_module_matches_flax_parameters_and_casts_its_output():
    from tpuframe.ops.layer_norm import FusedLayerNorm as JaxFusedLayerNorm

    x, _, _, _ = _inputs(4, 16, seed=7)
    jm = JaxFusedLayerNorm(dtype=jnp.bfloat16, use_mesh=False)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    tm = FusedLayerNorm(16, dtype=torch.bfloat16, device="cpu")
    assert tm.scale.dtype == tm.bias.dtype == torch.float32
    np.testing.assert_array_equal(tm.scale.detach().numpy(), np.asarray(variables["params"]["scale"]))
    np.testing.assert_array_equal(tm.bias.detach().numpy(), np.asarray(variables["params"]["bias"]))
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), "bfloat16", "y")
    with pytest.raises(ValueError, match="scale/bias shapes"):
        fused_layer_norm(torch.zeros(2, 5), torch.ones(4), torch.zeros(4))
