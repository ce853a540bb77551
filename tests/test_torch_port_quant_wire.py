"""The compressed wire's kernels (K5a amax, K5b encode, K5c decode): the
port's plain versions against ``tpuframe.ops.quant_wire``'s references and
its Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances, each with its reason:

- amax and encode (int8 round half to even, int8 stochastic with the same
  noise array, fp8 e4m3) and the encode's dequantization factor: bit-equal.
  The expressions are the same IEEE operations in the same order.  XLA on
  the CPU runs with subnormals flushed to zero (as the TPU does), so these
  comparisons run under ``torch.set_flush_denormal(True)``; on the card
  the kernel and the plain version both keep subnormals, and are held
  bit-equal there (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
- decode: within 1e-6 (relative and absolute), as the JAX test holds its
  kernel against its reference; NaN, bit for bit in position, where the
  bucket's amax is not finite.
"""

import numpy as np
import pytest
import torch

from tpuframe_torch.ops import build
from tpuframe_torch.ops.quant_wire import (
    bucket_abs_max,
    bucket_abs_max_reference,
    quant_decode,
    quant_decode_reference,
    quant_encode,
    quant_encode_reference,
)

SHAPES = ((1, 64), (3, 130), (8, 2048))

#: 16-wide rows: .5 ties on a grid whose scale is exactly 1 (amax 127),
#: the clip edges, zeros of both signs, subnormals, a bucket whose amax is
#: below FLT_MIN, e4m3 grid points, midpoints and subnormals (amax 448)
EDGE_ROWS = np.stack([
    np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127, -127, 0, -0.0, 3.5, 4.5,
              100.5, -100.5], np.float32),
    np.array([1e-40, -3e-41, 2e-39, 0, 5e-45, -1e-38, 1e-39, 7e-42] + [0] * 8, np.float32),
    np.zeros(16, np.float32),
    np.full(16, -0.0, np.float32),
    np.array([448, -448, 2 ** -9, 2 ** -10, 3 * 2 ** -10, 1, -1, 0.3, 17, 200, 300, 440, 447,
              5.5, 6.5, 7.5], np.float32),
    np.array([1e-30, 2e-37, -3e-36, 1.2e-38, 1.17549435e-38] + [0] * 11, np.float32),
])


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


@pytest.fixture
def ftz():
    """XLA's denormal mode on the CPU: flush to zero."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _case(name: str):
    rng = np.random.default_rng(len(name))
    if name == "edges":
        v = EDGE_ROWS
    else:
        v = (rng.standard_normal(tuple(int(d) for d in name.split("x"))) * 9).astype(np.float32)
    noise = rng.uniform(0, 1, v.shape).astype(np.float32)
    return v, noise


CASES = [f"{r}x{c}" for r, c in SHAPES] + ["edges"]


@pytest.mark.parametrize("case", CASES)
def test_amax_and_encode_are_bit_equal_to_jax(case, ftz):
    import jax.numpy as jnp

    from tpuframe.ops import quant_wire as jq

    v, noise = _case(case)
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    ja = jq.bucket_abs_max_reference(jv)
    ta = bucket_abs_max_reference(tv)
    assert _bits_equal(ta.numpy(), ja)
    assert _bits_equal(ta.numpy(), jq.bucket_abs_max(jv, interpret=True))
    for mode, nz in (("int8", None), ("int8", noise), ("fp8", None)):
        jn = None if nz is None else jnp.asarray(nz)
        want_q, want_d = jq.quant_encode_reference(jv, ja, mode, noise=jn)
        kern_q, _ = jq.quant_encode(jv, ja, mode, noise=jn, interpret=True)
        q, d = quant_encode_reference(tv, ta, mode, None if nz is None else torch.from_numpy(nz))
        tag = (case, mode, nz is not None)
        assert q.dtype == (torch.float32 if mode == "fp8" else torch.int32), tag
        assert _bits_equal(q.numpy(), want_q), tag
        assert _bits_equal(q.numpy(), kern_q), tag
        assert _bits_equal(d.numpy(), want_d), tag


def test_edge_rows_encode_as_the_contract_says():
    """Spot values: ties round to even, the clip holds, fp8 grid points and
    subnormal e4m3 steps survive, a value past the e4m3 rounding edge is
    NaN (torch's own cast would saturate it)."""
    v = torch.from_numpy(EDGE_ROWS[:1])
    q, deq = quant_encode_reference(v, torch.tensor([[127.0]]), "int8")
    assert float(deq) == 1.0
    assert q[0].tolist() == [0, 2, 2, 0, -2, -2, 126, -126, 127, -127, 0, 0, 4, 4, 100, -100]
    noise = torch.tensor([[0.0, 0.5, 0.999999, 0.5] + [0.0] * 12])
    qs, _ = quant_encode_reference(v, torch.tensor([[127.0]]), "int8", noise)
    assert qs[0, :4].tolist() == [0, 2, 3, 0]
    # amax 448: x = (v / 448) * 448 gives these values back exactly (470
    # comes back as 470.00003, past the edge all the same)
    x = torch.tensor([[448.0, -448.0, 2 ** -9, 2 ** -10, 3 * 2 ** -10, 464.0, 470.0, 0.0, 232.0]])
    qf, _ = quant_encode_reference(x, torch.tensor([[448.0]]), "fp8")
    got = qf[0].tolist()
    assert got[:6] == [448.0, -448.0, 2 ** -9, 0.0, 2 ** -8, 448.0]
    assert np.isnan(got[6]) and got[7:] == [0.0, 224.0]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_decode_is_within_1e6_of_jax_and_propagates_nan(mode):
    import jax.numpy as jnp

    from tpuframe.ops import quant_wire as jq

    rng = np.random.default_rng(1)
    if mode == "int8":
        total = rng.integers(-1016, 1016, (5, 256)).astype(np.int32)
    else:  # sums of 8 e4m3 values: multiples of 2**-9, exact in float32
        total = (rng.integers(-8 * 448 * 512, 8 * 448 * 512, (5, 256)) / 512).astype(np.float32)
    amax = (np.abs(rng.standard_normal((5, 1))) * 20).astype(np.float32)
    amax[2, 0], amax[4, 0] = np.inf, np.nan
    want = np.asarray(jq.quant_decode_reference(jnp.asarray(total), jnp.asarray(amax), mode, 8))
    kern = np.asarray(jq.quant_decode(jnp.asarray(total), jnp.asarray(amax), mode, 8,
                                      interpret=True))
    got = quant_decode_reference(torch.from_numpy(total), torch.from_numpy(amax), mode, 8).numpy()
    assert got.dtype == np.float32 and got.shape == total.shape
    for ref in (want, kern):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref), rtol=1e-6, atol=1e-6)
    assert np.isnan(got[2]).all() and np.isnan(got[4]).all()
    assert np.isfinite(got[[0, 1, 3]]).all()


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    v, noise = _case("3x130")
    tv, tn = torch.from_numpy(v), torch.from_numpy(noise)
    counts = (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches)
    amax = bucket_abs_max(tv)
    assert torch.equal(amax, bucket_abs_max_reference(tv))
    for mode, nz in (("int8", None), ("int8", tn), ("fp8", tn)):
        q, d = quant_encode(tv, amax, mode, noise=nz)
        # fp8 ignores the noise, as in JAX
        wq, wd = quant_encode_reference(tv, amax, mode, None if mode == "fp8" else nz)
        assert torch.equal(q, wq) and torch.equal(d, wd)
        mean = quant_decode(q * 2, amax, mode, 2)
        torch.testing.assert_close(mean, quant_decode_reference(q * 2, amax, mode, 2),
                                   rtol=0, atol=0)
    assert (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches) == counts
    with pytest.raises(ValueError, match="unknown wire mode"):
        quant_encode(tv, amax, "int4")
    with pytest.raises(ValueError, match="unknown wire mode"):
        quant_decode(tv, amax, "bf16", 2)


def test_quant_wire_kernel_is_built_with_the_others():
    assert "quant_wire" in build.KERNELS
    src = (build.CSRC / "quant_wire.cu").read_text()
    for entry in ("tf_bucket_abs_max", "tf_quant_encode", "tf_quant_decode"):
        assert f'extern "C" int {entry}(' in src
    # the bit contract needs IEEE divisions and no flush to zero
    assert not any("fast" in f or "ftz" in f for f in build.NVCC_FLAGS)
