"""K2a and K2b, the fused cross entropy, in the PyTorch port.

The port's plain forward and backward (what a CPU tensor takes) against the
JAX package's Pallas kernels run in interpret mode, as ``tests/test_ops.py``
runs them, on the same numpy logits and labels.  Tolerances: f32 losses and
gradients within 1e-5 absolute (the two differ only in the order of the
row sums); bf16 logits are upcast to f32 on both sides, so the losses hold
the same 1e-5, and the bf16 gradients within one bf16 step of their
magnitude (2**-8 relative, plus 1e-6).  The CUDA kernels themselves run
only on the card (``tests/test_torch_port_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuframe.ops.cross_entropy import cross_entropy_reference as jax_reference
from tpuframe.ops.cross_entropy import fused_cross_entropy as jax_fused
from tpuframe_torch.ops import (
    build,
    cross_entropy_bwd,
    cross_entropy_bwd_reference,
    cross_entropy_fwd,
    cross_entropy_reference,
    cross_entropy_stats_reference,
    fused_cross_entropy,
)
from tpuframe_torch.train.step import cross_entropy

# (b, k): K not a multiple of 128, B not a multiple of 16, one wide row
SHAPES = [(8, 10), (13, 1000), (16, 128), (3, 10), (5, 4100)]


def _inputs(b, k, seed, label_dtype=np.int32):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, k)) * 3).astype(np.float32)
    labels = rng.integers(0, k, (b,)).astype(label_dtype)
    return logits, labels


@pytest.mark.parametrize("b,k", SHAPES)
def test_forward_matches_jax_kernel_f32(b, k):
    logits, labels = _inputs(b, k, seed=b + k)
    want = np.asarray(jax_fused(jnp.asarray(logits), jnp.asarray(labels), interpret=True))
    want_ref = np.asarray(jax_reference(jnp.asarray(logits), jnp.asarray(labels)))
    got = fused_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,k", [(8, 10), (13, 1000)])
def test_forward_matches_jax_kernel_bf16(b, k):
    logits, labels = _inputs(b, k, seed=7)
    lj = jnp.asarray(logits, jnp.bfloat16)
    want = np.asarray(jax_fused(lj, jnp.asarray(labels), interpret=True))
    lt = torch.from_numpy(logits).to(torch.bfloat16)
    got = fused_cross_entropy(lt, torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,k", [(12, 37), (13, 1000), (3, 10)])
def test_backward_matches_jax_grad_of_the_mean(b, k):
    logits, labels = _inputs(b, k, seed=3 * b)
    lab = jnp.asarray(labels)
    want = np.asarray(jax.grad(
        lambda lg: jnp.mean(jax_fused(lg, lab, interpret=True)))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    fused_cross_entropy(x, torch.from_numpy(labels)).mean().backward()
    assert x.grad.dtype == torch.float32
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-5)


def test_backward_bf16_gradient_in_logits_dtype():
    logits, labels = _inputs(13, 1000, seed=11)
    lj = jnp.asarray(logits, jnp.bfloat16)
    lab = jnp.asarray(labels)
    want = np.asarray(jax.grad(
        lambda lg: jnp.sum(jax_fused(lg, lab, interpret=True)))(lj)).astype(np.float32)
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_(True)
    fused_cross_entropy(x, torch.from_numpy(labels)).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    got = x.grad.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0**-8 * np.abs(want) + 1e-6)


def test_plain_backward_takes_any_g():
    """The backward of ``losses.mean()`` hands over an expanded g (stride
    0); a weighted g scales each row."""
    logits, labels = _inputs(6, 10, seed=5)
    x, lb = torch.from_numpy(logits), torch.from_numpy(labels)
    g = torch.full((), 1 / 6).expand(6)
    assert g.stride(0) == 0
    want = (torch.softmax(x, -1) - torch.nn.functional.one_hot(lb.long(), 10)) / 6
    torch.testing.assert_close(cross_entropy_bwd(x, lb, g), want, atol=1e-7, rtol=0)
    w = torch.arange(6, dtype=torch.float32)
    torch.testing.assert_close(cross_entropy_bwd_reference(x, lb, w),
                               want * 6 * w[:, None], atol=1e-6, rtol=0)


def test_cpu_tensors_never_launch(monkeypatch):
    monkeypatch.setattr(cross_entropy_fwd, "launches", 0)
    monkeypatch.setattr(cross_entropy_bwd, "launches", 0)
    logits, labels = _inputs(4, 10, seed=1)
    x = torch.from_numpy(logits).requires_grad_(True)
    fused_cross_entropy(x, torch.from_numpy(labels)).mean().backward()
    assert cross_entropy_fwd.launches == 0 and cross_entropy_bwd.launches == 0


def test_reference_agrees_with_optax_integer_labels():
    logits, labels = _inputs(9, 33, seed=9, label_dtype=np.int64)
    want = np.asarray(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels.astype(np.int32))))
    got = cross_entropy_reference(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_soft_labels_take_the_soft_route_like_jax():
    """``train.step.cross_entropy``: soft labels of the logits' rank go to
    the plain soft loss (optax ``softmax_cross_entropy``), with its
    gradient."""
    from tpuframe.train.step import cross_entropy as jax_cross_entropy

    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((6, 12)) * 2).astype(np.float32)
    soft = rng.dirichlet(np.ones(12), 6).astype(np.float32)
    want = np.asarray(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(soft)))
    want_g = np.asarray(jax.grad(
        lambda lg: jnp.mean(jax_cross_entropy(lg, jnp.asarray(soft))))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(x, torch.from_numpy(soft))
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=0, atol=1e-6)
    # higher-rank integer labels: per position, as optax's integer loss
    seq = (rng.standard_normal((2, 3, 7))).astype(np.float32)
    ids = rng.integers(0, 7, (2, 3))
    want_seq = np.asarray(jax_cross_entropy(jnp.asarray(seq), jnp.asarray(ids, jnp.int32)))
    got_seq = cross_entropy(torch.from_numpy(seq), torch.from_numpy(ids))
    np.testing.assert_allclose(got_seq.numpy(), want_seq, rtol=0, atol=1e-5)


def test_kernel_source_names_what_it_replaces():
    src = (build.CSRC / "cross_entropy.cu").read_text()
    assert "tpuframe/ops/cross_entropy.py" in src
    assert 'extern "C" int tf_cross_entropy_fwd' in src
    assert 'extern "C" int tf_cross_entropy_bwd' in src
    assert "cross_entropy" in build.KERNELS


@pytest.mark.parametrize("b,k", [(13, 1000), (16, 128), (5, 4100)])
def test_backward_from_saved_statistics_matches_jax_reference_gradient(b, k):
    """The plain K2b from the forward's row statistics against the gradient
    of JAX's reference loss, on rows whose label also holds the maximum:
    1e-6 absolute (the statistics' float64 sum keeps such rows there)."""
    logits, labels = _inputs(b, k, seed=2 * b + k)
    logits[::2][np.arange(len(labels[::2])), labels[::2]] = 20.0
    g = np.random.default_rng(b).uniform(0.5, 2.0, b).astype(np.float32)
    lab = jnp.asarray(labels)
    want = np.asarray(jax.grad(
        lambda lg: jnp.sum(jax_reference(lg, lab) * jnp.asarray(g)))(jnp.asarray(logits)))
    x, lb = torch.from_numpy(logits), torch.from_numpy(labels)
    loss, stats = cross_entropy_fwd(x, lb, with_stats=True)
    assert stats.shape == (b, 2) and stats.dtype == torch.float32
    torch.testing.assert_close(stats, cross_entropy_stats_reference(x), atol=0, rtol=0)
    torch.testing.assert_close(loss, cross_entropy_reference(x, lb), atol=0, rtol=0)
    got = cross_entropy_bwd(x, lb, torch.from_numpy(g), stats)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_function_saves_statistics_and_matches_the_stats_less_gradient(dtype):
    """With a gradient to take, the forward saves its row statistics and the
    backward uses them: the gradient equals the stats-less backward's bit
    for bit.  Without one, nothing beyond logits is computed."""
    logits, labels = _inputs(13, 1000, seed=21)
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    lb = torch.from_numpy(labels)
    loss = fused_cross_entropy(x, lb)
    saved = loss.grad_fn.saved_tensors
    assert len(saved) == 3
    torch.testing.assert_close(saved[2], cross_entropy_stats_reference(x.detach()),
                               atol=0, rtol=0)
    loss.mean().backward()
    g = torch.full((), 1 / 13).expand(13)
    want = cross_entropy_bwd(x.detach(), lb, g)
    assert torch.equal(x.grad, want)
    with torch.no_grad():
        assert fused_cross_entropy(x, lb).grad_fn is None
