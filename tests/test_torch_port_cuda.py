"""The port on the card: the CUDA kernels (K1 normalize, K2a/K2b cross
entropy, K3a/K3b LayerNorm, K4 fused AdamW over one tensor and over
lists, K5a/K5b/K5c the compressed
wire's amax, encode and decode, K6a/K6b/K6c blockwise attention forward
and backward) against their plain versions, the launch counts of a
blockwise LM step with and without ``remat``, the launch
floor's counter, a parameter without a gradient stepped by K4, the
compressed wire's sync on the card against the CPU, a
small serve slice, a small ``Trainer.fit``, eval mode for a model left in
train mode, the launch counts of one LM train step, and BatchNorm with
statistics across two gloo ranks on the card against one process's.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's dependencies::

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

(``--noconftest``: the suite's ``conftest.py`` imports JAX.)
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.models import ResNet18, TransformerLM
from tpuframe_torch.ops import (
    FusedAdamW,
    blockwise_attention_bwd_dkv,
    blockwise_attention_bwd_dq,
    blockwise_attention_bwd_reference,
    blockwise_attention_fwd,
    blockwise_attention_reference,
    cross_entropy_bwd,
    cross_entropy_bwd_reference,
    cross_entropy_fwd,
    cross_entropy_reference,
    cross_entropy_stats_reference,
    fused_adamw,
    fused_adamw_multi_update_,
    fused_adamw_update_,
    fused_adamw_update_reference,
    fused_cross_entropy,
    fused_layer_norm,
    launch_floor,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_fwd,
    layer_norm_reference,
    normalize_images,
    normalize_images_reference,
)
from tpuframe_torch.ops.fused_adamw import TABLE_CAPACITY
from tpuframe_torch.parallel import bf16_compute, full_precision
from tpuframe_torch.serve import ServeEngine, ServeKnobs
from tpuframe_torch.train import (
    Trainer,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_predict_fn,
    make_train_step,
)

pytestmark = pytest.mark.cuda

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the port's kernels have no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    # f32 comparisons below hold full f32 convolutions and products
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _uint8(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


# (name, input, mean, std, scale): C = 3 at element counts that are no
# multiple of the kernel's 48 (105, 3,468), the serve bucket 1 and the train
# batch 128 at 224 px, C = 1 in uint8 and f32, 16 channels (the general
# kernel)
INPUTS = [
    ("rgb_ragged", lambda: _uint8((4, 17, 17, 3)), MEAN, STD, 1 / 255),
    ("rgb_105", lambda: _uint8((1, 5, 7, 3), seed=2), MEAN, STD, 1 / 255),
    ("rgb_1x224", lambda: _uint8((1, 224, 224, 3), seed=3), MEAN, STD, 1 / 255),
    ("rgb_224", lambda: _uint8((2, 224, 224, 3)), MEAN, STD, 1 / 255),
    ("rgb_128x224", lambda: _uint8((128, 224, 224, 3), seed=4), MEAN, STD, 1 / 255),
    ("gray_uint8", lambda: _uint8((3, 9, 11, 1), seed=5), (0.5,), (0.25,), 1 / 255),
    ("gray_float", lambda: torch.from_numpy(
        np.random.default_rng(1).random((2, 28, 28, 1), dtype=np.float32)), (0.5,), (0.5,), 1.0),
    ("float_0_255", lambda: _uint8((3, 9, 7, 3)).float(), MEAN, STD, 1 / 255),
    ("sixteen_channels", lambda: _uint8((3, 5, 7, 16)),
     tuple(np.linspace(0.1, 0.9, 16)), tuple(np.linspace(0.2, 0.3, 16)), 1 / 255),
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", INPUTS, ids=[c[0] for c in INPUTS])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_kernel_matches_plain_version(card, case, out_dtype, aligned):
    _, make, mean, std, scale = case
    host = make()
    if aligned:
        x = host.to(card)
    else:  # contiguous, one element off a 16-byte boundary
        flat = torch.empty(host.numel() + 1, dtype=host.dtype, device=card)
        x = flat[1:].view(host.shape)
        x.copy_(host)
    before = normalize_images.launches
    got = normalize_images(x, mean, std, scale=scale, out_dtype=out_dtype)
    want = normalize_images_reference(x, mean, std, scale=scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert normalize_images.launches == before + 1
    assert got.dtype == out_dtype and got.shape == x.shape and got.device == x.device
    if out_dtype == torch.float32:  # one FMA against separate operations
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:  # the two may round to neighbouring bf16 values
        step = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp(min=1.0)
        assert bool(((got.float() - want.float()).abs() <= step).all())


def test_kernel_refuses_what_it_does_not_take(card):
    x = _uint8((2, 4, 4, 3)).to(card)
    with pytest.raises(TypeError, match="uint8 or float32"):
        normalize_images(x.int(), MEAN, STD)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        normalize_images(x, MEAN, STD, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        normalize_images(x.transpose(1, 2), MEAN, STD)
    wide = _uint8((1, 2, 2, 17)).to(card)
    with pytest.raises(ValueError, match="channels"):
        normalize_images(wide, (0.5,) * 17, (0.5,) * 17)


def test_small_slice_on_card_matches_cpu(card):
    """ResNet18 through ``make_predict_fn`` with the fused normalize, f32,
    on the card (TF32 off) against the same model on the CPU; then a few
    requests through ``ServeEngine`` on the card, one kernel launch per
    served batch."""
    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device=card, seed=3)
    predict = make_predict_fn(full_precision(), functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32))
    x = _uint8((5, 32, 32, 3), seed=4)
    on_card = predict(model, x.to(card)).cpu()
    model_cpu = ResNet18(num_classes=10, num_filters=8, stem="cifar", device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    on_cpu = predict(model_cpu, x)
    # the same f32 arithmetic; only the order of the sums differs
    torch.testing.assert_close(on_card, on_cpu, atol=1e-4, rtol=1e-3)

    knobs = ServeKnobs(buckets=(1, 4), batch_wait_ms=2.0, slo_ms=60_000)
    with ServeEngine(functools.partial(predict, model), knobs=knobs,
                     item_shape=(32, 32, 3), dtype="uint8") as eng:
        assert eng.device.type == "cuda"
        normalize_images.launches = 0
        futures = [eng.submit(img) for img in x.numpy()]
        outs = [f.result(timeout=120) for f in futures]
        eng.drain(timeout=60)
    assert {f.verdict for f in futures} == {"ok"}
    assert 2 <= normalize_images.launches <= 5
    for out, want in zip(outs, on_card):
        torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-3)


# -- K2a / K2b: cross entropy ------------------------------------------------

# (name, B, K, dtype): the train path's shape, a ragged bf16 batch, a tiny
# ragged row, K not a multiple of 4 (element loads), a K the warp cannot
# keep in registers, K above 4096 (a block per row), the HBM-bound shape
CE_CASES = [
    ("128x1000_f32", 128, 1000, torch.float32),
    ("130x1000_bf16", 130, 1000, torch.bfloat16),
    ("3x10_f32", 3, 10, torch.float32),
    ("3x10_bf16", 3, 10, torch.bfloat16),
    ("7x1001_f32", 7, 1001, torch.float32),
    ("9x3000_f32", 9, 3000, torch.float32),
    ("5x5000_f32", 5, 5000, torch.float32),
    ("5x5000_bf16", 5, 5000, torch.bfloat16),
    ("16384x1000_f32", 16384, 1000, torch.float32),
]


def _ce_inputs(b, k, dtype, label_dtype, card, seed=0):
    rng = np.random.default_rng(seed + b + k)
    logits = torch.from_numpy((rng.standard_normal((b, k)) * 3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, k, (b,))).to(label_dtype)
    return logits.to(dtype).to(card), labels.to(card)


def _close_in_dtype(got, want):
    """f32 within 1e-6 absolute (gradients are O(1/B)..O(1), the sums run
    in another order); bf16 within one bf16 step of the value."""
    if got.dtype == torch.float32:
        return bool(((got - want).abs() <= 1e-6).all())
    step = torch.finfo(torch.bfloat16).eps * want.float().abs() + 1e-6
    return bool(((got.float() - want.float()).abs() <= step).all())


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("case", CE_CASES, ids=[c[0] for c in CE_CASES])
def test_cross_entropy_kernels_match_plain_versions(card, case, label_dtype):
    _, b, k, dtype = case
    logits, labels = _ce_inputs(b, k, dtype, label_dtype, card)
    f0, b0 = cross_entropy_fwd.launches, cross_entropy_bwd.launches
    loss = cross_entropy_fwd(logits, labels)
    g = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 2, b).astype(np.float32)).to(card)
    grad = cross_entropy_bwd(logits, labels, g)
    torch.cuda.synchronize()
    assert cross_entropy_fwd.launches == f0 + 1 and cross_entropy_bwd.launches == b0 + 1
    assert loss.dtype == torch.float32 and loss.shape == (b,)
    assert grad.dtype == dtype and grad.shape == (b, k)
    # losses of O(10): 1e-5 absolute
    torch.testing.assert_close(loss, cross_entropy_reference(logits, labels), atol=1e-5, rtol=0)
    assert _close_in_dtype(grad, cross_entropy_bwd_reference(logits, labels, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cross_entropy_backward_of_the_mean_takes_a_stride_0_g(card, dtype):
    logits, labels = _ce_inputs(128, 1000, dtype, torch.int64, card)
    x = logits.clone().requires_grad_(True)
    b0 = cross_entropy_bwd.launches
    fused_cross_entropy(x, labels).mean().backward()  # g = expand(1/B), stride 0
    torch.cuda.synchronize()
    assert cross_entropy_bwd.launches == b0 + 1
    g = torch.full((), 1 / 128, device=card).expand(128)
    assert g.stride(0) == 0
    assert _close_in_dtype(x.grad, cross_entropy_bwd_reference(logits, labels, g))


def test_cross_entropy_kernel_refuses_what_it_does_not_take(card):
    logits, labels = _ce_inputs(8, 16, torch.float32, torch.int32, card)
    with pytest.raises(ValueError, match="contiguous in rows"):
        cross_entropy_fwd(logits.t().contiguous().t(), labels)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cross_entropy_fwd(logits.half(), labels)
    with pytest.raises(TypeError, match="int32 or int64"):
        cross_entropy_fwd(logits, labels.to(torch.int16))
    with pytest.raises(ValueError, match="float32 g"):
        cross_entropy_bwd(logits, labels, torch.ones(8, device=card, dtype=torch.float64))


# the forward's paths at their edges: rows in registers up to 1024 f32 and
# 2048 bf16, streamed up to 4096, a block per row above; element loads where
# K is no multiple of the 16-byte chunk
CE_FWD_K = [("1000_f32", 1000, torch.float32), ("1001_f32", 1001, torch.float32),
            ("1024_f32", 1024, torch.float32), ("2048_bf16", 2048, torch.bfloat16),
            ("4096_f32", 4096, torch.float32), ("4097_f32", 4097, torch.float32)]


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("b", [1, 128, 16384])
@pytest.mark.parametrize("case", CE_FWD_K, ids=[c[0] for c in CE_FWD_K])
def test_cross_entropy_forward_paths_take_edge_labels(card, case, b, label_dtype):
    """Labels at 0 and at K - 1, and rows whose label holds the row's
    maximum.  The loss is held against the plain version.  On the rows whose
    label holds the maximum the softmax is 1 less a small sum; there the
    plain version's float32 sums lie several times further from the float64
    softmax than the kernel's float64 row sum, on this data past the 1e-6
    tolerance at B = 16384: so the backward is held against the float64
    softmax, at the f32 gradient tolerance."""
    _, k, dtype = case
    rng = np.random.default_rng(k + b)
    logits = (rng.standard_normal((b, k)) * 3).astype(np.float32)
    labels = rng.integers(0, k, (b,))
    labels[0::3], labels[1::3] = 0, k - 1
    logits[2::3][np.arange(len(labels[2::3])), labels[2::3]] = 20.0
    x = torch.from_numpy(logits).to(dtype).to(card)
    lab = torch.from_numpy(labels).to(label_dtype).to(card)
    f0 = cross_entropy_fwd.launches
    loss = cross_entropy_fwd(x, lab)
    g = torch.from_numpy(rng.uniform(0.5, 2, b).astype(np.float32)).to(card)
    grad = cross_entropy_bwd(x, lab, g)
    torch.cuda.synchronize()
    assert cross_entropy_fwd.launches == f0 + 1
    torch.testing.assert_close(loss, cross_entropy_reference(x, lab), atol=1e-5, rtol=0)
    onehot = torch.nn.functional.one_hot(lab.long(), k).double()
    exact = (torch.softmax(x.double(), -1) - onehot) * g.double()[:, None]
    assert _close_in_dtype(grad, exact.to(dtype))


# K2b from the forward's row statistics: the train path's (128, 1000) and
# the HBM-bound (16384, 1000), a streamed row (1001: element loads) and a
# row a block owns (4097), in f32 and bf16
CE_STATS = [(b, k, dt) for b, k in ((128, 1000), (16384, 1000), (64, 1001), (16, 4097))
            for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("case", CE_STATS,
                         ids=[f"{b}x{k}_{'f32' if dt == torch.float32 else 'bf16'}"
                              for b, k, dt in CE_STATS])
def test_cross_entropy_backward_from_saved_statistics(card, case):
    """K2a's statistics against the plain ones; K2b from them bit-equal to
    the stats-less K2b (both take the same row max and 1/s, every element by
    one expression) and to the plain version at the dtype's tolerance; rows
    whose label holds the maximum against the float64 softmax at 1e-6."""
    b, k, dtype = case
    rng = np.random.default_rng(b + k)
    logits = (rng.standard_normal((b, k)) * 3).astype(np.float32)
    labels = rng.integers(0, k, (b,))
    logits[2::3][np.arange(len(labels[2::3])), labels[2::3]] = 20.0  # label on the max
    x = torch.from_numpy(logits).to(dtype).to(card)
    lab = torch.from_numpy(labels).to(card)
    g = torch.from_numpy(rng.uniform(0.5, 2, b).astype(np.float32)).to(card)
    f0, b0 = cross_entropy_fwd.launches, cross_entropy_bwd.launches
    loss, stats = cross_entropy_fwd(x, lab, with_stats=True)
    grad = cross_entropy_bwd(x, lab, g, stats)
    torch.cuda.synchronize()
    assert cross_entropy_fwd.launches == f0 + 1 and cross_entropy_bwd.launches == b0 + 1
    assert stats.shape == (b, 2) and stats.dtype == torch.float32
    torch.testing.assert_close(loss, cross_entropy_fwd(x, lab), atol=0, rtol=0)
    want = cross_entropy_stats_reference(x)
    assert torch.equal(stats[:, 0], want[:, 0])  # the max is exact
    # 1/s: the kernel sums chunks of 4 (f32) or 8 (bf16) exponentials in
    # float32 before its float64 row sum, the plain version each one into
    # float64; a few float32 ulps apart
    torch.testing.assert_close(stats[:, 1], want[:, 1], atol=0, rtol=5e-7)
    assert torch.equal(grad.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       cross_entropy_bwd(x, lab, g).view(
                           torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert _close_in_dtype(grad, cross_entropy_bwd_reference(x, lab, g))
    assert _close_in_dtype(grad, cross_entropy_bwd_reference(x, lab, g, stats))
    onehot = torch.nn.functional.one_hot(lab.long(), k).double()
    exact = (torch.softmax(x.double(), -1) - onehot) * g.double()[:, None]
    assert _close_in_dtype(grad[2::3], exact[2::3].to(dtype))


def test_cross_entropy_backward_refuses_bad_statistics(card):
    logits, labels = _ce_inputs(8, 16, torch.float32, torch.int32, card)
    g = torch.ones(8, device=card)
    _, stats = cross_entropy_fwd(logits, labels, with_stats=True)
    for bad in (stats.double(), stats[:4], stats.t().contiguous().t()[:, :1].expand(8, 2),
                stats.cpu()):
        with pytest.raises(ValueError, match="stats"):
            cross_entropy_bwd(logits, labels, g, bad)


def test_fused_cross_entropy_saves_statistics_only_for_a_gradient(card):
    logits, labels = _ce_inputs(128, 1000, torch.float32, torch.int64, card)
    x = logits.clone().requires_grad_(True)
    loss = fused_cross_entropy(x, labels)
    assert len(loss.grad_fn.saved_tensors) == 3  # logits, labels, statistics
    with torch.no_grad():
        f0 = cross_entropy_fwd.launches
        fused_cross_entropy(x, labels)
        assert cross_entropy_fwd.launches == f0 + 1


def test_launch_floor_counts_one_per_launch(card):
    before = launch_floor.launches
    for i in range(3):
        launch_floor(card)
        assert launch_floor.launches == before + i + 1
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="card"):
        launch_floor("cpu")
    assert launch_floor.launches == before + 3


class _Gated(torch.nn.Module):
    """``x[:, :-2] @ w + b``, plus ``x[:, -2:-1] * z`` when that column is
    not all zero; ``u`` is never used.  Autograd leaves ``u`` (and ``z`` on
    a batch whose gate column is zero) without a gradient."""

    def __init__(self, device):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        for name, shape in (("w", (6, 5)), ("b", (5,)), ("z", (5,)), ("u", (3,))):
            setattr(self, name, torch.nn.Parameter(torch.randn(shape, generator=gen).to(device)))

    def forward(self, x):
        out = x[:, :-2] @ self.w + self.b
        if bool(x[:, -2].any()):
            out = out + x[:, -2:-1] * self.z
        return out


def test_fused_adamw_steps_a_parameter_without_gradient_on_the_card(card):
    """Every parameter reaches K4 with a gradient, a fresh zero tensor where
    autograd left none: one launch a step over one table kept across the
    steps (the gradient addresses are written each step), and the same
    parameters as the plain update on the CPU."""
    gen = np.random.default_rng(1)
    batches = []
    for step in range(3):
        x = gen.normal(0, 1, (8, 8)).astype(np.float32)
        x[:, -2] = 0.0 if step == 0 else 1.0
        batches.append({"image": torch.from_numpy(x),
                        "label": torch.from_numpy(gen.integers(0, 5, (8,)))})
    results = {}
    for device in ("cpu", card):
        model = _Gated(device)
        state = create_train_state(model, fused_adamw(1e-2, weight_decay=0.1))
        step = make_train_step(full_precision())
        fused_adamw_multi_update_.launches = 0
        plans = []
        for b in batches:
            state, _ = step(state, {k: v.to(device) for k, v in b.items()})
            plans.append(state.optimizer._launch_plans[0])
        results[str(device)] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        if device == card:
            torch.cuda.synchronize()
            assert fused_adamw_multi_update_.launches == 3
            assert plans[0] is plans[1] is plans[2]  # one table for every step
        assert {int(st["count"]) for st in state.optimizer.state.values()} == {3}
    for n, want in results["cpu"].items():
        torch.testing.assert_close(results["cuda"][n], want, atol=1e-6, rtol=0, msg=n)


def test_small_trainer_fit_on_card_launches_every_kernel(card):
    """A few steps of a small ResNet18 through ``Trainer.fit`` with uint8
    images normalized on the card: K1 in every train and eval step, K2a in
    every train step and eval batch, K2b in every train step."""
    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device=card, seed=1)
    train = DataLoader(SyntheticImageDataset(n=64, image_size=32), 16, shuffle=True,
                       transfer_dtype="uint8")
    evl = DataLoader(SyntheticImageDataset(n=20, image_size=32, seed=5), 8, drop_last=False,
                     transfer_dtype="uint8")
    trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl, optimizer="sgd",
                      lr=0.05, max_duration="6ba", normalize=(MEAN, STD), log_interval=2)
    normalize_images.launches = cross_entropy_fwd.launches = cross_entropy_bwd.launches = 0
    result = trainer.fit()
    torch.cuda.synchronize()
    # 6 steps over two epochs of 4 batches (4 + 2), one eval of 3 batches each
    n_eval = 3 * len(result.history)
    assert cross_entropy_bwd.launches == 6
    assert cross_entropy_fwd.launches == 6 + n_eval
    assert normalize_images.launches == 6 + n_eval
    for h in result.history:
        assert np.isfinite(h["train_loss"]) and np.isfinite(h["eval_loss"])
        assert h["health_bad_steps"] == 0.0
    assert trainer.state.step == 6 and not model.training


def test_model_left_in_train_mode_is_served_with_running_statistics(card):
    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device=card, seed=2)
    x = _uint8((4, 32, 32, 3), seed=9).to(card)
    predict = make_predict_fn(full_precision(), functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32))
    want = predict(model, x)
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    got = predict(model, x)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    y = torch.from_numpy(np.arange(4) % 10).to(card)
    from tpuframe_torch.train import create_train_state, make_optimizer

    state = create_train_state(model, make_optimizer("sgd", 0.1))
    m = make_eval_step(full_precision(), batch_transform=lambda b: {
        **b, "image": normalize_images(b["image"], MEAN, STD)})(state, {"image": x, "label": y})
    assert float(m["count"]) == 4.0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, stats[k], atol=0, rtol=0)
    assert model.training


# -- K3a / K3b: LayerNorm ----------------------------------------------------

# (name, rows, D, x dtype, scale dtype): the LM path's (16384, 768) bf16 with
# the policy's bf16 scale, the same in f32, f32 x with a bf16 scale and the
# reverse, a ragged f32 row the register path takes, a ragged bf16 row (300
# is no multiple of 8: element path), the widest register row in bf16, and
# a row too wide for the registers; one row, fewer rows than the backward
# grid's warps (2 blocks of 8 an SM), and the widest f32 register row (one
# block an SM) over many blocks
LN_CASES = [
    ("16384x768_bf16", 16384, 768, torch.bfloat16, torch.bfloat16),
    ("16384x768_f32", 16384, 768, torch.float32, torch.float32),
    ("64x768_bf16_x_f32_scale", 64, 768, torch.bfloat16, torch.float32),
    ("64x768_f32_x_bf16_scale", 64, 768, torch.float32, torch.bfloat16),
    ("1000x300_f32", 1000, 300, torch.float32, torch.float32),
    ("1000x300_bf16", 1000, 300, torch.bfloat16, torch.bfloat16),
    ("33x2048_bf16", 33, 2048, torch.bfloat16, torch.bfloat16),
    ("9x4100_f32", 9, 4100, torch.float32, torch.float32),
    ("1x768_bf16", 1, 768, torch.bfloat16, torch.bfloat16),
    ("1x768_f32", 1, 768, torch.float32, torch.float32),
    ("100x768_bf16", 100, 768, torch.bfloat16, torch.bfloat16),
    ("3000x1024_f32", 3000, 1024, torch.float32, torch.float32),
    ("2048x2048_bf16", 2048, 2048, torch.bfloat16, torch.bfloat16),
]


def _ln_inputs(rows, d, dtype, sdtype, card, seed=0):
    rng = np.random.default_rng(seed + rows + d)
    x = torch.from_numpy((rng.standard_normal((rows, d)) * 2 + 0.5).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, d).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32))
    return (x.to(dtype).to(card), scale.to(sdtype).to(card), bias.to(sdtype).to(card),
            g.to(dtype).to(card))


def _ln_sums_close(got, want, terms):
    """dscale/dbias: f32 within 2e-5 of the column's sum of |terms| (a
    float32 sum of 16384 terms in another order: per lane, then per warp,
    then over the blocks' partials); bf16 within one bf16 step."""
    if got.dtype == torch.bfloat16:
        return _close_in_dtype(got, want)
    return bool(((got - want).abs() <= 2e-5 * terms + 1e-6).all())


@pytest.mark.parametrize("case", LN_CASES, ids=[c[0] for c in LN_CASES])
def test_layer_norm_kernels_match_plain_versions(card, case):
    _, rows, d, dtype, sdtype = case
    x, scale, bias, g = _ln_inputs(rows, d, dtype, sdtype, card)
    f0, b0 = layer_norm_fwd.launches, layer_norm_bwd.launches
    y = layer_norm_fwd(x, scale, bias)
    dx, dscale, dbias = layer_norm_bwd(x, scale, g)
    torch.cuda.synchronize()
    assert layer_norm_fwd.launches == f0 + 1 and layer_norm_bwd.launches == b0 + 1
    assert y.dtype == dx.dtype == dtype and dscale.dtype == dbias.dtype == sdtype
    want_dx, want_ds, want_db = layer_norm_bwd_reference(x, scale, g)
    # f32: 1e-5 absolute on O(1) values (sums in another order); bf16: one
    # bf16 step
    if dtype == torch.float32:
        torch.testing.assert_close(y, layer_norm_reference(x, scale, bias), atol=1e-5, rtol=0)
        torch.testing.assert_close(dx, want_dx, atol=1e-5, rtol=0)
    else:
        assert _close_in_dtype(y, layer_norm_reference(x, scale, bias))
        assert _close_in_dtype(dx, want_dx)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + 1e-6)
    assert _ln_sums_close(dscale, want_ds, (g.float() * xhat).abs().sum(0))
    assert _ln_sums_close(dbias, want_db, g.float().abs().sum(0))
    # no float atomics: a rerun gives the same bits
    again = layer_norm_bwd(x, scale, g)
    for a, b in zip((dx, dscale, dbias), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["stride_0", "transposed"])
def test_layer_norm_backward_takes_any_gradient_strides(card, layout):
    x, scale, bias, g = _ln_inputs(256, 768, torch.bfloat16, torch.bfloat16, card)
    if layout == "stride_0":  # the backward of y.sum()
        xr = x.clone().requires_grad_(True)
        b0 = layer_norm_bwd.launches
        fused_layer_norm(xr, scale, bias).sum().backward()
        assert layer_norm_bwd.launches == b0 + 1
        g = torch.ones((), dtype=x.dtype, device=card).expand(x.shape)
        got = xr.grad
    else:
        g = g.t().contiguous().t()
        assert not g.is_contiguous()
        got = layer_norm_bwd(x, scale, g)[0]
    torch.cuda.synchronize()
    assert _close_in_dtype(got, layer_norm_bwd_reference(x, scale, g)[0])


@pytest.mark.parametrize("case", [("16384x768_bf16", 16384, 768, torch.bfloat16),
                                  ("1000x300_f32", 1000, 300, torch.float32)],
                         ids=["16384x768_bf16", "1000x300_f32"])
def test_layer_norm_backward_takes_a_misaligned_g(card, case):
    """A contiguous g one element off the 16-byte alignment (the element
    path): within the plain-version tolerances, the same bits on a rerun."""
    _, rows, d, dtype = case
    x, scale, _, g = _ln_inputs(rows, d, dtype, dtype, card)
    flat = torch.empty(rows * d + 1, dtype=dtype, device=card)
    g_off = flat[1:].view(rows, d)
    g_off.copy_(g)
    got = layer_norm_bwd(x, scale, g_off)
    torch.cuda.synchronize()
    want_dx, want_ds, want_db = layer_norm_bwd_reference(x, scale, g)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want_dx, atol=1e-5, rtol=0)
    else:
        assert _close_in_dtype(got[0], want_dx)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + 1e-6)
    assert _ln_sums_close(got[1], want_ds, (g.float() * xhat).abs().sum(0))
    assert _ln_sums_close(got[2], want_db, g.float().abs().sum(0))
    for a, b in zip(got, layer_norm_bwd(x, scale, g_off)):
        assert torch.equal(a, b)


def test_layer_norm_kernels_refuse_what_they_do_not_take(card):
    x, scale, bias, g = _ln_inputs(8, 16, torch.float32, torch.float32, card)
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        layer_norm_fwd(x.half(), scale, bias)
    with pytest.raises(TypeError, match="of one dtype"):
        layer_norm_fwd(x, scale, bias.bfloat16())
    with pytest.raises(ValueError, match="rows, D"):
        layer_norm_fwd(x, scale[:8], bias[:8])
    with pytest.raises(ValueError, match="g like x"):
        layer_norm_bwd(x, scale, g.bfloat16())


# -- K4: fused AdamW -----------------------------------------------------------

# (name, shape, param dtype, hyperparameters, offset): the LM's largest
# leaf (the 32768 x 768 embedding), its smallest (a 768 bias), the ragged
# 257 x 130 leaf, a bf16 leaf, momentum-free Adam, and a leaf one element
# off the vector alignment
ADAMW_CASES = [
    ("32768x768_f32", (32768, 768), torch.float32, dict(lr=3e-4, weight_decay=1e-4), 0),
    ("768_f32", (768,), torch.float32, dict(lr=3e-4, weight_decay=1e-4), 0),
    ("257x130_f32", (257, 130), torch.float32, dict(lr=1e-2, weight_decay=0.01), 0),
    ("64x768_bf16", (64, 768), torch.bfloat16, dict(lr=1e-2, weight_decay=1e-4), 0),
    ("b1_zero", (33, 7), torch.float32, dict(lr=1e-2, b1=0.0), 0),
    ("unaligned_1001", (1001,), torch.float32,
     dict(lr=3e-3, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.05), 1),
]


@pytest.mark.parametrize("case", ADAMW_CASES, ids=[c[0] for c in ADAMW_CASES])
def test_fused_adamw_kernel_matches_plain_version(card, case):
    _, shape, dtype, hp, offset = case
    rng = np.random.default_rng(sum(shape))
    n = int(np.prod(shape))

    def on_card(a, dt=torch.float32):
        flat = torch.empty(n + offset, dtype=dt, device=card)
        t = flat[offset:].view(shape)
        t.copy_(torch.from_numpy(a.astype(np.float32)).to(dt))
        return t

    p = on_card(rng.standard_normal(shape), dtype)
    g = on_card(rng.standard_normal(shape), dtype)
    m = on_card(rng.standard_normal(shape) * 0.1)
    v = on_card(rng.uniform(0, 0.1, shape))
    count = torch.tensor(7, dtype=torch.int32, device=card)
    want = fused_adamw_update_reference(p, g, m, v, count, **hp)
    l0 = fused_adamw_update_.launches
    fused_adamw_update_(p, g, m, v, count, **hp)
    torch.cuda.synchronize()
    assert fused_adamw_update_.launches == l0 + 1
    # f32: 1e-6 absolute (the same float32 expression; the compiler may
    # fuse a multiply-add); bf16 parameters within one bf16 step
    torch.testing.assert_close(m, want[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(v, want[2], atol=1e-6, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(p, want[0], atol=1e-6, rtol=0)
    else:
        assert _close_in_dtype(p, want[0])


def _gpt2_small_shapes(card):
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, head_dim=64,
                          max_len=1024, device=card, seed=0)
    return [tuple(p.shape) for p in model.parameters()]


def test_fused_adamw_lists_match_plain_and_one_entry_calls(card):
    """One launch over the 149 GPT-2-small tensors plus a view one element
    off the vector alignment, and two over TABLE_CAPACITY + 7 small tensors:
    within 1e-6 of the plain version and bit-equal to a one-entry call per
    tensor."""
    gen = torch.Generator(device=card).manual_seed(0)
    hp = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    count = torch.tensor(7, dtype=torch.int32, device=card)

    def leaf(shape, offset=0):
        n = int(np.prod(shape))
        out = []
        for scale, fill in ((1.0, torch.randn), (1.0, torch.randn), (0.1, torch.randn),
                            (0.1, torch.rand)):
            t = torch.empty(n + offset, device=card)[offset:].view(shape)
            t.copy_(fill(shape, generator=gen, device=card) * scale)
            out.append(t)
        return out

    shapes = _gpt2_small_shapes(card)
    assert len(shapes) == 149
    small = np.random.default_rng(1).integers(1, 5000, TABLE_CAPACITY + 7)
    for leaves, launches in (([leaf(s) for s in shapes] + [leaf((1001,), offset=1)], 1),
                             ([leaf((int(k),)) for k in small], 2)):
        want = [fused_adamw_update_reference(p, g, m, v, count, **hp) for p, g, m, v in leaves]
        multi = [(p.clone(), m.clone(), v.clone()) for p, _, m, v in leaves]
        l0 = fused_adamw_multi_update_.launches
        fused_adamw_multi_update_([t[0] for t in multi], [lf[1] for lf in leaves],
                                  [t[1] for t in multi], [t[2] for t in multi],
                                  [count] * len(leaves), **hp)
        assert fused_adamw_multi_update_.launches == l0 + launches
        for (p, g, m, v), got, w in zip(leaves, multi, want):
            fused_adamw_update_(p, g, m, v, count, **hp)  # in place: the one-entry call
            for a, b, c in zip(got, (p, m, v), w):
                assert torch.equal(a, b)
                torch.testing.assert_close(a, c, atol=1e-6, rtol=0)
        del leaves, want, multi


def test_fused_adamw_steps_the_same_after_load_state_dict(card):
    """A bf16 and a float32 parameter in one group (two launches a step):
    an optimizer loaded from another's state after its first step keeps
    the int32 counts and float32 moments, and its second step gives the
    same bits as the original's."""
    gen = torch.Generator(device=card).manual_seed(0)
    shapes = ((64, 768), (768,))
    start = [torch.randn(s, generator=gen, device=card) for s in shapes]
    grads = [[torch.randn(s, generator=gen, device=card) for s in shapes] for _ in range(2)]

    def params():
        return [torch.nn.Parameter(start[0].bfloat16()), torch.nn.Parameter(start[1].clone())]

    first = params()
    opt = FusedAdamW(first, lr=1e-2, weight_decay=1e-4)
    for p, g in zip(first, grads[0]):
        p.grad = g.to(p.dtype)
    opt.step()
    second = [torch.nn.Parameter(p.detach().clone()) for p in first]
    loaded = FusedAdamW(second, lr=1e-2, weight_decay=1e-4)
    loaded.load_state_dict(opt.state_dict())
    l0 = fused_adamw_multi_update_.launches
    for o, ps in ((opt, first), (loaded, second)):
        for p, g in zip(ps, grads[1]):
            p.grad = g.to(p.dtype)
        o.step()
    torch.cuda.synchronize()
    assert fused_adamw_multi_update_.launches == l0 + 4
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        sa, sb = opt.state[a], loaded.state[b]
        assert sb["count"].dtype == torch.int32 and sb["mu"].dtype == torch.float32
        for k in ("count", "mu", "nu"):
            assert torch.equal(sa[k], sb[k])


def test_lm_train_step_launch_counts(card):
    """One bf16 train step of a 3-layer LM with ``fused_adamw``: K3a once
    per LayerNorm (2 per block + ``ln_f``), K3b as often in the backward,
    K4 once for all parameter tensors (one group, one dtype); the cross
    entropy of (B, L) labels is the plain per-position loss, so K2a/K2b
    stay at 0, as does K1."""
    model = TransformerLM(vocab_size=512, num_layers=3, num_heads=4, head_dim=32, max_len=64,
                          device=card, seed=0)
    state = create_train_state(model, fused_adamw(3e-4, weight_decay=1e-4))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 512, (4, 65))).to(card)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    step = make_train_step(bf16_compute())
    counters = (layer_norm_fwd, layer_norm_bwd, fused_adamw_multi_update_, cross_entropy_fwd,
                cross_entropy_bwd, normalize_images, fused_adamw_update_)
    for c in counters:
        c.launches = 0
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    n_leaves = len(list(model.parameters()))
    assert n_leaves == 2 + 12 * 3 + 3
    assert [c.launches for c in counters] == [7, 7, 1, 0, 0, 0, 0]
    assert np.isfinite(float(metrics["loss_sum"])) and float(metrics["count"]) == 4 * 64
    assert {int(s["count"]) for s in state.optimizer.state.values()} == {1}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_scheduled_lr_reads_the_applied_count_on_the_card(card, optimizer):
    """A warm-up-cosine schedule read at the device count of applied
    updates (fused SGD and capturable Adam take the lr as a device
    scalar), with a NaN batch skipped at step 2: four health-guarded steps
    on the card against the same steps on the CPU.  A linear model, f32,
    TF32 off: only the order of the sums differs (1e-5 absolute)."""
    from tpuframe_torch.fault.health import HealthPolicy
    from tpuframe_torch.train import make_optimizer
    from tpuframe_torch.train.schedules import warmup_cosine

    rng = np.random.default_rng(0)
    batches = [{"image": torch.from_numpy(rng.normal(0, 1, (8, 4, 4, 3)).astype(np.float32)),
                "label": torch.from_numpy(rng.integers(0, 10, 8))} for _ in range(4)]
    batches[2]["image"][0, 0, 0, 0] = float("nan")
    models = {}
    for dev in (card, torch.device("cpu")):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(48, 10)).to(dev)
        state = create_train_state(model, make_optimizer(optimizer, warmup_cosine(0.05, 2, 6)))
        step = make_train_step(full_precision(), health=HealthPolicy())
        for b in batches:
            state, _ = step(state, {k: v.to(dev) for k, v in b.items()})
        assert state.step == 4 and int(state.updates) == 3
        models[dev.type] = model
    for a, b in zip(models["cuda"].parameters(), models["cpu"].parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-5, rtol=0)


# -- K5a / K5b / K5c: the compressed wire ----------------------------------------

# (name, rows, cols, offset): the ResNet50-1K gradient's 25 buckets, the JAX
# test's shapes (130 columns: no 16-byte rows, the element path), and a
# buffer one element off the 16-byte alignment
QW_CASES = [
    ("25x1022336", 25, 1_022_336, 0),
    ("1x64", 1, 64, 0),
    ("3x130", 3, 130, 0),
    ("8x2048", 8, 2048, 0),
    ("8x2048_unaligned", 8, 2048, 1),
]

#: .5 ties on a grid of scale 1, clip edges, zeros of both signs, float32
#: subnormals, e4m3 grid points, midpoints and subnormals, past the e4m3 edge
QW_EDGES = np.array([
    [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127, -127, 0, -0.0, 3.5, 4.5, 100.5, -100.5],
    [1e-40, -3e-41, 2e-39, 0, 5e-45, -1e-38, 1e-39, 7e-42] + [0] * 8,
    [0.0] * 16,
    [-0.0] * 16,
    [448, -448, 2 ** -9, 2 ** -10, 3 * 2 ** -10, 1, -1, 0.3, 17, 200, 300, 440, 447, 5.5, 6.5,
     232],
], np.float32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, NaNs compared by position (their payloads may differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = torch.where(nan, 0, a), torch.where(nan, 0, b)
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _qw_inputs(rows, cols, offset, card, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)

    def place(t):
        flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=card)
        out = flat[offset:].view(t.shape)
        out.copy_(t)
        return out

    v = torch.randn(rows, cols, generator=gen, device=card) * 9
    noise = torch.rand(rows, cols, generator=gen, device=card)
    return place(v), place(noise)


@pytest.mark.parametrize("case", QW_CASES, ids=[c[0] for c in QW_CASES])
def test_quant_wire_kernels_match_plain_versions(card, case):
    from tpuframe_torch.ops import (
        bucket_abs_max,
        bucket_abs_max_reference,
        quant_decode,
        quant_decode_reference,
        quant_encode,
        quant_encode_reference,
    )

    _, rows, cols, offset = case
    v, noise = _qw_inputs(rows, cols, offset, card)
    counts = (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches)
    amax = bucket_abs_max(v)
    assert _same_bits(amax, bucket_abs_max_reference(v))
    for mode, nz in (("int8", None), ("int8", noise), ("fp8", None)):
        q, d = quant_encode(v, amax, mode, noise=nz)
        wq, wd = quant_encode_reference(v, amax, mode, nz)
        assert _same_bits(q, wq) and _same_bits(d, wd), mode
        total = q * 3  # three ranks' worth of the same payload
        bad = amax.clone()
        bad[0, 0] = float("nan")  # a poisoned bucket decodes to NaN
        for a in (amax, bad):
            got, want = quant_decode(total, a, mode, 3), quant_decode_reference(total, a, mode, 3)
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert bool(torch.isnan(got[0]).all()) == (a is bad)
            torch.testing.assert_close(torch.nan_to_num(got), torch.nan_to_num(want),
                                       rtol=1e-6, atol=1e-6)
    torch.cuda.synchronize()
    assert (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches) == (
        counts[0] + 1, counts[1] + 3, counts[2] + 6)


def test_quant_wire_kernels_take_the_edges_bit_for_bit(card):
    from tpuframe_torch.ops import (
        bucket_abs_max,
        bucket_abs_max_reference,
        quant_encode,
        quant_encode_reference,
    )

    v = torch.from_numpy(QW_EDGES).to(card)
    noise = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, QW_EDGES.shape).astype(
        np.float32)).to(card)
    assert _same_bits(bucket_abs_max(v), bucket_abs_max_reference(v))
    for amax in (bucket_abs_max(v), torch.tensor([[127.0], [1e-38], [0.0], [0.0], [400.0]],
                                                 device=card)):
        for mode, nz in (("int8", None), ("int8", noise), ("fp8", None)):
            q, _ = quant_encode(v, amax, mode, noise=nz)
            assert _same_bits(q, quant_encode_reference(v, amax, mode, nz)[0]), (mode, amax)
    nan_row = v.clone()
    nan_row[1, 3] = float("nan")
    amax = bucket_abs_max(nan_row)
    assert torch.isnan(amax[1, 0]) and _same_bits(amax, bucket_abs_max_reference(nan_row))
    q, _ = quant_encode(nan_row, amax, "int8")
    assert _same_bits(q, quant_encode_reference(nan_row, amax, "int8")[0])
    assert not q[1].any()  # a NaN scale encodes to 0, as XLA's convert makes it


def test_quant_wire_kernels_refuse_what_they_do_not_take(card):
    from tpuframe_torch.ops import bucket_abs_max, quant_decode, quant_encode

    v = torch.ones(4, 64, device=card)
    amax = torch.ones(4, 1, device=card)
    with pytest.raises(TypeError, match="dtype"):
        bucket_abs_max(v.double())
    with pytest.raises(ValueError, match="contiguous"):
        bucket_abs_max(v.t().contiguous().t()[:, ::2])
    with pytest.raises(ValueError, match="amax must be"):
        quant_encode(v, amax[:2], "int8")
    with pytest.raises(ValueError, match="noise"):
        quant_encode(v, amax, "int8", noise=torch.ones(4, 32, device=card))
    with pytest.raises(TypeError, match="dtype"):
        quant_decode(v, amax, "int8", 2)  # int8 totals are int32


def test_sync_gradients_on_card_matches_the_cpu(card):
    """The world-1 wire with the kernels against the same wire on the CPU
    (plain versions): means and residuals bit-equal, in every mode."""
    from tpuframe_torch.core import MeshSpec
    from tpuframe_torch.parallel import (
        CommsConfig,
        ParallelPlan,
        grad_layout,
        init_comms_state,
        sync_gradients,
    )

    rng = np.random.default_rng(5)
    tree = {"a/w": rng.standard_normal((64, 3, 3, 3)) * 0.2, "b/b": rng.standard_normal(64),
            "c/k": rng.standard_normal((1000, 37)) * 3e-3}
    tree = {k: torch.from_numpy(a.astype(np.float32)) for k, a in tree.items()}
    plan = ParallelPlan(mesh=MeshSpec().build(1))
    for kw in (dict(mode="int8"), dict(mode="int8", bucket_mb=0.01, groups=3),
               dict(mode="fp8", bucket_mb=0.01)):
        config = CommsConfig(**kw)
        layout = grad_layout(tree, config, plan)
        resid = init_comms_state(tree, plan, config)["flat"]
        resid.copy_(torch.from_numpy(rng.normal(0, 1e-3, resid.shape).astype(np.float32)))
        out = {}
        for dev in (card, torch.device("cpu")):
            grads = {k: t.to(dev) for k, t in tree.items()}
            out[dev.type] = sync_gradients(grads, {"flat": resid.to(dev)}, layout, config)
        for k in tree:
            assert _same_bits(out["cuda"][0][k].cpu(), out["cpu"][0][k]), (kw, k)
        assert _same_bits(out["cuda"][1]["flat"].cpu(), out["cpu"][1]["flat"]), kw


def test_compressed_trainer_fit_on_card_launches_the_wire(card):
    """A few steps of a small ResNet18 through ``Trainer(grad_compression=
    "int8")`` on one card without a process group: K5a, K5b and K5c once a
    step."""
    from tpuframe_torch.core import MeshSpec
    from tpuframe_torch.ops import bucket_abs_max, quant_decode, quant_encode
    from tpuframe_torch.parallel import ParallelPlan

    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device=card, seed=1)
    train = DataLoader(SyntheticImageDataset(n=64, image_size=32), 16, shuffle=True,
                       transfer_dtype="uint8")
    trainer = Trainer(model, train_dataloader=train, optimizer="sgd", lr=0.05,
                      max_duration="4ba", normalize=(MEAN, STD), log_interval=2,
                      plan=ParallelPlan(mesh=MeshSpec().build(1)), grad_compression="int8")
    bucket_abs_max.launches = quant_encode.launches = quant_decode.launches = 0
    result = trainer.fit()
    torch.cuda.synchronize()
    assert (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches) == (4, 4, 4)
    assert np.isfinite(result.history[-1]["train_loss"])
    assert trainer._train_step.wire["bytes_per_step"] == 0  # world 1: no wire
    assert float(trainer.state.comms["flat"].abs().max()) > 0


def test_compressed_step_never_waits_for_the_device(card):
    """No call of the compressed step synchronizes with the card (a constant
    copied from pageable host memory would: it stalls the host mid-step)."""
    from tpuframe_torch.core import MeshSpec
    from tpuframe_torch.fault.health import HealthPolicy
    from tpuframe_torch.parallel import CommsConfig, ParallelPlan, init_comms_state
    from tpuframe_torch.train import make_optimizer

    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device=card, seed=2)
    plan = ParallelPlan(mesh=MeshSpec().build(1))
    config = CommsConfig(mode="int8", bucket_mb=0.5)  # several buckets
    state = create_train_state(model, make_optimizer("sgd", 0.05))
    state.comms = init_comms_state(dict(model.named_parameters()), plan, config)
    step = make_train_step(full_precision(), health=HealthPolicy(), plan=plan,
                           grad_compression=config)
    gen = torch.Generator(device=card).manual_seed(0)
    batch = {"image": torch.randn(8, 32, 32, 3, generator=gen, device=card),
             "label": torch.randint(0, 10, (8,), generator=gen, device=card)}
    step(state, batch)  # builds the layout
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step.wire["n_buckets"] > 1


@pytest.mark.parametrize("kind", ["resnet18_sgd", "lm_fused_adamw"])
def test_checkpoint_round_trip_of_a_card_state(card, kind, tmp_path):
    """A state on the card saved and restored in place into another: every
    tensor stays on the card with its dtype, bit for bit."""
    from tpuframe_torch.ckpt import Checkpointer

    if kind == "resnet18_sgd":
        def make(seed):
            model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device=card, seed=seed)
            return create_train_state(model, make_optimizer("sgd", 0.1), seed=seed)
        rng = np.random.default_rng(0)
        batch = {"image": torch.from_numpy(rng.standard_normal((8, 16, 16, 3)).astype(
                     np.float32)).to(card),
                 "label": torch.from_numpy(rng.integers(0, 10, (8,))).to(card)}
    else:
        def make(seed):
            model = TransformerLM(vocab_size=128, num_layers=2, num_heads=4, head_dim=16,
                                  max_len=16, device=card, seed=seed)
            return create_train_state(model, fused_adamw(3e-3), seed=seed)
        t = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (4, 17))).to(card)
        batch = {"image": t[:, :-1], "label": t[:, 1:]}

    def tensors(state, tree=None):
        tree = state.state_dict() if tree is None else tree
        out = []
        for v in tree.values():
            if isinstance(v, dict):
                out += tensors(state, v)
            elif torch.is_tensor(v):
                out.append(v)
        return out

    state = make(0)
    step = make_train_step()
    for _ in range(2):
        state, _ = step(state, batch)
    want = [t.clone() for t in tensors(state)]
    with Checkpointer(tmp_path / "ck") as ck:
        ck.save(state)
        fresh = make(5)
        restored, _ = ck.restore(fresh)
    torch.cuda.synchronize()
    got = tensors(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == w.device and g.dtype == w.dtype and torch.equal(g, w)
    assert any(g.is_cuda for g in got) and restored.step == 2


def _cross_rank_bn_inputs():
    """(x NCHW, r, scale, bias) for a global batch of 16."""
    rng = np.random.default_rng(12)
    x = rng.normal(0.5, 2.0, (16, 32, 8, 8)).astype(np.float32)
    r = rng.normal(0, 1, x.shape).astype(np.float32)
    return x, r, rng.uniform(0.5, 1.5, 32).astype(np.float32), rng.normal(0, 0.3, 32).astype(
        np.float32)


def _cross_rank_bn(bn, x, r, rows, world):
    """Forward and backward of ``bn`` over ``rows`` of the batch (each
    rank's loss its local mean); the scale and bias gradients averaged over
    the ranks: (y, dx, dscale, dbias, running mean, running var) on the
    CPU."""
    import torch.distributed as dist

    from tpuframe_torch.models.norm import cross_rank_statistics

    dev = bn.weight.device
    xt = torch.from_numpy(x[rows]).to(dev).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    scope = cross_rank_statistics(bn) if world > 1 else contextlib.nullcontext()
    with scope:
        y = bn.train()(xt)
    (y * torch.from_numpy(r[rows]).to(dev)).sum().div(len(range(*rows.indices(16)))).backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    if world > 1:
        dist.all_reduce(grads)
        grads /= world
    return [t.detach().cpu().numpy() for t in (y, xt.grad, grads[0], grads[1], bn.running_mean,
                                               bn.running_var)]


def _new_bn(x_scale, x_bias, device):
    from tpuframe_torch.models import ReplicaGroupedBatchNorm

    bn = ReplicaGroupedBatchNorm(32, device=device)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(x_scale))
        bn.bias.copy_(torch.from_numpy(x_bias))
    return bn


def _cross_rank_bn_rank(rank, world):
    from tpuframe_torch.core import initialize

    rt = initialize(device="cuda:0", backend="gloo")
    x, r, scale, bias = _cross_rank_bn_inputs()
    n = 16 // world
    return _cross_rank_bn(_new_bn(scale, bias, rt.device), x, r,
                          slice(rank * n, (rank + 1) * n), world)


def test_cross_rank_batchnorm_on_two_gloo_ranks_of_the_card(card, tmp_path):
    """Sync BatchNorm over two gloo ranks on the one card (NCCL refuses two
    ranks on one device) against one process's BatchNorm on the global
    batch on the card: y, dx (a rank's loss is its local mean, so its dx is
    twice the global loss's), the averaged scale and bias gradients and the
    running statistics within 1e-5 (float32; flax's ``E[x^2] - E[x]^2``
    against the two-pass variance, sums in another order)."""
    from torch_ranks import run_ranks

    ranks = run_ranks(_cross_rank_bn_rank, 2, tmp_path, timeout=300)
    x, r, scale, bias = _cross_rank_bn_inputs()
    want = _cross_rank_bn(_new_bn(scale, bias, card), x, r, slice(0, 16), 1)
    got = [np.concatenate([ranks[0][0], ranks[1][0]]),
           np.concatenate([ranks[0][1], ranks[1][1]]) / 2, *ranks[0][2:]]
    names = ("y", "dx", "dscale", "dbias", "mean", "var")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
    for name, a, b in zip(names[2:], ranks[0][2:], ranks[1][2:]):
        np.testing.assert_array_equal(a, b, err_msg=name)  # one value on both ranks


# -- K6: blockwise attention --------------------------------------------------

#: (id, B, L, H, D, dtype, causal[, q's scale]): every head dim, ragged L,
#: both dtypes; in bf16 every head dim of the tensor-core backward, path B's
#: length (128 tiles in the loop) and large logits (q scaled by 8)
K6_CASES = [
    ("2x13x3x16_f32_causal", 2, 13, 3, 16, torch.float32, True),
    ("2x100x3x32_f32", 2, 100, 3, 32, torch.float32, False),
    ("2x1000x3x64_f32_causal", 2, 1000, 3, 64, torch.float32, True),
    ("1x300x2x128_f32", 1, 300, 2, 128, torch.float32, False),
    ("2x1000x3x64_bf16_causal", 2, 1000, 3, 64, torch.bfloat16, True),
    ("4x196x12x64_bf16", 4, 196, 12, 64, torch.bfloat16, False),
    ("1x257x2x128_bf16_causal", 1, 257, 2, 128, torch.bfloat16, True),
    ("2x13x3x16_bf16_causal", 2, 13, 3, 16, torch.bfloat16, True),
    ("2x100x3x32_bf16", 2, 100, 3, 32, torch.bfloat16, False),
    ("1x8192x2x64_bf16_causal", 1, 8192, 2, 64, torch.bfloat16, True),
    ("2x1000x3x64_bf16_causal_q8", 2, 1000, 3, 64, torch.bfloat16, True, 8.0),
]


def _k6_inputs(b, l, h, d, dtype, card, seed=0, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(4))
    return [torch.from_numpy(a).to(card).to(dtype) for a in (q * np.float32(q_scale), k, v, g)]


def _k6_run(q, k, v, g, causal):
    out, lse = blockwise_attention_fwd(q, k, v, causal=causal)
    dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=causal)
    dk, dv = blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=causal)
    return out, lse, dq, dk, dv


def _k6_plain(q, k, v, g, causal):
    out, lse = blockwise_attention_reference(q, k, v, causal=causal)
    return (out, lse, *blockwise_attention_bwd_reference(q, k, v, out, lse, g, causal=causal))


def _k6_lse_exact(q, k, causal):
    """The logsumexp of the scaled scores (B, H, L) in float64 over the same
    values: what every float32 lse approximates.  The float32 plain run is
    no yardstick for it at large logits: at q scaled by 8 its own sums
    round it about 1e-5 away (``chip_smoke.py`` phase 3 logs the distance),
    and a kernel that sums in another order lands elsewhere within that."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / np.sqrt(q.shape[-1])
    if causal:
        l = q.shape[1]
        s = s.masked_fill(~torch.ones(l, l, dtype=torch.bool, device=q.device).tril(), -np.inf)
    return torch.logsumexp(s, -1)


@pytest.mark.parametrize("case", K6_CASES, ids=[c[0] for c in K6_CASES])
def test_blockwise_attention_kernels_match_plain_versions(card, case):
    """K6a-K6c against the plain schedule run in float32 on the same
    inputs: in float32 within 1e-5 (out) and 1e-4 (gradients), the sums in
    another order over other tiles; in bf16 no further than twice the plain
    bf16 run's own distance.  lse (float32) within 1e-5 of the float64
    logsumexp (``_k6_lse_exact``).  A rerun gives the same bits (no
    atomics)."""
    _, b, l, h, d, dtype, causal, *q_scale = case
    q, k, v, g = _k6_inputs(b, l, h, d, dtype, card, q_scale=q_scale[0] if q_scale else 1.0)
    before = (blockwise_attention_fwd.launches, blockwise_attention_bwd_dq.launches,
              blockwise_attention_bwd_dkv.launches)
    got = _k6_run(q, k, v, g, causal)
    torch.cuda.synchronize()
    assert (blockwise_attention_fwd.launches, blockwise_attention_bwd_dq.launches,
            blockwise_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    assert [t.dtype for t in got] == [dtype, torch.float32, dtype, dtype, dtype]
    want = _k6_plain(*(t.float() for t in (q, k, v, g)), causal)
    err = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
    err[1] = float((got[1].double() - _k6_lse_exact(q, k, causal)).abs().max())
    assert err[1] <= 1e-5, err
    if dtype == torch.float32:
        assert err[0] <= 1e-5 and max(err[2:]) <= 1e-4, err
    else:
        plain = [float((a.float() - w).abs().max()) for a, w in zip(_k6_plain(q, k, v, g, causal),
                                                                    want)]
        for i in (0, 2, 3, 4):
            assert err[i] <= 2 * plain[i], (i, err, plain)
    again = _k6_run(q, k, v, g, causal)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


#: K6a alone: (id, B, L, H, D, causal[, q's scale]); every head dim of the
#: bf16 tensor-core forward at ragged L = 13 and 1000, causal and not, path
#: B's length, and large logits
K6A_CASES = [(f"1x{l}x2x{d}{'_causal' if c else ''}", 1, l, 2, d, c)
             for d in (16, 32, 64, 128) for l in (13, 1000) for c in (True, False)]
K6A_CASES += [("1x8192x2x64_causal", 1, 8192, 2, 64, True),
              ("1x8192x2x128_causal", 1, 8192, 2, 128, True),
              ("2x1000x2x128_causal_q8", 2, 1000, 2, 128, True, 8.0),
              ("2x1000x2x16_q8", 2, 1000, 2, 16, False, 8.0)]


def _k6a_rule(got, q, k, v, causal):
    """K6a's (out, lse) in bf16: out against the plain schedule run in
    float32 on the same inputs, no further than twice the plain bf16 run's
    own distance; lse within 1e-5 of the float64 logsumexp, or no further
    from it than twice the float32 plain run (at q scaled by 8 and D = 128
    both land about 1e-5 away: lse ~ 40, a few float32 steps)."""
    want = blockwise_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    plain = blockwise_attention_reference(q, k, v, causal=causal)
    exact = _k6_lse_exact(q, k, causal)
    err = [float((got[0].float() - want[0]).abs().max()),
           float((got[1].double() - exact).abs().max())]
    ref = [float((plain[0].float() - want[0]).abs().max()),
           float((want[1].double() - exact).abs().max())]
    assert err[1] <= max(1e-5, 2 * ref[1]) and err[0] <= 2 * ref[0], (err, ref)


@pytest.mark.parametrize("case", K6A_CASES, ids=[c[0] for c in K6A_CASES])
def test_blockwise_attention_forward_on_the_tensor_cores(card, case):
    """The bf16 forward (``tc::attn_fwd_tc``) at every head dim, held to the
    bf16 rule; one launch a call, and a rerun gives the same bits."""
    _, b, l, h, d, causal, *q_scale = case
    q, k, v, _ = _k6_inputs(b, l, h, d, torch.bfloat16, card,
                            q_scale=q_scale[0] if q_scale else 1.0)
    before = blockwise_attention_fwd.launches
    got = blockwise_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert blockwise_attention_fwd.launches == before + 1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert got[1].shape == (b, h, l)
    _k6a_rule(got, q, k, v, causal)
    again = blockwise_attention_fwd(q, k, v, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_blockwise_attention_forward_fully_masked_rows(card, dtype, d, causal):
    """Scores of -inf play the mask: with q's first column positive, a key
    whose first entry is -inf scores -inf against every query.  Head 0 has
    every key so (every row fully masked: lse = -inf, out = 0, no NaN, as
    JAX's guards give); head 1 every odd key (a mask across the tiles, held
    to the plain schedule).  L = 100 is ragged."""
    q, k, v, _ = _k6_inputs(1, 100, 2, d, dtype, card)
    q[..., 0] = q[..., 0].abs() + 0.5
    k[:, :, 0, 0] = -torch.inf
    k[:, 1::2, 1, 0] = -torch.inf
    out, lse = blockwise_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert not out.isnan().any() and not lse.isnan().any()
    assert bool((lse[:, 0] == -torch.inf).all()) and bool((out[:, :, 0] == 0).all())
    assert bool(torch.isfinite(lse[:, 1]).all())
    one = [t[:, :, 1:].contiguous() for t in (q, k, v)]
    got = (out[:, :, 1:], lse[:, 1:])
    if dtype == torch.bfloat16:
        _k6a_rule(got, *one, causal)
    else:
        want = blockwise_attention_reference(*one, causal=causal)
        assert max(float((a - w).abs().max()) for a, w in zip(got, want)) <= 1e-5


def test_blockwise_attention_kernels_refuse_what_they_do_not_take(card):
    q, k, v, g = _k6_inputs(1, 64, 2, 48, torch.float32, card)
    before = blockwise_attention_fwd.launches
    with pytest.raises(ValueError, match="head dims"):
        blockwise_attention_fwd(q, k, v)
    q, k, v, g = _k6_inputs(1, 64, 2, 64, torch.float16, card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        blockwise_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="must match"):
        blockwise_attention_fwd(q, k[:, :32], v)
    assert blockwise_attention_fwd.launches == before


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_blockwise_lm_step_launch_counts_and_remat_bits(card, remat):
    """One bf16 train step of a 2-layer LM at 4,096 tokens (``auto`` takes
    the blockwise path): K6a once a layer in the forward and once more in
    the recompute under ``remat``, K6b and K6c once a layer; with dropout
    0.1 the ``remat`` step gives the same loss and parameters, bit for bit,
    as the step without it."""
    cfg = dict(vocab_size=256, num_layers=2, num_heads=2, head_dim=32, max_len=4096)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 4097))).to(card)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    out = {}
    for r in (False, remat):
        model = TransformerLM(**cfg, dropout=0.1, remat=r, device=card, seed=0)
        state = create_train_state(model, fused_adamw(3e-4))
        counters = (blockwise_attention_fwd, blockwise_attention_bwd_dq,
                    blockwise_attention_bwd_dkv)
        for c in counters:
            c.launches = 0
        state, metrics = make_train_step(bf16_compute())(state, batch)
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [4 if r else 2, 2, 2]
        out[r] = (float(metrics["loss_sum"]), [p.detach().clone() for p in model.parameters()])
    assert out[remat][0] == out[False][0] and np.isfinite(out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out[False][1]))
