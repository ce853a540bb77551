"""The port on the card: the CUDA kernels (K1 normalize, K2a/K2b cross
entropy, K3a/K3b LayerNorm, K4 fused AdamW over one tensor and over
lists, K5a/K5b/K5c the compressed
wire's amax, encode and decode, K6a/K6b/K6c blockwise attention forward
and backward) against their plain versions, the launch counts of a
blockwise LM step with and without ``remat``, the launch
floor's counter, a parameter without a gradient stepped by K4, the
compressed wire's sync on the card against the CPU, its fused forms at
world 1 and a compressed step's bucket groups fired from its backward, a
small serve slice, a small ``Trainer.fit``, eval mode for a model left in
train mode, the launch counts of one LM train step, BatchNorm with
statistics across two gloo ranks on the card against one process's, and
the plain-PyTorch optimizers of the launcher slice (lion, lamb,
adafactor) and SGD with the moving average on the card against the CPU,
the streaming slice: a batch streamed from shards and normalized by
K1 on the card, and ``device_memory_stats`` against the allocator, and
ZeRO: K4 over owned slices, two gloo ranks under stages 0, 2 and 3, and
the compressed wire's sliced leaves through K5a-K5c against the plain
versions; two agents of the remote launcher on localhost sharing the card
over gloo.

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


def test_fused_forms_and_fired_groups_on_the_card(card):
    """World 1 on the card (no process group): each form of the fused
    transport returns its payload bit for bit, as JAX's does at W = 1; a
    compressed step in 3 bucket groups issues them from inside the
    backward, in the layout's fire order, with K5a-K5c once a group."""
    from unittest import mock

    from tpuframe_torch.core import MeshSpec
    from tpuframe_torch.ops import bucket_abs_max, quant_decode, quant_encode
    from tpuframe_torch.parallel import CommsConfig, ParallelPlan, grad_layout, init_comms_state
    from tpuframe_torch.parallel import compression as C
    from tpuframe_torch.train import make_optimizer
    from tpuframe_torch.train.step import trainable_parameters

    gen = torch.Generator(device=card).manual_seed(3)
    q = torch.randint(-127, 128, (8, 125), generator=gen, device=card, dtype=torch.int32)
    f = (torch.randn(8, 125, generator=gen, device=card) * 40).to(torch.float8_e4m3fn).float()
    f[:, 0] = -0.0
    for payload in (q, f):
        for form in ("ring", "concurrent", "single"):
            got = C._fused_allreduce(payload, 1, form=form)
            assert got.device == payload.device and _same_bits(got.cpu(), payload.cpu()), form

    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device=card, seed=4)
    plan = ParallelPlan(mesh=MeshSpec().build(1))
    config = CommsConfig(mode="int8", bucket_mb=0.2, groups=3, fused=True)
    state = create_train_state(model, make_optimizer("sgd", 0.05))
    state.comms = init_comms_state(trainable_parameters(model), plan, config)
    layout = grad_layout(trainable_parameters(model), config, plan)
    assert layout.n_groups == 3
    step = make_train_step(full_precision(), plan=plan, grad_compression=config)
    issued = []
    real_issue = C._WireRound._issue

    def issue(self, s, e):
        issued.append((s, torch._C._current_graph_task_id() != -1))
        return real_issue(self, s, e)

    batch = {"image": torch.randn(8, 32, 32, 3, generator=gen, device=card),
             "label": torch.randint(0, 10, (8,), generator=gen, device=card)}
    bucket_abs_max.launches = quant_encode.launches = quant_decode.launches = 0
    with mock.patch.object(C._WireRound, "_issue", issue):
        for _ in range(2):
            step(state, batch)
    torch.cuda.synchronize()
    assert issued == [(s, True) for s, _ in layout.group_bounds] * 2
    assert (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches) == (6, 6, 6)
    assert all(torch.isfinite(p).all() for p in model.parameters())


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


# the launcher slice's optimizers: plain PyTorch, so the card must give the
# CPU's update; one leaf of each kind adafactor tells apart
OPT_SHAPES = ((37,), (100, 50), (256, 512), (3, 130, 140), (3, 3, 64, 128))


def _opt_run(build, device, ema: bool = False):
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in OPT_SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in OPT_SHAPES] for _ in range(5)]
    model = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(a.copy()).to(device)) for a in p0])
    spec = build()
    if ema:
        from tpuframe_torch.train import with_ema

        spec = with_ema(spec, 0.9)
    state = create_train_state(model, spec)
    for g in grads:
        for p, a in zip(model, g):
            p.grad = torch.from_numpy(a.copy()).to(device)
        state.apply_gradients()
    params = [p.detach().cpu() for p in model]
    avg = [v.cpu() for v in state.ema.ema.values()] if ema else []
    return params, avg


@pytest.mark.parametrize("name", ["lion", "lamb", "adafactor", "sgd_ema"])
def test_launcher_slice_optimizers_on_the_card_match_the_cpu(card, name):
    """Five updates from the same gradients: every parameter (and, for
    SGD with EMA, the average) within 1e-6 of the CPU's, relative to the
    leaf's largest value."""
    opt, ema = ("sgd", True) if name == "sgd_ema" else (name, False)
    lr = 1e-2 if opt in ("sgd", "adafactor") else 1e-3
    build = functools.partial(make_optimizer, opt, lr)
    got, got_avg = _opt_run(build, card, ema)
    want, want_avg = _opt_run(build, torch.device("cpu"), ema)
    assert len(got_avg) == (len(OPT_SHAPES) if ema else 0)
    for a, b in zip(got + got_avg, want + want_avg):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)


def _stream_volume(root, n: int = 24, px: int = 32) -> str:
    """A small TFS volume of seeded images: JPEG where PIL encodes, else
    uint8 arrays."""
    from tpuframe_torch.data import ShardWriter

    try:
        import PIL  # noqa: F401

        codec = "jpg"
    except ImportError:
        codec = "ndarray"
    rng = np.random.default_rng(13)
    with ShardWriter(str(root), {"image": codec, "label": "int"}, shard_size_limit=1 << 12,
                     compression="none") as w:
        for i in range(n):
            w.write({"image": rng.integers(0, 256, (px, px, 3), dtype=np.uint8), "label": i})
    return str(root)


def test_a_streamed_uint8_batch_normalized_by_k1_equals_k1_on_the_same_array(card, tmp_path):
    """The streaming path's bytes reach K1 unchanged: a batch streamed
    from shards, shipped as uint8 by the DevicePrefetcher and normalized
    on the card equals K1 on the same host array, bit for bit."""
    from tpuframe_torch.data import DevicePrefetcher, StreamingDataset, uint8_image_transforms

    remote = _stream_volume(tmp_path / "remote")

    def loader():
        ds = StreamingDataset(remote, local_cache=str(tmp_path / "cache"),
                              transform=uint8_image_transforms(32), rng_seed=1)
        return DataLoader(ds, 8, shuffle=True, seed=2, transfer_dtype="uint8")

    host_images = next(iter(loader()))[0].copy()
    device_images, _ = next(iter(DevicePrefetcher(loader(), device=card)))
    assert device_images.dtype == torch.uint8 and device_images.device.type == "cuda"
    before = normalize_images.launches
    got = normalize_images(device_images, MEAN, STD, out_dtype=torch.bfloat16)
    want = normalize_images(torch.from_numpy(host_images).to(card), MEAN, STD,
                            out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert normalize_images.launches == before + 2
    assert torch.equal(got, want)


def test_device_memory_stats_reports_the_allocated_bytes(card):
    from tpuframe_torch.track.system_metrics import SystemMetricsMonitor, device_memory_stats

    keep = torch.empty(64 * 2**20, dtype=torch.uint8, device=card)
    i = keep.device.index or 0
    stats = device_memory_stats()
    allocated = torch.cuda.memory_allocated(i) / 2**20
    assert allocated >= 64
    assert abs(stats[f"device{i}_mem_used_mb"] - allocated) <= 0.01 * allocated
    total = torch.cuda.get_device_properties(i).total_memory / 2**20
    assert stats[f"device{i}_mem_util"] == pytest.approx(stats[f"device{i}_mem_used_mb"] / total)
    sample = SystemMetricsMonitor(interval_s=60.0).sample()
    assert sample[f"system/device{i}_mem_used_mb"] >= 64
    del keep


# -- ZeRO: K4 over owned slices, the sliced wire ---------------------------------


def test_fused_adamw_over_owned_slices_on_the_card(card):
    """K4 over the owned slices of ZeRO's exact path (runs of each
    parameter's storage, views: a channels_last conv weight's halves, a
    linear weight's) beside a whole bias: each within 1e-6 of the plain
    version, and the two halves' update bit-equal to K4 over the whole
    tensors (every element takes the same expression whatever the list)."""
    gen = torch.Generator(device=card).manual_seed(11)
    conv = torch.randn(64, 64, 3, 3, generator=gen, device=card).to(
        memory_format=torch.channels_last)
    lin = torch.randn(256, 768, generator=gen, device=card)
    bias = torch.randn(768, generator=gen, device=card)
    count = torch.full((), 4, dtype=torch.int32, device=card)
    hp = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)

    def memory_run(t):  # the storage in memory order, as ZeRO walks it
        order = sorted(range(t.ndim), key=lambda d: -t.stride()[d])
        return t.permute(order).reshape(-1)

    full = [conv.clone(), lin.clone(), bias.clone()]
    grads = [torch.randn(t.shape, generator=gen, device=card) * 1e-2 for t in full]
    grads = [torch.empty_like(t).copy_(g) for t, g in zip(full, grads)]
    moments = [(torch.rand_like(t) * 1e-3, torch.rand_like(t) * 1e-5) for t in full]
    whole = [t.clone() for t in full]
    whole_m = [(m.clone(), v.clone()) for m, v in moments]
    fused_adamw_multi_update_(whole, grads, [m for m, _ in whole_m], [v for _, v in whole_m],
                              [count] * 3, **hp)
    sliced = [t.clone() for t in full]
    sm = [(m.clone(), v.clone()) for m, v in moments]
    ps, gs, ms, vs = [], [], [], []
    for i in range(2):  # the two ranks' halves of the sliced leaves
        for k in (0, 1):
            n = full[k].numel() // 2
            run = slice(i * n, (i + 1) * n)
            ps.append(memory_run(sliced[k])[run])
            gs.append(memory_run(grads[k])[run])
            ms.append(memory_run(sm[k][0])[run])
            vs.append(memory_run(sm[k][1])[run])
    assert all(p.is_contiguous() and p._base is not None for p in ps)  # views, no copies
    ps.append(sliced[2])
    gs.append(grads[2])
    ms.append(sm[2][0])
    vs.append(sm[2][1])
    launches = fused_adamw_multi_update_.launches
    fused_adamw_multi_update_(ps, gs, ms, vs, [count] * len(ps), **hp)
    torch.cuda.synchronize()
    assert fused_adamw_multi_update_.launches == launches + 1
    for k in range(3):
        assert torch.equal(sliced[k], whole[k]) and torch.equal(sm[k][0], whole_m[k][0])
        want = fused_adamw_update_reference(full[k], grads[k], *moments[k], count, **hp)
        assert float((sliced[k] - want[0]).abs().max()) <= 1e-6


def _zero_card_rank(rank: int, world: int) -> dict:
    """Two gloo ranks on the one card: an MLP under ZeRO stages 0, 2 and 3
    (K4 on the card), and the compressed wire's sliced sync on CUDA
    tensors (K5a-K5c) and on CPU tensors (the plain versions)."""
    import warnings

    from tpuframe_torch.core import initialize
    from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode
    from tpuframe_torch.parallel import CommsConfig, ZeroConfig
    from tpuframe_torch.parallel import compression as C

    warnings.simplefilter("ignore")
    rt = initialize({"data": 1, "fsdp": world}, device="cuda:0", backend="gloo")
    out = {}
    for stage in (0, 2, 3):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.ReLU(),
                                    torch.nn.Linear(256, 16)).to(rt.device)
        plan = ZeroConfig(stage=stage, min_shard_elems=1024).plan(rt.mesh)
        state = create_train_state(model, fused_adamw(1e-2, weight_decay=1e-4), plan=plan)
        step = make_train_step(plan=plan)
        g = torch.Generator().manual_seed(1)
        launches = fused_adamw_multi_update_.launches
        for _ in range(3):
            x, y = torch.randn(16, 64, generator=g), torch.randint(0, 16, (16,), generator=g)
            state, _ = step(state, {"input": x[rank * 8:(rank + 1) * 8].to(rt.device),
                                    "label": y[rank * 8:(rank + 1) * 8].to(rt.device)})
        out[stage] = {"params": {k: v.cpu().numpy() for k, v in
                                 state.state_dict()["model"].items()},
                      "k4": fused_adamw_multi_update_.launches - launches,
                      "sliced": len(state.zero.opt) if state.zero is not None else 0}
    plan = ZeroConfig(stage=2, min_shard_elems=1024).plan(rt.mesh)
    rng = np.random.default_rng(rank)
    tree = {"w": rng.standard_normal((64, 256)).astype(np.float32),
            "b": rng.standard_normal(256).astype(np.float32)}
    for mode in ("int8", "fp8"):
        config = CommsConfig(mode=mode, bucket_mb=0.001)
        synced = {}
        for dev in ("cpu", "cuda"):
            grads = {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}
            layout = C.grad_layout(grads, config, plan)
            comms = {k: torch.zeros((1,) + tuple(s[1:]), device=dev)
                     for k, s in C.comms_template(grads, config, plan).items()}
            counts = [f.launches for f in (bucket_abs_max, quant_encode, quant_decode)]
            got, new = C.sync_gradients(grads, comms, layout, config)
            synced[dev] = ({k: v.cpu().numpy() for k, v in got.items()},
                           {k: v.cpu().numpy() for k, v in new.items()},
                           [f.launches - c for f, c in zip(
                               (bucket_abs_max, quant_encode, quant_decode), counts)],
                           len(layout.sliced))
        out[mode] = synced
    return out


def test_zero_on_two_gloo_ranks_of_the_card(card, tmp_path):
    """Stages 2 and 3 update bit for bit as stage 0 does, K4 once a step on
    each rank; the compressed wire's sliced leaf through K5a-K5c on the
    card equals the plain versions on the CPU bit for bit (means, owned
    chunks and residuals), one launch each per group and per sliced leaf."""
    from torch_ranks import run_ranks

    ranks = run_ranks(_zero_card_rank, 2, tmp_path, timeout=300)
    for r in ranks:
        assert r[0]["k4"] == r[2]["k4"] == r[3]["k4"] == 3
        assert r[2]["sliced"] == r[3]["sliced"] == 2
        for stage in (2, 3):
            for k, v in r[0]["params"].items():
                np.testing.assert_array_equal(r[stage]["params"][k], v, err_msg=k)
        for mode in ("int8", "fp8"):
            cpu, cuda = r[mode]["cpu"], r[mode]["cuda"]
            assert cuda[3] == 1 and cuda[2] == [2, 2, 2] and cpu[2] == [0, 0, 0]
            for a, b in zip(cpu[:2], cuda[:2]):
                for k in a:
                    assert np.array_equal(np.ascontiguousarray(a[k]).view(np.uint8),
                                          np.ascontiguousarray(b[k]).view(np.uint8)), (mode, k)


def _tp_pp_card_rank(rank: int, world: int) -> dict:
    """Two gloo ranks on the one card: a small ``TransformerLM`` under
    ``transformer_tp_rules`` (model 2), one f32 step on CUDA tensors (K2a/
    K2b on the vocabulary shard, K3a/K3b on whole rows, K4 on the shards)
    and the same step on CPU tensors (the plain versions); then
    ``gpipe_spmd`` over a pipe axis of 2 on CUDA and CPU tensors (the hop
    by ``all_to_all_single``)."""
    from tpuframe_torch.core import MeshSpec, initialize
    from tpuframe_torch.models import transformer_tp_rules
    from tpuframe_torch.parallel import ParallelPlan, full_precision, gpipe_spmd
    from tpuframe_torch.parallel.tensor import full_tensor

    # a spawned process starts with TF32 on; the CPU has none
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rt = initialize({"data": 1, "model": world}, device="cuda:0", backend="gloo")
    cfg = dict(vocab_size=512, num_layers=2, num_heads=4, head_dim=16, max_len=64)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (4, 65)))
    out = {}
    for dev in ("cpu", "cuda:0"):
        # the same weights on both: drawn on the CPU (a CUDA generator draws others)
        model = TransformerLM(**cfg, attn_impl="full", device="cpu", seed=0).to(dev)
        plan = ParallelPlan(mesh=rt.mesh, rules=transformer_tp_rules())
        state = create_train_state(model, fused_adamw(1e-3, eps=1e-3), plan=plan)
        counters = (cross_entropy_fwd, cross_entropy_bwd, layer_norm_fwd, layer_norm_bwd,
                    fused_adamw_multi_update_)
        before = [c.launches for c in counters]
        batch = {"input": toks[:, :-1].to(dev), "label": toks[:, 1:].to(dev)}
        state, m = make_train_step(full_precision(), plan=plan)(state, batch)
        torch.cuda.synchronize()
        grads = {n: full_tensor(p.grad, model.tp_layout[n], model.tp_mesh).cpu().numpy()
                 if n in model.tp_layout else p.grad.cpu().numpy()
                 for n, p in model.named_parameters()}
        out[dev] = {"loss": float(m["loss_sum"] / m["count"]), "grads": grads,
                    "launches": [c.launches - b for c, b in zip(counters, before)]}
    mesh = MeshSpec(pipe=world, data=1).build(world)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((world, 32, 32)).astype(np.float32) * 0.3
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    for dev in ("cpu", "cuda:0"):
        p = {"w": torch.from_numpy(w[rank:rank + 1]).to(dev).requires_grad_(True)}
        y = gpipe_spmd(lambda q, h: torch.tanh(h @ q["w"]), p, torch.from_numpy(x).to(dev),
                       mesh=mesh)
        (y ** 2).mean().backward()
        out[f"pipe_{dev}"] = {"y": y.detach().cpu().numpy(), "g": p["w"].grad.cpu().numpy()}
    return out


def test_tensor_and_pipeline_parallel_on_gloo_ranks_of_the_card(card, tmp_path):
    """The TP step's loss and whole gradients on the card (the kernels on
    the shards) against the same step's plain versions on the CPU, within
    1e-5 relative (loss) and 1e-5 of each gradient's largest element, with
    K2a/K2b once, K3a/K3b five times and K4 once on each rank; the GPipe
    schedule's outputs and gradients on CUDA tensors within 1e-5 of the CPU
    tensors' (the hop carried by gloo's ``all_to_all_single`` both ways)."""
    from torch_ranks import run_ranks

    for r in run_ranks(_tp_pp_card_rank, 2, tmp_path, timeout=300):
        cpu, gpu = r["cpu"], r["cuda:0"]
        assert gpu["launches"] == [1, 1, 5, 5, 1] and cpu["launches"] == [0] * 5
        assert abs(gpu["loss"] / cpu["loss"] - 1) <= 1e-5
        for k, v in cpu["grads"].items():
            np.testing.assert_allclose(gpu["grads"][k], v, rtol=0,
                                       atol=1e-5 * float(np.abs(v).max()), err_msg=k)
        for k in ("y", "g"):
            np.testing.assert_allclose(r["pipe_cuda:0"][k], r["pipe_cpu"][k], rtol=0, atol=1e-5)


# -- sequence parallelism and MoE: K6's float32 partials, the ring (K7), Ulysses
# (K8) and the MoE row copies (K9a-K9c) ------------------------------------------------

K6_PARTIAL_CASES = [("2x1000x3x64_causal", 2, 1000, 3, 64, True),
                    ("1x300x2x128", 1, 300, 2, 128, False),
                    ("2x13x3x16_causal", 2, 13, 3, 16, True),
                    ("1x2048x2x64_causal", 1, 2048, 2, 64, True)]


@pytest.mark.parametrize("case", K6_PARTIAL_CASES, ids=[c[0] for c in K6_PARTIAL_CASES])
def test_blockwise_attention_float32_partials(card, case):
    """``out_dtype=torch.float32`` on bf16 inputs stores the accumulators as
    they are: rounded to bf16 they are the default launch's bits (and lse
    and delta are equal); against the plain schedule's float32 partials on
    float32 copies of the inputs, no further than twice the plain schedule
    run on the bf16 inputs.  One launch a call."""
    _, b, l, h, d, causal = case
    q, k, v, g = _k6_inputs(b, l, h, d, torch.bfloat16, card)
    f32 = torch.float32
    counters = (blockwise_attention_fwd, blockwise_attention_bwd_dq, blockwise_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = blockwise_attention_fwd(q, k, v, causal=causal)
    out32, lse32 = blockwise_attention_fwd(q, k, v, causal=causal, out_dtype=f32)
    dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=causal)
    dq32, delta32 = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=causal, out_dtype=f32)
    dk, dv = blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=causal)
    dk32, dv32 = blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=causal,
                                             out_dtype=f32)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 2]
    got = (out32, dq32, dk32, dv32)
    assert all(t.dtype == f32 for t in got)
    for a, b16 in zip(got, (out, dq, dk, dv)):
        assert torch.equal(a.to(torch.bfloat16), b16)
    assert torch.equal(lse32, lse) and torch.equal(delta32, delta)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    want_out, want_lse = blockwise_attention_reference(qf, kf, vf, causal=causal)
    want = (want_out, *blockwise_attention_bwd_reference(qf, kf, vf, want_out, want_lse, gf,
                                                         causal=causal))
    p_out, p_lse = blockwise_attention_reference(q, k, v, causal=causal, out_dtype=f32)
    plain = (p_out, *blockwise_attention_bwd_reference(q, k, v, out, p_lse, g, causal=causal))
    for i, (a, w, p) in enumerate(zip(got, want, plain)):
        err, ref = float((a - w).abs().max()), float((p.float() - w).abs().max())
        assert err <= 2 * ref, (i, err, ref)


def _moe_slots(n, e, k, capacity, e0, e_local, seed):
    """A routing of n tokens' k distinct random choices among e experts:
    the (e_loc, slot, count) descriptors of experts e0 .. e0 + e_local - 1."""
    from tpuframe_torch.ops.moe_gating import _descriptors, _routing

    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(np.argsort(rng.random((n, e)), -1)[:, :k].astype(np.int32))
    choice_exp, _, keep, _ = _routing(idx, e, capacity)
    return _descriptors(choice_exp, keep, e0, e_local)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous tensor whose base lies one element
    past an allocation's start (so not on 16 bytes)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _nan_buffer(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device).fill_(float("nan"))


#: (id, dtype, N, D, E, k, capacity, first local expert, local experts,
#: rows and buffer on a misaligned base)
MOE_CASES = [("f32_all", torch.float32, 64, 48, 4, 2, 40, 0, 4, False),
             ("f32_tight_half", torch.float32, 64, 48, 4, 2, 5, 2, 2, False),
             ("bf16_path", torch.bfloat16, 4096, 768, 8, 2, 1280, 4, 4, False),
             ("bf16_ragged", torch.bfloat16, 333, 100, 6, 3, 170, 0, 6, False),
             ("f32_top1", torch.float32, 256, 64, 4, 1, 70, 0, 4, False),
             ("bf16_top4", torch.bfloat16, 512, 768, 8, 4, 300, 2, 4, False),
             ("bf16_top8", torch.bfloat16, 256, 512, 8, 8, 280, 0, 8, False),
             ("bf16_top10_generic", torch.bfloat16, 128, 256, 12, 10, 110, 3, 6, False),
             ("bf16_d97", torch.bfloat16, 300, 97, 6, 2, 120, 0, 3, False),
             ("bf16_misaligned", torch.bfloat16, 1024, 768, 8, 2, 300, 4, 4, True),
             ("f32_misaligned", torch.float32, 200, 96, 4, 2, 120, 0, 2, True),
             ("bf16_mixtral_width", torch.bfloat16, 8192, 4096, 8, 2, 2560, 0, 8, False)]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_kernels_match_plain_versions(card, case):
    """K9a (the dispatch), K9b (combine) and K9c (the combine's backward:
    ``dbuf`` and ``dgate`` in one launch) against their plain versions on
    CPU copies of the same inputs: K9a, K9b and K9c's ``dbuf`` bit-equal
    (each product and sum rounded as the plain version rounds it), K9c's
    ``dgate`` within 1e-5 of the largest dot (a float32 dot in another
    order) and +0.0 bit for bit where a slot is not held here.  K9a writes
    a NaN-filled ``torch.empty`` buffer whole, and so does K9c its
    NaN-filled ``out=``: the zero-filled result, no NaN left.  Top 1 to 8 (K9b's instances) and 10 (its generic loop), rows of
    16-byte accesses and of elements (D = 97 and 100 bf16; a misaligned
    base), Mixtral's width.  One launch a call; a rerun gives the same bits,
    and so does the same (g, buf) row pair at two slots in different
    blocks."""
    from tpuframe_torch.ops.moe_gating import moe_combine, moe_combine_backward, moe_dispatch

    _, dtype, n, d, e, k, capacity, e0, e_local, misaligned = case
    e_loc, slot, count = _moe_slots(n, e, k, capacity, e0, e_local, seed=3)
    rows = min(capacity, n * k)
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.random(n * k).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    counters = (moe_dispatch, moe_combine, moe_combine_backward)
    shape = (e_local, rows, d)
    place = _misaligned if misaligned else (lambda t: t)
    got = {}
    for dev in ("cpu", card):
        before = [c.launches for c in counters]
        a = [t.to(dev) for t in (src, w, g, e_loc, slot, count)]
        if dev == card:
            a[0], a[2] = place(a[0]), place(a[2])
            assert not misaligned or (a[0].data_ptr() % 16 and a[2].data_ptr() % 16)
        buf = moe_dispatch(a[0], _nan_buffer(shape, dtype, dev), a[3], a[4], count=a[5])
        fwd_buf = place(buf) if dev == card else buf
        out = moe_combine(fwd_buf, a[1], a[3], a[4], n)
        if dev == card:
            again = moe_dispatch(a[0], _nan_buffer(shape, dtype, dev), a[3], a[4], count=a[5])
        nan_out = (_nan_buffer(shape, dtype, dev), _nan_buffer((n * k,), torch.float32, dev))
        dbuf, dgate = moe_combine_backward(a[2], fwd_buf, a[1], a[3], a[4], a[5], *nan_out)
        got[str(dev)] = [t.cpu() for t in (buf, out, dbuf, dgate)]
        if dev == card:
            torch.cuda.synchronize()
            assert [c.launches - b for c, b in zip(counters, before)] == [2, 1, 1]
            assert torch.equal(again.cpu(), got[str(dev)][0])
            again = moe_combine(fwd_buf, a[1], a[3], a[4], n)
            assert torch.equal(again.cpu(), got[str(dev)][1])
            again_dbuf, again_dgate = moe_combine_backward(
                a[2], fwd_buf, a[1], a[3], a[4], a[5], torch.empty_like(dbuf),
                torch.empty_like(dgate))
            assert torch.equal(again_dbuf.cpu(), got[str(dev)][2])
            assert torch.equal(again_dgate.cpu().view(torch.int32),
                               got[str(dev)][3].view(torch.int32))
            # the same (g, buf) row pair at the first and the last held slot
            # (different blocks, other places in their blocks): the same bits
            held_f = (e_loc >= 0).nonzero()[:, 0]
            f1, f2 = int(held_f[0]), int(held_f[-1])
            assert f1 // 16 != f2 // 16
            g2, buf2 = a[2].clone(), buf.clone()
            g2[f2 % n] = g2[f1 % n]
            buf2[int(e_loc[f2]), int(slot[f2])] = buf2[int(e_loc[f1]), int(slot[f1])]
            _, dgate2 = moe_combine_backward(place(g2), place(buf2), a[1], a[3], a[4], a[5],
                                             torch.empty_like(dbuf), torch.empty_like(dgate))
            pair = dgate2[[f1, f2]].cpu().view(torch.int32)
            assert int(pair[0]) == int(pair[1]), pair
    cpu, gpu = got["cpu"], got[str(card)]
    held = e_loc >= 0
    zeroed = torch.zeros((e_local, rows, d), dtype=dtype)
    zeroed[e_loc[held].long(), slot[held].long()] = src[held.nonzero()[:, 0] % n]
    assert torch.equal(cpu[0], zeroed)  # the plain version's rows: the zero-filled result
    for i in range(3):
        assert not gpu[i].isnan().any(), i
        assert torch.equal(gpu[i], cpu[i]), i
    assert not gpu[3].isnan().any()
    assert float((gpu[3] - cpu[3]).abs().max()) <= 1e-5 * max(1.0, float(cpu[3].abs().max()))
    assert torch.equal(gpu[3][~held].view(torch.int32), torch.zeros(int((~held).sum()),
                                                                    dtype=torch.int32))
    assert int(held.sum()) > 0 and int((~held).sum()) > 0 or e_local == e
    assert int(count.sum()) == int(held.sum())


def _sp_card_rank(rank: int, world: int, what: str) -> dict:
    """Two gloo ranks on the one card: (``what="seq"``) the ring and
    Ulysses over ``seq`` (f32, causal) on CUDA tensors against the same
    ranks' CPU tensors, with K6's launches; (``"expert"``) a small MoE LM
    step at ``expert=2`` on the card and on the CPU, with K9's launches."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.ops import ring_attention, ulysses_attention

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rt = initialize({"data": 1, what: world}, device="cuda:0", backend="gloo")
    if what == "expert":
        return _moe_card_step(rt)
    out = {}
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.standard_normal((2, 128 * world, 4, 32)).astype(np.float32)
                  for _ in range(4))
    run = slice(rank * 128, (rank + 1) * 128)
    k6 = (blockwise_attention_fwd, blockwise_attention_bwd_dq, blockwise_attention_bwd_dkv)
    for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for dev in ("cpu", "cuda:0"):
            before = [c.launches for c in k6]
            x = [torch.from_numpy(a[:, run].copy()).to(dev).requires_grad_(True)
                 for a in (q, k, v)]
            o = fn(*x, rt.mesh, causal=True)
            (o * torch.from_numpy(g[:, run].copy()).to(dev)).sum().backward()
            out[f"{impl}_{dev}"] = {"o": o.detach().cpu().numpy(),
                                    "grads": [t.grad.cpu().numpy() for t in x],
                                    "launches": [c.launches - b for c, b in zip(k6, before)]}
    return out


def _moe_card_step(rt) -> dict:
    """A small MoE LM step at ``expert=2`` on the card and on the CPU."""
    from tpuframe_torch.models import moe_rules
    from tpuframe_torch.ops.moe_gating import moe_combine, moe_combine_backward, moe_dispatch
    from tpuframe_torch.parallel import ParallelPlan, full_precision
    from tpuframe_torch.parallel.tensor import full_tensor

    out = {}
    cfg = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16, max_len=64)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 65)))
    k9 = (moe_dispatch, moe_combine, moe_combine_backward)
    for dev in ("cpu", "cuda:0"):
        model = TransformerLM(**cfg, attn_impl="full", moe_experts=4, device="cpu",
                              seed=0).to(dev)
        plan = ParallelPlan(mesh=rt.mesh, rules=moe_rules())
        state = create_train_state(model, fused_adamw(1e-3, eps=1e-3), plan=plan)
        before = [c.launches for c in k9]
        batch = {"input": toks[:, :-1].to(dev), "label": toks[:, 1:].to(dev)}
        state, m = make_train_step(full_precision(), plan=plan)(state, batch)
        torch.cuda.synchronize()
        grads = {n: full_tensor(p.grad, model.tp_layout[n], model.tp_mesh).cpu().numpy()
                 if n in model.tp_layout else p.grad.cpu().numpy()
                 for n, p in model.named_parameters()}
        out[f"moe_{dev}"] = {"loss": float(m["loss_sum"] / m["count"]), "grads": grads,
                             "launches": [c.launches - b for c, b in zip(k9, before)]}
    return out


def test_sequence_and_expert_parallel_on_gloo_ranks_of_the_card(card, tmp_path):
    """The ring and Ulysses on CUDA tensors (K6 tiles; the ring's float32
    partials) against the same ranks' CPU tensors within 1e-5 (out) and
    1e-4 (gradients), rank r of the causal ring launching r + 1 tiles of
    each kernel and Ulysses one; a MoE LM step at ``expert=2`` on the card
    against the CPU within 1e-5 relative (loss) and 1e-5 of each gradient's
    largest element, K9a once, K9b twice and K9c once a MoE layer."""
    from torch_ranks import run_ranks

    seq = run_ranks(_sp_card_rank, 2, tmp_path / "seq", "seq", timeout=300)
    expert = run_ranks(_sp_card_rank, 2, tmp_path / "expert", "expert", timeout=300)
    for rank, (r, e) in enumerate(zip(seq, expert)):
        for impl, want_launches in (("ring", [rank + 1] * 3), ("ulysses", [1, 1, 1])):
            cpu, gpu = r[f"{impl}_cpu"], r[f"{impl}_cuda:0"]
            assert gpu["launches"] == want_launches and cpu["launches"] == [0, 0, 0], impl
            np.testing.assert_allclose(gpu["o"], cpu["o"], rtol=0, atol=1e-5, err_msg=impl)
            for a, b in zip(gpu["grads"], cpu["grads"]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=impl)
        cpu, gpu = e["moe_cpu"], e["moe_cuda:0"]
        assert gpu["launches"] == [2, 4, 2] and cpu["launches"] == [0, 0, 0]
        assert abs(gpu["loss"] / cpu["loss"] - 1) <= 1e-5
        for k, v in cpu["grads"].items():
            np.testing.assert_allclose(gpu["grads"][k], v, rtol=0,
                                       atol=1e-5 * float(np.abs(v).max()), err_msg=k)


def _remote_card_rank() -> dict:
    """An agent's runtime on the card: its backend, device and a gloo
    all-reduce of a CUDA tensor."""
    import os

    import torch.distributed as dist

    from tpuframe_torch.core import initialize

    rt = initialize()
    x = torch.full((3,), float(rt.process_index + 1), device=rt.device)
    dist.all_reduce(x)
    return {"rank": rt.process_index, "local_rank": os.environ["LOCAL_RANK"],
            "backend": dist.get_backend(), "device": str(x.device), "sum": x.cpu().tolist()}


def test_two_localhost_agents_share_the_card_over_gloo(card):
    """The remote launcher with two "hosts" on localhost: each agent drives
    the one card (``LOCAL_RANK`` 0 and 1 over one card: gloo, NCCL refuses
    two ranks on a device), and rank 0's value comes back."""
    import sys

    from tpuframe_torch.launch import RemoteDistributor

    rd = RemoteDistributor(["localhost", "localhost"], connect=lambda host: [],
                           remote_python=sys.executable, timeout_s=300.0)
    assert rd.run(_remote_card_rank) == {"rank": 0, "local_rank": "0", "backend": "gloo",
                                         "device": "cuda:0", "sum": [3.0, 3.0, 3.0]}
