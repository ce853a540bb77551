"""The port on the card: the CUDA kernels (K1 normalize, K2a/K2b cross
entropy) against their plain versions, a small serve slice, a small
``Trainer.fit``, and eval mode for a model left in train mode.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's dependencies::

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

(``--noconftest``: the suite's ``conftest.py`` imports JAX.)
"""

import functools

import numpy as np
import pytest
import torch

from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.models import ResNet18
from tpuframe_torch.ops import (
    cross_entropy_bwd,
    cross_entropy_bwd_reference,
    cross_entropy_fwd,
    cross_entropy_reference,
    fused_cross_entropy,
    normalize_images,
    normalize_images_reference,
)
from tpuframe_torch.parallel import full_precision
from tpuframe_torch.serve import ServeEngine, ServeKnobs
from tpuframe_torch.train import Trainer, make_eval_step, make_predict_fn

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


# (name, input, mean, std, scale)
INPUTS = [
    ("rgb_ragged", lambda: _uint8((4, 17, 17, 3)), MEAN, STD, 1 / 255),
    ("rgb_224", lambda: _uint8((2, 224, 224, 3)), MEAN, STD, 1 / 255),
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
