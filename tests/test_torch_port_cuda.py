"""The port on the card: K1's CUDA kernel against its plain version, and a
small serve slice through it.

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

from tpuframe_torch.models import ResNet18
from tpuframe_torch.ops import normalize_images, normalize_images_reference
from tpuframe_torch.parallel import full_precision
from tpuframe_torch.serve import ServeEngine, ServeKnobs
from tpuframe_torch.train import make_predict_fn

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
