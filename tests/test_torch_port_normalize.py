"""K1, the fused normalize, in the PyTorch port (``tpuframe_torch.ops``).

The port's plain path is held against the JAX package's Pallas kernel (run
in interpret mode, as ``tests/test_ops.py`` runs it) and its jnp
reference, on the same numpy inputs and at the same tolerances as
``tests/test_ops.py``.  The CUDA kernel itself runs only on the card: its
tests are in ``tests/test_torch_port_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuframe.ops import normalize_images as jax_normalize_images
from tpuframe.ops import normalize_images_reference as jax_normalize_reference
from tpuframe_torch.ops import build, normalize_images, normalize_images_reference
from tpuframe_torch.ops.dispatch import use_kernel
from tpuframe_torch.ops.normalize import MAX_CHANNELS

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# (name, make input from rng, mean, std, scale, jax dtype, torch dtype, atol)
CASES = [
    ("uint8_rgb_f32", lambda r: r.integers(0, 256, (4, 17, 17, 3), dtype=np.uint8),
     MEAN, STD, 1.0 / 255.0, jnp.float32, torch.float32, 1e-5),
    ("uint8_rgb_bf16", lambda r: r.integers(0, 256, (3, 17, 17, 3), dtype=np.uint8),
     MEAN, STD, 1.0 / 255.0, jnp.bfloat16, torch.bfloat16, 1e-2),
    ("gray_float_bf16", lambda r: r.random((2, 28, 28, 1), dtype=np.float32),
     (0.5,), (0.5,), 1.0, jnp.bfloat16, torch.bfloat16, 1e-2),
    ("float_0_255_f32", lambda r: (r.random((2, 9, 7, 3)) * 255).astype(np.float32),
     MEAN, STD, 1.0 / 255.0, jnp.float32, torch.float32, 1e-5),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_path_matches_jax_kernel_and_reference(case):
    name, make, mean, std, scale, jdt, tdt, atol = case
    x = make(np.random.default_rng(len(name)))
    jax_kernel = np.asarray(jax_normalize_images(
        jnp.asarray(x), mean, std, scale=scale, out_dtype=jdt, interpret=True
    ), np.float32)
    jax_ref = np.asarray(jax_normalize_reference(
        jnp.asarray(x), mean, std, scale=scale, out_dtype=jdt), np.float32)
    got = normalize_images(torch.from_numpy(x), mean, std, scale=scale, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, jax_kernel, atol=atol)
    np.testing.assert_allclose(got, jax_ref, atol=atol)


def test_cpu_tensor_never_launches_the_kernel(monkeypatch):
    monkeypatch.setattr(normalize_images, "launches", 0)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 5, 5, 3), dtype=np.uint8))
    normalize_images(x, MEAN, STD, out_dtype=torch.bfloat16)
    assert normalize_images.launches == 0


def test_reference_is_the_plain_formula():
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8))
    want = (x.float() / 255.0 - torch.tensor(MEAN)) / torch.tensor(STD)
    torch.testing.assert_close(normalize_images_reference(x, MEAN, STD), want,
                               atol=1e-6, rtol=0)


def test_mean_std_length_must_match_channels():
    x = torch.zeros((1, 2, 2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="channels"):
        normalize_images(x, (0.5,), (0.5,))


def test_dispatch_is_by_device_alone():
    assert use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="cuda"):
        use_kernel(torch.zeros(1, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_library_path_is_keyed_by_source_and_flags():
    path = build.library_path("normalize")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libnormalize-") and path.suffix == ".so"
    assert build.library_path("normalize") == path  # stable for one source
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.KERNELS) == {p.stem for p in build.CSRC.glob("*.cu")}


def test_launch_floor_is_built_with_the_kernels_and_needs_the_card(monkeypatch):
    """The empty kernel goes through the same build and ctypes route as
    every kernel; it computes nothing, so a CPU device has no version of it
    and raises before any build or launch."""
    from tpuframe_torch.ops import launch_floor

    assert "launch_floor" in build.KERNELS
    assert 'extern "C" int tf_launch_floor(' in (build.CSRC / "launch_floor.cu").read_text()
    monkeypatch.setattr(launch_floor, "launches", 0)
    with pytest.raises(ValueError, match="card"):
        launch_floor("cpu")
    assert launch_floor.launches == 0


def test_kernel_source_states_the_wrappers_channel_limit():
    src = (build.CSRC / "normalize.cu").read_text()
    assert f"#define TF_NORM_MAX_C {MAX_CHANNELS}" in src
    assert "tpuframe/ops/normalize.py" in src  # names the TPU kernel it replaces
