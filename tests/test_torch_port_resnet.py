"""The port's ResNet (``tpuframe_torch.models``) against the JAX package's.

Weights are drawn with numpy in the JAX layout, with non-trivial
BatchNorm parameters and running statistics (so a swapped mean/var or
scale/bias mapping shows), and carried into the port by
``from_jax_variables``; both sides get the same
numpy images.  In f32 the tolerance is atol 2e-4 / rtol 1e-3: CPU conv sums
run in another order in the two frameworks.  In bf16 the two frameworks
round at other places, so logits are held to 2 % of their largest
magnitude (a bf16 step is 0.4 %).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuframe.models import ResNet18 as JaxResNet18
from tpuframe.models import ResNet50 as JaxResNet50
from tpuframe_torch.models import (
    ResNet18,
    ResNet50,
    export_torch_resnet,
    from_jax_variables,
    import_torch_resnet,
)

HERE = os.path.dirname(os.path.abspath(__file__))
SD_PATH = os.path.join(HERE, "fixtures", "resnet18_tv_w4.pt")
GOLDEN_PATH = os.path.join(HERE, "fixtures", "resnet18_tv_w4_golden.npz")


def jax_variables(model, x: np.ndarray, seed: int) -> dict:
    """Random weights for ``model`` in the JAX layout, all drawn with numpy
    from ``seed``: He-normal kernels, and non-trivial BN scale, bias, mean
    and var.  Shapes come from ``jax.eval_shape`` of the model's init."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(seed)
    draw = {
        "mean": lambda s: rng.normal(0.0, 0.2, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.2, s),
        "kernel": lambda s: rng.normal(0.0, np.sqrt(2.0 / np.prod(s[:-1])), s),
    }

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw[k](v.shape).astype(np.float32)
                for k, v in tree.items()}

    return {"params": walk(dict(shapes["params"])),
            "batch_stats": walk(dict(shapes["batch_stats"]))}


def pair(jax_cls, torch_cls, stem, px, batch, jax_dtype, torch_dtype, norm_dtype=None):
    """(JAX logits, port logits) for one model on one numpy batch."""
    jm = jax_cls(num_classes=10, num_filters=8, stem=stem, dtype=jax_dtype,
                 norm_dtype=None if norm_dtype is None else jnp.bfloat16)
    x = np.random.default_rng(px + batch).normal(0, 1, (batch, px, px, 3)).astype(np.float32)
    variables = jax_variables(jm, x, seed=batch)
    want = np.asarray(jm.apply(variables, x, train=False))
    tm = torch_cls(num_classes=10, num_filters=8, stem=stem, dtype=torch_dtype,
                   norm_dtype=norm_dtype, device="cpu")
    tm.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, 10)
    return want, got.numpy()


MODELS = [
    ("resnet18_cifar_32px", JaxResNet18, ResNet18, "cifar", 32, 2),
    ("resnet18_imagenet_32px", JaxResNet18, ResNet18, "imagenet", 32, 2),
    ("resnet50_imagenet_64px_odd_batch", JaxResNet50, ResNet50, "imagenet", 64, 3),
]


@pytest.mark.parametrize("spec", MODELS, ids=[m[0] for m in MODELS])
def test_eval_logits_match_jax_f32(spec):
    _, jcls, tcls, stem, px, batch = spec
    want, got = pair(jcls, tcls, stem, px, batch, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("spec", [MODELS[0], MODELS[2]], ids=[MODELS[0][0], MODELS[2][0]])
def test_eval_logits_match_jax_bf16(spec):
    _, jcls, tcls, stem, px, batch = spec
    want, got = pair(jcls, tcls, stem, px, batch, jnp.bfloat16, torch.bfloat16)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_norm_dtype_bf16_matches_jax():
    want, got = pair(JaxResNet18, ResNet18, "cifar", 32, 2, jnp.bfloat16,
                     torch.bfloat16, norm_dtype=torch.bfloat16)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_dtype_flow_inside_the_model():
    """Convs run in the compute dtype, BN outputs f32, the residual sum is
    promoted (f32), and the next block receives the compute dtype."""
    m = ResNet18(num_classes=4, num_filters=4, stem="cifar", dtype=torch.bfloat16,
                 device="cpu")
    seen = {}
    m.layer1[0].conv1.register_forward_hook(
        lambda mod, i, o: seen.__setitem__("conv", o.dtype))
    m.bn1.register_forward_hook(lambda mod, i, o: seen.__setitem__("bn", o.dtype))
    m.layer1[0].register_forward_hook(lambda mod, i, o: seen.__setitem__("sum", o.dtype))
    m.layer1[1].register_forward_pre_hook(
        lambda mod, i: seen.__setitem__("next_in", i[0].dtype))
    with torch.no_grad():
        out = m(torch.zeros(1, 8, 8, 3))
    assert seen == {"conv": torch.bfloat16, "bn": torch.float32,
                    "sum": torch.float32, "next_in": torch.bfloat16}
    assert out.dtype == torch.float32
    m.set_compute_dtype(torch.float32)
    assert all(c.compute_dtype == torch.float32
               for c in m.modules() if hasattr(c, "compute_dtype"))


def test_model_is_channels_last_and_eval_only():
    """A new model is channels_last and starts in eval mode; in train mode
    its BatchNorm uses batch statistics and moves its running buffers
    (the steps choose the mode per call: tests/test_torch_port_train.py)."""
    m = ResNet18(num_classes=4, num_filters=4, device="cpu")
    assert m.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    assert not m.training
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        m(x)
    assert torch.equal(m.bn1.running_mean, torch.zeros(4))
    m.train()
    with torch.no_grad():
        m(x)
    assert not torch.equal(m.bn1.running_mean, torch.zeros(4))


def test_from_jax_variables_maps_each_leaf():
    jm = JaxResNet18(num_classes=10, num_filters=4)
    v = jax_variables(jm, np.zeros((1, 32, 32, 3), np.float32), seed=3)
    sd = from_jax_variables(v)
    model = ResNet18(num_classes=10, num_filters=4, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict
    p, s = v["params"], v["batch_stats"]
    np.testing.assert_array_equal(sd["bn1.running_mean"], s["bn1"]["mean"])
    np.testing.assert_array_equal(sd["bn1.running_var"], s["bn1"]["var"])
    np.testing.assert_array_equal(sd["bn1.weight"], p["bn1"]["scale"])
    np.testing.assert_array_equal(sd["bn1.bias"], p["bn1"]["bias"])
    np.testing.assert_array_equal(
        sd["layer2.0.downsample.1.running_var"], s["layer2_0"]["downsample_bn"]["var"])
    np.testing.assert_array_equal(
        sd["layer1.1.conv2.weight"], p["layer1_1"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"], p["fc"]["kernel"].T)
    assert int(sd["bn1.num_batches_tracked"]) == 0


@pytest.fixture(scope="module")
def torchvision_state_dict():
    return torch.load(SD_PATH, map_location="cpu", weights_only=True)


def test_torchvision_fixture_loads_and_matches_golden(torchvision_state_dict):
    """The committed torchvision-format checkpoint loads straight into the
    port's ResNet18 and reproduces torch's own eval logits."""
    golden = np.load(GOLDEN_PATH)
    model = ResNet18(num_filters=4, num_classes=10, device="cpu")
    model.load_state_dict(torchvision_state_dict)  # strict
    with torch.no_grad():
        logits = model(torch.from_numpy(golden["x"]))
    np.testing.assert_allclose(logits.numpy(), golden["logits"], atol=2e-4, rtol=1e-3)


def test_interop_round_trip(torchvision_state_dict):
    sd = torchvision_state_dict
    back = export_torch_resnet(import_torch_resnet(sd))
    expected = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == expected
    for k in expected:
        np.testing.assert_array_equal(back[k], sd[k].numpy(), err_msg=k)
