"""The small models of the launcher slice against the JAX package's.

- ``MnistNet``: log-probabilities on JAX's weights (carried across by
  ``models.interop``, ``fc1``'s rows permuted from flax's NHWC flatten
  order to NCHW), float32 within 1e-5 absolute (the same float32 convs
  and dense layers, summed in other orders).
- ``conv2_drop``: whole feature maps drop at the rate, held by
  distribution (ROADMAP Queue 3 item 5: the masks come from another
  generator than flax's): the share of dropped maps within six binomial
  standard deviations of 0.5, every map all kept or all zero, kept values
  ``2 x`` bit for bit, as flax ``Dropout(broadcast_dims=(1, 2))`` does.
- ``TransferClassifier`` over ``ResNet18(num_classes=0)``: logits on JAX's
  weights within 1e-4 (the ResNet parity tolerance of
  ``test_torch_port_resnet.py``), eval mode.
- ``backbone_frozen_labels``: JAX's label tree, leaf for leaf, on the JAX
  tree; the module form labels every parameter under ``backbone.``
  frozen.
- Freezing: three AdamW steps (weight decay 1e-2) of the classifier with
  the backbone frozen (``models.freeze``, the port's
  ``optax.multi_transform(..., set_to_zero())``): the backbone bit-equal to
  its start, the head within 1e-5 of JAX's ``multi_transform`` run on the
  same weights and batches (lr 1e-3; BatchNorm in train mode moves its
  buffers on both sides).  Without the freeze the backbone moves (the
  control).  K4's ``fused_adamw`` leaves a frozen parameter and its count
  untouched too.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuframe.models import MnistNet as JaxMnistNet
from tpuframe.models import ResNet18 as JaxResNet18
from tpuframe.models import TransferClassifier as JaxTransferClassifier
from tpuframe.models import backbone_frozen_labels as jax_labels
from tpuframe.parallel.precision import full_precision as jax_f32
from tpuframe.train.state import create_train_state as jax_create_train_state
from tpuframe.train.step import make_train_step as jax_make_train_step
from tpuframe_torch.models import (
    MnistNet,
    ResNet18,
    TransferClassifier,
    backbone_frozen_labels,
    freeze,
    from_jax_variables,
)
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.train import create_train_state, make_train_step
from tpuframe_torch.train.optim import optimizer_from_config


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mnist(seed: int):
    x = np.random.default_rng(seed).uniform(0, 1, (5, 28, 28, 1)).astype(np.float32)
    jm = JaxMnistNet()
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    model = MnistNet(device="cpu")
    model.load_state_dict(from_jax_variables(_np(variables)))
    return jm, variables, model, x


@pytest.mark.parametrize("seed", [0, 1])
def test_mnist_net_matches_jax_on_jax_weights(seed):
    jm, variables, model, x = _mnist(seed)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (5, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    # log-probabilities: each row sums to 1 after exp
    np.testing.assert_allclose(got.exp().sum(-1).detach().numpy(), 1.0, atol=1e-5)


def test_mnist_fc1_rows_are_permuted_from_flax_order():
    """flax flattens (h, w, c), the port (c, h, w): the carried ``fc1``
    column for feature (c, h, w) is flax's row h*80 + w*20 + c."""
    _, variables, model, _ = _mnist(0)
    kernel = np.asarray(variables["params"]["fc1"]["kernel"])  # (320, 50)
    weight = model.fc1.weight.detach().numpy()  # (50, 320)
    for c, h, w in ((0, 0, 0), (3, 1, 2), (19, 3, 3), (7, 0, 3)):
        np.testing.assert_array_equal(weight[:, c * 16 + h * 4 + w], kernel[h * 80 + w * 20 + c])


def test_conv2_drop_drops_whole_maps_at_its_rate_as_flax():
    model = MnistNet(device="cpu").train()
    n, c, hw = 64, 20, 8
    x = torch.rand(n, c, hw, hw, dtype=torch.float32) + 0.5
    y = model.conv2_drop(x, torch.Generator().manual_seed(3))
    kept = (y != 0).reshape(n, c, -1)
    whole = kept.all(-1) | (~kept).all(-1)
    assert bool(whole.all()), "a map was dropped in part"
    dropped = float((~kept.any(-1)).float().mean())
    std = (0.25 / (n * c)) ** 0.5
    assert abs(dropped - 0.5) < 6 * std, dropped
    mask = kept.any(-1)[:, :, None, None].expand_as(x)
    assert torch.equal(y[mask], x[mask] / 0.5)
    # flax's Dropout(broadcast_dims=(1, 2)) on NHWC: the same structure
    xj = jnp.transpose(jnp.asarray(x.numpy()), (0, 2, 3, 1))
    yj = np.asarray(fnn.Dropout(0.5, broadcast_dims=(1, 2)).apply(
        {}, xj, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))
    kj = (yj != 0).reshape(n, -1, c)
    assert bool((kj.all(1) | (~kj).all(1)).all())
    # eval mode: the identity
    assert torch.equal(model.eval().conv2_drop(x, None), x)


def _transfer(seed: int = 0, dropout: float = 0.5):
    x = np.random.default_rng(seed).standard_normal((4, 16, 16, 3)).astype(np.float32)
    jt = JaxTransferClassifier(backbone=JaxResNet18(num_classes=0, num_filters=8, stem="cifar"),
                               num_classes=5, dropout_rate=dropout)
    variables = jt.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    model = TransferClassifier(ResNet18(num_classes=0, num_filters=8, stem="cifar", device="cpu"),
                               5, dropout_rate=dropout, device="cpu")
    model.load_state_dict(from_jax_variables(_np(variables)))
    return jt, variables, model, x


@pytest.mark.parametrize("seed", [0, 1])
def test_transfer_classifier_matches_jax_on_jax_weights(seed):
    jt, variables, model, x = _transfer(seed)
    want = np.asarray(jt.apply(variables, jnp.asarray(x)))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    assert sorted({n.split(".")[0] for n, _ in model.named_parameters()}) == ["backbone", "head"]


def test_backbone_frozen_labels_as_jax():
    _, variables, model, _ = _transfer()
    want = jax_labels(variables["params"])
    assert backbone_frozen_labels(_np(variables["params"])) == want
    assert backbone_frozen_labels(_np(variables["params"]), ("head",)) == jax_labels(
        variables["params"], ("head",))
    labels = backbone_frozen_labels(model)
    n_frozen = sum(v == "frozen" for v in labels["backbone"].values())
    assert set(labels["backbone"].values()) == {"frozen"}
    assert labels["head"] == {"weight": "trainable", "bias": "trainable"}
    assert n_frozen == len(jax.tree.leaves(want["backbone"]))
    freeze(model, labels)
    assert [p.requires_grad for p in model.backbone.parameters()] == [False] * n_frozen
    assert model.head.weight.requires_grad and model.head.bias.requires_grad


def _batches(n: int = 3):
    rng = np.random.default_rng(7)
    return [{"image": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 5, 4).astype(np.int32)} for _ in range(n)]


ADAMW = {"optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 1e-2}}}


def _jax_frozen_run(jt, variables, batches):
    labels = jax_labels(variables["params"])
    tx = optax.multi_transform({"trainable": optax.adamw(1e-3, weight_decay=1e-2),
                                "frozen": optax.set_to_zero()}, labels)
    x0 = np.zeros((4, 16, 16, 3), np.float32)
    state = jax_create_train_state(jt, jax.random.PRNGKey(0), x0, tx,
                                   init_kwargs={"train": False})
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = state.replace(params=params, opt_state=tx.init(params),
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    step = jax_make_train_step(jax_f32(), donate=False)
    for b in batches:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    return state


def test_frozen_backbone_does_not_move_under_adamw_with_decay():
    jt, variables, model, _ = _transfer(dropout=0.0)
    batches = _batches()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    freeze(model)
    state = create_train_state(model, optimizer_from_config(ADAMW))
    step = make_train_step()
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    for name, p in model.backbone.named_parameters():
        assert torch.equal(p, start[f"backbone.{name}"]), name
        assert p.grad is None and not state.optimizer.state.get(p), name
    jstate = _jax_frozen_run(jt, variables, batches)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]["backbone"]):
        after = jstate.params["backbone"]
        for k in path:
            after = after[k.key]
        np.testing.assert_array_equal(np.asarray(after), np.asarray(leaf))
    head = jstate.params["head"]
    np.testing.assert_allclose(model.head.weight.detach().numpy(), np.asarray(head["kernel"]).T,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(model.head.bias.detach().numpy(), np.asarray(head["bias"]),
                               atol=1e-5, rtol=0)
    assert not torch.equal(model.head.weight, start["head.weight"])


def test_unfrozen_backbone_moves_the_control():
    _, _, model, _ = _transfer(dropout=0.0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, optimizer_from_config(ADAMW))
    step = make_train_step()
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()})
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, start[n])]
    assert len(moved) == len(start)


def test_fused_adamw_leaves_a_frozen_parameter_and_its_count_alone():
    _, _, model, _ = _transfer(dropout=0.0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    freeze(model)
    state = create_train_state(model, fused_adamw(1e-3, weight_decay=1e-2))
    step = make_train_step()
    for b in _batches(2):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    for name, p in model.backbone.named_parameters():
        assert torch.equal(p, start[f"backbone.{name}"]), name
        count = state.optimizer.state.get(p, {}).get("count")
        assert count is None or int(count) == 0, (name, count)
    assert int(state.optimizer.state[model.head.weight]["count"]) == 2
