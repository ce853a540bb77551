"""The port's training path (``tpuframe_torch.train``, ``models.norm``,
``fault.health``) against the JAX package, on the same numpy inputs and
weights.

Tolerances, each with its reason:

- BatchNorm in f32: outputs and gradients 2e-5 absolute on O(1) values,
  running statistics 1e-5 — flax takes E[x^2] - E[x]^2, torch a two-pass
  variance; both are float32 sums in another order.
- ResNet18 steps in f32 on the CPU: loss 1e-5 relative, parameters and BN
  statistics 2e-4 absolute after two SGD steps (lr 0.1, momentum 0.9):
  the convolution sums run in another order in the two frameworks, and
  lr 0.1 with momentum carries those differences into the weights.
- The same under ``bf16_compute``: the two frameworks round activations
  and gradients to bf16 at other places, and in this small net bf16
  rounding alone moves JAX's own update ~40 % (relative to its norm) from
  the f32 one.  So the first loss holds 2e-2 relative, and the port's
  bf16 parameters and BN statistics lie no further from JAX's f32 ones
  than twice JAX's own bf16 run does.
- Schedules 1e-6 relative (float32 in JAX, float64 here); optimizer
  updates 1e-6 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from tpuframe.fault import health as jax_health
from tpuframe.models import ResNet18 as JaxResNet18
from tpuframe.models.norm import ReplicaGroupedBatchNorm as JaxGroupedBN
from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw
from tpuframe.parallel.precision import bf16_compute as jax_bf16
from tpuframe.parallel.precision import full_precision as jax_f32
from tpuframe.train import schedules as jax_schedules
from tpuframe.train.state import create_train_state as jax_create_train_state
from tpuframe.train.step import make_eval_step as jax_make_eval_step
from tpuframe.train.step import make_grad_accum_step as jax_make_grad_accum_step
from tpuframe.train.step import make_train_step as jax_make_train_step
from tpuframe_torch.fault.health import (
    HEALTH_STATS_FIELDS,
    HealthPolicy,
    health_verdict,
    init_health_state,
    resolve_policy,
    unpack_health_stats,
)
from tpuframe_torch.models import ReplicaGroupedBatchNorm, ResNet18, from_jax_variables
from tpuframe_torch.models.interop import import_torch_resnet
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.parallel import bf16_compute, full_precision
from tpuframe_torch.train import schedules
from tpuframe_torch.train.optim import (
    clip_by_global_norm_,
    make_optimizer,
    optimizer_from_config,
)
from tpuframe_torch.train.state import create_train_state
from tpuframe_torch.train.step import (
    make_eval_step,
    make_grad_accum_step,
    make_predict_fn,
    make_train_step,
)

# ---------------------------------------------------------------- BatchNorm


def _bn_pair(groups):
    rng = np.random.default_rng(groups)
    x = rng.normal(0.5, 2.0, (8, 5, 5, 6)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.3, 6).astype(np.float32)
    mean0 = rng.normal(0, 0.2, 6).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    r = rng.normal(0, 1, x.shape).astype(np.float32)
    return x, scale, bias, mean0, var0, r


@pytest.mark.parametrize("groups", [1, 2], ids=["flax_batchnorm", "grouped_2"])
def test_training_batchnorm_matches_flax(groups):
    x, scale, bias, mean0, var0, r = _bn_pair(groups)
    if groups == 1:
        jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    else:
        jbn = JaxGroupedBN(use_running_average=False, groups=groups)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def loss(p, xx):
        y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (_, (jy, jstats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    bn = ReplicaGroupedBatchNorm(6, groups=groups, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    to_nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(to_nhwc(y), np.asarray(jy), atol=2e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jstats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jstats["var"]), atol=1e-5)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(gx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), atol=2e-4, rtol=1e-5)


def test_batchnorm_eval_mode_uses_running_statistics_and_output_dtype():
    x, scale, bias, mean0, var0, _ = _bn_pair(1)
    bn = ReplicaGroupedBatchNorm(6, out_dtype=torch.bfloat16, device="cpu")
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.eval()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    want = (torch.from_numpy(x).to(torch.bfloat16).float() - torch.from_numpy(mean0)) / torch.sqrt(
        torch.from_numpy(var0) + 1e-5)
    torch.testing.assert_close(y.float().permute(0, 2, 3, 1), want, atol=2e-2, rtol=1e-2)
    np.testing.assert_array_equal(bn.running_mean.numpy(), mean0)  # untouched
    with pytest.raises(ValueError, match="divide evenly"):
        ReplicaGroupedBatchNorm(6, groups=3, device="cpu").train()(
            torch.zeros(4, 6, 2, 2))


# ------------------------------------------------------------- the steps

SGD = functools.partial(optax.sgd, 0.1, momentum=0.9)


def _variables(model, x, seed, unit_bn=False):
    """Random JAX-layout weights, drawn with numpy: He-normal kernels,
    random running statistics, and random BN scale and bias (or, with
    ``unit_bn``, a fresh model's 1 and 0)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(seed)
    draw = {
        "mean": lambda s: rng.normal(0.0, 0.2, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
        "scale": lambda s: np.ones(s) if unit_bn else rng.uniform(0.5, 1.5, s),
        "bias": lambda s: np.zeros(s) if unit_bn else rng.normal(0.0, 0.2, s),
        "kernel": lambda s: rng.normal(0.0, np.sqrt(2.0 / np.prod(s[:-1])), s),
    }

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw[k](v.shape).astype(np.float32)
                for k, v in tree.items()}

    return {"params": walk(dict(shapes["params"])),
            "batch_stats": walk(dict(shapes["batch_stats"]))}


def _batches(n, batch=8, px=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(0, 1, (batch, px, px, 3)).astype(np.float32),
             "label": rng.integers(0, 10, (batch,)).astype(np.int32)} for _ in range(n)]


def _pair(dtype="f32", seed=1, px=16, unit_bn=False):
    """(JAX state, port state) over one small ResNet18 and the same weights."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jm = JaxResNet18(num_classes=10, num_filters=4, stem="cifar", dtype=jdt)
    x0 = np.zeros((8, px, px, 3), np.float32)
    v = _variables(jm, x0, seed, unit_bn)
    tx = SGD()
    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, tx, init_kwargs={"train": False})
    params = jax.tree.map(jnp.asarray, v["params"])
    js = js.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                    opt_state=tx.init(params))
    tm = ResNet18(num_classes=10, num_filters=4, stem="cifar", dtype=tdt, device="cpu")
    tm.load_state_dict(from_jax_variables(v))
    ts = create_train_state(tm, make_optimizer("sgd", 0.1))
    return js, ts


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _tree(ts):
    tree = import_torch_resnet(ts.model.state_dict())
    return tree["params"], tree["batch_stats"]


def _assert_trees_close(got, want, atol, what):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(np.asarray(g), np.asarray(flat_w[path], np.float32),
                                   atol=atol, rtol=0, err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in jax.tree.leaves(tree)])


def _two_steps(dtype, px=16):
    """Two train steps of the JAX package and of the port from one state:
    (initial flat params, JAX (losses, params, stats), port (losses,
    params, stats))."""
    js, ts = _pair(dtype, seed=1, px=px)
    p0 = _flat(js.params)
    jpol, tpol = (jax_f32(), full_precision()) if dtype == "f32" else (jax_bf16(), bf16_compute())
    jstep, tstep = jax_make_train_step(jpol, donate=False), make_train_step(tpol)
    jl, tl = [], []
    for b in _batches(2, px=px):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, _torch_batch(b))
        jl.append(float(jm["loss_sum"]) / float(jm["count"]))
        tl.append(float(tm["loss_sum"]) / float(tm["count"]))
    assert ts.step == int(js.step) == 2
    assert not ts.model.training  # the step restored the eval mode it found
    return p0, (jl, js.params, js.batch_stats), (tl, *_tree(ts))


@pytest.fixture(scope="module")
def f32_steps():
    return _two_steps("f32")


def test_train_step_matches_jax_f32(f32_steps):
    _, (jl, jparams, jstats), (tl, params, stats) = f32_steps
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_trees_close(params, jparams, 2e-4, "param")
    _assert_trees_close(stats, jstats, 2e-4, "batch_stats")


def test_train_step_matches_jax_bf16(f32_steps):
    """bf16 rounding alone moves this small net's updates far: JAX's own
    bf16 run lies ~40 % (relative to the update norm) from its f32 run, and
    the second step's loss, taken at those weights, moves with them.  So
    the first loss (the same weights on both sides) is held within 2e-2
    relative of JAX's bf16 loss, and after two steps the port's bf16
    parameters and BN statistics lie no further from JAX's f32 ones than
    twice JAX's own bf16 run does."""
    p0, (_, f32_params, f32_stats), _ = f32_steps
    _, (jl, jparams, jstats), (tl, params, stats) = _two_steps("bf16")
    assert abs(tl[0] - jl[0]) <= 2e-2 * abs(jl[0]), (tl, jl)

    def rel(a):
        return np.linalg.norm(_flat(a) - _flat(f32_params)) / np.linalg.norm(_flat(f32_params) - p0)

    assert rel(params) <= 2 * rel(jparams), (rel(params), rel(jparams))
    gap = np.abs(_flat(jstats) - _flat(f32_stats)).max()
    assert np.abs(_flat(stats) - _flat(f32_stats)).max() <= 2 * gap, gap


def test_eval_step_with_weight_mask_matches_jax():
    js, ts = _pair("f32", seed=2)
    b = _batches(1, seed=3)[0]
    b["weight"] = np.array([1, 1, 1, 0, 1, 0, 1, 1], np.float32)
    jm = jax_make_eval_step(jax_f32())(js, b)
    ts.model.train()  # a model left in train mode is still evaluated in eval mode
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    tm = make_eval_step(full_precision())(ts, _torch_batch(b))
    for k in ("loss_sum", "correct", "count"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-5), k
    assert float(tm["count"]) == 6.0
    for k, v in ts.model.state_dict().items():
        torch.testing.assert_close(v, before[k], atol=0, rtol=0)
    assert ts.model.training


def test_grad_accum_step_matches_jax():
    js, ts = _pair("f32", seed=4)
    b = _batches(1, seed=5)[0]
    micro = {k: v.reshape((2, 4) + v.shape[1:]) for k, v in b.items()}
    js, jm = jax_make_grad_accum_step(2, jax_f32(), donate=False)(js, micro)
    ts, tm = make_grad_accum_step(2, full_precision())(ts, _torch_batch(micro))
    assert float(tm["loss_sum"]) == pytest.approx(float(jm["loss_sum"]), rel=1e-5)
    assert float(tm["count"]) == float(jm["count"]) == 8.0
    params, stats = _tree(ts)
    _assert_trees_close(params, js.params, 2e-4, "param")
    _assert_trees_close(stats, js.batch_stats, 2e-4, "batch_stats")


def test_predict_of_a_model_left_in_train_mode_uses_running_statistics():
    _, ts = _pair("f32", seed=6)
    x = torch.from_numpy(_batches(1, seed=7)[0]["image"])
    ts.model.eval()
    want = make_predict_fn()(ts.model, x)
    ts.model.train()
    before = ts.model.bn1.running_mean.clone()
    got = make_predict_fn()(ts.model, x)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(ts.model.bn1.running_mean, before, atol=0, rtol=0)
    assert ts.model.training


# ---------------------------------------------------------------- health


def test_health_verdict_matches_jax_on_crafted_inputs():
    policy = HealthPolicy(warmup_steps=2)
    jpolicy = jax_health.HealthPolicy(warmup_steps=2)
    grads = [np.full((3, 2), 0.5, np.float32), np.arange(4, dtype=np.float32)]
    # (loss, poison): good, good, good, spike, NaN loss, inf gradient
    seq = [(2.0, None), (2.1, None), (1.9, None), (30.0, None), (np.nan, None), (1.8, np.inf)]
    ts, js = init_health_state("cpu"), jax_health.init_health_state()
    for step, (loss, poison) in enumerate(seq):
        g = [a.copy() for a in grads]
        if poison is not None:
            g[1][0] = poison
        tbad, ts, tm = health_verdict(torch.tensor(loss, dtype=torch.float32),
                                      [torch.from_numpy(a) for a in g], ts, step, policy)
        jbad, js, jm = jax_health.health_verdict(jnp.float32(loss), [jnp.asarray(a) for a in g],
                                                 js, step, jpolicy)
        assert bool(tbad) == bool(jbad), step
        np.testing.assert_allclose(tm["health_stats"].numpy(), np.asarray(jm["health_stats"]),
                                   rtol=1e-6, atol=1e-6)
        for k in js:
            np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert HEALTH_STATS_FIELDS == jax_health.HEALTH_STATS_FIELDS
    assert unpack_health_stats([1, 0, 1, 2.5, 3]) == jax_health.unpack_health_stats([1, 0, 1, 2.5, 3])
    assert resolve_policy(False) is None and resolve_policy(policy) is policy


def test_nan_batch_leaves_params_optimizer_state_and_bn_stats_untouched():
    """A NaN image poisons loss and gradients: the step applies no update,
    zeroes the metrics and counts the bad step, as the JAX step does."""
    js, ts = _pair("f32", seed=8)
    good, bad = _batches(2, seed=9)
    bad["image"][0, 0, 0, 0] = np.nan
    policy = HealthPolicy()
    step = make_train_step(full_precision(), health=policy)
    ts, _ = step(ts, _torch_batch(good))  # momentum buffers are now non-zero
    before = [t.clone() for t in _state_tensors(ts)]
    ts, m = step(ts, _torch_batch(bad))
    for a, b in zip(before, _state_tensors(ts)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    stats = unpack_health_stats(m["health_stats"])
    assert stats["health_bad"] == 1.0 and stats["health_nonfinite"] == 1.0
    assert float(m["loss_sum"]) == 0.0 and float(m["count"]) == 0.0
    assert float(ts.health["bad_steps"]) == 1.0 and float(ts.health["last_bad_step"]) == 1.0
    assert ts.step == 2

    jstep = jax_make_train_step(jax_f32(), donate=False,
                                health=jax_health.HealthPolicy())
    js, _ = jstep(js, good)
    jbefore = jax.tree.map(np.asarray, (js.params, js.opt_state, js.batch_stats))
    js, jm = jstep(js, bad)
    jafter = jax.tree.map(np.asarray, (js.params, js.opt_state, js.batch_stats))
    jax.tree.map(np.testing.assert_array_equal, jbefore, jafter)
    np.testing.assert_allclose(m["health_stats"].numpy()[:3], np.asarray(jm["health_stats"])[:3])


# (name, JAX tx, port spec): SGD with momentum over a warm-up into cosine
# decay (the schedule's count is optax's, inside opt_state), and the fused
# AdamW (its count is FusedAdamWState.count)
SKIP_OPTIMIZERS = [
    ("sgd_warmup_cosine",
     lambda: optax.sgd(jax_schedules.warmup_cosine(0.02, 2, 6, end_lr=0.002, init_lr=0.004),
                       momentum=0.9),
     lambda: make_optimizer("sgd", schedules.warmup_cosine(0.02, 2, 6, end_lr=0.002,
                                                          init_lr=0.004))),
    ("fused_adamw", lambda: jax_fused_adamw(1e-2, weight_decay=1e-4),
     lambda: fused_adamw(1e-2, weight_decay=1e-4)),
]


@pytest.mark.parametrize("name,make_j,make_t", SKIP_OPTIMIZERS, ids=[o[0] for o in SKIP_OPTIMIZERS])
def test_skipped_step_does_not_advance_the_optimizer_count(name, make_j, make_t):
    """Four health-guarded steps, the third on a NaN batch: JAX restores
    ``opt_state`` (the schedule's and AdamW's counts in it), so the fourth
    step reads the schedule at count 2, not 3.  The port counts applied
    updates on the device and restores the count with the rest; parameters
    and BN statistics agree with JAX within the f32 step tolerance (peak lr
    0.02: this small ResNet's f32 steps drift apart ~1e3-fold faster at
    0.1).  Read at the count of steps taken instead, the SGD case moved the
    parameters 2.5e-2 from JAX's, against 3e-5 read at the applied count."""
    js, ts = _pair("f32", seed=10)
    jtx = make_j()
    js = js.replace(tx=jtx, opt_state=jtx.init(js.params))
    ts = create_train_state(ts.model, make_t())
    batches = _batches(4, seed=11)
    batches[2]["image"][0, 0, 0, 0] = np.nan
    jstep = jax_make_train_step(jax_f32(), donate=False, health=jax_health.HealthPolicy())
    tstep = make_train_step(full_precision(), health=HealthPolicy())
    bad = []
    for b in batches:
        js, _ = jstep(js, b)
        ts, m = tstep(ts, _torch_batch(b))
        bad.append(unpack_health_stats(m["health_stats"])["health_bad"])
    assert bad == [0.0, 0.0, 1.0, 0.0]
    assert ts.step == int(js.step) == 4 and int(ts.updates) == 3
    params, stats = _tree(ts)
    _assert_trees_close(params, js.params, 2e-4, "param")
    _assert_trees_close(stats, js.batch_stats, 2e-4, "batch_stats")


def _state_tensors(ts):
    out = list(ts.model.state_dict().values())
    for st in ts.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
    return out


# ------------------------------------------------------------ schedules

SCHEDULES = [
    ("warmup_lr", lambda m: m.warmup_lr(0.1, 7, min_lr=0.01)),
    ("warmup_lr_log", lambda m: m.warmup_lr(0.1, 7, warmup_type="log")),
    ("warmup_decay_lr", lambda m: m.warmup_decay_lr(0.2, 5, 20, min_lr=0.02)),
    ("cosine_annealing", lambda m: m.cosine_annealing(0.1, 15, eta_min=0.001)),
    ("step_decay", lambda m: m.step_decay(0.1, 4, gamma=0.5)),
    ("warmup_cosine", lambda m: m.warmup_cosine(0.3, 5, 20, end_lr=0.01, init_lr=0.001)),
    ("config_warmup_decay", lambda m: m.from_config(
        {"scheduler": {"type": "WarmupDecayLR",
                       "params": {"warmup_max_lr": 0.05, "warmup_num_steps": 3,
                                  "total_num_steps": "auto"}}}, total_steps=18)),
    ("config_cosine_lr", lambda m: m.from_config(
        {"type": "WarmupCosineLR", "params": {"warmup_max_lr": 0.1, "warmup_num_steps": 2,
                                              "cos_min_ratio": 0.1}}, total_steps=12)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax_at_every_step(name, make):
    jsched, tsched = make(jax_schedules), make(schedules)
    for step in range(25):
        want = float(jsched(step))
        assert tsched(step) == pytest.approx(want, rel=1e-6, abs=1e-7), (name, step)


# ------------------------------------------------------------ optimizers

OPTIMIZERS = [
    ("sgd", lambda: make_optimizer("sgd", 0.05), lambda: optax.sgd(0.05, momentum=0.9)),
    ("adam", lambda: make_optimizer("adam", 0.01), lambda: optax.adam(0.01)),
    ("adamw_named", lambda: make_optimizer("adamw", 0.01), lambda: optax.adamw(0.01)),
    ("adamw_config", lambda: optimizer_from_config(
        {"optimizer": {"type": "AdamW", "params": {"lr": 0.02, "weight_decay": 0.05,
                                                    "betas": [0.8, 0.99], "eps": 1e-6}}}),
     lambda: optax.adamw(0.02, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.05)),
    ("sgd_config_clip", lambda: optimizer_from_config(
        {"optimizer": {"type": "SGD", "params": {"lr": 0.1, "momentum": 0.5}},
         "gradient_clipping": 0.5}),
     lambda: optax.chain(optax.clip_by_global_norm(0.5), optax.sgd(0.1, momentum=0.5))),
]


@pytest.mark.parametrize("name,make_t,make_j", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_updates_match_optax(name, make_t, make_j):
    rng = np.random.default_rng(len(name))
    p0 = [rng.normal(0, 1, (4, 3)).astype(np.float32), rng.normal(0, 1, (5,)).astype(np.float32)]
    grads = [[rng.normal(0, 1, p.shape).astype(np.float32) for p in p0] for _ in range(2)]
    tx = make_j()
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    model = torch.nn.Module()
    model.a = torch.nn.Parameter(torch.from_numpy(p0[0].copy()))
    model.b = torch.nn.Parameter(torch.from_numpy(p0[1].copy()))
    ts = create_train_state(model, make_t())
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        model.a.grad, model.b.grad = (torch.from_numpy(x.copy()) for x in g)
        ts.apply_gradients()
    for got, want in zip((model.a, model.b), jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_global_norm_clip_matches_optax():
    rng = np.random.default_rng(0)
    g = [rng.normal(0, 1, (6, 4)).astype(np.float32), rng.normal(0, 1, (3,)).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        clip = optax.clip_by_global_norm(max_norm)
        want, _ = clip.update([jnp.asarray(x) for x in g], clip.init(None))
        got = [torch.from_numpy(x.copy()) for x in g]
        norm = clip_by_global_norm_(got, max_norm)
        assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["lion", "lamb", "adafactor"])
def test_unported_optimizers_name_the_roadmap(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(name, 0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimizer_from_config({"optimizer": {"type": name, "params": {"lr": 0.1}}})
