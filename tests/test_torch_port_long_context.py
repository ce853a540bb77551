"""The long-context parts of the port's ``TransformerLM`` against the JAX
package's: ``attn_impl="auto"`` at 4,096 tokens (the blockwise path),
``remat=True``, and dropout with its per-step generator.

JAX's ``auto`` asks its kernel ledger first; ``TPUFRAME_KERNEL_LEDGER_DIR``
points at an empty directory here, so it takes its static rule, as the
port always does.

Tolerances, each with its reason (float32 on the CPU):

- Logits within 1e-4 of the largest logit and gradients within 1e-4 of
  each leaf's norm: the products and sums run in another order in XLA and
  ATen, and the blockwise softmax over other blocks (measured below 2e-6).
- The port with and without ``remat``: bit-equal, loss and gradients,
  with and without dropout: the recompute runs the same operations on the
  same tensors and draws the same masks.
- Dropout cannot be held against JAX mask for mask (the two generators
  differ): the share dropped is held within six binomial standard
  deviations of the rate, for the port and for flax's ``nn.Dropout`` alike,
  and what is kept is the input times ``1 / (1 - rate)`` on both sides,
  bit for bit.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuframe_torch.models.transformer as port_transformer
import tpuframe_torch.train.step as port_step
from tpuframe.models.transformer import TransformerLM as JaxLM
from tpuframe_torch.models import Dropout, TransformerLM, from_jax_variables, import_torch_transformer
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.parallel import full_precision
from tpuframe_torch.train import create_train_state, make_train_step
from tpuframe_torch.train.step import step_generator

LONG = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=8, max_len=4096)
SMALL = dict(vocab_size=32, num_layers=2, num_heads=2, head_dim=8, max_len=64)


def _tokens(b, l, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, l + 1)).astype(np.int32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_loss_and_grads(cfg, params, toks, **kw):
    """JAX logits, mean loss and parameter gradients (the JAX tree)."""
    jm = JaxLM(**cfg, **kw)
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])

    def loss(p):
        logits = jm.apply({"params": p}, x)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], -1)), logits

    (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(logits), float(value), _np(grads)


def _port_loss_and_grads(model, toks):
    """The port's logits, mean loss and gradients keyed as the JAX tree."""
    x, y = torch.from_numpy(toks[:, :-1]).long(), torch.from_numpy(toks[:, 1:]).long()
    logits = model(x)
    logp = torch.log_softmax(logits, -1)
    value = -torch.gather(logp, -1, y[..., None]).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(value, [p for _, p in model.named_parameters()])
    tree = import_torch_transformer(dict(zip(names, grads)))["params"]
    return logits.detach().numpy(), float(value.detach()), tree


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads_close(got, want, rtol=1e-4):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert np.linalg.norm(got[k] - want[k]) <= rtol * np.linalg.norm(want[k]) + 1e-12, k


def test_auto_at_4096_tokens_runs_blockwise_and_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUFRAME_KERNEL_LEDGER_DIR", str(tmp_path))
    toks = _tokens(1, 4096, LONG["vocab_size"], seed=1)
    jm = JaxLM(**LONG, attn_impl="auto")
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(toks[:, :8]))["params"])
    want_logits, want_loss, want_grads = _jax_loss_and_grads(LONG, params, toks, attn_impl="auto")

    calls = []
    real = port_transformer.blockwise_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(port_transformer, "blockwise_attention", spy)
    tm = TransformerLM(**LONG, device="cpu")
    tm.load_state_dict(from_jax_variables({"params": params}))
    logits, loss, grads = _port_loss_and_grads(tm, toks)
    assert calls == [(1, 4096, 2, 8)]
    assert np.abs(logits - want_logits).max() <= 1e-4 * np.abs(want_logits).max()
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_grads_close(grads, want_grads)

    calls.clear()  # one token fewer: full attention, as in JAX
    tm(torch.from_numpy(toks[:, :4095]).long())
    assert calls == []


@pytest.mark.parametrize("attn_impl", ["full", "blockwise"])
def test_remat_gradients_are_bit_equal_and_match_jax_remat(attn_impl):
    toks = _tokens(2, 32, SMALL["vocab_size"], seed=2)
    jm = JaxLM(**SMALL, attn_impl=attn_impl, remat=True)
    params = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(toks[:, :-1]))["params"])
    _, want_loss, want_grads = _jax_loss_and_grads(SMALL, params, toks, attn_impl=attn_impl,
                                                   remat=True)
    out = {}
    for remat in (False, True):
        tm = TransformerLM(**SMALL, attn_impl=attn_impl, remat=remat, device="cpu")
        tm.load_state_dict(from_jax_variables({"params": params}))
        out[remat] = _port_loss_and_grads(tm, toks)
    assert out[True][1] == out[False][1]
    flat_r, flat_n = _flat(out[True][2]), _flat(out[False][2])
    assert all(np.array_equal(flat_r[k], flat_n[k]) for k in flat_n)
    assert out[True][1] == pytest.approx(want_loss, rel=1e-5)
    _assert_grads_close(out[True][2], want_grads)


def test_dropout_drops_its_rate_and_scales_what_it_keeps_as_flax():
    rate, n = 0.1, 400_000
    bound = 6 * np.sqrt(rate * (1 - rate) / n)
    x = np.random.default_rng(3).uniform(0.5, 2.0, n).astype(np.float32)
    drop = Dropout(rate).train()
    got = drop(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(flax_nn.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)}))
    for out in (got, want):
        kept = out != 0
        assert abs((1 - kept.mean()) - rate) <= bound
        np.testing.assert_array_equal(out[kept], (x / np.float32(1 - rate))[kept])
    assert torch.equal(drop.eval()(torch.from_numpy(x), None), torch.from_numpy(x))


def test_eval_with_dropout_equals_no_dropout_and_train_without_generator_raises():
    toks = torch.from_numpy(_tokens(2, 32, SMALL["vocab_size"])[:, :-1]).long()
    plain = TransformerLM(**SMALL, device="cpu", seed=4)
    dropped = TransformerLM(**SMALL, dropout=0.1, device="cpu", seed=4)
    assert torch.equal(plain(toks), dropped(toks))
    with pytest.raises(ValueError, match="generator"):
        dropped.train()(toks)


def _step_once(cfg, seed=0, step=0, **kw):
    """Loss and parameters after one f32 train step of a fresh state."""
    toks = torch.from_numpy(_tokens(2, 32, cfg["vocab_size"], seed=5)).long()
    model = TransformerLM(**cfg, device="cpu", seed=6, **kw)
    state = create_train_state(model, fused_adamw(1e-2), seed=seed)
    state.step = step
    state, m = make_train_step(full_precision())(state, {"image": toks[:, :-1],
                                                         "label": toks[:, 1:]})
    assert model.dropout_generator is None  # set for the step only
    return float(m["loss_sum"]), [p.detach().clone() for p in model.parameters()]


def test_dropout_masks_follow_the_step_seed_and_rank(monkeypatch):
    base_loss, base = _step_once(SMALL, dropout=0.1)
    again_loss, again = _step_once(SMALL, dropout=0.1)
    assert base_loss == again_loss and all(torch.equal(a, b) for a, b in zip(base, again))
    assert _step_once(SMALL, step=1, dropout=0.1)[0] != base_loss
    assert _step_once(SMALL, seed=1, dropout=0.1)[0] != base_loss
    assert _step_once(SMALL)[0] != base_loss  # dropout 0
    monkeypatch.setattr(port_step, "_wired", lambda: True)
    monkeypatch.setattr(port_step.dist, "get_rank", lambda: 1)
    assert _step_once(SMALL, dropout=0.1)[0] != base_loss
    # the microbatches of one step draw from distinct streams
    state = create_train_state(TransformerLM(**SMALL, device="cpu"), fused_adamw(1e-2))
    draws = [torch.rand(64, generator=step_generator(state, torch.device("cpu"), "dropout", i))
             for i in (None, 0, 1)]
    assert not any(torch.equal(draws[i], draws[j]) for i, j in ((0, 1), (0, 2), (1, 2)))


def test_remat_reproduces_the_dropout_masks():
    loss, params = _step_once(SMALL, dropout=0.1)
    remat_loss, remat_params = _step_once(SMALL, dropout=0.1, remat=True)
    assert remat_loss == loss
    assert all(torch.equal(a, b) for a, b in zip(params, remat_params))
