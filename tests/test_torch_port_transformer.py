"""The port's ``TransformerLM`` (``models/transformer.py``) and full
attention (``ops/ring_attention.attention_reference``) against the JAX
package's, on the JAX model's own weights carried across with
``from_jax_variables``.

Tolerances, each with its reason:

- float32 logits within 1e-4 of the largest logit (relative): the products
  and the row sums run in another order in XLA and ATen (measured 5e-7).
- bf16 logits within 3e-2 of the largest logit: both sides round every
  product, LayerNorm output, softmax and residual add to bf16, but XLA on
  the CPU and ATen keep float32 inside other ops, so values near a rounding
  boundary land one bf16 step apart and carry through two blocks (measured
  9e-3, about two bf16 steps of the largest logit).
- Attention in float32 within 1e-6 absolute (O(1) values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuframe.models.transformer import TransformerLM as JaxLM
from tpuframe.ops.ring_attention import attention_reference as jax_attention
from tpuframe_torch.models import (
    TransformerLM,
    export_torch_transformer,
    from_jax_variables,
    import_torch_transformer,
)
from tpuframe_torch.ops import attention_reference
from tpuframe_torch.parallel import align_model_dtype, bf16_compute

SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=16, max_len=16)


def _tokens(b=2, l=16, seed=0):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (b, l)).astype(np.int32)


def _jax_variables(dtype=jnp.float32, seed=0):
    model = JaxLM(**SMALL, attn_impl="full", dtype=dtype)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(_tokens()))
    return model, jax.tree.map(lambda a: np.asarray(a, np.float32), dict(variables))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax_on_jax_weights(dtype):
    jm, variables = _jax_variables(getattr(jnp, dtype))
    tokens = _tokens(seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(tokens)), np.float32)
    tm = TransformerLM(**SMALL, dtype=getattr(torch, dtype), device="cpu")
    tm.load_state_dict(from_jax_variables(variables))
    # the bf16 step casts the parameters as the JAX policy does
    params = {k: p.detach().to(getattr(torch, dtype)) for k, p in tm.named_parameters()}
    got = torch.func.functional_call(tm, params, (torch.from_numpy(tokens),))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 128)
    rel = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
    assert rel <= (1e-4 if dtype == "float32" else 3e-2), rel


def test_tree_round_trip_and_parameter_names():
    _, variables = _jax_variables()
    state = from_jax_variables(variables)
    tm = TransformerLM(**SMALL, device="cpu")
    assert set(state) == set(tm.state_dict())
    assert len(state) == 2 + 12 * SMALL["num_layers"] + 3
    assert tuple(state["block1.attn.query.weight"].shape) == (64, 64)
    assert tuple(state["lm_head.weight"].shape) == (128, 64)
    back = import_torch_transformer(state)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path({"params": variables["params"]}):
        np.testing.assert_array_equal(flat_a[path], leaf)
    assert set(export_torch_transformer(variables)) == set(state)


def test_init_draws_flax_distributions():
    """Same families and scales as flax's initializers: Dense kernels
    truncated at two standard deviations with variance 1/fan_in, Embed
    tables N(0, 1/features), zero biases, unit LayerNorm."""
    cfg = dict(vocab_size=512, num_layers=1, num_heads=4, head_dim=32, max_len=64)
    tm = TransformerLM(**cfg, device="cpu", seed=3)
    jv = JaxLM(**cfg, attn_impl="full").init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    for name, jleaf in (("block0.mlp_in.weight", jv["params"]["block0"]["mlp_in"]["kernel"]),
                        ("lm_head.weight", jv["params"]["lm_head"]["kernel"]),
                        ("embed.weight", jv["params"]["embed"]["embedding"])):
        got = dict(tm.named_parameters())[name].detach().numpy()
        want = np.asarray(jleaf)
        assert got.std() == pytest.approx(want.std(), rel=0.05), name
        if name != "embed.weight":  # truncated: both cut at the same bound
            bound = 2 * np.sqrt(1.0 / got.shape[1]) / 0.87962566103423978
            assert np.abs(got).max() <= bound * (1 + 1e-6) and np.abs(want).max() <= bound * (1 + 1e-6)
    assert float(tm.block0.mlp_in.bias.detach().abs().max()) == 0.0
    assert float(tm.ln_f.scale.detach().min()) == float(tm.ln_f.scale.detach().max()) == 1.0
    again = TransformerLM(**cfg, device="cpu", seed=3)
    torch.testing.assert_close(again.lm_head.weight, tm.lm_head.weight, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax(causal):
    rng = np.random.default_rng(int(causal))
    q, k, v = (rng.standard_normal((2, 7, 3, 8)).astype(np.float32) for _ in range(3))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_compute_dtype_follows_the_policy():
    tm = TransformerLM(**SMALL, device="cpu")
    align_model_dtype(tm, bf16_compute())
    assert tm.compute_dtype == torch.bfloat16
    assert tm.block0.ln1.dtype == torch.bfloat16
    assert tm.block1.attn.query.compute_dtype == tm.embed.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    out = tm(torch.from_numpy(_tokens()).long())
    assert out.dtype == torch.float32


@pytest.mark.parametrize("kw,match", [
    (dict(attn_impl="blockwise"), "long-context"),
    (dict(attn_impl="ring"), "sequence-parallel"),
    (dict(attn_impl="ulysses"), "sequence-parallel"),
    (dict(moe_experts=4), "MoE"),
    (dict(remat=True), "remat"),
    (dict(dropout=0.1), "dropout"),
])
def test_unported_options_name_their_slice(kw, match):
    """``ring``, ``ulysses`` and MoE still raise, naming their slice.  The
    long-context slice's options (blockwise attention, ``remat``, dropout)
    are ported: they build, and a train-mode forward and backward runs (the
    dropout one with a generator)."""
    if match in ("sequence-parallel", "MoE"):
        with pytest.raises(NotImplementedError, match=match):
            TransformerLM(**SMALL, device="cpu", **kw)
        return
    tm = TransformerLM(**SMALL, device="cpu", **kw).train()
    tm.dropout_generator = torch.Generator().manual_seed(0)
    logits = tm(torch.from_numpy(_tokens()).long())
    logits.sum().backward()
    assert logits.shape == (2, 16, 128)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in tm.parameters())


def test_auto_attention_refuses_long_context_and_unknown_impls(monkeypatch):
    """``auto`` takes the blockwise path at 4,096 tokens (JAX's static rule,
    ``_BLOCKWISE_AUTO_LEN``) and full attention below; an unknown impl
    raises."""
    import tpuframe_torch.models.transformer as port_transformer

    calls = []
    real = port_transformer.blockwise_attention
    monkeypatch.setattr(port_transformer, "blockwise_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    tm = TransformerLM(vocab_size=8, num_layers=1, num_heads=1, head_dim=4, max_len=4096,
                       device="cpu")
    assert port_transformer._BLOCKWISE_AUTO_LEN == 4096
    out = tm(torch.zeros(1, 4096, dtype=torch.long))
    assert calls == [(1, 4096, 1, 4)] and bool(torch.isfinite(out).all())
    tm(torch.zeros(1, 4095, dtype=torch.long))
    assert len(calls) == 1
    with pytest.raises(ValueError, match="unknown attn_impl"):
        TransformerLM(**SMALL, device="cpu", attn_impl="flash")
