"""Ring attention (K7) and Ulysses attention (K8) on gloo ranks
(``tests/torch_ranks.py``) against the JAX package's ``ring_attention`` and
``ulysses_attention`` over a ``seq`` mesh of the same size on the virtual
CPU devices of ``conftest.py``, with the same numpy-seeded inputs.

Each rank holds its run of L / n positions of q, k and v (the port's
functions take shards; JAX's take global arrays under ``shard_map``), so
the ranks' outputs and gradients are concatenated along the sequence
before the comparison.

- causal and not, at n = 2 and 4: float32 outputs within 1e-5 absolute,
  the gradients of q, k and v (of ``sum(out * g)``, g seeded) against
  ``jax.grad`` within 1e-4;
- large logits (q x 8, as ``tests/test_ring_attention.py``'s no-NaN case
  drives them): finite and within the same tolerances;
- Ulysses with heads the axis does not divide raises JAX's
  ``ValueError``, word for word.

The tiles run K6's plain schedule on the CPU; JAX's Ulysses materializes
its scores, the port's takes K6 (ROADMAP.md, Queue 3): within these
tolerances.  Every case of a world runs in one spawn of its ranks.
"""

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

B, L, H, D = 2, 32, 4, 8
CASES = [(impl, causal, big) for impl in ("ring", "ulysses") for causal in (False, True)
         for big in (False, True)]


def _inputs(big: bool):
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))
    return (q * 8 if big else q), k, v, g


# -- the ranks' jobs (no JAX here) -------------------------------------------------


def _attention_job(rank, world):
    from tpuframe_torch.core import initialize
    from tpuframe_torch.ops import ring_attention, ulysses_attention

    rt = initialize({"data": 1, "seq": world}, device="cpu")
    run = L // world
    out = {}
    for impl, causal, big in CASES:
        q, k, v, g = (torch.from_numpy(a[:, rank * run:(rank + 1) * run].copy())
                      for a in _inputs(big))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        fn = ring_attention if impl == "ring" else ulysses_attention
        o = fn(q, k, v, rt.mesh, causal=causal)
        (o * g).sum().backward()
        out[(impl, causal, big)] = (o.detach().numpy(), [t.grad.numpy() for t in (q, k, v)])
    bad = torch.zeros(B, run, 3 * world - 1, D)
    try:
        ulysses_attention(bad, bad, bad, rt.mesh)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


# -- the JAX side -------------------------------------------------------------------


def _jax(world: int) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuframe.core.runtime import MeshSpec
    from tpuframe.ops.ring_attention import ring_attention
    from tpuframe.ops.ulysses import ulysses_attention

    mesh = MeshSpec(data=1, seq=world).build(jax.devices()[:world])
    out = {}
    for impl, causal, big in CASES:
        fn = ring_attention if impl == "ring" else ulysses_attention
        q, k, v, g = (jnp.asarray(a) for a in _inputs(big))

        def both(q, k, v, g, fn=fn, causal=causal):
            def loss(q, k, v):
                return jnp.sum(fn(q, k, v, mesh, causal=causal) * g)

            return fn(q, k, v, mesh, causal=causal), jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

        o, grads = jax.jit(both)(q, k, v, g)
        out[(impl, causal, big)] = (np.asarray(o), [np.asarray(t) for t in grads])
    bad = jnp.zeros((B, L, 3 * world - 1, D))
    with pytest.raises(ValueError) as err:
        ulysses_attention(bad, bad, bad, mesh)
    out["error"] = str(err.value)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {world: (run_ranks(_attention_job, world, tmp_path_factory.mktemp(f"sp{world}"),
                              timeout=300), _jax(world)) for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("impl,causal,big", CASES,
                         ids=[f"{i}-{'causal' if c else 'full'}{'-big' if b else ''}"
                              for i, c, b in CASES])
def test_sequence_parallel_attention_matches_jax(results, world, impl, causal, big):
    ranks, want = results[world]
    got_out = np.concatenate([r[(impl, causal, big)][0] for r in ranks], axis=1)
    want_out, want_grads = want[(impl, causal, big)]
    assert np.isfinite(got_out).all()
    np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=0)
    for i, name in enumerate("qkv"):
        got = np.concatenate([r[(impl, causal, big)][1][i] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want_grads[i], atol=1e-4, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_indivisible_heads_raise_jax_error(results, world):
    ranks, want = results[world]
    for r in ranks:
        assert r["error"] == want["error"]
    assert "divisible" in want["error"]
