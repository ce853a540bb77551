"""The LM training path of the port against the JAX package's: the
``TransformerLM`` train step with ``fused_adamw`` as ``tx``, and a small
``Trainer(tx=...).fit()``, on the JAX model's own initial weights and the
same token batches.

The tokens come from a copy of example 06's ``NextTokenDataset``
(``examples/06_lm_sequence_parallel.py``): the JAX package has no token
dataset, and the port's package has none either.

Tolerances, each with its reason (float32 on the CPU throughout):

- Losses within 1e-5 relative: the products and sums run in another order
  in XLA and ATen (measured 9e-8).
- Parameters after two AdamW steps (lr 1e-3): the difference within 1e-4
  of the norm of the update, and every element within 1e-4 absolute (a
  tenth of lr).  Adam's first updates are about ``lr * g / (|g| + eps)``,
  so an element whose gradient is small differs by up to lr times the
  relative rounding difference of its gradient (measured 8.9e-6 of the
  update norm, and 4.5e-6 at one element of ``mlp_in``).
- ``Trainer.fit`` over two epochs: per-epoch train and eval loss within
  1e-4 relative (eight AdamW steps of order-of-summation differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuframe.data import DataLoader as JaxDataLoader
from tpuframe.models.transformer import TransformerLM as JaxLM
from tpuframe.ops.fused_adamw import fused_adamw as jax_fused_adamw
from tpuframe.parallel.precision import full_precision as jax_f32
from tpuframe.train.state import create_train_state as jax_create_train_state
from tpuframe.train.step import make_train_step as jax_make_train_step
from tpuframe.train.trainer import Trainer as JaxTrainer
from tpuframe_torch.data import DataLoader
from tpuframe_torch.models import TransformerLM, from_jax_variables, import_torch_transformer
from tpuframe_torch.ops import FusedAdamW, fused_adamw
from tpuframe_torch.parallel import full_precision
from tpuframe_torch.train import Trainer, create_train_state, make_train_step

SMALL = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=16, max_len=16)
HP = dict(weight_decay=1e-4)


class SyntheticTokenDataset:
    """Example 06's deterministic next-token streams: token t+1 = (start +
    stride * t) mod vocab, keyed by index."""

    def __init__(self, n: int, seq_len: int, vocab: int, seed: int = 0):
        self.n, self.seq_len, self.vocab, self.seed = n, seq_len, vocab, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 100_003 + i)
        start = int(rng.integers(0, self.vocab))
        stride = int(rng.integers(1, 7))
        toks = (start + stride * np.arange(self.seq_len + 1)) % self.vocab
        return toks.astype(np.int32)


class NextTokenDataset(SyntheticTokenDataset):
    """(input, label) next-token pairs."""

    def __getitem__(self, i: int):
        toks = super().__getitem__(i)
        return toks[:-1], toks[1:]


def _batch(n=8, seed=0):
    ds = NextTokenDataset(n, SMALL["max_len"], SMALL["vocab_size"], seed=seed)
    x, y = zip(*(ds[i] for i in range(n)))
    return {"image": np.stack(x), "label": np.stack(y)}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def test_two_train_steps_with_fused_adamw_match_jax():
    jm = JaxLM(**SMALL, attn_impl="full")
    x0 = jnp.asarray(_batch()["image"])
    tx = jax_fused_adamw(1e-3, **HP)
    js = jax_create_train_state(jm, jax.random.PRNGKey(0), x0, tx, init_kwargs={"train": False})
    start = _flat({"params": _np(js.params)})
    tm = TransformerLM(**SMALL, device="cpu")
    tm.load_state_dict(from_jax_variables({"params": _np(js.params)}))
    ts = create_train_state(tm, fused_adamw(1e-3, **HP))
    assert isinstance(ts.optimizer, FusedAdamW)
    jstep = jax_make_train_step(jax_f32(), donate=False)
    tstep = make_train_step(full_precision())
    for seed in (1, 2):
        b = _batch(seed=seed)
        js, jmet = jstep(js, b)
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        assert float(tmet["count"]) == float(jmet["count"]) == 8 * SMALL["max_len"]
        assert float(tmet["loss_sum"]) == pytest.approx(float(jmet["loss_sum"]), rel=1e-5)
    assert ts.step == int(js.step) == 2 and int(ts.updates) == 2
    got = _flat(import_torch_transformer(ts.model.state_dict()))
    want = _flat({"params": _np(js.params)})
    assert got.keys() == want.keys()
    diff = np.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in want))
    update = np.sqrt(sum(((want[k] - start[k]) ** 2).sum() for k in want))
    assert diff <= 1e-4 * update, (diff, update)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
    counts = {int(st["count"]) for st in ts.optimizer.state.values()}
    assert counts == {int(js.opt_state.count)} == {2}


def test_trainer_fit_with_tx_matches_the_jax_trainer():
    def loaders(dl_cls, **extra):
        ds = lambda n, seed: NextTokenDataset(n, SMALL["max_len"], SMALL["vocab_size"], seed)  # noqa: E731
        train = dl_cls(ds(32, 1), 8, shuffle=True, seed=2, **extra)
        evl = dl_cls(ds(12, 7), 8, drop_last=False, **extra)  # a ragged last batch
        return train, evl

    common = dict(max_duration="2ep", health=False, seed=0)
    jtrain, jeval = loaders(JaxDataLoader, process_index=0, process_count=1)
    jtr = JaxTrainer(JaxLM(**SMALL, attn_impl="full"), tx=jax_fused_adamw(3e-3, **HP),
                     train_dataloader=jtrain, eval_dataloader=jeval, precompile=False, **common)
    params = _np(jtr.init_state().params)
    want = jtr.fit().history

    model = TransformerLM(**SMALL, device="cpu")
    model.load_state_dict(from_jax_variables({"params": params}))
    train, evl = loaders(DataLoader)
    trainer = Trainer(model, tx=fused_adamw(3e-3, **HP), train_dataloader=train,
                      eval_dataloader=evl, **common)
    got = trainer.fit().history
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train_loss", "eval_loss", "eval_accuracy"):
            assert g[key] == pytest.approx(w[key], rel=1e-4), (key, g[key], w[key])
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    assert trainer.state.step == 8 and isinstance(trainer.state.optimizer, FusedAdamW)


def test_tx_refuses_grad_clip_and_other_objects():
    model = TransformerLM(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="grad_clip"):
        Trainer(model, tx=fused_adamw(1e-3), grad_clip=1.0)
    with pytest.raises(TypeError, match="OptimizerSpec"):
        Trainer(model, tx=object())
