"""Checkpoints across plan changes, the cases of
``tests/test_plan_change_restore.py`` on the port: a ``compose(tp=4)``
``PipelinedTransformerLM`` state saved on four gloo ranks restores
bit-exact under ``compose(tp=2, pp=2)`` (the same four ranks: the
embedding re-split 4 -> 2 ways over ``model``, the blocks from whole to
split over ``pipe``) and under plain data parallelism (world 1, this
process), with one ``fault/reshard`` event carrying both plan signatures;
the same plan restores with no event; another vocabulary refuses before
any read.  Each state takes one Adam step before it is saved or restored
into, so the optimizer's moments are there and not zeros.
"""

import warnings

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.core import initialize
from tpuframe_torch.parallel import PipelinedTransformerLM, compose, full_precision
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step


def _lm(vocab: int = 64, seed: int = 0):
    # num_layers=2 divides the pipe=2 target; embed (64 x 16) and lm_head
    # (64 x 16) split by tp=4 and by tp=2, so every plan here splits them
    # differently
    return PipelinedTransformerLM(vocab_size=vocab, num_layers=2, num_heads=2, head_dim=8,
                                  max_len=32, n_microbatches=2, device="cpu", seed=seed)


def _state(plan, vocab: int = 64, seed: int = 0):
    state = create_train_state(_lm(vocab, seed), make_optimizer("adam", 1e-3), plan=plan)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, (4, 16)))
    step = make_train_step(full_precision(), plan=plan)
    state, _ = step(state, {"input": toks, "label": torch.roll(toks, -1, 1)})
    return state


def _whole(state) -> dict:
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif torch.is_tensor(v):
                out[f"{prefix}{k}"] = v.detach().cpu().numpy().copy()
            else:
                out[f"{prefix}{k}"] = v

    walk(state.state_dict(), "")
    return out


_MARKS = iter(range(1, 1 << 30))


def _mark() -> str:
    """A marker event (the telemetry keeps a bounded window of recent
    events, so a count taken before would not do)."""
    token = f"plan-change-{next(_MARKS)}"
    get_telemetry().event("test/mark", token=token)
    return token


def _events_since(token: str) -> list[dict]:
    ev = get_telemetry().recent_events(10**6)
    idx = max(i for i, e in enumerate(ev)
              if e.get("name") == "test/mark" and e.get("token") == token)
    return ev[idx + 1:]


def _restore(directory, plan, vocab: int = 64) -> dict:
    template = _state(plan, vocab, seed=9)
    mark = _mark()
    with Checkpointer(directory) as ck:
        restored, _ = ck.restore(template, plan=plan)
    events = _events_since(mark)
    return {"whole": _whole(restored), "signature": plan.signature(),
            "reshard": [e for e in events if e.get("name") == "fault/reshard"],
            "layout": dict(getattr(restored.model, "tp_layout", None) or {})}


# -- the ranks' job (no JAX here) ----------------------------------------------------


def _job(rank, world, directory):
    initialize(device="cpu")
    plan4 = compose(tp=4)
    state = _state(plan4)
    whole = _whole(state)
    layout = dict(state.model.tp_layout)
    with Checkpointer(directory) as ck:
        ck.save(state, step=5, plan=plan4)
    moved = _restore(directory, compose(tp=2, pp=2))
    same_dir = directory + "_same"
    plan = compose(tp=2, pp=2)
    with Checkpointer(same_dir) as ck:
        ck.save(_state(plan), step=1, plan=plan)
    same = _restore(same_dir, plan)
    return {"whole": whole, "layout": layout, "signature": plan4.signature(), "moved": moved,
            "same": same["reshard"]}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("plan_change") / "ck")
    return {"dir": directory,
            "ranks": run_ranks(_job, 4, tmp_path_factory.mktemp("pc4"), directory,
                               timeout=300)}


def _assert_whole_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("target", ["tp2xpp2", "dp_only"])
def test_tp4_checkpoint_restores_across_plan_change(saved, target):
    ref = saved["ranks"][0]
    assert ref["layout"]["embed_head.embed.weight"] == [(0, "model")]
    assert "blocks.attn.query.weight" not in ref["layout"]  # pp=1: whole blocks
    if target == "tp2xpp2":
        outs = [r["moved"] for r in saved["ranks"]]
        want_layout = {"embed_head.embed.weight": [(0, "model")],
                       "blocks.attn.query.weight": [(0, "pipe")]}
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs = [_restore(saved["dir"], compose())]
        want_layout = {}
    for out in outs:
        _assert_whole_equal(out["whole"], ref["whole"])
        for name, split in want_layout.items():
            assert out["layout"][name] == split
        assert len(out["reshard"]) == 1
        ev = out["reshard"][0]
        assert ev["from_plan"] == ref["signature"] and ev["to_plan"] == out["signature"]
        assert ev["from_axes"]["model"] == 4


def test_same_composed_plan_restore_emits_no_reshard(saved):
    for r in saved["ranks"]:
        assert r["same"] == []


def test_logical_mismatch_refuses_before_reading_data(saved):
    target = compose()
    other = _state(target, vocab=48)  # another embed/head shape
    mark = _mark()
    with Checkpointer(saved["dir"]) as ck:
        with pytest.raises(ValueError, match="checkpoint cannot reshard onto the target topology"):
            ck.restore(other, plan=target)
    names = [e.get("name") for e in _events_since(mark)]
    assert "fault/reshard" not in names and "ckpt/restore" not in names
