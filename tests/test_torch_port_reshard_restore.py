"""Reshard-on-restore (``Checkpointer.restore``'s topology boundary), the
cases of ``tests/test_elastic.py::TestReshardRestore`` on the port.

- A ZeRO-1 ``MnistNet(num_classes=4)`` state saved on four gloo ranks
  (after one Adam step, so the moments are not zeros) restores at worlds 2
  (two spawned ranks) and 1 (this process) bit-exact: every parameter,
  buffer, optimizer leaf, counter and the generator's state, and the same
  eval logits, bits and all; one ``fault/reshard`` event (and one
  ``fault/reshards`` tick) with both worlds, emitted before the read's
  ``ckpt/restore`` span.
- A restore at the same topology emits no ``fault/reshard``.
- Another model (``num_classes=7``) refuses with ``ValueError`` before any
  read, event or span; at the same topology DCP's failure, a
  ``BaseException`` (``CheckpointException``), reaches the caller as an
  ``Exception``.
"""

import warnings

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks
from tpuframe_torch.ckpt import Checkpointer
from tpuframe_torch.core import MeshSpec, initialize
from tpuframe_torch.models import MnistNet
from tpuframe_torch.parallel import ParallelPlan, full_precision
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step

X_EVAL = np.random.default_rng(0).random((4, 28, 28, 1)).astype(np.float32)


def _batch(index: int, count: int) -> dict:
    rng = np.random.default_rng(1)
    x = rng.random((8, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 4, 8).astype(np.int64)
    n = 8 // count
    return {"image": torch.from_numpy(x[index * n:(index + 1) * n]),
            "label": torch.from_numpy(y[index * n:(index + 1) * n])}


def _state(plan, seed=0, classes=4):
    """A ZeRO state over ``plan`` after one Adam step (every process of the
    plan calls this)."""
    from tpuframe_torch.core.runtime import process_count, process_index

    state = create_train_state(MnistNet(num_classes=classes, device="cpu", seed=seed),
                               make_optimizer("adam", 1e-3), plan=plan, seed=seed)
    step = make_train_step(full_precision(), plan=plan)
    state, _ = step(state, _batch(process_index(), process_count()))
    return state


def _whole(state) -> dict:
    """The state as a checkpoint holds it, flattened to numpy copies (the
    generator's state as bytes)."""
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


def _logits(state) -> np.ndarray:
    model = state.model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(X_EVAL)).numpy()


_MARKS = iter(range(1, 1 << 30))


def _mark() -> str:
    """A marker event (the telemetry keeps a bounded window of recent
    events, so a count taken before would not do)."""
    token = f"reshard-{next(_MARKS)}"
    get_telemetry().event("test/mark", token=token)
    return token


def _events_since(token: str, name: str | None = None) -> list[dict]:
    ev = get_telemetry().recent_events(10**6)
    idx = max(i for i, e in enumerate(ev)
              if e.get("name") == "test/mark" and e.get("token") == token)
    return [e for e in ev[idx + 1:] if name is None or e.get("name") == name]


def _restore(directory, plan, seed=9, classes=4) -> dict:
    """Restore into a fresh state (another seed: every leaf must be
    overwritten); its whole state, logits and the events of the restore."""
    template = _state(plan, seed=seed, classes=classes)
    mark = _mark()
    with Checkpointer(directory) as ck:
        restored, _ = ck.restore(template, plan=plan)
    return {"whole": _whole(restored), "logits": _logits(restored),
            "reshard": _events_since(mark, "fault/reshard"),
            "names": [e.get("name") for e in _events_since(mark)]}


# -- the ranks' jobs (no JAX here) -------------------------------------------------


def _save_job(rank, world, directory):
    rt = initialize(device="cpu")
    plan4 = ParallelPlan(mesh=rt.mesh, zero_stage=1, min_shard_elems=1)
    state = _state(plan4)
    whole, logits = _whole(state), _logits(state)
    with Checkpointer(directory) as ck:
        ck.save(state, step=7, plan=plan4)
    same = _restore(directory, plan4, seed=1)
    return {"whole": whole, "logits": logits, "same": same["reshard"],
            "signature": plan4.signature()}


def _restore_job(rank, world, directory):
    rt = initialize(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = ParallelPlan(mesh=MeshSpec(data=4).build(4), zero_stage=1,
                            min_shard_elems=1).rebind(rt.mesh)
    return _restore(directory, plan)


# -- the tests ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("reshard") / "ck")
    four = run_ranks(_restore_or_save, 4, tmp_path_factory.mktemp("rs4"), "save", directory)
    two = run_ranks(_restore_or_save, 2, tmp_path_factory.mktemp("rs2"), "restore", directory)
    return {"dir": directory, "four": four, "two": two}


def _restore_or_save(rank, world, what, directory):
    return (_save_job if what == "save" else _restore_job)(rank, world, directory)


def _assert_whole_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("target", [2, 1])
def test_save_dp4_restore_smaller_bit_exact(saved, target):
    ref = saved["four"][0]
    for r in saved["four"][1:]:
        _assert_whole_equal(r["whole"], ref["whole"])
    if target == 2:
        outs = saved["two"]
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the data axis collapses to 1
            plan = ParallelPlan(mesh=MeshSpec(data=4).build(4), zero_stage=1,
                                min_shard_elems=1).rebind(MeshSpec(data=1).build(1))
        reshards = get_telemetry().registry.counter("fault/reshards").value
        outs = [_restore(saved["dir"], plan)]
        assert get_telemetry().registry.counter("fault/reshards").value == reshards + 1
    for out in outs:
        _assert_whole_equal(out["whole"], ref["whole"])
        np.testing.assert_array_equal(out["logits"], ref["logits"])
        assert len(out["reshard"]) == 1
        ev = out["reshard"][0]
        assert ev["from_world"] == 4 and ev["to_world"] == target
        assert ev["from_axes"]["data"] == 4 and ev["from_plan"] == ref["signature"]
        assert ev["leaves"] == len(ref["whole"]) - 1  # every tensor leaf; "step" is an int
        names = out["names"]
        assert names.index("fault/reshard") < names.index("ckpt/restore")


def test_same_topology_restore_emits_no_reshard(saved):
    for r in saved["four"]:
        assert r["same"] == []
    # world 1 saved, world 1 restored
    plan = ParallelPlan(mesh=MeshSpec(data=1).build(1))
    d = str(saved["dir"]) + "_w1"
    with Checkpointer(d) as ck:
        ck.save(_state(plan), step=1, plan=plan)
    assert _restore(d, plan, seed=1)["reshard"] == []


def test_logical_mismatch_raises_before_read(saved, tmp_path):
    plan = ParallelPlan(mesh=MeshSpec(data=1).build(1))
    other = _state(plan, classes=7)  # a different head width
    mark = _mark()
    with Checkpointer(saved["dir"]) as ck:
        with pytest.raises(ValueError, match="different model"):
            ck.restore(other, plan=plan)
    assert _events_since(mark, "fault/reshard") == []
    assert _events_since(mark, "ckpt/restore") == []
    # at the same topology the check does not run and DCP's read fails: its
    # CheckpointException derives from BaseException alone, and reaches the
    # caller as an Exception
    d = str(tmp_path / "w1")
    with Checkpointer(d) as ck:
        ck.save(_state(plan), step=1, plan=plan)
        with pytest.raises(Exception) as info:
            ck.restore(other, plan=plan)
    assert isinstance(info.value, Exception)
