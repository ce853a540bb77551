"""The port's checkpoints (``tpuframe_torch.ckpt``) against the JAX package's.

- Round trips on the CPU, bit for bit: a small ResNet18 with SGD momentum,
  a 2-layer ``TransformerLM`` with ``fused_adamw`` (int32 counts, float32
  moments), and a state with compressed-wire residuals; parameters,
  buffers, optimizer state, ``step``, ``updates``, the generator's state
  and the health tensors, in place and with their dtypes.
- The on-disk layout is the JAX package's: one tree written by the port,
  with committed steps, a torn step, a step stamped unhealthy and one
  without a stamp, read by each stdlib reader of both packages
  (``tpuframe.ckpt.meta`` and ``tpuframe_torch.ckpt.meta``), with equal
  results; quarantine and rollback run on copies of the tree.
- Retention and best tracking, ``save_pytree``/``load_pytree`` and
  ``maybe_restore``, as ``tests/test_ckpt.py`` and ``tests/test_fault.py``
  check the JAX package's.
- A write that fails once with ``OSError`` is retried, and counted.
- ``_fold_comms`` folds residuals across world sizes as JAX's does, bit
  for bit on the same numpy arrays.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import tpuframe.ckpt.meta as jax_meta
import tpuframe_torch.ckpt.checkpoint as port_checkpoint
import tpuframe_torch.ckpt.meta as port_meta
from tpuframe.ckpt.checkpoint import _fold_comms as jax_fold_comms
from tpuframe.track.telemetry import get_telemetry as jax_telemetry
from tpuframe_torch.ckpt import (
    Checkpointer,
    best_checkpoint_path,
    latest_step,
    load_pytree,
    save_pytree,
)
from tpuframe_torch.core import current_runtime
from tpuframe_torch.models import ResNet18, TransformerLM
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.parallel import CommsConfig, ParallelPlan, init_comms_state
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step
from tpuframe_torch.fault.health import HealthPolicy


def _resnet_state(seed):
    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device="cpu", seed=seed)
    return create_train_state(model, make_optimizer("sgd", 0.1), seed=seed)


def _lm_state(seed):
    model = TransformerLM(vocab_size=128, num_layers=2, num_heads=4, head_dim=16, max_len=16,
                          device="cpu", seed=seed)
    return create_train_state(model, fused_adamw(3e-3, weight_decay=1e-4), seed=seed)


def _comms_state(seed):
    state = _resnet_state(seed)
    plan = ParallelPlan(mesh=current_runtime(device="cpu").mesh)
    state.comms = init_comms_state(dict(state.model.named_parameters()), plan,
                                   CommsConfig("int8"))
    return state


def _image_batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 10, (4,)))}


def _token_batch(seed):
    t = torch.from_numpy(np.random.default_rng(seed).integers(0, 128, (4, 17)))
    return {"image": t[:, :-1], "label": t[:, 1:]}


STATES = {
    "resnet18_sgd_momentum": (_resnet_state, _image_batch),
    "lm_fused_adamw": (_lm_state, _token_batch),
    "resnet18_with_comms": (_comms_state, _image_batch),
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", sorted(STATES))
def test_round_trip_is_bit_exact_in_place(tmp_path, name):
    make, batch = STATES[name]
    state = make(0)
    step = make_train_step(health=HealthPolicy())
    for i in range(2):
        state, _ = step(state, batch(i))
    if state.comms:
        gen = torch.Generator().manual_seed(3)
        for v in state.comms.values():
            v.copy_(torch.randn(v.shape, generator=gen))
    state.generator.manual_seed(1234)  # the fresh state below seeds 7
    want = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in _flat(state.state_dict())}
    with Checkpointer(tmp_path / "ck") as ck:
        path = ck.save(state, metrics={"loss": 1.0}, meta={"epoch": 1})
        assert path == str(tmp_path / "ck" / str(state.step))
        fresh = make(7)  # other weights, a zero optimizer state, another generator
        live = {k: v.data_ptr() for k, v in _flat(fresh.state_dict()) if torch.is_tensor(v)
                and k != "rng"}
        restored, meta = ck.restore(fresh)
    assert restored is fresh and meta == {"epoch": 1}
    got = dict(_flat(restored.state_dict()))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if torch.is_tensor(w):
            assert g.dtype == w.dtype and g.device == w.device, k
            assert torch.equal(g, w), k
            if k != "rng":
                assert g.data_ptr() == live[k], f"{k} was not restored in place"
        else:
            assert g == w, k
    assert restored.step == 2 and int(restored.updates) == 2
    if name == "lm_fused_adamw":
        counts = [s["count"] for s in restored.optimizer.state.values()]
        assert all(c.dtype == torch.int32 and int(c) == 2 for c in counts)
    manifest = jax_meta.read_manifest(tmp_path / "ck")
    if name == "resnet18_with_comms":
        assert manifest["leaves"]["comms/flat"]["shape"][0] == 1
    assert manifest["version"] == 1 and manifest["world_size"] == 1


def test_async_save_writes_the_state_of_the_call(tmp_path):
    """The state is copied before ``save`` returns: a step taken while the
    write runs does not reach the checkpoint, and the commit waits for it."""
    state = _resnet_state(0)
    step = make_train_step()
    state, _ = step(state, _image_batch(0))
    want = [v.clone() for v in state.model.state_dict().values()]
    with Checkpointer(tmp_path / "ck", async_save=True) as ck:
        ck.save(state)
        state, _ = step(state, _image_batch(1))
        ck.wait()
        assert ck.all_steps() == [1]
        restored, _ = ck.restore(_resnet_state(3))
    assert all(torch.equal(a, b) for a, b in zip(restored.model.state_dict().values(), want))


# -- the on-disk layout, read by both packages ------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Steps 1 (healthy stamp), 2 (no stamp), 3 (healthy), 4 (torn: its
    marker removed), 5 (stamped unhealthy), all written by the port."""
    d = tmp_path_factory.mktemp("layout") / "ck"
    state = {"w": torch.arange(4, dtype=torch.float32)}
    stamp = lambda ok, s: {"healthy": ok, "step": s, "loss_ewma": 1.0,  # noqa: E731
                           "grad_norm": 0.5, "bad_steps": 0 if ok else 3,
                           "last_bad_step": -1 if ok else s, "window": 16}
    with Checkpointer(d, max_to_keep=None) as ck:
        for s, health in ((1, stamp(True, 1)), (2, None), (3, stamp(True, 3)),
                          (4, stamp(True, 4)), (5, stamp(False, 5))):
            ck.save({"w": state["w"] * s}, step=s, meta={"epoch": s}, health=health)
    os.remove(d / "4" / "_CHECKPOINT_METADATA")
    return d


READERS = {
    "is_committed": lambda m, d: [m.is_committed(d / str(s)) for s in range(1, 7)],
    "valid_steps": lambda m, d: m.valid_steps(d),
    "latest_step": lambda m, d: m.latest_step(d),
    "read_manifest": lambda m, d: [m.read_manifest(d, s) for s in (None, 1, 4, 5, 6)],
    "read_health": lambda m, d: [m.read_health(d, s) for s in (None, 1, 2, 4, 5)],
    "ckpt_health_verdict": lambda m, d: [m.ckpt_health_verdict(d, s)
                                         for s in (None, 1, 2, 3, 4, 5, 6)],
    "is_healthy": lambda m, d: [m.is_healthy(d, s) for s in range(1, 7)],
    "healthy_steps": lambda m, d: m.healthy_steps(d),
    "latest_healthy_step": lambda m, d: m.latest_healthy_step(d),
}


@pytest.mark.parametrize("reader", sorted(READERS))
def test_meta_readers_agree_with_jax_on_the_port_layout(tree, reader):
    got, want = READERS[reader](port_meta, tree), READERS[reader](jax_meta, tree)
    assert got == want
    assert got not in (None, [], [None] * 5)  # the tree gives each reader something to read


def _copies(tree, tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(tree, a)
    shutil.copytree(tree, b)
    return a, b


def _listing(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, dirs, files in os.walk(d) for f in dirs + files)


def test_quarantine_agrees_with_jax_on_the_port_layout(tree, tmp_path):
    a, b = _copies(tree, tmp_path)
    got, want = port_meta.quarantine_torn_steps(a), jax_meta.quarantine_torn_steps(b)
    assert [os.path.relpath(p, a) for p in got] == [os.path.relpath(p, b) for p in want]
    assert [os.path.relpath(p, a) for p in got] == [os.path.join("_quarantine", "4")]
    assert _listing(a) == _listing(b)


def test_rollback_agrees_with_jax_on_the_port_layout(tree, tmp_path):
    a, b = _copies(tree, tmp_path)
    before = get_telemetry().registry.counter("fault/rollbacks").value
    got, want = port_meta.rollback_to_last_healthy(a), jax_meta.rollback_to_last_healthy(b)
    assert got == want == {"to_step": 3, "quarantined": [5]}
    assert get_telemetry().registry.counter("fault/rollbacks").value == before + 1
    assert _listing(a) == _listing(b)


def test_step_directory_holds_the_jax_layout(tree):
    step = tree / "3"
    assert sorted(os.listdir(step)) == ["_CHECKPOINT_METADATA", "meta", "state"]
    assert sorted(os.listdir(step / "state")) == [".metadata", "__0_0.distcp"]
    doc = jax_meta._read_meta_doc(tree, 3)
    assert set(doc) == {"meta", "metrics", "topology", "health"} and doc["meta"] == {"epoch": 3}
    assert not [e for e in os.listdir(tree) if "tmp" in e]  # nothing left staged


# -- retention, best, pytrees, auto-resume ------------------------------------------


def test_retention_and_best(tmp_path):
    state = {"w": torch.ones(3)}
    losses = [3.0, 1.0, 2.0, 0.5, 4.0, 5.0]
    with Checkpointer(tmp_path / "ckpt", max_to_keep=3, best_metric="loss",
                      best_mode="min") as ck:
        for i, loss in enumerate(losses):
            ck.save(state, step=i, metrics={"loss": loss})
        ck.wait()
        assert ck.best_step() == 3
        assert best_checkpoint_path(ck).endswith("3")
        kept = ck.all_steps()
        assert 3 in kept and len(kept) <= 4  # the best survives pruning
        assert kept == [3, 4, 5]
        assert ck.metrics_for(3) == {"loss": 0.5}
    with Checkpointer(tmp_path / "max", max_to_keep=2, best_metric="acc",
                      best_mode="max") as ck:
        for i, acc in enumerate([0.9, 0.1, 0.2]):
            ck.save(state, step=i, metrics={"acc": acc})
        assert ck.best_step() == 0 and ck.all_steps() == [0, 1, 2]


def test_save_refuses_a_committed_step_unless_forced(tmp_path):
    with Checkpointer(tmp_path / "ck") as ck:
        ck.save({"w": torch.zeros(2)}, step=1)
        with pytest.raises(ValueError, match="already saved"):
            ck.save({"w": torch.ones(2)}, step=1)
        ck.save({"w": torch.ones(2)}, step=1, force=True)
        out, _ = ck.restore({"w": torch.zeros(2)})
    assert torch.equal(out["w"], torch.ones(2)) and ck.all_steps() == [1]


def test_save_pytree_roundtrip(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(3)}}
    path = save_pytree(tmp_path / "m" / "state.pt", tree)
    out = load_pytree(path, {"w": torch.zeros(2, 3), "b": {"c": torch.zeros(3, dtype=torch.int32)}})
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3))
    assert out["b"]["c"].dtype == torch.int32 and torch.equal(out["b"]["c"], torch.ones(3).int())


def _save_steps(directory, steps):
    with Checkpointer(directory) as ck:
        for s in steps:
            ck.save({"w": torch.arange(4, dtype=torch.float32) * s}, step=s)


def test_maybe_restore_empty_passthrough(tmp_path):
    state = {"w": torch.zeros(4)}
    with Checkpointer(tmp_path / "none") as ck:
        out, meta = ck.maybe_restore(state)
    assert out is state and meta is None


def test_maybe_restore_all_torn_passes_through(tmp_path):
    d = tmp_path / "ck"
    _save_steps(d, [1])
    os.remove(d / "1" / "_CHECKPOINT_METADATA")
    state = {"w": torch.zeros(4)}
    with Checkpointer(d) as ck:
        out, meta = ck.maybe_restore(state)
    assert out is state and meta is None


def test_maybe_restore_falls_back_to_newest_committed_step(tmp_path):
    d = tmp_path / "ck"
    _save_steps(d, [1, 2, 3])
    os.remove(d / "3" / "_CHECKPOINT_METADATA")
    assert latest_step(d) == 2
    template = {"w": torch.zeros(4)}
    with Checkpointer(d) as ck:
        out, meta = ck.maybe_restore(template)
    assert torch.equal(out["w"], torch.arange(4, dtype=torch.float32) * 2)
    assert meta == {} and torch.equal(template["w"], torch.zeros(4))  # the template stays


def test_save_retries_an_oserror(tmp_path, monkeypatch):
    real, calls = port_checkpoint.dcp.save, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk flake")
        return real(*args, **kwargs)

    monkeypatch.setattr(port_checkpoint.dcp, "save", flaky)
    counter = get_telemetry().registry.counter("ckpt/save_retries")
    before = counter.value
    with Checkpointer(tmp_path / "ck") as ck:
        ck.save({"w": torch.ones(2)}, step=4)
        assert ck.all_steps() == [4]
    assert counter.value == before + 1 and len(calls) == 2
    monkeypatch.setenv("TPUFRAME_CKPT_SAVE_RETRIES", "0")
    calls.clear()
    with Checkpointer(tmp_path / "ck2") as ck, pytest.raises(OSError, match="disk flake"):
        ck.save({"w": torch.ones(2)}, step=1)


# -- the residuals across world sizes -------------------------------------------------


@pytest.mark.parametrize("from_w,to_w", [(2, 1), (1, 2), (3, 2), (4, 2)])
def test_fold_comms_matches_jax(from_w, to_w):
    import jax.numpy as jnp

    saved = np.random.default_rng(from_w * 10 + to_w).standard_normal(
        (from_w, 3, 5)).astype(np.float32)
    want = jax_fold_comms({"flat": jnp.asarray(saved)},
                          {"flat": jnp.zeros((to_w, 3, 5), jnp.float32)}, jax_telemetry(), step=1)
    got = port_checkpoint._fold_comms({"flat": torch.from_numpy(saved)}, to_w, get_telemetry(),
                                      step=1)
    assert got["flat"].shape == (to_w, 3, 5)
    assert np.asarray(want["flat"]).tobytes() == got["flat"].numpy().tobytes()


def test_comms_restore_actions():
    tmpl = {"comms": {"flat": torch.zeros(1, 3, 5)}}

    def manifest(shape):
        return {"leaves": {"comms/flat": {"shape": list(shape), "dtype": "float32"}}}

    assert port_checkpoint._comms_restore_action(tmpl, manifest((1, 3, 5))) == (None, {})
    assert port_checkpoint._comms_restore_action(tmpl, {"leaves": {}})[0] == "reset"
    assert port_checkpoint._comms_restore_action(tmpl, manifest((2, 3, 6)))[0] == "reset"
    assert port_checkpoint._comms_restore_action(tmpl, manifest((2, 3, 5)))[0] == "fold"
    assert port_checkpoint._comms_restore_action({}, manifest((2, 3, 5))) == (None, {})
