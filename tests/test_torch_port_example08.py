"""Example 08 (real-data convergence) in the port, against
``examples/08_real_data_convergence.py``.

- ``load_digits_arrays`` (sklearn's bundled digits, nothing downloaded) and
  the augmentations ``shift_crop`` / ``flip_and_crop`` are the JAX
  example's exactly, on the same seed and the same rng.
- ``--epochs 2 --elastic`` on the CPU with the crash set inside epoch 1
  (batch 10 of 15, a snapshot every 4): the first attempt exits 13, the
  restart resumes from the mid-epoch snapshot of batch 8 (its
  ``ckpt/restore`` span), and the final checkpoint (parameters, optimizer
  state, metrics) is bit-equal to an uninterrupted 2-epoch run's.
- ``--dataset cifar10`` without ``--data-npz`` exits 2 with the JAX
  example's message; a stand-in ``datasets`` module refuses the load, so
  nothing is downloaded.
- ``slow``: the full recipe, 25 epochs, clears ``--min-accuracy 0.97`` with
  and without ``--elastic``.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "tpuframe_torch" / "examples" / "08_real_data_convergence.py"


def _jax_example():
    """The JAX example 08 as a module, with its own ``_common``."""
    sys.modules.pop("_common", None)
    sys.path.insert(0, str(REPO / "examples"))
    spec = importlib.util.spec_from_file_location("jax_example_08",
                                                  REPO / "examples" / "08_real_data_convergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules.pop("_common", None)
    return mod


def _port_example():
    sys.modules.pop("_common", None)
    return importlib.import_module("tpuframe_torch.examples.08_real_data_convergence")


@pytest.fixture
def examples(monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.delitem(sys.modules, "_common", raising=False)
    jax_mod = _jax_example()
    port_mod = _port_example()
    yield jax_mod, port_mod
    sys.modules.pop("_common", None)


def test_digits_and_augmentations_are_the_jax_examples(examples):
    jax_mod, port_mod = examples
    for seed in (0, 3):
        (a_tr, a_ytr), (a_te, a_yte) = jax_mod.load_digits_arrays(seed=seed)
        (b_tr, b_ytr), (b_te, b_yte) = port_mod.load_digits_arrays(seed=seed)
        for a, b in ((a_tr, b_tr), (a_ytr, b_ytr), (a_te, b_te), (a_yte, b_yte)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert b_tr.shape == (1500, 28, 28, 1) and b_te.shape == (297, 28, 28, 1)
    img = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)
    for jax_aug, port_aug in ((jax_mod.shift_crop(2, 28), port_mod.shift_crop(2, 28)),
                              (jax_mod.flip_and_crop(4, 32), port_mod.flip_and_crop(4, 32))):
        for s in range(20):
            a = jax_aug(img, np.random.default_rng(s))
            b = port_aug(img, np.random.default_rng(s))
            assert a.shape == b.shape and np.array_equal(a, b)


def _run(workdir: Path, *flags: str, env=None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(SCRIPT), "--simulate-devices", "1", "--workdir", str(workdir),
         *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2", **(env or {})})


def _final_state(ck: Path) -> dict:
    """The newest epoch-end step of ``ck`` as plain tensors, and its meta."""
    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

    from tpuframe_torch.ckpt.meta import _read_meta_doc, latest_step

    step = latest_step(str(ck))
    out = ck.parent / f"final_{ck.parent.name}.pt"
    dcp_to_torch_save(str(ck / str(step) / "state"), str(out))
    return {"step": step, "state": torch.load(out, weights_only=False),
            "metrics": _read_meta_doc(str(ck), step)["metrics"]}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_elastic_restart_resumes_bit_equal_to_an_uninterrupted_run(tmp_path):
    tele = tmp_path / "tele"
    short = ("--epochs", "2", "--eval-interval", "1", "--checkpoint-interval-batches", "4")
    elastic = _run(tmp_path / "elastic", *short, "--elastic", "--simulate-crash-at-batch", "10",
                   env={"TPUFRAME_TELEMETRY_DIR": str(tele)})
    plain = _run(tmp_path / "plain", *short)
    out_e, _ = elastic.communicate(timeout=400)
    out_p, _ = plain.communicate(timeout=400)
    assert elastic.returncode == 0, out_e[-3000:]
    assert plain.returncode == 0, out_p[-3000:]
    assert "[crash-sim] hard exit at global batch 10" in out_e
    assert "[elastic] child failed rc=13; restarting" in out_e
    assert "[elastic] recovered and finished after 1 restart(s)" in out_e
    restores = [r for r in map(json.loads, (tele / "events-rank0.jsonl").read_text().splitlines())
                if r.get("name") == "ckpt/restore"]
    assert [r["attrs"]["step"] for r in restores] == [8]  # the mid-epoch snapshot
    final = [line for line in out_e.splitlines() if line.startswith("final eval_accuracy")]
    assert final and final == [line for line in out_p.splitlines()
                               if line.startswith("final eval_accuracy")]
    a, b = _final_state(tmp_path / "elastic" / "ck"), _final_state(tmp_path / "plain" / "ck")
    model_keys = ("train_loss", "train_accuracy", "grad_norm", "eval_loss", "eval_accuracy")
    assert a["step"] == b["step"] == 30
    assert [a["metrics"][k] for k in model_keys] == [b["metrics"][k] for k in model_keys]
    la, lb = dict(_leaves(a["state"])), dict(_leaves(b["state"]))
    assert la.keys() == lb.keys() and len(la) > 10
    for k in la:
        if isinstance(la[k], torch.Tensor):
            assert torch.equal(la[k], lb[k]), k
        else:
            assert la[k] == lb[k], k


def test_cifar10_without_data_exits_2_with_the_clear_message(examples, monkeypatch, capsys,
                                                              tmp_path):
    _, port_mod = examples

    def refuse(*args, **kwargs):
        raise ConnectionError("no network in this test")

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(load_dataset=refuse))
    with pytest.raises(SystemExit) as info:
        port_mod.main(["--dataset", "cifar10", "--workdir", str(tmp_path)])
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert "cifar10 data unavailable: could not load HF dataset 'cifar10'" in err


@pytest.mark.slow
def test_the_full_digits_recipe_clears_97_percent_with_and_without_elastic(tmp_path):
    flags = ("--epochs", "25", "--min-accuracy", "0.97")
    runs = {"plain": _run(tmp_path / "plain", *flags),
            "elastic": _run(tmp_path / "elastic", *flags, "--elastic")}
    for name, p in runs.items():
        out, _ = p.communicate(timeout=1800)
        assert p.returncode == 0 and "ACCEPTED" in out, (name, out[-3000:])
        print(name, [line for line in out.splitlines() if line.startswith("final")])
