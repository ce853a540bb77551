"""The port (``tpuframe_torch``) stands alone and runs on the card by default.

- No file of the port, and not ``chip_smoke.py``, imports JAX, flax, optax,
  orbax or anything of the JAX package: an AST scan of every import.
- Without CUDA, ``initialize()`` and every entry point that takes a device
  raise unless the caller passes ``device="cpu"``.
- ``chip_smoke.py`` fails, and prints no result, without CUDA and in a
  directory that holds nothing else of the repo.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpuframe_torch
from tpuframe_torch.core import initialize, resolve_device
from tpuframe_torch.data import DevicePrefetcher
from tpuframe_torch.models import ResNet18, ResNet50
from tpuframe_torch.serve import ServeEngine

REPO = Path(__file__).resolve().parents[1]
PORT = Path(tpuframe_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tpuframe"}
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    """Top-level package names that ``path`` imports, at any depth."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_imports_nothing_of_jax_or_the_jax_package(path):
    bad = imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_scan_sees_every_import_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom tpuframe.ops import x\n"
                 "def g():\n    import optax\n    __import__('flax')\n"
                 "from tpuframe_torch import ops\n")
    assert imported_roots(f) & FORBIDDEN == {"jax", "tpuframe", "optax", "flax"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_initialize_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize(device="cuda:0")
    rt = initialize(device="cpu")
    assert rt.device == torch.device("cpu") and rt.platform == "cpu"
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        resolve_device("meta")


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(num_classes=1000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(lambda x: x, item_shape=(2,), dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher(iter(()))
    model = ResNet18(num_classes=4, num_filters=4, device="cpu")
    assert model.conv1.weight.device.type == "cpu"


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine has
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_and_prints_no_result(where, tmp_path):
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def _jax_counterpart(rel: Path) -> Path:
    """``tpuframe/<rel>``, or ``examples/<name>`` for a ported example."""
    if rel.parts[0] == "examples":
        return REPO.joinpath(*rel.parts)
    return REPO / "tpuframe" / rel


#: the port's own modules, with no JAX counterpart: the kernels' build, and
#: the tensor-parallel split forms (GSPMD inserts those collectives in JAX)
PORT_ONLY = {"ops/build.py", "parallel/tensor.py"}


def test_port_modules_mirror_the_jax_package():
    ported = {p.relative_to(PORT) for p in PORT.rglob("*.py") if p.name != "__init__.py"}
    missing = [str(p) for p in ported if not _jax_counterpart(p).exists()
               and p.as_posix() not in PORT_ONLY]
    assert not missing, f"port modules with no JAX counterpart: {missing}"
    for module in ("ops/cross_entropy.py", "models/norm.py", "fault/health.py",
                   "train/state.py", "train/step.py", "train/schedules.py", "train/optim.py",
                   "train/duration.py", "train/callbacks.py", "train/algorithms.py",
                   "train/trainer.py", "data/datasets.py", "data/loader.py"):
        assert (PORT / module).exists() and (REPO / "tpuframe" / module).exists(), module
    assert (PORT / "csrc" / "normalize.cu").exists()
    assert (PORT / "csrc" / "cross_entropy.cu").exists()
    # CUDA kernels, and three host-side C++ sources that core/native.py
    # builds with g++: the launcher's heartbeat, the shard codec and the
    # JPEG decoder
    sources = list((PORT / "csrc").iterdir())
    assert {p.name for p in sources if p.suffix != ".cu"} == {"codec.cpp", "heartbeat.cpp",
                                                              "jpegdec.cpp"}
