"""The port's public names against the JAX package's, so that ``examples/``
translate line for line.

1. For each ported subpackage, ``tpuframe_torch.<sub>.__all__`` against
   ``tpuframe.<sub>.__all__``, read at run time (several tables are built
   by code).  A JAX name the port lacks must be one of three kinds, each
   listed below: a name of a module still to port (``QUEUE1_MODULES``,
   ROADMAP Queue 1), a name of a ported module that waits for a later
   slice's code (``LATER``), or a dispatch switch dropped by design
   (``DROPPED``).  A table entry that the port has since gained fails too,
   so the tables stay true.
2. Every ``from tpuframe.X import ...`` line of ``examples/*.py``, mapped
   to ``tpuframe_torch``, resolves, or names a module still to port.
3. The chaos-site registry: every literal ``maybe_fire``/``site`` call
   under ``tpuframe_torch/`` names a site of ``fault.chaos.CHAOS_SITES``,
   and every site there has a call (the port does not port the JAX
   package's linter, which holds the same invariant).
4. Behaviour against JAX for the names this slice added: ``param_count``,
   ``is_main_process``, ``reset_runtime``, ``Timer``, ``schedule_from_config``
   (on ``tests/test_schedules.py``'s config dicts), ``hfds_download`` (with
   a stand-in ``datasets`` module: nothing is downloaded),
   ``make_image_dataset``, ``hf_get_num_classes`` and ``read_export_meta``.
"""

import ast
import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuframe_torch.core.runtime as port_runtime
from tpuframe.core import runtime as jax_runtime
from tpuframe.data import datasets as jax_datasets
from tpuframe.serve.admission import read_export_meta as jax_read_export_meta
from tpuframe.train.schedules import from_config as jax_from_config
from tpuframe.train.state import param_count as jax_param_count
from tpuframe_torch.core import is_main_process, reset_runtime, simulate_cpu_devices
from tpuframe_torch.data import (
    Timer,
    hf_get_num_classes,
    hfds_download,
    make_image_dataset,
)
from tpuframe_torch.data import datasets as port_datasets
from tpuframe_torch.models import TransformerLM
from tpuframe_torch.serve import read_export_meta
from tpuframe_torch.train import create_train_state, param_count, schedule_from_config
from tpuframe_torch.train.optim import make_optimizer

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("core", "data", "train", "models", "ops", "parallel", "ckpt", "serve", "track",
               "fault", "compile", "launch")

#: JAX modules (or whole packages) the port does not have yet, with the
#: ROADMAP Queue 1 item that brings each
QUEUE1_MODULES = {
    "tpuframe.ops.ledger": 9,
    "tpuframe.autotune": 9,
    "tpuframe.serve.export": 9,
    "tpuframe.serve.router": 9,
    "tpuframe.serve.fleet": 9,
}

#: names of ported modules that wait for a later slice's code: (subpackage,
#: name) -> (Queue 1 item, what they wait for)
LATER: dict = {}

#: modules ported in the launcher slice: (module under tpuframe, JAX
#: module's own class or function) -> (Queue 1 item, what it waits for)
LATER_IN_MODULE: dict = {}

#: the modules of the launcher slice and of the streaming slice, compared
#: module by module
SLICE_MODULES = ("core.config", "core.workspace", "core.native", "models.cnn", "models.transfer",
                 "train.ema", "track.mlflow_store", "track.registry", "launch.distributor",
                 "launch.trainer_api", "data.transforms", "data.streaming", "data.mds",
                 "track.tensorboard", "track.system_metrics", "track.telemetry",
                 "parallel.zero", "parallel.memory", "parallel.sharding", "parallel.compose",
                 "parallel.pipeline", "fault.chaos", "fault.preempt", "fault.supervisor",
                 "fault.health", "launch.elastic", "launch.remote", "launch.agent",
                 "track.device_time", "track.profiler", "track.memory", "track.analyze",
                 "track.http_store")

#: the JAX package's kernel switches: the port dispatches by device alone
DROPPED = {"use_pallas", "kernel_enabled", "kernels_mode"}


def _jax_home(sub: str, name: str) -> str:
    """The JAX module that defines ``tpuframe.<sub>``'s export ``name``,
    from the package's lazy tables or its ``from ... import`` lines."""
    pkg = importlib.import_module(f"tpuframe.{sub}")
    if name in getattr(pkg, "_LAZY", {}):
        return pkg._LAZY[name]
    if name in getattr(pkg, "_EXPORTS", {}):
        return f"tpuframe.{sub}.{pkg._EXPORTS[name]}"
    if name in getattr(pkg, "_SUBMODULES", ()):
        return f"tpuframe.{sub}.{name}"
    for node in ast.walk(ast.parse(Path(pkg.__file__).read_text())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("tpuframe."):
            if any((a.asname or a.name) == name for a in node.names):
                return node.module
    raise AssertionError(f"tpuframe.{sub}.{name}: no home module found")


def _in_queue1(module: str) -> bool:
    return any(module == m or module.startswith(m + ".") for m in QUEUE1_MODULES)


def _port_has_module(module: str) -> bool:
    port = "tpuframe_torch" + module.removeprefix("tpuframe")
    try:
        importlib.import_module(port)
    except ModuleNotFoundError:
        return False
    return True


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_public_names_match_jax_but_for_the_listed_gaps(sub):
    jax_names = set(importlib.import_module(f"tpuframe.{sub}").__all__)
    port = importlib.import_module(f"tpuframe_torch.{sub}")
    port_names = set(port.__all__)
    assert all(hasattr(port, n) for n in port_names), sorted(n for n in port_names
                                                             if not hasattr(port, n))
    unexplained = []
    for name in sorted(jax_names - port_names):
        if name in DROPPED or (sub, name) in LATER:
            continue
        if not _in_queue1(_jax_home(sub, name)):
            unexplained.append(name)
    assert not unexplained, f"tpuframe_torch.{sub} lacks {unexplained}"
    stale = [n for (s, n) in LATER if s == sub and n in port_names]
    stale += [n for n in DROPPED if n in port_names and sub == "ops"]
    assert not stale, f"tpuframe_torch.{sub} has {stale} now: take them out of the tables"


def test_queue1_modules_are_still_missing_from_the_port():
    assert not [m for m in QUEUE1_MODULES if _port_has_module(m)]


def _defined(module) -> set[str]:
    """The public classes and functions a module defines itself."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and callable(v)
            and getattr(v, "__module__", None) == module.__name__}


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_names_match_jax_but_for_the_listed_gaps(module):
    jax_names = _defined(importlib.import_module(f"tpuframe.{module}"))
    port = importlib.import_module(f"tpuframe_torch.{module}")
    port_names = {n for n in dir(port) if not n.startswith("_")}
    later = {n for (m, n) in LATER_IN_MODULE if m == module}
    missing, stale = sorted(jax_names - port_names - later), sorted(later & port_names)
    assert not missing, f"tpuframe_torch.{module} lacks {missing}"
    assert not stale, f"tpuframe_torch.{module} has {stale} now: take them out of the table"
    assert set(getattr(port, "__all__", port_names)) <= port_names


def _chaos_site_calls() -> dict[str, list[str]]:
    """site -> the ``file:line`` of each literal ``maybe_fire``/``site`` call
    under ``tpuframe_torch/``."""
    calls: dict[str, list[str]] = {}
    for path in sorted((REPO / "tpuframe_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "chaos" else None)
            arg = node.args[0]
            if name in ("maybe_fire", "site") and isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, str):
                calls.setdefault(arg.value, []).append(
                    f"{path.relative_to(REPO)}:{node.lineno}")
    return calls


def test_chaos_sites_registry_matches_the_instrumented_calls():
    from tpuframe.fault.chaos import CHAOS_SITES as JAX_SITES
    from tpuframe_torch.fault.chaos import CHAOS_SITES

    calls = _chaos_site_calls()
    assert set(calls) == set(CHAOS_SITES), (sorted(calls), sorted(CHAOS_SITES))
    # the JAX package's sites, but for the serving fleet's (not ported)
    assert set(CHAOS_SITES) == {s for s in JAX_SITES if not s.startswith("fleet/")}
    assert len(calls["step"]) >= 2 and len(calls["ckpt/saved"]) == 1


def _example_imports():
    """(example, line, module, names) of every ``from tpuframe... import``."""
    out = []
    for path in sorted((REPO / "examples").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                    node.module == "tpuframe" or (node.module or "").startswith("tpuframe.")):
                out.append((path.name, node.lineno, node.module, [a.name for a in node.names]))
    return out


EXAMPLE_IMPORTS = _example_imports()


def _is_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # a parent that is a module, not a package
        return False


def _example_module_attributes():
    """(example, JAX module, attribute) for each ``alias.attribute`` in an
    example whose ``alias`` names a JAX module (``from tpuframe import
    core``, ``from tpuframe.core import runtime as rt``) and is bound by
    nothing else in that file."""
    out = set()
    for path in sorted((REPO / "examples").glob("*.py")):
        tree = ast.parse(path.read_text())
        aliases, rebound = {}, set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                    node.module or "").split(".")[0] == "tpuframe":
                for a in node.names:
                    mod = f"{node.module}.{a.name}"
                    if _is_module(mod):
                        aliases[a.asname or a.name] = mod
            elif isinstance(node, (ast.Name, ast.arg)) and isinstance(
                    getattr(node, "ctx", ast.Store()), ast.Store):
                rebound.add(node.id if isinstance(node, ast.Name) else node.arg)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                    and node.value.id in aliases and node.value.id not in rebound):
                out.add((path.name, aliases[node.value.id], node.attr))
    return sorted(out)


EXAMPLE_ATTRIBUTES = _example_module_attributes()


@pytest.mark.parametrize("example,line,module,names", EXAMPLE_IMPORTS,
                         ids=[f"{e}:{ln}" for e, ln, _, _ in EXAMPLE_IMPORTS])
def test_example_imports_resolve_in_the_port(example, line, module, names):
    if _in_queue1(module):
        return  # the whole module waits for its slice
    port = importlib.import_module("tpuframe_torch" + module.removeprefix("tpuframe"))
    missing = []
    for name in names:
        if hasattr(port, name) or _port_has_module(f"{module}.{name}"):
            continue
        if module == "tpuframe" and _in_queue1(f"tpuframe.{name}"):
            continue  # a subpackage still to port
        sub = module.removeprefix("tpuframe.")
        if "." not in sub and module != "tpuframe" and (
                (sub, name) in LATER or _in_queue1(_jax_home(sub, name))):
            continue
        missing.append(name)
    assert not missing, f"{example}:{line}: tpuframe_torch lacks {missing} of {module}"


@pytest.mark.parametrize("example,module,attr", EXAMPLE_ATTRIBUTES,
                         ids=[f"{e}:{m}.{a}" for e, m, a in EXAMPLE_ATTRIBUTES])
def test_example_module_attributes_resolve_in_the_port(example, module, attr):
    """``rt.reset_runtime()`` in example 06 needs ``reset_runtime`` in
    ``tpuframe_torch.core.runtime``, and ``core.initialize`` ``initialize``
    in ``tpuframe_torch.core``."""
    if _in_queue1(module):
        return
    port = importlib.import_module("tpuframe_torch" + module.removeprefix("tpuframe"))
    assert hasattr(port, attr) or _port_has_module(f"{module}.{attr}"), (
        f"{example}: tpuframe_torch lacks {module.removeprefix('tpuframe')}.{attr}")


# -- behaviour against JAX ------------------------------------------------------


def test_param_count_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"dense": {"kernel": rng.standard_normal((7, 5)), "bias": rng.standard_normal(5)},
            "blocks": [rng.standard_normal((3, 2, 4)), np.array(rng.standard_normal())]}
    jax_tree = jax.tree.map(jnp.asarray, tree)
    port_tree = {"dense": {k: torch.from_numpy(v) for k, v in tree["dense"].items()},
                 "blocks": [torch.from_numpy(v) for v in tree["blocks"]]}
    want = jax_param_count(jax_tree)
    assert want == 7 * 5 + 5 + 24 + 1
    assert param_count(port_tree) == want
    assert param_count(tree) == want  # numpy leaves
    model = TransformerLM(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, max_len=16,
                          device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert param_count(model) == n
    assert param_count(create_train_state(model, make_optimizer("sgd", 0.1))) == n
    named = {k: v for k, v in model.named_parameters()}
    assert param_count(named) == jax_param_count(
        {k: jnp.asarray(v.detach().numpy()) for k, v in named.items()}) == n


def test_is_main_process_and_reset_runtime_as_jax(monkeypatch):
    # the JAX runtime other tests of this process may hold comes back after
    monkeypatch.setattr(jax_runtime, "_CURRENT", jax_runtime._CURRENT)
    port_runtime.reset_runtime()
    rt = port_runtime.initialize(device="cpu")
    assert port_runtime.current_runtime(auto_init=False) is rt
    assert is_main_process() == jax_runtime.is_main_process() is True
    reset_runtime()
    with pytest.raises(RuntimeError, match="not initialized"):
        port_runtime.current_runtime(auto_init=False)
    jax_runtime.reset_runtime()
    with pytest.raises(RuntimeError, match="not initialized"):
        jax_runtime.current_runtime(auto_init=False)
    assert is_main_process()  # no runtime, no group: rank 0


def test_reset_runtime_destroys_only_a_group_it_built(tmp_path, monkeypatch):
    import torch.distributed as dist

    store = f"file://{tmp_path / 'store'}"
    monkeypatch.setenv("TPUFRAME_COORDINATOR", store)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    port_runtime.reset_runtime()
    try:
        port_runtime.initialize(device="cpu")  # builds a one-rank gloo group
        assert dist.is_initialized()
        reset_runtime()
        assert not dist.is_initialized()
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'own'}", world_size=1,
                                rank=0)
        port_runtime.initialize(device="cpu")  # joins the caller's group
        reset_runtime()
        assert dist.is_initialized()  # the caller's group stays
    finally:
        port_runtime.shutdown()
    assert not dist.is_initialized()


def test_simulate_cpu_devices_names_the_ports_route():
    with pytest.raises(NotImplementedError,
                       match=r"gloo processes.*Distributor\(num_processes=4, simulate_devices=1\)"):
        simulate_cpu_devices(4)


def test_timer_as_jax():
    for cls in (Timer, jax_datasets.Timer):
        t = cls()
        time.sleep(0.01)
        first = t.stop()
        assert 0.01 <= first < 5.0 and t.end >= t.start
        assert t.stop() >= first  # the start stays


#: ``tests/test_schedules.py``'s TestFromConfig dicts: (config, total_steps)
SCHEDULE_CONFIGS = [
    ({"scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0, "warmup_max_lr": 2e-4, "warmup_num_steps": 100,
        "warmup_type": "linear"}}}, None),
    ({"type": "WarmupLR", "params": {
        "warmup_min_lr": 0, "warmup_max_lr": 2e-4, "warmup_num_steps": 100,
        "warmup_type": "linear"}}, None),
    ({"type": "WarmupDecayLR", "params": {
        "warmup_max_lr": 1e-3, "warmup_num_steps": 10, "total_num_steps": "auto"}}, 110),
    ({"type": "CosineAnnealingLR", "params": {"base_lr": 0.1, "T_max": 10}}, None),
    ({"type": "StepLR", "params": {"base_lr": 1.0, "step_size": 5, "gamma": 0.5}}, None),
]
SCHEDULE_ERRORS = [
    ({"type": "WarmupDecayLR", "params": {"warmup_max_lr": 1e-3, "warmup_num_steps": 10}},
     "auto"),
    ({"type": "OneCycle", "params": {}}, "unknown scheduler"),
    ({"type": "WarmupCosineLR", "params": {"warmup_num_steps": 100, "total_num_steps": 1000}},
     "warmup_max_lr"),
    ({"warmup_max_lr": 1e-3, "warmup_num_steps": 500}, "no 'type' key"),
]


@pytest.mark.parametrize("cfg,total", SCHEDULE_CONFIGS,
                         ids=["deepspeed", "block", "warmup_decay_auto", "cosine", "step"])
def test_schedule_from_config_matches_jax(cfg, total):
    kw = {} if total is None else {"total_steps": total}
    jsched, tsched = jax_from_config(cfg, **kw), schedule_from_config(cfg, **kw)
    for step in (0, 1, 5, 9, 10, 50, 99, 100, 110, 500):
        # float32 in JAX, float64 here
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-6, abs=1e-7), step


@pytest.mark.parametrize("cfg,match", SCHEDULE_ERRORS,
                         ids=["auto_without_total", "unknown", "no_peak", "no_type"])
def test_schedule_from_config_refuses_as_jax(cfg, match):
    for fn in (jax_from_config, schedule_from_config):
        with pytest.raises(ValueError, match=match):
            fn(cfg)


def test_hfds_download_as_jax_without_a_download(monkeypatch):
    """``datasets`` missing: JAX's ImportError.  A stand-in ``datasets``
    module: the same call through, and a failure re-raised as JAX's
    RuntimeError.  Nothing touches the network."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    for fn in (hfds_download, jax_datasets.hfds_download):
        with pytest.raises(ImportError, match="'datasets' package is required"):
            fn("some/dataset", "/nonexistent-cache")
    calls = []

    def load_dataset(**kw):
        calls.append(kw)
        if kw["path"] == "missing":
            raise FileNotFoundError(kw["path"])
        return {"train": {"img": [1, 2], "label": [0, 1]}}

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(load_dataset=load_dataset))
    got = [fn("tiny", "/cache", split="train") for fn in (hfds_download,
                                                           jax_datasets.hfds_download)]
    assert got[0] == got[1] and calls[0] == calls[1] == {
        "path": "tiny", "cache_dir": "/cache", "trust_remote_code": False, "split": "train"}
    for fn in (hfds_download, jax_datasets.hfds_download):
        with pytest.raises(RuntimeError, match="could not load HF dataset 'missing'"):
            fn("missing", "/cache")


def test_make_image_dataset_and_num_classes_as_jax():
    rng = np.random.default_rng(3)
    split = {"img": rng.integers(0, 256, (6, 4, 4, 3), dtype=np.uint8),
             "label": [2, 0, 1, 2, 0, 2], "pixels": rng.integers(0, 256, (6, 2), np.uint8),
             "y": [1, 1, 0, 1, 0, 0]}

    def flip(img, r):
        return img[:, ::-1] if r.random() < 0.5 else img

    for kw in ({}, {"image_key": "pixels", "label_key": "y"}, {"transform": flip}):
        port, ref = make_image_dataset(split, **kw), jax_datasets.make_image_dataset(split, **kw)
        assert isinstance(port, port_datasets.ArrayDataset) and len(port) == len(ref) == 6
        for i in range(6):
            (a, la), (b, lb) = port[i], ref[i]
            np.testing.assert_array_equal(a, b)
            assert la == lb
    data = {"train": split, "test": {"label": [5, 5, 5]}}
    for key, label, want in (("train", "label", 3), ("train", "y", 2), ("test", "label", 1)):
        assert hf_get_num_classes(data, key, label) == want
        assert jax_datasets.hf_get_num_classes(data, key, label) == want


def _artifact(path: Path, header: bytes, length: int | None = None, blob: bytes = b"xyz"):
    n = len(header) if length is None else length
    path.write_bytes(n.to_bytes(8, "little") + header + blob)
    return path


def test_read_export_meta_as_jax(tmp_path):
    meta = {"magic": "tpuframe-export", "model": "resnet", "buckets": [1, 8]}
    head = json.dumps(meta).encode()
    good = _artifact(tmp_path / "good.bin", head)
    want = jax_read_export_meta(good)
    assert read_export_meta(good) == want == {**meta, "_blob_offset": 8 + len(head)}
    assert read_export_meta(str(good)) == want
    bad = {
        "short": _artifact(tmp_path / "short.bin", b"{", length=1),
        "huge": _artifact(tmp_path / "huge.bin", head, length=1 << 40),
        "past_end": _artifact(tmp_path / "past.bin", head, length=len(head) + 100, blob=b""),
        "not_json": _artifact(tmp_path / "nj.bin", b"\xff\xfe garbage"),
        "not_a_dict": _artifact(tmp_path / "list.bin", b"[1, 2]"),
        "wrong_magic": _artifact(tmp_path / "magic.bin", json.dumps({"magic": "x"}).encode()),
    }
    for name, path in bad.items():
        for fn in (read_export_meta, jax_read_export_meta):
            with pytest.raises(ValueError, match="not a tpuframe export artifact"):
                fn(path)
