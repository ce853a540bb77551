"""The port's persistent compile cache (``tpuframe_torch.compile.cache``)
against the JAX package's (``tpuframe.compile.cache``).

- Exact against JAX on the same environment and files: the knob list and
  its domains, ``cache_dir_from_env`` (explicit, falsy, the scratch
  default), ``trim`` on a flat directory of ``<key>-cache``/``<key>-atime``
  files (keep-K, the size cap, a junk cap, a missing directory) and
  ``cache_info``'s keys and counts.
- The port's own layout: a key directory of Inductor's is evicted whole,
  a bucket of generated code by key stem, ``locks/`` never.
- Real compiles, in fresh processes (the cache is the point): a tiny
  compiled function misses into a new directory (``enable`` called after
  ``import torch``), hits in a second process with no backend compile,
  and after ``trim`` empties the directory misses and hits again.
- ``compile.cache`` imports no torch.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpuframe.compile import cache as jax_cc
from tpuframe_torch.compile import cache as cc

REPO = Path(__file__).resolve().parents[1]


def test_knob_list_and_domains_are_jaxs():
    assert cc.COMPILE_ENV_VARS == jax_cc.COMPILE_ENV_VARS
    assert cc.COMPILE_ENV_DOMAINS == jax_cc.COMPILE_ENV_DOMAINS


@pytest.mark.parametrize("value", ["/some/dir", "0", "off", "false", "no", "disabled",
                                   "  OFF ", ""])
def test_cache_dir_from_env_is_jaxs(monkeypatch, tmp_path, value):
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", value)
    monkeypatch.setenv("TPUFRAME_LOCAL_SCRATCH", str(tmp_path))
    assert cc.cache_dir_from_env() == jax_cc.cache_dir_from_env()


def test_default_dir_is_the_host_shared_scratch(monkeypatch, tmp_path):
    monkeypatch.delenv("TPUFRAME_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("TPUFRAME_LOCAL_SCRATCH", str(tmp_path))
    assert cc.cache_dir_from_env() == jax_cc.cache_dir_from_env() == str(
        tmp_path / "compile_cache")
    monkeypatch.delenv("TPUFRAME_LOCAL_SCRATCH")
    assert cc.cache_dir_from_env() == jax_cc.cache_dir_from_env()


def test_a_falsy_env_disables_enable(monkeypatch):
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", "off")
    assert cc.enable() is None


def _fill(d, n, size=1000):
    """JAX's test layout: n entries, entry i older when i is small."""
    os.makedirs(d, exist_ok=True)
    now = time.time()
    for i in range(n):
        p = os.path.join(d, f"jit_f{i}-{'a' * 8}-cache")
        with open(p, "wb") as f:
            f.write(b"x" * size)
        at = p[: -len("-cache")] + "-atime"
        with open(at, "w"):
            pass
        t = now - (n - i) * 60
        os.utime(p, (t, t))
        os.utime(at, (t, t))


# (n entries, size, max_bytes, keep, env cap): JAX's TestTrim cases and more
TRIM_CASES = [
    ("over_cap", 10, 1000, 5000, 2, None),
    ("keep_k_wins", 6, 1000, 1, 4, None),
    ("unbounded", 3, 1000, 0, 1, None),
    ("fits", 4, 100, 10_000, 0, None),
    ("keep_zero", 5, 2048, 4096, 0, None),
    ("junk_env_cap", 3, 1000, None, None, "banana"),
    ("env_cap", 8, 2**18, None, None, "1"),
]


@pytest.mark.parametrize("case", TRIM_CASES, ids=[c[0] for c in TRIM_CASES])
def test_trim_of_flat_files_is_jaxs(monkeypatch, tmp_path, case):
    _, n, size, max_bytes, keep, env_cap = case
    if env_cap is not None:
        monkeypatch.setenv("TPUFRAME_COMPILE_CACHE_MAX_MB", env_cap)
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE_KEEP", "2")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    _fill(ours, n, size)
    _fill(theirs, n, size)
    got = cc.trim(ours, max_bytes=max_bytes, keep=keep)
    want = jax_cc.trim(theirs, max_bytes=max_bytes, keep=keep)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    assert _info(cc, ours) == {**_info(jax_cc, theirs), "dir": ours}


def test_trim_of_a_missing_dir_is_a_noop(tmp_path):
    missing = str(tmp_path / "nope")
    assert cc.trim(missing, max_bytes=10, keep=0) == jax_cc.trim(missing, max_bytes=10,
                                                                  keep=0) == []


def _info(module, d: str) -> dict:
    """``cache_info`` of ``d``; its ``enabled_in_process`` says whether the
    package enabled its cache in this process (whatever ran here before),
    which each package reports of itself."""
    info = module.cache_info(d)
    assert info.pop("enabled_in_process") is (module.enabled_dir() is not None)
    return info


def test_cache_info_has_jaxs_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE_KEEP", "7")
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE_MAX_MB", "256")
    d = str(tmp_path / "c")
    _fill(d, 4, size=2048)
    ours, theirs = cc.cache_info(d), jax_cc.cache_info(d)
    assert set(ours) == set(theirs)
    assert _info(cc, d) == _info(jax_cc, d)
    assert ours["entries"] == 4 and ours["keep"] == 7 and ours["max_mb"] == 256.0


def _inductor_layout(d: Path) -> dict:
    """Inductor's layout in miniature: key directories under fxgraph/ (two
    levels), aotautograd/ and triton/<device>/, a bucket of generated code
    (two key stems), and a lock; ages from old to new."""
    entries = {
        "fxgraph/ab/fkey1": ["entry", "meta"],
        "fxgraph/cd/fkey2": ["entry"],
        "aotautograd/akey1": ["entry", "x", "y"],
        "triton/0/tkey1": ["k.cubin", "k.json"],
    }
    age = 100
    for key, files in entries.items():
        (d / key).mkdir(parents=True)
        for f in files:
            p = d / key / f
            p.write_bytes(b"x" * 1000)
            os.utime(p, (time.time() - age * 60,) * 2)
        age -= 10
    (d / "zz").mkdir()
    for stem, t in (("cold", 200), ("hot", 1)):
        for ext in ("py", "so", "main.cpp"):
            p = d / "zz" / f"{stem}.{ext}"
            p.write_bytes(b"y" * 500)
            os.utime(p, (time.time() - t * 60,) * 2)
    (d / "locks").mkdir()
    (d / "locks" / "fkey1.lock").write_bytes(b"")
    return entries


def test_trim_evicts_inductor_keys_whole_and_never_locks(tmp_path):
    from tpuframe_torch.track.telemetry import get_telemetry

    d = tmp_path / "cache"
    entries = _inductor_layout(d)
    info = cc.cache_info(str(d))
    assert info["entries"] == len(entries) + 2  # four keys, two code stems
    tele = get_telemetry()
    before = tele.registry.counter("compile/cache_evictions").value
    evicted = cc.trim(str(d), max_bytes=4000, keep=1)
    assert tele.registry.counter("compile/cache_evictions").value - before == 4
    (event,) = [e for e in tele.recent_events(100) if e.get("name") == "compile/cache_evict"
                and e.get("dir") == str(d)]
    assert event["n"] == 4
    names = [os.path.relpath(p, d) for p in evicted]
    # oldest first until 11,000 bytes fit 4,000: the cold code stem, then
    # fxgraph's two keys, then aotautograd's; triton's key and the newest
    # stem (kept) stay
    assert [n.split(".")[0] for n in names] == [
        os.path.join("zz", "cold"), "fxgraph/ab/fkey1", "fxgraph/cd/fkey2", "aotautograd/akey1"]
    for key, files in entries.items():
        present = [(d / key / f).exists() for f in files]
        assert all(present) or not any(present) and not (d / key).exists(), key
    assert not any(n.endswith(".evicting") for n in os.listdir(d))
    assert (d / "locks" / "fkey1.lock").exists()
    assert (d / "zz" / "hot.py").exists() and not (d / "zz" / "cold.so").exists()
    left = cc.cache_info(str(d))
    assert left["entries"] == 2 and left["total_mb"] == round(3500 / 2**20, 3)


_CHILD = r"""
import json, sys
import torch
import torch._inductor.config
from tpuframe_torch.compile import cache as cc
from tpuframe_torch.track.telemetry import get_telemetry

d = cc.enable(sys.argv[1])  # after import torch: it must take effect
cc.install_listeners()
with cc.compile_label("tiny"):
    f = torch.compile(lambda x: torch.sin(x) * 2 + 1)
    y = f(torch.ones(8))
assert torch.allclose(y, torch.sin(torch.ones(8)) * 2 + 1)
snap = get_telemetry().registry.snapshot()
events = [e for e in get_telemetry().recent_events(10000)
          if e.get("name") == "compile/backend_compile"]
print(json.dumps({"dir": d, "counts": {k: snap.get(f"compile/{k}", 0.0) for k in
                  ("cache_hits", "cache_misses", "backend_compiles")},
                  "events": [{k: e.get(k) for k in ("label", "persistent_cache")}
                             for e in events]}))
"""


def _compile_in_a_fresh_process(d: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("TORCHINDUCTOR_CACHE_DIR", None)
    env.pop("TRITON_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(d)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_compile_misses_then_hits_in_a_second_process_and_again_after_trim(tmp_path):
    d = tmp_path / "cc"
    cold = _compile_in_a_fresh_process(d)
    assert cold["dir"] == str(d)
    assert cold["counts"]["cache_misses"] >= 1 and cold["counts"]["backend_compiles"] >= 1
    assert cold["events"] and cold["events"][0] == {"label": "tiny", "persistent_cache": "miss"}
    assert (d / "fxgraph").is_dir()  # enable() after import torch took effect
    warm = _compile_in_a_fresh_process(d)
    assert warm["counts"]["cache_hits"] >= 1
    assert warm["counts"]["backend_compiles"] == 0 and warm["counts"]["cache_misses"] == 0
    assert warm["events"] == []  # a retrieval is counted, not shouted
    assert cc.trim(str(d), max_bytes=1, keep=0)
    assert cc.cache_info(str(d))["total_mb"] == 0.0  # what is left holds no byte
    again = _compile_in_a_fresh_process(d)
    assert again["counts"]["cache_misses"] >= 1 and again["counts"]["backend_compiles"] >= 1
    hit = _compile_in_a_fresh_process(d)
    assert hit["counts"]["cache_hits"] >= 1 and hit["counts"]["backend_compiles"] == 0


def test_the_cache_module_imports_no_torch():
    code = ("import sys; import tpuframe_torch.compile.cache, tpuframe_torch.compile as c; "
            "assert 'torch' not in sys.modules, 'torch'; "
            "assert c.COMPILE_ENV_VARS and c.cache_info()['keep'] == 16")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("TPUFRAME_COMPILE_CACHE_KEEP", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_enable_and_disable_set_inductors_switches(tmp_path):
    import torch._functorch.config as fc
    import torch._inductor.config as ic

    prev = cc.enabled_dir()
    saved = {k: os.environ.get(k) for k in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR")}
    try:
        d = str(tmp_path / "x")
        assert cc.enable(d) == d == cc.enabled_dir()
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == d
        assert os.environ["TRITON_CACHE_DIR"] == os.path.join(d, "triton")
        assert ic.fx_graph_cache is True and fc.enable_autograd_cache is True
        cc.disable()
        assert cc.enabled_dir() is None
        assert ic.fx_graph_cache is False and fc.enable_autograd_cache is False
    finally:
        cc.enable(prev) if prev else cc.disable()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ic.fx_graph_cache = fc.enable_autograd_cache = True


def test_the_remote_launcher_ships_the_compile_knobs_as_jax_does(monkeypatch):
    """JAX's ``test_remote_ships_compile_env`` on the port's launcher, and
    the knob list inside ``all_env_vars``."""
    from tpuframe.launch.remote import RemoteDistributor as JaxRemote
    from tpuframe_torch.launch.remote import RemoteDistributor, all_env_vars

    assert set(cc.COMPILE_ENV_VARS) <= set(all_env_vars())
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", "/fleet/cache")
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE_MAX_MB", "256")
    for cls in (RemoteDistributor, JaxRemote):
        env = cls(["h0", "h1"])._worker_env(1, "h0", 1234, 1235, "tok", None)
        assert env["TPUFRAME_COMPILE_CACHE"] == "/fleet/cache"
        assert env["TPUFRAME_COMPILE_CACHE_MAX_MB"] == "256"
        # an explicit env= still wins over the inherited knob
        env2 = cls(["h0"], env={"TPUFRAME_COMPILE_CACHE": "/custom"})._worker_env(
            0, "h0", 1234, 1235, "tok", None)
        assert env2["TPUFRAME_COMPILE_CACHE"] == "/custom"


def test_initialize_enables_the_cache_first(monkeypatch, tmp_path):
    """``core.initialize`` enables the persistent cache from the env before
    any other work, as JAX's ``runtime.initialize`` does; a falsy env
    leaves it off."""
    from tpuframe_torch.core import initialize, reset_runtime

    prev = cc.enabled_dir()
    try:
        monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", str(tmp_path / "rt"))
        cc.disable()
        initialize(device="cpu")
        assert cc.enabled_dir() == str(tmp_path / "rt")
        reset_runtime()
        monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", "0")
        cc.disable()
        initialize(device="cpu")
        assert cc.enabled_dir() is None
    finally:
        reset_runtime()
        cc.enable(prev) if prev else cc.disable()
