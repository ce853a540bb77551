"""``tpuframe_torch.track.memory`` (the memory plane) against
``tpuframe.track.memory``.

- ``memory_env`` over a table of values, and the knob list and domains:
  exactly JAX's.
- ``update_watermarks``: seeded sequences of samples give JAX's peaks,
  gauges and ratcheted ``memory/watermark`` events, exactly.
- ``is_oom``: JAX's verdict on JAX's cases (XLA's status names, the chaos
  injector's synthetic error, non-OOMs); ``torch.OutOfMemoryError`` and
  "CUDA out of memory" are OOMs too.
- ``maybe_oom_event`` after ``set_context`` for one plan and the same
  templates: the ``memory/oom`` event carries JAX's keys, JAX's estimate
  and JAX's ``suggest_fit`` ladder; a non-OOM and ``TPUFRAME_MEMORY_LIVE=0``
  emit nothing.
- ``record_executable_memory`` over a precompiled CPU step: JAX's record
  keys, the state's and the template's bytes as arguments, persisted
  under ``<compile cache>/memory/`` and read back by
  ``executable_records``.
"""

import warnings

import numpy as np
import pytest
import torch

from tpuframe.track import memory as jax_memory
from tpuframe.track import telemetry as jax_telemetry
from tpuframe_torch.track import memory
from tpuframe_torch.track import telemetry


@pytest.fixture(autouse=True)
def fresh():
    for t in (telemetry, jax_telemetry):
        t.reset()
    for m in (memory, jax_memory):
        m.reset_peaks()
        m.clear_context()
    yield
    for t in (telemetry, jax_telemetry):
        t.reset()
    for m in (memory, jax_memory):
        m.reset_peaks()
        m.clear_context()


@pytest.mark.parametrize("env", [
    {}, {"TPUFRAME_MEMORY_SAMPLE_S": "2.5"}, {"TPUFRAME_MEMORY_SAMPLE_S": "0.01"},
    {"TPUFRAME_MEMORY_SAMPLE_S": "soon", "TPUFRAME_MEMORY_BUDGET_MB": "-1"},
    {"TPUFRAME_MEMORY_BUDGET_MB": "81920"}, {"TPUFRAME_MEMORY_TOP_LEAVES": "64"},
    {"TPUFRAME_MEMORY_TOP_LEAVES": "65"}, {"TPUFRAME_MEMORY_TOP_LEAVES": "x"},
    {"TPUFRAME_MEMORY_LIVE": "off"}, {"TPUFRAME_MEMORY_LIVE": " FALSE "},
    {"TPUFRAME_MEMORY_LIVE": "yes"}, {"TPUFRAME_MEMORY_LIVE": "   "},
])
def test_memory_env_is_jaxs(env):
    assert memory.memory_env(env) == jax_memory.memory_env(env)


def test_knob_list_and_domains_are_jaxs():
    assert memory.MEMORY_ENV_VARS == jax_memory.MEMORY_ENV_VARS
    assert memory.MEMORY_ENV_DOMAINS == jax_memory.MEMORY_ENV_DOMAINS


def _samples(seed: int, n: int = 40) -> list:
    """(device stats, rss) samples of one or two cards whose usage drifts
    up and down: some steps grow the peak by more than 5 %, most not."""
    rng = np.random.default_rng(seed)
    used = np.cumsum(rng.normal(20.0, 120.0, (n, 2)), axis=0).clip(1.0) + 1000.0
    out = []
    for i in range(n):
        stats = {f"device{d}_mem_used_mb": float(used[i, d]) for d in range(1 + seed % 2)}
        for d in range(1 + seed % 2):
            stats[f"device{d}_mem_util"] = float(used[i, d]) / 81559.0
        out.append((stats, float(rng.uniform(500, 5000))))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_watermark_ratchet_is_jaxs(seed):
    for stats, rss in _samples(seed):
        got = memory.update_watermarks(stats, rss)
        want = jax_memory.update_watermarks(stats, rss)
        assert got == want
    assert memory.peaks() == jax_memory.peaks()
    mine = [e for e in telemetry.get_telemetry().recent_events(500)
            if e["name"] == "memory/watermark"]
    theirs = [e for e in jax_telemetry.get_telemetry().recent_events(500)
              if e["name"] == "memory/watermark"]
    assert mine and [{k: e[k] for k in memory.peaks()} for e in mine] == [
        {k: e[k] for k in memory.peaks()} for e in theirs]
    gauges = ("memory/hbm_peak_mb", "memory/host_peak_mb")
    assert ({g: telemetry.get_telemetry().registry.gauge(g).value for g in gauges}
            == {g: jax_telemetry.get_telemetry().registry.gauge(g).value for g in gauges})


def _oom_cases():
    from tpuframe.fault.chaos import OomError as JaxOomError
    from tpuframe_torch.fault.chaos import OomError

    msg = "chaos: RESOURCE_EXHAUSTED: injected out-of-memory at step step 3 (synthetic, OomAt)"
    return [
        (RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate"),) * 2,
        (RuntimeError("resource exhausted"),) * 2,
        (MemoryError("Out of memory"),) * 2,
        (OomError(msg), JaxOomError(msg)),
        (ValueError("shape mismatch"),) * 2,
        (KeyError("RESOURCE"),) * 2,
    ]


@pytest.mark.parametrize("case", range(6))
def test_is_oom_is_jaxs_on_jaxs_cases(case):
    mine, theirs = _oom_cases()[case]
    assert memory.is_oom(mine) == jax_memory.is_oom(theirs)


def test_torchs_out_of_memory_is_an_oom():
    assert memory.is_oom(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total capacity of 79.19 GiB"))
    assert memory.is_oom(RuntimeError("CUDA out of memory."))
    assert issubclass(torch.cuda.OutOfMemoryError, RuntimeError)
    assert not memory.is_oom(RuntimeError("CUDA error: an illegal memory access"))


MODEL = {"embed": {"embedding": ((32768, 768), "float32")},
         "attn": {"kernel": ((768, 2304), "float32"), "bias": ((2304,), "float32")},
         "head": {"kernel": ((768, 1000), "bfloat16")}}
BATCH = {"image": ((64, 1024), "int32"), "label": ((64, 1024), "int32")}


def _torch_dtypes(tree):
    if isinstance(tree, dict):
        return {k: _torch_dtypes(v) for k, v in tree.items()}
    shape, name = tree
    return (shape, getattr(torch, name))


def _plans(mesh: dict):
    import jax

    from tpuframe.core.runtime import MeshSpec as JaxMeshSpec
    from tpuframe.parallel import ParallelPlan as JaxPlan
    from tpuframe_torch.core.runtime import MeshSpec
    from tpuframe_torch.parallel import ParallelPlan

    n = mesh["data"] * mesh["fsdp"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JaxPlan(mesh=JaxMeshSpec(**mesh).build(jax.devices()[:n])),
                ParallelPlan(mesh=MeshSpec(**mesh).build(n)))


def _oom_event(tele) -> list[dict]:
    return [e for e in tele.recent_events(100) if e["name"] == "memory/oom"]


@pytest.mark.parametrize("mesh", [dict(data=1, fsdp=2), dict(data=4, fsdp=1)])
def test_oom_event_carries_jaxs_keys_estimate_and_ladder(mesh, monkeypatch):
    monkeypatch.setenv("TPUFRAME_MEMORY_BUDGET_MB", "300")
    monkeypatch.delenv("TPUFRAME_COMPILE_CACHE", raising=False)
    jax_plan, plan = _plans(mesh)
    kw = dict(microbatches=2)
    want_est = jax_memory.set_context(plan=jax_plan, model_template=MODEL, batch_spec=BATCH, **kw)
    got_est = memory.set_context(plan=plan, model_template=_torch_dtypes(MODEL),
                                 batch_spec=_torch_dtypes(BATCH), **kw)
    assert got_est == want_est
    err = RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 1.2G")
    assert memory.maybe_oom_event(err, where="step", step=7)
    assert jax_memory.maybe_oom_event(err, where="step", step=7)
    (got,), (want,) = _oom_event(telemetry.get_telemetry()), _oom_event(
        jax_telemetry.get_telemetry())
    assert set(got) == set(want)
    for key in ("where", "step", "error", "estimate_total_mb", "estimate", "budget_mb", "fit"):
        assert got[key] == want[key], key
    assert got["fit"] is not None and got["budget_mb"] == 300.0
    assert telemetry.get_telemetry().registry.counter("memory/oom_total").value == 1


def test_no_event_for_a_non_oom_or_with_the_plane_off(monkeypatch):
    assert not memory.maybe_oom_event(ValueError("bad shape"), where="step")
    monkeypatch.setenv("TPUFRAME_MEMORY_LIVE", "0")
    assert not memory.maybe_oom_event(torch.OutOfMemoryError("CUDA out of memory"),
                                      where="serve/infer")
    assert not _oom_event(telemetry.get_telemetry())


def test_executable_record_of_a_precompiled_step(tmp_path, monkeypatch):
    import tpuframe_torch.compile.precompile as pc
    from tpuframe_torch.compile.precompile import TensorSpec, precompile_step
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import create_train_state, make_train_step

    monkeypatch.setattr(pc, "_BACKEND", "aot_eager")
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", str(tmp_path / "cache"))
    model = TransformerLM(vocab_size=64, num_layers=1, num_heads=2, head_dim=8, max_len=8,
                          device="cpu")
    state = create_train_state(model, fused_adamw(1e-3))
    template = {"image": TensorSpec((2, 8), torch.int64, torch.device("cpu")),
                "label": TensorSpec((2, 8), torch.int64, torch.device("cpu"))}
    exe = precompile_step(make_train_step(), state, template, label="precompile/train@t")
    rec = memory.record_executable_memory(exe)
    jax_keys = set(jax_memory._STAT_FIELDS.values()) | {"label", "peak_mb"}
    assert jax_keys <= set(rec) and set(rec) - jax_keys == {"peak_source"}
    state_bytes = sum(t.numel() * t.element_size() for t in pc._state_tensors(state).values())
    assert rec["argument_mb"] == round((state_bytes + 2 * 2 * 8 * 8) / 2**20, 3)
    assert rec["peak_source"] == "arguments" and rec["temp_mb"] == 0.0  # no peak on the CPU
    assert rec["peak_mb"] == rec["argument_mb"] + rec["output_mb"]
    (ev,) = [e for e in telemetry.get_telemetry().recent_events(50)
             if e["name"] == "memory/executable"]
    assert ev["label"] == "precompile/train@t" and ev["peak_mb"] == rec["peak_mb"]
    memory._EXECUTABLES.clear()  # a fresh process: the persisted record is read back
    assert memory.executable_records()["precompile/train@t"] == rec
    assert memory.record_executable_memory(object()) is None
