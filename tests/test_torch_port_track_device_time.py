"""``tpuframe_torch.track.device_time`` against ``tpuframe.track.device_time``.

- The interval math on seeded random intervals: equal to JAX's, exactly.
- JAX's golden trace (``tests/fixtures/device_trace/``), rewritten in the
  form torch.profiler (Kineto) writes (a device event is one whose ``cat``
  is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, on the device's pid, a
  stream's tid; host ops are ``cpu_op`` events), gives JAX's report
  numbers.
- ``classify_op``: JAX's op names give JAX's classes; CUDA kernel names
  the stated ones (NCCL collective, copies and memsets transfer, every
  other kernel compute), with Kineto's category and by name alone;
  ``_base_name`` folds template arguments, parameters and Inductor's
  numbered suffixes.
- ``profile_env`` over a table of values, and the knob list and domains:
  exactly JAX's.
- Discovery in torch.profiler's layout (the newest file of each worker).
"""

import gzip
import json
import os
import shutil

import numpy as np
import pytest

from tpuframe.track import device_time as jax_dt
from tpuframe_torch.track import device_time as dt

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "device_trace")


def _random_intervals(rng, n):
    starts = rng.uniform(0, 1000, n).round(1)
    return [(float(a), float(a + d)) for a, d in zip(starts, rng.uniform(-5, 80, n).round(1))]


@pytest.mark.parametrize("seed", range(12))
def test_interval_math_is_jaxs_on_random_intervals(seed):
    rng = np.random.default_rng(seed)
    a, b = _random_intervals(rng, 40), _random_intervals(rng, 30)
    ua, ub = dt.interval_union(a), dt.interval_union(b)
    assert ua == jax_dt.interval_union(a) and ub == jax_dt.interval_union(b)
    assert dt.interval_subtract(ua, ub) == jax_dt.interval_subtract(ua, ub)
    assert dt.interval_subtract(ub, ua) == jax_dt.interval_subtract(ub, ua)


def _kineto_form(trace: dict) -> dict:
    """JAX's trace as torch.profiler writes one: each op JAX counts as
    device work a Kineto device event (``gpu_memcpy`` for a transfer,
    ``kernel`` otherwise) on device pid 0, stream 7; every other event a
    host ``cpu_op`` on pid 1234, framing spans included."""
    pnames = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "process_name"}
    tnames = {(e["pid"], e["tid"]): e["args"]["name"] for e in trace["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    out = [{"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "GPU 0"}},
           {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name", "args": {"name": "stream 7"}},
           {"ph": "M", "pid": 1234, "name": "process_name", "args": {"name": "python"}}]
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        on_device = jax_dt._is_exec_track(pnames.get(e["pid"], ""),
                                          tnames.get((e["pid"], e["tid"]), ""))
        cls = jax_dt.classify_op(e["name"]) if on_device else None
        if cls is None:
            out.append(dict(e, pid=1234, tid=1234, cat="cpu_op"))
        else:
            cat = "gpu_memcpy" if cls == "transfer" else "kernel"
            out.append(dict(e, pid=0, tid=7, cat=cat))
    return {"schemaVersion": 1, "traceEvents": out}


@pytest.fixture(scope="module")
def kineto_dir(tmp_path_factory):
    src = jax_dt.find_trace_files(FIXTURE)[0]
    d = tmp_path_factory.mktemp("kineto")
    with gzip.open(d / "host_42.1700000000000.pt.trace.json.gz", "wt") as f:
        json.dump(_kineto_form(jax_dt.load_trace(src)), f)
    return str(d)


@pytest.mark.parametrize("steps,top_k", [(None, 10), (2, 10), (2, 2), (3, 1)])
def test_the_golden_trace_in_kineto_form_gives_jaxs_report(kineto_dir, steps, top_k):
    want = jax_dt.device_time_report(FIXTURE, steps=steps, top_k=top_k)
    got = dt.device_time_report(kineto_dir, steps=steps, top_k=top_k)
    assert got["trace_dir"] == kineto_dir
    assert {**got, "trace_dir": None} == {**want, "trace_dir": None}
    # the fixture's exact numbers (compute 400 µs, collective 200, transfer
    # 50, exposed 150 over a 700 µs window)
    assert got["window_s"] == pytest.approx(700e-6)
    assert got["exposed_comms_s"] == pytest.approx(150e-6)
    assert got["overlap_efficiency"] == pytest.approx(0.25)


def test_device_events_and_their_count(kineto_dir):
    want = jax_dt.device_trace_events(FIXTURE)
    got = dt.device_trace_events(kineto_dir)
    assert [(e["name"], e["class"], e["ts_us"], e["dur_us"]) for e in got] == [
        (e["name"], e["class"], e["ts_us"], e["dur_us"]) for e in want]
    assert {(e["device"], e["thread"]) for e in got} == {("GPU 0", "stream 7")}
    assert dt.count_device_events(kineto_dir) == len(want) == 6
    # a trace of host ops alone: no report, and zero device events
    host_only = {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "cat": "cpu_op",
                                  "name": "aten::mm", "ts": 0, "dur": 5}]}
    assert dt.device_time_report(host_only) is None
    assert dt.count_device_events(host_only) == 0


JAX_NAMES = ["all-reduce.1", "all-gather.17", "reduce-scatter.3", "collective-permute.2",
             "AllReduce.5", "send.1", "recv.9", "infeed.2", "outfeed.1", "copy.44",
             "copy-start.3", "fusion.123", "dot.4", "tanh.5", "", "ThunkExecutor::Execute",
             "Thunk::Run", "$fused_computation", "all-reduce", "ncclAllReduce.2",
             "memcpy.1", "dot.4.remat"]


@pytest.mark.parametrize("name", JAX_NAMES)
def test_classify_op_gives_jaxs_class_on_jaxs_names(name):
    assert dt.classify_op(name) == jax_dt.classify_op(name)


CUDA_NAMES = [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "kernel",
     "collective"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "kernel",
     "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "transfer"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "transfer"),
    ("Memset (Device)", "gpu_memset", "transfer"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "kernel", "compute"),
    ("triton_poi_fused__to_copy_add_mul_12", "kernel", "compute"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_"
     "execute_segment_k_off_kernel__5x_cublas", "kernel", "compute"),
    ("void ln_fwd_chunked<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, long long, int, float)",
     "kernel", "compute"),
    ("void adamw_multi_kernel<float>(Table, Hyper)", "kernel", "compute"),
    ("void tc::attn_fwd_tc<64>(tc::FwdArgs)", "kernel", "compute"),
    ("void (anonymous namespace)::copy_kernel(float*)", "kernel", "compute"),
]


@pytest.mark.parametrize("name,cat,cls", CUDA_NAMES, ids=[f"{c}-{n[:24]}" for n, c, _ in CUDA_NAMES])
def test_classify_op_on_cuda_names(name, cat, cls):
    assert dt.classify_op(name, cat) == cls
    assert dt.classify_op(name) == cls  # by the name alone too


@pytest.mark.parametrize("name,base", [
    ("dot.42", "dot"),
    ("all-reduce.1", "all-reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>)",
     "at::native::vectorized_elementwise_kernel"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 10, false>(float*)",
     "softmax_warp_forward"),
    ("triton_poi_fused_add_3", "triton_poi_fused_add"),
    ("triton_red_fused__to_copy_native_layer_norm_12", "triton_red_fused__to_copy_native_layer_norm"),
    ("void ln_bwd_reduce<__nv_bfloat16>(float const*, int, int, __nv_bfloat16*)", "ln_bwd_reduce"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
])
def test_base_name_folds_instances_templates_and_inductor_numbers(name, base):
    assert dt._base_name(name) == base


def test_the_top_op_table_groups_a_kernel_across_its_instantiations():
    events = [{"ph": "X", "pid": 0, "tid": 7, "cat": "kernel", "ts": i * 10, "dur": 5,
               "name": n} for i, n in enumerate([
                   "void ln_fwd_chunked<float, float>(float const*)",
                   "void ln_fwd_chunked<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 const*)",
                   "triton_poi_fused_add_0", "triton_poi_fused_add_1"])]
    rep = dt.device_time_report({"traceEvents": events})
    assert {(o["name"], o["count"]) for o in rep["top_ops"]} == {
        ("ln_fwd_chunked", 2), ("triton_poi_fused_add", 2)}
    assert rep["classes"]["compute"]["events"] == 4 and rep["idle_s"] == pytest.approx(15e-6)


@pytest.mark.parametrize("env", [
    {}, {"TPUFRAME_PROFILE_STEPS": "4"}, {"TPUFRAME_PROFILE_STEPS": "banana"},
    {"TPUFRAME_PROFILE_EVERY": "-3", "TPUFRAME_PROFILE_KEEP": "5"},
    {"TPUFRAME_PROFILE_STEPS": " 2 ", "TPUFRAME_PROFILE_EVERY": "50",
     "TPUFRAME_PROFILE_KEEP": "2", "TPUFRAME_PROFILE_DIR": " /tmp/prof "},
    {"TPUFRAME_PROFILE_KEEP": "0"}, {"TPUFRAME_PROFILE_DIR": "   "},
    {"TPUFRAME_PROFILE_STEPS": "1.5"},
])
def test_profile_env_is_jaxs(env):
    assert dt.profile_env(env) == jax_dt.profile_env(env)


def test_knob_list_domains_and_version_are_jaxs():
    assert dt.PROFILE_ENV_VARS == jax_dt.PROFILE_ENV_VARS
    assert dt.PROFILE_ENV_DOMAINS == jax_dt.PROFILE_ENV_DOMAINS
    assert dt.DEVICE_TIME_VERSION == jax_dt.DEVICE_TIME_VERSION


def test_discovery_reads_torch_profilers_layout(tmp_path, kineto_dir):
    src = os.path.join(kineto_dir, os.listdir(kineto_dir)[0])
    for name in ("hostA_1.100.pt.trace.json.gz", "hostA_1.300.pt.trace.json.gz",
                 "hostA_1.200.pt.trace.json.gz", "hostB_9.150.pt.trace.json.gz"):
        shutil.copy(src, tmp_path / name)
    files = [os.path.basename(f) for f in dt.find_trace_files(str(tmp_path))]
    assert files == ["hostA_1.300.pt.trace.json.gz", "hostB_9.150.pt.trace.json.gz"]
    rep = dt.device_time_report(str(tmp_path))
    assert rep["device_tracks"] == 2 and rep["window_s"] == pytest.approx(700e-6)
    assert dt.find_trace_files(str(tmp_path / "missing")) == []
    for b in (30, 10, 20):
        (tmp_path / f"capture-b{b:08d}").mkdir()
    assert dt.list_captures(str(tmp_path)) == jax_dt.list_captures(str(tmp_path))
