"""The port's serve slice (``tpuframe_torch``) against the JAX package's.

- The whole slice: JAX ``make_predict_fn`` with the fused normalize as its
  ``input_transform`` against the port's, on the same uint8 images and the
  same weights; then the port's ``ServeEngine(device="cpu")`` answers
  requests across buckets, each equal to a direct ``predict``.
- Admission verdicts: one scripted story (queue full under ``reject-new``
  and under ``shed-oldest``, deadline shed, invalid payload, draining) run
  through both engines must give the same verdicts, those that
  ``tests/test_serve.py`` asserts for the JAX engine.
- The HTTP front, the pinned-buffer pool, the shape guard, the precision
  policies and the telemetry record schema.
"""

import contextlib
import functools
import gc
import io
import json
import threading
import time
import urllib.error
import urllib.request
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpuframe.serve as jax_serve
from tpuframe.fault.chaos import ChaosPlan, SlowConsumer
from tpuframe.models import ResNet18 as JaxResNet18
from tpuframe.ops import normalize_images as jax_normalize_images
from tpuframe.parallel import precision as jax_precision
from tpuframe.track import telemetry as jax_telemetry
from tpuframe.train.state import TrainState
from tpuframe.train.step import make_predict_fn as jax_make_predict_fn
import tpuframe_torch.serve as port_serve
from tpuframe_torch.compile.precompile import ShapeGuard, batch_signature
from tpuframe_torch.data.loader import BatchBufferPool
from tpuframe_torch.models import ResNet18, from_jax_variables
from tpuframe_torch.ops import normalize_images
from tpuframe_torch.parallel import precision as port_precision
from tpuframe_torch.track import telemetry as port_telemetry
from tpuframe_torch.train import make_predict_fn

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
PX = 32


def jax_variables(model, x: np.ndarray, seed: int) -> dict:
    """Weights for ``model`` in the JAX layout drawn with numpy from
    ``seed``, with non-trivial BatchNorm scale, bias and running
    statistics."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(seed)
    draw = {
        "mean": lambda s: rng.normal(0.0, 0.2, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.2, s),
        "kernel": lambda s: rng.normal(0.0, np.sqrt(2.0 / np.prod(s[:-1])), s),
    }

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw[k](v.shape).astype(np.float32)
                for k, v in tree.items()}

    return {"params": walk(dict(shapes["params"])),
            "batch_stats": walk(dict(shapes["batch_stats"]))}


def images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, PX, PX, 3), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def slice_pair(policy_name: str):
    """(JAX predict bound to its state, port predict bound to its model) for
    ResNet18 (cifar stem, 8 filters) on the same weights, each with its
    package's fused normalize as the input transform."""
    jpol = jax_precision.get_policy(policy_name)
    jm = jax_precision.align_model_dtype(
        JaxResNet18(num_classes=10, num_filters=8, stem="cifar"), jpol)
    variables = jax_variables(jm, np.zeros((1, PX, PX, 3), np.float32), seed=7)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"], opt_state=(),
        batch_stats=variables["batch_stats"], rng=jax.random.PRNGKey(0),
        apply_fn=jm.apply, tx=optax.identity(),
    )
    jpredict = jax_make_predict_fn(jpol, input_transform=functools.partial(
        jax_normalize_images, mean=MEAN, std=STD, out_dtype=jpol.compute_dtype,
        interpret=True))

    ppol = port_precision.get_policy(policy_name)
    model = ResNet18(num_classes=10, num_filters=8, stem="cifar", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    port_precision.align_model_dtype(model, ppol)
    ppredict = make_predict_fn(ppol, input_transform=functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=ppol.compute_dtype))
    return (lambda x: np.asarray(jpredict(state, jnp.asarray(x))),
            functools.partial(ppredict, model))


# -- the whole slice ---------------------------------------------------------


def test_slice_predict_matches_jax_f32():
    jax_fn, port_fn = slice_pair("fp32")
    x = images(3, seed=0)
    got = port_fn(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 10)
    # CPU conv sums run in another order in the two frameworks
    np.testing.assert_allclose(got.numpy(), jax_fn(x), atol=2e-4, rtol=1e-3)


def test_slice_predict_matches_jax_bf16():
    jax_fn, port_fn = slice_pair("bf16")
    x = images(3, seed=1)
    got = port_fn(torch.from_numpy(x)).numpy()
    want = jax_fn(x)
    # the frameworks round bf16 at other places; a bf16 step is 0.4 %
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_predict_recasts_params_only_after_a_change():
    _, port_fn = slice_pair("bf16")
    model = port_fn.args[0]
    x = torch.from_numpy(images(2, seed=2))
    before = port_fn(x)
    torch.testing.assert_close(port_fn(x), before, rtol=0, atol=0)
    with torch.no_grad():
        model.fc.bias.add_(1.0)
    try:
        # bf16 logits round each shifted value on its own: hold the mean
        shift = float((port_fn(x) - before).mean())
        assert abs(shift - 1.0) < 0.1
    finally:
        with torch.no_grad():
            model.fc.bias.sub_(1.0)


def test_predict_keeps_models_apart_and_lets_them_go():
    """One predict function over two models of the same shape gives each its
    own logits, and holds neither alive once the caller drops it."""
    predict = make_predict_fn(port_precision.bf16_compute())
    x = torch.from_numpy(images(2, seed=5)).float()
    a = ResNet18(num_classes=10, num_filters=8, stem="cifar", device="cpu", seed=1)
    b = ResNet18(num_classes=10, num_filters=8, stem="cifar", device="cpu", seed=2)
    want_a, want_b = predict(a, x), predict(b, x)
    assert not torch.equal(want_a, want_b)
    for _ in range(2):
        torch.testing.assert_close(predict(b, x), want_b, rtol=0, atol=0)
        torch.testing.assert_close(predict(a, x), want_a, rtol=0, atol=0)
    gone = weakref.ref(a)
    del a
    gc.collect()
    assert gone() is None
    # a new model built where the old one was freed is cast afresh
    c = ResNet18(num_classes=10, num_filters=8, stem="cifar", device="cpu", seed=3)
    fresh = make_predict_fn(port_precision.bf16_compute())
    torch.testing.assert_close(predict(c, x), fresh(c, x), rtol=0, atol=0)


def test_engine_on_cpu_answers_each_request_as_direct_predict():
    _, port_fn = slice_pair("fp32")
    reg = port_telemetry.get_telemetry().registry
    recompiles0 = reg.counter("compile/recompiles").value
    xs = images(11, seed=3)
    knobs = port_serve.ServeKnobs(buckets=(1, 2, 4), batch_wait_ms=2.0, slo_ms=60_000)
    with port_serve.ServeEngine(port_fn, knobs=knobs, item_shape=(PX, PX, 3),
                                dtype="uint8", device="cpu") as eng:
        assert eng.device == torch.device("cpu")
        futures = [eng.submit(x) for x in xs]
        outs = [f.result(timeout=60) for f in futures]
    assert {f.verdict for f in futures} == {"ok"}
    for x, out in zip(xs, outs):
        assert tuple(out.shape) == (10,)
        direct = port_fn(torch.from_numpy(x[None]))[0]
        # batch shape changes the CPU conv's blocking, hence its sum order
        torch.testing.assert_close(out, direct, atol=1e-5, rtol=1e-4)
    assert reg.counter("compile/recompiles").value == recompiles0


# -- admission verdicts: one story through both engines ----------------------


class _Gate:
    """Port backend that doubles its input and, while armed, blocks its
    next call until released."""

    def __init__(self):
        self.armed = False
        self.entered = threading.Event()
        self.released = threading.Event()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.armed:
            self.armed = False
            self.entered.set()
            self.released.wait(30)
        return x.reshape(x.shape[0], -1) * 2.0


def _engine(side: str, *, queue_cap: int, shed_policy: str = "reject-new"):
    """(engine, hold, let_go) for ``side``: inside ``hold()`` the engine's
    first batch stalls, on the JAX side for one second (its chaos stall),
    on the port's until ``let_go()``."""
    pkg = jax_serve if side == "jax" else port_serve
    knobs = pkg.ServeKnobs(buckets=(1,), batch_wait_ms=0.0, slo_ms=60_000,
                           queue_cap=queue_cap, shed_policy=shed_policy)
    if side == "jax":
        eng = jax_serve.ServeEngine(lambda x: x.reshape(x.shape[0], -1) * 2.0,
                                    knobs=knobs, item_shape=(4, 3), dtype="float32")
        return (eng, lambda: ChaosPlan([SlowConsumer(step=0, stall_s=1.0)]).active(),
                lambda: None)
    gate = _Gate()
    eng = port_serve.ServeEngine(gate, knobs=knobs, item_shape=(4, 3),
                                 dtype="float32", device="cpu")

    @contextlib.contextmanager
    def hold():
        gate.armed = True
        try:
            yield
        finally:
            gate.released.set()

    return eng, hold, gate.released.set


def _verdict(fn) -> str:
    """``ok``, or the verdict of the typed error ``fn`` raised."""
    try:
        fn()
    except (jax_serve.RequestRejected, jax_serve.RequestShed,
            port_serve.RequestRejected, port_serve.RequestShed) as e:
        return e.verdict
    except (jax_serve.InvalidRequest, port_serve.InvalidRequest):
        return "invalid"
    return "ok"


def _wait_until_batch_zero_runs(eng) -> None:
    t0 = time.monotonic()
    while eng.queue_depth() and time.monotonic() - t0 < 10:
        time.sleep(0.005)


def verdict_story(side: str, shed_policy: str) -> list[str]:
    """A queue of two behind a stalled batch takes a third request; a
    deadline expires in the queue; a bad shape and a NaN payload reach the
    door; a drained engine takes one more."""
    x = np.ones((4, 3), np.float32)
    eng, hold, let_go = _engine(side, queue_cap=2, shed_policy=shed_policy)
    verdicts = []
    with eng, hold():
        f0 = eng.submit(x)
        _wait_until_batch_zero_runs(eng)
        f1, f2 = eng.submit(x), eng.submit(x)
        third = []
        verdicts.append(_verdict(lambda: third.append(eng.submit(x))))
        let_go()
        for f in (f0, f1, f2, *third):
            verdicts.append(_verdict(lambda f=f: f.result(timeout=30)))
    eng, hold, let_go = _engine(side, queue_cap=8)
    with eng, hold():
        f0 = eng.submit(x)
        _wait_until_batch_zero_runs(eng)
        late = eng.submit(x, deadline_ms=50)
        time.sleep(0.1)  # the deadline passes while batch 0 stalls
        let_go()
        verdicts += [_verdict(lambda: f0.result(timeout=30)),
                     _verdict(lambda: late.result(timeout=30))]
        bad_nan = x.copy()
        bad_nan[0, 0] = np.nan
        verdicts += [_verdict(lambda: eng.submit(np.ones((5, 3), np.float32))),
                     _verdict(lambda: eng.submit(bad_nan))]
    verdicts.append(_verdict(lambda: eng.submit(x)))
    return verdicts


TAIL = ["ok", "shed-deadline", "invalid", "invalid", "rejected-draining"]
STORIES = [
    ("reject-new", ["rejected-queue-full", "ok", "ok", "ok"] + TAIL),
    ("shed-oldest", ["ok", "ok", "shed-oldest", "ok", "ok"] + TAIL),
]


@pytest.mark.parametrize("story", STORIES, ids=[s[0] for s in STORIES])
def test_admission_verdicts_match_the_jax_engine(story):
    shed_policy, expected = story
    assert verdict_story("port", shed_policy) == expected
    assert verdict_story("jax", shed_policy) == expected


def test_backend_error_fails_only_its_batch():
    calls = []

    def flaky(x):
        calls.append(len(x))
        if len(calls) == 2:  # the first served batch, after the warm-up
            raise OSError("backend down")
        return x.reshape(x.shape[0], -1) * 2.0

    knobs = port_serve.ServeKnobs(buckets=(1,), batch_wait_ms=0.0, slo_ms=60_000)
    x = np.ones((4, 3), np.float32)
    with port_serve.ServeEngine(flaky, knobs=knobs, item_shape=(4, 3),
                                dtype="float32", device="cpu") as eng:
        f1 = eng.submit(x)
        with pytest.raises(OSError, match="backend down"):
            f1.result(timeout=10)
        assert f1.verdict == "error"
        np.testing.assert_array_equal(eng.submit(x).result(timeout=10), 2.0 * x.reshape(-1))


def test_engine_requires_a_signature():
    with pytest.raises(ValueError, match="item_shape"):
        port_serve.ServeEngine(lambda x: x, device="cpu")


# -- the HTTP front ----------------------------------------------------------


def _post(url: str, body: bytes, headers=None):
    req = urllib.request.Request(url + "/predict", data=body, method="POST",
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=30)


def test_http_predict_health_metrics_and_drain():
    knobs = port_serve.ServeKnobs(buckets=(1, 2), slo_ms=60_000)
    eng = port_serve.ServeEngine(lambda x: x.reshape(x.shape[0], -1) * 2.0, knobs=knobs,
                                 item_shape=(4, 3), dtype="float32", device="cpu").start()
    srv = port_serve.ServingServer(eng)
    try:
        x = np.random.default_rng(3).random((4, 3), dtype=np.float32)
        buf = io.BytesIO()
        np.save(buf, x)
        with _post(srv.url, buf.getvalue(), {"X-Deadline-Ms": "5000",
                                             "X-Trace-Id": "req-1"}) as resp:
            assert resp.status == 200 and resp.headers["X-Trace-Id"] == "req-1"
            body = json.loads(resp.read())
        np.testing.assert_allclose(np.asarray(body["output"], np.float32),
                                   2.0 * x.reshape(-1), rtol=1e-6)
        assert body["verdict"] == "ok" and body["latency_ms"] > 0
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as resp:
            assert "tpuframe_serve_requests_served" in resp.read().decode()
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(srv.url, b"not-npy")
        assert bad.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as big:
            _post(srv.url, b"x" * (srv.max_body_bytes + 1))
        assert big.value.code == 413
        eng.drain(timeout=10)
        with pytest.raises(urllib.error.HTTPError) as draining:
            _post(srv.url, buf.getvalue())
        assert draining.value.code == 503 and draining.value.headers["Retry-After"]
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "draining"
    finally:
        srv.close()
        eng.stop()


# -- the pieces under the engine ---------------------------------------------


def test_pool_recycles_leases_and_drops_them_on_a_shape_change():
    reg = port_telemetry.get_telemetry().registry
    allocs = reg.counter("data/ring_allocs")
    pool = BatchBufferPool(2)
    a0 = allocs.value
    lease = pool.acquire(4, (3, 3, 3), np.uint8)
    assert lease.images.dtype == torch.uint8 and tuple(lease.images.shape) == (4, 3, 3, 3)
    assert not lease.images.is_pinned()
    lease.images_np[...] = 7  # a numpy view of the same buffer
    assert int(lease.images.sum()) == 7 * lease.images.numel()
    assert pool.release(lease, copy_done=None)
    assert pool.acquire(4, (3, 3, 3), np.uint8) is lease
    assert allocs.value == a0 + 1
    assert pool.release(lease)
    other = pool.acquire(2, (3, 3, 3), np.uint8)
    assert other is not lease and allocs.value == a0 + 2
    assert not pool.release(lease)  # a lease of the old shape is dropped


def test_shape_guard_counts_one_recompile_per_new_signature():
    reg = port_telemetry.get_telemetry().registry
    c = reg.counter("compile/recompiles")
    guard = ShapeGuard()
    sig = batch_signature({"image": torch.zeros(2, 4, 4, 3, dtype=torch.uint8)})
    assert sig == batch_signature({"image": np.zeros((2, 4, 4, 3), np.uint8)})
    assert sig == (("image", (2, 4, 4, 3), "uint8"),)
    c0 = c.value
    assert not guard.check("serve", sig)  # disarmed: records only
    guard.expect("serve", sig)
    assert guard.check("serve", sig)
    other = batch_signature({"image": np.zeros((3, 4, 4, 3), np.uint8)})
    assert not guard.check("serve", other) and guard.check("serve", other)
    assert c.value == c0 + 1


@pytest.mark.parametrize("name", ["fp32", "float32", "bf16", "bfloat16", "pure_bf16"])
def test_named_policies_match_jax(name):
    j, p = jax_precision.get_policy(name), port_precision.get_policy(name)
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(p, field)).removeprefix("torch.") == jnp.dtype(getattr(j, field)).name
    cast = p.cast_batch({"x": torch.zeros(2), "y": torch.zeros(2, dtype=torch.int32)})
    assert cast["x"].dtype == p.compute_dtype and cast["y"].dtype == torch.int32
    with pytest.raises(ValueError, match="unknown precision policy"):
        port_precision.get_policy("fp8")


def test_telemetry_records_share_the_jax_schema(tmp_path):
    """A span and an event written by either package carry the same keys,
    so one analyzer reads logs from both."""
    records = {}
    for side, mod in (("jax", jax_telemetry), ("port", port_telemetry)):
        tele = mod.Telemetry(str(tmp_path / f"{side}.jsonl"), rank=0)
        with tele.span("serve/infer", batch=0):
            pass
        tele.event("serve/request", latency_s=0.001, verdict="ok")
        tele.close()
        lines = [json.loads(s) for s in (tmp_path / f"{side}.jsonl").read_text().splitlines()]
        records[side] = [(r["kind"], r["name"], sorted(r)) for r in lines]
    assert records["port"] == records["jax"]
    assert [r[1] for r in records["port"]] == ["telemetry/meta", "serve/infer", "serve/request"]
