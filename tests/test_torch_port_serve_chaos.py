"""The port's serve chaos sites, flood and preemption drain (the
counterparts of ``tests/test_serve.py``'s ``TestChaosAcceptance`` and
``TestServeWatchdog``), on the CPU over the same linear model.

- ``QueueFlood`` overloads the bounded queue: sheds fire, and the admitted
  requests' p99 stays within the SLO.
- ``PoisonRequest`` is rejected at the door and its would-be batchmates'
  outputs are bit-equal to a clean run's (and within 1e-5 of ``x @ W``).
- A preemption notice mid-load drains with zero dropped in-flight
  requests; new ones get ``rejected-draining``.
- ``SlowConsumer`` past the ``serve/infer`` deadline trips the serve
  watchdog.
- ``ServingServer.run_forever`` returns on a watcher's notice, with the
  engine drained and the HTTP front closed.

The story of each case is also run through the JAX engine, which must
give the same verdicts.
"""

import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tpuframe.serve as jax_serve
from tpuframe.fault import chaos as jax_chaos
from tpuframe.fault import preempt as jax_preempt
from tpuframe_torch.fault import ChaosPlan, PoisonRequest, QueueFlood, SlowConsumer
from tpuframe_torch.fault import preempt
from tpuframe_torch.serve import (
    InvalidRequest,
    RequestRejected,
    RequestShed,
    ServeEngine,
    ServeKnobs,
    ServingServer,
)
from tpuframe_torch.track import telemetry as T
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.track.watchdog import Watchdog

W = np.random.RandomState(42).rand(12, 5).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_watcher():
    preempt.uninstall()
    jax_preempt.uninstall()
    yield
    preempt.uninstall()
    jax_preempt.uninstall()


def _engine(side="port", **over):
    kn = dict(buckets=(1, 4), slo_ms=5000, queue_cap=16, batch_wait_ms=1.0)
    kn.update(over)
    if side == "jax":
        return jax_serve.ServeEngine(lambda x: x.reshape(x.shape[0], -1) @ W,
                                     knobs=jax_serve.ServeKnobs(**kn), item_shape=(4, 3),
                                     dtype="float32")
    w = torch.from_numpy(W)
    return ServeEngine(lambda x: x.reshape(x.shape[0], -1) @ w, knobs=ServeKnobs(**kn),
                       item_shape=(4, 3), dtype="float32", device="cpu")


def _x(i):
    return np.random.RandomState(i).rand(4, 3).astype(np.float32)


def test_queue_flood_sheds_and_p99_holds_the_slo():
    reg = get_telemetry().registry
    slo_ms = 2000.0
    eng = _engine(queue_cap=8, shed_policy="shed-oldest", slo_ms=slo_ms)
    shed0 = reg.counter("serve/shed").value
    plan = ChaosPlan([QueueFlood(120, step=3)])
    lats = []
    with eng, plan.active():
        for i in range(40):
            try:
                f = eng.submit(_x(i))
                f.result(timeout=20)
            except (RequestRejected, RequestShed):
                continue
            lats.append(f.latency_s)
    assert plan.fired_count() == 1
    assert reg.counter("serve/shed").value > shed0
    assert lats, "every client request was lost under overload"
    lats.sort()
    p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
    assert p99 * 1e3 <= slo_ms, f"admitted p99 {p99 * 1e3:.0f} ms > SLO"
    names = [e.get("name") for e in get_telemetry().recent_events(500)]
    assert "serve/shed" in names and "serve/flood" in names


def test_flood_admits_as_the_jax_engine_does():
    """The hook alone, on an engine whose batcher holds: the same admitted
    count and queue depth on both sides."""
    out = {}
    for side in ("port", "jax"):
        eng = _engine(side, queue_cap=8, shed_policy="reject-new").start()
        try:
            out[side] = (eng.flood(20), eng.queue_depth() <= 8)
        finally:
            eng.stop()
    assert out["port"] == out["jax"]


def _poisoned(side):
    eng = _engine(side, batch_wait_ms=5.0)
    if side == "jax":
        plan = jax_chaos.ChaosPlan([jax_chaos.PoisonRequest(step=2)])
        invalid = jax_serve.InvalidRequest
    else:
        plan, invalid = ChaosPlan([PoisonRequest(step=2)]), InvalidRequest
    results, poisoned = {}, []

    def client(i):
        try:
            results[i] = np.asarray(eng.submit(_x(i)).result(timeout=20))
        except invalid:
            poisoned.append(i)

    with eng, plan.active():
        threads = []
        for i in range(6):  # submits in order, so step 2 hits one request
            t = threading.Thread(target=client, args=(i,))
            t.start()
            t.join(timeout=0.02)
            threads.append(t)
        for t in threads:
            t.join(timeout=20)
    return poisoned, results


def test_poison_request_rejected_and_batchmates_unaffected():
    poisoned, results = _poisoned("port")
    assert poisoned == [2] and sorted(results) == [0, 1, 3, 4, 5]
    clean = _engine(batch_wait_ms=5.0)
    with clean:
        want = {i: np.asarray(clean.submit(_x(i)).result(timeout=20)) for i in results}
    for i, out in results.items():
        assert out.tobytes() == want[i].tobytes(), f"batch-mate {i} moved"
        np.testing.assert_allclose(out, _x(i).reshape(-1) @ W, rtol=1e-5)
    assert _poisoned("jax")[0] == poisoned


def test_preemption_notice_drains_with_zero_dropped_inflight():
    watcher = preempt.install(signals=(signal.SIGUSR1,))
    eng = _engine(buckets=(1,), batch_wait_ms=0.0)
    with eng:
        with ChaosPlan([SlowConsumer(step=0, stall_s=0.2)]).active():
            futs = [(x, eng.submit(x)) for x in map(_x, range(6))]
            os.kill(os.getpid(), signal.SIGUSR1)  # the platform reclaims the machine
            deadline = time.monotonic() + 10
            while not eng.draining and time.monotonic() < deadline:
                time.sleep(0.01)  # the batcher drains on its own at a batch boundary
            assert eng.draining, "no auto-drain on the notice"
            assert eng.drain(timeout=20), "drain did not complete"
            for x, f in futs:
                np.testing.assert_allclose(np.asarray(f.result(timeout=1)),
                                           x.reshape(-1) @ W, rtol=1e-5)
            with pytest.raises(RequestRejected, match="rejected-draining"):
                eng.submit(_x(0))
    assert watcher.reason == "signal:SIGUSR1"
    events = get_telemetry().recent_events(500)
    drains = [e for e in events if e.get("name") == "serve/drain"]
    assert any(e["reason"] == "preempt:signal:SIGUSR1" for e in drains)
    drained = [e for e in events if e.get("name") == "serve/drained"]
    assert drained and drained[-1]["served"] >= 6


def test_slow_consumer_trips_the_serve_watchdog(tmp_path):
    wd = Watchdog(deadlines={"serve/infer": 0.1}, poll_interval_s=0.05)
    T.configure(jsonl_dir=str(tmp_path), watchdog=wd)
    try:
        eng = _engine(buckets=(1,), batch_wait_ms=0.0, watchdog_s=0.1)
        plan = ChaosPlan([SlowConsumer(step=0, stall_s=0.5)])
        with eng, plan.active():
            eng.submit(np.zeros((4, 3), np.float32)).result(timeout=10)
        assert plan.fired_count() == 1
        assert any(r["name"] == "serve/infer" for r in wd.reports)
    finally:
        T.reset()


def test_run_forever_drains_on_a_notice():
    watcher = preempt.install(signals=())
    eng = _engine(buckets=(1,), batch_wait_ms=0.0)
    eng.start()
    srv = ServingServer(eng)
    done = threading.Thread(target=srv.run_forever, kwargs={"poll_s": 0.02}, daemon=True)
    futs = [(x, eng.submit(x)) for x in map(_x, range(4))]
    done.start()
    watcher.request("drain")
    done.join(timeout=20)
    assert not done.is_alive()
    assert eng.draining and all(f.done() for _, f in futs)
    for x, f in futs:
        np.testing.assert_allclose(np.asarray(f.result(timeout=1)), x.reshape(-1) @ W,
                                   rtol=1e-5)
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(srv.url + "/healthz", timeout=2)
