"""``tpuframe_torch.track.http_store`` (the MLflow REST client),
``registry.HttpModelRegistry`` and ``telemetry.start_metrics_server``
against the JAX package's.

A stdlib fake MLflow server on localhost records every request.  The same
calls through both packages' ``HttpExperimentTracker``/``HttpRun`` and
``HttpModelRegistry`` send the same paths and bodies (timestamps masked),
with JAX's handling of a missing experiment (404, then create) and of a
server without the artifact proxy (the ``tpuframe.artifact_skipped`` tag).
A port CPU fit with an ``http://`` tracking URI logs its params, metrics
and final status to the server.  The metrics page serves JAX's text.
"""

import json
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tpuframe_torch.track import http_store, registry, telemetry


class FakeMlflow:
    """Records ``(method, path, body)``; answers what MLflow 2.x answers."""

    def __init__(self, artifacts: bool = True):
        self.requests: list = []
        self.artifacts = artifacts
        self.experiments: dict = {}
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code, payload=None):
                body = json.dumps(payload or {}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                fake.requests.append(("GET", self.path, None))
                if "experiments/get-by-name" in self.path:
                    name = urllib.parse.unquote(self.path.split("experiment_name=")[1])
                    if name not in fake.experiments:
                        return self._reply(404, {"error_code": "RESOURCE_DOES_NOT_EXIST"})
                    return self._reply(200, {"experiment": {
                        "experiment_id": fake.experiments[name]}})
                return self._reply(200, {"model_version": {
                    "version": "2", "run_id": "r" * 32, "source": "runs:/x/model",
                    "creation_timestamp": 7, "aliases": ["champion"]}})

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                fake.requests.append(("POST", self.path, body))
                if self.path.endswith("experiments/create"):
                    fake.experiments[body["name"]] = str(len(fake.experiments) + 1)
                    return self._reply(200, {"experiment_id": fake.experiments[body["name"]]})
                if self.path.endswith("runs/create"):
                    return self._reply(200, {"run": {"info": {
                        "run_id": "0123456789abcdef" * 2, "run_name": body.get("run_name")}}})
                if self.path.endswith("model-versions/create"):
                    return self._reply(200, {"model_version": {"version": "1",
                                                               "creation_timestamp": 5}})
                if self.path.endswith("get-latest-versions"):
                    return self._reply(200, {"model_versions": [{
                        "version": "3", "run_id": "r" * 32, "source": "runs:/y/model"}]})
                return self._reply(200, {})

            def do_PUT(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                blob = self.rfile.read(n)
                fake.requests.append(("PUT", self.path, len(blob)))
                if not fake.artifacts:
                    return self._reply(404, {"error_code": "ENDPOINT_NOT_FOUND"})
                return self._reply(200, {})

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()

    def masked(self) -> list:
        out = []
        for method, path, body in self.requests:
            if isinstance(body, dict):
                body = {k: ("<t>" if k in ("start_time", "end_time") else v)
                        for k, v in body.items()}
                if "metrics" in body:
                    body["metrics"] = [dict(m, timestamp="<t>") for m in body["metrics"]]
            out.append((method, path, body))
        return out


def _drive(mod, url: str, tmp_path) -> None:
    tracker = mod.make_tracker(url)
    tracker.set_experiment("exp one")
    tracker.set_experiment("exp one")  # exists now: found by name
    with tracker.start_run(run_name="r1") as run:
        run.log_param("lr", 0.1)
        run.log_params({f"p{i}": i for i in range(130)})  # two batches of params
        run.log_metric("loss", 1.5, step=3)
        run.log_metrics({f"m{i}": i / 7 for i in range(950)}, step=4)  # two batches
        run.set_tag("k", "v")
        art = tmp_path / "notes.txt"
        art.write_text("hello")
        run.log_artifact(str(art), "docs")
        run.log_text("some text", "dir/t.txt")
        run.log_dict({"a": 1}, "d.json")
    tracker.start_run(run_id="fedcba9876543210" * 2).end("FAILED")


@pytest.mark.parametrize("artifacts", [True, False])
def test_the_rest_calls_are_jaxs(artifacts, tmp_path):
    from tpuframe.track import http_store as jax_http_store

    sent = []
    for mod in (http_store, jax_http_store):
        fake = FakeMlflow(artifacts=artifacts)
        try:
            _drive(mod, fake.url, tmp_path)
        finally:
            fake.close()
        sent.append(fake.masked())
    assert sent[0] == sent[1]
    puts = [r for r in sent[0] if r[0] == "PUT"]
    assert len(puts) == 3
    skipped = [r for r in sent[0] if r[1].endswith("runs/set-tag")
               and r[2]["key"] == "tpuframe.artifact_skipped"]
    assert len(skipped) == (0 if artifacts else 3)


def test_the_model_registry_calls_are_jaxs():
    from tpuframe.track.registry import HttpModelRegistry as JaxHttpModelRegistry

    sent, versions = [], []
    for cls in (registry.HttpModelRegistry, JaxHttpModelRegistry):
        fake = FakeMlflow()
        try:
            reg = cls(fake.url)
            run = type("R", (), {"run_id": "a" * 32})()
            v = [reg.register_model(run, "cifar", "model")]
            reg.set_alias("cifar", "champion", 1)
            v += [reg.get("cifar", "@champion"), reg.get("cifar", 2), reg.latest("cifar")]
            versions.append([(x.name, x.version, x.run_id, x.source, x.aliases) for x in v])
        finally:
            fake.close()
        sent.append(fake.masked())
    assert sent[0] == sent[1] and versions[0] == versions[1]


def test_a_fit_with_an_http_tracking_uri_logs_to_the_server():
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet18
    from tpuframe_torch.track import MLflowLogger
    from tpuframe_torch.train import Trainer

    fake = FakeMlflow()
    try:
        logger = MLflowLogger("port-http", tracking_uri=fake.url)
        model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
        Trainer(model, train_dataloader=DataLoader(SyntheticImageDataset(n=16, image_size=8), 8),
                max_duration="2ba", loggers=[logger], log_interval=1).fit()
    finally:
        fake.close()
    paths = [p for _, p, _ in fake.requests]
    assert paths[:3] == ["/api/2.0/mlflow/experiments/get-by-name?experiment_name=port-http",
                         "/api/2.0/mlflow/experiments/create", "/api/2.0/mlflow/runs/create"]
    batches = [b for m, p, b in fake.requests if p.endswith("runs/log-batch")]
    params = {p["key"] for b in batches for p in b["params"]}
    metrics = {m["key"] for b in batches for m in b["metrics"]}
    assert {"max_duration", "optimizer"} <= params
    assert "train_batch_loss" in metrics or any(k.startswith("train_") for k in metrics)
    assert fake.requests[-1][1].endswith("runs/update")
    assert fake.requests[-1][2]["status"] == "FINISHED"


def test_the_metrics_page_serves_jaxs_text():
    from tpuframe.track import telemetry as jax_telemetry

    pages = []
    for mod in (telemetry, jax_telemetry):
        reg = mod.MetricsRegistry()
        reg.counter("train/steps").inc(3)
        reg.gauge("memory/hbm_peak_mb").set(1234.5)
        for v in (0.1, 0.2, 0.4):
            reg.histogram("span/train/step").observe(v)
        server = mod.start_metrics_server(port=0, registry=reg)
        try:
            with urllib.request.urlopen(server.url, timeout=10) as r:
                page = r.read().decode()
            with urllib.request.urlopen(server.url.replace("/metrics", "/healthz"),
                                        timeout=10) as r:
                health = json.loads(r.read())
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(server.url.replace("/metrics", "/nope"), timeout=10)
        finally:
            server.close()
        pages.append((page, health, type(server).__name__))
    assert pages[0] == pages[1]
    assert "memory_hbm_peak_mb" in pages[0][0] and pages[0][1] == {"status": "ok"}
