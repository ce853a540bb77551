"""Remote MLflow tracking over the REST API (http/https tracking URIs).

Port of ``tpuframe/track/http_store.py`` (stdlib only).  The system this
framework was modelled on logs to a *remote* Databricks-hosted MLflow
server, with every worker re-authenticating from env credentials.
The local file store (``mlflow_store.py``) covers the mlruns-directory
world; this module keeps the same ``Run``/tracker duck-type against any
stock MLflow server using only stdlib HTTP, no mlflow package:

- MLflow REST 2.0: experiments/get-by-name|create, runs/create,
  runs/log-batch (params+metrics, batched), runs/set-tag, runs/update.
- Artifacts: the ``mlflow-artifacts`` proxy (``mlflow server
  --serve-artifacts``) via HTTP PUT; servers without the proxy get the
  upload skipped with a recorded ``tpuframe.artifact_skipped`` tag rather
  than a crashed run.  A model's and a state dict's bytes are the port's
  (``torch.save``, ``mlflow_store.MODEL_FORMAT``).
- Auth from env, the reference's re-auth pattern: Bearer
  ``MLFLOW_TRACKING_TOKEN`` (or ``DATABRICKS_TOKEN``), else Basic
  ``MLFLOW_TRACKING_USERNAME``/``MLFLOW_TRACKING_PASSWORD``.

Select by URI scheme: ``make_tracker("http://host:5000")`` (or pass the
URI to ``MLflowLogger``/``set_experiment``) routes here automatically.
"""

from __future__ import annotations

import base64
import json
import os
import urllib.error
import urllib.request
from typing import Any, Mapping

__all__ = ["HttpError", "HttpExperimentTracker", "HttpRun", "MetricsServer", "is_http_uri",
           "make_tracker"]

_API = "/api/2.0/mlflow"


def _now_ms() -> int:
    import time

    return int(time.time() * 1000)


class HttpError(RuntimeError):
    def __init__(self, status: int, body: str, url: str):
        super().__init__(f"HTTP {status} from {url}: {body[:300]}")
        self.status = status


class _Client:
    """Tiny JSON-over-HTTP client with env-credential auth."""

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _headers(self) -> dict[str, str]:
        h = {"Content-Type": "application/json"}
        token = os.environ.get("MLFLOW_TRACKING_TOKEN") or os.environ.get(
            "DATABRICKS_TOKEN"
        )
        user = os.environ.get("MLFLOW_TRACKING_USERNAME")
        if token:
            h["Authorization"] = f"Bearer {token}"
        elif user:
            pw = os.environ.get("MLFLOW_TRACKING_PASSWORD", "")
            cred = base64.b64encode(f"{user}:{pw}".encode()).decode()
            h["Authorization"] = f"Basic {cred}"
        return h

    def call(self, method: str, path: str, payload: Mapping | None = None) -> dict:
        url = self.base + path
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            url, data=data, method=method, headers=self._headers()
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                body = resp.read()
                return json.loads(body) if body else {}
        except urllib.error.HTTPError as e:
            raise HttpError(e.code, e.read().decode(errors="replace"), url) from None

    def put_bytes(self, path: str, blob: bytes) -> None:
        url = self.base + path
        headers = self._headers()
        headers["Content-Type"] = "application/octet-stream"
        req = urllib.request.Request(url, data=blob, method="PUT", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                return
        except urllib.error.HTTPError as e:
            raise HttpError(e.code, e.read().decode(errors="replace"), url) from None


class HttpRun:
    """Duck-type of :class:`tpuframe_torch.track.mlflow_store.Run` over REST."""

    #: MLflow's runs/log-batch caps: 100 params, 1000 total entities per
    #: request (metrics effectively 1000; we stay under both).
    PARAM_BATCH = 100
    METRIC_BATCH = 900

    def __init__(self, client: _Client, experiment_id: str,
                 run_id: str | None = None, run_name: str | None = None):
        self._client = client
        self.experiment_id = experiment_id
        if run_id is None:
            payload = {
                "experiment_id": experiment_id,
                "start_time": _now_ms(),
                "run_name": run_name or "",
            }
            info = client.call("POST", f"{_API}/runs/create", payload)["run"]["info"]
            run_id = info["run_id"]
            run_name = info.get("run_name", run_name)
        self.run_id = run_id
        self.run_name = run_name or f"run-{run_id[:8]}"

    # -- params / metrics / tags ------------------------------------------
    def _log_batch(self, params=(), metrics=()) -> None:
        params, metrics = list(params), list(metrics)
        while params or metrics:
            take_p, params = params[: self.PARAM_BATCH], params[self.PARAM_BATCH:]
            take_m, metrics = metrics[: self.METRIC_BATCH], metrics[self.METRIC_BATCH:]
            self._client.call(
                "POST", f"{_API}/runs/log-batch",
                {"run_id": self.run_id, "params": take_p, "metrics": take_m},
            )

    def log_param(self, key: str, value: Any) -> None:
        self._log_batch(params=[{"key": key, "value": str(value)}])

    def log_params(self, params: Mapping[str, Any]) -> None:
        self._log_batch(
            params=[{"key": k, "value": str(v)} for k, v in params.items()]
        )

    def log_metric(self, key: str, value: float, step: int = 0) -> None:
        self.log_metrics({key: value}, step)

    def log_metrics(self, metrics: Mapping[str, float], step: int = 0) -> None:
        ts = _now_ms()
        self._log_batch(metrics=[
            {"key": k, "value": float(v), "timestamp": ts, "step": int(step)}
            for k, v in metrics.items()
        ])

    def set_tag(self, key: str, value: Any) -> None:
        self._client.call(
            "POST", f"{_API}/runs/set-tag",
            {"run_id": self.run_id, "key": key, "value": str(value)},
        )

    # -- artifacts ---------------------------------------------------------
    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> str:
        name = os.path.basename(local_path)
        rel = f"{artifact_path}/{name}" if artifact_path else name
        with open(local_path, "rb") as f:
            blob = f.read()
        try:
            self._client.put_bytes(
                f"/api/2.0/mlflow-artifacts/artifacts/"
                f"{self.experiment_id}/{self.run_id}/artifacts/{rel}",
                blob,
            )
        except (HttpError, urllib.error.URLError):
            # server has no artifact proxy: record the gap, don't crash the fit
            self.set_tag("tpuframe.artifact_skipped", rel)
        return rel

    def log_text(self, text: str, artifact_file: str) -> str:
        import shutil
        import tempfile

        d = tempfile.mkdtemp(prefix="tpuframe_http_art_")
        try:
            local = os.path.join(d, os.path.basename(artifact_file))
            with open(local, "w") as f:
                f.write(text)
            sub = os.path.dirname(artifact_file) or None
            return self.log_artifact(local, sub)
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def log_dict(self, data: Mapping[str, Any], artifact_file: str) -> str:
        return self.log_text(
            json.dumps(dict(data), indent=2, default=str), artifact_file
        )

    def log_state_dict(self, tree: Any, artifact_path: str = "state_dict") -> str:
        import shutil
        import tempfile

        from tpuframe_torch.ckpt import save_pytree
        from tpuframe_torch.track.mlflow_store import _model_tree

        d = tempfile.mkdtemp(prefix="tpuframe_http_art_")
        try:
            local = os.path.join(d, "state.msgpack")
            save_pytree(local, _model_tree(tree) if hasattr(tree, "named_parameters") else tree)
            return self.log_artifact(local, artifact_path)
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def log_model(self, state: Any, artifact_path: str = "model",
                  meta: Mapping[str, Any] | None = None) -> str:
        import shutil
        import tempfile

        from tpuframe_torch.ckpt import save_pytree
        from tpuframe_torch.track.mlflow_store import MODEL_FORMAT, _model_tree

        d = tempfile.mkdtemp(prefix="tpuframe_http_model_")
        try:
            save_pytree(os.path.join(d, "model.msgpack"), _model_tree(state))
            self.log_artifact(os.path.join(d, "model.msgpack"), artifact_path)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        self.log_dict(
            {"flavors": {"tpuframe": {"format": MODEL_FORMAT,
                                      "data": "model.msgpack",
                                      **dict(meta or {})}},
             "run_id": self.run_id},
            f"{artifact_path}/MLmodel.json",
        )
        return artifact_path

    # -- lifecycle ---------------------------------------------------------
    def end(self, status: str = "FINISHED") -> None:
        self._client.call(
            "POST", f"{_API}/runs/update",
            {"run_id": self.run_id, "status": status, "end_time": _now_ms()},
        )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.end("FAILED" if exc_type else "FINISHED")


class HttpExperimentTracker:
    """Duck-type of :class:`ExperimentTracker` against a remote server."""

    def __init__(self, tracking_uri: str):
        self.tracking_uri = tracking_uri
        self._client = _Client(tracking_uri)
        self.experiment_id: str | None = None
        self.experiment_name: str | None = None

    def set_experiment(self, name: str) -> str:
        try:
            exp = self._client.call(
                "GET",
                f"{_API}/experiments/get-by-name?experiment_name="
                + urllib.request.quote(name, safe=""),
            )["experiment"]
            self.experiment_id = exp["experiment_id"]
        except HttpError as e:
            if e.status != 404:
                raise
            self.experiment_id = self._client.call(
                "POST", f"{_API}/experiments/create", {"name": name}
            )["experiment_id"]
        self.experiment_name = name
        return self.experiment_id

    def start_run(self, run_name: str | None = None,
                  run_id: str | None = None) -> HttpRun:
        if self.experiment_id is None:
            self.set_experiment("Default")
        return HttpRun(
            self._client, self.experiment_id, run_id=run_id, run_name=run_name
        )


def is_http_uri(tracking_uri: str) -> bool:
    return tracking_uri.startswith(("http://", "https://"))


def make_tracker(tracking_uri: str):
    """File store for paths/file:// URIs, REST client for http(s)://."""
    if is_http_uri(tracking_uri):
        return HttpExperimentTracker(tracking_uri)
    from tpuframe_torch.track.mlflow_store import ExperimentTracker

    return ExperimentTracker(tracking_uri)


class MetricsServer:
    """Prometheus-style scrape endpoint over the telemetry metrics registry.

    Serves ``GET /metrics`` (exposition text from
    ``MetricsRegistry.prometheus_text``) and ``GET /healthz`` from a daemon
    thread — the pull-based half of the telemetry spine's export story
    (the push half is the logger bridge, ``telemetry.publish_to_loggers``).
    ``port=0`` picks a free port; read it back from ``.port``/``.url``.
    """

    def __init__(self, registry=None, host: str = "127.0.0.1", port: int = 0):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if registry is None:
            from tpuframe_torch.track.telemetry import get_telemetry

            registry = get_telemetry().registry
        self.registry = registry
        server_self = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] == "/metrics":
                    body = server_self.registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/healthz":
                    body, ctype = b'{"status": "ok"}', "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tpuframe-metrics", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
