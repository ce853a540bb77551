"""The MLflow file store and the model registry against the JAX package's.

- The same calls on ``tpuframe.track.MLflowLogger`` and on the port's
  (params, metrics at several steps, tags, text and dict artifacts, nested
  keys that collide and take the ``%`` flat fallback, a state dict and a
  model, FINISHED and FAILED ends, a second experiment through the
  module-level ``set_experiment``/``start_run``) write the same
  ``mlruns/`` tree: the same relative paths (run ids masked), the same
  ``meta.yaml`` keys and values (ids, times and absolute paths masked),
  the same param and tag files and the same metric lines (timestamps
  masked).  One documented difference (ROADMAP Queue 3): the bytes of
  ``model.msgpack`` / ``state.msgpack`` (flax msgpack in JAX,
  ``torch.save`` in the port) and the ``MLmodel`` flavor's ``format``
  that names them.
- A registry round trip: register, alias, reassign and delete an alias
  (the "transition"), resolve ``latest``/``@alias``/numbers and
  ``models:/`` URIs as JAX does, and ``load_model`` gives the logged
  tensors back bit for bit; the registry's files match JAX's the same way.
- ``broadcast_run_id`` on two gloo ranks (``tests/torch_ranks.py``): rank
  0's id on both; at world 1 it returns the id unchanged.

This module imports JAX only inside its tests: the spawned ranks import it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from torch_ranks import run_ranks
from tpuframe_torch.models import MnistNet
from tpuframe_torch.track import (
    MLflowLogger,
    ModelRegistry,
    broadcast_run_id,
    load_model,
    mlflow_store,
    registry,
)


def _drive_logger(track, root: Path, model_state, tree) -> list[str]:
    """The same calls on either package's tracking module; returns the run
    ids in order."""
    ids = []
    logger = track.MLflowLogger("exp", tracking_uri=str(root), run_name="first")
    logger.log_params({"lr": 1e-3, "optimizer": "adam", "nested/key": 3, "bad:chars?": "x"})
    for step in range(3):
        logger.log_metrics({"loss": 1.0 / (step + 1), "system/cpu": 10.0 * step}, step=step)
    logger.log_metrics({"system": 2.5}, step=3)  # collides with the system/ dir: % fallback
    run = logger.run
    run.set_tag("team", "tpu")
    run.log_text("hello\n", "notes/readme.txt")
    run.log_dict({"a": 1, "b": [1, 2]}, "cfg.json")
    run.log_state_dict(tree, artifact_path="epoch_0")
    logger.log_model(model_state, artifact_path="model")
    ids.append(run.run_id)
    assert run.get_param("nested/key") == "3" and run.get_param("missing") is None
    assert [v for _, v, _ in run.get_metric_history("system")] == [2.5]
    assert [s for _, _, s in run.get_metric_history("system/cpu")] == [0, 1, 2]
    logger.flush()
    failed = track.MLflowLogger("exp", tracking_uri=str(root))
    failed.log_metrics({"loss": 9.0})
    ids.append(failed.run.run_id)
    failed.finish(error=RuntimeError("x"))
    track.set_experiment("other", tracking_uri=str(root))
    with track.start_run(run_name="third") as r:
        r.log_metric("acc", 0.5, step=7)
        ids.append(r.run_id)
    return ids


MASKED_META = {"artifact_uri", "artifact_location", "start_time", "end_time", "creation_time",
               "last_update_time", "run_id", "run_uuid", "run_name", "utc_time_created",
               "source"}


def _tree_of(root: Path, ids: list[str]) -> dict:
    """{masked relative path: masked content} of an mlruns tree."""
    out = {}
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = str(path.relative_to(root))
        for i, run_id in enumerate(ids):
            rel = rel.replace(run_id, f"<run{i}>")
        if path.suffix == ".msgpack":
            out[rel] = "<bytes>"
            continue
        text = path.read_text()
        for i, run_id in enumerate(ids):  # the default run name is run-<id[:8]>
            text = text.replace(run_id[:8], f"<run{i}>")
        if path.name in ("meta.yaml", "MLmodel", "aliases.yaml"):
            data = yaml.safe_load(text) or {}
            for key in MASKED_META & set(data):
                data[key] = "<masked>"
            if "flavors" in data:
                data["flavors"]["tpuframe"]["format"] = "<format>"
            out[rel] = data
        elif "/metrics/" in f"/{rel}":
            out[rel] = [line.split(" ", 1)[1] for line in text.splitlines()]
        else:
            out[rel] = text
    return out


def test_the_mlruns_tree_is_the_jax_writers(tmp_path):
    import jax.numpy as jnp

    import tpuframe.track.mlflow_store as jax_track

    model = MnistNet(device="cpu")
    port_ids = _drive_logger(mlflow_store, tmp_path / "port", model,
                             {"params": dict(model.named_parameters())})
    jax_params = {"w": jnp.ones((2, 3)), "b": jnp.zeros(3)}
    jax_ids = _drive_logger(jax_track, tmp_path / "jax", {"w": jnp.ones(2)},
                            {"params": jax_params})
    got, want = _tree_of(tmp_path / "port", port_ids), _tree_of(tmp_path / "jax", jax_ids)
    assert sorted(got) == sorted(want)
    assert got == want
    meta = yaml.safe_load((tmp_path / "port" / "0" / port_ids[0] / "meta.yaml").read_text())
    assert meta["status"] == 3 and meta["artifact_uri"].endswith(f"{port_ids[0]}/artifacts")
    failed = yaml.safe_load((tmp_path / "port" / "0" / port_ids[1] / "meta.yaml").read_text())
    assert failed["status"] == 4
    mlmodel = yaml.safe_load(
        (tmp_path / "port" / "0" / port_ids[0] / "artifacts" / "model" / "MLmodel").read_text())
    assert mlmodel["flavors"]["tpuframe"]["format"] == mlflow_store.MODEL_FORMAT == "torch-save"
    assert (tmp_path / "port" / "0" / port_ids[0] / "metrics" / "%system").is_file()


def test_the_port_refuses_what_waits_for_later_slices(tmp_path):
    # the HTTP store has landed: an http(s) URI gets the REST client, as in
    # JAX (test_torch_port_track_http_store.py logs to a fake server)
    from tpuframe.track.http_store import make_tracker as jax_make_tracker
    from tpuframe_torch.track.http_store import HttpExperimentTracker

    for uri in ("http://localhost:5000", "https://localhost:5443"):
        tracker = mlflow_store.make_tracker(uri)
        assert isinstance(tracker, HttpExperimentTracker) and tracker.tracking_uri == uri
        assert type(tracker).__name__ == type(jax_make_tracker(uri)).__name__
    assert isinstance(mlflow_store.make_tracker(str(tmp_path)), mlflow_store.ExperimentTracker)
    # the system-metrics monitor has landed: it is accepted, and starts
    # with the run (test_torch_port_track_loggers.py holds it against JAX)
    logger = MLflowLogger("e", tracking_uri=str(tmp_path), system_metrics=True)
    assert logger.system_metrics and logger._monitor is None


def test_registry_round_trip_as_jax(tmp_path):
    import jax.numpy as jnp

    import tpuframe.track.mlflow_store as jax_track
    import tpuframe.track.registry as jax_registry

    model = MnistNet(device="cpu", seed=4)
    trees = {}
    for name, track, reg_mod, state in (
            ("port", mlflow_store, registry, model),
            ("jax", jax_track, jax_registry, {"w": jnp.arange(4.0)})):
        root = tmp_path / name
        logger = track.MLflowLogger("reg", tracking_uri=str(root))
        logger.log_model(state)
        run = logger.run
        logger.flush()
        reg = reg_mod.ModelRegistry(str(root))
        v1 = reg.register_model(run, "cifar-net")
        v2 = reg.register_model(run, "cifar-net", tags={"stage": "candidate"})
        reg.set_alias("cifar-net", "champion", v1.version)
        reg.set_alias("cifar-net", "champion", v2.version)  # the alias moves
        reg.set_alias("cifar-net", "old", v1.version)
        reg.delete_alias("cifar-net", "old")
        got = reg.get("cifar-net", "@champion")
        errors = []
        for bad in (lambda: reg.register_model(run, "-bad name"),
                    lambda: reg.get("cifar-net", "@old"),
                    lambda: reg.get("cifar-net", 9),
                    lambda: reg.get("nope"),
                    lambda: reg.get("cifar-net", "v2"),
                    lambda: reg.set_alias("cifar-net", "x", 7)):
            try:
                bad()
                errors.append(None)
            except Exception as e:  # the same type on both sides
                errors.append(type(e).__name__)
        trees[name] = (
            [got.version, got.aliases, got.run_id == run.run_id, reg.versions("cifar-net"),
             reg.latest("cifar-net").version, reg.list_models(), reg.get("cifar-net", "1").version,
             errors],
            _tree_of(root / "models", [run.run_id]))
        if name == "port":
            port_run = run
    assert trees["port"][0] == trees["jax"][0] == [
        2, ("champion",), True, [1, 2], 2, ["cifar-net"], 1,
        ["ValueError", "KeyError", "KeyError", "KeyError", "ValueError", "KeyError"]]
    assert trees["port"][1] == trees["jax"][1]
    for uri in ("models:/cifar-net/2", "models:/cifar-net@champion", "models:/cifar-net",
                "models:/a.b-c/10"):
        assert registry.parse_models_uri(uri) == jax_registry.parse_models_uri(uri)
    for bad in ("runs:/x", "cifar-net"):
        for fn in (registry.parse_models_uri, jax_registry.parse_models_uri):
            with pytest.raises(ValueError, match="not a models:/ URI"):
                fn(bad)
    fresh = MnistNet(device="cpu", seed=5)
    reloaded = load_model("models:/cifar-net@champion", template=fresh,
                          tracking_uri=str(tmp_path / "port"))
    for n, p in model.named_parameters():
        assert torch.equal(reloaded["params"][n], p.detach()), n
    assert reloaded["batch_stats"] == {}
    assert (Path(registry.ModelRegistry(str(tmp_path / "port")).get("cifar-net").path)
            / "model.msgpack").is_file()
    assert port_run.artifact_path("model").startswith(str(tmp_path / "port"))


def _broadcast_rank(rank: int, world: int) -> list:
    from tpuframe_torch.core import initialize

    initialize(device="cpu")
    mine = "f00dcafe" * 4 if rank == 0 else None
    long_id = "x" * 80 if rank == 0 else "ignored"
    return [broadcast_run_id(mine), broadcast_run_id(long_id), broadcast_run_id(None)]


def test_broadcast_run_id_on_two_gloo_ranks(tmp_path):
    got = run_ranks(_broadcast_rank, 2, tmp_path, timeout=90.0)
    assert got[0] == got[1] == ["f00dcafe" * 4, "x" * 64, ""]
    assert broadcast_run_id("abc") == "abc" and broadcast_run_id(None) == ""
