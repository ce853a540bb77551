"""``core.config`` and ``core.workspace`` against the JAX package's.

The port keeps its own copy of both (stdlib and ``yaml``: it imports
nothing of the JAX package).  Each case of ``tests/test_config.py`` runs on
both packages, and what it returns must be equal: values, dicts, YAML
text, created paths (relative to the case's own directory) and, where a
case raises, the exception type.  Exact equality: the code is the same
logic over the same inputs.
"""

import os

import pytest

import tpuframe.core.config as jax_config
import tpuframe.core.workspace as jax_workspace
import tpuframe_torch.core.config as port_config
import tpuframe_torch.core.workspace as port_workspace
from tpuframe_torch.core import AUTO, Config, Workspace, export_worker_env, load_config


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the case compares what each package raises
        return type(e).__name__
    return None


def attribute_and_item_access(m, tmp, mp):
    cfg = m.Config({"train": {"batch_size": 128, "opt": {"lr": 1e-3}}})
    out = [cfg.train.batch_size, cfg["train"]["opt"]["lr"]]
    cfg.train.batch_size = 64
    out.append(cfg["train"]["batch_size"])
    out.append(_raises(lambda: cfg.nope))
    del cfg.train
    out.append(_raises(lambda: delattr(cfg, "train")))
    return out


def nested_assignment_wraps(m, tmp, mp):
    cfg = m.Config()
    cfg.data = {"cache": "/x", "sub": {"a": 1}, "items": [{"b": 2}]}
    return [type(cfg.data).__name__, cfg.data.sub.a, type(cfg.data["items"][0]).__name__,
            cfg.to_dict()]


def deep_merge_later_wins(m, tmp, mp):
    base = m.Config({"a": {"x": 1, "y": 2}, "b": 3})
    out = base.merged({"a": {"y": 20, "z": 30}}, {"b": {"c": 1}})
    return [out.to_dict(), base.to_dict()]


def dotted_paths(m, tmp, mp):
    cfg = m.Config({"stages": [{"w": 1}, {"w": 2}]})
    cfg.set_path("zero.stage", 2)
    cfg.set_path("stages.1.w", 5)
    return [cfg.zero.stage, cfg.get_path("zero.stage"), cfg.get_path("zero.missing", "d"),
            cfg.get_path("stages.1.w"), cfg.get_path("stages.7.w", "none"), cfg.flat()]


def yaml_round_trip(m, tmp, mp):
    cfg = m.Config({"catalog": "main", "num_nodes": 4, "train": {"bf16": True, "lr": 1e-3}})
    text = cfg.to_yaml(tmp / "cfg.yaml")
    back = m.Config.from_yaml(tmp / "cfg.yaml")
    (tmp / "empty.yaml").write_text("")
    (tmp / "list.yaml").write_text("- 1\n- 2\n")
    return [text, back.to_dict() == cfg.to_dict(), m.Config.from_yaml(tmp / "empty.yaml"),
            _raises(lambda: m.Config.from_yaml(tmp / "list.yaml")),
            m.Config.from_json('{"a": {"b": [1, 2]}}').to_dict()]


def env_overlay(m, tmp, mp):
    mp.setenv("TPUFRAME_TRAIN__BATCH_SIZE", "256")
    mp.setenv("TPUFRAME_TRAIN__BF16", "true")
    mp.setenv("TPUFRAME_TRAIN__NAME", "a: [")  # not yaml: the raw string
    mp.setenv("OTHER_VAR", "1")
    cfg = m.Config({"train": {"batch_size": 1}}).overlay_env()
    return [cfg.train.batch_size, cfg.train.bf16, cfg.train.name, "other_var" in cfg]


def auto_resolution(m, tmp, mp):
    cfg = m.Config({"train_batch_size": m.AUTO, "zero": {"reduce_bucket_size": m.AUTO},
                    "lr": 1e-3})
    out = cfg.resolve_auto({"train_batch_size": lambda c: 512, "zero.*": lambda c: 5e8})
    loose = cfg.resolve_auto({"train_batch_size": lambda c: 1}, strict=False)
    return [sorted(cfg.auto_paths()), out.to_dict(), loose.to_dict(),
            _raises(lambda: cfg.resolve_auto({"train_batch_size": lambda c: 1}))]


def load_config_layering(m, tmp, mp):
    path = tmp / "local.yaml"
    path.write_text("catalog: main\nnum_nodes: 2\n")
    mp.setenv("TPUFRAME_NUM_NODES", "8")
    cfg = m.load_config(path, overrides={"num_nodes": 4, "extra": 1})
    bare = m.load_config(overrides={"x": 1}, env_prefix="")
    return [cfg.to_dict(), bare.to_dict()]


def auto_inside_lists(m, tmp, mp):
    cfg = m.Config({"stages": [{"bucket": m.AUTO}, {"bucket": 1}]})
    out = cfg.resolve_auto({"stages.*.bucket": lambda c: 5e8})
    return [cfg.auto_paths(), out.stages[0].bucket, _raises(lambda: cfg.resolve_auto({}))]


def env_overlay_conflict(m, tmp, mp):
    mp.setenv("TPUFRAME_TRAIN", "fast")
    mp.setenv("TPUFRAME_TRAIN__LR", "0.1")
    return _raises(lambda: m.Config().overlay_env())


def workspace_layout(m, tmp, mp):
    ws = m.Workspace(str(tmp / "ws"))
    ws2 = m.Workspace(str(tmp / "ws"))
    paths = [ws.checkpoints, ws.mlruns, ws.dataset_dir("cifar10"), ws.shards_dir("tiny"),
             ws.run_dir("exp1")]
    assert ws.checkpoints == ws2.checkpoints and all(os.path.isdir(p) for p in paths)
    marker = (tmp / "ws" / ".tpuframe-workspace").read_text()
    return [os.path.relpath(p, tmp) for p in paths] + [marker]


def workspace_local_scratch(m, tmp, mp):
    mp.setenv("TPUFRAME_LOCAL_SCRATCH", str(tmp / "scratch"))
    mp.setenv("TPUFRAME_PROCESS_ID", "3")
    first = m.Workspace(str(tmp / "ws")).local_scratch("stream")
    mp.delenv("TPUFRAME_PROCESS_ID")
    mp.setenv("RANK", "5")
    second = m.Workspace(str(tmp / "ws")).local_scratch()
    return [os.path.relpath(first, tmp), os.path.relpath(second, tmp)]


def worker_env(m, tmp, mp):
    mp.delenv("MLFLOW_TRACKING_TOKEN", raising=False)
    m.export_worker_env({"MLFLOW_TRACKING_TOKEN": "tok"})
    first = os.environ["MLFLOW_TRACKING_TOKEN"]
    m.export_worker_env({"MLFLOW_TRACKING_TOKEN": "other", "TPUFRAME_X": 3}, overwrite=False)
    out = [first, os.environ["MLFLOW_TRACKING_TOKEN"], os.environ["TPUFRAME_X"]]
    mp.delenv("MLFLOW_TRACKING_TOKEN")
    mp.delenv("TPUFRAME_X")
    return out


CASES = [attribute_and_item_access, nested_assignment_wraps, deep_merge_later_wins,
         dotted_paths, yaml_round_trip, env_overlay, auto_resolution, load_config_layering,
         auto_inside_lists, env_overlay_conflict]
WORKSPACE_CASES = [workspace_layout, workspace_local_scratch, worker_env]


class _Both:
    """One package's names, as the cases use them."""

    def __init__(self, config, workspace):
        self.Config, self.AUTO, self.load_config = config.Config, config.AUTO, config.load_config
        self.Workspace, self.export_worker_env = workspace.Workspace, workspace.export_worker_env


@pytest.mark.parametrize("case", CASES + WORKSPACE_CASES, ids=lambda c: c.__name__)
def test_case_gives_what_jax_gives(case, tmp_path, monkeypatch):
    got = {}
    for name, mods in (("jax", (jax_config, jax_workspace)), ("port", (port_config,
                                                                      port_workspace))):
        d = tmp_path / name
        d.mkdir()
        with monkeypatch.context() as mp:
            got[name] = case(_Both(*mods), d, mp)
    assert got["port"] == got["jax"]


def test_the_core_package_exports_them():
    assert Config is port_config.Config and AUTO == jax_config.AUTO == "auto"
    assert load_config is port_config.load_config
    assert Workspace is port_workspace.Workspace
    assert export_worker_env is port_workspace.export_worker_env
    assert port_workspace.PERF_ENV_VARS == jax_workspace.PERF_ENV_VARS
    assert port_workspace.PERF_ENV_DOMAINS == jax_workspace.PERF_ENV_DOMAINS
    assert port_workspace.LAYOUT_VERSION == jax_workspace.LAYOUT_VERSION
