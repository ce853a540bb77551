"""The port's precompile (``tpuframe_torch.compile.precompile``) and the
Trainer's compile spine, on the CPU, against the JAX package's.

- ``loader_batch_template``: its signature is JAX's on the same loader
  spec (plain, MixUp, ``drop_last=False``, ``grad_accum=2``), exact once
  JAX's x64-off pipeline is taken into account (a class id reaches JAX's
  step as int32, the port's as numpy's int64), and it is the port's own
  first batch's, exact.  A duck-typed loader gives None.
- A precompiled fit (``Trainer(precompile=True)``: the steps' model regions
  compiled, dispatched on a signature match) against JAX's precompiled
  fit on weights carried by ``from_jax_variables``, at the tolerance of
  ``test_fit_matches_the_jax_trainer``.  The mechanics tests compile with
  ``aot_eager`` (``precompile._BACKEND``): no code generation.
- The warm-up runs on the live state and restores it bit for bit.
- ``precompile()`` is synchronous and idempotent; the shape guard fires
  once on a stray shape, the executable takes the matching batches; a
  step precompile does not cover (dropout) is reported ``skipped``.
- ``TPUFRAME_PRECOMPILE`` opts in (the port's default is off: ROADMAP
  Queue 3, difference 31).
- An in-process ``Supervisor`` restart with Inductor and the persistent
  cache: attempt 2 makes no backend compile and hits the cache from its
  ``on_fit_start`` on, and ``fault/restart`` carries the directory.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

import tpuframe_torch.compile.precompile as pc
from tpuframe.compile.precompile import batch_signature as jax_signature
from tpuframe.compile.precompile import loader_batch_template as jax_template
from tpuframe.data import DataLoader as JaxDataLoader
from tpuframe.data.datasets import SyntheticImageDataset as JaxSynthetic
from tpuframe.models import MnistNet as JaxMnistNet
from tpuframe.models import ResNet18 as JaxResNet18
from tpuframe.train.algorithms import MixUp as JaxMixUp
from tpuframe.train.trainer import Trainer as JaxTrainer
from tpuframe_torch.compile import cache as cc
from tpuframe_torch.compile.precompile import (
    TensorSpec,
    abstract_state,
    batch_signature,
    loader_batch_template,
    precompile_enabled,
    precompile_step,
)
from tpuframe_torch.data import DataLoader, SyntheticImageDataset
from tpuframe_torch.models import MnistNet, ResNet18, TransformerLM, from_jax_variables
from tpuframe_torch.ops import fused_adamw
from tpuframe_torch.track.telemetry import get_telemetry
from tpuframe_torch.train import Callback, Trainer, create_train_state, make_optimizer
from tpuframe_torch.train.algorithms import MixUp
from tpuframe_torch.train.schedules import warmup_cosine
from tpuframe_torch.train.step import make_grad_accum_step, make_train_step

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture
def aot_eager(monkeypatch):
    """The mechanics tests compile without code generation."""
    monkeypatch.setattr(pc, "_BACKEND", "aot_eager")
    torch._dynamo.reset()


def _mark(tele):
    token = f"precompile-test-{id(object())}-{len(tele.recent_events(10**6))}"
    tele.event("test/mark", token=token)
    return token


def _since(tele, token, name):
    events = tele.recent_events(10**6)
    at = max(i for i, e in enumerate(events) if e.get("token") == token)
    return [e for e in events[at + 1:] if e.get("name") == name]


# -- loader templates ---------------------------------------------------------


def _x64_off(sig: tuple) -> tuple:
    """A port signature as JAX's x64-off pipeline would carry it."""
    canon = {"int64": "int32", "float64": "float32"}
    return tuple((k, shape, canon.get(dt, dt)) for k, shape, dt in sig)


TEMPLATE_CASES = {
    "plain": dict(),
    "mixup": dict(algorithms=("mixup",)),
    "eval_drop_last_false": dict(train=False),
    "grad_accum_2": dict(grad_accum=2),
}


@pytest.mark.parametrize("case", TEMPLATE_CASES, ids=list(TEMPLATE_CASES))
def test_loader_template_is_jaxs_and_the_first_batchs(case):
    kw = dict(TEMPLATE_CASES[case])
    train = kw.pop("train", True)
    algs = kw.pop("algorithms", ())
    jds = JaxSynthetic(n=64, image_size=28, channels=1, num_classes=4, seed=0)
    jtr = JaxTrainer(JaxMnistNet(num_classes=4), max_duration="1ep", eval_interval=1,
                     log_interval=0, precompile=False,
                     train_dataloader=JaxDataLoader(jds, batch_size=16, shuffle=True, seed=3),
                     eval_dataloader=JaxDataLoader(jds, batch_size=16, drop_last=False),
                     algorithms=[JaxMixUp(alpha=0.2)] if algs else [], **kw)
    ds = SyntheticImageDataset(n=64, image_size=28, channels=1, num_classes=4, seed=0)
    tr = Trainer(MnistNet(num_classes=4, device="cpu"), max_duration="1ep", eval_interval=1,
                 log_interval=0, train_dataloader=DataLoader(ds, 16, shuffle=True, seed=3),
                 eval_dataloader=DataLoader(ds, 16, drop_last=False),
                 algorithms=[MixUp(alpha=0.2)] if algs else [], **kw)
    ours = loader_batch_template(tr, train=train)
    sig = batch_signature(ours)
    assert _x64_off(sig) == jax_signature(jax_template(jtr, train=train))
    loader = tr.train_dataloader if train else tr.eval_dataloader
    first = next(iter(tr._device_batches(loader, train=train)))
    assert sig == batch_signature(first)
    assert all(isinstance(v, TensorSpec) and v.device == tr.device for v in ours.values())


class _Batches:
    """A duck-typed loader: batches, nothing of the DataLoader's spec."""

    def __iter__(self):
        yield np.zeros((4, 28, 28, 1), np.uint8), np.zeros(4, np.int64)

    def set_epoch(self, epoch):
        pass


def test_a_duck_typed_loader_has_no_template():
    tr = Trainer(MnistNet(num_classes=4, device="cpu"), train_dataloader=_Batches(),
                 max_duration="1ba", num_classes=4)
    assert loader_batch_template(tr, train=True) is None
    assert loader_batch_template(tr, train=False) is None


# -- the precompiled fit against JAX's ----------------------------------------


def _loaders(ds_cls, dl_cls, **extra):
    train = dl_cls(ds_cls(n=40, image_size=16, num_classes=10, seed=1), 8, shuffle=True, seed=2,
                   transfer_dtype="uint8", **extra)
    evl = dl_cls(ds_cls(n=20, image_size=16, num_classes=10, seed=7), 8, drop_last=False,
                 transfer_dtype="uint8", **extra)
    return train, evl


def test_precompiled_fit_matches_jaxs_precompiled_fit(aot_eager):
    common = dict(optimizer="sgd", lr=0.05, max_duration="2ep", normalize=(MEAN, STD),
                  health=False, seed=0)
    jtrain, jeval = _loaders(JaxSynthetic, JaxDataLoader, process_index=0, process_count=1)
    jtr = JaxTrainer(JaxResNet18(num_classes=10, num_filters=4, stem="cifar"),
                     train_dataloader=jtrain, eval_dataloader=jeval, precompile=True, **common)
    state = jtr.init_state()
    variables = {k: jax.tree.map(lambda a: np.asarray(a, np.float32), v)
                 for k, v in (("params", state.params), ("batch_stats", state.batch_stats))}
    want = jtr.fit().history
    assert jtr._precompile_report and all(s.get("dispatchable")
                                          for s in jtr._precompile_report["steps"])

    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    train, evl = _loaders(SyntheticImageDataset, DataLoader)
    tele = get_telemetry()
    token = _mark(tele)
    tr = Trainer(model, train_dataloader=train, eval_dataloader=evl, precompile=True, **common)
    got = tr.fit().history
    rep = tr._precompile_report
    assert [s["kind"] for s in rep["steps"]] == ["train", "eval"]
    assert all(s.get("dispatchable") and s.get("graphed") is False for s in rep["steps"])
    assert {k for k, _ in tr._compiled} == {"train", "eval"}  # never dropped by a fallback
    assert not _since(tele, token, "compile/recompile")
    assert not _since(tele, token, "compile/aot_fallback")
    (done,) = _since(tele, token, "compile/precompile")
    assert done["compiled"] == done["dispatchable"] == 2
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train_loss", "train_accuracy", "eval_loss", "eval_accuracy"):
            assert g[key] == pytest.approx(w[key], rel=1e-3), (key, g[key], w[key])


# -- the warm-up's restore ----------------------------------------------------


def _tensors(state) -> dict:
    out = {k: v.clone() for k, v in pc._state_tensors(state).items()}
    out["rng"] = state.generator.get_state()
    return out


def _resnet_case():
    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu", seed=1)
    state = create_train_state(model, make_optimizer("sgd", 0.05))
    batch = {"image": torch.rand(4, 16, 16, 3), "label": torch.arange(4)}
    from tpuframe_torch.fault.health import HealthPolicy

    return state, make_train_step(health=HealthPolicy()), batch


def _lm_case():
    model = TransformerLM(vocab_size=64, num_layers=2, num_heads=2, head_dim=16, max_len=16,
                          device="cpu", seed=1)
    state = create_train_state(model, fused_adamw(warmup_cosine(1e-3, 2, 20), weight_decay=1e-4))
    toks = torch.randint(0, 64, (4, 17), generator=torch.Generator().manual_seed(0))
    return state, make_grad_accum_step(2), {"image": toks[:, :-1].reshape(2, 2, 16),
                                            "label": toks[:, 1:].reshape(2, 2, 16)}


@pytest.mark.parametrize("make", [_resnet_case, _lm_case], ids=["resnet_sgd_health",
                                                                "lm_fused_adamw_accum"])
def test_the_warmup_restores_the_state_bit_for_bit(aot_eager, make):
    state, step, batch = make()
    for _ in range(2):  # a state with history: counts, moments, EMA of the loss
        state, _ = step(state, batch)
    state.step = 7
    before, host = _tensors(state), state.step
    spec = abstract_state(state)
    template = {k: TensorSpec(tuple(v.shape), v.dtype) for k, v in batch.items()}
    exe = precompile_step(step, state, template, label="test", planned_steps=20)
    after = _tensors(state)
    assert state.step == host
    assert set(before) == set(after)
    for k in before:
        assert before[k].dtype == after[k].dtype and torch.equal(before[k], after[k]), k
    assert {k: v for k, v in abstract_state(state).items() if k != "lr_table"} == {
        k: v for k, v in spec.items() if k != "lr_table"}
    # the executable steps as the eager step does, to the bit
    twin = make()[0]
    for _ in range(2):
        twin, _ = step(twin, batch)
    twin.step = 7
    _, m1 = exe(state, batch)
    _, m2 = step(twin, batch)
    assert state.step == twin.step == 8
    assert all(torch.equal(m1[k], m2[k]) for k in m2)
    assert all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                 twin.model.parameters()))


# -- the Trainer's spine --------------------------------------------------------


def _small_trainer(**kw):
    ds = SyntheticImageDataset(n=32, image_size=16, num_classes=10, seed=0)
    kw.setdefault("train_dataloader", DataLoader(ds, 8, seed=3, transfer_dtype="uint8"))
    kw.setdefault("max_duration", "1ep")
    return Trainer(ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu"),
                   eval_interval=0, log_interval=0, normalize=(MEAN, STD), **kw)


def test_precompile_is_synchronous_and_idempotent(aot_eager):
    tr = _small_trainer()
    assert tr.precompile_enabled is False  # the port's default (difference 31)
    rep = tr.precompile()
    assert rep is tr.precompile()  # the second call: the same report, no redo
    assert tr._shape_guard.armed
    assert rep["steps"][0]["kind"] == "train" and rep["steps"][0]["dispatchable"]
    assert len(rep["steps"]) == 1  # no eval loader


def test_the_guard_fires_once_on_a_stray_shape_and_the_executable_takes_the_rest(aot_eager):
    tr = _small_trainer()
    tr.precompile()
    ((kind, sig), exe), = tr._compiled.items()
    calls = []
    real = exe.fn
    exe.fn = lambda *a: calls.append(1) or real(*a)
    good = next(iter(tr._device_batches(tr.train_dataloader, train=True)))
    stray = {k: v[:4] for k, v in good.items()}
    tele = get_telemetry()
    token = _mark(tele)
    state = tr.state
    for batch in (good, stray, stray, good):
        state, _ = tr._step_call("train", tr._train_step, state, batch)
    shouts = _since(tele, token, "compile/recompile")
    assert len(shouts) == 1 and "image:(4,16,16,3):uint8" in shouts[0]["signature"]
    assert len(calls) == 2  # the two batches of the precompiled signature
    assert state.step == 4


def test_a_step_precompile_does_not_cover_is_reported_skipped(aot_eager):
    ds = SyntheticImageDataset(n=32, image_size=28, channels=1, num_classes=4, seed=0)
    tr = Trainer(MnistNet(num_classes=4, device="cpu"), max_duration="1ep", log_interval=0,
                 train_dataloader=DataLoader(ds, 16, seed=3),
                 eval_dataloader=DataLoader(ds, 16, drop_last=False))
    rep = tr.precompile()
    train, evl = rep["steps"]
    assert "dropout" in train["skipped"] and not train.get("dispatchable")
    assert evl["dispatchable"]  # eval mode draws no dropout
    assert [k for k, _ in tr._compiled] == ["eval"]


@pytest.mark.parametrize("value, on", [(None, False), ("1", True), ("true", True), ("0", False),
                                       ("off", False)])
def test_the_env_opts_in(monkeypatch, aot_eager, value, on):
    if value is None:
        monkeypatch.delenv("TPUFRAME_PRECOMPILE", raising=False)
    else:
        monkeypatch.setenv("TPUFRAME_PRECOMPILE", value)
    assert precompile_enabled(None) is on
    assert precompile_enabled(True) is True and precompile_enabled(False) is False
    tr = _small_trainer(max_duration="1ba")
    assert tr.precompile_enabled is on
    tr.fit()
    assert (tr._precompile_report is not None) is on
    assert bool(tr._compiled) is on


# -- a supervised in-process restart reads the cache ----------------------------


class _Tiny(nn.Module):
    """A linear classifier of 28x28 gray images: an Inductor compile of its
    step is cheap on the CPU."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(28 * 28, 4)

    def forward(self, x):
        return self.fc(x.reshape(x.shape[0], -1).float() / 255.0)


def _counters():
    snap = get_telemetry().registry.snapshot()
    return {k: snap.get(f"compile/{k}", 0.0)
            for k in ("cache_hits", "cache_misses", "backend_compiles", "recompiles")}


def test_in_process_restart_resumes_with_zero_backend_compiles(tmp_path, monkeypatch):
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.fault import ChaosPlan, RestartPolicy, Supervisor

    prev = cc.enabled_dir()
    cache_dir = str(tmp_path / "compile_cache")
    monkeypatch.setenv("TPUFRAME_COMPILE_CACHE", cache_dir)
    torch._dynamo.reset()
    ds = SyntheticImageDataset(n=64, image_size=28, channels=1, num_classes=4, seed=0)
    ckpt_dir = str(tmp_path / "ck")
    snaps = []

    class Snap(Callback):
        def on_fit_start(self, trainer):
            snaps.append(_counters())

    def attempt():
        ck = Checkpointer(ckpt_dir)
        try:
            tr = Trainer(_Tiny(), train_dataloader=DataLoader(ds, 16, shuffle=True, seed=3),
                         max_duration="2ep", eval_interval=0, log_interval=0, checkpointer=ck,
                         checkpoint_interval_batches=2, callbacks=[Snap()], precompile=True)
            return tr, tr.fit()
        finally:
            ck.close()

    tele = get_telemetry()
    token = _mark(tele)
    plan = ChaosPlan.scheduled(3, sites=("loader",), min_step=5, max_step=7)
    sup = Supervisor(RestartPolicy(max_restarts=1, backoff_base_s=0.0), checkpoint_dir=ckpt_dir)
    try:
        with plan.active():
            tr, res = sup.run(attempt)
    finally:
        cc.enable(prev) if prev else cc.disable()
    assert res.error is None and sup.retries == 1
    assert tr.state.step == 8
    (restart,) = _since(tele, token, "fault/restart")
    assert restart["compile_cache"] == cache_dir
    assert all(s.get("dispatchable") for s in tr._precompile_report["steps"])
    end = _counters()
    # attempt 1 compiled for real (a cold cache)...
    assert end["cache_misses"] - snaps[0]["cache_misses"] >= 1
    # ...attempt 2, from its fit start, read every compile from the cache
    assert len(snaps) == 2
    assert end["backend_compiles"] - snaps[1]["backend_compiles"] == 0
    assert end["cache_misses"] - snaps[1]["cache_misses"] == 0
    assert end["cache_hits"] - snaps[1]["cache_hits"] >= 1
