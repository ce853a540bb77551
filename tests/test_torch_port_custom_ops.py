"""The hand kernels as registered custom ops (``tpuframe::``), on the CPU.

- ``torch.library.opcheck`` on every op (schema, fake tensors, autograd
  registration, AOT dispatch), each on the inputs its paths give it.  The
  ops carry no autograd formula: K2's and K3's gradients are their
  ``autograd.Function``'s, which calls the forward op and then the
  backward op, so the inputs here need no gradient; the Dynamo cases
  below hold the pairs' gradients.
- No op has a ``CompositeImplicitAutograd`` kernel (Inductor could then
  decompose it into the plain version); each has a CPU and a CUDA kernel.
- TorchDynamo traces the model region of a small ResNet step (K1, K2a;
  K2b in its backward graph) and of 2-layer, width-32 LM steps (K3a; K3b
  in its backward graph), full, blockwise (K6a; K6b and K6c), blockwise
  under ``remat`` (the backward graph recomputes K3a and K6a) and MoE
  (K9a and K9b; K9c and K9b, the MoE routing and aux loss in the graph)
  with zero graph breaks, the ``tpuframe::`` nodes in the graphs, bit-equal
  to the eager region; and K4's list update as one node.  The LM's (B, L)
  labels take the plain per-position loss, as JAX's step routes them, so
  K2 is the ResNet path's.
- The launch tally: with ``torch.cuda.is_current_stream_capturing``
  patched to true, a launch goes to the open capture's tally (or nowhere)
  and a replay adds it to the counter.
- Through a compile with the ``aot_eager`` backend, each op's forward and
  gradient equal the eager ones to the bit.
"""

import functools
from unittest import mock

import pytest
import torch

from tpuframe_torch.models import ResNet18, TransformerLM
from tpuframe_torch.ops import dispatch
from tpuframe_torch.ops.cross_entropy import fused_cross_entropy
from tpuframe_torch.ops.fused_adamw import fused_adamw_multi_update_
from tpuframe_torch.ops.blockwise_attention import blockwise_attention_reference
from tpuframe_torch.ops.layer_norm import fused_layer_norm
from tpuframe_torch.ops.moe_gating import _descriptors, _routing
from tpuframe_torch.ops.normalize import normalize_images
from tpuframe_torch.parallel import full_precision
from tpuframe_torch.train import step as train_step

OPS = ("normalize", "cross_entropy_fwd", "cross_entropy_bwd", "layer_norm_fwd",
       "layer_norm_bwd", "fused_adamw_", "blockwise_attention_fwd", "blockwise_attention_bwd_dq",
       "blockwise_attention_bwd_dkv", "moe_dispatch", "moe_combine", "moe_combine_backward")
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _adamw_args(dtype):
    shapes = [(5, 9), (9,), (3, 4, 4, 2)]
    ps = [torch.randn(s, generator=_g(1)).to(dtype) for s in shapes]
    gs = [torch.randn(s, generator=_g(2)).to(dtype) for s in shapes]
    ms = [torch.rand(s, generator=_g(3)) for s in shapes]
    vs = [torch.rand(s, generator=_g(4)) for s in shapes]
    cs = [torch.tensor(3, dtype=torch.int32) for _ in shapes]
    return (ps, gs, ms, vs, cs, torch.tensor(1e-3), 0.9, 0.999, 1e-8, 1e-4)


def _cases():
    x = torch.randn(6, 10, generator=_g())
    labels = torch.tensor([0, 9, 3, 3, 1, 5])
    g = torch.rand(6, generator=_g(1))
    stats = torch.cat([x.amax(-1, keepdim=True), torch.rand(6, 1, generator=_g(2))], -1)
    h = torch.randn(7, 16, generator=_g(3))
    scale = torch.randn(16, generator=_g(4))
    bias = torch.randn(16, generator=_g(5))
    return [
        ("normalize_u8_bf16", "normalize", (torch.randint(0, 256, (2, 5, 5, 3), dtype=torch.uint8,
                                                          generator=_g()),
                                            list(MEAN), list(STD), 1 / 255, torch.bfloat16)),
        ("normalize_f32", "normalize", (torch.rand(2, 4, 4, 1, generator=_g()) * 255, [0.5],
                                        [0.25], 1 / 255, torch.float32)),
        ("ce_fwd_stats", "cross_entropy_fwd", (x, labels, True)),
        ("ce_fwd_nostats", "cross_entropy_fwd", (x, labels, False)),
        ("ce_fwd_bf16", "cross_entropy_fwd", (x.bfloat16(), labels.int(), True)),
        ("ce_bwd_stats", "cross_entropy_bwd", (x, labels, g, stats)),
        ("ce_bwd_nostats", "cross_entropy_bwd", (x, labels, g, None)),
        ("ln_fwd", "layer_norm_fwd", (h, scale, bias, 1e-6)),
        ("ln_fwd_bf16", "layer_norm_fwd", (h.bfloat16(), scale.bfloat16(), bias.bfloat16(),
                                          1e-6)),
        ("ln_bwd", "layer_norm_bwd", (h, scale, torch.randn(7, 16), 1e-6)),
        ("adamw_f32_bump", "fused_adamw_", (*_adamw_args(torch.float32), True)),
        ("adamw_bf16", "fused_adamw_", (*_adamw_args(torch.bfloat16), False)),
    ]


def _k6_cases():
    """K6 on the inputs its paths give it: causal (the LM) and
    bidirectional (ViT), float32 and bf16, L = 24 over blocks of 16 (the
    plain schedule pads to 32), and the ring's float32 ``out_dtype``."""
    cases = []
    for dtype, causal, out_dtype in ((torch.float32, True, torch.float32),
                                     (torch.bfloat16, True, torch.bfloat16),
                                     (torch.bfloat16, False, torch.float32)):
        q, k, v, g = (torch.randn(1, 24, 2, 16, generator=_g(i)).to(dtype) for i in range(4))
        out, lse = blockwise_attention_reference(q, k, v, causal=causal, block_size=16)
        delta = torch.einsum("bqhd,bqhd->bhq", out.float(), g.float()).contiguous()
        tag = f"{str(dtype)[6:]}_{'causal' if causal else 'full'}_out_{str(out_dtype)[6:]}"
        cases += [(f"k6_fwd_{tag}", "blockwise_attention_fwd", (q, k, v, causal, 16, out_dtype)),
                  (f"k6_dq_{tag}", "blockwise_attention_bwd_dq",
                   (q, k, v, out, lse, g, causal, 16, out_dtype)),
                  (f"k6_dkv_{tag}", "blockwise_attention_bwd_dkv",
                   (q, k, v, lse, delta, g, causal, 16, out_dtype))]
    return cases


def _k9_cases():
    """K9 at a capacity that drops slots (12 tokens, top 2, 3 experts,
    capacity 5 of the 8 an even share would take), float32 and bf16."""
    cases = []
    gate_idx = torch.stack([torch.arange(12) % 3, (torch.arange(12) + 1) % 3], 1)
    choice_exp, _, keep, _ = _routing(gate_idx, 3, 5)
    e_loc, slot, count = _descriptors(choice_exp, keep, 0, 3)
    assert not bool(keep.all())
    w = torch.rand(24, generator=_g(5))
    for dtype in (torch.float32, torch.bfloat16):
        src = torch.randn(12, 8, generator=_g(6)).to(dtype)
        buf = torch.randn(3, 5, 8, generator=_g(7)).to(dtype)
        name = str(dtype)[6:]
        cases += [(f"k9_dispatch_{name}", "moe_dispatch", (src, e_loc, slot, count, 3, 5)),
                  (f"k9_combine_{name}", "moe_combine", (buf, w, e_loc, slot, 12)),
                  (f"k9_combine_backward_{name}", "moe_combine_backward",
                   (src, buf, w, e_loc, slot, count))]
    return cases


CASES = _cases() + _k6_cases() + _k9_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_opcheck(case):
    _, name, args = case
    torch.library.opcheck(getattr(torch.ops.tpuframe, name).default, args)


@pytest.mark.parametrize("name", OPS)
def test_registered_kernels_and_no_composite(name):
    qual = f"tpuframe::{name}"
    has = functools.partial(torch._C._dispatch_has_kernel_for_dispatch_key, qual)
    assert has("CPU") and has("CUDA")
    assert not has("CompositeImplicitAutograd")
    assert not has("CompositeExplicitAutograd")


class _Graphs:
    """An ``aot_eager``-like backend that keeps the forward and backward
    graphs AOTAutograd hands it."""

    def __init__(self):
        self.fw, self.bw = [], []

    def backend(self):
        from torch._dynamo.backends.common import aot_autograd
        from torch._functorch.aot_autograd import make_boxed_func

        def keep(into):
            def compiler(gm, example_inputs):
                into.append(gm)
                return make_boxed_func(gm.forward)
            return compiler

        return aot_autograd(fw_compiler=keep(self.fw), bw_compiler=keep(self.bw))

    @staticmethod
    def targets(gms) -> list[str]:
        return [str(n.target) for gm in gms for n in gm.graph.nodes
                if str(n.target).startswith("tpuframe.")]


def _resnet_region():
    model = ResNet18(num_classes=10, num_filters=4, stem="cifar", device="cpu", seed=0)
    tf = functools.partial(normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32)
    step = train_step.make_train_step(full_precision(),
                                      batch_transform=lambda b: {**b, "image": tf(b["image"])})
    batch = {"image": torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8, generator=_g()),
             "label": torch.tensor([1, 2, 3, 4])}
    return model, step.region, batch


#: the 2-layer, width-32 LMs of the step regions
LM_KINDS = {"lm": {}, "blockwise": {"attn_impl": "blockwise"},
            "remat": {"attn_impl": "blockwise", "remat": True},
            "moe": {"moe_experts": 4, "moe_top_k": 2}}


def _lm_region(kind: str = "lm"):
    model = TransformerLM(vocab_size=64, num_layers=2, num_heads=2, head_dim=16, max_len=16,
                          device="cpu", seed=0, **LM_KINDS[kind])
    step = train_step.make_train_step(full_precision())
    toks = torch.randint(0, 64, (2, 17), generator=_g())
    return model, step.region, {"image": toks[:, :-1], "label": toks[:, 1:]}


def _op_names(**counts) -> list[str]:
    return [f"tpuframe.{name}.default" for name, n in counts.items() for _ in range(n)]


_K6 = dict(blockwise_attention_bwd_dq=2, blockwise_attention_bwd_dkv=2)


@pytest.mark.parametrize("path, fw_ops, bw_ops", [
    ("resnet", _op_names(normalize=1, cross_entropy_fwd=1), _op_names(cross_entropy_bwd=1)),
    ("lm", _op_names(layer_norm_fwd=5), _op_names(layer_norm_bwd=5)),
    ("blockwise", _op_names(layer_norm_fwd=5, blockwise_attention_fwd=2),
     _op_names(layer_norm_bwd=5, **_K6)),
    # the backward recomputes each block's forward: its two LayerNorms and K6a
    ("remat", _op_names(layer_norm_fwd=5, blockwise_attention_fwd=2),
     _op_names(layer_norm_bwd=5, layer_norm_fwd=4, blockwise_attention_fwd=2, **_K6)),
    ("moe", _op_names(layer_norm_fwd=5, moe_dispatch=2, moe_combine=2),
     _op_names(layer_norm_bwd=5, moe_combine_backward=2, moe_combine=2)),
])
def test_dynamo_traces_the_step_region_with_no_break(path, fw_ops, bw_ops):
    torch._dynamo.reset()
    model, region, batch = _resnet_region() if path == "resnet" else _lm_region(path)
    explained = torch._dynamo.explain(region)(model, batch)
    assert explained.graph_break_count == 0, explained.break_reasons
    assert explained.graph_count == 1
    graphs = _Graphs()
    compiled = torch.compile(region, backend=graphs.backend(), fullgraph=True)
    losses, logits, aux = compiled(model, batch)
    assert (aux is not None) == (path == "moe")  # the aux loss leaves the region
    train_step._objective(losses.mean(), aux).backward()
    assert sorted(graphs.targets(graphs.fw)) == sorted(fw_ops)
    assert sorted(graphs.targets(graphs.bw)) == sorted(bw_ops)
    if path == "remat":  # each block's kernels marked for recompute, whatever the partitioner
        from torch.utils.checkpoint import CheckpointPolicy

        policies = [n.meta.get("recompute") for gm in graphs.fw for n in gm.graph.nodes
                    if str(n.target).startswith("tpuframe.")]
        assert policies == [CheckpointPolicy.MUST_RECOMPUTE] * 6 + [None], policies
    assert all(getattr(m, "aux_loss", None) is None for m in model.modules())
    # the same forward and gradients as the eager region, bit for bit
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    ref_losses, ref_logits, ref_aux = region(model, batch)
    train_step._objective(ref_losses.mean(), ref_aux).backward()
    assert torch.equal(losses, ref_losses) and torch.equal(logits, ref_logits)
    assert aux is None or torch.equal(aux, ref_aux)
    assert all(torch.equal(grads[n], p.grad) for n, p in model.named_parameters())


def test_dynamo_traces_k4_as_one_node():
    torch._dynamo.reset()
    ps, gs, ms, vs, cs, lr, *_ = _adamw_args(torch.float32)

    def update(ps, gs, ms, vs, cs, lr):
        fused_adamw_multi_update_(ps, gs, ms, vs, cs, lr=lr, weight_decay=1e-4, bump=True)

    explained = torch._dynamo.explain(update)(ps, gs, ms, vs, cs, lr)
    assert explained.graph_break_count == 0, explained.break_reasons
    nodes = [str(n.target) for g in explained.graphs for n in g.graph.nodes]
    assert nodes.count("tpuframe.fused_adamw_") + nodes.count(
        "tpuframe.fused_adamw_.default") == 1, nodes
    # the compiled update equals the eager one to the bit
    copies = [[t.clone() for t in ts] for ts in (ps, ms, vs, cs)]
    torch.compile(update, backend="aot_eager", fullgraph=True)(ps, gs, ms, vs, cs, lr)
    update(*copies[:1], gs, *copies[1:], lr)
    for got, want in zip((ps, ms, vs, cs), copies):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_each_op_through_a_compile_equals_eager():
    torch._dynamo.reset()
    x = torch.randn(6, 10, generator=_g(), requires_grad=True)
    labels = torch.tensor([0, 9, 3, 3, 1, 5])
    h = torch.randn(3, 4, 16, generator=_g(1), requires_grad=True)
    scale = torch.randn(16, generator=_g(2), requires_grad=True)
    bias = torch.randn(16, generator=_g(3), requires_grad=True)

    def f(x, labels, h, scale, bias):
        return fused_cross_entropy(x, labels).sum() + fused_layer_norm(h, scale, bias).square().sum()

    out = torch.compile(f, backend="aot_eager", fullgraph=True)(x, labels, h, scale, bias)
    got = torch.autograd.grad(out, (x, h, scale, bias))
    ref = f(x, labels, h, scale, bias)
    want = torch.autograd.grad(ref, (x, h, scale, bias))
    assert torch.equal(out, ref) and all(torch.equal(a, b) for a, b in zip(got, want))


class _Wrapper:
    launches = 0


def test_a_launch_under_capture_goes_to_the_open_tally():
    """Keyed by the capturing stream: another thread's launch on it (a
    backward that autograd's device thread records) lands in the same
    tally, a launch on another capturing stream in that one's."""
    import threading

    w = _Wrapper()
    stream = [1]
    with mock.patch.object(torch.cuda, "is_current_stream_capturing", lambda: True), \
            mock.patch.object(dispatch, "_stream_key", lambda: stream[0]):
        dispatch.count_launch(w)  # a capture with no tally open counts nothing
        with dispatch.capture_tally() as tally:
            dispatch.count_launch(w)
            t = threading.Thread(target=dispatch.count_launch, args=(w,))
            t.start()
            t.join()
            stream[0] = 2
            with dispatch.capture_tally() as other:  # another stream's capture
                dispatch.count_launch(w)
            stream[0] = 1
            dispatch.count_launch(w)
        assert dispatch._TALLIES == {}
    assert w.launches == 0
    assert tally == {w: 3} and other == {w: 1}
    with mock.patch.object(torch.cuda, "is_current_stream_capturing", lambda: False):
        dispatch.count_launch(w)
    assert w.launches == 1
    dispatch.add_tally(tally)  # one replay
    dispatch.add_tally(tally, times=2)  # two more
    assert w.launches == 1 + 9
