"""Long-context LM training with sequence parallelism (ring or Ulysses).

Port of ``examples/06_lm_sequence_parallel.py``: a decoder-only
``TransformerLM`` trained on synthetic token streams with the sequence
dimension split over the mesh's ``seq`` axis:

- ``--attn ring``     K and V rotate the ring of ``seq`` ranks (exact, K6
                      tiles, O((L/N)^2) score memory);
- ``--attn ulysses``  all-to-all head <-> sequence re-sharding (needs
                      heads % seq_shards == 0);
- ``--attn full``     no SP, the single-device baseline;
- ``--attn blockwise`` no SP, the flash-style linear-memory path.

``--moe-experts N`` swaps every block's MLP for a top-k gated MoE with the
expert weights split over the ``expert`` axis (``moe_rules``); bf16 on the
card.  ZeRO via ``--zero-stage`` shards optimizer state over the ``fsdp``
axis, which this recipe's mesh leaves at 1, so it stays inactive (the
default stage 1 runs as stage 0, as in the JAX package).

The port runs one process a device, so it launches ``--num-processes``
workers (default: ``--seq-shards`` x ``--expert-shards``, the second only
with MoE) through the ``Distributor``; ``--simulate-devices 1`` runs them on
the CPU.  Each worker takes its data shard's rows of the global batch; the
train step cuts its run of positions.

``--composed`` (the composed N-D story: TP x PP x ZeRO chaos-killed and
resumed under another plan) raises ``NotImplementedError``: it needs the
rest of ROADMAP.md Queue 1 item 7 (ZeRO and the wire beside ``model`` and
``pipe``) and precompile under plans of more than one rank (item 9: the
compile plane captures one rank's step; NCCL capture waits).

Run:  python 06_lm_sequence_parallel.py --attn ulysses --seq-len 512 \\
          --seq-shards 2 --simulate-devices 1
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np

from _common import base_parser, simulate_in_process


class SyntheticTokenDataset:
    """Deterministic next-token streams with learnable structure: token
    t+1 = (a * t + noise-free affine walk) mod vocab, keyed by index."""

    def __init__(self, n: int, seq_len: int, vocab: int, seed: int = 0):
        self.n, self.seq_len, self.vocab, self.seed = n, seq_len, vocab, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(self.seed * 100_003 + i)
        start = int(rng.integers(0, self.vocab))
        stride = int(rng.integers(1, 7))
        toks = (start + stride * np.arange(self.seq_len + 1)) % self.vocab
        return toks.astype(np.int32)


def train(args) -> dict:
    from tpuframe_torch.core import runtime as rt
    from tpuframe_torch.core.runtime import MeshSpec
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.parallel import ZeroConfig, bf16_compute, full_precision
    from tpuframe_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        merge_metrics,
        summarize_metrics,
        warmup_cosine,
    )

    # dp x sp (x ep) mesh: batch over data, sequence over seq, experts
    # over expert when MoE is on
    runtime = rt.initialize(
        MeshSpec(data=-1, seq=args.seq_shards,
                 expert=args.expert_shards if args.moe_experts else 1)
    )
    rules = ()
    if args.moe_experts:
        from tpuframe_torch.models import moe_rules

        rules = moe_rules()
    plan = ZeroConfig(stage=args.zero_stage).plan(runtime.mesh, rules=rules)
    policy = bf16_compute() if runtime.platform == "gpu" else full_precision()

    model = TransformerLM(
        vocab_size=args.vocab,
        num_layers=args.layers,
        num_heads=args.heads,
        head_dim=args.head_dim,
        max_len=args.seq_len,
        attn_impl=args.attn,
        dtype=policy.compute_dtype,
        moe_experts=args.moe_experts,
        seed=args.seed,
    )
    total_steps = args.epochs * (args.train_samples // args.batch_size)
    state = create_train_state(
        model,
        make_optimizer("adamw", warmup_cosine(args.lr, max(total_steps // 10, 1), total_steps)),
        seed=args.seed,
        plan=plan,
    )
    step = make_train_step(policy)

    ds = SyntheticTokenDataset(args.train_samples, args.seq_len, args.vocab,
                               seed=args.seed)
    steps_per_epoch = args.train_samples // args.batch_size
    shard, shards = runtime.data_index, runtime.data_count
    rows = args.batch_size // shards
    history = []
    order_rng = np.random.default_rng(args.seed)
    for epoch in range(args.epochs):
        order = order_rng.permutation(len(ds))
        acc = None
        for b in range(steps_per_epoch):
            idx = order[b * args.batch_size : (b + 1) * args.batch_size]
            idx = idx[shard * rows : (shard + 1) * rows]  # this process's rows
            toks = np.stack([ds[int(i)] for i in idx])  # (B / shards, L+1)
            batch = plan.shard_batch(
                {"input": toks[:, :-1], "label": toks[:, 1:]}
            )
            state, metrics = step(state, batch)
            acc = merge_metrics(acc, metrics)
        summary = summarize_metrics(acc, prefix="train_")
        history.append(summary)
        if runtime.is_main:
            print(
                f"epoch {epoch}: loss {summary['train_loss']:.4f} "
                f"acc {summary['train_accuracy']:.3f} (attn={args.attn})",
                flush=True,
            )
    return history[-1]


def main(argv=None):
    p = base_parser("Long-context LM with ring/Ulysses sequence parallelism")
    p.add_argument("--attn", default="ring",
                   choices=["ring", "ulysses", "full", "auto", "blockwise"])
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--seq-shards", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=16)
    p.add_argument("--zero-stage", type=int, default=1)
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--expert-shards", type=int, default=2)
    p.add_argument("--composed", action="store_true",
                   help="run the composed TP x PP -> plan-change resume story")
    p.add_argument("--pp-schedule", default=None,
                   help="pipeline schedule pin for --composed "
                        "(interleaved/barriered/1f1b; default: env)")
    p.add_argument("--pp-microbatches", type=int, default=0,
                   help="pipeline microbatch pin for --composed (0: env)")
    p.add_argument("--kill-step", type=int, default=0,
                   help="chaos-kill step for --composed (0: auto)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="workers, one device each (default: --seq-shards x --expert-shards)")
    args = p.parse_args(argv)
    if args.composed:
        raise NotImplementedError(
            "--composed is not ported: it needs the rest of ROADMAP.md Queue 1 item 7 (ZeRO "
            "and the compressed wire beside tensor and pipeline parallelism) and precompile "
            "under plans of more than one rank (item 9; NCCL capture)")
    workers = args.num_processes or args.seq_shards * (
        args.expert_shards if args.moe_experts else 1)
    if workers > 1:
        from tpuframe_torch.launch import Distributor

        final = Distributor(num_processes=workers,
                            simulate_devices=args.simulate_devices).run(train, args)
    else:
        simulate_in_process(args)
        final = train(args)
    assert np.isfinite(final["train_loss"])
    return final


if __name__ == "__main__":
    main()
