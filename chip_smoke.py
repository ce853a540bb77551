#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``tpuframe_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit, no result line):

1. Device: the card's name and power limit from ``nvidia-smi``; no CUDA,
   no run, and none while ``TPUFRAME_SIMULATE_DEVICES`` (the launcher's
   request for CPU workers) is set.
2. Build: every CUDA kernel of the port (eight sources), compiled from
   ``tpuframe_torch/csrc`` with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
   source, all started together, and beside them the K2 baseline
   (``tests/csrc/cross_entropy_baseline.cu``, the design before saved row
   statistics), the K6 baseline (``tests/csrc/
   blockwise_attention_baseline.cu``, every product a float32 FMA), the
   K9 baseline (``tests/csrc/moe_gating_baseline.cu``, K9a and K9b
   before their redesign), K9b's generic loop at any top-k
   (``tests/csrc/moe_combine_any_k.cu``) and the K9c baseline
   (``tests/csrc/moe_gate_grad_baseline.cu``, the combine's backward as
   the two launches it was), for timing only; each kernel's registers and
   spills from ``ptxas``, none allowed in ``moe_gating.cu``.
3. Kernels: first the launch floor, the time of an empty kernel
   (``csrc/launch_floor.cu``) launched through ``ctypes`` as every kernel
   is, printed on its own line and given as ``floor_ms`` beside each
   kernel's byte or operation bound.  Then each kernel against its plain
   PyTorch version on the card, at the shapes its paths give it and at
   ragged ones, timed with CUDA events (median of 100 launches after
   warm-up, L2 flushed before each) beside its plain version and one
   library call of the same function, in turns: K1 normalize at every
   serve bucket and the train batch of 128 (``torch.addcmul`` into a bf16
   ``out=`` at 64 and 128), K2a cross entropy forward
   (``F.cross_entropy(reduction="none")``) and K2b its backward
   (``torch.autograd.grad`` of that loss), the last two checked also at
   phase 10's (64, 1000) a rank, and timed at the train
   path's (128, 1000) and at an HBM-bound (16384, 1000), f32 and bf16,
   each with its ratio to the floor, as the train path calls them (K2a
   writing the row statistics, K2b taking them), without statistics, and
   the baseline, in turns; checked at every path of the forward with
   labels at 0, at K - 1 and on the row's maximum, K2b from the
   statistics bit-equal to K2b without them; K3a
   LayerNorm forward (``F.layer_norm(eps=1e-6)``) and K3b its backward
   (``torch.autograd.grad`` of it) at the LM path's (16384, 768) bf16 with
   bf16 scale and bias, checked there, in f32 and at a ragged 1000 x 300,
   K3b also timed in f32 and at 1000 x 300 and split by kernel with
   ``torch.profiler``; K4 fused AdamW, one launch over the 149 parameter
   tensors of the GPT-2-small LM plus a misaligned view, over a ragged
   list with ``b1 = 0``, a bf16 list and a list longer than one launch's
   table, each bit-equal to one-entry calls, then one ``FusedAdamW.step()``
   over the 149 tensors timed beside ``torch.optim.AdamW(fused=True)
   .step()`` (the same update) and the per-tensor loop of one-entry calls;
   K5a bucket abs-max
   (``torch.linalg.vector_norm(v, inf, dim=1)``), K5b encode (int8, int8
   stochastic with the same noise, fp8) and K5c decode at the ResNet50-1K
   wire's 25 x 1,022,336 float32, at (3, 130) and on edge rows: amax and
   encode bit-equal, decode within 1e-6 with NaN where amax is NaN; K6a
   blockwise attention forward, K6b its backward's delta and dQ, K6c dK
   and dV, against the plain schedule run in float32 at the long-context
   path's (2, 8192, 12, 64) bf16 causal, ViT's (64, 196, 12, 64) bf16 and
   ragged L = 13 and 1000 in f32 and bf16 (f32 within 1e-5 forward and
   1e-4 gradients, bf16 at most twice the plain bf16 run's distance), two
   runs bit-equal, the K6 baseline held to the same bf16 rule at the path's
   shape, K6a at q scaled by 8 with its lse within 1e-5 of the float64
   logsumexp or no further than twice the f32 plain run; timed at the
   path's shape beside the plain passes,
   ``F.scaled_dot_product_attention(is_causal=True)`` forward and autograd
   backward and the baseline, in turns, each against its operation bound
   in bf16.
   K6's counters are then zeroed, and phases 4 to 10 must leave them at 0.
   Last, the card tests of the graphed K6 and K9 steps (``GRAPHED_TESTS``
   of ``tests/test_torch_port_cuda.py``: a captured K6 step's launches
   over its replays, a small blockwise and a small MoE LM step graphed
   against eager) start in a pytest process beside phases 4 on; phase 21
   joins it and fails on a failure or a skip.
4. Serve: ResNet50 with 1000 classes under ``bf16_compute`` serves 160
   uint8 224x224 images through ``ServeEngine`` (buckets 1/8/32/64) from 4
   client threads, plus one ``POST /predict`` through ``ServingServer``.
   Launch counters are zeroed just before and read just after; every
   kernel of the path must have launched, once a batch, and no other.
   Served rows are held against direct predicts, against predicts through
   the plain normalize, and an f32 forward on the card against the same
   forward on the CPU.
5. Train: ``Trainer(...).fit()`` on ResNet50-1K (``norm_dtype=bf16``,
   ``precision="bf16"``, SGD lr 0.1 momentum 0.9, uint8 images normalized
   by K1) for 12 batches of 128 plus an eval whose last batch is ragged;
   counters zeroed just before and read just after, each kernel at its
   expected count.  Then the train step alone on one device-resident
   batch (images per second, median of 30 steps, and a ``torch.profiler``
   table of one step), ten steps on one batch that must lower the loss,
   kernel against plain cross entropy in f32 train steps, and an f32 train
   step on the card against the CPU.  The track plane: (d) the fit runs
   the straggler monitor's self-baseline (``straggler_sync_steps=2``,
   ``straggler_factor=1.5``) with every step from ``STRAGGLER_AFTER`` on
   ``STRAGGLER_SLEEP_S`` late, and must emit ``train/straggler``; (e) a
   fresh ResNet50 Trainer under an allocator limit ``OOM_HEADROOM_MB``
   above its state raises a real ``torch.OutOfMemoryError`` in its first
   step, narrated by exactly one ``memory/oom`` event.
6. LM train: ``Trainer(TransformerLM(...), tx=fused_adamw(3e-4,
   weight_decay=1e-4), precision="bf16").fit()`` on the GPT-2-small LM of
   ``benchmarks/bench_lm.py`` (12 layers, 12 heads x 64, vocab 32768, seq
   1024, batch 16, random weights from a seed) for 12 batches of example
   06's next-token data, plus an eval whose last batch is ragged; counters
   zeroed just before and read just after: K3a 25 per forward, K3b 25 per
   step, K4 1 per step (one launch for the 149 tensors), K1 and K2 none.
   Then the train step alone on one
   device-resident batch (tokens per second and MFU, median of 30 steps, a
   ``torch.profiler`` table, and the time of the materialized attention and
   of the float32 logits and loss at the step's shapes), ten steps on one
   batch that must lower the loss, kernel against plain LayerNorm and AdamW
   in f32 steps, and a small f32 LM step on the card against the CPU.
   (a): the fit is armed by ``TPUFRAME_PROFILE_STEPS`` (steps 3 to 6
   captured by the Trainer's env-armed ``ProfilerCallback``); the
   capture's ``device_time`` report (compute, transfer, idle seconds, the
   top 8 ops) is printed, and each of K3a, K3b and K4 must appear in it as
   often as its wrapper launched in the window.  Neither phase 5 nor 6
   reports its fit's throughput: 5(d)'s sleeps and 6(a)'s profiler run
   inside the fit.
7. Checkpoint and resume: phase 6's LM fit with
   ``checkpoint_interval_batches=2`` stopped by a crash after step 4, a new
   Trainer over the same directory that auto-resumes and runs to step 6
   (its first batch must be batch 5), bit-equal to an uninterrupted 6-step
   fit; the step directory in the JAX package's layout; then the wall time
   and GB/s of a save and a restore of the full LM state (parameters and
   both moments), and of an async save with the step time while it is in
   flight.
8. Compressed data-parallel train: phase 5's ResNet50-1K fit through
   ``Trainer(plan=ParallelPlan(mesh=initialize().mesh), grad_compression=
   "int8")`` on a one-rank NCCL group (``RANK=0``, ``WORLD_SIZE=1``, a free
   ``MASTER_PORT``); counters zeroed just before and read just after: K5a,
   K5b and K5c once a step, K1 and K2 at phase 5's counts.  First loss near
   ln 1000, a non-zero error-feedback residual, then the compressed step's
   median beside the uncompressed step's (in turns), the sync and the
   buffer average alone, one compressed step under CUDA's sync debug mode
   (it must never wait for the device) and a profile; (b) three compressed
   steps captured by ``track.profiler``: the collective class and the
   exposed comms of the one NCCL rank, and K5a-K5c's kernel events equal
   to their launches; then the state with its residual saved, overwritten
   and restored, bit for bit.
9. Two ranks on one card: two spawned gloo ranks (NCCL refuses two ranks
   on one device) sync a ResNet50-shaped named tree with the kernels; it
   must equal the same ranks' plain run on the CPU bit for bit, give both
   ranks one mean, and decode a NaN on one rank to NaN in its bucket.  The
   fused transport in each form gloo carries for CUDA tensors
   (``PHASE9_FORMS``: ``concurrent`` and ``single``; not the ring) must
   equal the staged run bit for bit (the sign of a zero counts) for int8,
   int8 stochastic and fp8 with error feedback, and keep the NaN in its
   bucket; then each transport's time in ``sync_gradients``.
10. Uncompressed data parallelism on one card: two spawned gloo ranks
   train phase 5's ResNet50-1K through ``Trainer(plan=ParallelPlan(mesh=
   rt.mesh)).fit()`` (global batch 128, 64 a rank, process loader workers)
   for 4 batches plus an eval whose last batch is ragged; counters zeroed
   just before and read just after on each rank: K1 and K2a once a batch
   (train and eval), K2b once a step.  Both ranks end with the same
   parameters and BatchNorm buffers bit for bit, the eval counts each
   image once, the first loss is near ln 1000.  Then the two-rank step
   alone (img/s; gloo routes every collective through the host) with a
   ``torch.profiler`` count of its device time beside the same step with
   each rank's BatchNorm on its own rows, and one
   f32 step of the two ranks on their halves held against one process's
   step on the global batch, for sync BatchNorm and for local with
   ``bn_groups=2``: loss and running statistics within 1e-5, the update
   within ``DDP_UPDATE_RTOL`` (sync also against one process through the
   cross-rank function), beside controls of what rounding alone moves,
   and two planted faults of the sync backward that must exceed it.
   (c): the ranks write their telemetry (``TPUFRAME_TELEMETRY_DIR``), and
   ``python -m tpuframe_torch.track analyze`` over it must see both ranks
   and write a Perfetto trace with a process track each.
11. ViT serve: phase 4's serve path over ViT-B/16 with 1000 classes
   (random weights from a seed): K1 once a batch, K3a 25 times a forward,
   K6 never (196 tokens take full attention), and the same checks.
12. Long-context LM train: ``bench_lm.py``'s ``long_ctx`` (phase 6's widths
   at seq 8192, batch 2, ``attn_impl="auto"``, so blockwise) through
   ``Trainer(tx=fused_adamw(...), precision="bf16").fit()`` for 4 batches
   plus an eval of 3 batches, counters zeroed just before and read just
   after: K6a 12 a forward, K6b and K6c 12 a step, K3a, K3b and K4 at
   their per-step counts.  The first loss near ln 32768; the step alone
   (tokens per second, MFU on phase 6's formula, a profile with K6's
   share); ten steps on one batch; then ``long_remat`` (``remat=True``)
   for 2 batches: K6a 24 a step, its first loss bit-equal to
   ``long_ctx``'s, its peak memory below it; a small f32 blockwise LM
   step on the card against the CPU.
13. Launcher: example 01's ``train_cifar`` through ``Distributor(
   num_processes=1).run`` on the card at the example's defaults (ResNet18
   CIFAR stem, 32 px, global batch 64, 2 epochs of 512, bf16), its
   worker's K1/K2a/K2b launches counted there (zeroed just before, read
   just after) and held exact (0, 16, 16), and the time from spawn to
   result; example 05 through ``TPUTrainer(...).fit()`` with one worker on
   the card (``MnistNet``, 28 px): one report per epoch, launches (0, 16,
   16), and its last checkpoint bundle reloaded into ``MnistNet``; two
   gloo ranks on the one card through ``Distributor(num_processes=2)``:
   three ``lion`` steps of ``MnistNet`` leave both ranks bit-equal,
   ``broadcast_run_id`` agrees, a raising rank surfaces as its exception
   with a ``DistributorError`` (rank 1, exit 1, its traceback) as cause,
   and a lost rank (frozen by SIGSTOP) as ``WorkerLostError`` within a 3 s
   heartbeat timeout, the heartbeat monitor built here; one bf16 step of
   ``TransferClassifier(ResNet50(num_classes=0), 10)`` at 128 x 224 px,
   backbone frozen, under ``sgd``, ``lion``, ``lamb``, ``adafactor`` and
   ``sgd`` with EMA (median of 20 synced steps each), the backbone
   bit-equal after all of them; the same step unfrozen (all 161 tensors
   train) under ``sgd``, ``lion``, ``lamb`` and ``adafactor`` (median of
   10 each), where the plain per-tensor optimizers cost most; then
   examples 03 (which registers its
   model and reads it back through ``load_model``) and 04 in this process
   on the card, 3 steps of 64 and an eval each, their K2 launches exact.
14. Streaming: 4,096 synthetic 224 px images from ``--seed`` (default 0;
   low-frequency, 1000 classes) written as a TFS volume (``ShardWriter``)
   and an MDS volume (``MDSWriter``) of at least 8 shards each, JPEG where
   PIL encodes and zstd where a codec exists, then streamed from that
   "remote" directory into a local cache.  The phase prints which
   ``decoder`` (``native``, ``pil`` or ``none``), ``codec`` (``native``,
   ``zstandard`` or ``none``) and ``resize`` (``pil`` or ``nearest``) ran.
   The producer ceiling: ``DataLoader(transfer_dtype="uint8")`` over
   ``uint8_image_transforms(224)`` with ``decode_min_hw=(224, 224)`` and an
   instant consumer, img/s for 1, 4 and ``min(16, cpu_count)`` thread
   workers and that many process workers.  Then phase 5's ResNet50-1K
   ``Trainer`` (bf16, K1 normalizing on the card) fed from the TFS volume
   for 12 batches of 128 through the ``DevicePrefetcher``, then from MDS,
   counters zeroed just before each and read just after: K1, K2a and K2b
   once a step; the first loss near ln 1000; after each, the same step on
   a device-resident batch (in turns), giving the data-fed and
   device-resident img/s, ``input_stall_pct`` = 1 - fed/resident and
   ``host_input_wait_frac``; one ``SystemMetricsMonitor.sample()`` mid-fit
   (``device0_mem_used_mb`` within 1 % of ``torch.cuda.memory_allocated``);
   the same TFS fit with half the workers, and over decoded uint8 arrays in
   host memory (the fit loop without decode); the card's busy share over
   steps 2 to 8 of a profiled data-fed fit.
   Example 01a through its own ``main`` (``Distributor``, one worker on the
   card, its defaults: 64 px, 200 classes, ResNet50, 2 epochs of 256),
   its worker's K1/K2a/K2b launches held exact and its five-image spot
   check; example 07 at ``--tp 1`` cut to 3 steps of 64 and an eval, in
   this process, its K1, K2 and K3 launches held exact.
15. Overlapped and fused data parallelism: two spawned gloo ranks train
   phase 10's ResNet50-1K (global batch 128, 4 batches and an eval)
   through ``Trainer(plan=ParallelPlan(mesh=rt.mesh, comms_groups=4,
   comms_fused=True), grad_compression="int8").fit()``, then through the
   staged single shot (``comms_groups=1, comms_fused=False``), then
   uncompressed (``Trainer(plan=...)``) with its buckets fired from the
   backward and with the hooks unarmed; counters zeroed just before each
   fit and read just after: K5a-K5c groups x steps on each rank, K1 and
   K2 at phase 10's counts.  Deterministic cuDNN: the grouped fused fit
   must equal the staged single shot bit for bit, the overlapped
   uncompressed fit the non-overlapped one, each on both ranks; the first
   loss near ln 1000.  Then the two-rank step of each arm (the wire at 1
   and 4 groups, staged and fused; uncompressed armed and not) alone, in
   turns, with its device-busy share (``torch.profiler``), printed beside
   the two-rank step recorded in PERF.md §5, which came from other runs.
16. ZeRO on one card: two spawned gloo ranks train ResNet50-1K under
   stages 0-3, offload and int8 ``zero_2`` (``zero_phase``), the
   GPT-2-small-width LM's memory against ``plan_memory``, examples 02 and
   02a through ``ZeroDistributor``.
17. Tensor and pipeline parallelism on one card (``tp_phase``): (a) the
   GPT-2-small-width LM under ``transformer_tp_rules`` on two gloo ranks,
   its first f32 loss and update against one process's unsharded run, the
   vocab-parallel loss's K2a/K2b on a shard against their plain versions,
   then 3 bf16 steps timed with each rank's K2a/K2b/K3a/K3b/K4 launches
   held exact; (b) ``PipelinedTransformerLM`` under ``compose(tp=2,
   pp=2)`` on four ranks, 8 sequences in 4 microbatches, each schedule's
   first loss bit-equal to the others' and held against (a)'s
   one-process loss, its step, hops and memory beside ``plan_memory``;
   (c) that state saved and restored into ``compose(tp=4)`` on the same
   ranks and into one process's plan here, bit-exact with one
   ``fault/reshard`` each, and another vocabulary refused before any read;
   (d) example 07 with ``--tp 2`` through the ``Distributor``.
18. Sequence parallelism and MoE on one card (``sp_phase``): (a) the ring
   and (b) Ulysses: ``long_ctx``'s LM (vocabulary 32,768, 12 x 64 heads,
   seq 8192, batch 2) on four gloo ranks (mesh seq 4, 2,048 positions a
   rank) with ``fused_adamw``, its first f32 loss and update at 2 layers
   against one process's blockwise step (loss 1e-5 relative, update 1e-3
   of its largest element), then 3 bf16 steps at 12 layers, each rank's
   launches held exact (K6a-K6c 12 (r + 1) a step on seq rank r under the
   ring, 12 under Ulysses; K3a/K3b 25 and K4 1, K2 none: the (B, L)
   labels take the plain per-position loss, as in phase 6) and its
   ``all_to_all_single`` calls (the ring 7 a layer a step, Ulysses 4);
   (c) ``gpt_small``'s widths with 8 experts, top 2, 8 sequences on data 2
   x expert 2 under ``moe_rules``: the f32 checks at 2 layers at the
   default capacity and at one that drops tokens, 3 bf16 steps at 12
   layers with K9a 12, K9b 24 and K9c 12 a step on each rank, and each
   rank's CUDA tensors beside ``plan_memory``; (d) example 06 through its
   workers three ways (Ulysses on seq 2; the ring with MoE on seq 2; full
   attention with MoE on expert 2), rank 0's K6 and K9 launches held
   exact; (e) K9a-K9c against their plain versions (K9a, K9b and K9c's
   dbuf bit-equal, K9c's dgate within 1e-5, +0.0 where a slot is not held,
   bit-equal on a rerun and for a row pair moved to another block) at the
   MoE path's shape, small and at Mixtral-8x7B's width (8,192 tokens x
   4,096 bf16, 8 experts, top 2), K9a and K9c writing NaN-filled outputs
   whole; a profiled ``_Dispatch`` launching K9a alone and a profiled
   ``_Combine`` backward K9c alone; K9a-K9c timed at the path's and the
   wide shape beside the plain versions, the library calls
   (``index_put_``, ``F.embedding_bag``) and the baseline kernels (K9a as
   ``zero_()`` plus its kernel, K9c as the scaled K9a and the gate
   gradient it replaces), K9b also beside its generic loop and a
   ``copy_`` of as many bytes, in turns, with the aims hit or missed; and
   K6's float32
   partials at the ring's tile, rounded to bf16 bit-equal to the default
   launches.
19. Fault tolerance on one card (``fault_phase``), every part a gate, each
   part's main path counted exactly: (a) phase 6's LM fit (8 steps,
   snapshots every 2) under the ``Supervisor`` with a ``PreemptNotice``
   during step 3: one ``fault/preempted``, one synchronous last-chance
   snapshot, a restart from the preemption budget with 0 s delay, with
   the seconds from the notice to ``Preempted`` (the save of the state
   apart) and from the restart to the first resumed step; (b) in the
   same supervised fit, its snapshot of step 6 torn (``TornCheckpoint``)
   and a ``ChaosError`` at the next step: one ``fault/quarantine``, a
   RETRYABLE restart resumed from the committed step 4; the fit of three
   attempts bit-equal (parameters and optimizer state) to an
   uninterrupted one;
   (c) example 01 (MNIST) through the ``Distributor`` and
   ``run_with_restarts`` on two gloo ranks, rank 1 SIGKILLed
   (``KillWorker``) before step 7: one RETRYABLE restart, ``"finished"``,
   resumed from the epoch-1 checkpoint, with the seconds to detect the
   loss and from the relaunch to the result; a worker whose fn raises
   ``Preempted`` exits 143; (d) ResNet50-1K on f32 host batches with NaN
   in three batches against ``max_bad=2``: skipped steps,
   ``Divergence``, the rollback to step 4 (``fault/rollback``), the next
   attempt at ``lr_scale`` 0.5 to the end with every parameter finite;
   (e) ResNet50-1K under ZeRO-1 with AdamW over ``fsdp`` on two gloo
   ranks under ``run_elastic(min_world_size=1)``, ``LoseRank(1)`` before
   step 6: worlds [2, 1], one ``fault/world_resized``, a
   ``fault/reshard``, no quarantine, the state restored at world 1 (from
   the epoch-end step 4) bit-equal to that checkpoint read back at two
   ranks, all 8 steps, with the reshard-restore seconds; (f) ResNet50-1K served (f32 requests): a
   ``QueueFlood`` sheds with the clients' p99 within the SLO tracker's
   target, a ``PoisonRequest`` is rejected and its batchmates are
   bit-equal to a clean run, a ``SlowConsumer`` is reported by the serve
   watchdog, and a watcher's notice through ``run_forever`` drains with
   no in-flight request dropped.  (c) and (e), whose time is mostly their
   launchers' workers starting on the host's cores, run from threads
   beside (a, b), (d) and (f); each part reads only its own events and
   counters.
20. Remote launch on one card (``remote_phase``): the multi-host launcher
   with two "hosts" on localhost, ``RemoteDistributor(["localhost",
   "localhost"], connect=lambda h: [])``, one agent (``python -m
   tpuframe_torch.launch.agent``) a rank, each part a gate: (a) the env
   contract as each agent sees it (``LOCAL_RANK`` 0 and 1,
   ``LOCAL_WORLD_SIZE`` 2, gloo on ``cuda:0``, this script's bytecode
   prefix inherited), a ``ControlPlane`` barrier, ``allgather_bytes`` and
   ``broadcast_bytes`` across the agents, and ``broadcast_run_id`` of a
   100-byte id back whole; (b) example 01 (MNIST)'s ``train_mnist`` run
   remotely and twice through the local ``Distributor`` with the same
   config and seed: the first loss bit-equal, rank 0's final eval loss
   and accuracy within the gap of the two local runs, the K2a/K2b
   launches equal, and each launcher's seconds from spawn to result; (c)
   rank 1 raises a typed exception, which surfaces as itself with a
   ``RemoteLaunchError`` (host, rank, exit code, stderr tail) as its
   cause; (d) an agent whose stdin closes exits 17 within 20 s, and a
   SIGKILLed agent behind a transport that lingers is found by its silent
   beacon, with the seconds to find it; (e) a ``Checkpointer.save`` of a
   small CUDA state whose ``FileSystemWriter.write_data`` fails once
   retries once, ticks ``ckpt/save_retries`` and commits (ROADMAP Queue 3
   item 29).  The launches of (a)-(d), mostly their workers starting on
   the host's cores, run from threads beside phase 19's parts
   (``remote_launches``); (e) runs once phase 19 has ended, so no other
   save is in flight in this process, and the phase's gates
   (``remote_report``) once every launch has returned.  Alone:
   ``remote_phase(card)``.
21. Compile plane on one card (``compile_phase``), every part a gate and
   a fresh process, run one stage after another on a thread beside
   phases 4 to 20 at ``SIDE_NICE`` (joined here; its timed parts and phase 18(e)'s
   timing of K9 hold one lock, ``card_timing``, so they never overlap):
   (e) path
   (B)'s time to first step (phase 5's ResNet50-1K Trainer without eval,
   from its construction to the end of its first step), eager, then with
   ``precompile=True`` on a cold cache, beside (a) path (A)'s precompile
   on a cold cache (ResNet50-1K bf16 behind ``ServeEngine(precompile=
   True)``: one Inductor compile with a dynamic batch and a bucket of one
   apart, a CUDA graph per bucket) and beside the f32 pairs: one
   precompiled f32 step against one eager step of path (B) (loss 1e-5
   relative, update within ROADMAP difference 2's 3e-2 of its norm) and of
   path (C) at 2 layers, its schedule's lr above 0 at the first step (the
   update within 1e-3 of its largest element, which must not be 0); then
   (c) the GPT-2-small LM (4 of its 12 layers, ``COMPILE_LM``) under
   ``fused_adamw`` with a warmup-cosine schedule, cold, fitted
   precompiled (K3a/K3b/K4, every step a replay of its graph), K4's lr read from the schedule's device table bit-equal to
   the host float, the graphed step against the eager one in turns
   (tokens/s, MFU, busy); then (e) on the warm cache (cache hits, no backend compile) and (b) its
   fit of 12 steps: the step dispatchable and each a replay, K1/K2a/K2b
   launches less the warm-up's equal to eager's, the graphed step against
   the eager step in turns (img/s, ``torch.profiler`` busy share), and the
   memory plane's ``memory/executable`` record of its graphed step (the
   track plane's (f)) beside ``max_memory_allocated`` over three replays; (a) on
   the warm cache and (d) a burst of 160 through it against the eager
   engine (K1 once a served batch, the logits within the bf16 tolerance).
   Beside (c), (f): ``long_ctx`` (2 x 8192 tokens, blockwise: K6a-K6c;
   6 of its 12 layers, ``COMPILE_LONG``), then ``long_remat``, each an
   eager fit then a precompiled graphed fit from the same weights (launches less the warm-up's eager's, the first
   loss within 2e-2, each fit's peak memory, ``long_remat``'s graphed
   peak below ``long_ctx``'s), the graphed step against the eager one in
   turns (tokens/s, MFU, busy, kernels a step), then an f32 pair of the
   blockwise LM at 2 layers (loss 1e-6, update 1e-3 of its largest
   element); with (b) and (d), (g): the MoE LM (K9a-K9c, 4 of its 12
   layers: ``COMPILE_MOE``) the same way, and f32 pairs at capacity
   factors 1.25 and 0.25.  No graph break in (f) or (g).  The timed
   parts hold ``card_timing``.  Alone: ``compile_phase(card)``.
22. Result: a ``kernels`` JSON line (each kernel with ``floor_ms``; K1 and
   K2 also with ``launches_ddp``, phase 10's count on each rank, and
   ``launches_streaming``, phase 14's TFS fit; K2a/K2b, K3a/K3b and K4
   with ``launches_tp`` and ``launches_tp_pp``, phase 17's counts on each
   rank, and ``launches_example07_tp2``; K4 with ``launches_zero``;
   K5a-K5c with ``launches_grouped``, phase 15's grouped fit on each rank,
   and ``launches_zero_int8``; K6 with
   ``launches_remat``, its share of the bound, ``baseline_ms``,
   ``speedup`` and ``ptxas``, the registers and spills of its bf16
   tensor-core kernel at each head dim, and ``launches_ring``,
   ``launches_ulysses`` and ``launches_example06``, phase 18's counts;
   K9a-K9c with ``launches_moe`` on each rank of phase 18's MoE LM and
   ``launches_example06``, ``baseline_ms``, ``bound_share``, ``x_floor``,
   ``turns_ms``, ``wide`` (the same at Mixtral's width), ``aims`` and
   ``ptxas``; K9b with ``any_k_ms`` and ``copy_ms``; K9c with
   ``baseline_saved_floors``; K1-K4 with ``launches_fault``, phase 19's
   counts by part; K2a/K2b with ``launches_remote``, phase 20's counts on
   rank 0 of the remote and the local runs; K1-K4 with
   ``launches_graphed``, phase 21's precompiled fits, and K1 with
   ``launches_graphed_serve``; K6 and K9 with ``launches_graphed`` and
   ``launches_graphed_warmup``, (f)'s ``long_ctx`` and (g)'s graphed fits,
   K6 with ``launches_graphed_remat``), the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Each phase's wall seconds are printed on a line of their own as it ends
(``phase N: ... s``), and at the start of phase 22 those of the phases
on gloo ranks (10, 15-20) and of all phases together.

One phase of 3 alone, for a short run on the card (the kernels it needs
are built at first use)::

    python3 -c "import torch, chip_smoke as cs; f = torch.empty(2**28, dtype=torch.uint8,
    device='cuda'); fl = cs.floor_phase(f); cs.kernel_phase(f, fl); cs.cross_entropy_phase(f, fl,
    cs.baseline_library(cs.start_baseline_build()))"

(one line; the break inside the quotes is harmless).  K6 against its
baseline alone: ``cs.blockwise_phase(f, cs.baseline_library(
cs.start_baseline_build(cs.BASELINE_K6)))``.  Phase 15 alone (its ranks
build what they launch, so build first)::

    python3 -c "import chip_smoke as cs; from tpuframe_torch.ops import build; build.build();
    print(cs.overlap_phase('H100'))"
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores


def bound(moved: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over HBM's rate and the float32 operations over its peak."""
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
BUCKETS = (1, 8, 32, 64)
N_REQUESTS = 160
N_CLIENTS = 4
# bf16 logits of one image served in a batch of up to 64 against the same
# image predicted alone: cuDNN picks other algorithms per batch shape, so
# every conv rounds its bf16 output at other places; over ~50 layers that
# stays within a few bf16 ulps (2**-8 each) of the logit scale
BF16_REL_TOL = 3e-2
# f32 forward on the card (TF32 off) against the CPU: only the order of the
# sums differs
F32_REL_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max().item())


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of one bf16 step at the value (its
    ulp: 2**-7 of the power of two at or below |want|) plus 1e-6.  At most
    1 where the two round float32 values a rounding apart, also where a
    value cancels to near zero (there a bf16 ulp is tiny and the ulp count
    of :func:`bf16_ulp_distance` is large)."""
    got, want = got.float(), want.float()
    _, exp = torch.frexp(want)  # |want| in [2**(exp-1), 2**exp)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    return float(((got - want).abs() / (ulp + 1e-6)).max())


def time_ms(fn, flush: torch.Tensor, iters: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, by CUDA events.  The flush reads a buffer larger than L2: a
    flush that writes would leave dirty lines whose write-back lands inside
    the timed launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.amax()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_jax_variables(template: dict, seed: int) -> dict:
    """Random weights in the JAX ResNet layout, from ``seed``: He-normal
    conv kernels, LeCun-normal ``fc``, and non-trivial BatchNorm scale,
    bias and running statistics."""
    rng = np.random.default_rng(seed)

    def fill(tree: dict, stats: bool) -> dict:
        out = {}
        for name in sorted(tree):
            v = tree[name]
            if isinstance(v, dict):
                out[name] = fill(v, stats)
                continue
            shape = np.shape(v)
            if name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                scale = np.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in)
                a = rng.normal(0.0, scale, shape)
            elif name == "mean":
                a = rng.normal(0.0, 0.1, shape)
            elif name == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif name == "scale":
                a = rng.uniform(0.2, 0.6, shape)
            else:  # BN and fc bias
                a = rng.normal(0.0, 0.05, shape)
            out[name] = a.astype(np.float32)
        return out

    return {"params": fill(template["params"], False),
            "batch_stats": fill(template["batch_stats"], True)}


def demangled(mangled: str) -> str:
    """A kernel's mangled name as ``name<template arguments>``: the last
    length-prefixed name, then its type (``f32``, ``bf16``) and integer and
    bool (0, 1) arguments."""
    if not mangled.startswith("_Z"):
        return mangled
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    rest = mangled[i:]
    if not rest.startswith("I"):
        return name
    targs = rest[1:rest.index("EE") + 1]
    args = [t for t, pat in (("f32", r"^f"), ("bf16", r"^13__nv_bfloat16")) if re.match(pat, targs)]
    return f"{name}<{','.join(args + re.findall(r'L[ib](\d+)E', targs))}>"


def ptxas_table(text: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from an
    ``nvcc -Xptxas -v`` log, each kernel named by its function and template
    arguments (``attn_bwd_dq_tc<64>``, ``attn_fwd_kernel<bf16,64>``)."""
    table, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = demangled(m.group(1))
            table[fn] = {"registers": None, "spill_stores": None, "spill_loads": None}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            table[fn]["spill_stores"], table[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[fn]["registers"] = int(m.group(1))
    return table


def floor_phase(flush) -> float:
    """The launch floor: the median CUDA-event time of the empty kernel
    (``csrc/launch_floor.cu``), launched from Python through ``ctypes`` as
    every kernel is, after the same L2 flush.  Every kernel's time below
    holds this much overhead."""
    from tpuframe_torch.ops import launch_floor

    before = launch_floor.launches
    launch_floor()
    torch.cuda.synchronize()
    check(launch_floor.launches == before + 1,
          f"launch floor counter moved {launch_floor.launches - before} for one launch")
    floor = min(time_ms(launch_floor, flush), time_ms(launch_floor, flush))
    return floor


def normalize_timings(flush, x) -> dict:
    """K1 on ``x`` (uint8 NHWC) into bf16, timed beside ``torch.addcmul``
    (one TensorIterator launch of b + x * w from uint8 into a bf16 out=,
    the same folded f32 constants; the port never calls it) and the plain
    version; calls in turns (plain, kernel, library, library, kernel,
    plain), the better of each pair kept."""
    from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference

    dev = x.device
    w_t = torch.tensor([(1 / 255) / s for s in STD], dtype=torch.float32, device=dev)
    b_t = torch.tensor([-m / s for m, s in zip(MEAN, STD)], dtype=torch.float32, device=dev)
    lib_out = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    library = functools.partial(torch.addcmul, b_t, x, w_t, out=lib_out)
    library()
    want = normalize_images_reference(x, MEAN, STD, out_dtype=torch.bfloat16)
    lib_ulps = bf16_ulp_distance(lib_out, want)
    check(lib_ulps <= 1, f"torch.addcmul yardstick: {lib_ulps} bf16 ulps from plain (tol 1)")
    kernel = functools.partial(normalize_images, x, MEAN, STD, out_dtype=torch.bfloat16)
    plain = functools.partial(normalize_images_reference, x, MEAN, STD,
                              out_dtype=torch.bfloat16)
    plain_ms = [time_ms(plain, flush)]
    kernel_ms = [time_ms(kernel, flush)]
    library_ms = [time_ms(library, flush), time_ms(library, flush)]
    kernel_ms.append(time_ms(kernel, flush))
    plain_ms.append(time_ms(plain, flush))
    n = x.numel()
    moved = n * 1 + n * 2  # uint8 in, bf16 out
    return {"shape": "x".join(map(str, x.shape)) + " uint8->bf16", "ms": min(kernel_ms),
            "plain_ms": min(plain_ms), "library_ms": min(library_ms),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes_moved": moved,
            "library_ulps": lib_ulps}


def kernel_phase(flush, floor_ms: float):
    """K1 against its plain version on the card: the runs path (C = 3 and
    C = 1 on aligned pointers) at every serve bucket, the train shape and
    element counts that are no multiple of 48, the general path (pointers
    1 byte off 16, 16 channels); then timed at the serve buckets and the
    train shape 128x224x224x3, beside ``torch.addcmul`` at 64 and 128."""
    from tpuframe_torch.ops.normalize import (
        normalize_images,
        normalize_images_reference,
    )

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def images(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    batches = {b: images((b, 224, 224, 3)) for b in BUCKETS + (TRAIN_BATCH,)}
    ragged = images((3, 17, 17, 3))  # 2,601 elements: 54 runs of 48 and 9 left
    odd = images((1, 5, 7, 3))  # 105: two vectors of 16 and a tail of 9
    flat = torch.empty(ragged.numel() + 1, dtype=torch.uint8, device=dev)
    unaligned = flat[1:].view(ragged.shape)  # contiguous, 1 byte off 16
    unaligned.copy_(ragged)
    gray = torch.from_numpy(rng.random((2, 28, 28, 1), dtype=np.float32)).to(dev)
    wide = images((3, 5, 7, 16))
    cases = [(f"{b}x224x224x3 uint8->bf16", batches[b], MEAN, STD, 1 / 255, torch.bfloat16)
             for b in BUCKETS + (TRAIN_BATCH,)]
    cases += [
        ("64x224x224x3 uint8->f32", batches[64], MEAN, STD, 1 / 255, torch.float32),
        (f"{TRAIN_BATCH}x224x224x3 uint8->f32", batches[TRAIN_BATCH], MEAN, STD, 1 / 255,
         torch.float32),
        ("3x17x17x3 uint8->f32", ragged, MEAN, STD, 1 / 255, torch.float32),
        ("3x17x17x3 uint8->bf16", ragged, MEAN, STD, 1 / 255, torch.bfloat16),
        ("1x5x7x3 uint8->bf16", odd, MEAN, STD, 1 / 255, torch.bfloat16),
        ("3x17x17x3 unaligned uint8->bf16", unaligned, MEAN, STD, 1 / 255,
         torch.bfloat16),
        ("2x28x28x1 f32 scale=1 ->f32", gray, (0.5,), (0.5,), 1.0, torch.float32),
        ("2x28x28x1 f32 scale=1 ->bf16", gray, (0.5,), (0.5,), 1.0, torch.bfloat16),
        ("3x5x7x16 uint8->bf16", wide, tuple(np.linspace(0.1, 0.9, 16)),
         tuple(np.linspace(0.2, 0.3, 16)), 1 / 255, torch.bfloat16),
    ]
    max_err = 0.0
    for name, x, mean, std, scale, out_dtype in cases:
        got = normalize_images(x, mean, std, scale=scale, out_dtype=out_dtype)
        want = normalize_images_reference(x, mean, std, scale=scale,
                                          out_dtype=out_dtype)
        torch.cuda.synchronize()
        check(got.dtype == out_dtype and got.shape == x.shape, f"{name}: {got.dtype} {got.shape}")
        err = float((got.float() - want.float()).abs().max().item())
        if out_dtype == torch.float32:
            check(err <= 1e-5, f"normalize {name}: max abs diff {err} > 1e-5")
            log(f"  normalize {name}: max abs diff {err:.3g} (tol 1e-5)")
        else:
            ulps = bf16_ulp_distance(got, want)
            check(ulps <= 1, f"normalize {name}: {ulps} bf16 ulps apart (tol 1)")
            log(f"  normalize {name}: max abs diff {err:.3g}, {ulps} bf16 ulp (tol 1)")
        if x is batches[64] and out_dtype == torch.bfloat16:
            max_err = err
        del got, want

    timed = {b: normalize_timings(flush, batches[b]) for b in (64, TRAIN_BATCH)}
    for b in BUCKETS[:-1]:
        kernel = functools.partial(normalize_images, batches[b], MEAN, STD,
                                   out_dtype=torch.bfloat16)
        n = batches[b].numel()
        timed[b] = {"shape": f"{b}x224x224x3 uint8->bf16",
                    "ms": min(time_ms(kernel, flush), time_ms(kernel, flush)),
                    "bound_ms": 3 * n / HBM_BYTES_PER_S * 1e3, "bytes_moved": 3 * n}
    for b in BUCKETS + (TRAIN_BATCH,):
        t = timed[b]
        extra = ""
        if t.get("library_ms") is not None:
            extra = (f", plain {t['plain_ms'] * 1e3:.2f} us, torch.addcmul "
                     f"{t['library_ms'] * 1e3:.2f} us ({t['library_ulps']} bf16 ulp from plain)")
        log(f"  normalize {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bytes_moved'] / 1e6:.2f} MB at 3.35 TB/s, "
            f"{100 * t['bound_ms'] / t['ms']:.1f} %), {t['ms'] / floor_ms:.2f}x the floor{extra}")
    main = timed[64]
    return {
        "name": "normalize",
        "route": "cuda",
        "source": "tpuframe_torch/csrc/normalize.cu",
        "replaces": "tpuframe/ops/normalize.py:48",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],  # torch.addcmul into a bf16 out=
        "shape": main["shape"],
        "bytes_moved": main["bytes_moved"],
        "buckets_ms": {str(b): timed[b]["ms"] for b in BUCKETS},
        "train": {k: v for k, v in timed[TRAIN_BATCH].items() if k != "library_ulps"},
    }


BASELINE_CE = Path(__file__).resolve().parent / "tests" / "csrc" / "cross_entropy_baseline.cu"
#: K6 before its bf16 backward moved to the tensor cores (every product a
#: float32 FMA), its entry points renamed tf_blockwise_attention_baseline_*
BASELINE_K6 = Path(__file__).resolve().parent / "tests" / "csrc" / "blockwise_attention_baseline.cu"
#: K9a and K9b before their redesign (a warp a slot or a token, scalar
#: loads; K9a after a separate zero fill), renamed tf_moe_*_baseline
BASELINE_K9 = Path(__file__).resolve().parent / "tests" / "csrc" / "moe_gating_baseline.cu"
#: K9b's generic loop over the top-k at any K (the port's own source,
#: included), tf_moe_combine_any_k: the yardstick of its top-k instances
ANY_K_K9B = Path(__file__).resolve().parent / "tests" / "csrc" / "moe_combine_any_k.cu"
#: the combine's backward before K9c was folded into it: the scaled
#: dispatch, then the gate gradient, tf_moe_{dispatch_scaled,gate_grad}_baseline
BASELINE_K9C = Path(__file__).resolve().parent / "tests" / "csrc" / "moe_gate_grad_baseline.cu"


def start_baseline_build(source: Path = BASELINE_CE):
    """Start ``nvcc`` on a baseline kernel source (the K2 design before
    saved row statistics, ``BASELINE_CE``, K6's FMA design,
    ``BASELINE_K6``, K9a and K9b before their redesign, ``BASELINE_K9``,
    K9b's generic loop, ``ANY_K_K9B``, or the combine's backward as two
    launches, ``BASELINE_K9C``) with the port's flags, beside
    :func:`build.build`'s; :func:`baseline_library` waits for it.  The
    library's name hashes the source, the files it includes by a relative
    ``#include "..."`` and the flags.  Returns ``(source, process or None,
    temporary output, library path)``."""
    import hashlib

    from tpuframe_torch.ops import build

    text = source.read_bytes()
    included = re.findall(rb'^#include "([^"]+)"', text, flags=re.M)
    digest = hashlib.sha256(b"".join([text] + [(source.parent / inc.decode()).read_bytes()
                                               for inc in included])
                            + " ".join(build.NVCC_FLAGS).encode())
    out = build.BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return source, None, None, out
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(tmp),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return source, proc, tmp, out


def baseline_library(handle, timeout_s: float = 600.0):
    """The built baseline library, its C signatures declared (K2's: the ones
    without statistics; K6's: those of ``ops/blockwise_attention.py``;
    K9's: dispatch and combine as ``ops/moe_gating.py`` declared them
    before the dispatch took ``count``; K9b's generic loop: the combine's;
    K9c's pair: the scaled dispatch and the gate gradient as
    ``ops/moe_gating.py`` declared them before K9c was folded).
    The ``ptxas`` lines of its build, if it was built here, are in
    ``lib.build_log``."""
    import ctypes

    source, proc, tmp, out = handle
    log_text = ""
    if proc is not None:
        log_text, _ = proc.communicate(timeout=timeout_s)
        check(proc.returncode == 0 and tmp.exists(),
              f"nvcc failed to build {source.name}:\n{log_text}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.build_log = log_text
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if source == BASELINE_K6:
        shape = [i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
        lib.tf_blockwise_attention_baseline_fwd.argtypes = [ptr] * 5 + shape
        lib.tf_blockwise_attention_baseline_bwd_dq.argtypes = [ptr] * 8 + shape
        lib.tf_blockwise_attention_baseline_bwd_dkv.argtypes = [ptr] * 8 + shape
        for fn in (lib.tf_blockwise_attention_baseline_fwd,
                   lib.tf_blockwise_attention_baseline_bwd_dq,
                   lib.tf_blockwise_attention_baseline_bwd_dkv):
            fn.restype = i32
        return lib
    if source == BASELINE_K9:
        for fn in (lib.tf_moe_dispatch_baseline, lib.tf_moe_combine_baseline):
            fn.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]  # N K D capacity dtype stream
            fn.restype = i32
        return lib
    if source == ANY_K_K9B:
        lib.tf_moe_combine_any_k.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]  # as tf_moe_combine
        lib.tf_moe_combine_any_k.restype = i32
        return lib
    if source == BASELINE_K9C:
        # N K D capacity (E_local) dtype stream
        lib.tf_moe_dispatch_scaled_baseline.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.tf_moe_gate_grad_baseline.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.tf_moe_dispatch_scaled_baseline.restype = i32
        lib.tf_moe_gate_grad_baseline.restype = i32
        return lib
    lib.tf_cross_entropy_fwd.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.tf_cross_entropy_bwd.argtypes = [ptr] * 3 + [ctypes.c_longlong, ptr] + [i32] * 4 + [ptr]
    lib.tf_cross_entropy_fwd.restype = lib.tf_cross_entropy_bwd.restype = i32
    return lib


def cross_entropy_phase(flush, floor_ms: float, baseline) -> list[dict]:
    """K2a and K2b against their plain versions at the train path's shapes,
    at every path of the forward (rows in registers, streamed, element by
    element, a block per row) and ragged ones, with labels at 0, at K - 1
    and on the row's maximum; K2b from the forward's row statistics (the
    train path) bit-equal to K2b without them.  Then timed at (128, 1000)
    and (16384, 1000), f32 and bf16, beside the plain version, the library
    call, the launch floor and ``baseline`` (the design before saved
    statistics), in turns."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.cross_entropy import (
        _LABEL_CODES,
        _LOGIT_CODES,
        cross_entropy_bwd,
        cross_entropy_bwd_reference,
        cross_entropy_fwd,
        cross_entropy_reference,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)

    def inputs(b, k, dtype, label_dtype=torch.int64, edges=False):
        logits = (rng.standard_normal((b, k)) * 3).astype(np.float32)
        labels = rng.integers(0, k, (b,))
        if edges:  # rows labelled 0, K - 1, and a label on the row's maximum
            labels[0::3], labels[1::3] = 0, k - 1
            logits[2::3][np.arange(len(labels[2::3])), labels[2::3]] = 20.0
        g = torch.from_numpy(rng.uniform(0.5, 2.0, b).astype(np.float32))
        return (torch.from_numpy(logits).to(dtype).to(dev),
                torch.from_numpy(labels).to(label_dtype).to(dev), g.to(dev))

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    cases = [
        ("128x1000 f32 int64", 128, 1000, torch.float32, torch.int64, False),
        ("128x1000 f32 int32", 128, 1000, torch.float32, torch.int32, False),
        # phase 10's logits on each of its two ranks
        ("64x1000 f32", 64, 1000, torch.float32, torch.int64, False),
        ("64x1000 bf16", 64, 1000, torch.bfloat16, torch.int64, False),
        ("130x1000 bf16", 130, 1000, torch.bfloat16, torch.int64, False),
        ("3x10 f32", 3, 10, torch.float32, torch.int64, False),
        ("3x10 bf16", 3, 10, torch.bfloat16, torch.int32, False),
        ("16384x1000 f32", 16384, 1000, torch.float32, torch.int64, False),
        ("16384x1000 bf16", 16384, 1000, torch.bfloat16, torch.int64, False),
        ("128x1000 f32, stride-0 g", 128, 1000, torch.float32, torch.int64, True),
        ("128x1000 bf16, stride-0 g", 128, 1000, torch.bfloat16, torch.int64, True),
    ]
    # the forward's paths at their edges: rows in registers up to 1024 f32
    # and 2048 bf16, streamed up to 4096, a block per row above; element
    # loads where K is no multiple of the 16-byte chunk.  A third of the
    # rows put the row's maximum on the label, where the softmax is 1 less
    # a small sum: the plain version's float32 exponentials lose most there,
    # so the backward on these cases is held against the float64 softmax
    cases += [(f"{b}x{k} {'f32' if dt == torch.float32 else 'bf16'} {str(ldt)[6:]}, edge labels",
               b, k, dt, ldt, False)
              for b, k, dt, ldt in ((128, 1000, torch.float32, torch.int32),
                                    (128, 1000, torch.bfloat16, torch.int64),
                                    (128, 1001, torch.float32, torch.int64),
                                    (128, 1024, torch.float32, torch.int64),
                                    (16, 2048, torch.bfloat16, torch.int32),
                                    (16, 4096, torch.float32, torch.int64),
                                    (16, 4097, torch.float32, torch.int32),
                                    (1, 1000, torch.float32, torch.int64),
                                    (16384, 1000, torch.float32, torch.int64),
                                    (16384, 1001, torch.float32, torch.int64))]
    err = {"fwd": 0.0, "bwd": 0.0}
    for name, b, k, dtype, ldt, stride0 in cases:
        logits, labels, g = inputs(b, k, dtype, ldt, edges="edge labels" in name)
        if stride0:
            g = torch.full((), 1.0 / b, device=dev).expand(b)
        loss = cross_entropy_fwd(logits, labels)
        loss_s, stats = cross_entropy_fwd(logits, labels, with_stats=True)
        grad = cross_entropy_bwd(logits, labels, g)
        grad_s = cross_entropy_bwd(logits, labels, g, stats)
        want_loss = cross_entropy_reference(logits, labels)
        want_grad = cross_entropy_bwd_reference(logits, labels, g)
        note = ""
        if "edge labels" in name:
            onehot = F.one_hot(labels.long(), k).double()
            exact = (torch.softmax(logits.double(), -1) - onehot) * g.double()[:, None]
            note = (f"; against the float64 softmax: K2b "
                    f"{float((grad_s.double() - exact).abs().max()):.3g}, plain "
                    f"{float((want_grad.double() - exact).abs().max()):.3g}")
            want_grad = exact.to(dtype)
        torch.cuda.synchronize()
        check(loss.shape == (b,) and loss.dtype == torch.float32, f"K2a {name}: {loss.shape}")
        check(torch.equal(loss, loss_s), f"K2a {name}: the statistics moved the loss")
        check(grad_s.shape == (b, k) and grad_s.dtype == dtype, f"K2b {name}: {grad_s.dtype}")
        # the statistics are the ones the stats-less K2b takes itself
        check(torch.equal(bits(grad_s), bits(grad)),
              f"K2b {name}: from the statistics not bit-equal to the stats-less K2b")
        e_loss = float((loss - want_loss).abs().max())
        e_grad = float((grad_s.float() - want_grad.float()).abs().max())
        # losses of O(10): 1e-5 absolute; f32 gradients 1e-6 absolute; bf16
        # gradients within one bf16 step of the plain value (of the float64
        # softmax on the edge cases)
        check(e_loss <= 1e-5, f"K2a {name}: max abs diff {e_loss} > 1e-5")
        if dtype == torch.float32:
            check(e_grad <= 1e-6, f"K2b {name}: max abs diff {e_grad} > 1e-6")
            tol = "1e-6"
        else:
            ulps = bf16_ulp_distance(grad_s, want_grad)
            check(ulps <= 1, f"K2b {name}: {ulps} bf16 ulps apart (tol 1)")
            tol = f"{ulps} bf16 ulp, tol 1"
        log(f"  cross entropy {name}: K2a max abs diff {e_loss:.3g} (tol 1e-5), "
            f"K2b {e_grad:.3g} ({tol}), bit-equal without statistics{note}")
        if name == "128x1000 f32 int64":
            err = {"fwd": e_loss, "bwd": e_grad}

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def timed(b, k, dtype):
        logits, labels, g = inputs(b, k, dtype)
        loss_buf = torch.empty(b, dtype=torch.float32, device=dev)
        grad_buf = torch.empty((b, k), dtype=dtype, device=dev)
        codes = (_LOGIT_CODES[dtype], _LABEL_CODES[labels.dtype])
        # the baseline on the same inputs, bit-equal to the stats-less kernel
        check(baseline.tf_cross_entropy_fwd(logits.data_ptr(), labels.data_ptr(),
                                            loss_buf.data_ptr(), b, k, *codes, stream()) == 0,
              "baseline K2a launch")
        check(baseline.tf_cross_entropy_bwd(logits.data_ptr(), labels.data_ptr(), g.data_ptr(),
                                            1, grad_buf.data_ptr(), b, k, *codes,
                                            stream()) == 0, "baseline K2b launch")
        loss, stats = cross_entropy_fwd(logits, labels, with_stats=True)
        grad = cross_entropy_bwd(logits, labels, g, stats)
        torch.cuda.synchronize()
        # the same arithmetic: held at the kernels' tolerances, bits logged
        check(float((loss_buf - loss).abs().max()) <= 1e-6
              and (float((grad_buf.float() - grad.float()).abs().max()) <= 1e-6
                   if dtype == torch.float32 else bf16_ulp_distance(grad_buf, grad) <= 1),
              f"baseline K2 at {b}x{k} disagrees with the kernels")
        log(f"  baseline K2 at {b}x{k} {str(dtype)[6:]}: loss bit-equal "
            f"{torch.equal(loss_buf, loss)}, gradient bit-equal "
            f"{torch.equal(bits(grad_buf), bits(grad))}")
        x = logits.detach().float().requires_grad_(True)
        lib_loss = F.cross_entropy(x, labels, reduction="none")
        lib_err = (lib_loss.detach() - cross_entropy_reference(logits, labels)).abs().max()
        check(float(lib_err) <= 1e-5, "F.cross_entropy yardstick disagrees with the plain forward")
        lib_x = logits.detach().requires_grad_(True)
        lib_loss = F.cross_entropy(lib_x, labels, reduction="none")
        arms = {
            "fwd": {
                "kernel": functools.partial(cross_entropy_fwd, logits, labels, with_stats=True),
                "no_stats": functools.partial(cross_entropy_fwd, logits, labels),
                "baseline": lambda: baseline.tf_cross_entropy_fwd(
                    logits.data_ptr(), labels.data_ptr(), loss_buf.data_ptr(), b, k, *codes,
                    stream()),
                "plain": functools.partial(cross_entropy_reference, logits, labels),
                "library": functools.partial(F.cross_entropy, logits, labels, reduction="none"),
            },
            "bwd": {
                "kernel": functools.partial(cross_entropy_bwd, logits, labels, g, stats),
                "no_stats": functools.partial(cross_entropy_bwd, logits, labels, g),
                "baseline": lambda: baseline.tf_cross_entropy_bwd(
                    logits.data_ptr(), labels.data_ptr(), g.data_ptr(), 1, grad_buf.data_ptr(),
                    b, k, *codes, stream()),
                "plain": functools.partial(cross_entropy_bwd_reference, logits, labels, g, stats),
                "library": lambda: torch.autograd.grad(lib_loss, lib_x, g, retain_graph=True),
            },
        }
        esize = logits.element_size()
        out = {}
        for which, arm in arms.items():
            order = ["plain", "baseline", "kernel", "no_stats", "library"]
            times = {name: [] for name in order}
            for name in order + order[::-1]:  # in turns, each arm twice
                times[name].append(time_ms(arm[name], flush))
            # each input read once, each output written once: logits, int64
            # labels (B*8), g (B*4) and the statistics (B*8) the backward
            # reads or the forward writes; the loss (B*4) or the gradient
            stats_bytes = b * 8
            moved = (b * k * esize + b * 8 + b * 4 + stats_bytes if which == "fwd"
                     else 2 * b * k * esize + b * 8 + b * 4 + stats_bytes)
            best = {name: min(v) for name, v in times.items()}
            out[which] = {"ms": best["kernel"], "no_stats_ms": best["no_stats"],
                          "baseline_ms": best["baseline"], "plain_ms": best["plain"],
                          "library_ms": best["library"], "runs_ms": times,
                          "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bytes_moved": moved}
        return out

    shapes = {f"{b}x{k} {tag}": (b, k, dt) for b, k in ((128, 1000), (16384, 1000))
              for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    timings = {name: timed(*shape) for name, shape in shapes.items()}
    rows = []
    for which, name, line in (("fwd", "cross_entropy_fwd", 49), ("bwd", "cross_entropy_bwd", 60)):
        for shape, t in timings.items():
            r = t[which]
            log(f"  {name} {shape}: kernel {r['ms'] * 1e3:.2f} us ({r['ms'] / floor_ms:.2f}x the "
                f"floor, {r['bound_ms'] / r['ms'] * 100:.1f} % of the bound), without statistics "
                f"{r['no_stats_ms'] * 1e3:.2f} us, baseline {r['baseline_ms'] * 1e3:.2f} us, plain "
                f"{r['plain_ms'] * 1e3:.2f} us, library {r['library_ms'] * 1e3:.2f} us, bound "
                f"{r['bound_ms'] * 1e3:.3f} us ({r['bytes_moved'] / 1e6:.2f} MB at 3.35 TB/s) "
                f"on {floor_ms * 1e3:.2f} us floor")
        s = timings["128x1000 f32"][which]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "tpuframe_torch/csrc/cross_entropy.cu",
            "replaces": f"tpuframe/ops/cross_entropy.py:{line}",
            "launches": None,  # filled from the main path's run
            "max_abs_err": err[which],
            **{k: s[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "no_stats_ms",
                                 "baseline_ms", "bytes_moved")},
            "bound_by": "bytes",
            "shape": "128x1000 f32, int64 labels, with the row statistics",
            "at": {shape: {k: v for k, v in t[which].items() if k != "runs_ms"}
                   for shape, t in timings.items() if shape != "128x1000 f32"},
        })
    return rows


def layer_norm_phase(flush) -> list[dict]:
    """K3a and K3b against their plain versions at the LM path's (16384,
    768) bf16 with bf16 scale and bias (the bf16 policy casts them), in f32
    and at a ragged (1000, 300), then timed at the path's shape beside the
    plain versions and the library calls."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.layer_norm import (
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_fwd,
        layer_norm_reference,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    path = (16384, 768)

    def inputs(rows, d, dtype):
        x = (rng.standard_normal((rows, d)) * 2 + 0.5).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
        bias = rng.normal(0, 0.3, d).astype(np.float32)
        g = rng.standard_normal((rows, d)).astype(np.float32)
        return tuple(torch.from_numpy(a).to(dtype).to(dev) for a in (x, scale, bias, g))

    cases = [("16384x768 bf16", *path, torch.bfloat16), ("16384x768 f32", *path, torch.float32),
             ("1000x300 f32", 1000, 300, torch.float32),
             ("1000x300 bf16", 1000, 300, torch.bfloat16)]
    err = {}
    for name, rows, d, dtype in cases:
        x, scale, bias, g = inputs(rows, d, dtype)
        y = layer_norm_fwd(x, scale, bias)
        dx, dscale, dbias = layer_norm_bwd(x, scale, g)
        want_y = layer_norm_reference(x, scale, bias)
        want_dx, want_ds, want_db = layer_norm_bwd_reference(x, scale, g)
        torch.cuda.synchronize()
        check(y.dtype == dx.dtype == dtype and dscale.dtype == dbias.dtype == dtype
              and y.shape == dx.shape == x.shape, f"K3 {name}: {y.dtype} {dx.dtype} {dscale.dtype}")
        e_y = float((y.float() - want_y.float()).abs().max())
        e_dx = float((dx.float() - want_dx.float()).abs().max())
        e_ds = float((dscale.float() - want_ds.float()).abs().max())
        e_db = float((dbias.float() - want_db.float()).abs().max())
        if dtype == torch.float32:
            # O(1) values, sums over the row in another order: 1e-5 absolute.
            # dscale and dbias sum `rows` terms in another order (per lane,
            # per warp, then the blocks' partials): within 2e-5 of each
            # column's sum of |terms|
            xf = x.float()
            mu = xf.mean(-1, keepdim=True)
            xhat = (xf - mu) * torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + 1e-6)
            ok_s = bool(((dscale - want_ds).abs() <= 2e-5 * (g * xhat).abs().sum(0) + 1e-6).all())
            ok_b = bool(((dbias - want_db).abs() <= 2e-5 * g.abs().sum(0) + 1e-6).all())
            check(e_y <= 1e-5 and e_dx <= 1e-5 and ok_s and ok_b,
                  f"K3 {name}: y {e_y}, dx {e_dx} (tol 1e-5), dscale {e_ds} ({ok_s}), "
                  f"dbias {e_db} ({ok_b})")
            tol = "1e-5; dscale/dbias 2e-5 of the column's sum of |terms|"
        else:
            # one bf16 step of the value (y and dx cancel to near zero
            # where x is near its row's mean: there the kernel's fused
            # multiply-adds and the plain version's separate roundings
            # land a few float32 roundings apart)
            steps = [round(bf16_steps(a, b), 3) for a, b in
                     ((y, want_y), (dx, want_dx), (dscale, want_ds), (dbias, want_db))]
            check(max(steps) <= 1, f"K3 {name}: bf16 steps y/dx/dscale/dbias {steps} (tol 1)")
            tol = f"bf16 steps y/dx/dscale/dbias {steps}, tol 1"
        log(f"  layer norm {name}: K3a max abs diff {e_y:.3g}, K3b dx {e_dx:.3g}, dscale "
            f"{e_ds:.3g}, dbias {e_db:.3g} ({tol})")
        if (rows, d) == path and dtype == torch.bfloat16:
            err = {"fwd": e_y, "bwd": max(e_dx, e_ds, e_db)}
        again = layer_norm_bwd(x, scale, g)
        check(all(torch.equal(a, b) for a, b in zip((dx, dscale, dbias), again)),
              f"K3b {name}: a rerun gave other bits")

    rows, d = path
    x, scale, bias, g = inputs(rows, d, torch.bfloat16)
    xl, sl, bl = (t.detach().requires_grad_(True) for t in (x, scale, bias))
    lib_y = F.layer_norm(xl, (d,), sl, bl, eps=1e-6)
    lib_steps = bf16_steps(lib_y.detach(), layer_norm_reference(x, scale, bias))
    log(f"  F.layer_norm yardstick 16384x768 bf16: within {lib_steps:.3g} bf16 steps of the "
        "plain version (it takes a two-pass variance)")
    arms = {
        "fwd": (functools.partial(layer_norm_fwd, x, scale, bias),
                functools.partial(layer_norm_reference, x, scale, bias),
                functools.partial(F.layer_norm, x, (d,), scale, bias, eps=1e-6)),
        "bwd": (functools.partial(layer_norm_bwd, x, scale, g),
                functools.partial(layer_norm_bwd_reference, x, scale, g),
                lambda: torch.autograd.grad(lib_y, (xl, sl, bl), g, retain_graph=True)),
    }
    elem = rows * d
    # each input read once, each output written once (bf16): x and y, plus
    # scale and bias; x, g and dx, plus scale, dscale and dbias.  About 8
    # float32 operations an element forward, 16 backward
    moved = {"fwd": 2 * elem * 2 + 2 * d * 2, "bwd": 3 * elem * 2 + 3 * d * 2}
    flops = {"fwd": 8 * elem, "bwd": 16 * elem}
    rows_out = []
    for which, name, line in (("fwd", "layer_norm_fwd", 51), ("bwd", "layer_norm_bwd", 64)):
        kernel, plain, library = arms[which]
        plain_ms = [time_ms(plain, flush)]
        kernel_ms = [time_ms(kernel, flush)]
        library_ms = [time_ms(library, flush), time_ms(library, flush)]
        kernel_ms.append(time_ms(kernel, flush))
        plain_ms.append(time_ms(plain, flush))
        bound_ms, bound_by = bound(moved[which], flops[which])
        r = {"name": name, "route": "cuda", "source": "tpuframe_torch/csrc/layer_norm.cu",
             "replaces": f"tpuframe/ops/layer_norm.py:{line}", "launches": None,
             "max_abs_err": err[which], "ms": min(kernel_ms), "plain_ms": min(plain_ms),
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": min(library_ms),
             "shape": "16384x768 bf16, bf16 scale/bias", "bytes_moved": moved[which]}
        log(f"  {name} 16384x768 bf16: kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {r['library_ms'] * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({moved[which] / 1e6:.2f} MB at 3.35 TB/s)")
        rows_out.append(r)
    rows_out[1].update(layer_norm_bwd_detail(flush, inputs, layer_norm_bwd, arms["bwd"][0]))
    return rows_out


def layer_norm_bwd_detail(flush, inputs, layer_norm_bwd, path_call) -> dict:
    """K3b beyond the path's shape: its time at (16384, 768) f32 and at the
    ragged (1000, 300) (the element path), and where a call at the path's
    shape spends its device time, kernel by kernel (``torch.profiler``)."""
    ms_by_shape = {}
    for name, rows, d, dtype in (("16384x768 f32", 16384, 768, torch.float32),
                                 ("1000x300 f32", 1000, 300, torch.float32),
                                 ("1000x300 bf16", 1000, 300, torch.bfloat16)):
        x, scale, _, g = inputs(rows, d, dtype)
        ms_by_shape[name] = time_ms(functools.partial(layer_norm_bwd, x, scale, g), flush)
    split = kernel_split(path_call)
    log("  layer_norm_bwd at other shapes: " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in ms_by_shape.items()))
    log("  layer_norm_bwd 16384x768 bf16, device time by kernel (profiler, no flush): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in split.items()))
    return {"ms_by_shape": ms_by_shape, "profile_split_us": split}


ADAMW_HP = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def adamw_leaf(gen, shape, dtype=torch.float32, offset: int = 0):
    """(p, g, m, v) on the card from ``gen``; ``offset`` > 0 places each
    array that many elements into a larger buffer (off the vector
    alignment)."""
    dev = torch.device("cuda")
    n = int(np.prod(shape))

    def place(t):
        if not offset:
            return t
        flat = torch.empty(n + offset, dtype=t.dtype, device=dev)
        out = flat[offset:].view(shape)
        out.copy_(t)
        return out

    p = torch.randn(shape, generator=gen, device=dev).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
    m = torch.randn(shape, generator=gen, device=dev) * 0.1
    v = torch.rand(shape, generator=gen, device=dev) * 0.1
    return tuple(place(t) for t in (p, g, m, v))


def adamw_phase(flush, shapes) -> dict:
    """K4 against its plain version: one multi-tensor launch over
    ``shapes`` (the LM's parameter tensors) plus a view one element off the
    vector alignment, a ragged 257 x 130 list with ``b1 = 0``, a bf16 list,
    and a list longer than one launch's table; each within 1e-6 of the plain
    version (a bf16 parameter within one bf16 step) and bit-equal to
    one-entry calls per tensor.  Then one optimizer step over ``shapes``,
    timed (:func:`adamw_step_times`)."""
    from tpuframe_torch.ops.fused_adamw import (
        TABLE_CAPACITY,
        fused_adamw_multi_update_,
        fused_adamw_update_,
        fused_adamw_update_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    count = torch.full((), 7, dtype=torch.int32, device=dev)
    lm = [adamw_leaf(gen, s) for s in shapes]
    cases = [
        (f"{len(shapes)} LM tensors + 1001 off by one", lm + [adamw_leaf(gen, (1001,), offset=1)],
         ADAMW_HP),
        ("257x130 + 33x7 f32, b1 = 0", [adamw_leaf(gen, (257, 130)), adamw_leaf(gen, (33, 7))],
         dict(lr=1e-2, b1=0.0, b2=0.999, eps=1e-8, weight_decay=0.01)),
        ("bf16 4096x768 + 768 + 1001 off by one",
         [adamw_leaf(gen, (4096, 768), torch.bfloat16), adamw_leaf(gen, (768,), torch.bfloat16),
          adamw_leaf(gen, (1001,), torch.bfloat16, offset=1)], ADAMW_HP),
        (f"{TABLE_CAPACITY + 3} small tensors (over one table)",
         [adamw_leaf(gen, (int(k),)) for k in
          np.random.default_rng(5).integers(1, 3000, TABLE_CAPACITY + 3)], ADAMW_HP),
    ]
    worst = 0.0
    for name, leaves, hp in cases:
        want = [fused_adamw_update_reference(p, g, m, v, count, **hp) for p, g, m, v in leaves]
        multi = [(p.clone(), m.clone(), v.clone()) for p, _, m, v in leaves]
        single = [(p.clone(), m.clone(), v.clone()) for p, _, m, v in leaves]
        l0 = fused_adamw_multi_update_.launches
        fused_adamw_multi_update_([t[0] for t in multi], [lf[1] for lf in leaves],
                                  [t[1] for t in multi], [t[2] for t in multi],
                                  [count] * len(leaves), **hp)
        launches = fused_adamw_multi_update_.launches - l0
        for (p, m, v), (_, g, _, _) in zip(single, leaves):
            fused_adamw_update_(p, g, m, v, count, **hp)
        torch.cuda.synchronize()
        expect = -(-len(leaves) // TABLE_CAPACITY)
        same = all(torch.equal(a, b) for got, one in zip(multi, single) for a, b in zip(got, one))
        err_mv = max(float((a - b).abs().max()) for got, w in zip(multi, want)
                     for a, b in zip(got[1:], w[1:]))
        if leaves[0][0].dtype == torch.bfloat16:
            err_p = max(bf16_steps(got[0], w[0]) for got, w in zip(multi, want))
            ok = err_mv <= 1e-6 and err_p <= 1
            tol = f"m/v {err_mv:.3g} (tol 1e-6), p {err_p:.3g} bf16 steps (tol 1)"
        else:
            err = max(err_mv, max(float((got[0] - w[0]).abs().max())
                                  for got, w in zip(multi, want)))
            worst = max(worst, err)
            ok = err <= 1e-6
            tol = f"max abs diff {err:.3g} (tol 1e-6)"
        # the same float32 expression (the compiler may fuse a multiply-add)
        log(f"  fused AdamW, {name}: {launches} launch(es) (expected {expect}); {tol}; "
            f"bit-equal to one-entry calls: {same}")
        check(ok and same and launches == expect, f"K4 {name}: {tol}, launches {launches}, "
              f"bit-equal {same}")
    del cases, want, multi, single

    # the library yardstick: torch's fused AdamW over the same tensors.  From
    # zero moments at step 1 it gives the same update as the plain version
    params = [torch.nn.Parameter(p.clone()) for p, _, _, _ in lm]
    for prm, (_, g, _, _) in zip(params, lm):
        prm.grad = g.clone()
    hp = ADAMW_HP
    lib = torch.optim.AdamW(params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]), eps=hp["eps"],
                            weight_decay=hp["weight_decay"], fused=True)
    lib.step()
    one_count = torch.ones((), dtype=torch.int32, device=dev)
    lib_err = 0.0
    for prm, (p, g, _, _) in zip(params, lm):
        zeros = torch.zeros_like(p)
        want = fused_adamw_update_reference(p, g, zeros, zeros, one_count, **hp)[0]
        lib_err = max(lib_err, float((prm.detach() - want).abs().max()))
    log(f"  torch.optim.AdamW(fused=True) yardstick: first step within {lib_err:.3g} of the "
        "plain version")
    del lm, params, lib
    torch.cuda.empty_cache()

    t = adamw_step_times(flush, shapes)
    n = t["parameters"]
    moved = n * 4 * 7  # p, g, m, v read; p, m, v written; float32
    bound_ms, bound_by = bound(moved, 16 * n)  # about 16 float32 operations an element
    r = {"name": "fused_adamw", "route": "cuda", "source": "tpuframe_torch/csrc/fused_adamw.cu",
         "replaces": "tpuframe/ops/fused_adamw.py:55", "launches": None, "max_abs_err": worst,
         "ms": t["step_ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": t["library_ms"],
         "per_tensor_ms": t["per_tensor_ms"], "profile_split_us": t["split_us"],
         "shape": f"FusedAdamW.step() over {len(shapes)} f32 tensors, {n} parameters",
         "bytes_moved": moved}
    log(f"  fused_adamw bound {bound_ms:.3f} ms ({moved / 1e9:.2f} GB at 3.35 TB/s): step at "
        f"{bound_ms / r['ms']:.1%} of it; {r['library_ms'] / r['ms']:.3f}x the speed of "
        "AdamW(fused=True)")
    return r


def adamw_step_times(flush, shapes, hp=ADAMW_HP) -> dict:
    """One optimizer step over float32 tensors of ``shapes``, timed in
    turns (median of 20 steps, L2 flushed before each): ``FusedAdamW.step()``
    (what the Trainer runs: the counts' one increment, then K4), ``torch.
    optim.AdamW(fused=True).step()``, the per-tensor loop of
    ``fused_adamw_update_`` (one K4 launch a tensor), and the plain
    version; then the device time of one ``FusedAdamW.step()`` by kernel."""
    from tpuframe_torch.ops.fused_adamw import (
        FusedAdamW,
        fused_adamw_update_,
        fused_adamw_update_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    leaves = [adamw_leaf(gen, s) for s in shapes]
    count = torch.full((), 7, dtype=torch.int32, device=dev)

    def optimizer_params():
        params = [torch.nn.Parameter(p.clone()) for p, _, _, _ in leaves]
        for prm, (_, g, _, _) in zip(params, leaves):
            prm.grad = g.clone()
        return params

    ours = FusedAdamW(optimizer_params(), hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                      weight_decay=hp["weight_decay"])
    lib = torch.optim.AdamW(optimizer_params(), lr=hp["lr"], betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], weight_decay=hp["weight_decay"], fused=True)

    def per_tensor():
        for p, g, m, v in leaves:
            fused_adamw_update_(p, g, m, v, count, **hp)

    def plain():
        for p, g, m, v in leaves:
            fused_adamw_update_reference(p, g, m, v, count, **hp)

    timed = functools.partial(time_ms, flush=flush, iters=20, warmup=3)
    arms = {"plain": plain, "step": ours.step, "per_tensor": per_tensor, "library": lib.step}
    times = {k: [] for k in arms}
    for k in ("plain", "step", "per_tensor", "library", "library", "per_tensor", "step", "plain"):
        times[k].append(timed(arms[k]))
    split = kernel_split(ours.step)
    out = {f"{k}_ms": min(v) for k, v in times.items()}
    out.update(parameters=sum(p.numel() for p, _, _, _ in leaves), split_us=split)
    log(f"  one AdamW step over {len(shapes)} tensors ({out['parameters'] / 1e6:.1f} M "
        f"parameters): FusedAdamW.step {out['step_ms']:.3f} ms, per-tensor loop of "
        f"fused_adamw_update_ {out['per_tensor_ms']:.3f} ms, torch AdamW(fused=True) "
        f"{out['library_ms']:.3f} ms, plain {out['plain_ms']:.3f} ms (each the better of two "
        f"medians)")
    log("  FusedAdamW.step device time by kernel (profiler, no flush): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in split.items()))
    return out


#: the ResNet50-1K gradient on the wire: 25,557,032 float32 elements in 161
#: leaves, 25 buckets of 1,022,336 at the default 4 MiB
WIRE_SHAPE = (25, 1_022_336)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, NaNs compared by position (their payloads may differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = torch.where(nan, 0, a), torch.where(nan, 0, b)
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def quant_wire_phase(flush) -> list[dict]:
    """K5a, K5b (int8, int8 stochastic with the same noise, fp8) and K5c
    against their plain versions at the ResNet50-1K wire's (25, 1022336),
    at (3, 130) and on edge rows: amax and encode bit-equal, decode within
    1e-6 with NaN where the amax is not finite.  Then timed at the wire's
    shape beside the plain versions and, for K5a, the library's
    ``torch.linalg.vector_norm(v, inf, dim=1)``."""
    from tpuframe_torch.ops.quant_wire import (
        bucket_abs_max,
        bucket_abs_max_reference,
        quant_decode,
        quant_decode_reference,
        quant_encode,
        quant_encode_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    edges = torch.tensor([
        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127, -127, 0, -0.0, 3.5, 4.5, 100.5,
         -100.5],
        [1e-40, -3e-41, 2e-39, 0, 5e-45, -1e-38, 1e-39, 7e-42] + [0] * 8,
        [448, -448, 2 ** -9, 2 ** -10, 3 * 2 ** -10, 1, -1, 0.3, 17, 200, 300, 440, 447, 5.5, 6.5,
         232]], device=dev)
    cases = [("25x1022336", torch.randn(WIRE_SHAPE, generator=gen, device=dev) * 1e-3),
             ("3x130", torch.randn((3, 130), generator=gen, device=dev) * 9),
             ("edges", edges)]
    err = {"bucket_abs_max": 0.0, "quant_encode": 0.0, "quant_decode": 0.0}

    def max_diff(a, b):
        """Largest |a - b|, NaNs at the same places counted as 0."""
        return float((torch.nan_to_num(a.float()) - torch.nan_to_num(b.float())).abs().max())

    for name, v in cases:
        noise = torch.rand(v.shape, generator=gen, device=dev)
        amax = bucket_abs_max(v)
        want_amax = bucket_abs_max_reference(v)
        check(same_bits(amax, want_amax), f"K5a {name}: not bit-equal")
        err["bucket_abs_max"] = max(err["bucket_abs_max"], max_diff(amax, want_amax))
        bad = amax.clone()
        bad[0, 0] = float("nan")
        for mode, nz in (("int8", None), ("int8", noise), ("fp8", None)):
            tag = f"{name} {mode}{' stochastic' if nz is not None else ''}"
            q, d = quant_encode(v, amax, mode, noise=nz)
            wq, wd = quant_encode_reference(v, amax, mode, nz)
            check(same_bits(q, wq) and same_bits(d, wd), f"K5b {tag}: not bit-equal")
            err["quant_encode"] = max(err["quant_encode"], max_diff(q, wq), max_diff(d, wd))
            total = q * 2  # two ranks' worth
            for a in (amax, bad):
                got = quant_decode(total, a, mode, 2)
                want = quant_decode_reference(total, a, mode, 2)
                check(torch.equal(torch.isnan(got), torch.isnan(want))
                      and bool(torch.isnan(got[0]).all()) == (a is bad),
                      f"K5c {tag}: NaN rows differ")
                e = max_diff(got, want)
                check(e <= 1e-6, f"K5c {tag}: max abs diff {e} > 1e-6")
                err["quant_decode"] = max(err["quant_decode"], e)
        torch.cuda.synchronize()
        log(f"  quant_wire {name}: K5a and K5b (int8, int8 stochastic, fp8) bit-equal to the "
            f"plain versions; K5c within {err['quant_decode']:.3g} (tol 1e-6), NaN where amax "
            "is NaN")

    v, noise = cases[0][1], torch.rand(WIRE_SHAPE, generator=gen, device=dev)
    amax = bucket_abs_max(v)
    q8, _ = quant_encode(v, amax, "int8")
    qf, _ = quant_encode(v, amax, "fp8")
    lib = functools.partial(torch.linalg.vector_norm, v, float("inf"), dim=1, keepdim=True)
    check(same_bits(lib(), bucket_abs_max_reference(v)), "vector_norm(inf) yardstick differs")
    arms = {
        "bucket_abs_max": (functools.partial(bucket_abs_max, v),
                           functools.partial(bucket_abs_max_reference, v), lib),
        "quant_encode": (functools.partial(quant_encode, v, amax, "int8"),
                         functools.partial(quant_encode_reference, v, amax, "int8"), None),
        "quant_encode_stochastic": (functools.partial(quant_encode, v, amax, "int8", noise),
                                    functools.partial(quant_encode_reference, v, amax, "int8",
                                                      noise), None),
        "quant_encode_fp8": (functools.partial(quant_encode, v, amax, "fp8"),
                             functools.partial(quant_encode_reference, v, amax, "fp8"), None),
        "quant_decode": (functools.partial(quant_decode, q8 * 2, amax, "int8", 2),
                         functools.partial(quant_decode_reference, q8 * 2, amax, "int8", 2), None),
        "quant_decode_fp8": (functools.partial(quant_decode, qf * 2, amax, "fp8", 2),
                             functools.partial(quant_decode_reference, qf * 2, amax, "fp8", 2),
                             None),
    }
    n, nb = v.numel(), v.shape[0]
    # each input read once, each output written once (float32 or int32)
    moved = {"bucket_abs_max": 4 * n + 4 * nb, "quant_encode": 8 * n + 4 * nb,
             "quant_encode_stochastic": 12 * n + 4 * nb, "quant_encode_fp8": 8 * n + 4 * nb,
             "quant_decode": 8 * n + 4 * nb, "quant_decode_fp8": 8 * n + 4 * nb}
    times = {}
    for which, (kernel, plain, library) in arms.items():
        # plain, kernel, library, library, kernel, plain
        plain_ms = [time_ms(plain, flush, iters=30)]
        kernel_ms = [time_ms(kernel, flush)]
        library_ms = [time_ms(library, flush), time_ms(library, flush)] if library else []
        kernel_ms.append(time_ms(kernel, flush))
        plain_ms.append(time_ms(plain, flush, iters=30))
        bound_ms, bound_by = bound(moved[which], 5 * n)  # about 5 operations an element
        times[which] = {"ms": min(kernel_ms), "plain_ms": min(plain_ms),
                        "library_ms": min(library_ms) if library_ms else None,
                        "bound_ms": bound_ms, "bound_by": bound_by, "bytes_moved": moved[which]}
        t = times[which]
        log(f"  {which} 25x1022336: kernel {t['ms'] * 1e3:.2f} us, plain "
            f"{t['plain_ms'] * 1e3:.2f} us"
            + (f", vector_norm(inf) {t['library_ms'] * 1e3:.2f} us" if library else "")
            + f", bound {bound_ms * 1e3:.2f} us ({moved[which] / 1e6:.1f} MB at 3.35 TB/s)")
    rows = []
    for which, line, shape, extra in (
            ("bucket_abs_max", 91, "25x1022336 f32 -> 25x1 f32", ()),
            ("quant_encode", 107, "25x1022336 f32 -> int32 (int8 grid)",
             ("quant_encode_stochastic", "quant_encode_fp8")),
            ("quant_decode", 125, "25x1022336 int32 (int8 grid) -> f32", ("quant_decode_fp8",))):
        row = {"name": which, "route": "cuda", "source": "tpuframe_torch/csrc/quant_wire.cu",
               "replaces": f"tpuframe/ops/quant_wire.py:{line}", "launches": None,
               "max_abs_err": err[which],
               **{k: times[which][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")},
               "shape": shape, "bytes_moved": times[which]["bytes_moved"]}
        for e in extra:
            row[e.removeprefix(which + "_")] = times[e]
        rows.append(row)
    del cases, v, noise, q8, qf
    return rows


#: bench_lm.py's long_ctx: the GPT-2-small widths at seq 8192, batch 2
LONG_LM = dict(vocab_size=32768, num_layers=12, num_heads=12, head_dim=64, max_len=8192)
LONG_BATCH = 2
#: K6's shapes on the paths: the long-context LM's causal attention, and
#: ViT-B/16's bidirectional attention at the serve bucket of 64
ATTN_PATH = (LONG_BATCH, LONG_LM["max_len"], LONG_LM["num_heads"], LONG_LM["head_dim"])
ATTN_VIT = (64, 196, 12, 64)
# K6 against its plain version run in float32 on the same inputs: in f32
# the sums run in another order over other tiles (1e-5 forward, 1e-4 for
# the gradients); in bf16 the kernel may be at most twice as far from the
# f32 result as the plain bf16 run (the same roundings at the same places,
# other sums before them); lse is float32 on both sides (1e-5)
K6_F32_FWD_TOL = 1e-5
K6_F32_BWD_TOL = 1e-4
K6_BF16_FACTOR = 2.0
#: K6a at large logits (q scaled by 8, causal): lse against the float64
#: logsumexp, since there the float32 plain run's own sums round it by as
#: much as 1e-5 (lse ~ 40, a few float32 steps) and a kernel that sums in
#: another order lands elsewhere; within 1e-5 of it, or no further than
#: twice the float32 plain run (the bf16 rule's form)
K6_LARGE_LOGITS = ((2, 1000, 3, 64), (2, 1000, 2, 128))


def lse_float64(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """The logsumexp (B, H, L) of the scaled scores in float64 over the same
    values: what every float32 lse of attention approximates."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(q.shape[-1])
    if causal:
        l = q.shape[1]
        s = s.masked_fill(~torch.ones(l, l, dtype=torch.bool, device=q.device).tril(), -math.inf)
    return torch.logsumexp(s, -1)


def blockwise_phase(flush, baseline) -> list[dict]:
    """K6a (forward), K6b (delta and dQ) and K6c (dK and dV) against the
    plain schedule on the card: at the long-context path's (2, 8192, 12,
    64) bf16 causal, ViT's (64, 196, 12, 64) bf16 bidirectional, and ragged
    L = 13 and 1000 in f32 and bf16, causal and not; two runs bit-equal;
    K6a at large logits, its lse against the float64 logsumexp
    (``K6_LARGE_LOGITS``).  At the path's shape ``baseline`` (K6's FMA
    design, ``BASELINE_K6``) is held to the same bf16 rule on the same
    inputs.
    Then timed at the path's shape beside the plain passes,
    ``F.scaled_dot_product_attention(is_causal=True)`` (forward, and its
    autograd backward, which computes dQ, dK and dV together) and the
    baseline, in turns."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.blockwise_attention import (
        _CODES,
        _bwd_dkv_reference,
        _bwd_dq_reference,
        _delta,
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_bwd_reference,
        blockwise_attention_fwd,
        blockwise_attention_reference,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)

    def inputs(shape, dtype):
        return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)
                for _ in range(4)]

    def kernels(q, k, v, g, causal):
        out, lse = blockwise_attention_fwd(q, k, v, causal=causal)
        dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=causal)
        dk, dv = blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=causal)
        return out, lse, dq, dk, dv

    def plain(q, k, v, g, causal):
        out, lse = blockwise_attention_reference(q, k, v, causal=causal)
        return (out, lse, *blockwise_attention_bwd_reference(q, k, v, out, lse, g, causal=causal))

    def launch_baseline(fn, ptrs, q, causal):
        b, l, h, d = q.shape
        rc = fn(*(t.data_ptr() for t in ptrs), b, l, h, d, int(causal), 1.0 / math.sqrt(d),
                _CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"baseline K6 launch failed: CUDA error {rc}")

    def baseline_fwd(q, k, v, causal):
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=dev)
        launch_baseline(baseline.tf_blockwise_attention_baseline_fwd, (q, k, v, out, lse), q,
                        causal)
        return out, lse

    def baseline_dq(q, k, v, out, lse, g, causal):
        dq = torch.empty_like(q)
        delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)
        launch_baseline(baseline.tf_blockwise_attention_baseline_bwd_dq,
                        (q, k, v, out, g, lse, dq, delta), q, causal)
        return dq, delta

    def baseline_dkv(q, k, v, lse, delta, g, causal):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        launch_baseline(baseline.tf_blockwise_attention_baseline_bwd_dkv,
                        (q, k, v, g, lse, delta, dk, dv), q, causal)
        return dk, dv

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("2x8192x12x64 bf16 causal", ATTN_PATH, bf16, True),
             ("64x196x12x64 bf16", ATTN_VIT, bf16, False)]
    cases += [(f"2x{l}x3x64 {str(dt)[6:]}{' causal' if c else ''}", (2, l, 3, 64), dt, c)
              for l in (13, 1000) for dt in (f32, bf16) for c in (True, False)]
    path_err = None
    for name, shape, dtype, causal in cases:
        q, k, v, g = inputs(shape, dtype)
        got = kernels(q, k, v, g, causal)
        torch.cuda.synchronize()
        check([t.dtype for t in got] == [dtype, f32, dtype, dtype, dtype],
              f"K6 {name}: dtypes {[t.dtype for t in got]}")
        want = plain(*(t.float() for t in (q, k, v, g)), causal)
        err = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
        check(all(math.isfinite(e) for e in err), f"K6 {name}: non-finite error {err}")
        if dtype == f32:
            ok = err[0] <= K6_F32_FWD_TOL and err[1] <= K6_F32_FWD_TOL and max(err[2:]) <= K6_F32_BWD_TOL
            tol = f"tol {K6_F32_FWD_TOL} out/lse, {K6_F32_BWD_TOL} gradients"
        else:
            ref = [float((a.float() - w).abs().max()) for a, w in zip(plain(q, k, v, g, causal), want)]
            ok = err[1] <= K6_F32_FWD_TOL and all(
                err[i] <= K6_BF16_FACTOR * ref[i] for i in (0, 2, 3, 4))
            tol = (f"plain bf16 {[f'{e:.3g}' for e in ref]}, tol {K6_BF16_FACTOR}x that "
                   f"(lse {K6_F32_FWD_TOL})")
        log(f"  blockwise attention {name}: out/lse/dq/dk/dv max abs diff from the f32 plain "
            f"version {[f'{e:.3g}' for e in err]} ({tol})")
        check(ok, f"K6 {name}: errors {err} ({tol})")
        again = kernels(q, k, v, g, causal)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K6 {name}: a rerun gave other bits")
        if shape == ATTN_PATH:
            path_err = err
            # the baseline's K6a, and its K6b and K6c from the kernels'
            # forward, to the same rule
            base = baseline_fwd(q, k, v, causal)
            bdq, bdelta = baseline_dq(q, k, v, got[0], got[1], g, causal)
            base += (bdq, *baseline_dkv(q, k, v, got[1], bdelta, g, causal))
            base_err = [float((a.float() - w).abs().max()) for a, w in zip(base, want)]
            apart = [float((a.float() - b_.float()).abs().max()) for a, b_ in zip(base, got)]
            log(f"  baseline K6 {name}: out/lse/dq/dk/dv max abs diff from the f32 plain version "
                f"{[f'{e:.3g}' for e in base_err]}, from the kernels "
                f"{[f'{e:.3g}' for e in apart]} (tol {K6_BF16_FACTOR}x the plain bf16 run's, "
                f"lse {K6_F32_FWD_TOL})")
            check(base_err[1] <= K6_F32_FWD_TOL and all(
                base_err[i] <= K6_BF16_FACTOR * ref[i] for i in (0, 2, 3, 4)),
                f"baseline K6 {name}: errors {base_err}, plain bf16 {ref}")
            del bdq, bdelta, base
        del q, k, v, g, got, want, again
    for shape in K6_LARGE_LOGITS:
        q, k, v, _ = inputs(shape, bf16)
        q = q * 8  # exact in bf16
        name = f"{'x'.join(map(str, shape))} bf16 causal, q x 8"
        want, plain_bf16 = (blockwise_attention_reference(*(t.float() for t in (q, k, v)),
                                                          causal=True),
                            blockwise_attention_reference(q, k, v, causal=True))
        runs = {"K6a": blockwise_attention_fwd(q, k, v, causal=True),
                "baseline": baseline_fwd(q, k, v, True), "plain f32": want}
        exact = lse_float64(q, k, True)
        lse_err = {n: float((r[1].double() - exact).abs().max()) for n, r in runs.items()}
        out_err = float((runs["K6a"][0].float() - want[0]).abs().max())
        out_ref = float((plain_bf16[0].float() - want[0]).abs().max())
        lse_tol = max(K6_F32_FWD_TOL, K6_BF16_FACTOR * lse_err["plain f32"])
        log(f"  blockwise attention forward {name}: lse max abs diff from the float64 "
            f"logsumexp {', '.join(f'{n} {e:.3g}' for n, e in lse_err.items())} (K6a's tol "
            f"{lse_tol:.3g}); K6a out {out_err:.3g} from the f32 plain version (plain bf16 "
            f"{out_ref:.3g}, tol {K6_BF16_FACTOR}x that)")
        check(lse_err["K6a"] <= lse_tol and out_err <= K6_BF16_FACTOR * out_ref,
              f"K6a {name}: lse {lse_err['K6a']} (tol {lse_tol}), out {out_err} (plain bf16 "
              f"{out_ref})")
        del q, k, v, want, plain_bf16, runs, exact
    torch.cuda.empty_cache()

    # -- timed at the path's shape: (2, 8192, 12, 64) bf16, causal ------------
    q, k, v, g = inputs(ATTN_PATH, bf16)
    out, lse = blockwise_attention_fwd(q, k, v, causal=True)
    dq, delta = blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=True)
    plain_delta = _delta(out, g)
    heads = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    g_heads = g.transpose(1, 2).contiguous()
    lib_out = F.scaled_dot_product_attention(*heads, is_causal=True)
    lib_err = float((lib_out.detach().transpose(1, 2).float() - out.float()).abs().max())
    log(f"  F.scaled_dot_product_attention yardstick: {lib_err:.3g} max abs from K6a's output")
    arms = {
        "fwd": (lambda: blockwise_attention_fwd(q, k, v, causal=True),
                lambda: blockwise_attention_reference(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(*heads, is_causal=True),
                lambda: baseline_fwd(q, k, v, True)),
        "dq": (lambda: blockwise_attention_bwd_dq(q, k, v, out, lse, g, causal=True),
               lambda: _bwd_dq_reference(q, k, v, lse, _delta(out, g), g, True, None), None,
               lambda: baseline_dq(q, k, v, out, lse, g, True)),
        "dkv": (lambda: blockwise_attention_bwd_dkv(q, k, v, lse, delta, g, causal=True),
                lambda: _bwd_dkv_reference(q, k, v, lse, plain_delta, g, True, None), None,
                lambda: baseline_dkv(q, k, v, lse, delta, g, True)),
    }
    times = {}
    for which, (kernel, plain_fn, library, base) in arms.items():
        # plain, kernel, [library, library,] baseline, baseline, kernel, plain
        plain_ms = [time_ms(plain_fn, flush, iters=3, warmup=1)]
        kernel_ms = [time_ms(kernel, flush, iters=20, warmup=2)]
        if library is not None:
            times[which + "_library"] = min(time_ms(library, flush, iters=20, warmup=2)
                                            for _ in range(2))
        times[which + "_baseline"] = min(time_ms(base, flush, iters=10, warmup=1)
                                         for _ in range(2))
        kernel_ms.append(time_ms(kernel, flush, iters=20, warmup=2))
        plain_ms.append(time_ms(plain_fn, flush, iters=3, warmup=1))
        times[which], times[which + "_plain"] = min(kernel_ms), min(plain_ms)
    lib_bwd = lambda: torch.autograd.grad(lib_out, heads, g_heads, retain_graph=True)  # noqa: E731
    times["bwd_library"] = min(time_ms(lib_bwd, flush, iters=20, warmup=2) for _ in range(2))

    b, l, h, d = ATTN_PATH
    product = 2 * b * h * (l * l / 2) * d  # one causal product: the visible half of L^2
    elem, rows = b * l * h * d * 2, b * h * l * 4  # bf16 tensors, float32 rows
    work = {"fwd": (4 * elem + rows, 2 * product),  # q, k, v in, out; lse
            "dq": (6 * elem + 2 * rows, 3 * product),  # q, k, v, out, g in, dq; lse, delta
            "dkv": (6 * elem + 2 * rows, 4 * product)}  # q, k, v, g in, dk, dv; lse, delta
    fa2_bwd_ms = 5 * product / BF16_FLOPS * 1e3  # FlashAttention-2's five backward products
    names = {"fwd": ("blockwise_attention_fwd", 64), "dq": ("blockwise_attention_bwd_dq", 150),
             "dkv": ("blockwise_attention_bwd_dkv", 180)}
    errs = {"fwd": path_err[0], "dq": path_err[2], "dkv": max(path_err[3:])}
    rows_out = []
    for which, (name, line) in names.items():
        moved, flops = work[which]
        by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        r = {"name": name, "route": "cuda", "source": "tpuframe_torch/csrc/blockwise_attention.cu",
             "replaces": f"tpuframe/ops/blockwise_attention.py:{line}", "launches": None,
             "max_abs_err": errs[which], "ms": times[which], "plain_ms": times[which + "_plain"],
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "operations" if by_ops >= by_bytes else "bytes",
             "library_ms": times["fwd_library"] if which == "fwd" else times["bwd_library"],
             "shape": "2x8192x12x64 bf16 causal", "bytes_moved": moved, "flops": flops}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r.update(baseline_ms=times[which + "_baseline"], speedup=times[which + "_baseline"] / r["ms"])
        if which != "fwd":
            r.update(library_covers="dQ, dK and dV together (SDPA's autograd backward)",
                     backward_ms=times["dq"] + times["dkv"], fa2_backward_bound_ms=fa2_bwd_ms)
        log(f"  {name} 2x8192x12x64 bf16 causal: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, baseline "
            f"{r['baseline_ms']:.3f} ms ({r['speedup']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ms ({100 * r['bound_share']:.1f} %; {flops / 1e9:.1f} GFLOP "
            f"at 989 TFLOP/s; {moved / 1e6:.1f} MB at 3.35 TB/s)")
        rows_out.append(r)
    pair_bound = (work["dq"][1] + work["dkv"][1]) / BF16_FLOPS * 1e3
    log(f"  blockwise attention backward (K6b + K6c): {times['dq'] + times['dkv']:.3f} ms "
        f"(baseline {times['dq_baseline'] + times['dkv_baseline']:.3f} ms) against its 7 "
        f"products' {pair_bound:.4f} ms, FlashAttention-2's five products {fa2_bwd_ms:.3f} ms "
        f"and SDPA's backward {times['bwd_library']:.3f} ms")
    return rows_out


def dev_us(e) -> float:
    """Device µs of one ``key_averages()`` entry."""
    return float(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0))


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without namespace, template arguments
    or parameters."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", key, maxsplit=1)[0].strip()


def kernel_split(fn, calls: int = 20) -> dict:
    """Device µs that one call of ``fn`` spends in each CUDA kernel, by
    kernel name (``torch.profiler`` over ``calls`` calls after a warm one;
    no L2 flush between them).  Fails where the profiler saw no device
    event: an empty split would pass every check on it."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            name = kernel_name(e.key)
            split[name] = split.get(name, 0.0) + dev_us(e) / calls
    check(bool(split), "torch.profiler saw no device events")
    return split


def profile(fn, what: str, top: int = 12, also: tuple = ()) -> dict:
    """Where one call of ``fn`` spends its time: host wall time of the call
    (after one warm call), device time summed over its kernels (one call
    under ``track.profiler.trace_step_window``, reduced by
    ``track.device_time``), the kernels with the most device time, and
    every kernel whose name holds one of ``also`` (returned by name, each
    summed over its template instances).  Fails where the profiler saw no
    device event."""
    import tempfile

    from tpuframe_torch.track.device_time import device_time_report
    from tpuframe_torch.track.profiler import trace_step_window

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="tpuframe_profile_") as d:
        trace_step_window(fn, 1, d)
        rep = device_time_report(d, top_k=10**6)
    check(rep is not None, f"torch.profiler saw no device events in {what}")
    ops = rep["top_ops"] if rep else []
    total_ms = sum(o["total_s"] for o in ops) * 1e3
    launches = sum(o["count"] for o in ops)
    log(f"  profile, {what}: wall {wall_ms:.2f} ms, device "
        f"{total_ms:.2f} ms over {launches} kernel launches "
        f"(device busy {total_ms / wall_ms:.0%} of wall)")
    named = {}
    for i, o in enumerate(ops):
        if i < top or any(a in o["name"] for a in also):
            log(f"    {o['total_s'] * 1e3:8.3f} ms  x{o['count']:<4d} {o['name'][:110]}")
        if any(a in o["name"] for a in also):
            named[kernel_name(o["name"])] = {"ms": o["total_s"] * 1e3, "count": o["count"]}
    return {"wall_ms": wall_ms, "device_ms": total_ms, "launches": launches, "named": named}


# -- the track plane's parts: captures on fits the script runs -----------------

#: where the track plane's parts write their captures and telemetry
TRACK_DIR = Path(__file__).resolve().parent / "build" / "tpuframe_torch" / "track_smoke"
#: the kernel each launch of a wrapper runs once (a K3b launch runs its dx
#: kernel, then ``ln_bwd_reduce``), as ``track.device_time`` names it
KERNEL_EVENTS = {"layer_norm_fwd": ("ln_fwd_chunked", "ln_fwd_elementwise"),
                 "layer_norm_bwd": ("ln_bwd_reduce",), "fused_adamw": ("adamw_multi_kernel",),
                 "bucket_abs_max": ("amax_kernel",), "quant_encode": ("encode_kernel",),
                 "quant_decode": ("decode_kernel",)}
LM_PROFILE_SKIP = 3  # (a): the ProfilerCallback's default skip_steps
LM_PROFILE_STEPS = 4  # (a): TPUFRAME_PROFILE_STEPS of phase 6's fit
STRAGGLER_AFTER = 7  # (d): phase 5's fit steps slow from this batch on
STRAGGLER_SLEEP_S = 0.5  # (d): what each slow step adds
OOM_HEADROOM_MB = 512  # (e): the allocator's limit above what it holds


def window_tally(counters: dict, start: int, n: int):
    """A Trainer callback holding the launches each wrapper of ``counters``
    counted over steps ``start`` to ``start + n - 1`` (``tally``): the
    dispatch side of an env-armed capture's window."""
    from tpuframe_torch.train import Callback

    class WindowTally(Callback):
        tally: dict = {}

        def on_step_start(self, trainer):
            if trainer.batches_seen == start:
                self.before = {k: fn.launches for k, fn in counters.items()}

        def on_step_end(self, trainer):
            if trainer.batches_seen == start + n:
                self.tally = {k: fn.launches - self.before[k] for k, fn in counters.items()}

    return WindowTally()


def kernel_events(rep: dict, names) -> dict:
    """Each wrapper's kernel events in a device-time report's top-op table."""
    ops = {o["name"]: o["count"] for o in rep["top_ops"]}
    return {n: sum(ops.get(k, 0) for k in KERNEL_EVENTS[n]) for n in names}


def report_device_time(rep: dict, what: str, card: str, top: int = 8) -> dict:
    """Log a ``device_time`` record: the window, busy and idle seconds, each
    class's wall and events, exposed comms, and the top ``top`` ops."""
    c = rep["classes"]
    log(f"  {what}: {rep['steps']} steps, window {rep['window_s'] * 1e3:.3f} ms, busy "
        f"{rep['busy_s'] * 1e3:.3f} ms, idle {rep['idle_s'] * 1e3:.3f} ms; compute "
        f"{c['compute']['wall_s'] * 1e3:.3f} ms ({c['compute']['events']} events), transfer "
        f"{c['transfer']['wall_s'] * 1e3:.3f} ms ({c['transfer']['events']}), collective "
        f"{c['collective']['wall_s'] * 1e3:.3f} ms ({c['collective']['events']}); exposed "
        f"comms {rep['exposed_comms_s'] * 1e3:.3f} ms; on {card}")
    for o in rep["top_ops"][:top]:
        log(f"    {o['total_s'] * 1e3:9.3f} ms {o['pct']:6.2f} %  x{o['count']:<5d} "
            f"{o['class']:10s} {o['name'][:100]}")
    return {k: rep[k] for k in ("window_s", "busy_s", "idle_s", "exposed_comms_s",
                                "overlap_efficiency", "device_step_s", "classes")} | {
        "top_ops": rep["top_ops"][:top]}


def gated_report(rep: dict | None, tally: dict, what: str, card: str, note: str) -> dict:
    """Log a capture's report and hold each wrapper's kernel events in it
    to ``tally``, its launches in the window."""
    if rep is None:  # a rehearsal on the CPU (the device-event check logs)
        return {}
    out = report_device_time(rep, what, card)
    events = kernel_events(rep, tally)
    log(f"  {what}: kernel events {events}, launches in the window {tally}; {note}")
    check(events == tally and all(tally.values()),
          f"{what}: kernel events {events} != launches {tally}")
    return out | {"kernel_events": events, "tally": tally}


def capture_window(fn, steps: int, logdir: Path, counters: dict, what: str,
                   card: str) -> dict:
    """``steps`` calls of ``fn`` under ``track.profiler.trace_step_window``
    (one warm call first), reduced by ``track.device_time``: the report
    logged, and each wrapper's kernel events held to its launches in the
    window."""
    from tpuframe_torch.track.device_time import count_device_events, device_time_report
    from tpuframe_torch.track.profiler import trace_step_window

    shutil.rmtree(logdir, ignore_errors=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before = {k: c.launches for k, c in counters.items()}
    trace_step_window(fn, steps, str(logdir))
    tally = {k: c.launches - before[k] for k, c in counters.items()}
    n_events = count_device_events(str(logdir))
    check(n_events > 0, f"{what}: the capture holds no device event")
    rep = device_time_report(str(logdir), steps=steps, top_k=10**6)
    return gated_report(rep, tally, what, card, f"{n_events} device events, in "
                        f"{time.perf_counter() - t0:.1f} s") | {"device_events": n_events}


def armed_capture(trainer, window, what: str, card: str) -> dict:
    """(a): the env-armed ``ProfilerCallback``'s capture of ``trainer``'s fit,
    reduced by ``track.device_time``; each kernel's events in the window
    held to ``window``'s dispatch tally."""
    from tpuframe_torch.track.device_time import device_time_report
    from tpuframe_torch.track.profiler import ProfilerCallback

    t0 = time.perf_counter()
    (cb,) = [c for c in trainer.callbacks if isinstance(c, ProfilerCallback)]
    check(len(cb.captures) == 1 and not cb.captures[0]["partial"], f"{what}: {cb.captures}")
    cap = cb.captures[0]
    check(cap["device_events"] > 0, f"{what}: the capture saw no device event: {cap}")
    rep = device_time_report(cap["dir"], steps=cap["steps"], top_k=10**6)
    return gated_report(rep, window.tally, what, card,
                        f"capture {cap['bytes'] / 2**20:.1f} MiB, {cap['device_events']} device "
                        f"events, reduced in {time.perf_counter() - t0:.1f} s") | {
        "device_events": cap["device_events"], "bytes": cap["bytes"]}


def analyze_part(tele: Path, trace: Path, card: str) -> dict:
    """(c): ``python -m tpuframe_torch.track analyze`` over phase 10's two
    ranks' telemetry: both ranks in the skew report, a Perfetto trace
    written with a process track each."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpuframe_torch.track", "analyze", str(tele), "--trace",
         str(trace), "--json"], cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=300)
    check(proc.returncode == 0, f"(c) the analyzer exited {proc.returncode}: {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout[proc.stdout.index("{"):])["report"]
    tracks = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "process_name"]
    st = report.get("step_time") or {}
    log(f"  (c) python -m tpuframe_torch.track analyze over phase 10's telemetry: "
        f"{report['ranks']} ranks, {report.get('steps')} steps, step p50 "
        f"{st.get('p50', 0) * 1e3:.1f} ms p95 {st.get('p95', 0) * 1e3:.1f} ms, slowest "
        f"{report.get('slowest')}, lost to skew {report.get('total_lost_s')} s; "
        f"Perfetto trace {trace.stat().st_size / 2**10:.0f} KiB with {len(tracks)} rank tracks; "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    check(report["ranks"] == 2 and len(tracks) == 2,
          f"(c) the analyzer saw {report['ranks']} ranks and {len(tracks)} tracks")
    return {"ranks": report["ranks"], "steps": report.get("steps"), "step_time": st,
            "slowest": report.get("slowest"), "tracks": len(tracks),
            "trace_kib": trace.stat().st_size / 2**10, "seconds": time.perf_counter() - t0}


def oom_part(card: str, dev: torch.device, image_size: int, batch_size: int) -> dict:
    """(e): a real ``torch.OutOfMemoryError`` in phase 5's ResNet Trainer:
    the allocator's limit ``OOM_HEADROOM_MB`` above what it holds after the
    state is built, so the first step's activations fail; one
    ``memory/oom`` event (the estimate, the allocator's live figures, the
    fit ladder), the error re-raised, the limit lifted after."""
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import Trainer

    t0 = time.perf_counter()
    model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
    train = DataLoader(SyntheticImageDataset(n=2 * batch_size, image_size=image_size,
                                             num_classes=1000, seed=1),
                       batch_size, transfer_dtype="uint8")
    trainer = Trainer(model, train_dataloader=train, optimizer="sgd", lr=0.1, precision="bf16",
                      normalize=(MEAN, STD), max_duration="2ba")
    trainer.init_state()
    counter = get_telemetry().registry.counter("memory/oom_total")
    seen = counter.value
    raised = None
    index = torch.cuda.current_device() if dev.type == "cuda" else None
    if index is not None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(index).total_memory
        torch.cuda.set_per_process_memory_fraction(
            (torch.cuda.memory_reserved(index) + OOM_HEADROOM_MB * 2**20) / total, index)
    try:
        trainer.fit()
    except torch.OutOfMemoryError as e:
        raised = e
    finally:
        if index is not None:
            torch.cuda.set_per_process_memory_fraction(1.0, index)
    del trainer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(raised is not None, "(e) the fit under the lowered limit did not raise an OOM")
    check(counter.value - seen == 1, f"(e) {counter.value - seen} memory/oom events, not 1")
    evs = [e for e in get_telemetry().recent_events(512) if e["name"] == "memory/oom"]
    if not evs:  # a rehearsal on the CPU (the checks above log)
        return {}
    ev = evs[-1]
    live = ev["live"]
    log(f"  (e) OOM in the ResNet50 Trainer's step {ev['step']} (limit {OOM_HEADROOM_MB} MiB "
        f"above the allocator's reserve): one memory/oom event, where {ev['where']!r}; estimate "
        f"{ev['estimate_total_mb']} MB a device, live allocated {live.get('allocated_mb')} MB "
        f"(peak {live.get('allocated_peak_mb')}), reserved {live.get('reserved_mb')} MB, "
        f"num_ooms {live.get('num_ooms')}, budget {ev['budget_mb']} MB, fit ladder "
        f"{json.dumps(ev['fit'])[:300]}; error re-raised: {str(raised)[:120]!r}; "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    check(ev["where"] == "step" and ev["step"] == 0 and ev["estimate_total_mb"],
          f"(e) the memory/oom event: {ev}")
    return {"where": ev["where"], "step": ev["step"], "estimate_total_mb":
            ev["estimate_total_mb"], "live": live, "budget_mb": ev["budget_mb"],
            "seconds": time.perf_counter() - t0}


def slice_phase(card: str) -> dict:
    """Phase 4: ResNet50-1K served (K1 once a batch, nothing else)."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.models import ResNet50, from_jax_variables, import_torch_resnet

    dev = initialize().device
    model = ResNet50(num_classes=1000, device=dev)
    variables = random_jax_variables(import_torch_resnet(model.state_dict()), seed=0)
    model.load_state_dict(from_jax_variables(variables))
    return serve_phase(card, model, "ResNet50-1K", {"normalize": 1})


def vit_serve_phase(card: str) -> dict:
    """Phase 11: ViT-B/16-1K (random weights from a seed) served: K1 once a
    batch, K3a 25 times a forward (``ln1`` and ``ln2`` of 12 blocks and
    ``ln_f``); at 196 tokens ``auto`` is full attention, so K6 never."""
    from tpuframe_torch.core import initialize
    from tpuframe_torch.models import ViT_B16

    dev = initialize().device
    model = ViT_B16(num_classes=1000, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  ViT-B/16: {n_params / 1e6:.2f} M parameters, 196 tokens at 224 px")
    return serve_phase(card, model, "ViT-B/16-1K", {"normalize": 1, "layer_norm_fwd": 25})


def serve_phase(card: str, model, what: str, per_batch: dict) -> dict:
    """``model`` under ``bf16_compute`` behind ``ServeEngine`` (buckets
    1/8/32/64) and ``ServingServer``: 160 uint8 224x224 requests from 4
    client threads plus one ``POST /predict``, every kernel counter zeroed
    just before and read just after (``per_batch`` launches a served batch,
    the others none); served rows against direct predicts and predicts
    through the plain normalize; an f32 forward on the card against the
    CPU.  Returns the launch counts."""
    from tpuframe_torch.ops.blockwise_attention import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
    )
    from tpuframe_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from tpuframe_torch.ops.normalize import normalize_images, normalize_images_reference
    from tpuframe_torch.parallel import align_model_dtype, bf16_compute, full_precision
    from tpuframe_torch.serve import ServeEngine, ServeKnobs, ServingServer
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import make_predict_fn

    dev = next(model.parameters()).device
    counters = {"normalize": normalize_images, "layer_norm_fwd": layer_norm_fwd,
                "layer_norm_bwd": layer_norm_bwd, "blockwise_attention_fwd": blockwise_attention_fwd,
                "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv}
    policy = bf16_compute()
    align_model_dtype(model, policy)
    predict = make_predict_fn(policy, functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=policy.compute_dtype))
    engine = ServeEngine(
        functools.partial(predict, model),
        knobs=ServeKnobs(buckets=BUCKETS, slo_ms=60_000, queue_cap=1024,
                         batch_wait_ms=5.0),
        item_shape=(224, 224, 3), dtype="uint8", device=dev,
    )
    t0 = time.perf_counter()
    engine.start()
    log(f"  engine warm-up over buckets {BUCKETS}: {time.perf_counter() - t0:.2f} s")
    server = ServingServer(engine)
    images = np.random.default_rng(1).integers(
        0, 256, (N_REQUESTS, 224, 224, 3), dtype=np.uint8)
    reg = get_telemetry().registry
    futures: dict[int, object] = {}

    submitted: dict[int, float] = {}

    def client(k: int) -> None:
        for i in range(k, N_REQUESTS, N_CLIENTS):
            futures[i] = engine.submit(images[i])
        submitted[k] = time.perf_counter()

    try:
        # the main path: counts zeroed just before, read just after
        for fn in counters.values():
            fn.launches = 0
        batches0 = reg.counter("serve/batches").value
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "client thread did not finish")
        served = {i: f.result(timeout=600) for i, f in futures.items()}
        wall = time.perf_counter() - t_start
        buf = io.BytesIO()
        np.save(buf, images[0])
        req = urllib.request.Request(server.url + "/predict", data=buf.getvalue(),
                                     method="POST", headers={"X-Deadline-Ms": "60000"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            status = resp.status
            http_out = np.asarray(json.loads(resp.read())["output"], np.float32)
        check(engine.drain(timeout=120), "engine did not drain")
        launches = {name: fn.launches for name, fn in counters.items()}
        batches = int(reg.counter("serve/batches").value - batches0)
        submit_s = max(submitted.values()) - t_start
    finally:
        server.close()
        engine.stop()

    check(status == 200, f"POST /predict answered {status}")
    lat = sorted(f.latency_s for f in futures.values())
    verdicts = {f.verdict for f in futures.values()}
    check(verdicts == {"ok"}, f"verdicts {verdicts}")
    check(len(served) == N_REQUESTS, f"{len(served)} of {N_REQUESTS} answered")
    for i, out in served.items():
        check(tuple(out.shape) == (1000,) and bool(torch.isfinite(out).all()),
              f"request {i}: shape {tuple(out.shape)} or non-finite logits")
    expected = {name: per_batch.get(name, 0) * batches for name in counters}
    check(batches > 0 and launches == expected,
          f"{what} serve launches {launches} for {batches} served batches, expected {expected}")
    log(f"  {what}: served {N_REQUESTS} + 1 HTTP requests in {batches} batches; "
        f"launches {launches}")
    infer = reg.histogram("span/serve/infer").window()[-batches:]
    occupancy = reg.histogram("serve/batch_occupancy").window()[-batches:]
    log(f"  all {N_REQUESTS} submitted after {submit_s * 1e3:.1f} ms; per batch: "
        f"occupancy {[round(o, 3) for o in occupancy]}, serve/infer ms "
        f"{[round(t * 1e3, 1) for t in infer]}")

    # -- correctness of the served rows (launches here are not counted) ----
    plain_predict = make_predict_fn(policy, functools.partial(
        normalize_images_reference, mean=MEAN, std=STD, out_dtype=policy.compute_dtype))
    worst = {"served vs direct": 0.0, "served vs plain-normalize predict": 0.0,
             "direct: kernel vs plain normalize": 0.0}
    for i, out in served.items():
        x = torch.from_numpy(images[i][None]).to(dev)
        direct = predict(model, x)[0].cpu()
        plain = plain_predict(model, x)[0].cpu()
        scale = float(direct.abs().max())
        for key, a, b in (("served vs direct", out, direct),
                          ("served vs plain-normalize predict", out, plain),
                          ("direct: kernel vs plain normalize", direct, plain)):
            worst[key] = max(worst[key], float((a - b).abs().max()) / scale)
    http_err = float(np.abs(http_out - served[0].numpy()).max()) / float(served[0].abs().max())
    for k, v in worst.items():
        log(f"  {k}: max |diff| / max|logit| = {v:.3g} (tol {BF16_REL_TOL})")
        check(v <= BF16_REL_TOL, f"{k} rel err {v} > {BF16_REL_TOL}")
    check(http_err <= BF16_REL_TOL, f"HTTP row rel err {http_err}")

    xb = torch.from_numpy(images[:BUCKETS[-1]]).to(dev)
    prof = profile(lambda: predict(model, xb), f"{what} predict of {tuple(xb.shape)}")

    # f32 on the card (TF32 off) against the same model on the CPU
    align_model_dtype(model, full_precision())
    predict32 = make_predict_fn(full_precision(), functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32))
    x2 = torch.from_numpy(images[:2])
    on_card = predict32(model, x2.to(dev)).cpu()
    model_cpu = model.to("cpu")
    on_cpu = predict32(model_cpu, x2)
    f32_err = float((on_card - on_cpu).abs().max()) / float(on_cpu.abs().max())
    log(f"  {what} f32 card vs CPU: max |diff| / max|logit| = {f32_err:.3g} (tol {F32_REL_TOL}), "
        f"max|logit| {float(on_cpu.abs().max()):.4g}")
    check(f32_err <= F32_REL_TOL, f"f32 card vs CPU rel err {f32_err}")

    ms = [v * 1e3 for v in lat]
    summary = {
        "model": what,
        "requests": N_REQUESTS,
        "clients": N_CLIENTS,
        "batches": batches,
        "req_per_s": N_REQUESTS / wall,
        "p50_ms": ms[len(ms) // 2],
        "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
        "launches": launches,
        "f32_card_vs_cpu": f32_err,
        "predict_64_device_ms": prof["device_ms"],
        "card": card,
    }
    log(f"  {what} serve: {summary['req_per_s']:.1f} req/s, p50 {summary['p50_ms']:.1f} ms, "
        f"p99 {summary['p99_ms']:.1f} ms over {N_REQUESTS} requests "
        f"({N_CLIENTS} clients, buckets {BUCKETS}) on {card}")
    log("  serve_json " + json.dumps(summary))
    return summary


#: the epoch summary keys of the JAX Trainer (health on, with eval)
SUMMARY_KEYS = {
    "train_loss", "train_accuracy", "train_samples_per_sec", "health_bad_steps", "grad_norm",
    "epoch_time_s", "data_wait_s", "dispatch_s", "host_block_s", "assemble_s", "h2d_s",
    "eval_loss", "eval_accuracy",
}
TRAIN_BATCH = 128
TRAIN_STEPS = 12
# f32 train steps, kernel against plain cross entropy, convolutions
# deterministic and TF32 off: the two differ only in the rounding of the
# cross entropy (~1e-7 relative).  The losses of two steps hold 1e-4
# relative; the parameters are held after the first step, within 1e-4 of
# the largest update: a freshly initialized ResNet50 takes updates of O(1)
# (gradient norm ~7e3 at lr 0.1), so the second step carries those
# roundings ~1e3-fold into the weights (3e-6 -> 1.3e-3 relative, measured
# on the CPU with the plain versions), and is only logged
CE_STEP_LOSS_RTOL = 1e-4
CE_STEP_PARAM_RTOL = 1e-4
# f32 train step on the card (TF32 off) against the CPU: the order of the
# sums differs.  The loss holds 1e-4 relative.  The update (parameters and
# BN statistics after one SGD step at lr 0.1) is held as a whole,
# ||card - cpu|| / ||cpu update|| <= 3e-2: this fresh ResNet18 at batch 8
# in train mode is ill-conditioned.  On the CPU alone, a 1e-6 change of
# the input, or another thread count, moves the update by 1.2e-3 on this
# measure and single tensors by ~1 %; the card changes the order of every
# sum (each op alone agrees with float64 to ~1e-7 on both), and gave 1.0e-2
CPU_STEP_LOSS_RTOL = 1e-4
CPU_STEP_UPDATE_RTOL = 3e-2


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_phase(card: str, dev: torch.device = torch.device("cuda"), image_size: int = 224,
                batch_size: int = TRAIN_BATCH, ce_px: int = 64) -> tuple[dict, dict]:
    """The train slice through ``Trainer.fit`` (main path, counted), then
    the step alone, the overfit check and the two f32 parity checks.
    Returns (launch counts, summary).  The device and sizes are arguments
    so the phase can be rehearsed small on the CPU."""
    import math

    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet18, ResNet50
    from tpuframe_torch.ops.cross_entropy import (
        cross_entropy_bwd,
        cross_entropy_fwd,
        cross_entropy_reference,
    )
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import Callback, Trainer, create_train_state, make_optimizer
    from tpuframe_torch.train.step import make_train_step

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, trainer, metrics):
            self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

    model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
    train = DataLoader(SyntheticImageDataset(n=batch_size * TRAIN_STEPS, image_size=image_size,
                                             num_classes=1000, seed=1),
                       batch_size, shuffle=True, seed=0, transfer_dtype="uint8", num_workers=8)
    eval_images = 2 * batch_size + 44 * batch_size // TRAIN_BATCH  # a ragged last batch
    evl = DataLoader(SyntheticImageDataset(n=eval_images, image_size=image_size,
                                           num_classes=1000, seed=2),
                     batch_size, drop_last=False, transfer_dtype="uint8", num_workers=8)
    steps = StepLosses()

    class PlantedSlowdown(Callback):
        """(d): every step from STRAGGLER_AFTER on ends STRAGGLER_SLEEP_S late."""

        def on_step_end(self, trainer):
            if trainer.batches_seen >= STRAGGLER_AFTER:
                time.sleep(STRAGGLER_SLEEP_S)

    # (d): the straggler monitor's self-baseline (one process) on this fit,
    # compared every 2 steps, a rank straggling at 1.5x its own median
    trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl, optimizer="sgd",
                      lr=0.1, precision="bf16", normalize=(MEAN, STD),
                      max_duration=f"{TRAIN_STEPS}ba", log_interval=1,
                      callbacks=[steps, PlantedSlowdown()], straggler_sync_steps=2,
                      straggler_factor=1.5)
    trainer.init_state()
    n_eval = len(evl)
    from tpuframe_torch.track.telemetry import get_telemetry

    stragglers = get_telemetry().registry.counter("train/stragglers")
    straggled = stragglers.value
    # -- the main path: counts zeroed just before, read just after ---------
    normalize_images.launches = cross_entropy_fwd.launches = cross_entropy_bwd.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    sync(dev)
    fit_s = time.perf_counter() - t0
    launches = {"normalize": normalize_images.launches,
                "cross_entropy_fwd": cross_entropy_fwd.launches,
                "cross_entropy_bwd": cross_entropy_bwd.launches}
    expected = {"normalize": TRAIN_STEPS + n_eval, "cross_entropy_fwd": TRAIN_STEPS + n_eval,
                "cross_entropy_bwd": TRAIN_STEPS}
    log(f"  fit: {TRAIN_STEPS} steps of {batch_size} + eval of {eval_images} images "
        f"({n_eval} batches) in {fit_s:.2f} s (of which (d)'s planted "
        f"{(TRAIN_STEPS - STRAGGLER_AFTER + 1) * STRAGGLER_SLEEP_S:.1f} s); launches {launches} "
        f"(expected {expected})")
    check(launches == expected, f"train launches {launches} != {expected}")
    events = [e for e in get_telemetry().recent_events(512) if e["name"] == "train/straggler"]
    straggler = {"events": stragglers.value - straggled,
                 "skew_ratio": get_telemetry().registry.gauge("train/skew_ratio").value,
                 "last": {k: events[-1][k] for k in ("mode", "step", "ewma_s", "median_s",
                                                     "ratio")} if events else None}
    log(f"  (d) straggler self-baseline, steps from {STRAGGLER_AFTER} on {STRAGGLER_SLEEP_S} s "
        f"late: {straggler['events']} train/straggler events, skew ratio "
        f"{straggler['skew_ratio']:.3f}, the last {straggler['last']}")
    check(straggler["events"] >= 1 and events and events[-1]["mode"] == "self",
          f"(d) the planted slowdown emitted no train/straggler event: {straggler}")
    summary = result.history[-1]
    check(SUMMARY_KEYS <= set(summary), f"epoch summary lacks {SUMMARY_KEYS - set(summary)}")
    losses = steps.losses
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          f"step losses {losses}")
    check(abs(losses[0] - math.log(1000)) <= 1.0,
          f"first-step loss {losses[0]:.4f} not within 1.0 of ln 1000")
    check(summary["health_bad_steps"] == 0.0, f"{summary['health_bad_steps']} bad steps")
    log(f"  step losses {[round(v, 4) for v in losses]}")
    log("  epoch summary " + json.dumps({k: round(v, 6) for k, v in summary.items()}))

    # -- the train step alone on one device-resident batch ------------------
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8)).to(dev),
             "label": torch.from_numpy(rng.integers(0, 1000, batch_size)).to(dev)}
    state, step = trainer.state, trainer._train_step
    fixed = []
    for _ in range(10):  # ten steps on one batch: the overfit check
        state, m = step(state, batch)
        fixed.append(m["loss_sum"] / m["count"])
    fixed = [float(v) for v in torch.stack(fixed).cpu()]
    log(f"  ten steps on one batch: losses {[round(v, 4) for v in fixed]}")
    check(all(math.isfinite(v) for v in fixed) and fixed[-1] < fixed[0],
          f"ten steps on one batch did not lower the loss: {fixed}")
    for _ in range(3):
        state, _ = step(state, batch)
    times = []
    for _ in range(30):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    img_s = batch_size / (step_ms / 1e3)
    mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    log(f"  train step alone, batch {batch_size}: median {step_ms:.2f} ms over 30 steps "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = {img_s:.1f} img/s; "
        f"peak memory {mem_gb:.2f} GB on {card}")
    prof = profile(lambda: step(state, batch), f"train step of {batch_size} (bf16, health on)")
    del trainer, state, model, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    oom = oom_part(card, dev, image_size, batch_size)

    # -- kernel against plain cross entropy: f32 train steps on the card ----
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ce_model = ResNet50(num_classes=1000, device=dev, seed=4)
        twin = ResNet50(num_classes=1000, device=dev, seed=5)
        twin.load_state_dict(ce_model.state_dict())
        rng = np.random.default_rng(5)
        batches = [{"image": torch.from_numpy(rng.normal(0, 1, (32, ce_px, ce_px, 3)).astype(
                        np.float32)).to(dev),
                    "label": torch.from_numpy(rng.integers(0, 1000, 32)).to(dev)}
                   for _ in range(2)]
        sgd = make_optimizer("sgd", 0.1)
        start = [v.clone() for v in ce_model.state_dict().values()]
        kernel_state = create_train_state(ce_model, sgd)
        plain_state = create_train_state(twin, sgd)
        kernel_step = make_train_step(full_precision())
        plain_step = make_train_step(full_precision(), loss_fn=cross_entropy_reference)

        def param_diff():
            pairs = [(a, b, s0) for a, b, s0 in zip(ce_model.state_dict().values(),
                                                    twin.state_dict().values(), start)
                     if a.is_floating_point()]
            diff = max(float((a - b).abs().max()) for a, b, _ in pairs)
            update = max(float((a - s0).abs().max()) for a, _, s0 in pairs)
            return diff, diff / update

        worst_loss, param = 0.0, []
        for b in batches:
            kernel_state, km = kernel_step(kernel_state, b)
            plain_state, pm = plain_step(plain_state, b)
            kl, pl = float(km["loss_sum"]), float(pm["loss_sum"])
            worst_loss = max(worst_loss, abs(kl - pl) / abs(pl))
            param.append(param_diff())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"  f32 steps, kernel vs plain cross entropy (ResNet50-1K, 2 steps of 32 at {ce_px} px): "
        f"loss rel diff {worst_loss:.3g} (tol {CE_STEP_LOSS_RTOL}); params + BN stats after "
        f"step 1 max abs diff {param[0][0]:.3g} = {param[0][1]:.3g} of the largest update "
        f"(tol {CE_STEP_PARAM_RTOL}); after step 2 {param[1][0]:.3g} = {param[1][1]:.3g} "
        f"(logged only)")
    check(worst_loss <= CE_STEP_LOSS_RTOL, f"kernel vs plain CE loss rel diff {worst_loss}")
    check(param[0][1] <= CE_STEP_PARAM_RTOL, f"kernel vs plain CE params diff {param[0]}")
    del ce_model, twin, kernel_state, plain_state

    # -- an f32 train step on the card against the CPU -----------------------
    card_model = ResNet18(num_classes=10, num_filters=16, stem="cifar", device=dev, seed=6)
    cpu_model = ResNet18(num_classes=10, num_filters=16, stem="cifar", device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    start = [v.clone() for v in cpu_model.state_dict().values()]
    rng = np.random.default_rng(6)
    b_cpu = {"image": torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 10, 8))}
    b_card = {k: v.to(dev) for k, v in b_cpu.items()}
    to_f32 = functools.partial(normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32)
    transform = lambda b: {**b, "image": to_f32(b["image"])}  # noqa: E731
    sgd = make_optimizer("sgd", 0.1)
    card_state, cm = make_train_step(full_precision(), batch_transform=transform)(
        create_train_state(card_model, sgd), b_card)
    cpu_state, pm = make_train_step(full_precision(), batch_transform=transform)(
        create_train_state(cpu_model, sgd), b_cpu)
    cpu_loss_err = abs(float(cm["loss_sum"]) - float(pm["loss_sum"])) / abs(float(pm["loss_sum"]))
    pairs = [(a.cpu(), b, s0) for a, b, s0 in zip(card_model.state_dict().values(),
                                                  cpu_model.state_dict().values(), start)
             if a.is_floating_point()]
    diff_sq = sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs)
    update_sq = sum(float(((b - s0) ** 2).sum()) for _, b, s0 in pairs)
    cpu_update_err = math.sqrt(diff_sq / update_sq)
    cpu_entry_err = max(float((a - b).abs().max()) for a, b, _ in pairs)
    log(f"  f32 train step, card vs CPU (ResNet18 cifar, 32 px, batch 8): loss rel diff "
        f"{cpu_loss_err:.3g} (tol {CPU_STEP_LOSS_RTOL}), update rel diff {cpu_update_err:.3g} "
        f"(tol {CPU_STEP_UPDATE_RTOL}); largest single entry diff {cpu_entry_err:.3g}")
    check(cpu_loss_err <= CPU_STEP_LOSS_RTOL, f"card vs CPU loss rel diff {cpu_loss_err}")
    check(cpu_update_err <= CPU_STEP_UPDATE_RTOL, f"card vs CPU update rel diff {cpu_update_err}")

    out = {
        "img_per_s": img_s,
        "step_ms": step_ms,
        "batch": batch_size,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "fixed_batch_losses": [fixed[0], fixed[-1]],
        "eval_loss": summary["eval_loss"],
        "profile": prof,
        "straggler": straggler,
        "oom": oom,
        "peak_memory_gb": mem_gb,
        "kernel_vs_plain_ce": {"loss_rel": worst_loss, "param_step1": param[0],
                               "param_step2": param[1]},
        "card_vs_cpu": {"loss_rel": cpu_loss_err, "update_rel": cpu_update_err,
                        "entry_abs": cpu_entry_err},
        "card": card,
    }
    log("  train_json " + json.dumps(out))
    return launches, out


#: the GPT-2-small LM of ``benchmarks/bench_lm.py`` ("gpt_small")
LM = dict(vocab_size=32768, num_layers=12, num_heads=12, head_dim=64, max_len=1024)
LM_BATCH = 16
LM_STEPS = 12
#: kernel against plain LayerNorm and AdamW: two f32 steps of a 2-layer LM
#: at the path's width, vocabulary and a shorter sequence
LM_PLAIN = dict(vocab_size=32768, num_layers=2, num_heads=12, head_dim=64, max_len=256)
#: the f32 LM step on the card against the CPU
LM_CPU = dict(vocab_size=512, num_layers=2, num_heads=4, head_dim=32, max_len=64)
# f32 LM steps, kernel against plain LayerNorm and AdamW: the two differ in
# the rounding of LayerNorm's sums and of the AdamW expression (~1e-7
# relative).  Losses hold 1e-5 relative.  The parameters are held as a
# whole, ||kernel - plain|| within 1e-4 of the update's norm after each of
# two steps.  AdamW runs with eps 1e-3 here: Adam's update is lr * m /
# (sqrt(v) + eps), and at the default 1e-8 a gradient element that is only
# rounding noise (a sum that is zero in exact arithmetic, ~1e-9) is scaled
# up to a step of order lr on either side, which alone moved the update
# 1.4e-4 of its norm between the two arms on the CPU
LM_STEP_LOSS_RTOL = 1e-5
LM_STEP_UPDATE_RTOL = 1e-4
LM_STEP_ADAMW = dict(eps=1e-3, weight_decay=1e-4)
# the small f32 LM step, card (TF32 off) against the CPU, with the same
# AdamW settings: the order of every sum differs; the loss holds 1e-4
# relative and the update 1e-3 of its norm
LM_CPU_UPDATE_RTOL = 1e-3


class SyntheticTokenDataset:
    """Example 06's deterministic next-token streams
    (``examples/06_lm_sequence_parallel.py``): token t+1 = (start + stride *
    t) mod vocab, keyed by index."""

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


class NextTokenDataset(SyntheticTokenDataset):
    """(input, label) next-token pairs."""

    def __getitem__(self, i: int):
        toks = super().__getitem__(i)
        return toks[:-1], toks[1:]


def plain_adamw(lr: float, **hp):
    """An ``OptimizerSpec`` whose optimizer runs the plain AdamW update in
    place of K4: the other arm of the kernel-against-plain check."""
    from tpuframe_torch.ops.fused_adamw import FusedAdamW, fused_adamw_update_reference
    from tpuframe_torch.train import OptimizerSpec

    class PlainAdamW(FusedAdamW):
        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                kw = {k: group[k] for k in ("lr", "b1", "b2", "eps", "weight_decay")}
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    st = self.state[p]
                    st["count"] += 1
                    new = fused_adamw_update_reference(p, p.grad, st["mu"], st["nu"],
                                                       st["count"], **kw)
                    for t, n in zip((p, st["mu"], st["nu"]), new):
                        t.copy_(n)

    return OptimizerSpec(lambda params: PlainAdamW(params, lr, **hp), lr)


def plain_layer_norm(module, x: torch.Tensor) -> torch.Tensor:
    """``FusedLayerNorm.forward`` through the plain version (autograd of
    plain tensor ops) in place of K3a and K3b."""
    from tpuframe_torch.ops.layer_norm import layer_norm_reference

    return layer_norm_reference(x, module.scale, module.bias, module.epsilon).to(module.dtype)


def lm_breakdown(cfg: dict, batch_size: int, dev: torch.device) -> dict:
    """Device time of two parts of the LM step at its shapes: the
    materialized attention (``attention_reference`` forward and backward,
    bf16) of one layer, and the head (``lm_head`` product, f32 logits, the
    per-position loss, and their backward)."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.ring_attention import attention_reference
    from tpuframe_torch.train.step import cross_entropy

    b, l, h, dh, v = (batch_size, cfg["max_len"], cfg["num_heads"], cfg["head_dim"],
                      cfg["vocab_size"])
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    q, k, vv = (rand(b, l, h, dh).requires_grad_(True) for _ in range(3))
    g_out = rand(b, l, h, dh)
    x = rand(b, l, h * dh).requires_grad_(True)
    w = rand(v, h * dh, scale=(h * dh) ** -0.5).requires_grad_(True)
    labels = torch.randint(0, v, (b, l), generator=gen, device=dev)

    def attention():
        torch.autograd.grad(attention_reference(q, k, vv, causal=True), (q, k, vv), g_out)

    def head():
        logits = F.linear(x, w).float()
        torch.autograd.grad(cross_entropy(logits, labels).mean(), (x, w))

    no_flush = torch.empty(1, device=dev)
    attn_ms = time_ms(attention, no_flush, iters=10, warmup=2)
    head_ms = time_ms(head, no_flush, iters=10, warmup=2)
    return {"attention_ms_per_layer": attn_ms, "attention_ms": attn_ms * cfg["num_layers"],
            "head_ms": head_ms}


def lm_phase(card: str, dev: torch.device = torch.device("cuda"), cfg: dict = LM,
             batch_size: int = LM_BATCH, plain_cfg: dict = LM_PLAIN,
             plain_batch: int = 4) -> tuple[dict, dict]:
    """The LM train slice through ``Trainer.fit`` (main path, counted), then
    the step alone, the overfit check and the two f32 parity checks.
    Returns (launch counts, summary).  The device and sizes are arguments
    so the phase can be rehearsed small on the CPU."""
    import math

    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import (
        FusedLayerNorm,
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
        cross_entropy_bwd,
        cross_entropy_fwd,
        fused_adamw,
        fused_adamw_multi_update_,
        layer_norm_bwd,
        layer_norm_fwd,
        normalize_images,
    )
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import Trainer, create_train_state, make_train_step

    seq, vocab, layers = cfg["max_len"], cfg["vocab_size"], cfg["num_layers"]
    model = TransformerLM(**cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    n_leaves = len(list(model.parameters()))
    train = DataLoader(NextTokenDataset(batch_size * LM_STEPS, seq, vocab, seed=1), batch_size,
                       shuffle=True, seed=0, num_workers=4)
    eval_n = 2 * batch_size + 5  # a ragged last batch
    evl = DataLoader(NextTokenDataset(eval_n, seq, vocab, seed=2), batch_size, drop_last=False,
                     num_workers=4)
    steps = _step_losses()
    counters = {"layer_norm_fwd": layer_norm_fwd, "layer_norm_bwd": layer_norm_bwd,
                "fused_adamw": fused_adamw_multi_update_, "normalize": normalize_images,
                "cross_entropy_fwd": cross_entropy_fwd, "cross_entropy_bwd": cross_entropy_bwd,
                "blockwise_attention_fwd": blockwise_attention_fwd,
                "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv}
    # (a): the fit armed by TPUFRAME_PROFILE_* captures steps 3 to 6; the
    # window's launches are tallied beside it
    window = window_tally({k: counters[k] for k in ("layer_norm_fwd", "layer_norm_bwd",
                                                    "fused_adamw")},
                          LM_PROFILE_SKIP, LM_PROFILE_STEPS)
    shutil.rmtree(TRACK_DIR / "lm", ignore_errors=True)
    with mock.patch.dict(os.environ, {"TPUFRAME_PROFILE_STEPS": str(LM_PROFILE_STEPS),
                                      "TPUFRAME_PROFILE_DIR": str(TRACK_DIR / "lm")}):
        trainer = Trainer(model, tx=fused_adamw(3e-4, weight_decay=1e-4), train_dataloader=train,
                          eval_dataloader=evl, precision="bf16", max_duration=f"{LM_STEPS}ba",
                          log_interval=1, callbacks=[steps, window])
    trainer.init_state()
    n_eval = len(evl)
    # -- the main path: counts zeroed just before, read just after ---------
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    sync(dev)
    fit_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    n_ln = 2 * layers + 1  # ln1 and ln2 of every block, ln_f
    expected = {"layer_norm_fwd": n_ln * (LM_STEPS + n_eval), "layer_norm_bwd": n_ln * LM_STEPS,
                "fused_adamw": LM_STEPS, "normalize": 0, "cross_entropy_fwd": 0,
                "cross_entropy_bwd": 0, "blockwise_attention_fwd": 0,
                "blockwise_attention_bwd_dq": 0, "blockwise_attention_bwd_dkv": 0}
    log(f"  LM fit: {n_params / 1e6:.1f} M parameters in {n_leaves} tensors, {LM_STEPS} steps "
        f"of {batch_size}x{seq} tokens + eval of {eval_n} sequences ({n_eval} batches) in "
        f"{fit_s:.2f} s ({LM_PROFILE_STEPS} steps of it under (a)'s profiler, its traces "
        f"written); launches {launches} (expected {expected})")
    check(launches == expected, f"LM launches {launches} != {expected}")
    summary = result.history[-1]
    check(SUMMARY_KEYS <= set(summary), f"epoch summary lacks {SUMMARY_KEYS - set(summary)}")
    losses = steps.losses
    check(len(losses) == LM_STEPS and all(math.isfinite(v) for v in losses),
          f"step losses {losses}")
    # the JAX model at init gives ln(vocab) + ~0.5 (logits of unit spread):
    # 10.84 for vocab 32768 on the CPU at 2 layers, width 768
    check(abs(losses[0] - math.log(vocab)) <= 1.0,
          f"first-step loss {losses[0]:.4f} not within 1.0 of ln {vocab} = {math.log(vocab):.4f}")
    check(summary["health_bad_steps"] == 0.0, f"{summary['health_bad_steps']} bad steps")
    check(math.isfinite(summary["eval_loss"]), f"eval loss {summary['eval_loss']}")
    log(f"  step losses {[round(v, 4) for v in losses]}")
    log("  epoch summary " + json.dumps({k: round(v, 6) for k, v in summary.items()}))
    captured = armed_capture(trainer, window, f"(a) the LM fit's steps {LM_PROFILE_SKIP} to "
                             f"{LM_PROFILE_SKIP + LM_PROFILE_STEPS - 1}, env-armed capture", card)
    shutil.rmtree(TRACK_DIR / "lm", ignore_errors=True)

    # -- the train step alone on one device-resident batch ------------------
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    state, step = trainer.state, trainer._train_step
    fixed = []
    for _ in range(10):  # ten steps on one batch: the overfit check
        state, m = step(state, batch)
        fixed.append(m["loss_sum"] / m["count"])
    fixed = [float(v) for v in torch.stack(fixed).cpu()]
    log(f"  ten steps on one batch: losses {[round(v, 4) for v in fixed]}")
    check(all(math.isfinite(v) for v in fixed) and fixed[-1] < fixed[0],
          f"ten steps on one batch did not lower the loss: {fixed}")
    for _ in range(3):
        state, _ = step(state, batch)
    times = []
    for _ in range(30):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    tokens = batch_size * seq
    tok_s = tokens / (step_ms / 1e3)
    # 6 N T for the parameters' products, plus attention's QK^T and PV,
    # forward and backward (3 x 4 B H L^2 Dh per layer)
    model_flops = 6 * n_params * tokens
    attn_flops = 3 * 4 * batch_size * cfg["num_heads"] * seq * seq * cfg["head_dim"] * layers
    mfu = (model_flops + attn_flops) / (step_ms / 1e3) / BF16_FLOPS
    mem_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
    log(f"  LM train step alone, batch {batch_size}x{seq}: median {step_ms:.2f} ms over 30 steps "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = {tok_s:.0f} tokens/s; "
        f"MFU {mfu:.4f} ({(model_flops + attn_flops) / 1e12:.2f} TFLOP per step at 989 "
        f"TFLOP/s); peak memory {mem_gb:.2f} GB on {card}")
    prof = profile(lambda: step(state, batch), f"LM train step of {batch_size}x{seq} "
                   "(bf16, health on)", top=30, also=("ln_bwd", "ln_fwd", "adamw"))
    del trainer, state, step, model, batch, toks
    parts = {}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        parts = lm_breakdown(cfg, batch_size, dev)
        log(f"  at the step's shapes: attention forward+backward "
            f"{parts['attention_ms_per_layer']:.3f} ms a layer, {parts['attention_ms']:.2f} ms "
            f"for {layers} layers "
            f"({parts['attention_ms'] / step_ms:.1%} of the step); lm_head + f32 logits + loss "
            f"and backward {parts['head_ms']:.2f} ms ({parts['head_ms'] / step_ms:.1%})")

    # -- kernel against plain LayerNorm and AdamW: f32 LM steps -------------
    kernel_model = TransformerLM(**plain_cfg, device=dev, seed=4)
    plain_model = TransformerLM(**plain_cfg, device=dev, seed=5)
    plain_model.load_state_dict(kernel_model.state_dict())
    for m in plain_model.modules():
        if isinstance(m, FusedLayerNorm):
            m.forward = functools.partial(plain_layer_norm, m)
    start = [p.detach().clone() for p in kernel_model.parameters()]
    kernel_state = create_train_state(kernel_model, fused_adamw(1e-3, **LM_STEP_ADAMW))
    plain_state = create_train_state(plain_model, plain_adamw(1e-3, **LM_STEP_ADAMW))
    f32_step = make_train_step(full_precision())
    prng = np.random.default_rng(5)
    pv, pl_ = plain_cfg["vocab_size"], plain_cfg["max_len"]
    worst_loss, update_rel = 0.0, []
    for _ in range(2):
        t = torch.from_numpy(prng.integers(0, pv, (plain_batch, pl_ + 1))).to(dev)
        b = {"image": t[:, :-1], "label": t[:, 1:]}
        kernel_state, km = f32_step(kernel_state, b)
        before = {n: fn.launches for n, fn in counters.items()}
        plain_state, pm = f32_step(plain_state, b)
        check({n: fn.launches for n, fn in counters.items()} == before,
              "the plain LM step launched a kernel")
        kl, pl = float(km["loss_sum"]), float(pm["loss_sum"])
        worst_loss = max(worst_loss, abs(kl - pl) / abs(pl))
        with torch.no_grad():
            diff = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in
                                 zip(kernel_model.parameters(), plain_model.parameters())))
            upd = math.sqrt(sum(float(((b - s0) ** 2).sum()) for b, s0 in
                                zip(plain_model.parameters(), start)))
        update_rel.append(diff / upd)
    log(f"  f32 LM steps, kernel vs plain LayerNorm and AdamW ({plain_cfg['num_layers']} layers, "
        f"{plain_batch}x{pl_}): loss rel diff {worst_loss:.3g} (tol {LM_STEP_LOSS_RTOL}); "
        f"||kernel - plain|| / ||update|| after step 1 {update_rel[0]:.3g}, step 2 "
        f"{update_rel[1]:.3g} (tol {LM_STEP_UPDATE_RTOL})")
    check(worst_loss <= LM_STEP_LOSS_RTOL, f"kernel vs plain LM loss rel diff {worst_loss}")
    check(max(update_rel) <= LM_STEP_UPDATE_RTOL, f"kernel vs plain LM update rel diff {update_rel}")
    del kernel_model, plain_model, kernel_state, plain_state, start

    # -- a small f32 LM step on the card against the CPU ---------------------
    card_model = TransformerLM(**LM_CPU, device=dev, seed=6)
    cpu_model = TransformerLM(**LM_CPU, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    start = [p.detach().clone() for p in cpu_model.parameters()]
    t = torch.from_numpy(np.random.default_rng(6).integers(0, LM_CPU["vocab_size"],
                                                           (4, LM_CPU["max_len"] + 1)))
    b_cpu = {"image": t[:, :-1], "label": t[:, 1:]}
    b_card = {k: v.to(dev) for k, v in b_cpu.items()}
    _, cm = f32_step(create_train_state(card_model, fused_adamw(1e-3, **LM_STEP_ADAMW)), b_card)
    _, pm = f32_step(create_train_state(cpu_model, fused_adamw(1e-3, **LM_STEP_ADAMW)), b_cpu)
    cpu_loss_err = abs(float(cm["loss_sum"]) - float(pm["loss_sum"])) / abs(float(pm["loss_sum"]))
    pairs = list(zip((p.detach().cpu() for p in card_model.parameters()),
                     (p.detach() for p in cpu_model.parameters()), start))
    cpu_update_err = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs)
                               / sum(float(((b - s0) ** 2).sum()) for _, b, s0 in pairs))
    cpu_entry_err = max(float((a - b).abs().max()) for a, b, _ in pairs)
    log(f"  f32 LM step, card vs CPU ({LM_CPU['num_layers']} layers, width "
        f"{LM_CPU['num_heads'] * LM_CPU['head_dim']}, 4x{LM_CPU['max_len']}): loss rel diff "
        f"{cpu_loss_err:.3g} (tol {CPU_STEP_LOSS_RTOL}), update rel diff {cpu_update_err:.3g} "
        f"(tol {LM_CPU_UPDATE_RTOL}); largest single entry diff {cpu_entry_err:.3g}")
    check(cpu_loss_err <= CPU_STEP_LOSS_RTOL, f"LM card vs CPU loss rel diff {cpu_loss_err}")
    check(cpu_update_err <= LM_CPU_UPDATE_RTOL, f"LM card vs CPU update rel diff {cpu_update_err}")

    out = {
        "tokens_per_s": tok_s,
        "step_ms": step_ms,
        "batch": batch_size,
        "seq": seq,
        "params": n_params,
        "mfu": mfu,
        "step_tflop": (model_flops + attn_flops) / 1e12,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "fixed_batch_losses": [fixed[0], fixed[-1]],
        "eval_loss": summary["eval_loss"],
        "profile": prof,
        "armed_capture": captured,
        "parts": parts,
        "peak_memory_gb": mem_gb,
        "kernel_vs_plain": {"loss_rel": worst_loss, "update_rel": update_rel},
        "card_vs_cpu": {"loss_rel": cpu_loss_err, "update_rel": cpu_update_err,
                        "entry_abs": cpu_entry_err},
        "card": card,
    }
    log("  lm_json " + json.dumps(out))
    return launches, out


LONG_STEPS = 4  # the long_ctx fit's batches
LONG_REMAT_STEPS = 2  # the long_remat fit's batches
LONG_TIMED = 5  # steps of the step alone
#: the small f32 blockwise LM step on the card against the CPU
LONG_CPU = dict(vocab_size=512, num_layers=2, num_heads=4, head_dim=32, max_len=256,
                attn_impl="blockwise")


def long_context_phase(card: str, dev: torch.device = torch.device("cuda"), cfg: dict = LONG_LM,
                       batch_size: int = LONG_BATCH, cpu_cfg: dict = LONG_CPU) -> tuple[dict, dict]:
    """Phase 12: ``bench_lm.py``'s ``long_ctx`` (GPT-2-small widths, seq
    8192, batch 2, ``attn_impl="auto"``: blockwise) through ``Trainer(tx=
    fused_adamw(...), precision="bf16").fit()`` with an eval, counters
    zeroed just before and read just after; the step alone (tokens/s, MFU,
    a profile with K6's share); ten steps on one batch; then ``long_remat``
    (``remat=True``) through the Trainer (K6a twice a layer, the first loss
    bit-equal, less peak memory); a small f32 blockwise LM step on the card
    against the CPU.  Returns (launch counts, summary); the sizes are
    arguments so the phase can be rehearsed small on the CPU."""
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
        cross_entropy_bwd,
        cross_entropy_fwd,
        fused_adamw,
        fused_adamw_multi_update_,
        layer_norm_bwd,
        layer_norm_fwd,
        normalize_images,
    )
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import Trainer, create_train_state, make_train_step

    seq, vocab, layers = cfg["max_len"], cfg["vocab_size"], cfg["num_layers"]
    counters = {"blockwise_attention_fwd": blockwise_attention_fwd,
                "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv,
                "layer_norm_fwd": layer_norm_fwd, "layer_norm_bwd": layer_norm_bwd,
                "fused_adamw": fused_adamw_multi_update_, "normalize": normalize_images,
                "cross_entropy_fwd": cross_entropy_fwd, "cross_entropy_bwd": cross_entropy_bwd}
    n_ln = 2 * layers + 1

    def fit(remat: bool, steps: int, with_eval: bool):
        model = TransformerLM(**cfg, remat=remat, device=dev, seed=0)
        train = DataLoader(NextTokenDataset(batch_size * LONG_STEPS, seq, vocab, seed=1),
                           batch_size, shuffle=True, seed=0, num_workers=2)
        evl = (DataLoader(NextTokenDataset(2 * batch_size + 1, seq, vocab, seed=2), batch_size,
                          drop_last=False, num_workers=2) if with_eval else None)
        losses = _step_losses()
        trainer = Trainer(model, tx=fused_adamw(3e-4, weight_decay=1e-4), train_dataloader=train,
                          eval_dataloader=evl, precision="bf16", max_duration=f"{steps}ba",
                          log_interval=1, callbacks=[losses])
        trainer.init_state()
        # -- the main path: counts zeroed just before, read just after -------
        for fn in counters.values():
            fn.launches = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = trainer.fit()
        sync(dev)
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
        n_eval = len(evl) if evl is not None else 0
        fwd = steps * (2 if remat else 1) + n_eval  # the recompute runs each block again
        expected = {"blockwise_attention_fwd": layers * fwd,
                    "blockwise_attention_bwd_dq": layers * steps,
                    "blockwise_attention_bwd_dkv": layers * steps,
                    "layer_norm_fwd": n_ln * (steps + n_eval) + (2 * layers * steps if remat else 0),
                    "layer_norm_bwd": n_ln * steps, "fused_adamw": steps, "normalize": 0,
                    "cross_entropy_fwd": 0, "cross_entropy_bwd": 0}
        what = "long_remat" if remat else "long_ctx"
        log(f"  {what} fit: {steps} steps of {batch_size}x{seq} tokens"
            f"{f' + eval of {2 * batch_size + 1} sequences ({n_eval} batches)' if evl else ''} in "
            f"{fit_s:.2f} s; peak memory {peak:.2f} GB; launches {launches} (expected {expected})")
        check(launches == expected, f"{what} launches {launches} != {expected}")
        check(len(losses.losses) == steps and all(math.isfinite(v) for v in losses.losses),
              f"{what} step losses {losses.losses}")
        return trainer, result.history[-1], losses.losses, launches, peak, fit_s

    trainer, summary, losses, launches, peak_ctx, fit_s = fit(False, LONG_STEPS, True)
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    # a model at init gives about ln(vocab) + 0.5 (phase 6)
    check(abs(losses[0] - math.log(vocab)) <= 1.0,
          f"long_ctx first loss {losses[0]:.4f} not within 1.0 of ln {vocab} = {math.log(vocab):.4f}")
    check(summary["health_bad_steps"] == 0.0 and math.isfinite(summary["eval_loss"]),
          f"long_ctx summary {summary}")
    log(f"  long_ctx step losses {[round(v, 4) for v in losses]}, eval loss "
        f"{summary['eval_loss']:.2f} (a per-sequence sum, ROADMAP Queue 3 item 3)")

    # -- the train step alone on one device-resident batch -------------------
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    state, step = trainer.state, trainer._train_step
    fixed = []
    for _ in range(10):  # ten steps on one batch: the overfit check
        state, m = step(state, batch)
        fixed.append(m["loss_sum"] / m["count"])
    fixed = [float(v) for v in torch.stack(fixed).cpu()]
    log(f"  ten steps on one batch: losses {[round(v, 4) for v in fixed]}")
    check(all(math.isfinite(v) for v in fixed) and fixed[-1] < fixed[0],
          f"ten steps on one batch did not lower the loss: {fixed}")
    times = []
    for _ in range(LONG_TIMED):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    tokens = batch_size * seq
    tok_s = tokens / (step_ms / 1e3)
    # phase 6's formula: 6 N T for the parameters' products plus attention's
    # QK^T and PV, forward and backward, over the full L^2 (3 x 4 B H L^2 Dh
    # a layer): it counts the causal mask's skipped half as work
    model_flops = 6 * n_params * tokens
    attn_flops = 3 * 4 * batch_size * cfg["num_heads"] * seq * seq * cfg["head_dim"] * layers
    mfu = (model_flops + attn_flops) / (step_ms / 1e3) / BF16_FLOPS
    mfu_causal = (model_flops + attn_flops / 2) / (step_ms / 1e3) / BF16_FLOPS
    log(f"  long_ctx train step alone, batch {batch_size}x{seq}: median {step_ms:.2f} ms over "
        f"{LONG_TIMED} steps (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{tok_s:.0f} tokens/s; MFU {mfu:.4f} (phase 6's formula, attention over the full L^2; "
        f"{mfu_causal:.4f} counting the causal half) at 989 TFLOP/s on {card}")
    # K6 in bf16 on the tensor cores; the FMA kernels are f32's
    k6_names = ("tc::attn_fwd_tc", "tc::attn_bwd_dq_tc", "tc::attn_bwd_dkv_tc",
                "attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")
    prof = {}
    if dev.type == "cuda":
        prof = profile(lambda: step(state, batch), f"long_ctx train step of {batch_size}x{seq} "
                       "(bf16, health on)", top=20, also=k6_names)
        k6_ms = sum(v["ms"] for v in prof["named"].values())
        prof["k6_ms"], prof["k6_share"] = k6_ms, k6_ms / prof["device_ms"]
        log(f"  K6 in the step: {k6_ms:.2f} ms of {prof['device_ms']:.2f} ms device time "
            f"({prof['k6_share']:.1%}): " + ", ".join(
                f"{k} {v['ms']:.2f} ms x{v['count']}" for k, v in prof["named"].items()))
    del trainer, state, step, batch, toks
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- long_remat: the same model and data with remat=True -----------------
    trainer, _, remat_losses, remat_launches, peak_remat, remat_fit_s = fit(
        True, LONG_REMAT_STEPS, False)
    toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
    batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
    state, step = trainer.state, trainer._train_step
    state, _ = step(state, batch)
    remat_times = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync(dev)
        remat_times.append(time.perf_counter() - t0)
    remat_step_ms = statistics.median(remat_times) * 1e3
    log(f"  long_remat train step alone: median {remat_step_ms:.2f} ms over 3 steps "
        f"({tokens / (remat_step_ms / 1e3):.0f} tokens/s; long_ctx {step_ms:.2f} ms)")
    del trainer, state, step, batch, toks
    log(f"  long_remat first loss {remat_losses[0]!r}, long_ctx first loss {losses[0]!r}; peak "
        f"memory long_remat {peak_remat:.3f} GB, long_ctx {peak_ctx:.3f} GB")
    check(remat_losses[0] == losses[0], "long_remat's first loss is not bit-equal to long_ctx's")
    check(dev.type != "cuda" or peak_remat < peak_ctx,
          f"long_remat peak memory {peak_remat} GB not below long_ctx's {peak_ctx} GB")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- a small f32 blockwise LM step on the card against the CPU -----------
    card_model = TransformerLM(**cpu_cfg, device=dev, seed=6)
    cpu_model = TransformerLM(**cpu_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    start = [p.detach().clone() for p in cpu_model.parameters()]
    t = torch.from_numpy(np.random.default_rng(6).integers(0, cpu_cfg["vocab_size"],
                                                           (4, cpu_cfg["max_len"] + 1)))
    b_cpu = {"image": t[:, :-1], "label": t[:, 1:]}
    f32_step = make_train_step(full_precision())
    before = blockwise_attention_fwd.launches
    _, cm = f32_step(create_train_state(card_model, fused_adamw(1e-3, **LM_STEP_ADAMW)),
                     {k: v.to(dev) for k, v in b_cpu.items()})
    check(dev.type != "cuda" or blockwise_attention_fwd.launches == before + cpu_cfg["num_layers"],
          "the f32 blockwise step on the card did not launch K6a once a layer")
    _, pm = f32_step(create_train_state(cpu_model, fused_adamw(1e-3, **LM_STEP_ADAMW)), b_cpu)
    loss_err = abs(float(cm["loss_sum"]) - float(pm["loss_sum"])) / abs(float(pm["loss_sum"]))
    pairs = list(zip((p.detach().cpu() for p in card_model.parameters()),
                     (p.detach() for p in cpu_model.parameters()), start))
    update_err = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs)
                           / sum(float(((b - s0) ** 2).sum()) for _, b, s0 in pairs))
    log(f"  f32 blockwise LM step, card vs CPU ({cpu_cfg['num_layers']} layers, width "
        f"{cpu_cfg['num_heads'] * cpu_cfg['head_dim']}, 4x{cpu_cfg['max_len']}): loss rel diff "
        f"{loss_err:.3g} (tol {CPU_STEP_LOSS_RTOL}), update rel diff {update_err:.3g} "
        f"(tol {LM_CPU_UPDATE_RTOL})")
    check(loss_err <= CPU_STEP_LOSS_RTOL, f"blockwise LM card vs CPU loss rel diff {loss_err}")
    check(update_err <= LM_CPU_UPDATE_RTOL, f"blockwise LM card vs CPU update rel diff {update_err}")

    out = {
        "tokens_per_s": tok_s,
        "step_ms": step_ms,
        "batch": batch_size,
        "seq": seq,
        "params": n_params,
        "mfu": mfu,
        "mfu_causal_half": mfu_causal,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "fixed_batch_losses": [fixed[0], fixed[-1]],
        "fit_s": fit_s,
        "eval_loss": summary["eval_loss"],
        "peak_memory_gb": peak_ctx,
        "remat": {"first_loss": remat_losses[0], "peak_memory_gb": peak_remat,
                  "step_ms": remat_step_ms, "fit_s": remat_fit_s, "launches": remat_launches},
        "profile": prof,
        "card_vs_cpu": {"loss_rel": loss_err, "update_rel": update_err},
        "card": card,
    }
    log("  long_json " + json.dumps(out))
    return {"long_ctx": launches, "long_remat": remat_launches}, out


CKPT_STEPS = 6  # the uninterrupted fit
CKPT_CRASH = 4  # the interrupted fit stops after this step
CKPT_EVERY = 2  # its checkpoint_interval_batches


def _state_tensors(state) -> list:
    """Every tensor of a ``TrainState``'s saveable dict, in a fixed order."""
    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from walk(v)
            elif torch.is_tensor(v):
                yield v
    return list(walk(state.state_dict()))


def _same_state(a, b) -> tuple[bool, float]:
    """(bit-equal, largest |a - b|) over the parameters and optimizer state
    of two ``TrainState``s."""
    ta = [t for t in _state_tensors(a)]
    tb = [t for t in _state_tensors(b)]
    check(len(ta) == len(tb), "states of different layouts")
    equal = all(torch.equal(x, y) for x, y in zip(ta, tb))
    diff = max(float((x.double() - y.double()).abs().max()) for x, y in zip(ta, tb)
               if x.is_floating_point())
    return equal, diff


def checkpoint_phase(card: str, dev: torch.device = torch.device("cuda"), cfg: dict = LM,
                     batch_size: int = LM_BATCH) -> dict:
    """Checkpoint and resume through ``Trainer.fit`` on phase 6's LM.

    (a) A fit with ``checkpoint_interval_batches=2`` stopped by a crash
    after step 4, then a new Trainer over the same directory that
    auto-resumes from the snapshot of step 4 and runs to step 6, against an
    uninterrupted 6-step fit: bit-equal (parameters and optimizer state),
    and the resumed run's first batch is batch 5.  (b) The wall time and
    rate of a save and a restore of the full state, and of an async save,
    with the train step's time while it is in flight.  (d) The step
    directories in the JAX package's layout.  The device and sizes are
    arguments so the phase can be rehearsed small on the CPU."""
    import shutil
    import tempfile

    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.ckpt.meta import (
        _read_meta_doc,
        is_committed,
        read_health,
        read_manifest,
        valid_steps,
    )
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.ops.build import BUILD_DIR
    from tpuframe_torch.train import Callback, Trainer

    seq, vocab = cfg["max_len"], cfg["vocab_size"]

    class Crash(Callback):
        def on_step_end(self, trainer):
            if trainer.batches_seen >= CKPT_CRASH:
                raise RuntimeError("simulated crash")

    class Positions(Callback):
        def __init__(self):
            self.seen = []

        def on_step_end(self, trainer):
            self.seen.append(trainer._train_prefetcher.state_dict()["batches_yielded"])

    def make(directory=None, callbacks=()):
        model = TransformerLM(**cfg, device=dev, seed=0)
        data = NextTokenDataset(batch_size * (CKPT_STEPS + 2), seq, vocab, seed=1)
        return Trainer(model, tx=fused_adamw(3e-4, weight_decay=1e-4),
                       train_dataloader=DataLoader(data, batch_size, shuffle=True, seed=0,
                                                   num_workers=4),
                       precision="bf16", max_duration=f"{CKPT_STEPS}ba", log_interval=0,
                       callbacks=list(callbacks),
                       checkpointer=None if directory is None else Checkpointer(directory),
                       checkpoint_interval_batches=CKPT_EVERY if directory else None)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=BUILD_DIR)
    try:
        # -- (a) interrupted, resumed, against uninterrupted ---------------
        directory = os.path.join(root, "lm")
        first = make(directory, [Crash()])
        try:
            first.fit()
            check(False, "the interrupted fit ran to its end")
        except RuntimeError as e:
            check(str(e) == "simulated crash", f"the interrupted fit failed otherwise: {e!r}")
        intra = directory + "_intra"
        check(valid_steps(intra) == [CKPT_CRASH] and valid_steps(directory) == [],
              f"snapshots {valid_steps(intra)}, epoch-end steps {valid_steps(directory)}")
        snap = _read_meta_doc(intra, CKPT_CRASH)["meta"]
        check(snap["batches_seen"] == CKPT_CRASH and snap["loader_state"]["batches_yielded"]
              == CKPT_CRASH and snap["global_batch"] == batch_size,
              f"snapshot meta {snap}")
        del first
        positions = Positions()
        resumed = make(directory, [positions])
        t0 = time.perf_counter()
        result = resumed.fit()
        sync(dev)
        resume_s = time.perf_counter() - t0
        want_pos = list(range(CKPT_CRASH + 1, CKPT_STEPS + 1))
        check(positions.seen == want_pos,
              f"the resumed run consumed batches {positions.seen}, not {want_pos}")
        check(resumed.state.step == CKPT_STEPS
              and result.checkpoint == os.path.join(directory, str(CKPT_STEPS)),
              f"resumed to step {resumed.state.step}, checkpoint {result.checkpoint}")
        straight = make()
        straight.fit()
        sync(dev)
        equal, diff = _same_state(resumed.state, straight.state)
        repeat_diff = None
        if not equal:  # measure the card's own spread over two straight fits
            again = make()
            again.fit()
            sync(dev)
            _, repeat_diff = _same_state(again.state, straight.state)
            del again
            check(repeat_diff > 0 and diff <= repeat_diff,
                  f"resumed fit {diff:.3g} from the uninterrupted one; two uninterrupted "
                  f"fits {repeat_diff:.3g} apart")
        log(f"  (a) fit of {CKPT_STEPS} steps of {batch_size}x{seq} stopped after step "
            f"{CKPT_CRASH} (snapshots every {CKPT_EVERY}), resumed from the snapshot in "
            f"{resume_s:.2f} s: first batch {positions.seen[0]}, bit-equal to the "
            f"uninterrupted fit {equal} (max |diff| {diff:.3g}"
            + (f", two uninterrupted fits {repeat_diff:.3g} apart)" if not equal else ")"))
        del straight

        # -- (d) the layout --------------------------------------------------
        step_dir = os.path.join(directory, str(CKPT_STEPS))
        state = resumed.state
        n_leaves = len(_state_tensors(state))
        manifest, stamp = read_manifest(directory), read_health(directory)
        doc = _read_meta_doc(directory, CKPT_STEPS)
        check(is_committed(step_dir)
              and sorted(os.listdir(step_dir)) == ["_CHECKPOINT_METADATA", "meta", "state"]
              and set(doc) == {"meta", "metrics", "topology", "health"}
              and doc["meta"]["epoch"] == 1 and doc["meta"]["batches_seen"] == CKPT_STEPS
              and manifest["world_size"] == 1 and len(manifest["leaves"]) == n_leaves
              and stamp["healthy"] and stamp["step"] == CKPT_STEPS
              and valid_steps(intra) == []
              and not [e for e in os.listdir(directory) if not e.isdigit()],
              f"step directory {sorted(os.listdir(step_dir))}, meta {doc.get('meta')}, "
              f"{len(manifest['leaves'])} leaves, stamp {stamp}")
        log(f"  (d) {step_dir}: {sorted(os.listdir(step_dir))}, state/ "
            f"{sorted(os.listdir(os.path.join(step_dir, 'state')))}, meta keys {sorted(doc)}, "
            f"{len(manifest['leaves'])} manifest leaves, health stamp {stamp}")

        # -- (b) full-size save and restore ----------------------------------
        nbytes = sum(t.numel() * t.element_size() for t in _state_tensors(state))
        timing = Checkpointer(os.path.join(root, "timing"), max_to_keep=1)
        sync(dev)
        t0 = time.perf_counter()
        timing.save(state, step=100)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        timing.restore(state)
        sync(dev)
        restore_s = time.perf_counter() - t0
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(0, vocab, (batch_size, seq + 1))).to(dev)
        batch = {"image": toks[:, :-1], "label": toks[:, 1:]}
        step = resumed._train_step

        def step_s():
            sync(dev)
            t = time.perf_counter()
            step(state, batch)
            sync(dev)
            return time.perf_counter() - t

        for _ in range(3):
            step_s()
        alone = [step_s() for _ in range(10)]
        saved = [t.clone() for t in _state_tensors(state)]
        async_ck = Checkpointer(os.path.join(root, "async"), max_to_keep=1, async_save=True)
        t0 = time.perf_counter()
        async_ck.save(state, step=200)
        async_return_s = time.perf_counter() - t0
        in_flight = []
        while async_ck._pending is not None and async_ck._pending.is_alive() \
                and len(in_flight) < 500:
            in_flight.append(step_s())
        async_ck.wait()
        async_total_s = time.perf_counter() - t0
        check(async_ck.all_steps() == [200], f"async steps {async_ck.all_steps()}")
        async_ck.restore(state)
        sync(dev)
        check(all(torch.equal(a, b) for a, b in zip(_state_tensors(state), saved)),
              "the async checkpoint does not hold the state of the save call")
        gb = nbytes / 1e9
        out = {
            "state_gb": gb, "save_ms": save_s * 1e3, "save_gb_s": gb / save_s,
            "restore_ms": restore_s * 1e3, "restore_gb_s": gb / restore_s,
            "async_return_ms": async_return_s * 1e3, "async_total_ms": async_total_s * 1e3,
            "step_ms_alone": statistics.median(alone) * 1e3,
            "step_ms_in_flight": statistics.median(in_flight) * 1e3 if in_flight else None,
            "steps_in_flight": len(in_flight), "resume_bit_equal": equal,
            "resume_max_abs_diff": diff, "repeat_max_abs_diff": repeat_diff,
            "resume_fit_s": resume_s, "card": card,
        }
        log(f"  (b) save of the full state ({gb:.3f} GB, {n_leaves} tensors): "
            f"{out['save_ms']:.1f} ms wall, {out['save_gb_s']:.3f} GB/s; restore "
            f"{out['restore_ms']:.1f} ms, {out['restore_gb_s']:.3f} GB/s (the machine's disk "
            f"and host copies, not HBM); async save returns in {out['async_return_ms']:.1f} ms "
            f"and commits after {out['async_total_ms']:.1f} ms; train step median "
            f"{out['step_ms_alone']:.2f} ms alone, "
            + (f"{out['step_ms_in_flight']:.2f} ms over {len(in_flight)} steps while the "
               f"write is in flight" if in_flight else "no step while the write was in flight")
            + f" on {card}")
        log("  ckpt_json " + json.dumps(out))
        del resumed, state, saved
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def compressed_round_trip(trainer, card: str) -> dict:
    """(c) The compressed fit's state (parameters, BatchNorm buffers, SGD
    momentum and the int8 wire's residual) saved, overwritten, and restored
    in place: bit-equal, with the residual's global leaf in the manifest."""
    import shutil
    import tempfile

    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.ops.build import BUILD_DIR

    state = trainer.state
    dev = state.updates.device
    tensors = _state_tensors(state)
    saved = [t.clone() for t in tensors]
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=BUILD_DIR)
    try:
        ck = Checkpointer(root)
        sync(dev)
        t0 = time.perf_counter()
        ck.save(state, plan=trainer.plan)
        save_s = time.perf_counter() - t0
        leaf = ck.manifest_for()["leaves"]["comms/flat"]
        check(leaf["shape"] == [1, *WIRE_SHAPE] and leaf["dtype"] == "float32",
              f"residual leaf {leaf}")
        with torch.no_grad():
            for t in tensors:
                if t.is_floating_point():
                    t.add_(1.0)
        t0 = time.perf_counter()
        ck.restore(state)
        sync(dev)
        restore_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(_state_tensors(state), saved)),
              "the compressed state did not round-trip bit for bit")
        nbytes = sum(t.numel() * t.element_size() for t in saved)
        out = {"state_gb": nbytes / 1e9, "save_ms": save_s * 1e3, "restore_ms": restore_s * 1e3,
               "residual_shape": leaf["shape"]}
        log(f"  (c) compressed state ({nbytes / 1e9:.3f} GB with the residual "
            f"{leaf['shape']}) round-trips bit for bit: save {out['save_ms']:.1f} ms, restore "
            f"{out['restore_ms']:.1f} ms on {card}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def free_port() -> int:
    """A free TCP port on this machine's loopback interface."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_phase(card: str, dev: torch.device = torch.device("cuda"), image_size: int = 224,
             batch_size: int = TRAIN_BATCH) -> tuple[dict, dict]:
    """ResNet50-1K trained as phase 5 configures it, but through
    ``Trainer(plan=ParallelPlan(mesh=initialize().mesh), grad_compression=
    "int8")`` on a one-rank process group (NCCL on the card): the main path,
    counted.  Then the compressed step's median beside the uncompressed
    step's on one device-resident batch, in turns, the wire's parts alone,
    a check that the compressed step never waits for the device, and a
    profile of one compressed step.  Returns (launch counts, summary).  The
    device and sizes are arguments so the phase can be rehearsed small on
    the CPU."""
    import math
    import os

    from tpuframe_torch.core import initialize, shutdown
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode
    from tpuframe_torch.parallel import ParallelPlan, grad_layout, sync_gradients
    from tpuframe_torch.parallel.compression import resolve_fused
    from tpuframe_torch.train import Callback, Trainer
    from tpuframe_torch.train.step import _average_buffers, make_train_step

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, trainer, metrics):
            self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    try:
        rt = initialize(device=dev)
        import torch.distributed as dist

        check(dist.is_initialized() and dist.get_world_size() == 1,
              "initialize() built no one-rank process group")
        backend = dist.get_backend()
        model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
        train = DataLoader(SyntheticImageDataset(n=batch_size * TRAIN_STEPS,
                                                 image_size=image_size, num_classes=1000,
                                                 seed=1),
                           batch_size, shuffle=True, seed=0, transfer_dtype="uint8",
                           num_workers=8)
        eval_images = 2 * batch_size + 44 * batch_size // TRAIN_BATCH  # a ragged last batch
        evl = DataLoader(SyntheticImageDataset(n=eval_images, image_size=image_size,
                                               num_classes=1000, seed=2),
                         batch_size, drop_last=False, transfer_dtype="uint8", num_workers=8)
        steps = StepLosses()
        trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl, optimizer="sgd",
                          lr=0.1, precision="bf16", normalize=(MEAN, STD),
                          max_duration=f"{TRAIN_STEPS}ba", log_interval=1, callbacks=[steps],
                          plan=ParallelPlan(mesh=rt.mesh), grad_compression="int8")
        trainer.init_state()
        n_eval = len(evl)
        counters = {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
                    "cross_entropy_bwd": cross_entropy_bwd, "bucket_abs_max": bucket_abs_max,
                    "quant_encode": quant_encode, "quant_decode": quant_decode}
        # -- the main path: counts zeroed just before, read just after -----
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = trainer.fit()
        sync(dev)
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        expected = {"normalize": TRAIN_STEPS + n_eval, "cross_entropy_fwd": TRAIN_STEPS + n_eval,
                    "cross_entropy_bwd": TRAIN_STEPS, "bucket_abs_max": TRAIN_STEPS,
                    "quant_encode": TRAIN_STEPS, "quant_decode": TRAIN_STEPS}
        wire = trainer._train_step.wire
        log(f"  compressed fit ({backend}, world 1, int8): {TRAIN_STEPS} steps of {batch_size} "
            f"+ eval of {eval_images} images in {fit_s:.2f} s; launches {launches} (expected "
            f"{expected}); wire {wire['n_buckets']} buckets x {wire['bucket_elems']} "
            f"({wire['flat_elems']} elements)")
        check(launches == expected, f"compressed train launches {launches} != {expected}")
        n_params = sum(p.numel() for p in model.parameters())
        check((wire["n_buckets"], wire["bucket_elems"], wire["flat_elems"])
              == (25, 1_022_336, n_params) and n_params == 25_557_032,
              f"wire layout {wire}")
        summary = result.history[-1]
        check(SUMMARY_KEYS <= set(summary), f"epoch summary lacks {SUMMARY_KEYS - set(summary)}")
        losses = steps.losses
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
              f"step losses {losses}")
        check(abs(losses[0] - math.log(1000)) <= 1.0,
              f"first-step loss {losses[0]:.4f} not within 1.0 of ln 1000")
        check(summary["health_bad_steps"] == 0.0, f"{summary['health_bad_steps']} bad steps")
        resid = float(trainer.state.comms["flat"].abs().max())
        check(math.isfinite(resid) and resid > 0, f"error-feedback residual max |r| = {resid}")
        log(f"  step losses {[round(v, 4) for v in losses]}; residual max |r| {resid:.4g}")
        log("  epoch summary " + json.dumps({k: round(v, 6) for k, v in summary.items()}))

        # -- the step alone: compressed and uncompressed, in turns ----------
        rng = np.random.default_rng(3)
        batch = {"image": torch.from_numpy(rng.integers(
                     0, 256, (batch_size, image_size, image_size, 3), dtype=np.uint8)).to(dev),
                 "label": torch.from_numpy(rng.integers(0, 1000, batch_size)).to(dev)}
        state = trainer.state
        compressed = trainer._train_step
        transform = functools.partial(normalize_images, mean=MEAN, std=STD,
                                      out_dtype=trainer.policy.compute_dtype)
        plain = make_train_step(trainer.policy, batch_transform=lambda b: {
            **b, "image": transform(b["image"])}, health=trainer.health)

        def median_ms(fn, n=20):
            """Median host wall of ``fn()`` from a synced device to its end."""
            for _ in range(3):
                fn()
            times = []
            for _ in range(n):
                sync(dev)
                t0 = time.perf_counter()
                fn()
                sync(dev)
                times.append(time.perf_counter() - t0)
            return statistics.median(times) * 1e3

        def run_plain():
            plain(state, batch)

        def run_compressed():
            compressed(state, batch)

        arms = {"uncompressed": [median_ms(run_plain)], "compressed": [median_ms(run_compressed)]}
        arms["compressed"].append(median_ms(run_compressed))
        arms["uncompressed"].append(median_ms(run_plain))
        step_ms = {k: min(v) for k, v in arms.items()}
        log(f"  train step alone, batch {batch_size}: compressed int8 (world 1) median "
            f"{step_ms['compressed']:.2f} ms {arms['compressed']}, uncompressed "
            f"{step_ms['uncompressed']:.2f} ms {arms['uncompressed']} (the better of two "
            f"medians of 20 steps, in turns U C C U) on {card}")
        # what the compressed step adds, alone on this step's gradients
        grads = {n: p.grad for n, p in model.named_parameters()}
        config = resolve_fused(trainer.plan, trainer.comms_config)
        layout = grad_layout(grads, config, trainer.plan)
        parts_ms = {
            "sync_gradients": median_ms(lambda: sync_gradients(grads, state.comms, layout, config)),
            "average_buffers": median_ms(lambda: _average_buffers(model, 1)),
        }
        log(f"  the wire's parts alone (median host wall to the device's end): "
            f"{json.dumps(parts_ms)}")
        if dev.type == "cuda":
            # no call of the compressed step may wait for the device
            torch.cuda.set_sync_debug_mode("error")
            try:
                run_compressed()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log("  the compressed step makes no synchronizing call (sync debug mode)")
        prof = profile(run_compressed,
                       f"compressed train step of {batch_size} (bf16, int8 wire, health on)")
        captured = {}
        if dev.type == "cuda":
            # (b): three compressed steps on the one NCCL rank captured; the
            # collective class and the exposed comms of the capture (NCCL
            # may launch no kernel for a world-1 collective)
            captured = capture_window(
                run_compressed, 3, TRACK_DIR / "dp",
                {"bucket_abs_max": bucket_abs_max, "quant_encode": quant_encode,
                 "quant_decode": quant_decode},
                f"(b) three compressed steps of {batch_size} on one NCCL rank ({backend})", card)
            log(f"  (b) collective class on one NCCL rank: "
                f"{captured['classes']['collective']['events']} events, "
                f"{captured['classes']['collective']['wall_s'] * 1e3:.3f} ms; exposed comms "
                f"{captured['exposed_comms_s'] * 1e3:.3f} ms, overlap efficiency "
                f"{captured['overlap_efficiency']}")
            shutil.rmtree(TRACK_DIR / "dp", ignore_errors=True)
        round_trip = compressed_round_trip(trainer, card)
        out = {"round_trip": round_trip, "step_ms": step_ms, "step_ms_runs": arms, "parts_ms": parts_ms, "fit_s": fit_s,
               "first_loss": losses[0], "last_loss": losses[-1], "residual_max": resid,
               "wire": wire, "backend": backend, "profile": prof, "captured": captured,
               "card": card}
        log("  dp_json " + json.dumps(out))
        del trainer, state, model, batch
        return launches, out
    finally:
        shutdown()
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)


#: the fused transport's forms phase 9 runs on two gloo ranks of one card.
#: ``ring`` is left out: its hops are point-to-point sends, and gloo's send
#: and receive of a CUDA tensor fail there ("writev ... Bad address": gloo
#: hands the device pointer to the socket; probed on an H100), where its
#: all-reduce, all-to-all, all-gather and reduce-scatter copy through the
#: host.  NCCL, which carries all three, refuses two ranks on one device.
PHASE9_FORMS = ("concurrent", "single")
#: phase 9's wire formats, each with error feedback: (name, CommsConfig kw)
PHASE9_MODES = (("int8", dict(mode="int8")),
                ("int8_stochastic", dict(mode="int8", stochastic_rounding=True)),
                ("fp8", dict(mode="fp8")))
PHASE9_TIMED = 3  # syncs timed a form, each turn


def _two_rank_child(rank: int, world: int, store: str, out_dir: str, device: str) -> None:
    """One of two ranks on the same card (gloo: NCCL refuses two ranks on
    one device): ``sync_gradients`` over a ResNet50-shaped named tree with
    the kernels, then the same ranks' plain run on the CPU; then the fused
    transport in each of ``PHASE9_FORMS`` against the staged run, for each
    of ``PHASE9_MODES``, and each form's time; writes what it saw as
    JSON."""
    import dataclasses
    import hashlib
    import os
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    out = {}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.models import ResNet50
        from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode
        from tpuframe_torch.parallel import (
            CommsConfig,
            ParallelPlan,
            grad_layout,
            init_comms_state,
            sync_gradients,
        )
        from tpuframe_torch.parallel import compression

        rt = initialize(device=device, backend="gloo")
        try:
            dev = rt.device
            shapes = {n: p.shape for n, p in
                      ResNet50(num_classes=1000, device="cpu").named_parameters()}
            config = CommsConfig(mode="int8")
            plan = ParallelPlan(mesh=rt.mesh)
            gen = torch.Generator(device=dev).manual_seed(100 + rank)
            grads = {n: torch.randn(s, generator=gen, device=dev) * 1e-2 for n, s in shapes.items()}
            layout = grad_layout(grads, config, plan)
            resid = init_comms_state(grads, plan, config)["flat"]
            resid.normal_(0, 1e-5, generator=gen)
            poisoned = "layer3.0.conv2.weight"
            offset = next(o for p, _, _, o in layout.flat if p == poisoned) + 7
            bucket = offset // layout.bucket_elems
            in_bucket = torch.zeros(layout.padded_elems, dtype=torch.bool)
            in_bucket[bucket * layout.bucket_elems:(bucket + 1) * layout.bucket_elems] = True
            in_bucket = in_bucket[:layout.flat_elems]

            def flat_nan(mean):
                flat = torch.cat([mean[p].reshape(-1).cpu() for p, _, _, _ in layout.flat])
                return flat, torch.isnan(flat)

            def run(tree, cfg, form=None, seed=None):
                """sync_gradients staged (``form`` None) or fused in ``form``;
                stochastic rounding from a generator seeded ``seed``."""
                rng = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
                if form is None:
                    return sync_gradients(tree, {"flat": resid}, layout, cfg, rng)
                cfg = dataclasses.replace(cfg, fused=True)
                # the form the phase asks for, whatever the backend's default
                with mock.patch.object(compression, "_form_default", lambda: form):
                    return sync_gradients(tree, {"flat": resid}, layout, cfg, rng)

            def bits_equal(a, b):
                return all(same_bits(a[0][k], b[0][k]) for k in a[0]) and same_bits(
                    a[1]["flat"], b[1]["flat"])

            for poison in (False, True):
                if poison and rank == 1:  # one bad value in the middle of the tree
                    grads[poisoned].view(-1)[7] = float("nan")
                before = (bucket_abs_max.launches, quant_encode.launches, quant_decode.launches)
                card_mean, card_resid = run(grads, config)
                sync(dev)
                launched = [a - b for a, b in zip((bucket_abs_max.launches, quant_encode.launches,
                                                   quant_decode.launches), before)]
                cpu_mean, cpu_resid = sync_gradients({k: g.cpu() for k, g in grads.items()},
                                                     {"flat": resid.cpu()}, layout, config)
                equal = all(same_bits(card_mean[k].cpu(), cpu_mean[k]) for k in grads)
                equal = equal and same_bits(card_resid["flat"].cpu(), cpu_resid["flat"])
                flat, nan = flat_nan(card_mean)
                digest = hashlib.sha256(torch.where(nan, 0, flat).numpy().tobytes()
                                        + nan.numpy().tobytes()).hexdigest()
                want_nan = in_bucket if poison else torch.zeros_like(nan)
                # the fused transport in each form against the staged run
                forms = {}
                for form in PHASE9_FORMS:
                    fused = run(grads, config, form)
                    forms[form] = {"equals_staged": bits_equal(fused, (card_mean, card_resid)),
                                   "nan_bucket_ok": torch.equal(flat_nan(fused[0])[1], want_nan)}
                out["nan" if poison else "clean"] = {
                    "card_equals_cpu": equal, "digest": digest,
                    "nan_bucket_ok": torch.equal(nan, want_nan), "bucket": bucket if poison else None,
                    "launches": launched, "backend": "gloo", "elements": layout.flat_elems,
                    "buckets": layout.n_buckets, "forms": forms}
            grads[poisoned].view(-1)[7] = 0.0
            modes = {}
            for name, kw in PHASE9_MODES:
                cfg = CommsConfig(**kw)
                seed = 7 if cfg.stochastic_rounding else None
                staged = run(grads, cfg, seed=seed)
                modes[name] = {form: bits_equal(run(grads, cfg, form, seed), staged)
                               for form in PHASE9_FORMS}
            out["modes"] = modes
            # each transport's time in sync_gradients, int8, in turns
            arms = (None,) + PHASE9_FORMS
            times = {str(a): [] for a in arms}
            for turn in (arms, arms[::-1]):
                for form in turn:
                    run(grads, config, form)
                    for _ in range(PHASE9_TIMED):
                        sync(dev)
                        t0 = time.perf_counter()
                        run(grads, config, form)
                        sync(dev)
                        times[str(form)].append((time.perf_counter() - t0) * 1e3)
            out["sync_ms"] = {("staged" if k == "None" else k): statistics.median(v)
                              for k, v in times.items()}
            out["sync_ms_all"] = times
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def _spawn(target, world: int, args: tuple, timeout_s: float, what: str,
           tmp: str | None = None) -> list[dict]:
    """``world`` spawned processes running ``target(rank, world, store,
    out_dir, *args)`` (``out_dir`` is ``tmp``, else a fresh temporary
    directory); each rank's ``rank{r}.json``, failing the run on a hang, a
    missing file or an error."""
    import tempfile

    import torch.multiprocessing as mp

    if tmp is None:
        with tempfile.TemporaryDirectory() as fresh:
            return _spawn(target, world, args, timeout_s, what, fresh)
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, f"{tmp}/store", tmp) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, timeout_s - (time.perf_counter() - t0)))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(not hung, f"{what}: ranks {hung} hung past {timeout_s} s")
    log(f"  ({what}: {world} spawned ranks, {time.perf_counter() - t0:.1f} s from their start "
        "to their end)")
    res = []
    for r in range(world):
        f = Path(tmp, f"rank{r}.json")
        check(f.exists(), f"{what}: rank {r} wrote nothing (exit {procs[r].exitcode})")
        res.append(json.loads(f.read_text()))
    errors = [f"rank {r}:\n{o['error']}" for r, o in enumerate(res) if "error" in o]
    check(not errors, f"{what}, " + "\n".join(errors))
    return res


def two_rank_phase(card: str = "", timeout_s: float = 300.0, device: str = "cuda:0") -> dict:
    """Two gloo ranks on the one card, spawned: ``sync_gradients`` over a
    ResNet50-shaped named tree (25,557,032 elements, each rank its own
    gradient and residual) with the kernels must equal the same ranks'
    plain run on the CPU bit for bit (int8 round half to even), give both
    ranks the same mean, and decode a NaN on one rank to NaN in its bucket
    on both.  The fused transport, in each of ``PHASE9_FORMS``, must equal
    the staged run bit for bit (the sign of a zero counts) in int8, int8
    stochastic and fp8 with error feedback, and keep the NaN in its bucket;
    then each transport's median time in ``sync_gradients``.  ``device`` is
    an argument so the phase can be rehearsed on the CPU."""
    t0 = time.perf_counter()
    res = _spawn(_two_rank_child, 2, (device,), timeout_s, "two-rank phase")
    for r, out in enumerate(res):
        for case in ("clean", "nan"):
            o = out[case]
            check(o["card_equals_cpu"], f"rank {r} {case}: card sync differs from the CPU's")
            check(o["nan_bucket_ok"], f"rank {r} {case}: NaN outside (or missing from) "
                                      f"bucket {o['bucket']}")
            check(o["launches"] == [1, 1, 1], f"rank {r} {case}: launches {o['launches']}")
            for form, f in o["forms"].items():
                check(f["equals_staged"], f"rank {r} {case}: the fused {form} form differs from "
                                          "the staged transport")
                check(f["nan_bucket_ok"], f"rank {r} {case}: the fused {form} form's NaNs lie "
                                          f"outside (or are missing from) bucket {o['bucket']}")
        for mode, forms in out["modes"].items():
            check(all(forms.values()), f"rank {r} {mode}: fused forms against staged {forms}")
    for case in ("clean", "nan"):
        check(res[0][case]["digest"] == res[1][case]["digest"],
              f"{case}: the two ranks decoded different means")
    sync_ms = {k: max(o["sync_ms"][k] for o in res) for k in res[0]["sync_ms"]}
    log(f"  two gloo ranks on one card, {res[0]['clean']['elements']} elements in "
        f"{res[0]['clean']['buckets']} buckets: means and residuals with the kernels bit-equal "
        f"to the plain run on the CPU on both ranks, one mean on both; a NaN on rank 1 decodes "
        f"to NaN in bucket {res[0]['nan']['bucket']} only, on both ranks "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"  the fused transport, forms {list(PHASE9_FORMS)} (ring left out: gloo cannot send a "
        f"CUDA tensor point to point): bit-equal to the staged run in "
        f"{sorted(res[0]['modes'])} with error feedback, and a NaN stays in its bucket")
    log(f"  sync_gradients of the ResNet50 tree (int8, 1 group, median of {2 * PHASE9_TIMED} "
        f"a transport, slower rank, in turns): {json.dumps(sync_ms)} ms on {card}")
    return {"ranks": 2, "seconds": time.perf_counter() - t0, "sync_ms": sync_ms,
            "sync_ms_ranks": [o["sync_ms_all"] for o in res]}


DDP_STEPS = 4  # the main path's batches on two ranks
DDP_TIMED = 10  # steps of the two-rank step alone
# f32, one SGD step (lr 0.1, momentum 0.9) of ResNet50-1K from one seed:
# two gloo ranks on their halves of a batch of 128 against one process on
# all of it (TF32 off).  The loss and the running statistics hold 1e-5: the
# ranks sum the moments in another order and, under sync, take flax's
# E[x^2] - E[x]^2 where one process takes cuDNN's variance (measured 1.9e-7
# and within 2.5e-6 on an H100).  The update (parameters after the step) is
# held as a whole, ||ranks - one|| / ||one - start|| <= DDP_UPDATE_RTOL.  A
# fresh ResNet50's first backward cancels most of each BatchNorm's and
# convolution's gradient sums, so their rounding shows in the update:
# cuDNN picks its algorithms by shape, and local BN's step at the ranks'
# shapes (two microbatches of 64, one process: the control printed beside)
# lies as far from the step at 128 as the two ranks do (5.2e-3 on an H100
# 80GB HBM3 at 700 W).  Sync BN measured 2.2e-2 there, as far as rounding
# alone moves this step: the same step on images moved by 1e-7 of
# themselves lies 2.1e-2 from it, and one process with every BatchNorm
# through the cross-rank function (one-rank gloo group) 2.4e-2; the ranks
# are held against that one too.  Two planted faults of the sync backward
# (its all-reduce dropped: 0.30; the scale's and bias's gradients
# all-reduced, the trap in models/norm.py: 9.2e-2) must read above the
# limit, or the phase fails
DDP_LOSS_RTOL = 1e-5
DDP_STATS_TOL = 1e-5
DDP_UPDATE_RTOL = 5e-2
# local BN's two ranks against the same step in one process at their
# shapes (two microbatches of 64): the same kernels on the same shapes and
# the same sum of two gradients, so only the order inside cuDNN's
# nondeterministic algorithms may differ (one process against itself with
# deterministic ones moves the update 1.6e-5; the ranks measured 1.2e-5)
DDP_SHAPES_RTOL = 1e-4
DDP_FAULTS = ("no all-reduce", "summed affine")


@contextlib.contextmanager
def _through_cross_rank():
    """Every training BatchNorm with ``groups=1`` through the cross-rank
    function (sync BN's plain ops), whatever the world size: on a one-rank
    group its all-reduces sum one term."""
    from tpuframe_torch.models import ReplicaGroupedBatchNorm

    forward = ReplicaGroupedBatchNorm.forward

    def through(self, x):
        if not (self.training and self.groups == 1):
            return forward(self, x)
        return self._sync_forward(x, self.weight.to(torch.float32), self.bias.to(torch.float32))

    with mock.patch.object(ReplicaGroupedBatchNorm, "forward", through):
        yield


@contextlib.contextmanager
def _planted_bn_fault(kind: str):
    """A planted fault of sync BN's backward, for reading what the update's
    limit catches: ``"no all-reduce"`` takes the input's gradient from the
    rank's own sums; ``"summed affine"`` returns the all-reduced scale and
    bias gradients (``world`` times the right ones after the step's
    average)."""
    import torch.distributed as dist

    from tpuframe_torch.models import norm

    sound = norm._CrossRankBatchNorm.backward

    def backward(ctx, *grads):
        if kind == "no all-reduce":
            with mock.patch.object(dist, "all_reduce", lambda *a, **k: None):
                return sound(ctx, *grads)
        dx, dw, db, *rest = sound(ctx, *grads)
        dist.all_reduce(dw)
        dist.all_reduce(db)
        return (dx, dw, db, *rest)

    with mock.patch.object(norm._CrossRankBatchNorm, "backward", staticmethod(backward)):
        yield


def _ddp_reference(dev: torch.device, image_size: int, batch_size: int,
                   ref_dir: str) -> dict:
    """One process's f32 step on the global batch, from the seed the ranks
    use, for ``bn_stats`` "sync" and "local" (two groups, the ranks'
    halves): the start, the loss and the state after, saved under
    ``ref_dir`` for the ranks to compare with (TF32 off, as the ranks run).
    Returns the controls, each as ``_update_rel`` from the saved step: the
    same step again with deterministic cuDNN algorithms, for each;
    (``sync_plain``) the sync step with every BatchNorm through the
    cross-rank function on a one-rank gloo group, saved too;
    (``ulp_input``) the sync step on images moved by 1e-7 of themselves; and
    (``local_shapes``) local BN's step at the ranks' shapes in one process,
    two microbatches of 64, saved too."""
    import torch.distributed as dist

    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import (
        create_train_state,
        make_grad_accum_step,
        make_optimizer,
        make_train_step,
    )

    batch = {k: torch.from_numpy(v).to(dev) for k, v in _ddp_batch(image_size, batch_size).items()}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def one_step(bn_stats: str, n_micro: int = 1, batch: dict = batch) -> dict:
        model = ResNet50(num_classes=1000, device=dev, seed=7, bn_stats=bn_stats, bn_groups=2)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        state = create_train_state(model, make_optimizer("sgd", 0.1))
        if n_micro == 1:
            state, m = make_train_step(full_precision())(state, batch)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
                     for k, v in batch.items()}
            state, m = make_grad_accum_step(n_micro, full_precision())(state, micro)
        params[:] = [k for k, _ in model.named_parameters()]
        return {"start": start, "loss": float(m["loss_sum"]) / float(m["count"]),
                "after": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}

    params: list = []
    control, refs = {}, {}
    for bn_stats in ("sync", "local"):
        runs = []
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            try:
                runs.append(one_step(bn_stats))
            finally:
                torch.backends.cudnn.deterministic = False
        refs[bn_stats] = runs[0]
        torch.save(runs[0], Path(ref_dir, f"{bn_stats}.pt"))
        control[bn_stats] = _update_rel(runs[1]["after"], runs[0], params)
    # sync BN's plain ops in one process at the global batch
    dist.init_process_group("gloo", init_method=f"file://{ref_dir}/one_rank_store",
                            rank=0, world_size=1)
    try:
        with _through_cross_rank():
            plain = one_step("sync")
    finally:
        dist.destroy_process_group()
    torch.save(plain, Path(ref_dir, "sync_plain.pt"))
    control["sync_plain"] = _update_rel(plain["after"], refs["sync"], params)
    control["sync_plain_loss_rel"] = abs(plain["loss"] - refs["sync"]["loss"]) / refs["sync"]["loss"]
    # how far rounding alone moves this step: cuDNN's sync step on images
    # moved by 1e-7 of themselves (seeded noise, about one f32 ulp)
    noise = torch.from_numpy(np.random.default_rng(9).standard_normal(
        batch["image"].shape).astype(np.float32)).to(dev)
    moved = one_step("sync", batch={**batch, "image": batch["image"] * (1 + 1e-7 * noise)})
    control["ulp_input"] = _update_rel(moved["after"], refs["sync"], params)
    # one process at the ranks' shapes: two microbatches of 64 (grad
    # accumulation), each its own BatchNorm group, which is local BN's step
    accum = one_step("sync", n_micro=2)
    torch.save(accum, Path(ref_dir, "local_accum.pt"))
    control["local_shapes"] = _update_rel(accum["after"], refs["local"], params)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return control


def _update_rel(after: dict, ref: dict, params: list) -> float:
    """||after - ref's after|| / ||ref's update|| over the parameters."""
    import math

    diff = sum(float(((after[k] - ref["after"][k]) ** 2).sum()) for k in params)
    update = sum(float(((ref["after"][k] - ref["start"][k]) ** 2).sum()) for k in params)
    return math.sqrt(diff / update)


def _ddp_batch(image_size: int, batch_size: int) -> dict:
    rng = np.random.default_rng(8)
    return {"image": rng.normal(0, 1, (batch_size, image_size, image_size, 3)).astype(np.float32),
            "label": rng.integers(0, 1000, batch_size)}


def _ddp_child(rank: int, world: int, store: str, out_dir: str, device: str, image_size: int,
               batch_size: int) -> None:
    """One of two gloo ranks on the one card: the main path (ResNet50-1K
    through ``Trainer(plan=...).fit()``, counted), the two-rank step alone,
    and the f32 step against one process's (``_ddp_reference``); writes
    what it saw as JSON."""
    import hashlib
    import math
    import os
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    # a spawned process starts from torch's defaults (TF32 convolutions)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.data import DataLoader, SyntheticImageDataset
        from tpuframe_torch.models import ReplicaGroupedBatchNorm, ResNet50
        from tpuframe_torch.ops.blockwise_attention import (
            blockwise_attention_bwd_dkv,
            blockwise_attention_bwd_dq,
            blockwise_attention_fwd,
        )
        from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
        from tpuframe_torch.ops.normalize import normalize_images
        from tpuframe_torch.parallel import ParallelPlan, full_precision
        from tpuframe_torch.train import (
            Callback,
            Trainer,
            create_train_state,
            make_optimizer,
            make_train_step,
        )
        from tpuframe_torch.train.step import _MeanSync

        class StepLosses(Callback):
            def __init__(self):
                self.losses = []

            def on_batch_end(self, trainer, metrics):
                self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

        rt = initialize(device=device, backend="gloo")
        try:
            dev = rt.device
            # -- the main path: counts zeroed just before, read just after --
            model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
            train = DataLoader(SyntheticImageDataset(n=batch_size * DDP_STEPS,
                                                     image_size=image_size, num_classes=1000,
                                                     seed=1),
                               batch_size, shuffle=True, seed=0, transfer_dtype="uint8",
                               num_workers=4, worker_mode="process")
            eval_images = 2 * batch_size + 44 * batch_size // TRAIN_BATCH  # a ragged last batch
            evl = DataLoader(SyntheticImageDataset(n=eval_images, image_size=image_size,
                                                   num_classes=1000, seed=2),
                             batch_size, drop_last=False, transfer_dtype="uint8", num_workers=4)
            steps = StepLosses()
            trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl,
                              optimizer="sgd", lr=0.1, precision="bf16", normalize=(MEAN, STD),
                              max_duration=f"{DDP_STEPS}ba", log_interval=1, callbacks=[steps],
                              plan=ParallelPlan(mesh=rt.mesh))
            trainer.init_state()
            eval_counts = []
            eval_step = trainer._eval_step

            def counted_eval(state, batch):
                m = eval_step(state, batch)
                eval_counts.append(float(m["count"]))
                return m

            trainer._eval_step = counted_eval
            counters = {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
                        "cross_entropy_bwd": cross_entropy_bwd,
                        "blockwise_attention_fwd": blockwise_attention_fwd,
                        "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
                        "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv}
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            result = trainer.fit()
            sync(dev)
            fit_s = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            train.close()
            digest = hashlib.sha256()
            for t in model.state_dict().values():
                digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
            summary = result.history[-1]
            out["fit"] = {
                "launches": launches, "n_eval": len(evl), "eval_count": sum(eval_counts),
                "eval_images": eval_images, "losses": steps.losses, "fit_s": fit_s,
                "digest": digest.hexdigest(), "plan_world": trainer.plan.dp_size,
                "local_batch": train.local_batch_size, "bad_steps": summary["health_bad_steps"],
                "eval_loss": summary["eval_loss"],
                "finite": all(math.isfinite(v) for v in steps.losses)}

            # -- the two-rank step alone on a device-resident local batch -----
            rng = np.random.default_rng(3 + rank)
            local = batch_size // world
            batch = {"image": torch.from_numpy(rng.integers(
                         0, 256, (local, image_size, image_size, 3), dtype=np.uint8)).to(dev),
                     "label": torch.from_numpy(rng.integers(0, 1000, local)).to(dev)}
            state, step = trainer.state, trainer._train_step
            for _ in range(3):
                step(state, batch)
            times = []
            for _ in range(DDP_TIMED):
                sync(dev)
                t0 = time.perf_counter()
                step(state, batch)
                sync(dev)
                times.append(time.perf_counter() - t0)
            out["step_ms"] = statistics.median(times) * 1e3
            out["step_ms_all"] = [t * 1e3 for t in times]
            # the stage alone on this step's gradients: the gradient
            # all-reduce in 25 MB buckets and the metrics' sum
            stage = _MeanSync(trainer.plan)
            zero = torch.zeros((), device=dev)
            times = []
            for i in range(8):
                sync(dev)
                t0 = time.perf_counter()
                stage(state, zero, {"count": zero})
                sync(dev)
                if i >= 3:
                    times.append(time.perf_counter() - t0)
            out["grad_sync_ms"] = statistics.median(times) * 1e3
            if dev.type == "cuda":
                # device time of the step, and of the same step with each
                # rank's BatchNorm on its own rows (cuDNN's, no collective)
                out["profile"] = profile(lambda: step(state, batch),
                                         f"rank {rank}: two-rank step of {local} (sync BN)", top=0)
                with mock.patch.object(_MeanSync, "statistics",
                                       lambda self, model: contextlib.nullcontext()):
                    out["profile_local_bn"] = profile(
                        lambda: step(state, batch),
                        f"rank {rank}: the same step, BatchNorm on the rank's rows", top=0)
            del trainer, state, model, batch
            if dev.type == "cuda":
                torch.cuda.empty_cache()

            # -- f32: two ranks on their halves against one process ------------
            glob = _ddp_batch(image_size, batch_size)
            rows = slice(rank * local, (rank + 1) * local)
            mine = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(dev)
                    for k, v in glob.items()}
            refs = {name: torch.load(Path(out_dir, f"{name}.pt"))
                    for name in ("sync", "local", "sync_plain", "local_accum")}
            for bn_stats, fault in [("sync", None), ("local", None)] + [
                    ("sync", f) for f in DDP_FAULTS]:
                ref = refs[bn_stats]
                f32 = ResNet50(num_classes=1000, device=dev, seed=7, bn_stats=bn_stats,
                               bn_groups=2)
                same_start = all(torch.equal(v.cpu(), ref["start"][k])
                                 for k, v in f32.state_dict().items())
                state = create_train_state(f32, make_optimizer("sgd", 0.1))
                with _planted_bn_fault(fault) if fault else contextlib.nullcontext():
                    state, m = make_train_step(full_precision(), plan=ParallelPlan(mesh=rt.mesh))(
                        state, mine)
                loss = float(m["loss_sum"]) / float(m["count"])
                after = {k: v.cpu() for k, v in f32.state_dict().items()}
                params = [k for k, _ in f32.named_parameters()]
                rel = _update_rel(after, ref, params)
                if fault:
                    out[f"fault_{fault}"] = {"update_rel": rel, "vs_plain": _update_rel(
                        after, refs["sync_plain"], params)}
                    del f32, state
                    continue
                stats_err = max(float(((after[k] - ref["after"][k]).abs()
                                       - DDP_STATS_TOL * (1.0 + ref["after"][k].abs())).max())
                                for k in after if k.endswith(("running_mean", "running_var")))
                digest = hashlib.sha256()
                for t in after.values():
                    digest.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
                out[f"f32_{bn_stats}"] = {
                    "same_start": same_start, "loss": loss, "ref_loss": ref["loss"],
                    "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
                    "stats_excess": stats_err, "update_rel": rel,
                    "entry_abs": max(float((after[k] - ref["after"][k]).abs().max())
                                     for k in params),
                    "groups": sorted({mod.groups for mod in f32.modules()
                                      if isinstance(mod, ReplicaGroupedBatchNorm)}),
                    "digest": digest.hexdigest()}
                if bn_stats == "local":
                    out["f32_local"]["vs_shapes"] = _update_rel(after, refs["local_accum"], params)
                else:
                    out["f32_sync"]["vs_plain"] = _update_rel(after, refs["sync_plain"], params)
                del f32, state
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def ddp_phase(card: str, timeout_s: float = 900.0, device: str = "cuda:0",
              image_size: int = 224, batch_size: int = TRAIN_BATCH) -> dict:
    """Uncompressed data parallelism on one card: two spawned gloo ranks
    (NCCL refuses two ranks on one device) train ResNet50-1K as phase 5
    configures it through ``Trainer(plan=ParallelPlan(mesh=rt.mesh)).fit()``
    (the main path, counted on each rank), time the two-rank step, and hold
    one f32 step against one process's on the global batch, for sync and
    local BatchNorm.  Returns the ranks' launch counts and a summary.  The
    device and sizes are arguments so the phase can be rehearsed small on
    the CPU."""
    import math
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        control = _ddp_reference(torch.device(device), image_size, batch_size, tmp)
        # (c): the ranks write their telemetry, which the analyzer then reads
        tele = Path(tmp, "telemetry")
        with mock.patch.dict(os.environ, {"TPUFRAME_TELEMETRY_DIR": str(tele)}):
            res = _spawn(_ddp_child, 2, (device, image_size, batch_size), timeout_s,
                         "ddp phase", tmp)
        fleet = analyze_part(tele, Path(tmp, "fleet_trace.json"), card)
    fits = [o["fit"] for o in res]
    n_eval = fits[0]["n_eval"]
    expected = {"normalize": DDP_STEPS + n_eval, "cross_entropy_fwd": DDP_STEPS + n_eval,
                "cross_entropy_bwd": DDP_STEPS, "blockwise_attention_fwd": 0,
                "blockwise_attention_bwd_dq": 0, "blockwise_attention_bwd_dkv": 0}
    for r, f in enumerate(fits):
        check(f["launches"] == expected, f"ddp rank {r} launches {f['launches']} != {expected}")
        check(f["plan_world"] == 2 and f["local_batch"] == batch_size // 2,
              f"ddp rank {r}: plan world {f['plan_world']}, local batch {f['local_batch']}")
        check(f["eval_count"] == f["eval_images"],
              f"ddp rank {r}: eval counted {f['eval_count']} of {f['eval_images']} images")
        check(f["finite"] and len(f["losses"]) == DDP_STEPS, f"ddp rank {r} losses {f['losses']}")
        check(abs(f["losses"][0] - math.log(1000)) <= 1.0,
              f"ddp first-step loss {f['losses'][0]:.4f} not within 1.0 of ln 1000")
        check(f["bad_steps"] == 0.0, f"ddp rank {r}: {f['bad_steps']} bad steps")
    check(fits[0]["digest"] == fits[1]["digest"],
          "the two ranks ended the fit with different parameters or BatchNorm buffers")
    check(fits[0]["losses"] == fits[1]["losses"], "the two ranks logged different losses")
    log(f"  two gloo ranks on one card, ResNet50-1K bf16 through Trainer(plan).fit(): "
        f"{DDP_STEPS} steps of {batch_size} ({batch_size // 2} a rank) + eval of "
        f"{fits[0]['eval_images']} images, counted once each; launches a rank "
        f"{fits[0]['launches']} (expected {expected}); step losses "
        f"{[round(v, 4) for v in fits[0]['losses']]}; parameters and BN buffers bit-equal on "
        f"both ranks ({fits[0]['fit_s']:.2f} s)")
    f32 = {}
    for bn_stats in ("sync", "local"):
        a, b = (o[f"f32_{bn_stats}"] for o in res)
        check(a["same_start"] and b["same_start"], f"f32 {bn_stats}: ranks started elsewhere")
        check(a["digest"] == b["digest"] and a["loss"] == b["loss"],
              f"f32 {bn_stats}: the ranks ended the step apart")
        check(a["groups"] == [1 if bn_stats == "sync" else 2], f"f32 {bn_stats}: groups {a}")
        log(f"  f32 step, two ranks vs one process ({bn_stats} BN, ResNet50-1K, {image_size} px, "
            f"batch {batch_size}): loss rel diff {a['loss_rel']:.3g} (tol {DDP_LOSS_RTOL}), "
            f"running statistics within {DDP_STATS_TOL} (excess {a['stats_excess']:.3g}), update "
            f"rel diff {a['update_rel']:.3g} (tol {DDP_UPDATE_RTOL}; one process against itself "
            f"with deterministic cuDNN: {control[bn_stats]:.3g}); largest entry diff "
            f"{a['entry_abs']:.3g}")
        check(a["loss_rel"] <= DDP_LOSS_RTOL, f"f32 {bn_stats} loss rel diff {a['loss_rel']}")
        check(a["stats_excess"] <= 0.0,
              f"f32 {bn_stats} running statistics beyond {DDP_STATS_TOL} (atol and rtol): {a}")
        check(a["update_rel"] <= DDP_UPDATE_RTOL, f"f32 {bn_stats} update rel diff {a}")
        f32[bn_stats] = {k: a[k] for k in ("loss_rel", "stats_excess", "update_rel", "entry_abs")}
        f32[bn_stats]["control_rel"] = control[bn_stats]
    a = res[0]["f32_local"]
    log(f"  local BN's step in one process at the ranks' shapes (two microbatches of "
        f"{batch_size // 2}): "
        f"update rel diff {control['local_shapes']:.3g} from one process at batch 128; the "
        f"two ranks {a['vs_shapes']:.3g} from it (tol {DDP_SHAPES_RTOL})")
    check(a["vs_shapes"] <= DDP_SHAPES_RTOL, f"f32 local against the microbatched step: {a}")
    f32["local"].update(vs_shapes=a["vs_shapes"], shapes_rel=control["local_shapes"])
    a = res[0]["f32_sync"]
    log(f"  sync BN's plain ops in one process (every BatchNorm through the cross-rank function "
        f"on a one-rank gloo group, batch {batch_size}): update rel diff "
        f"{control['sync_plain']:.3g} from cuDNN's step (loss rel diff "
        f"{control['sync_plain_loss_rel']:.3g}); the two ranks {a['vs_plain']:.3g} from it "
        f"(tol {DDP_UPDATE_RTOL}); "
        f"cuDNN's step on images moved by 1e-7 of themselves {control['ulp_input']:.3g} from "
        f"cuDNN's step (rounding alone)")
    check(a["vs_plain"] <= DDP_UPDATE_RTOL, f"f32 sync against the plain-op step: {a}")
    f32["sync"].update(vs_plain=a["vs_plain"], plain_rel=control["sync_plain"],
                       ulp_input_rel=control["ulp_input"])
    faults = {}
    for fault in DDP_FAULTS:
        fa, fb = (o[f"fault_{fault}"] for o in res)
        faults[fault] = fa
        log(f"  planted fault of the sync backward, {fault}: update rel diff "
            f"{fa['update_rel']:.3g} from one process's step (limit {DDP_UPDATE_RTOL}), "
            f"{fa['vs_plain']:.3g} from the plain-op one")
        check(fa["update_rel"] > DDP_UPDATE_RTOL and fb["update_rel"] > DDP_UPDATE_RTOL,
              f"the update's limit {DDP_UPDATE_RTOL} misses the planted fault {fault!r}: {fa}")
    f32["faults"] = faults
    step_ms = max(o["step_ms"] for o in res)
    img_s = batch_size / (step_ms / 1e3)
    grad_sync_ms = max(o["grad_sync_ms"] for o in res)
    log(f"  two-rank step alone (bf16, {batch_size // 2} a rank, gloo: every collective goes "
        f"through the host): median {step_ms:.2f} ms over {DDP_TIMED} steps = {img_s:.1f} img/s "
        f"on {card}; a correctness phase, not a scaling number")
    log(f"  of which the gradient all-reduce (25,557,032 f32 in 25 MB buckets) and the metrics' "
        f"sum alone: median {grad_sync_ms:.2f} ms")
    profiles = {}
    if "profile" in res[0]:
        for key, what in (("profile", "sync BN"),
                          ("profile_local_bn", "BatchNorm on the rank's rows (cuDNN)")):
            ps = [o[key] for o in res]
            profiles[key] = {k: [p[k] for p in ps] for k in ("wall_ms", "device_ms", "launches")}
            r = profiles[key]
            log(f"  profile of the two-rank step, {what}: device {r['device_ms']} ms over "
                f"{r['launches']} launches, wall {r['wall_ms']} ms (ranks 0, 1) on {card}")
    out = {"launches": fits[0]["launches"], "step_ms": step_ms, "img_per_s": img_s,
           "grad_sync_ms": grad_sync_ms,
           "step_ms_ranks": [o["step_ms_all"] for o in res], "f32": f32, "profiles": profiles,
           "fit_s": fits[0]["fit_s"], "losses": fits[0]["losses"], "fleet": fleet, "card": card,
           "seconds": time.perf_counter() - t0}
    log("  ddp_json " + json.dumps(out))
    return out


# -- phase 15: overlapped and fused data parallelism -------------------------------

OVERLAP_GROUPS = 4  # the grouped wire's bucket groups (25 buckets: 7, 6, 6, 6)
OVERLAP_TIMED = 5  # timed steps an arm, each turn, after 2 warm ones
#: the two-rank uncompressed step as first measured on the card, before its
#: buckets were fired from the backward (PERF.md §5), for the log
EARLIER_STEP_MS = "367-563"
#: the fits of the phase: (name, plan keywords, grad_compression, hooks armed)
OVERLAP_FITS = (
    ("wire_g4_fused", dict(comms_groups=OVERLAP_GROUPS, comms_fused=True), "int8", True),
    ("wire_g1_staged", dict(comms_groups=1, comms_fused=False), "int8", True),
    ("mean_overlapped", {}, None, True),
    ("mean_after_backward", {}, None, False),
)
#: the timed arms: (name, plan keywords, grad_compression, hooks armed)
OVERLAP_ARMS = (
    ("wire_g1_staged", dict(comms_groups=1, comms_fused=False), "int8", True),
    ("wire_g1_fused", dict(comms_groups=1, comms_fused=True), "int8", True),
    ("wire_g4_staged", dict(comms_groups=OVERLAP_GROUPS, comms_fused=False), "int8", True),
    ("wire_g4_fused", dict(comms_groups=OVERLAP_GROUPS, comms_fused=True), "int8", True),
    ("mean_overlapped", {}, None, True),
    ("mean_after_backward", {}, None, False),
)


@contextlib.contextmanager
def _hooks_unarmed(armed: bool):
    """The data-parallel stages with their gradient hooks never armed (every
    bucket taken after the backward, the non-overlapped order) unless
    ``armed``."""
    from tpuframe_torch.train import step as train_step

    if armed:
        yield
        return
    with mock.patch.object(train_step._FiredStage, "arm", lambda self, state, n=1: None):
        yield


def _overlap_child(rank: int, world: int, store: str, out_dir: str, device: str,
                   image_size: int, batch_size: int) -> None:
    """One of two gloo ranks on the one card: phase 10's ResNet50-1K fit
    through each of ``OVERLAP_FITS`` (counted, deterministic cuDNN, so two
    fits can be held bit for bit), then the step of each of
    ``OVERLAP_ARMS`` alone, in turns, and a profile of each; writes what it
    saw as JSON."""
    import hashlib
    import math
    import os
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {"fits": {}}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.data import DataLoader, SyntheticImageDataset
        from tpuframe_torch.models import ResNet50
        from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
        from tpuframe_torch.ops.normalize import normalize_images
        from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode
        from tpuframe_torch.parallel import ParallelPlan
        from tpuframe_torch.train import Callback, Trainer, make_train_step

        class StepLosses(Callback):
            def __init__(self):
                self.losses = []

            def on_batch_end(self, trainer, metrics):
                self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

        counters = {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
                    "cross_entropy_bwd": cross_entropy_bwd, "bucket_abs_max": bucket_abs_max,
                    "quant_encode": quant_encode, "quant_decode": quant_decode}
        rt = initialize(device=device, backend="gloo")
        try:
            dev = rt.device

            def trainer_for(plan_kw, wire, steps):
                model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
                train = DataLoader(SyntheticImageDataset(n=batch_size * steps,
                                                         image_size=image_size, num_classes=1000,
                                                         seed=1),
                                   batch_size, shuffle=True, seed=0, transfer_dtype="uint8",
                                   num_workers=4)
                eval_images = 2 * batch_size + 44 * batch_size // TRAIN_BATCH  # ragged last
                evl = DataLoader(SyntheticImageDataset(n=eval_images, image_size=image_size,
                                                       num_classes=1000, seed=2),
                                 batch_size, drop_last=False, transfer_dtype="uint8",
                                 num_workers=4)
                steps_cb = StepLosses()
                trainer = Trainer(model, train_dataloader=train, eval_dataloader=evl,
                                  optimizer="sgd", lr=0.1, precision="bf16",
                                  normalize=(MEAN, STD), max_duration=f"{steps}ba",
                                  log_interval=1, callbacks=[steps_cb],
                                  plan=ParallelPlan(mesh=rt.mesh, **plan_kw),
                                  grad_compression=wire)
                trainer.init_state()
                return trainer, steps_cb, len(evl)

            # -- the main path, each fit counted: zeroed just before, read after
            torch.backends.cudnn.deterministic = True
            kept = {}
            for name, plan_kw, wire, armed in OVERLAP_FITS:
                trainer, steps_cb, n_eval = trainer_for(plan_kw, wire, DDP_STEPS)
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                with _hooks_unarmed(armed):
                    result = trainer.fit()
                sync(dev)
                fit_s = time.perf_counter() - t0
                launches = {k: fn.launches for k, fn in counters.items()}
                digest = hashlib.sha256()
                for t in trainer.model.state_dict().values():
                    digest.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
                summary = result.history[-1]
                out["fits"][name] = {
                    "launches": launches, "n_eval": n_eval, "losses": steps_cb.losses,
                    "fit_s": fit_s, "digest": digest.hexdigest(),
                    "finite": all(math.isfinite(v) for v in steps_cb.losses),
                    "bad_steps": summary["health_bad_steps"],
                    "groups": (trainer._train_step.wire or {}).get("overlap_groups"),
                    "fused": (trainer._train_step.wire or {}).get("fused")}
                if name in ("wire_g4_fused", "mean_overlapped"):
                    kept["wire" if wire else "mean"] = trainer
                else:
                    del trainer
            torch.backends.cudnn.deterministic = False
            if dev.type == "cuda":
                torch.cuda.empty_cache()

            # -- each arm's step alone on a device-resident local batch ----------
            rng = np.random.default_rng(3 + rank)
            local = batch_size // world
            batch = {"image": torch.from_numpy(rng.integers(
                         0, 256, (local, image_size, image_size, 3), dtype=np.uint8)).to(dev),
                     "label": torch.from_numpy(rng.integers(0, 1000, local)).to(dev)}
            calls = {}
            for name, plan_kw, wire, armed in OVERLAP_ARMS:
                trainer = kept["wire" if wire else "mean"]
                transform = functools.partial(normalize_images, mean=MEAN, std=STD,
                                              out_dtype=trainer.policy.compute_dtype)
                step = make_train_step(trainer.policy, batch_transform=lambda b, t=transform: {
                    **b, "image": t(b["image"])}, health=trainer.health,
                    plan=ParallelPlan(mesh=rt.mesh, **plan_kw), grad_compression=wire)

                def call(step=step, state=trainer.state, armed=armed):
                    with _hooks_unarmed(armed):
                        step(state, batch)

                calls[name] = call
            times = {name: [] for name in calls}
            for turn in (list(calls), list(calls)[::-1]):
                for name in turn:
                    for _ in range(2):
                        calls[name]()
                    runs = []
                    for _ in range(OVERLAP_TIMED):
                        sync(dev)
                        t0 = time.perf_counter()
                        calls[name]()
                        sync(dev)
                        runs.append((time.perf_counter() - t0) * 1e3)
                    times[name].append(statistics.median(runs))
            out["step_ms"] = times
            if dev.type == "cuda":
                out["profiles"] = {name: profile(fn, f"rank {rank}: {name} step of {local}",
                                                 top=0) for name, fn in calls.items()}
            del kept, calls, batch
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def overlap_phase(card: str, timeout_s: float = 900.0, device: str = "cuda:0",
                  image_size: int = 224, batch_size: int = TRAIN_BATCH) -> dict:
    """Two spawned gloo ranks on the one card train ResNet50-1K as phase 10
    configures it through the grouped, fused wire (``Trainer(plan=
    ParallelPlan(mesh=rt.mesh, comms_groups=4, comms_fused=True),
    grad_compression="int8")``), then through the staged single shot, then
    uncompressed with the buckets fired from the backward and with them
    taken after it, each fit counted.  The grouped fused fit must equal the
    staged single shot bit for bit (integer totals are exact), the
    overlapped uncompressed fit the non-overlapped one (two addends
    commute), each on both ranks; K5a-K5c launch groups x steps times on
    each rank, K1 and K2 at phase 10's counts.  Then the two-rank step of
    each arm alone (in turns) and its device-busy share.  Returns the
    grouped fit's launches and a summary; the device and sizes are
    arguments so the phase can be rehearsed small on the CPU."""
    import math

    t0 = time.perf_counter()
    res = _spawn(_overlap_child, 2, (device, image_size, batch_size), timeout_s,
                 "overlap phase")
    fits = {name: [o["fits"][name] for o in res] for name, _, _, _ in OVERLAP_FITS}
    n_eval = fits["wire_g4_fused"][0]["n_eval"]
    for name, _, wire, _ in OVERLAP_FITS:
        groups = OVERLAP_GROUPS if name == "wire_g4_fused" else 1 if wire else 0
        expected = {"normalize": DDP_STEPS + n_eval, "cross_entropy_fwd": DDP_STEPS + n_eval,
                    "cross_entropy_bwd": DDP_STEPS, "bucket_abs_max": groups * DDP_STEPS,
                    "quant_encode": groups * DDP_STEPS, "quant_decode": groups * DDP_STEPS}
        for r, f in enumerate(fits[name]):
            check(f["launches"] == expected,
                  f"{name} rank {r}: launches {f['launches']} != {expected}")
            check(f["finite"] and len(f["losses"]) == DDP_STEPS, f"{name} rank {r}: {f['losses']}")
            check(abs(f["losses"][0] - math.log(1000)) <= 1.0,
                  f"{name}: first-step loss {f['losses'][0]:.4f} not within 1.0 of ln 1000")
            check(f["bad_steps"] == 0.0, f"{name} rank {r}: {f['bad_steps']} bad steps")
        check(fits[name][0]["digest"] == fits[name][1]["digest"],
              f"{name}: the two ranks ended the fit apart")
        log(f"  {name}: {DDP_STEPS} steps of {batch_size} on two gloo ranks + eval, launches a "
            f"rank {fits[name][0]['launches']} (expected {expected}), step losses "
            f"{[round(v, 4) for v in fits[name][0]['losses']]}, both ranks bit-equal "
            f"({fits[name][0]['fit_s']:.2f} s)")
    f = fits["wire_g4_fused"][0]
    check(f["groups"] == OVERLAP_GROUPS and f["fused"], f"the grouped fit's wire {f}")
    check(fits["wire_g4_fused"][0]["digest"] == fits["wire_g1_staged"][0]["digest"],
          "the grouped fused fit differs from the staged single-shot fit")
    check(fits["mean_overlapped"][0]["digest"] == fits["mean_after_backward"][0]["digest"],
          "the overlapped uncompressed fit differs from the non-overlapped one")
    log(f"  the grouped fused wire ({OVERLAP_GROUPS} groups fired from the backward; gloo's "
        "form is single) bit-equal to the staged single shot; the overlapped uncompressed fit "
        "bit-equal to the one that sums after the backward (deterministic cuDNN)")
    step_ms = {name: max(min(o["step_ms"][name]) for o in res) for name, _, _, _ in OVERLAP_ARMS}
    log(f"  two-rank step alone, bf16, {batch_size // 2} a rank (the better of two medians of "
        f"{OVERLAP_TIMED} steps in turns, slower rank): {json.dumps(step_ms)} ms on {card}; "
        f"the two-rank uncompressed step measured {EARLIER_STEP_MS} ms in other runs, before "
        "its buckets were fired from the backward (PERF.md §5)")
    busy = {}
    if "profiles" in res[0]:
        for name, _, _, _ in OVERLAP_ARMS:
            ps = [o["profiles"][name] for o in res]
            busy[name] = {"device_ms": [p["device_ms"] for p in ps],
                          "wall_ms": [p["wall_ms"] for p in ps],
                          "busy": [p["device_ms"] / p["wall_ms"] for p in ps]}
        log("  device busy of each arm's step (torch.profiler, ranks 0, 1): " + json.dumps(
            {k: [round(b, 4) for b in v["busy"]] for k, v in busy.items()}) + " on " + card
            + "; gloo routes every collective through the host, so this is a finding about "
            "overlap there, not a scaling number")
    out = {"launches": fits["wire_g4_fused"][0]["launches"], "step_ms": step_ms,
           "step_ms_ranks": [o["step_ms"] for o in res], "busy": busy,
           "losses": {k: v[0]["losses"] for k, v in fits.items()},
           "fit_s": {k: v[0]["fit_s"] for k, v in fits.items()}, "card": card,
           "seconds": time.perf_counter() - t0}
    log("  overlap_json " + json.dumps(out))
    return out


# -- phase 13: the launcher ------------------------------------------------------

LAUNCH_DIR = Path(__file__).resolve().parent / "build" / "tpuframe_torch" / "launcher_smoke"
EXAMPLES = "tpuframe_torch.examples"
#: example 01's and 05's defaults (``examples/_common.py``, 2 epochs of 512)
EX01_CFG = dict(epochs=2, batch_size=64, train_samples=512, image_size=32, num_classes=10,
                lr=1e-3, seed=42)
EX05_CFG = dict(epochs=2, batch_size=64, train_samples=512, lr=1e-3, seed=42)
OPT_STEPS = 20  # timed steps a optimizer, after 3 warm-up steps
OPT_BATCH = 128
OPTIMIZERS = (("sgd", 0.1, None), ("lion", 1e-4, None), ("lamb", 1e-3, None),
              ("adafactor", 1e-2, None), ("sgd", 0.1, 0.999))
UNFROZEN_STEPS = 10  # timed unfrozen steps a optimizer, after 3 warm-up steps


def _example(name: str):
    """A ported example by module name (``tpuframe_torch/examples``)."""
    import importlib

    return importlib.import_module(f"{EXAMPLES}.{name}")


def _k12():
    """The counters of K1 and K2a/K2b, the kernels of the examples' paths."""
    from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from tpuframe_torch.ops.normalize import normalize_images

    return {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
            "cross_entropy_bwd": cross_entropy_bwd}


def counted_call(kernels, module: str, fn: str, *args, **kwargs):
    """Worker side: ``module.fn(*args, **kwargs)`` with the kernels that
    ``kernels()`` names (:func:`_k12`, :func:`_zero_counters`,
    :func:`_tp_counters`) counted, zeroed just before and read just after.
    Returns (its value, the counts)."""
    counters = kernels()
    for c in counters.values():
        c.launches = 0
    value = getattr(_example(module), fn)(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return value, {n: c.launches for n, c in counters.items()}


def counted_loop(config: dict):
    """Worker side of the TPUTrainer run: example 05's ``train_func``,
    counted, the counts written beside the reports."""
    from tpuframe_torch.launch import get_context

    _, counts = counted_call(_k12, "05_ray_fashion_mnist", "train_func", config)
    ctx = get_context()
    Path(ctx.get_result_dir(), f"launches_{ctx.get_world_rank()}.json").write_text(
        json.dumps(counts))


def two_rank_job(mode: str, steps: int = 3):
    """Worker side of the two ranks on the one card (gloo: NCCL refuses two
    ranks on one device).  ``"lion"``: a few lion steps of MnistNet over
    the ranks' own batches, then both ranks' parameter digests and
    broadcast run ids, gathered to rank 0.  ``"raise"``: rank 1 raises
    (rank 0 returns at once).  ``"lost"``: rank 1 freezes whole (SIGSTOP)
    once its beacon was heard."""
    import hashlib
    import signal
    import uuid

    rank = int(os.environ["RANK"])
    if mode == "raise":
        if rank == 1:
            raise RuntimeError("planted failure on rank 1")
        return None
    if mode == "lost":
        if rank == 1:
            time.sleep(2.0)
            os.kill(os.getpid(), signal.SIGSTOP)
        time.sleep(120)
        return None
    import torch.distributed as dist

    from tpuframe_torch.core import initialize, shutdown
    from tpuframe_torch.models import MnistNet
    from tpuframe_torch.parallel import ParallelPlan
    from tpuframe_torch.track import broadcast_run_id
    from tpuframe_torch.train import create_train_state, make_optimizer, make_train_step

    rt = initialize(device="cuda:0", backend="gloo")
    try:
        model = MnistNet(device=rt.device, seed=0)
        state = create_train_state(model, make_optimizer("lion", 1e-3))
        step = make_train_step(plan=ParallelPlan(mesh=rt.mesh))
        rng = np.random.default_rng(10 + rank)
        losses = []
        for _ in range(steps):
            batch = {"image": torch.from_numpy(rng.uniform(0, 1, (32, 28, 28, 1)).astype(
                         np.float32)).to(rt.device),
                     "label": torch.from_numpy(rng.integers(0, 10, 32)).to(rt.device)}
            state, m = step(state, batch)
            losses.append(float(m["loss_sum"] / m["count"]))
        digest = hashlib.sha256(b"".join(p.detach().cpu().numpy().tobytes()
                                         for p in model.parameters())).hexdigest()
        run_id = broadcast_run_id(uuid.uuid4().hex if rank == 0 else None)
        gathered = [None, None]
        dist.all_gather_object(gathered, {"digest": digest, "run_id": run_id,
                                          "losses": losses, "device": str(rt.device)})
        return gathered
    finally:
        shutdown()


def launcher_phase(card: str) -> dict:
    """Phase 13 (module docstring).  Returns its numbers."""
    import shutil

    from tpuframe_torch.core import native
    from tpuframe_torch.core.runtime import reset_runtime
    from tpuframe_torch.launch import (
        Distributor,
        DistributorError,
        RunConfig,
        ScalingConfig,
        TPUTrainer,
        WorkerLostError,
    )
    from tpuframe_torch.models import MnistNet, ResNet50, TransferClassifier, freeze
    from tpuframe_torch.train import Trainer

    out: dict = {}
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    LAUNCH_DIR.mkdir(parents=True)
    try:
        # -- 1. example 01's worker through the Distributor, on the card ---------
        cfg = {**EX01_CFG, "tracking_uri": str(LAUNCH_DIR / "cifar" / "mlruns")}
        t0 = time.perf_counter()
        (summary, elapsed), counts = Distributor(num_processes=1, timeout_s=300).run(
            counted_call, _k12, "01_distributor_cifar_resnet", "train_cifar", cfg)
        spawn_s = time.perf_counter() - t0
        n_steps = cfg["epochs"] * (cfg["train_samples"] // cfg["batch_size"])
        want = {"normalize": 0, "cross_entropy_fwd": n_steps, "cross_entropy_bwd": n_steps}
        log(f"  example 01 through Distributor(num_processes=1): {spawn_s:.2f} s from spawn to "
            f"result, {elapsed:.2f} s in the worker's loop ({n_steps} steps of "
            f"{cfg['batch_size']} at {cfg['image_size']} px, bf16); launches {counts} "
            f"(expected {want}); {summary} on {card}")
        check(counts == want, f"example 01's worker launches {counts} != {want}")
        check(math.isfinite(summary["train_loss"]) and 0 <= summary["demo_pred"] < 10,
              f"example 01's result {summary}")
        out["ex01_spawn_to_result_s"] = spawn_s
        out["ex01_loop_s"] = elapsed

        # -- 2. example 05 through TPUTrainer, one worker on the card -------------
        t0 = time.perf_counter()
        result = TPUTrainer(counted_loop, train_loop_config=dict(EX05_CFG),
                            scaling_config=ScalingConfig(num_workers=1),
                            run_config=RunConfig(storage_path=str(LAUNCH_DIR / "ray"),
                                                 name="fashion")).fit()
        fit_s = time.perf_counter() - t0
        check(result.error is None, f"example 05's fit failed: {result.error!r}")
        counts = json.loads(Path(result.path, "launches_0.json").read_text())
        n_steps = EX05_CFG["epochs"] * (EX05_CFG["train_samples"] // EX05_CFG["batch_size"])
        want = {"normalize": 0, "cross_entropy_fwd": n_steps, "cross_entropy_bwd": n_steps}
        epochs = [m["epoch"] for m in result.metrics_dataframe]
        check(epochs == [float(e) for e in range(EX05_CFG["epochs"])],
              f"example 05 reported epochs {epochs}")
        check(counts == want, f"example 05's worker launches {counts} != {want}")
        with result.checkpoint.as_directory() as d:
            meta = json.loads(Path(d, "meta.json").read_text())
            tree = torch.load(Path(d, "model.msgpack"), map_location="cuda", weights_only=True)
        reloaded = MnistNet(device="cuda", seed=1)
        reloaded.load_state_dict(tree["params"])
        logp = reloaded(torch.zeros(2, 28, 28, 1, device="cuda"))
        check(meta == {"epoch": EX05_CFG["epochs"] - 1} and bool(torch.isfinite(logp).all()),
              f"example 05's checkpoint bundle: meta {meta}")
        log(f"  example 05 through TPUTrainer(1 worker): {fit_s:.2f} s from spawn to result, "
            f"{len(epochs)} reports, launches {counts} (expected {want}), metrics "
            f"{result.metrics}; its last bundle reloads into MnistNet on the card")
        out["ex05_spawn_to_result_s"] = fit_s

        # -- 3. two ranks on the one card ------------------------------------------
        check(native.heartbeat_available(), f"the heartbeat did not build: {native.build_error}")
        t0 = time.perf_counter()
        dist2 = Distributor(num_processes=2, timeout_s=300)
        ranks = dist2.run(two_rank_job, "lion")
        two_s = time.perf_counter() - t0
        check(ranks[0]["digest"] == ranks[1]["digest"],
              "two ranks' lion steps left different parameters")
        check(ranks[0]["run_id"] == ranks[1]["run_id"] and len(ranks[0]["run_id"]) == 32,
              f"broadcast_run_id gave {ranks[0]['run_id']!r} and {ranks[1]['run_id']!r}")
        check(all(r["device"] == "cuda:0" for r in ranks), f"devices {ranks}")
        log(f"  two gloo ranks on the card: 3 lion steps of MnistNet bit-equal on both ranks "
            f"(losses {[round(v, 4) for v in ranks[0]['losses']]}), one run id; "
            f"{two_s:.2f} s from spawn to result; heartbeat monitor {dist2.heartbeat_active}")
        t0 = time.perf_counter()
        try:
            Distributor(num_processes=2, timeout_s=120).run(two_rank_job, "raise")
            check(False, "a raising rank did not fail the run")
        except RuntimeError as e:
            cause = e.__cause__
            check(isinstance(cause, DistributorError) and cause.rank == 1
                  and cause.returncode == 1 and "planted failure" in cause.stderr_tail
                  and "Traceback" in cause.stderr_tail, f"raising rank surfaced as {e!r}")
        raise_s = time.perf_counter() - t0
        lost = Distributor(num_processes=2, timeout_s=120, heartbeat_timeout_s=3.0)
        t0 = time.perf_counter()
        try:
            lost.run(two_rank_job, "lost")
            check(False, "a lost rank did not fail the run")
        except WorkerLostError as e:
            check(e.rank == 1 and lost.heartbeat_active is True,
                  f"lost rank surfaced as {e!r} (monitor {lost.heartbeat_active})")
            lost_s = time.perf_counter() - t0
            log(f"  a raising rank: its RuntimeError with DistributorError(rank 1, exit 1, its "
                f"traceback) as cause in {raise_s:.2f} s; a lost rank (SIGSTOP): "
                f"WorkerLostError(rank 1, silent {e.silent_s:.1f} s) in {lost_s:.2f} s at a "
                f"3 s heartbeat timeout, the monitor built here")
        out.update(two_rank_s=two_s, raise_s=raise_s, lost_s=lost_s)

        # -- 4. a step per optimizer, frozen ResNet50 backbone ---------------------
        backbone = ResNet50(num_classes=0, device="cuda", seed=0)
        model = freeze(TransferClassifier(backbone, 10, device="cuda", seed=0))
        frozen0 = {n: p.detach().clone() for n, p in model.backbone.named_parameters()}
        rng = np.random.default_rng(5)
        batch = {"image": torch.from_numpy(rng.integers(
                     0, 256, (OPT_BATCH, 224, 224, 3), dtype=np.uint8)).cuda(),
                 "label": torch.from_numpy(rng.integers(0, 10, OPT_BATCH)).cuda()}

        def timed_steps(name, lr, ema, n_steps):
            """The median of ``n_steps`` synced steps of ``model`` under
            ``name``, after 3 warm-up steps; the last step's metrics."""
            trainer = Trainer(model, optimizer=name, lr=lr, ema_decay=ema, precision="bf16",
                              normalize=(MEAN, STD), health=False)
            state, step = trainer.init_state(), trainer._train_step
            for _ in range(3):
                state, m = step(state, batch)
            times = []
            for _ in range(n_steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            label = name if ema is None else f"{name}+ema"
            check(math.isfinite(float(m["loss_sum"])), f"{label}: loss {m['loss_sum']}")
            return label, statistics.median(times)

        step_ms = {}
        for name, lr, ema in OPTIMIZERS:
            label, step_ms[label] = timed_steps(name, lr, ema, OPT_STEPS)
            trained = [p for p in model.parameters() if p.requires_grad]
            check(len(trained) == 2 and all(p.grad is not None for p in trained),
                  f"{label}: the head's two tensors should train")
        moved = [n for n, p in model.backbone.named_parameters()
                 if not torch.equal(p, frozen0[n])]
        check(not moved, f"the frozen backbone moved: {moved[:5]}")
        log(f"  TransferClassifier(ResNet50(num_classes=0), 10), backbone frozen, bf16, "
            f"{OPT_BATCH} x 224 px, one synced step (median of {OPT_STEPS}): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in step_ms.items())
            + f"; the backbone's {len(frozen0)} tensors bit-equal after all of them, on {card}")
        out["optimizer_step_ms"] = step_ms
        # the same step with every tensor training: the per-tensor optimizers'
        # cost at a full model's 161 tensors
        model.requires_grad_(True)
        unfrozen_ms = {}
        for name, lr, ema in OPTIMIZERS[:4]:
            label, unfrozen_ms[label] = timed_steps(name, lr, ema, UNFROZEN_STEPS)
            trained = list(model.parameters())
            check(len(trained) == len(frozen0) + 2 and all(p.grad is not None for p in trained),
                  f"{label}: every tensor should train")
        moved = [n for n, p in model.backbone.named_parameters()
                 if not torch.equal(p, frozen0[n])]
        check(len(moved) == len(frozen0), f"unfrozen, {len(moved)} of {len(frozen0)} moved")
        log(f"  the same step unfrozen ({len(frozen0) + 2} tensors train; median of "
            f"{UNFROZEN_STEPS}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in unfrozen_ms.items())
            + f" on {card}")
        out["unfrozen_step_ms"] = unfrozen_ms
        del model, backbone, batch
        torch.cuda.empty_cache()

        # -- 5. examples 03 and 04 in this process, on the card --------------------
        for name, tag in (("03_composer_cifar_resnet", "composer"),
                          ("04_accelerate_cifar", "accelerate")):
            counters = _k12()
            for c in counters.values():
                c.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _example(name).main(["--epochs", "1", "--train-samples", "192",
                                     "--eval-samples", "100", "--workdir", str(LAUNCH_DIR)])
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            text = buf.getvalue()
            counts = {n: c.launches for n, c in counters.items()}
            # 3 train steps of 64 and an eval of 2 batches (64 + a ragged 36);
            # example 03's LabelSmoothing and CutMix make soft labels, which
            # take the plain soft cross entropy, so only its eval runs K2a
            want = ({"normalize": 0, "cross_entropy_fwd": 2, "cross_entropy_bwd": 0}
                    if tag == "composer" else
                    {"normalize": 0, "cross_entropy_fwd": 5, "cross_entropy_bwd": 3})
            check(counts == want, f"example {name}: launches {counts} != {want}")
            if tag == "composer":
                check("registered=v1@champion" in text, f"example 03 printed {text[-500:]}")
            else:
                check("epoch 0 [" in text and "eval_loss" in text,
                      f"example 04 printed {text[-500:]}")
            log(f"  example {name[:2]} in process: {took:.2f} s, 3 steps of 64 + eval, launches "
                f"{counts} (expected {want}); {text.strip().splitlines()[-1][:160]}")
            out[f"ex{name[:2]}_s"] = took
            reset_runtime()
    finally:
        shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    return out



STREAM_DIR = Path(__file__).resolve().parent / "build" / "tpuframe_torch" / "stream_smoke"
STREAM_IMAGES = 4096  # the volume, written from the seed
STREAM_PX = 224
STREAM_BATCH = 128
STREAM_STEPS = 12  # batches of each data-fed fit
STREAM_SHARDS = 10  # shards aimed at (each format must reach 8 at least)
STREAM_RESIDENT_STEPS = 30  # synced steps of the device-resident step, each turn
STREAM_PROFILED_STEPS = 8  # batches of the profiled data-fed fit (steps 2..8 profiled)
#: example 01a's defaults (its ``main``: 64 px, 200 classes, 2 epochs of
#: 256, eval 64, batch 64)
EX01A_ARGS = dict(epochs=2, train_samples=256, eval_samples=64, batch_size=64)
#: example 07 at ``--tp 1``, cut to 3 steps of 64 and an eval of 2 batches
EX07_ARGV = ["--epochs", "1", "--train-samples", "192", "--eval-samples", "128"]


def synth_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """Low-frequency synthetic image: upsampled 8x8 noise plus a gradient
    (``benchmarks/bench_e2e.py``'s style), so it compresses like a
    photograph (~10:1 as JPEG), not like noise."""
    base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    tile = -(-size // 8)
    img = np.kron(base, np.ones((tile, tile, 1), np.uint8))[:size, :size]
    ramp = np.linspace(0, 64, size, dtype=np.uint8)[:, None, None]
    return np.clip(img.astype(np.int16) + ramp, 0, 255).astype(np.uint8)


def stream_backends() -> dict:
    """Which decoder, codec and resize the streaming path takes here."""
    from tpuframe_torch.core import native
    from tpuframe_torch.data import streaming

    try:
        import PIL  # noqa: F401

        resize = "pil"
    except ImportError:
        resize = "nearest"
    return {"decoder": streaming._decoder_name(), "codec": streaming._codec_name(),
            "resize": resize,
            "codec_build_error": native.build_errors.get("tfscodec"),
            "jpeg_build_error": native.build_errors.get("tfjpeg")}


def write_stream_volumes(root: Path, n_images: int, px: int, seed: int, backends: dict) -> dict:
    """The same ``n_images`` synthetic images as a TFS volume
    (``ShardWriter``) and an MDS volume (``MDSWriter``) under
    ``root/remote``: JPEG where PIL encodes, else uint8 arrays (TFS only);
    zstd where a codec exists.  Returns each format's directory and shard
    count."""
    import msgpack

    from tpuframe_torch.data import MDSWriter, ShardWriter
    from tpuframe_torch.data.streaming import CODECS

    jpeg = backends["resize"] == "pil"
    zstd = backends["codec"] != "none"
    first = synth_image(np.random.default_rng(seed), px)
    one = len(msgpack.packb({"image": CODECS["jpg" if jpeg else "ndarray"][0](first),
                             "label": 0}, use_bin_type=True))
    limit = max(1 << 16, one * n_images // STREAM_SHARDS)
    out = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    tfs = root / "remote" / "tfs"
    with ShardWriter(str(tfs), {"image": "jpg" if jpeg else "ndarray", "label": "int"},
                     shard_size_limit=limit, compression="zstd" if zstd else "none") as w:
        for i in range(n_images):
            w.write({"image": synth_image(rng, px), "label": i % 1000})
    out["tfs"] = {"dir": tfs, "shards": len(json.loads((tfs / "index.json").read_text())["shards"])}
    if jpeg:
        rng = np.random.default_rng(seed)
        mds = root / "remote" / "mds"
        with MDSWriter(str(mds), {"image": "jpeg", "label": "int"},
                       compression="zstd" if zstd else None, size_limit=limit) as w:
            for i in range(n_images):
                w.write({"image": synth_image(rng, px), "label": i % 1000})
        out["mds"] = {"dir": mds,
                      "shards": len(json.loads((mds / "index.json").read_text())["shards"])}
    out["write_s"] = time.perf_counter() - t0
    out["stored_mb"] = sum(f.stat().st_size for f in (root / "remote").rglob("*")
                           if f.is_file()) / 1e6
    out["shard_size_limit"] = limit
    return out


def stream_dataset(fmt: str, volumes: dict, root: Path, px: int):
    """The measured dataset: the remote volume streamed into a local cache
    of its own, ``uint8_image_transforms(px)`` with the fused decode at
    scale, every shard kept decoded once read (a shuffled epoch touches
    each shard over and over)."""
    from tpuframe_torch.data import MDSDataset, StreamingDataset, uint8_image_transforms

    vol = volumes[fmt]
    tf = uint8_image_transforms(px)
    cache = str(root / "cache" / fmt)
    if fmt == "mds":
        return MDSDataset(str(vol["dir"]), local_cache=cache, transform=tf,
                          keep_decoded_shards=vol["shards"], decode_min_hw=(px, px))
    return StreamingDataset(str(vol["dir"]), local_cache=cache, transform=tf,
                            decoded_cache_shards=vol["shards"], decode_min_hw=(px, px))


def producer_ceiling(ds, batch: int, workers: int, mode: str) -> float:
    """img/s of the loader against an instant consumer (each lease handed
    back the moment its batch lands), over one shuffled epoch after two
    warm-up batches (``bench_e2e.py --consumer null``)."""
    from tpuframe_torch.data import DataLoader

    loader = DataLoader(ds, batch, shuffle=True, seed=0, num_workers=workers, worker_mode=mode,
                        transfer_dtype="uint8", process_index=0, process_count=1)
    try:
        it = iter(loader)
        for _ in range(2):
            next(it)
            loader.release_oldest()
        n, t0 = 0, time.perf_counter()
        for _, labels in it:
            n += labels.shape[0]
            loader.release_oldest()
        return n / (time.perf_counter() - t0)
    finally:
        loader.close()


class _FedTimes:
    """Trainer callback: each step's start and each drained batch's end on
    the host clock (``log_interval=1`` syncs after every step), one
    ``SystemMetricsMonitor.sample()`` beside ``torch.cuda.memory_allocated``
    at step ``sample_at``, and optionally a ``torch.profiler`` window from
    the first drained step to step ``profile_to``."""

    def __init__(self, sample_at: int | None = None, profile_to: int | None = None):
        self.starts, self.ends, self.losses = [], [], []
        self.sample_at, self.sample = sample_at, None
        # a torch.profiler window over steps 2..profile_to (CUDA kernels only)
        self.profiler, self.profile_to, self.profile_marks = None, profile_to, []
        if profile_to is not None:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            self.profiler = torch_profile(activities=[ProfilerActivity.CUDA])

    def busy(self) -> dict:
        """The profiled window's wall and device time, and the card's busy
        share of it (kernel time over wall time)."""
        wall_ms = (self.profile_marks[1] - self.profile_marks[0]) * 1e3
        kernels = [e for e in self.profiler.key_averages() if str(e.device_type).endswith("CUDA")]
        device_ms = sum(dev_us(e) for e in kernels) / 1e3
        return {"steps": self.profile_to - 1, "wall_ms": wall_ms, "device_ms": device_ms,
                "launches": sum(e.count for e in kernels), "busy": device_ms / wall_ms}

    def on_fit_start(self, trainer): ...
    def on_epoch_start(self, trainer, epoch): ...
    def on_epoch_end(self, trainer, epoch, metrics): ...
    def on_eval_end(self, trainer, epoch, metrics): ...
    def on_fit_end(self, trainer): ...

    def on_step_start(self, trainer):
        self.starts.append(time.perf_counter())

    def on_step_end(self, trainer):
        if self.sample_at is not None and len(self.starts) == self.sample_at:
            from tpuframe_torch.track import SystemMetricsMonitor

            sample = SystemMetricsMonitor(interval_s=60.0).sample()
            self.sample = (sample, torch.cuda.memory_allocated() / 2**20
                           if torch.cuda.is_available() else 0.0)

    def on_batch_end(self, trainer, metrics):
        self.ends.append(time.perf_counter())
        self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))
        if self.profiler is not None and len(self.ends) in (1, self.profile_to):
            # the window: from the first drained step to the last (steps 2..N)
            if len(self.ends) == 1:
                self.profiler.start()
                self.profile_marks.append(time.perf_counter())
            else:
                self.profile_marks.append(time.perf_counter())
                self.profiler.stop()

    def window(self, batch: int) -> tuple[float, float]:
        """(img/s over steps 2..N, the share of that window the host waited
        in ``next(batch)``): from the end of the first drained step to the
        end of the last, each wait from a drained step to the next start."""
        span = self.ends[-1] - self.ends[0]
        waits = sum(s - e for s, e in zip(self.starts[1:], self.ends[:-1]))
        return batch * (len(self.ends) - 1) / span, waits / span


def fed_fit(ds, dev: torch.device, batch: int, steps: int, workers: int, mode: str,
            callback: _FedTimes):
    """``Trainer(ResNet50-1K, bf16, normalize=ImageNet)`` fed from ``ds``
    for ``steps`` batches (phase 5's step, SGD lr 0.1).  Returns (trainer,
    fit result, wall seconds)."""
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.train import Trainer

    loader = DataLoader(ds, batch, shuffle=True, seed=0, num_workers=workers, worker_mode=mode,
                        transfer_dtype="uint8")
    model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
    trainer = Trainer(model, train_dataloader=loader, optimizer="sgd", lr=0.1, precision="bf16",
                      normalize=(MEAN, STD), max_duration=f"{steps}ba", log_interval=1,
                      callbacks=[callback])
    trainer.init_state()
    try:
        sync(dev)
        t0 = time.perf_counter()
        result = trainer.fit()
        sync(dev)
        return trainer, result, time.perf_counter() - t0
    finally:
        loader.close()


def resident_rate(trainer, dev: torch.device, batch: int, px: int, steps: int) -> float:
    """img/s of the same train step on one device-resident uint8 batch:
    ``steps`` synced steps after 3 warm-up ones (phase 5's measure)."""
    rng = np.random.default_rng(3)
    b = {"image": torch.from_numpy(rng.integers(0, 256, (batch, px, px, 3),
                                                dtype=np.uint8)).to(dev),
         "label": torch.from_numpy(rng.integers(0, 1000, batch)).to(dev)}
    state, step = trainer.state, trainer._train_step
    for _ in range(3):
        state, _ = step(state, b)
    total = 0.0
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        state, _ = step(state, b)
        sync(dev)
        total += time.perf_counter() - t0
    return batch * steps / total


def streaming_phase(card: str, dev: torch.device = torch.device("cuda"), seed: int = 0,
                    n_images: int = STREAM_IMAGES, px: int = STREAM_PX,
                    batch: int = STREAM_BATCH, steps: int = STREAM_STEPS,
                    widest: int | None = None, examples: bool = True) -> tuple[dict, dict]:
    """Phase 14 (module docstring).  Returns (launch counts of the TFS fit,
    its numbers).  The device and sizes are arguments so the phase can be
    rehearsed small on the CPU (``examples=False`` there: the examples
    need the card)."""
    import shutil

    from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from tpuframe_torch.ops.normalize import normalize_images

    counters = {"normalize": normalize_images, "cross_entropy_fwd": cross_entropy_fwd,
                "cross_entropy_bwd": cross_entropy_bwd}
    out: dict = {"card": card}
    backends = stream_backends()
    log("  stream_backends " + json.dumps({k: backends[k] for k in ("decoder", "codec",
                                                                    "resize")}))
    for what in ("codec", "jpeg"):
        if backends[f"{what}_build_error"]:
            log(f"  the native {what} did not build here: "
                f"{backends[f'{what}_build_error'][:300]}")
    out.update({k: backends[k] for k in ("decoder", "codec", "resize")})
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    STREAM_DIR.mkdir(parents=True)
    try:
        # -- 1. the volumes ---------------------------------------------------
        volumes = write_stream_volumes(STREAM_DIR, n_images, px, seed, backends)
        shards = {f: volumes[f]["shards"] for f in ("tfs", "mds") if f in volumes}
        log(f"  wrote {n_images} synthetic {px} px images (seed {seed}, 1000 classes) as "
            f"{' and '.join(shards)} in {volumes['write_s']:.2f} s: shards {shards} at a "
            f"{volumes['shard_size_limit']} B limit, {volumes['stored_mb']:.2f} MB stored, "
            f"{'JPEG' if backends['resize'] == 'pil' else 'uint8 arrays'}, "
            f"{'zstd' if backends['codec'] != 'none' else 'no compression'} on {card}")
        check(all(n >= 8 for n in shards.values()), f"too few shards: {shards}")
        out["shards"], out["write_s"] = shards, volumes["write_s"]

        # -- 2. the producer ceiling ------------------------------------------
        widest = widest or min(16, os.cpu_count() or 1)
        ceiling = {}
        for workers, mode in ((1, "thread"), (4, "thread"), (widest, "thread"),
                              (widest, "process")):
            key = f"{mode}_{workers}"
            if key not in ceiling:
                ceiling[key] = producer_ceiling(stream_dataset("tfs", volumes, STREAM_DIR, px),
                                                batch, workers, mode)
        log(f"  producer ceiling (TFS, uint8, batch {batch}, instant consumer, "
            f"{os.cpu_count()} host cores), img/s: "
            + ", ".join(f"{k} {v:.1f}" for k, v in ceiling.items()) + f" on {card}")
        out["producer_ceiling"] = ceiling
        mode = "process" if ceiling[f"process_{widest}"] > ceiling[f"thread_{widest}"] \
            else "thread"
        out["fit_workers"] = f"{mode}_{widest}"

        # -- 3. the data-fed fits, the device-resident step in turns ----------
        fits = {}
        resident = []
        for fmt in [f for f in ("tfs", "mds") if f in volumes]:
            times = _FedTimes(sample_at=steps // 2 if dev.type == "cuda" else None)
            for c in counters.values():
                c.launches = 0
            trainer, result, fit_s = fed_fit(stream_dataset(fmt, volumes, STREAM_DIR, px), dev,
                                             batch, steps, widest, mode, times)
            counts = {n: c.launches for n, c in counters.items()}
            want = {"normalize": steps, "cross_entropy_fwd": steps, "cross_entropy_bwd": steps}
            fed, wait = times.window(batch)
            losses = [float(v) for v in times.losses]
            summary = result.history[-1]
            log(f"  data-fed fit from {fmt.upper()} ({mode} workers {widest}): {steps} steps of "
                f"{batch} in {fit_s:.2f} s, {fed:.1f} img/s over steps 2..{steps}, host waited "
                f"in next(batch) {wait:.1%} of that window; launches {counts} (expected {want}); "
                f"losses {[round(v, 4) for v in losses]}; data_wait_s "
                f"{summary['data_wait_s']:.3f}, assemble_s {summary['assemble_s']:.3f}, "
                f"h2d_s {summary['h2d_s']:.3f} on {card}")
            check(counts == want, f"{fmt} fit launches {counts} != {want}")
            check(len(losses) == steps and all(math.isfinite(v) for v in losses),
                  f"{fmt} fit losses {losses}")
            check(abs(losses[0] - math.log(1000)) <= 1.0,
                  f"{fmt} fit first loss {losses[0]:.4f} not within 1.0 of ln 1000")
            if times.sample is not None:
                sample, alloc_mb = times.sample
                used = sample.get("system/device0_mem_used_mb", 0.0)
                log(f"  SystemMetricsMonitor.sample() at step {steps // 2}: device0_mem_used_mb "
                    f"{used:.1f}, torch.cuda.memory_allocated {alloc_mb:.1f} MB, "
                    f"device0_mem_util {sample.get('system/device0_mem_util', 0.0):.4f} on {card}")
                check(used > 0 and abs(used - alloc_mb) <= 0.01 * alloc_mb,
                      f"system metrics device0_mem_used_mb {used} vs allocated {alloc_mb}")
                out.setdefault("system_metrics", {"device0_mem_used_mb": used,
                                                  "memory_allocated_mb": alloc_mb})
            resident.append(resident_rate(trainer, dev, batch, px, STREAM_RESIDENT_STEPS))
            log(f"  device-resident step (the same trainer, {STREAM_RESIDENT_STEPS} synced "
                f"steps): {resident[-1]:.1f} img/s on {card}")
            fits[fmt] = {"fed_img_s": fed, "host_input_wait_frac": wait, "first_loss": losses[0],
                         "launches": counts, "fit_s": fit_s, "data_wait_s":
                         summary["data_wait_s"], "resident_img_s": resident[-1]}
            del trainer
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        # the same TFS fit with half the workers: do the loader's processes
        # crowd out the training loop's host thread?
        half = max(1, widest // 2)
        times = _FedTimes()
        trainer, _, _ = fed_fit(stream_dataset("tfs", volumes, STREAM_DIR, px), dev, batch,
                                steps, half, mode, times)
        fed, wait = times.window(batch)
        log(f"  data-fed fit from TFS with {mode} workers {half} (half): {fed:.1f} img/s over "
            f"steps 2..{steps}, host waited in next(batch) {wait:.1%} of that window on {card}")
        out["fed_half_workers"] = {"workers": f"{mode}_{half}", "fed_img_s": fed,
                                   "host_input_wait_frac": wait}
        # the same fit loop over decoded uint8 arrays in host memory (no
        # workers: a fetch is an index): what the Trainer's loop costs
        # beside the step alone, with no decode behind it
        from tpuframe_torch.data import ArrayDataset

        rng = np.random.default_rng(seed)
        arrays = ArrayDataset(rng.integers(0, 256, (batch * steps, px, px, 3), dtype=np.uint8),
                              rng.integers(0, 1000, batch * steps))
        times = _FedTimes()
        trainer, _, _ = fed_fit(arrays, dev, batch, steps, 0, "thread", times)
        loop, wait = times.window(batch)
        log(f"  the same fit over uint8 arrays in host memory (no workers): {loop:.1f} img/s over "
            f"steps 2..{steps}, host waited in next(batch) {wait:.1%} of that window on {card}")
        out["in_memory_fit"] = {"img_s": loop, "host_input_wait_frac": wait}
        del trainer, arrays
        synthetic = statistics.mean(resident)
        for fmt, f in fits.items():
            f["input_stall_pct"] = 100 * (1 - f["fed_img_s"] / synthetic)
        out["fits"], out["synthetic_img_s"] = fits, synthetic
        log(f"  input stall (1 - fed / device-resident {synthetic:.1f} img/s): "
            + ", ".join(f"{k} {v['input_stall_pct']:.1f} %" for k, v in fits.items())
            + f" on {card}")

        # -- 4. the card's busy share over one data-fed window ----------------
        if dev.type == "cuda":
            times = _FedTimes(profile_to=STREAM_PROFILED_STEPS)
            trainer, _, _ = fed_fit(stream_dataset("tfs", volumes, STREAM_DIR, px), dev, batch,
                                    STREAM_PROFILED_STEPS, widest, mode, times)
            prof = times.busy()
            log(f"  profile, steps 2..{STREAM_PROFILED_STEPS} of a data-fed fit: wall "
                f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms over "
                f"{prof['launches']} kernel launches (device busy {prof['busy']:.1%} of wall; "
                f"{times.window(batch)[0]:.1f} img/s) on {card}")
            out["profile"] = prof
            del trainer
            torch.cuda.empty_cache()

        # -- 5. example 01a through the Distributor, example 07 in process ----
        if examples:
            out.update(streaming_examples(card))
    finally:
        shutil.rmtree(STREAM_DIR, ignore_errors=True)
    log("  stream_json " + json.dumps(out, default=str))
    return fits["tfs"]["launches"], out


def streaming_examples(card: str) -> dict:
    """Phase 14's examples on the card: 01a through its own ``main`` (the
    Distributor, one worker) with the worker's K1/K2a/K2b launches
    counted, and 07 at ``--tp 1`` cut to 3 steps, in this process."""
    from tpuframe_torch.core.runtime import reset_runtime
    from tpuframe_torch.launch import Distributor
    from tpuframe_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd

    out = {}
    ex = _example("01a_distributor_tiny_imagenet_streaming")
    worker_counts = []

    class CountedDistributor(Distributor):
        """The example's Distributor, its worker fn counted in the worker."""

        def run(self, fn, *args):
            value, counts = super().run(counted_call, _k12, ex.__name__.rsplit(".", 1)[1],
                                        fn.__name__, *args)
            worker_counts.append(counts)
            return value

    workdir = STREAM_DIR / "ex01a"
    argv = ["--num-processes", "1", "--workdir", str(workdir)]
    t0 = time.perf_counter()
    with mock.patch.object(ex, "Distributor", functools.partial(CountedDistributor,
                                                                timeout_s=300)):
        summary = ex.main(argv)
    spawn_s = time.perf_counter() - t0
    a = EX01A_ARGS
    n_train = a["epochs"] * (a["train_samples"] // a["batch_size"])
    n_eval = a["epochs"] * -(-a["eval_samples"] // a["batch_size"])
    want = {"normalize": 0, "cross_entropy_fwd": n_train + n_eval, "cross_entropy_bwd": n_train}
    counts = worker_counts[0]
    log(f"  example 01a through its main (Distributor, 1 worker on the card, 64 px, 200 "
        f"classes, ResNet50, bf16, shards written and streamed): {spawn_s:.2f} s from its "
        f"start to the result, launches {counts} (expected {want}); {summary} on {card}")
    check(counts == want, f"example 01a's worker launches {counts} != {want}")
    check(len(summary["spot_preds"]) == 5 and all(0 <= p < 200 for p in summary["spot_preds"])
          and math.isfinite(summary["train_loss"]), f"example 01a's result {summary}")
    out["ex01a_s"] = spawn_s

    ex7 = _example("07_vit_classifier")
    counters = {**_k12(), "layer_norm_fwd": layer_norm_fwd, "layer_norm_bwd": layer_norm_bwd}
    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        metrics = ex7.main(EX07_ARGV + ["--workdir", str(STREAM_DIR / "ex07")])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    counts = {n: c.launches for n, c in counters.items()}
    # 4 layers: 9 LayerNorms a forward; 3 train steps and 2 eval batches; the
    # soft labels of LabelSmoothing and MixUp take the plain soft cross
    # entropy, so only the eval runs K2a; the images are float: no K1
    want = {"normalize": 0, "cross_entropy_fwd": 2, "cross_entropy_bwd": 0,
            "layer_norm_fwd": 9 * 5, "layer_norm_bwd": 9 * 3}
    log(f"  example 07 (--tp 1, 3 steps of 64 + eval) in process: {took:.2f} s, launches "
        f"{counts} (expected {want}); {buf.getvalue().strip().splitlines()[-1]} on {card}")
    check(counts == want, f"example 07's launches {counts} != {want}")
    check(math.isfinite(metrics["train_loss"]), f"example 07's metrics {metrics}")
    out["ex07_s"] = took
    reset_runtime()
    return out

# -- phase 16: ZeRO on one card ---------------------------------------------------

#: (name, stage, offload, wire) of the ResNet50-1K fits; zero_0 is the reference
ZERO_RUNS = (("zero_0", 0, False, None), ("zero_1", 1, False, None), ("zero_2", 2, False, None),
             ("zero_3", 3, False, None), ("zero_3_offload", 3, True, None),
             ("zero_2_int8", 2, False, "int8"))
ZERO_STEPS = 3  # the fit's batches, each 64 images a rank
ZERO_TIMED = 3  # steps of the step alone a turn, after one warm step
ZERO_CLIP = 0.3  # example 02a's gradient_clipping
ZERO_LR = dict(warmup_max_lr=1e-3, warmup_num_steps=10)
#: the clip's norm sums the owned slices' squares across the ranks, in
#: another order than one rank's sum over whole tensors, so the clip's scale
#: may differ in its last bits: stages 1-3 are held to zero_0 within this
#: share of zero_0's update (max |diff| / max |update|); unclipped, the
#: CPU tests hold them bit-equal
ZERO_UPDATE_RTOL = 1e-3
#: the memory check: GPT-2-small's width (repo LM config), 2 x 128 tokens a rank
ZERO_LM = dict(LM, max_len=128)
ZERO_LM_BATCH = 2
ZERO_MEM_RTOL = 0.05  # persistent bytes against plan_memory's params + opt_state
#: the bytes of the tensors a rank holds against the same estimate: every
#: parameter and optimizer slot priced; what is left are a few scalars
#: (counts, the health state) and the batch of token ids
ZERO_REACH_MB = 0.1
ZERO_PEAK_TOL = 0.15  # the JAX estimator's tolerance against compiled peaks (logged)


def _zero_counters():
    """K1, K2a/K2b, K4 and K5a-K5c."""
    from tpuframe_torch.ops.fused_adamw import fused_adamw_multi_update_
    from tpuframe_torch.ops.quant_wire import bucket_abs_max, quant_decode, quant_encode

    return {**_k12(), "fused_adamw": fused_adamw_multi_update_,
            "bucket_abs_max": bucket_abs_max, "quant_encode": quant_encode,
            "quant_decode": quant_decode}


def _params_host(state) -> dict:
    """The model's parameters as float32 host copies (gathered under stage
    3; every rank calls this)."""
    return {k: v.detach().float().cpu().clone() for k, v in state.state_dict()["model"].items()
            if v.is_floating_point()}


def _digest(params: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].numpy().tobytes())
    return h.hexdigest()


def _reachable_cuda_mb(by_dtype: bool = False) -> float | dict:
    """The bytes of every CUDA tensor Python can reach (each storage once),
    in MiB: what a state holds, apart from blocks no tensor owns (library
    workspaces, block rounding); ``by_dtype``: split by the dtype of the
    first tensor seen on each storage."""
    import gc

    seen: dict[int, tuple[int, str]] = {}
    for obj in gc.get_objects():
        if torch.is_tensor(obj) and obj.is_cuda:
            st = obj.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes(), str(obj.dtype).removeprefix("torch.")))
    if not by_dtype:
        return sum(n for n, _ in seen.values()) / 2**20
    out: dict[str, float] = {}
    for n, dt in seen.values():
        out[dt] = round(out.get(dt, 0.0) + n / 2**20, 3)
    return out


def _zero_kernels_on_slices(state, dev: torch.device) -> dict:
    """K4 over the state's owned slices, and K5a-K5c on a (world, chunk)
    array of its largest sliced leaf and on the owned (1, chunk) row, each
    against its plain version (launches here are not the main path's)."""
    from tpuframe_torch.ops.fused_adamw import (
        fused_adamw_multi_update_,
        fused_adamw_update_reference,
    )
    from tpuframe_torch.ops.quant_wire import (
        bucket_abs_max,
        bucket_abs_max_reference,
        quant_decode,
        quant_decode_reference,
        quant_encode,
        quant_encode_reference,
    )

    zero = state.zero
    gen = torch.Generator(device=dev).manual_seed(7)
    ps = [t.detach().clone() for t in zero.opt_params if t.dtype == torch.float32]
    gs = [torch.randn(p.shape, generator=gen, device=dev) * 1e-2 for p in ps]
    ms = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3 for p in ps]
    vs = [torch.rand(p.shape, generator=gen, device=dev) * 1e-5 for p in ps]
    # in each parameter's own layout (a whole conv weight is channels_last)
    gs, ms, vs = ([torch.empty_like(p).copy_(t) for p, t in zip(ps, ts)] for ts in (gs, ms, vs))
    count = torch.full((), 3, dtype=torch.int32, device=dev)
    hp = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    want = [fused_adamw_update_reference(p, g, m, v, count, **hp)
            for p, g, m, v in zip(ps, gs, ms, vs)]
    fused_adamw_multi_update_(ps, gs, ms, vs, [count] * len(ps), **hp)
    sync(dev)
    k4_err = max(float((a - b).abs().max()) for got, w in zip(zip(ps, ms, vs), want)
                 for a, b in zip(got, w))
    name = max(zero.opt, key=lambda n: zero.params[n].numel())
    sl = zero.opt[name]
    g = torch.randn(sl.shape, generator=gen, device=dev)
    rows = sl.chunks(g).contiguous()
    amax = bucket_abs_max(rows)
    q, deq = quant_encode(rows, amax, "int8")
    q_ref, deq_ref = quant_encode_reference(rows, amax, "int8")
    total = q[sl.index:sl.index + 1] * 2  # two ranks' equal payloads
    mean = quant_decode(total, amax[sl.index:sl.index + 1], "int8", 2)
    exact = (torch.equal(amax, bucket_abs_max_reference(rows)) and torch.equal(q, q_ref)
             and torch.equal(deq, deq_ref) and torch.equal(mean, quant_decode_reference(
                 total, amax[sl.index:sl.index + 1], "int8", 2)))
    return {"k4_owned_slices": len(ps), "k4_max_abs_err": k4_err,
            "k5_leaf": name, "k5_rows": list(rows.shape), "k5_bit_equal": exact}


def _zero_child(rank: int, world: int, store: str, out_dir: str, device: str,
                image_size: int, batch_size: int, lm_cfg: dict, lm_batch: int) -> None:
    """One of two gloo ranks on the one card (mesh fsdp 2): ResNet50-1K
    through ``Trainer(plan=...).fit`` under each of ``ZERO_RUNS`` (counted,
    deterministic cuDNN), each run's step alone and its memory, K4 and K5
    on the owned slices against their plain versions, then the LM memory
    check under stages 0-3; writes what it saw as JSON."""
    import gc
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {"runs": {}, "lm": {}}
    try:
        import warnings

        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.data import DataLoader, SyntheticImageDataset
        from tpuframe_torch.models import ResNet50, TransformerLM
        from tpuframe_torch.ops import fused_adamw
        from tpuframe_torch.parallel import ZeroConfig, plan_memory
        from tpuframe_torch.train import (
            Trainer,
            create_train_state,
            make_train_step,
            schedule_from_config,
        )

        warnings.simplefilter("ignore")  # the CPU rehearsal's offload downgrade
        rt = initialize({"data": 1, "fsdp": world}, device=device, backend="gloo")
        cuda = rt.device.type == "cuda"
        if not cuda:  # the CPU rehearsal: two ranks share the host's cores
            torch.set_num_threads(2)
        try:
            dev = rt.device
            schedule = schedule_from_config({"scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0, "warmup_type": "linear", **ZERO_LR}}})
            counters = _zero_counters()
            rng = np.random.default_rng(3 + rank)
            local = batch_size // world
            resident = {"image": torch.from_numpy(rng.integers(
                            0, 256, (local, image_size, image_size, 3), dtype=np.uint8)).to(dev),
                        "label": torch.from_numpy(rng.integers(0, 1000, local)).to(dev)}
            torch.backends.cudnn.deterministic = True
            init, kept = None, {}
            for name, stage, offload, wire in ZERO_RUNS:
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev) if cuda else 0
                model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
                if init is None:
                    init = {k: v.detach().float().cpu().clone()
                            for k, v in model.state_dict().items() if v.is_floating_point()}
                loader = DataLoader(SyntheticImageDataset(n=batch_size * ZERO_STEPS,
                                                          image_size=image_size,
                                                          num_classes=1000, seed=1),
                                    batch_size, shuffle=True, seed=0, transfer_dtype="uint8",
                                    num_workers=4 if cuda else 0)
                plan = ZeroConfig(stage=stage, offload_optimizer=offload).plan(rt.mesh)
                trainer = Trainer(model, train_dataloader=loader, precision="bf16",
                                  tx=fused_adamw(schedule, weight_decay=1e-4,
                                                 max_grad_norm=ZERO_CLIP),
                                  normalize=(MEAN, STD), max_duration=f"{ZERO_STEPS}ba",
                                  log_interval=1, plan=plan, grad_compression=wire)
                state = trainer.init_state()
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                result = trainer.fit()
                sync(dev)
                fit_s = time.perf_counter() - t0
                launches = {k: fn.launches for k, fn in counters.items()}
                params = _params_host(state)
                run = {"launches": launches, "fit_s": fit_s, "digest": _digest(params),
                       "loss": result.history[-1].get("train_loss"),
                       "sliced": len(state.zero.opt) if state.zero is not None else 0,
                       "resting": len(state.zero.rest) if state.zero is not None else 0,
                       "wire": trainer._train_step.wire}
                if name == "zero_0":
                    ref = params
                delta = max(float((params[k] - ref[k]).abs().max()) for k in ref)
                update = max(float((ref[k] - init[k]).abs().max()) for k in ref)
                run["update_rel"] = delta / update
                if offload and state.zero is not None:
                    copies = []
                    for _ in range(3):
                        sync(dev)
                        t0 = time.perf_counter()
                        with state.zero.offloaded(state.optimizer):
                            pass
                        copies.append((time.perf_counter() - t0) * 1e3)
                    run["offload_copy_ms"] = statistics.median(copies)
                    run["offload_mb"] = sum(
                        v.numel() * v.element_size() for st in state.optimizer.state.values()
                        for v in st.values() if torch.is_tensor(v) and v.is_pinned()) / 2**20
                    run["opt_kinds"] = sorted({
                        "pinned_host" if v.is_pinned() else "device"
                        for st in state.optimizer.state.values() for v in st.values()
                        if torch.is_tensor(v) and v.ndim > 0})
                if name == "zero_2" and cuda:
                    run["kernels"] = _zero_kernels_on_slices(state, dev)
                state.model.zero_grad(set_to_none=True)
                state.optimizer.zero_grad(set_to_none=True)
                gc.collect()
                if cuda:
                    sync(dev)
                    run["persistent_mb"] = (torch.cuda.memory_allocated(dev) - base) / 2**20
                    run["peak_mb"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
                out["runs"][name] = run
                kept[name] = trainer  # for the step alone, in turns below
                del state, model, loader, params
            # each run's step alone on a device-resident batch, in turns
            # (every run, then every run backwards): the better median
            for turn in (list(kept), list(kept)[::-1]):
                for name in turn:
                    trainer = kept[name]
                    trainer._train_step(trainer.state, resident)
                    times = []
                    for _ in range(ZERO_TIMED):
                        sync(dev)
                        t0 = time.perf_counter()
                        trainer._train_step(trainer.state, resident)
                        sync(dev)
                        times.append((time.perf_counter() - t0) * 1e3)
                    out["runs"][name].setdefault("step_ms_turns", []).append(
                        statistics.median(times))
            for name in kept:
                out["runs"][name]["step_ms"] = min(out["runs"][name]["step_ms_turns"])
            del kept, trainer
            torch.backends.cudnn.deterministic = False
            del resident

            # -- the memory check: GPT-2-small width under stages 0-3 ------------
            for stage in (0, 1, 2, 3):
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev) if cuda else 0
                model = TransformerLM(**lm_cfg, device=dev, seed=0)
                template = {n: p for n, p in model.named_parameters()}
                plan = ZeroConfig(stage=stage).plan(rt.mesh)
                est = plan_memory(plan, template, {"input": ((world * lm_batch,
                                                              lm_cfg["max_len"]), "int32")},
                                  optimizer="adamw")
                state = create_train_state(model, fused_adamw(3e-4), plan=plan)
                step = make_train_step(plan=plan)
                tok = torch.from_numpy(np.random.default_rng(rank).integers(
                    0, lm_cfg["vocab_size"], (lm_batch, lm_cfg["max_len"] + 1))).to(dev)
                for _ in range(2):
                    state, m = step(state, {"input": tok[:, :-1], "label": tok[:, 1:]})
                loss = float(m["loss_sum"] / m["count"])
                state.model.zero_grad(set_to_none=True)
                state.optimizer.zero_grad(set_to_none=True)
                gc.collect()
                rec = {"estimate": est["per_device_mb"], "loss": loss,
                       "n_params": sum(p.numel() for p in template.values())}
                if cuda:
                    sync(dev)
                    rec["persistent_mb"] = (torch.cuda.memory_allocated(dev) - base) / 2**20
                    rec["peak_mb"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
                    rec["reachable_mb"] = _reachable_cuda_mb()
                out["lm"][stage] = rec
                del state, step, model, template
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def zero_examples(card: str, workdir: Path, ex02_argv: list, ex02a_argv: list) -> dict:
    """Examples 02 and 02a through their own ``main`` (ZeroDistributor, two
    workers sharing the card over gloo), each worker's K1, K2 and K4
    launches counted."""
    out = {}
    for module, argv in (("02_deepspeed_zero_cifar_resnet", ex02_argv),
                         ("02a_deepspeed_zero_imagenet1k", ex02a_argv)):
        ex = _example(module)
        counts = []

        class CountedZeroDistributor(ex.ZeroDistributor):
            """The example's ZeroDistributor, its worker fn counted there."""

            def run(self, fn, *args, **kwargs):
                value, c = super().run(counted_call, _zero_counters, module, fn.__name__,
                                       *args, **kwargs)
                counts.append(c)
                return value

        t0 = time.perf_counter()
        buf = io.StringIO()
        with mock.patch.object(ex, "ZeroDistributor", functools.partial(
                CountedZeroDistributor, timeout_s=600)), contextlib.redirect_stdout(buf):
            result = ex.main(argv + ["--workdir", str(workdir / module)])
        took = time.perf_counter() - t0
        check(math.isfinite(result["train_loss"]) and math.isfinite(result["val_loss"]),
              f"example {module}: {result}")
        out[module] = {"result": result, "launches": counts[0], "s": took}
        log(f"  example {module.split('_')[0]} through its main (ZeroDistributor, 2 workers on "
            f"the card, gloo): {took:.2f} s from its start to the result, rank 0's launches "
            f"{counts[0]}; {result} on {card}")
    return out


EX02_ARGV = ["--zero-stage", "2", "--fsdp", "2", "--num-processes", "2", "--epochs", "1",
             "--batch-size", "64", "--train-samples", "128", "--eval-samples", "64"]
EX02A_ARGV = ["--zero-stage", "3", "--offload", "--fsdp", "2", "--num-processes", "2",
              "--epochs", "1", "--batch-size", "32", "--train-samples", "64",
              "--eval-samples", "32", "--grad-accum", "2"]


def zero_phase(card: str, timeout_s: float = 900.0, device: str = "cuda:0",
               image_size: int = 224, batch_size: int = TRAIN_BATCH, lm_cfg: dict = ZERO_LM,
               lm_batch: int = ZERO_LM_BATCH, examples: bool = True) -> dict:
    """Two spawned gloo ranks on the one card (mesh fsdp 2): ResNet50-1K at
    224 px, 64 images a rank, bf16, AdamW (K4) with warmup and clip 0.3,
    through ``Trainer(plan=...).fit`` under ``zero_0``, ``zero_1``,
    ``zero_2``, ``zero_3``, ``zero_3_offload`` and ``zero_2`` with the int8
    wire, each fit counted: stages 1-3 (and offload) bit-equal to each other
    and within ``ZERO_UPDATE_RTOL`` of zero_0's update; K4 once a step a
    rank, K5a-K5c (1 + sliced leaves) times a step under the int8 wire; each
    run's step alone, its persistent and peak memory.  K4 and K5 on the
    owned slices against their plain versions.  The memory check on the
    GPT-2-small-width LM: each rank's persistent bytes within
    ``ZERO_MEM_RTOL`` of ``plan_memory``'s params + opt_state for stages
    0-3, the peak logged beside its total.  Then examples 02 and 02a
    through ZeroDistributor.  Returns the counts and a summary; the device
    and sizes are arguments so the phase can be rehearsed small on the
    CPU."""
    t_start = time.perf_counter()
    res = _spawn(_zero_child, 2, (device, image_size, batch_size, lm_cfg, lm_batch),
                 timeout_s, "ZeRO phase")
    cuda = device.startswith("cuda")
    runs = {name: [o["runs"][name] for o in res] for name, _, _, _ in ZERO_RUNS}
    for name, stage, offload, wire in ZERO_RUNS:
        r0 = runs[name][0]
        sliced = r0["sliced"]
        per_step = (1 + sliced) if wire else 0
        want = {"normalize": ZERO_STEPS, "cross_entropy_fwd": ZERO_STEPS,
                "cross_entropy_bwd": ZERO_STEPS, "fused_adamw": ZERO_STEPS,
                "bucket_abs_max": per_step * ZERO_STEPS, "quant_encode": per_step * ZERO_STEPS,
                "quant_decode": per_step * ZERO_STEPS}
        for r, run in enumerate(runs[name]):
            check(run["launches"] == want or not cuda,
                  f"{name} rank {r}: launches {run['launches']} != {want}")
            check(run["loss"] is not None and math.isfinite(run["loss"]),
                  f"{name} rank {r}: loss {run['loss']}")
        check(runs[name][0]["digest"] == runs[name][1]["digest"],
              f"{name}: the two ranks ended the fit apart")
        check(stage == 0 or sliced > 0, f"{name}: no leaf was sliced")
        if not wire:
            check(r0["update_rel"] <= ZERO_UPDATE_RTOL,
                  f"{name}: {r0['update_rel']:.3g} of zero_0's update from it (tol "
                  f"{ZERO_UPDATE_RTOL})")
        mem = (f", persistent {[round(x['persistent_mb'], 1) for x in runs[name]]} MB, peak "
               f"{[round(x['peak_mb'], 1) for x in runs[name]]} MB a rank" if cuda else "")
        extra = (f", offload copies {r0['offload_copy_ms']:.2f} ms a step (the "
                 f"{r0.get('offload_mb', 0):.1f} MB of pinned state to the card and back), "
                 f"optimizer state in {r0['opt_kinds']}" if "offload_copy_ms" in r0 else "")
        log(f"  {name}: {ZERO_STEPS} steps of {batch_size} on two ranks, {sliced} sliced leaves"
            f"{', ' + str(r0['resting']) + ' resting as shards' if r0['resting'] else ''}, "
            f"launches a rank {r0['launches']} (expected {want}), "
            f"{r0['update_rel']:.3g} of zero_0's update from it, ranks bit-equal, step alone "
            f"{max(x['step_ms'] for x in runs[name]):.1f} ms (the better of two medians of "
            f"{ZERO_TIMED} in turns, slower rank){mem}{extra} on {card}")
    ladder = [runs[n][0]["digest"] for n in ("zero_1", "zero_2", "zero_3", "zero_3_offload")]
    check(len(set(ladder)) == 1, "stages 1-3 and offload ended the fit apart")
    if cuda:
        check(runs["zero_3_offload"][0]["opt_kinds"] == ["pinned_host"],
              f"offload's optimizer state in {runs['zero_3_offload'][0]['opt_kinds']}")
        kern = runs["zero_2"][0]["kernels"]
        check(kern["k4_max_abs_err"] <= 1e-6 and kern["k5_bit_equal"],
              f"the kernels on the owned slices: {kern}")
        log(f"  K4 over the {kern['k4_owned_slices']} owned slices and whole leaves of zero_2: "
            f"max abs diff {kern['k4_max_abs_err']:.3g} from the plain version (tol 1e-6); "
            f"K5a-K5c on {kern['k5_leaf']} as {kern['k5_rows']} rows and its owned (1, chunk) "
            f"row bit-equal to the plain versions: {kern['k5_bit_equal']}")
    log(f"  stages 1-3 and offload bit-equal to each other; each within {ZERO_UPDATE_RTOL} of "
        "zero_0's update (the clip's plan-global norm sums in another order)")
    lm = {int(k): [o["lm"][k] for o in res] for k in res[0]["lm"]}
    for stage, recs in lm.items():
        est = recs[0]["estimate"]
        want_mb = est["params"] + est["opt_state"] + est["ef_residual"]
        line = (f"  LM memory, stage {stage} ({recs[0]['n_params']} parameters, 2 x "
                f"{lm_cfg['max_len']} tokens a rank): plan_memory params {est['params']} + "
                f"opt_state {est['opt_state']} MB = {want_mb:.1f} MB, total {est['total']} MB")
        if cuda:
            for r, rec in enumerate(recs):
                rel = rec["persistent_mb"] / want_mb - 1.0
                check(abs(rel) <= ZERO_MEM_RTOL,
                      f"LM stage {stage} rank {r}: persistent {rec['persistent_mb']:.1f} MB is "
                      f"{rel:+.2%} from plan_memory's {want_mb:.1f} MB (tol {ZERO_MEM_RTOL})")
                check(abs(rec["reachable_mb"] - want_mb) <= ZERO_REACH_MB,
                      f"LM stage {stage} rank {r}: the tensors held {rec['reachable_mb']:.3f} MB, "
                      f"plan_memory prices {want_mb:.3f} (tol {ZERO_REACH_MB} MB)")
            line += (f"; tensors held {[round(x['reachable_mb'], 3) for x in recs]} MB (tol "
                     f"{ZERO_REACH_MB}), allocated beside them "
                     f"{[round(x['persistent_mb'] - x['reachable_mb'], 1) for x in recs]} MB "
                     f"(blocks no tensor owns)")
            line += (f"; persistent {[round(x['persistent_mb'], 1) for x in recs]} MB "
                     f"({[f'{x['persistent_mb'] / want_mb - 1:+.2%}' for x in recs]}), peak "
                     f"{[round(x['peak_mb'], 1) for x in recs]} MB "
                     f"({[f'{x['peak_mb'] / est['total'] - 1:+.1%}' for x in recs]} of the "
                     f"total; JAX holds {ZERO_PEAK_TOL:.0%} against compiled peaks)")
        log(line + f", loss {recs[0]['loss']:.4f} on {card}")
    out = {"launches": {name: runs[name][0]["launches"] for name in runs},
           "step_ms": {name: max(x["step_ms"] for x in runs[name]) for name in runs},
           "update_rel": {name: runs[name][0]["update_rel"] for name in runs},
           "memory_mb": {name: [(x.get("persistent_mb"), x.get("peak_mb")) for x in runs[name]]
                         for name in runs},
           "offload_copy_ms": runs["zero_3_offload"][0].get("offload_copy_ms"),
           "offload_mb": runs["zero_3_offload"][0].get("offload_mb"),
           "lm": {k: {"estimate": v[0]["estimate"],
                      "persistent_mb": [x.get("persistent_mb") for x in v],
                      "reachable_mb": [x.get("reachable_mb") for x in v],
                      "peak_mb": [x.get("peak_mb") for x in v]} for k, v in lm.items()},
           "card": card}
    if examples:
        out["examples"] = zero_examples(card, LAUNCH_DIR.parent / "zero_smoke", EX02_ARGV,
                                        EX02A_ARGV)
    out["seconds"] = time.perf_counter() - t_start
    log("  zero_json " + json.dumps(out))
    return out


# -- phase 17: tensor and pipeline parallelism on one card ---------------------------

TP_BATCH = 8  # sequences a step, the same on every rank (data axis 1)
TP_STEPS = 3  # timed bf16 steps of the TP LM
TP_MICRO = 4  # the pipeline's microbatches
#: f32 against one process's unsharded run of the same weights and batch:
#: the split products and the cotangents' all-reduces sum in another order,
#: so the loss holds 1e-5 relative and the update (AdamW, eps 1e-3, as the
#: LM phase's f32 checks) 1e-3 of its largest element
TP_LOSS_RTOL = 1e-5
TP_UPDATE_RTOL = 1e-3
TP_DIR = Path(__file__).resolve().parent / "build" / "tpuframe_torch" / "tp_smoke"
EX07_TP2_ARGV = ["--tp", "2", "--epochs", "1", "--batch-size", "32", "--train-samples", "96",
             "--eval-samples", "32"]
EX07_LAYERS = 4  # example 07's default --layers


def _tp_counters():
    """K2a/K2b, K3a/K3b and K4, the kernels of the TP and pipeline paths."""
    from tpuframe_torch.ops.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from tpuframe_torch.ops.fused_adamw import fused_adamw_multi_update_
    from tpuframe_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd

    return {"cross_entropy_fwd": cross_entropy_fwd, "cross_entropy_bwd": cross_entropy_bwd,
            "layer_norm_fwd": layer_norm_fwd, "layer_norm_bwd": layer_norm_bwd,
            "fused_adamw": fused_adamw_multi_update_}


def _tp_batch(cfg: dict, dev: torch.device) -> dict:
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg["vocab_size"], (TP_BATCH, cfg["max_len"] + 1))).to(dev)
    return {"input": toks[:, :-1].contiguous(), "label": toks[:, 1:].contiguous()}


def flax_template(model) -> dict:
    """``{flax path: (flax-layout shape, dtype name)}`` of a port model's
    parameters: what ``plan_memory`` prices under the plan's rules."""
    from tpuframe_torch.parallel.tensor import _orders, flax_path

    orders = _orders(model)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in orders:
            shape = tuple(shape[d] for d in orders[name])
        out[flax_path(model, name)] = (shape, str(p.dtype).removeprefix("torch."))
    return out


def _whole_digest(state) -> tuple[str, int]:
    """A digest of the state as a checkpoint holds it (every tensor whole;
    every rank calls this) and the count of its tensors."""
    import hashlib

    h, n = hashlib.sha256(), 0

    def walk(tree, prefix):
        nonlocal n
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif torch.is_tensor(v):
                h.update(f"{prefix}{k}".encode())
                h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()
                         .tobytes())
                n += 1

    walk(state.state_dict(), "")
    return h.hexdigest(), n


def _mark(tele) -> str:
    """A marker event; :func:`_since` returns what came after it (the
    telemetry keeps a bounded window of recent events, so a count taken
    before would not do)."""
    token = f"smoke-mark-{time.monotonic_ns()}"
    tele.event("smoke/mark", token=token)
    return token


def _since(tele, token: str, name: str | None = None) -> list[dict]:
    events = tele.recent_events(10**6)
    at = max(i for i, e in enumerate(events)
             if e.get("name") == "smoke/mark" and e.get("token") == token)
    return [e for e in events[at + 1:] if name is None or e.get("name") == name]


def _memory(dev: torch.device, base: int) -> dict:
    if dev.type != "cuda":
        return {}
    sync(dev)
    return {"persistent_mb": (torch.cuda.memory_allocated(dev) - base) / 2**20,
            "peak_mb": (torch.cuda.max_memory_allocated(dev) - base) / 2**20}


def _tp_lm_child(rank: int, world: int, store: str, out_dir: str, device: str, cfg: dict,
                 steps: int, ref_path: str) -> None:
    """(a) One of two gloo ranks on the one card (mesh model 2):
    ``TransformerLM`` under ``transformer_tp_rules``.  One f32 step; on rank
    0 one process's unsharded f32 step of the same weights and batch (its
    parameters after the step saved at ``ref_path`` for (b)); the
    vocab-parallel loss (K2a/K2b) on the card against its plain version on
    CPU copies of the same shard; then ``steps`` bf16 steps timed and
    counted; writes what it saw as JSON."""
    import gc
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.models import TransformerLM, transformer_tp_rules
        from tpuframe_torch.ops import fused_adamw
        from tpuframe_torch.parallel import (
            ParallelPlan,
            align_model_dtype,
            bf16_compute,
            full_precision,
            plan_memory,
        )
        from tpuframe_torch.parallel.tensor import full_tensor, vocab_parallel_cross_entropy
        from tpuframe_torch.train import create_train_state, make_train_step

        rt = initialize({"data": 1, "model": world}, device=device, backend="gloo")
        dev, cuda = rt.device, rt.device.type == "cuda"
        if not cuda:
            torch.set_num_threads(2)
        try:
            batch = _tp_batch(cfg, dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev) if cuda else 0
            model = TransformerLM(**cfg, attn_impl="full", device=dev, seed=0)
            init = {n: p.detach().clone() for n, p in model.named_parameters()} if rank == 0 \
                else None
            plan = ParallelPlan(mesh=rt.mesh, rules=transformer_tp_rules())
            est = plan_memory(plan, flax_template(model),
                              {"input": ((TP_BATCH, cfg["max_len"]), "int32")},
                              optimizer="adamw")
            state = create_train_state(model, fused_adamw(3e-4, **LM_STEP_ADAMW), plan=plan)
            out["local_shapes"] = {n: list(p.shape) for n, p in model.named_parameters()
                                   if n in ("embed.weight", "block0.attn.query.weight",
                                            "block0.mlp_out.weight", "lm_head.weight")}
            step32 = make_train_step(full_precision(), plan=plan)
            state, m = step32(state, batch)
            out["loss_f32"] = float(m["loss_sum"] / m["count"])
            whole = {n: full_tensor(p.data, model.tp_layout[n], model.tp_mesh)
                     if n in model.tp_layout else p.data
                     for n, p in model.named_parameters()}
            if rank == 0:  # one process's unsharded run of the same weights and batch
                ref = TransformerLM(**cfg, attn_impl="full", device=dev, seed=0)
                ref_state = create_train_state(ref, fused_adamw(3e-4, **LM_STEP_ADAMW))
                ref_state, rm = make_train_step(full_precision())(ref_state, batch)
                out["loss_ref"] = float(rm["loss_sum"] / rm["count"])
                gap = max(float((whole[n] - p.data).abs().max())
                          for n, p in ref.named_parameters())
                update = max(float((p.data - init[n]).abs().max())
                             for n, p in ref.named_parameters())
                out["update_gap"], out["update_max"] = gap, update
                torch.save({n: p.detach().cpu() for n, p in ref.named_parameters()}, ref_path)
                del ref, ref_state, init
            del whole
            gc.collect()
            # K2a/K2b on this rank's vocabulary shard at the step's shape,
            # against the plain version on CPU copies (gloo carries both)
            from tpuframe_torch.parallel.tensor import axis

            ax = axis("model", rt.mesh)
            gen = torch.Generator(device=dev).manual_seed(5 + rank)
            n_tok = TP_BATCH * cfg["max_len"]
            local = torch.randn((n_tok, cfg["vocab_size"] // world), generator=gen,
                                device=dev) * 3
            labels = batch["label"].reshape(-1)
            g = torch.rand(n_tok, generator=gen, device=dev)
            got = []
            for x in (local, local.cpu()):
                x = x.clone().requires_grad_(True)
                loss = vocab_parallel_cross_entropy(x, labels.to(x.device), ax)
                (loss * g.to(x.device)).sum().backward()
                got.append((loss.detach().cpu(), x.grad.cpu()))
            out["k2_shard"] = {"shape": [n_tok, cfg["vocab_size"] // world],
                               "loss_err": float((got[0][0] - got[1][0]).abs().max()),
                               "grad_err": float((got[0][1] - got[1][1]).abs().max())}
            del got, local
            # the bf16 steps, timed and counted
            align_model_dtype(model, bf16_compute())
            step16 = make_train_step(bf16_compute(), plan=plan)
            counters = _tp_counters()
            for c in counters.values():
                c.launches = 0
            times, losses = [], []
            for _ in range(steps):
                sync(dev)
                t0 = time.perf_counter()
                state, m = step16(state, batch)
                sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss_sum"] / m["count"]))
            out["launches"] = {n: c.launches for n, c in counters.items()}
            out["step_ms"], out["losses_bf16"] = times, losses
            state.model.zero_grad(set_to_none=True)
            out["estimate"] = est["per_device_mb"]
            gc.collect()
            out.update(_memory(dev, base))
            if cuda:
                out["reachable_mb"] = _reachable_cuda_mb()
                out["reachable_by_dtype"] = _reachable_cuda_mb(by_dtype=True)
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def _pp_update(model, cfg: dict, ref_path: str | None) -> dict:
    """The pipelined model's whole parameters after its first step (every
    rank calls this): their digest, and with ``ref_path`` the largest gap
    from one process's ``TransformerLM`` after its step (the same seed
    builds the same weights; the stacked ``blocks`` are its layers)."""
    import hashlib

    from tpuframe_torch.parallel.tensor import full_tensor

    layout, h, gap = model.tp_layout, hashlib.sha256(), None
    ref = torch.load(ref_path) if ref_path else None
    for name, p in model.named_parameters():
        whole = full_tensor(p.data, layout[name], model.tp_mesh) if name in layout else p.data
        h.update(whole.cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        if ref is not None:
            if name.startswith("blocks."):
                rest = name.removeprefix("blocks.")
                want = torch.stack([ref[f"block{i}.{rest}"] for i in range(cfg["num_layers"])])
            else:
                want = ref[name.removeprefix("embed_head.")]
            gap = max(gap or 0.0, float((whole - want.to(whole.device)).abs().max()))
        del whole
    return {"digest": h.hexdigest(), **({"update_gap": gap} if ref is not None else {})}


def _tp_pp_child(rank: int, world: int, store: str, out_dir: str, device: str, cfg: dict,
                 ck_dir: str, ref_path: str) -> None:
    """(b) and (c): one of four gloo ranks on the one card.
    ``PipelinedTransformerLM`` under ``compose(tp=2, pp=2)``, one f32 step
    under each schedule (its first loss, the digest of the whole
    parameters after it, time, launches and memory; under ``interleaved``
    on rank 0 the largest gap of those parameters from one process's
    update saved at ``ref_path`` by (a)), then the last state saved, its
    whole digest taken, and restored into ``compose(tp=4)`` on the same
    ranks; writes what it saw as JSON."""
    import gc
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {"schedules": {}}
    try:
        import torch.distributed as dist

        from tpuframe_torch.ckpt import Checkpointer
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.ops import fused_adamw
        from tpuframe_torch.parallel import (
            PP_SCHEDULES,
            PipelinedTransformerLM,
            compose,
            full_precision,
            plan_memory,
        )
        from tpuframe_torch.track.telemetry import get_telemetry
        from tpuframe_torch.train import create_train_state, make_train_step

        rt = initialize({"pipe": 2, "data": 1, "model": 2}, device=device, backend="gloo")
        dev, cuda = rt.device, rt.device.type == "cuda"
        if not cuda:
            torch.set_num_threads(2)
        try:
            batch = _tp_batch(cfg, dev)
            hop = dist.all_to_all_single
            calls = {"hop": 0}

            def counted_hop(*a, **kw):
                calls["hop"] += 1
                return hop(*a, **kw)

            dist.all_to_all_single = counted_hop
            for i, schedule in enumerate(PP_SCHEDULES):
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev) if cuda else 0
                plan = compose(tp=2, pp=2, schedule=schedule, microbatches=TP_MICRO)
                model = PipelinedTransformerLM(**cfg, n_microbatches=TP_MICRO,
                                               schedule=schedule, device=dev, seed=0)
                est = plan_memory(plan, flax_template(model),
                                  {"input": ((TP_BATCH, cfg["max_len"]), "int32")},
                                  optimizer="adamw")
                state = create_train_state(model, fused_adamw(3e-4, **LM_STEP_ADAMW),
                                           plan=plan)
                step = make_train_step(full_precision(), plan=plan)
                counters = _tp_counters()
                for c in counters.values():
                    c.launches = 0
                calls["hop"] = 0
                sync(dev)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                sync(dev)
                rec = {"step_ms": (time.perf_counter() - t0) * 1e3,
                       "loss": float(m["loss_sum"] / m["count"]),
                       "launches": {n: c.launches for n, c in counters.items()},
                       "hops": calls["hop"], "estimate": est["per_device_mb"],
                       "layers_here": int(model.blocks.ln1.scale.shape[0])}
                rec.update(_pp_update(model, cfg, ref_path if rank == 0 and i == 0 else None))
                # a second step, timed (the first warms the libraries)
                sync(dev)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                sync(dev)
                rec["step2_ms"] = (time.perf_counter() - t0) * 1e3
                state.model.zero_grad(set_to_none=True)
                gc.collect()
                rec.update(_memory(dev, base))
                if cuda:
                    rec["reachable_mb"] = _reachable_cuda_mb()
                out["schedules"][schedule] = rec
                if i < len(PP_SCHEDULES) - 1:  # the last state is saved in (c)
                    del state, model, step, m
                    gc.collect()
            dist.all_to_all_single = hop
            # (c) save under tp2 x pp2, restore into tp4 on the same ranks
            digest, n = _whole_digest(state)
            out["digest"], out["tensors"] = digest, n
            with Checkpointer(ck_dir) as ck:
                ck.save(state, step=2, plan=plan)
            out["saved_signature"] = plan.signature()
            del state, model
            gc.collect()
            plan4 = compose(tp=4)
            template = create_train_state(
                PipelinedTransformerLM(**cfg, n_microbatches=TP_MICRO, device=dev, seed=9),
                fused_adamw(3e-4, **LM_STEP_ADAMW), plan=plan4)
            tiny = {k: v[:, :16] for k, v in _tp_batch(cfg, dev).items()}
            template, _ = make_train_step(full_precision(), plan=plan4)(template, tiny)
            tele = get_telemetry()
            mark = _mark(tele)
            t0 = time.perf_counter()
            with Checkpointer(ck_dir) as ck:
                template, _ = ck.restore(template, plan=plan4)
            out["restore_tp4_s"] = time.perf_counter() - t0
            out["restore_tp4_events"] = _since(tele, mark, "fault/reshard")
            out["restore_tp4_digest"] = _whole_digest(template)[0]
            out["restore_tp4_layout"] = {k: v for k, v in template.model.tp_layout.items()
                                         if k.startswith("embed_head")}
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out, default=str))


def _restore_one_process(card: str, cfg: dict, dev: torch.device, ck_dir: str, want: str,
                         saved_signature: str) -> dict:
    """(c) in this process (world 1): the TP x PP checkpoint restored into
    one process's plan bit-exact with one ``fault/reshard`` event; a model
    of another vocabulary refused before any read."""
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.parallel import PipelinedTransformerLM, compose, full_precision
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import create_train_state, make_train_step

    plan1 = compose(devices=1)
    template = create_train_state(
        PipelinedTransformerLM(**cfg, n_microbatches=TP_MICRO, device=dev, seed=9),
        fused_adamw(3e-4, **LM_STEP_ADAMW), plan=plan1)
    tiny = {k: v[:, :16] for k, v in _tp_batch(cfg, dev).items()}
    template, _ = make_train_step(full_precision(), plan=plan1)(template, tiny)
    tele = get_telemetry()
    mark = _mark(tele)
    t0 = time.perf_counter()
    with Checkpointer(ck_dir) as ck:
        template, _ = ck.restore(template, plan=plan1)
    took = time.perf_counter() - t0
    events = _since(tele, mark, "fault/reshard")
    digest = _whole_digest(template)[0]
    check(digest == want, "the TP x PP checkpoint restored into one process is not bit-exact")
    check(len(events) == 1 and events[0]["from_plan"] == saved_signature
          and events[0]["to_plan"] == plan1.signature(),
          f"one-process restore: fault/reshard events {events}")
    del template
    other_vocab = cfg["vocab_size"] - cfg["vocab_size"] // 4
    other = PipelinedTransformerLM(**dict(cfg, vocab_size=other_vocab),
                                   n_microbatches=TP_MICRO, device=dev, seed=0)
    other_state = create_train_state(other, fused_adamw(3e-4), plan=plan1)
    mark = _mark(tele)
    refused = False
    try:
        with Checkpointer(ck_dir) as ck:
            ck.restore(other_state, plan=plan1)
    except ValueError as e:
        refused = "cannot reshard onto the target topology" in str(e)
    names = [e.get("name") for e in _since(tele, mark)]
    check(refused and "ckpt/restore" not in names and "fault/reshard" not in names,
          f"another vocabulary: refused {refused}, events {names}")
    del other, other_state
    log(f"  (c) the TP x PP state restored into one process's plan ({plan1.signature()}) in "
        f"{took:.2f} s: bit-exact, one fault/reshard event {events[0]['from_axes']} -> "
        f"{events[0]['to_axes']}; a model of vocabulary {other_vocab} refused "
        f"with ValueError before any read (no ckpt/restore span) on {card}")
    return {"restore_one_s": took}


def tp_examples(card: str, workdir: Path, argv: list) -> dict:
    """(d) Example 07 with ``--tp 2`` through its main (``Distributor``, two
    workers sharing the card over gloo), each worker's launches counted."""
    import tpuframe_torch.launch as launch

    module = "07_vit_classifier"
    counts = []

    class CountedDistributor(launch.Distributor):
        """The launcher, its worker fn counted there."""

        def run(self, fn, *args, **kwargs):
            value, c = super().run(counted_call, _tp_counters, module, fn.__name__, *args,
                                   **kwargs)
            counts.append(c)
            return value

    t0 = time.perf_counter()
    buf = io.StringIO()
    with mock.patch.object(launch, "Distributor", functools.partial(
            CountedDistributor, timeout_s=600)), contextlib.redirect_stdout(buf):
        metrics = _example(module).main(argv + ["--workdir", str(workdir)])
    took = time.perf_counter() - t0
    c = counts[0] if counts else {}
    check(math.isfinite(metrics["train_loss"]), f"example 07 --tp 2: {metrics}")
    # the ViT's LayerNorms (two a block, the final one) on each train and
    # eval batch; K2a on the eval batches (MixUp's soft labels take the
    # gathered logits in training); AdamW is torch's
    arg = {k: int(v) for k, v in zip(argv[::2], argv[1::2])}
    n_train = arg["--train-samples"] // arg["--batch-size"]
    n_eval = -(-arg["--eval-samples"] // arg["--batch-size"])
    norms = 2 * EX07_LAYERS + 1
    want = {"cross_entropy_fwd": n_eval, "cross_entropy_bwd": 0,
            "layer_norm_fwd": (n_train + n_eval) * norms, "layer_norm_bwd": n_train * norms,
            "fused_adamw": 0}
    check(c == want or not torch.cuda.is_available(),
          f"example 07 --tp 2: rank 0's launches {c} != {want}")
    log(f"  (d) example 07 --tp 2 through its main (Distributor, 2 workers on the card, gloo): "
        f"{took:.2f} s from its start to the result, rank 0's launches {c} (expected); train_loss "
        f"{metrics['train_loss']:.4f} on {card}")
    return {"launches": c, "s": took, "metrics": metrics}


def tp_phase(card: str, timeout_s: float = 600.0, device: str = "cuda:0", cfg: dict = LM,
             steps: int = TP_STEPS, examples: bool = True) -> dict:
    """Phase 17 on the one card.  (a) ``TransformerLM`` at ``cfg``'s width
    under ``transformer_tp_rules`` on two gloo ranks: its first f32 loss and
    update against one process's unsharded run, the vocab-parallel loss's
    K2a/K2b on a shard against the plain version, ``steps`` bf16 steps timed
    with each rank's K2a/K2b/K3a/K3b/K4 launches exact.  (b)
    ``PipelinedTransformerLM`` under ``compose(tp=2, pp=2)`` on four ranks,
    8 sequences in 4 microbatches, each schedule once: first losses
    bit-equal and held against (a)'s one-process loss, step time, hops,
    memory beside ``plan_memory``.  (c) Its state saved, restored into
    ``compose(tp=4)`` on the same ranks and into one process's plan here,
    bit-exact, one ``fault/reshard`` each; another vocabulary refused.  (d)
    Example 07 with ``--tp 2``.  Returns the launch counts and a summary;
    the device and sizes are arguments so the phase can be rehearsed small
    on the CPU."""
    t_start = time.perf_counter()
    cuda = device.startswith("cuda")
    layers = cfg["num_layers"]
    TP_DIR.mkdir(parents=True, exist_ok=True)
    ref_path = str(TP_DIR / "one_process.pt")
    res = _spawn(_tp_lm_child, 2, (device, cfg, steps, ref_path), timeout_s, "TP LM")
    r0 = res[0]
    check(abs(r0["loss_f32"] / r0["loss_ref"] - 1) <= TP_LOSS_RTOL,
          f"(a) TP f32 loss {r0['loss_f32']!r} vs one process's {r0['loss_ref']!r} (rtol "
          f"{TP_LOSS_RTOL})")
    rel = r0["update_gap"] / r0["update_max"]
    check(rel <= TP_UPDATE_RTOL, f"(a) the TP update is {rel:.3g} of the update's largest "
          f"element from one process's (tol {TP_UPDATE_RTOL})")
    want = {"cross_entropy_fwd": steps, "cross_entropy_bwd": steps,
            "layer_norm_fwd": (2 * layers + 1) * steps, "layer_norm_bwd": (2 * layers + 1) * steps,
            "fused_adamw": steps}
    for r, o in enumerate(res):
        check(o["launches"] == want or not cuda,
              f"(a) rank {r}: launches {o['launches']} != {want}")
        check(o["k2_shard"]["loss_err"] <= 1e-4 and o["k2_shard"]["grad_err"] <= 1e-6,
              f"(a) rank {r}: K2 on the shard against the plain version {o['k2_shard']}")
        check(all(math.isfinite(x) for x in o["losses_bf16"]), f"(a) rank {r}: {o['losses_bf16']}")
    check(res[0]["losses_bf16"] == res[1]["losses_bf16"], "(a) the two ranks' losses differ")
    mem = (f"; persistent {[round(o['persistent_mb'], 1) for o in res]} MB (tensors held "
           f"{[round(o['reachable_mb'], 1) for o in res]} MB, by dtype "
           f"{[o['reachable_by_dtype'] for o in res]}), peak "
           f"{[round(o['peak_mb'], 1) for o in res]} MB a rank beside plan_memory's params "
           f"{r0['estimate']['params']} + opt_state {r0['estimate']['opt_state']} MB, total "
           f"{r0['estimate']['total']} MB" if cuda else "")
    log(f"  (a) TransformerLM {cfg} under transformer_tp_rules, model=2 on two gloo ranks, "
        f"{TP_BATCH} x {cfg['max_len']} tokens: local shapes {r0['local_shapes']}; first f32 "
        f"loss {r0['loss_f32']!r} vs one process's {r0['loss_ref']!r} "
        f"({r0['loss_f32'] / r0['loss_ref'] - 1:+.3g}, tol {TP_LOSS_RTOL}), update gap "
        f"{r0['update_gap']:.3g} of largest element {r0['update_max']:.3g} ({rel:.3g}, tol "
        f"{TP_UPDATE_RTOL}); K2a/K2b on the {r0['k2_shard']['shape']} shard vs plain: loss "
        f"{r0['k2_shard']['loss_err']:.3g}, grad {r0['k2_shard']['grad_err']:.3g}; {steps} "
        f"bf16 steps {[[round(t, 1) for t in o['step_ms']] for o in res]} ms, losses "
        f"{[round(x, 4) for x in r0['losses_bf16']]}, launches a rank "
        f"{[o['launches'] for o in res]} (expected {want}){mem} on {card}")

    ck_dir = str(TP_DIR / "ck")
    shutil.rmtree(ck_dir, ignore_errors=True)
    res4 = _spawn(_tp_pp_child, 4, (device, cfg, ck_dir, ref_path), timeout_s, "TP x PP LM")
    firsts = {s: [o["schedules"][s]["loss"] for o in res4] for s in res4[0]["schedules"]}
    ref_loss = r0["loss_ref"]
    for s, losses in firsts.items():
        check(losses == firsts["interleaved"], f"(b) {s}: first losses {losses} are not "
              f"bit-equal to interleaved's {firsts['interleaved']}")
        digests = {o["schedules"][s]["digest"] for o in res4}
        check(digests == {res4[0]["schedules"]["interleaved"]["digest"]},
              f"(b) {s}: the whole parameters after the first step are not bit-equal to "
              "interleaved's on every rank")
    check(abs(firsts["interleaved"][0] / ref_loss - 1) <= TP_LOSS_RTOL,
          f"(b) first loss {firsts['interleaved'][0]!r} vs one process's {ref_loss!r}")
    pp_rel = res4[0]["schedules"]["interleaved"]["update_gap"] / r0["update_max"]
    check(pp_rel <= TP_UPDATE_RTOL, f"(b) the TP x PP update is {pp_rel:.3g} of the update's "
          f"largest element from one process's (tol {TP_UPDATE_RTOL})")
    per = 2 * (layers // 2) * TP_MICRO  # LayerNorms of a stage's layers over the microbatches
    for s in firsts:
        recs = [o["schedules"][s] for o in res4]
        check(all(o["hops"] > 0 for o in recs), f"(b) {s}: no hop went over all_to_all_single")
        want_pp = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
                   "layer_norm_fwd": per + 1 + (per if s == "1f1b" else 0),
                   "layer_norm_bwd": per + 1, "fused_adamw": 1}
        for r, o in enumerate(recs):
            check(o["launches"] == want_pp or not cuda,
                  f"(b) {s} rank {r}: launches {o['launches']} != {want_pp}")
        mem = (f", persistent {[round(o['persistent_mb'], 1) for o in recs]} MB (tensors "
               f"held {[round(o['reachable_mb'], 1) for o in recs]} MB), peak "
               f"{[round(o['peak_mb'], 1) for o in recs]} MB a rank beside plan_memory's params "
               f"{recs[0]['estimate']['params']} + opt_state {recs[0]['estimate']['opt_state']} "
               f"MB, total {recs[0]['estimate']['total']} MB" if cuda else "")
        upd = (f", the update {recs[0]['update_gap']:.3g} from one process's ({pp_rel:.3g} of "
               f"its largest element, tol {TP_UPDATE_RTOL})" if "update_gap" in recs[0] else "")
        log(f"  (b) PipelinedTransformerLM under compose(tp=2, pp=2), schedule {s}: first f32 "
            f"loss {recs[0]['loss']!r} ({recs[0]['loss'] / ref_loss - 1:+.3g} from one "
            f"process's){upd}, parameters after it bit-equal across schedules and ranks, "
            f"{recs[0]['layers_here']} layers a stage, step "
            f"{[round(o['step_ms'], 1) for o in recs]} ms then "
            f"{[round(o['step2_ms'], 1) for o in recs]} ms a rank, all_to_all_single hops a step "
            f"{[o['hops'] for o in recs]} (gloo carried them on {device} tensors), launches a rank "
            f"{[o['launches'] for o in recs]} (expected {want_pp}){mem} on {card}")
    for r, o in enumerate(res4):
        check(o["restore_tp4_digest"] == o["digest"],
              f"(c) rank {r}: the tp4 restore is not bit-exact")
        ev = o["restore_tp4_events"]
        check(len(ev) == 1 and ev[0]["from_plan"] == o["saved_signature"],
              f"(c) rank {r}: fault/reshard events {ev}")
    check(len({o["digest"] for o in res4}) == 1, "(b) the ranks' whole states differ")
    log(f"  (c) the TP x PP state ({res4[0]['tensors']} tensors, saved whole) restored into "
        f"compose(tp=4) on the same ranks in {[round(o['restore_tp4_s'], 2) for o in res4]} s: "
        f"bit-exact, one fault/reshard each, embed_head layout "
        f"{res4[0]['restore_tp4_layout']}")
    dev = torch.device(device)
    one = _restore_one_process(card, cfg, dev, ck_dir, res4[0]["digest"],
                               res4[0]["saved_signature"])
    shutil.rmtree(TP_DIR, ignore_errors=True)
    out = {"launches_tp": [o["launches"] for o in res],
           "launches_tp_pp": {s: [o["schedules"][s]["launches"] for o in res4] for s in firsts},
           "tp_step_ms": [o["step_ms"] for o in res],
           "tp_pp_step_ms": {s: [o["schedules"][s]["step2_ms"] for o in res4] for s in firsts},
           "loss_ref": ref_loss, "loss_tp": r0["loss_f32"], "loss_tp_pp": firsts["interleaved"][0],
           "update_rel_tp": rel, "update_rel_tp_pp": pp_rel,
           "reachable_tp": [o.get("reachable_mb") for o in res],
           "memory_tp": [(o.get("persistent_mb"), o.get("peak_mb")) for o in res],
           "memory_tp_pp": {s: [(o["schedules"][s].get("persistent_mb"),
                                 o["schedules"][s].get("peak_mb")) for o in res4] for s in firsts},
           "estimate_tp": r0["estimate"],
           "estimate_tp_pp": res4[0]["schedules"]["interleaved"]["estimate"],
           **one, "card": card}
    if examples:
        out["example07"] = tp_examples(card, LAUNCH_DIR.parent / "tp_smoke_ex07",
                                       EX07_TP2_ARGV)
    out["seconds"] = time.perf_counter() - t_start
    log("  tp_json " + json.dumps(out))
    return out


# -- phase 18: sequence parallelism and MoE on one card ------------------------------

SP_SEQ = 4  # the seq axis of (a) and (b): 2,048 of long_ctx's 8,192 positions a rank
SP_STEPS = 3  # timed bf16 steps of each path
SP_CHECK_LAYERS = 2  # depth of the f32 checks against one process
MOE_LM = dict(LM, moe_experts=8, moe_top_k=2)  # gpt_small's widths, 8 experts, top 2
MOE_BATCH = 8  # sequences a step over data 2 (4 a rank), each on both expert ranks
MOE_MESH = {"data": 2, "expert": 2}
MOE_DROP_CF = 0.25  # a capacity factor at which the routing drops tokens
MOE_CAPACITIES = (1.25, MOE_DROP_CF)  # MoEMLP's default, then the dropping one
#: f32 against one process's run of the same weights and batch (the ring and
#: Ulysses tiles and the token group's all-reduce sum in another order): the
#: loss 1e-5 relative, the update (AdamW, eps 1e-3) 1e-3 of its largest element
SP_LOSS_RTOL = 1e-5
SP_UPDATE_RTOL = 1e-3
SP_DIR = Path(__file__).resolve().parent / "build" / "tpuframe_torch" / "sp_smoke"
EX06_RUNS = (  # (name, argv) of example 06 through its workers on the card
    ("ulysses_seq2", ["--attn", "ulysses", "--seq-shards", "2"]),
    ("ring_seq2_moe2", ["--attn", "ring", "--seq-shards", "2", "--moe-experts", "2",
                        "--expert-shards", "1"]),
    ("full_moe2_expert2", ["--attn", "full", "--seq-shards", "1", "--moe-experts", "2",
                           "--expert-shards", "2"]),
)
EX06_ARGV = ["--epochs", "1", "--train-samples", "64", "--batch-size", "16"]
EX06_LAYERS = 2  # example 06's default --layers
K6_NAMES = ("blockwise_attention_fwd", "blockwise_attention_bwd_dq",
            "blockwise_attention_bwd_dkv")
K9_NAMES = ("moe_dispatch", "moe_combine", "moe_combine_backward")


def _sp_counters():
    """The kernels of the sequence-parallel and MoE paths: K2a/K2b, K3a/K3b,
    K4, K6a-K6c and K9a-K9c."""
    from tpuframe_torch.ops.blockwise_attention import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
    )
    from tpuframe_torch.ops.moe_gating import moe_combine, moe_combine_backward, moe_dispatch

    return {**_tp_counters(), "blockwise_attention_fwd": blockwise_attention_fwd,
            "blockwise_attention_bwd_dq": blockwise_attention_bwd_dq,
            "blockwise_attention_bwd_dkv": blockwise_attention_bwd_dkv,
            "moe_dispatch": moe_dispatch, "moe_combine": moe_combine,
            "moe_combine_backward": moe_combine_backward}


def _sp_batch(cfg: dict, batch: int, dev: torch.device, seed: int) -> dict:
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg["vocab_size"], (batch, cfg["max_len"] + 1))).to(dev)
    return {"input": toks[:, :-1].contiguous(), "label": toks[:, 1:].contiguous()}


def _set_capacity(model, factor: float) -> None:
    from tpuframe_torch.models import MoEMLP

    for m in model.modules():
        if isinstance(m, MoEMLP):
            m.capacity_factor = factor


def _one_process(cfg: dict, batch: dict, dev: torch.device, capacity: float | None = None,
                 **kw) -> dict:
    """One process's f32 step of ``TransformerLM(**cfg, seed=0, **kw)`` on the
    whole batch: its loss, the parameters before and after."""
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import create_train_state, make_train_step

    ref = TransformerLM(**cfg, device=dev, seed=0, **kw)
    if capacity is not None:
        _set_capacity(ref, capacity)
    init = {n: p.detach().clone() for n, p in ref.named_parameters()}
    state = create_train_state(ref, fused_adamw(3e-4, **LM_STEP_ADAMW))
    state, m = make_train_step(full_precision())(state, batch)
    after = {n: p.detach().clone() for n, p in ref.named_parameters()}
    return {"loss": float(m["loss_sum"] / m["count"]), "init": init, "after": after}


def _save_one_process(ref: dict, path: str) -> None:
    torch.save({"loss": ref["loss"],
                **{k: {n: t.cpu() for n, t in ref[k].items()} for k in ("init", "after")}}, path)


def _update_gap(whole: dict, ref: dict) -> tuple[float, float]:
    """(largest gap of the whole parameters after a step from one process's,
    the largest element of one process's update)."""
    gap = max(float((whole[n] - p.to(whole[n].device)).abs().max())
              for n, p in ref["after"].items())
    update = max(float((p - ref["init"][n]).abs().max()) for n, p in ref["after"].items())
    return gap, update


def _whole_params(model) -> dict:
    """Every parameter whole (each split one gathered; every rank calls
    this)."""
    from tpuframe_torch.parallel.tensor import full_tensor

    layout = getattr(model, "tp_layout", None) or {}
    return {n: full_tensor(p.data, layout[n], model.tp_mesh) if n in layout else p.data
            for n, p in model.named_parameters()}


def _sp_bf16_steps(model, plan, batch: dict, steps: int, dev: torch.device,
                   calls: dict) -> dict:
    """``steps`` bf16 steps of ``model``'s state under ``plan``: their times,
    losses, the kernels' launches and the all-to-alls, counted from 0, and
    the state (its gradients freed)."""
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.parallel import align_model_dtype, bf16_compute
    from tpuframe_torch.train import create_train_state, make_train_step

    state = create_train_state(model, fused_adamw(3e-4, **LM_STEP_ADAMW), plan=plan)
    align_model_dtype(model, bf16_compute())
    step = make_train_step(bf16_compute(), plan=plan)
    counters = _sp_counters()
    for c in counters.values():
        c.launches = 0
    calls["a2a"] = 0
    times, losses = [], []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss_sum"] / m["count"]))
    out = {"launches": {n: c.launches for n, c in counters.items()}, "a2a": calls["a2a"],
           "step_ms": times, "losses": losses}
    state.model.zero_grad(set_to_none=True)
    return out, state


def _counted_all_to_all(calls: dict):
    """``dist.all_to_all_single`` counted in ``calls["a2a"]`` (the ring's
    hops and Ulysses' re-shards)."""
    import torch.distributed as dist

    real = dist.all_to_all_single

    def counted(*a, **kw):
        calls["a2a"] += 1
        return real(*a, **kw)

    return mock.patch.object(dist, "all_to_all_single", counted)


def _sp_seq_child(rank: int, world: int, store: str, out_dir: str, device: str, cfg: dict,
                  batch_size: int, steps: int, ref_path: str) -> None:
    """(a) and (b): one of ``world`` gloo ranks on the one card (mesh seq =
    world).  For the ring, then Ulysses: one f32 step at ``SP_CHECK_LAYERS``
    layers (on rank 0 against one process's blockwise step of the same
    weights and batch, saved at ``ref_path``: a model under this runtime
    would see the seq split), then ``steps`` bf16 steps at ``cfg``'s depth,
    timed, with each kernel's launches and the all-to-alls counted; writes
    what it saw as JSON."""
    import gc
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.models import TransformerLM
        from tpuframe_torch.ops import fused_adamw
        from tpuframe_torch.parallel import ParallelPlan, full_precision
        from tpuframe_torch.train import create_train_state, make_train_step

        rt = initialize({"data": 1, "seq": world}, device=device, backend="gloo")
        dev, cuda = rt.device, rt.device.type == "cuda"
        if not cuda:
            torch.set_num_threads(2)
        calls = {"a2a": 0}
        try:
            batch = _sp_batch(cfg, batch_size, dev, seed=13)  # every rank: the same rows
            small = dict(cfg, num_layers=SP_CHECK_LAYERS)
            ref = torch.load(ref_path) if rank == 0 else None
            with _counted_all_to_all(calls):
                for impl in ("ring", "ulysses"):
                    plan = ParallelPlan(mesh=rt.mesh)
                    model = TransformerLM(**small, attn_impl=impl, device=dev, seed=0)
                    state = create_train_state(model, fused_adamw(3e-4, **LM_STEP_ADAMW),
                                               plan=plan)
                    state, m = make_train_step(full_precision(), plan=plan)(state, batch)
                    rec = {"loss_f32": float(m["loss_sum"] / m["count"])}
                    if rank == 0:
                        rec["loss_ref"] = ref["loss"]
                        rec["update_gap"], rec["update_max"] = _update_gap(
                            _whole_params(model), ref)
                    del model, state, m
                    gc.collect()
                    if cuda:
                        torch.cuda.empty_cache()
                    model = TransformerLM(**cfg, attn_impl=impl, device=dev, seed=0)
                    steps_rec, state = _sp_bf16_steps(model, plan, batch, steps, dev, calls)
                    rec.update(steps_rec)
                    del model, state
                    gc.collect()
                    if cuda:
                        torch.cuda.empty_cache()
                        rec["peak_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20
                    out[impl] = rec
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def _sp_moe_child(rank: int, world: int, store: str, out_dir: str, device: str, cfg: dict,
                  batch_size: int, steps: int, ref_paths: dict) -> None:
    """(c): one of four gloo ranks on the one card (mesh data 2 x expert 2):
    ``TransformerLM`` with MoE blocks under ``moe_rules``.  f32 steps at
    ``SP_CHECK_LAYERS`` layers at the default capacity and at
    ``MOE_DROP_CF`` (on rank 0 against one process's step of the same
    weights and the whole batch, saved at ``ref_paths[cf]``), then
    ``steps`` bf16 steps at ``cfg``'s
    depth timed and counted, and the CUDA tensors a rank holds beside
    ``plan_memory``; writes what it saw as JSON."""
    import gc
    import traceback

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "TPUFRAME_COORDINATOR": f"file://{store}"})
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        from tpuframe_torch.core import initialize, shutdown
        from tpuframe_torch.models import TransformerLM, moe_rules
        from tpuframe_torch.ops import fused_adamw
        from tpuframe_torch.parallel import ParallelPlan, full_precision, plan_memory
        from tpuframe_torch.train import create_train_state, make_train_step

        rt = initialize(MOE_MESH, device=device, backend="gloo")
        dev, cuda = rt.device, rt.device.type == "cuda"
        if not cuda:
            torch.set_num_threads(2)
        calls = {"a2a": 0}
        try:
            whole = _sp_batch(cfg, batch_size, dev, seed=17)
            rows = batch_size // rt.data_count
            batch = {k: v[rt.data_index * rows:(rt.data_index + 1) * rows]
                     for k, v in whole.items()}
            small = dict(cfg, num_layers=SP_CHECK_LAYERS)
            plan = ParallelPlan(mesh=rt.mesh, rules=moe_rules())
            out["checks"] = {}
            for cf in MOE_CAPACITIES:
                model = TransformerLM(**small, device=dev, seed=0)
                _set_capacity(model, cf)
                state = create_train_state(model, fused_adamw(3e-4, **LM_STEP_ADAMW), plan=plan)
                state, m = make_train_step(full_precision(), plan=plan)(state, batch)
                rec = {"loss_f32": float(m["loss_sum"] / m["count"])}
                params = _whole_params(model)
                if rank == 0:
                    ref = torch.load(ref_paths[str(cf)])
                    rec["loss_ref"] = ref["loss"]
                    rec["update_gap"], rec["update_max"] = _update_gap(params, ref)
                    del ref
                rec["local_experts"] = int(model.block0.moe.w_in.shape[0])
                out["checks"][str(cf)] = rec
                del model, state, m, params
                gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev) if cuda else 0
            model = TransformerLM(**cfg, device=dev, seed=0)
            est = plan_memory(plan, flax_template(model),
                              {"input": ((batch_size, cfg["max_len"]), "int32")},
                              optimizer="adamw")
            with _counted_all_to_all(calls):
                steps_rec, state = _sp_bf16_steps(model, plan, batch, steps, dev, calls)
            out.update(steps_rec)
            out["estimate"] = est["per_device_mb"]
            out["layout"] = {k: v for k, v in model.tp_layout.items() if "block0" in k}
            gc.collect()
            out.update(_memory(dev, base))
            if cuda:
                out["reachable_mb"] = _reachable_cuda_mb()
        finally:
            shutdown()
    except BaseException:
        out["error"] = traceback.format_exc()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def sp_examples(card: str, workdir: Path) -> dict:
    """(d) Example 06 through its main (``Distributor``, its workers on the
    card over gloo) three ways, each worker's kernels counted; rank 0's
    K6 and K9 launches held exact."""
    import tpuframe_torch.launch as launch

    module = "06_lm_sequence_parallel"
    out = {}
    arg = {k: int(v) for k, v in zip(EX06_ARGV[::2], EX06_ARGV[1::2])}
    steps = arg["--train-samples"] // arg["--batch-size"]
    for name, argv in EX06_RUNS:
        counts = []

        class CountedDistributor(launch.Distributor):
            """The launcher, its worker fn counted there."""

            def run(self, fn, *args, **kwargs):
                value, c = super().run(counted_call, _sp_counters, module, fn.__name__, *args,
                                       **kwargs)
                counts.append(c)
                return value

        t0 = time.perf_counter()
        buf = io.StringIO()
        with mock.patch.object(launch, "Distributor", functools.partial(
                CountedDistributor, timeout_s=600)), contextlib.redirect_stdout(buf):
            metrics = _example(module).main(argv + EX06_ARGV + ["--workdir", str(workdir)])
        took = time.perf_counter() - t0
        c = counts[0] if counts else {}
        check(math.isfinite(metrics["train_loss"]), f"example 06 {name}: {metrics}")
        # rank 0 of each run: K6 once a layer (Ulysses; the ring's first rank
        # holds the diagonal tile alone), K9 per MoE layer: the dispatch
        # once, the combine twice (its forward, the dispatch's backward),
        # the combine's backward once
        ring_or_ulysses = "full" not in name
        moe = "moe" in name
        per = EX06_LAYERS * steps
        want = {n: per if ring_or_ulysses else 0 for n in K6_NAMES}
        want.update({"moe_dispatch": per if moe else 0, "moe_combine": 2 * per if moe else 0,
                     "moe_combine_backward": per if moe else 0})
        got = {n: c.get(n) for n in want}
        check(got == want or not torch.cuda.is_available(),
              f"example 06 {name}: rank 0's launches {got} != {want}")
        log(f"  (d) example 06 {' '.join(argv)} through its main (Distributor, workers on the "
            f"card, gloo): {took:.2f} s from its start to the result, rank 0's launches {c} "
            f"(K6/K9 expected {want}); train_loss {metrics['train_loss']:.4f} on {card}")
        out[name] = {"launches": c, "s": took, "train_loss": metrics["train_loss"]}
    return out


def sp_phase(card: str, timeout_s: float = 900.0, device: str = "cuda:0", cfg: dict = LONG_LM,
             batch_size: int = LONG_BATCH, moe_cfg: dict = MOE_LM, moe_batch: int = MOE_BATCH,
             steps: int = SP_STEPS, examples: bool = True) -> dict:
    """Phase 18 on the one card.  (a) The ring and (b) Ulysses: ``cfg``'s
    LM on ``SP_SEQ`` gloo ranks (mesh seq), each rank its run of positions:
    the first f32 loss and update at ``SP_CHECK_LAYERS`` layers against one
    process's blockwise run, then ``steps`` bf16 steps at full depth with
    each rank's launches and all-to-alls held exact.  (c) The MoE LM
    (``moe_cfg``) on data 2 x expert 2: the f32 checks at the default and a
    dropping capacity, ``steps`` bf16 steps with K9's launches held exact,
    memory beside ``plan_memory``.  (d) Example 06 three ways.  Returns the
    launches and a summary; sizes are arguments so the phase can be
    rehearsed small on the CPU."""
    t_start = time.perf_counter()
    cuda = device.startswith("cuda")
    layers = cfg["num_layers"]
    SP_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device(device)
    # one process's f32 steps here: under the ranks' runtime a model sees their split
    ref_seq = str(SP_DIR / "one_process_seq.pt")
    _save_one_process(_one_process(dict(cfg, num_layers=SP_CHECK_LAYERS),
                                   _sp_batch(cfg, batch_size, dev, seed=13), dev,
                                   attn_impl="blockwise"), ref_seq)
    ref_moe = {}
    for cf in MOE_CAPACITIES:
        ref_moe[str(cf)] = str(SP_DIR / f"one_process_moe_{cf}.pt")
        _save_one_process(_one_process(dict(moe_cfg, num_layers=SP_CHECK_LAYERS),
                                       _sp_batch(moe_cfg, moe_batch, dev, seed=17), dev,
                                       capacity=cf), ref_moe[str(cf)])
    if cuda:
        torch.cuda.empty_cache()
    res = _spawn(_sp_seq_child, SP_SEQ, (device, cfg, batch_size, steps, ref_seq), timeout_s,
                 "ring and Ulysses LM")
    r0 = res[0]
    out = {"card": card}
    for impl in ("ring", "ulysses"):
        rec = r0[impl]
        check(abs(rec["loss_f32"] / rec["loss_ref"] - 1) <= SP_LOSS_RTOL,
              f"({impl}) f32 loss {rec['loss_f32']!r} vs one process's {rec['loss_ref']!r}")
        rel = rec["update_gap"] / rec["update_max"]
        check(rel <= SP_UPDATE_RTOL, f"({impl}) the update is {rel:.3g} of the update's largest "
              f"element from one process's (tol {SP_UPDATE_RTOL})")
        per_layer_hops = (2 * SP_SEQ - 1) if impl == "ring" else 4
        for r, o in enumerate(res):
            tiles = (r + 1) if impl == "ring" else 1
            # the LM's (B, L) labels take the plain per-position loss (phase 6)
            want = {"cross_entropy_fwd": 0, "cross_entropy_bwd": 0,
                    "layer_norm_fwd": (2 * layers + 1) * steps,
                    "layer_norm_bwd": (2 * layers + 1) * steps, "fused_adamw": steps,
                    **{n: layers * tiles * steps for n in K6_NAMES},
                    **{n: 0 for n in K9_NAMES}}
            got = o[impl]
            check(got["launches"] == want or not cuda,
                  f"({impl}) rank {r}: launches {got['launches']} != {want}")
            check(got["a2a"] == layers * per_layer_hops * steps,
                  f"({impl}) rank {r}: {got['a2a']} all-to-alls, expected "
                  f"{layers * per_layer_hops * steps}")
            check(all(math.isfinite(x) for x in got["losses"]), f"({impl}) rank {r}: "
                  f"{got['losses']}")
        check(len({tuple(o[impl]["losses"]) for o in res}) == 1,
              f"({impl}) the ranks' losses differ")
        log(f"  ({'a' if impl == 'ring' else 'b'}) {impl}: TransformerLM {cfg} on seq={SP_SEQ} "
            f"gloo ranks, {batch_size} x {cfg['max_len'] // SP_SEQ} tokens a rank; at "
            f"{SP_CHECK_LAYERS} layers the first f32 loss {rec['loss_f32']!r} vs one process's "
            f"blockwise {rec['loss_ref']!r} ({rec['loss_f32'] / rec['loss_ref'] - 1:+.3g}, tol "
            f"{SP_LOSS_RTOL}), update gap {rec['update_gap']:.3g} of largest element "
            f"{rec['update_max']:.3g} ({rel:.3g}, tol {SP_UPDATE_RTOL}); {steps} bf16 steps "
            f"{[[round(t, 1) for t in o[impl]['step_ms']] for o in res]} ms, losses "
            f"{[round(x, 4) for x in rec['losses']]}, all_to_all_single {rec['a2a']} a rank "
            f"({per_layer_hops} a layer a step), launches a rank "
            f"{[{n: o[impl]['launches'][n] for n in K6_NAMES} for o in res]} (K6a-K6c; the "
            f"others {({n: v for n, v in rec['launches'].items() if n not in K6_NAMES})})"
            + (f", peak {[round(o[impl]['peak_mb'], 1) for o in res]} MB a rank" if cuda else "")
            + f" on {card}")
        out[f"launches_{impl}"] = [o[impl]["launches"] for o in res]
        out[f"{impl}_step_ms"] = [o[impl]["step_ms"] for o in res]
        out[f"{impl}_loss"] = (rec["loss_f32"], rec["loss_ref"], rel)
        out[f"{impl}_a2a"] = rec["a2a"]

    moe_layers = moe_cfg["num_layers"]
    resm = _spawn(_sp_moe_child, 4, (device, moe_cfg, moe_batch, steps, ref_moe), timeout_s,
                  "MoE LM")
    m0 = resm[0]
    for cf, rec in m0["checks"].items():
        check(abs(rec["loss_f32"] / rec["loss_ref"] - 1) <= SP_LOSS_RTOL,
              f"(c) capacity factor {cf}: f32 loss {rec['loss_f32']!r} vs one process's "
              f"{rec['loss_ref']!r}")
        rel = rec["update_gap"] / rec["update_max"]
        check(rel <= SP_UPDATE_RTOL, f"(c) capacity factor {cf}: the update is {rel:.3g} of "
              f"the update's largest element from one process's (tol {SP_UPDATE_RTOL})")
        log(f"  (c) MoE at {SP_CHECK_LAYERS} layers, capacity factor {cf}, data 2 x expert 2 "
            f"({rec['local_experts']} experts a rank): first f32 loss {rec['loss_f32']!r} vs one "
            f"process's {rec['loss_ref']!r} ({rec['loss_f32'] / rec['loss_ref'] - 1:+.3g}, tol "
            f"{SP_LOSS_RTOL}), update gap {rec['update_gap']:.3g} of {rec['update_max']:.3g} "
            f"({rel:.3g}, tol {SP_UPDATE_RTOL})")
    want = {"cross_entropy_fwd": 0, "cross_entropy_bwd": 0,
            "layer_norm_fwd": (2 * moe_layers + 1) * steps,
            "layer_norm_bwd": (2 * moe_layers + 1) * steps, "fused_adamw": steps,
            **{n: 0 for n in K6_NAMES}, "moe_dispatch": moe_layers * steps,
            "moe_combine": 2 * moe_layers * steps, "moe_combine_backward": moe_layers * steps}
    for r, o in enumerate(resm):
        check(o["launches"] == want or not cuda, f"(c) rank {r}: launches {o['launches']} != "
              f"{want}")
        check(all(math.isfinite(x) for x in o["losses"]), f"(c) rank {r}: {o['losses']}")
    mem = (f"; tensors held {[round(o['reachable_mb'], 1) for o in resm]} MB, persistent "
           f"{[round(o['persistent_mb'], 1) for o in resm]} MB, peak "
           f"{[round(o['peak_mb'], 1) for o in resm]} MB a rank beside plan_memory's params "
           f"{m0['estimate']['params']} + opt_state {m0['estimate']['opt_state']} MB, total "
           f"{m0['estimate']['total']} MB" if cuda else "")
    log(f"  (c) MoE TransformerLM {moe_cfg} under moe_rules on {MOE_MESH}, {moe_batch} x "
        f"{moe_cfg['max_len']} tokens ({moe_batch // 2} sequences a rank), layout "
        f"{m0['layout']}: {steps} bf16 steps {[[round(t, 1) for t in o['step_ms']] for o in resm]}"
        f" ms, losses {[round(x, 4) for x in m0['losses']]}, launches a rank "
        f"{[{n: o['launches'][n] for n in K9_NAMES} for o in resm]} (expected "
        f"{ {n: want[n] for n in K9_NAMES} }){mem} on {card}")
    out.update(launches_moe=[o["launches"] for o in resm],
               moe_step_ms=[o["step_ms"] for o in resm],
               moe_checks=m0["checks"], moe_estimate=m0["estimate"],
               moe_memory=[(o.get("reachable_mb"), o.get("persistent_mb"), o.get("peak_mb"))
                           for o in resm])
    if examples:
        out["example06"] = sp_examples(card, LAUNCH_DIR.parent / "sp_smoke_ex06")
    shutil.rmtree(SP_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_start
    log("  sp_json " + json.dumps(out))
    return out


#: Mixtral-8x7B's MoE width (its published config.json: hidden_size 4096,
#: num_local_experts 8, num_experts_per_tok 2), all 8 experts on one card,
#: capacity factor 1.25: where K9a's and K9b's byte bounds (~90 and ~60
#: us) lie far above the launch floor
MOE_WIDE = dict(tokens=8192, d=4096, experts=8, top_k=2, capacity_factor=1.25)


def _moe_case(dev, dtype, n, d, e, k, capacity, e0, e_local, seed):
    """Random routing (k distinct experts a token) and rows for K9: the
    descriptors ``(e_loc, slot, count)`` of experts ``e0 ..`` and the
    tokens, a cotangent and gate weights."""
    from tpuframe_torch.ops.moe_gating import _descriptors, _routing

    gen = np.random.default_rng(seed)
    idx = torch.from_numpy(np.argsort(gen.random((n, e)), -1)[:, :k].astype(np.int32))
    choice_exp, _, keep, _ = _routing(idx.to(dev), e, capacity)
    e_loc, slot, count = _descriptors(choice_exp, keep, e0, e_local)
    src, g = (torch.from_numpy(gen.standard_normal((n, d)).astype(np.float32)).to(dev, dtype)
              for _ in range(2))
    w = torch.from_numpy(gen.random(n * k).astype(np.float32)).to(dev)
    return e_loc, slot, count, src, g, w


def dispatch_profile() -> dict:
    """The device operations of one ``_Dispatch.apply`` and of one
    ``_Combine`` backward (``torch.autograd.grad`` of its output) at the MoE
    path's shape (a rank's 4,096 tokens x 768 bf16, experts 4..7 of 8, top
    2) by ``torch.profiler``: ``{"dispatch": {kernel: launches},
    "combine_backward": {...}}``, each kernel by the profiler's demangled
    name (its template arguments included)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from tpuframe_torch.ops.moe_gating import _Combine, _Dispatch

    dev = torch.device("cuda")
    n, d, e, k, e_local = MOE_BATCH // 2 * LM["max_len"], LM["num_heads"] * LM["head_dim"], 8, 2, 4
    capacity = max(1, int(-(-(k * n * 2) // e) * 1.25))
    e_loc, slot, count, src, g, w = _moe_case(dev, torch.bfloat16, n, d, e, k, capacity,
                                              e_local, e_local, seed=25)
    rows = min(capacity, k * n)
    buf = _Dispatch.apply(src, e_loc, slot, count, e_local, rows).detach().requires_grad_(True)
    w = w.requires_grad_(True)
    out = _Combine.apply(buf, w, e_loc, slot, count, n)

    def device_ops(fn) -> dict:
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {ev.key: ev.count for ev in prof.key_averages()
                if str(ev.device_type).endswith("CUDA")}

    return {"dispatch": device_ops(lambda: _Dispatch.apply(src, e_loc, slot, count, e_local,
                                                           rows)),
            "combine_backward": device_ops(lambda: torch.autograd.grad(
                out, (buf, w), g, retain_graph=True))}


def moe_kernel_phase(floor_ms: float, baseline, any_k, baseline_k9c) -> list[dict]:
    """(e) K9a-K9c against their plain versions on random inputs: at the
    MoE path's shape (a rank's 4,096 tokens, D 768, bf16, 8 experts of which
    4 are held, top 2, capacity 2,560), small in f32, at both expert
    offsets, and at Mixtral's width (``MOE_WIDE``); K9a, K9b and K9c's
    ``dbuf`` bit-equal, K9c's ``dgate`` within 1e-5 of the largest dot and
    +0.0 bit for bit where a slot is not held, bit-equal on a rerun and for
    the same (g, buf) row pair at two slots of other blocks.  K9a writes a
    NaN-filled buffer whole, and K9c NaN-filled outputs: the
    plain versions' zero-filled results.  The kernels
    before the redesign (``baseline``, ``BASELINE_K9``; ``baseline_k9c``,
    ``BASELINE_K9C``, the scaled dispatch then the gate gradient) and K9b's
    generic loop at top 2 (``any_k``, ``ANY_K_K9B``) give the same bits
    (the old gate gradient within 1e-5).  A profiled ``_Dispatch`` launches
    K9a alone (no zero fill) and a profiled ``_Combine`` backward K9c alone
    (:func:`dispatch_profile` in a fresh process).  Timed at the path's
    shape and at the wide one, in turns, beside the plain versions, the
    baseline kernels (K9a as the whole dispatch it was: ``zero_()`` of the
    buffer, then its kernel; K9c as the pair it replaces), the library
    calls (K9a: ``index_put_``, which writes the held rows; K9b:
    ``F.embedding_bag`` in sum mode with the weights in bf16, as it
    requires) and, for K9b, its generic loop and a ``copy_`` of an (N, D)
    tensor (as many bytes as K9b moves, or more: what a bare copy takes at
    that size).  Then K6's float32 partials at the ring's (2, 2048, 12, 64)
    bf16, causal and not: rounded to bf16 they are the default launch's
    bits."""
    import torch.nn.functional as F

    from tpuframe_torch.ops.blockwise_attention import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
    )
    from tpuframe_torch.ops.moe_gating import (
        _CODES,
        moe_combine,
        moe_combine_backward,
        moe_combine_reference,
        moe_dispatch,
        moe_dispatch_reference,
        moe_gate_grad_reference,
    )

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    bf16, nan = torch.bfloat16, float("nan")
    n, d, e, k, e_local = MOE_BATCH // 2 * LM["max_len"], LM["num_heads"] * LM["head_dim"], 8, 2, 4
    capacity = max(1, int(-(-(k * n * 2) // e) * 1.25))  # the path's global tokens
    rows = min(capacity, k * n)
    nw, dw, ew, kw = (MOE_WIDE[key] for key in ("tokens", "d", "experts", "top_k"))
    cap_w = int(-(-(kw * nw) // ew) * MOE_WIDE["capacity_factor"])

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def old_dispatch(src, buf, e_loc, slot):  # the zero fill, then the baseline K9a
        buf.zero_()
        rc = baseline.tf_moe_dispatch_baseline(
            src.data_ptr(), buf.data_ptr(), e_loc.data_ptr(), slot.data_ptr(), 0, src.shape[0],
            e_loc.numel() // src.shape[0], src.shape[1], buf.shape[1], _CODES[src.dtype],
            stream())
        check(rc == 0, f"baseline K9a launch failed: CUDA error {rc}")
        return buf

    def old_combine(buf, w, e_loc, slot, out):
        n_ = out.shape[0]
        rc = baseline.tf_moe_combine_baseline(
            buf.data_ptr(), w.data_ptr(), e_loc.data_ptr(), slot.data_ptr(), out.data_ptr(), n_,
            e_loc.numel() // n_, buf.shape[2], buf.shape[1], _CODES[buf.dtype], stream())
        check(rc == 0, f"baseline K9b launch failed: CUDA error {rc}")
        return out

    def any_k_combine(buf, w, e_loc, slot, out):  # K9b's generic loop at any top-k
        n_ = out.shape[0]
        rc = any_k.tf_moe_combine_any_k(
            buf.data_ptr(), w.data_ptr(), e_loc.data_ptr(), slot.data_ptr(), out.data_ptr(), n_,
            e_loc.numel() // n_, buf.shape[2], buf.shape[1], _CODES[buf.dtype], stream())
        check(rc == 0, f"K9b's generic loop failed to launch: CUDA error {rc}")
        return out

    def old_backward(g, buf, w, e_loc, slot, count, dbuf, dgate):
        """The pair K9c replaces: the scaled dispatch into dbuf, then the
        gate gradient into dgate."""
        n_, args = g.shape[0], (e_loc.numel() // g.shape[0], g.shape[1], buf.shape[1])
        rc = baseline_k9c.tf_moe_dispatch_scaled_baseline(
            g.data_ptr(), dbuf.data_ptr(), e_loc.data_ptr(), slot.data_ptr(), w.data_ptr(),
            count.data_ptr(), n_, *args, buf.shape[0], _CODES[g.dtype], stream())
        check(rc == 0, f"baseline scaled K9a launch failed: CUDA error {rc}")
        rc = baseline_k9c.tf_moe_gate_grad_baseline(
            g.data_ptr(), buf.data_ptr(), e_loc.data_ptr(), slot.data_ptr(), dgate.data_ptr(),
            n_, *args, _CODES[g.dtype], stream())
        check(rc == 0, f"baseline K9c launch failed: CUDA error {rc}")
        return dbuf, dgate

    t_start = time.perf_counter()
    # the profiles run in a fresh process, beside the checks below: after
    # the earlier phases this process's profiler saw no device events
    profiler = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke as cs; "
         "print(json.dumps(cs.dispatch_profile()))"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    err = {name: 0.0 for name in K9_NAMES}

    def check_all():
        """K9a-K9c against the plain versions and the baselines at each shape."""
        cases = [("path", bf16, n, d, e, e_local, capacity, (0, e_local)),
                 ("small", torch.float32, 300, 96, 6, 3, 60, (0, 3)),
                 ("wide", bf16, nw, dw, ew, ew, cap_w, (0,))]
        for name, dtype, nn_, dd, ee, el, cap, offsets in cases:
            for e0 in offsets:
                e_loc, slot, count, src, g, w = _moe_case(dev, dtype, nn_, dd, ee, k, cap, e0,
                                                          el, seed=21 + e0)
                shape = (el, min(cap, k * nn_), dd)

                def nan_buf():
                    return torch.empty(shape, dtype=dtype, device=dev).fill_(nan)

                buf = moe_dispatch(src, nan_buf(), e_loc, slot, count=count)
                want_buf = moe_dispatch_reference(
                    src, torch.zeros(shape, dtype=dtype, device=dev), e_loc, slot, count=count)
                plain_nan = moe_dispatch_reference(src, nan_buf(), e_loc, slot, count=count)
                old_buf = old_dispatch(src, nan_buf(), e_loc, slot)
                comb, want_comb = (moe_combine(buf, w, e_loc, slot, nn_),
                                   moe_combine_reference(buf, w, e_loc, slot, nn_))
                old_comb = old_combine(buf, w, e_loc, slot, torch.empty_like(comb))
                any_comb = any_k_combine(buf, w, e_loc, slot, torch.empty_like(comb))
                # K9c into NaN-filled outputs, then again; the plain pair into
                # a NaN-filled buffer; the baseline pair
                dbuf, dg = moe_combine_backward(g, buf, w, e_loc, slot, count, nan_buf(),
                                                torch.empty(k * nn_, device=dev).fill_(nan))
                dbuf2, dg2 = moe_combine_backward(g, buf, w, e_loc, slot, count,
                                                  torch.empty_like(dbuf), torch.empty_like(dg))
                want_dbuf = moe_dispatch_reference(g, nan_buf(), e_loc, slot, w, count=count)
                want_dg = moe_gate_grad_reference(g, buf, e_loc, slot)
                old_dbuf, old_dg = old_backward(g, buf, w, e_loc, slot, count, nan_buf(),
                                                torch.empty_like(want_dg).fill_(nan))
                # the same (g, buf) row pair at the first and the last held slot
                held_f = (e_loc >= 0).nonzero()[:, 0]
                f1, f2 = int(held_f[0]), int(held_f[-1])
                g_pair, buf_pair = g.clone(), buf.clone()
                g_pair[f2 % nn_] = g_pair[f1 % nn_]
                buf_pair[int(e_loc[f2]), int(slot[f2])] = buf_pair[int(e_loc[f1]), int(slot[f1])]
                _, dg_pair = moe_combine_backward(g_pair, buf_pair, w, e_loc, slot, count,
                                                  torch.empty_like(dbuf), torch.empty_like(dg))
                torch.cuda.synchronize()
                check(torch.equal(plain_nan, want_buf), f"plain K9a {name} e0={e0}: a "
                      "NaN-filled buffer does not give the zero-filled result")
                check(torch.equal(buf, want_buf), f"K9a {name} e0={e0}: not bit-equal to the "
                      "plain version")
                check(torch.equal(comb, want_comb), f"K9b {name} e0={e0}: not bit-equal")
                check(torch.equal(any_comb, want_comb),
                      f"K9b's generic loop {name} e0={e0}: not bit-equal")
                check(torch.equal(old_buf, want_buf) and torch.equal(old_comb, want_comb),
                      f"baseline K9a/K9b {name} e0={e0}: not the plain versions' bits")
                check(not dbuf.isnan().any() and not dg.isnan().any()
                      and torch.equal(dbuf, want_dbuf),
                      f"K9c {name} e0={e0}: dbuf not bit-equal to the plain version")
                check(torch.equal(dbuf2, dbuf) and torch.equal(dg2.view(torch.int32),
                                                               dg.view(torch.int32)),
                      f"K9c {name} e0={e0}: a rerun gave other bits")
                not_held = e_loc < 0
                check(not bool(dg[not_held].view(torch.int32).any()),
                      f"K9c {name} e0={e0}: dgate not +0.0 where a slot is not held")
                pair = dg_pair[[f1, f2]].view(torch.int32)
                check(f1 // 16 != f2 // 16 and int(pair[0]) == int(pair[1]),
                      f"K9c {name} e0={e0}: the same row pair at slots {f1} and {f2} gave "
                      f"{dg_pair[[f1, f2]].tolist()}")
                check(torch.equal(old_dbuf, want_dbuf),
                      f"baseline scaled K9a {name} e0={e0}: not the plain version's bits")
                tol = 1e-5 * max(1.0, float(want_dg.abs().max()))
                e9c = float((dg - want_dg).abs().max())
                e9c_old = float((old_dg - want_dg).abs().max())
                check(e9c <= tol, f"K9c {name} e0={e0}: dgate {e9c:.3g} from the plain version")
                check(e9c_old <= tol, f"baseline K9c {name} e0={e0}: {e9c_old:.3g} from the "
                      "plain version")
                err["moe_combine_backward"] = max(err["moe_combine_backward"], e9c)
                log(f"  MoE kernels {name} ({nn_} tokens, D {dd}, "
                    f"{str(dtype).removeprefix('torch.')}, experts {e0}..{e0 + el - 1} of {ee}, "
                    f"{int((e_loc >= 0).sum())} of {k * nn_} slots held here, {shape[1]} rows an "
                    f"expert): K9a (into NaN-filled buffers), K9b and K9c's dbuf bit-equal to "
                    f"their plain versions and to the baselines' (K9b also through its generic "
                    f"loop); K9c's dgate within {e9c:.3g} (the baseline's {e9c_old:.3g}), +0.0 "
                    f"at the slots not held, a rerun and the row pair at slots {f1} and {f2} "
                    f"bit-equal")
                del buf, want_buf, plain_nan, old_buf, dbuf, dbuf2, want_dbuf, old_dbuf, buf_pair
        torch.cuda.empty_cache()

    try:
        check_all()
        out_text, err_text = profiler.communicate(timeout=300)
    finally:
        if profiler.poll() is None:
            profiler.kill()
            profiler.wait()
    # one _Dispatch launches K9a alone (no zero fill beside it), one
    # _Combine backward K9c alone (the backward instance of its template)
    check(profiler.returncode == 0, f"the MoE profiles failed:\n{out_text}\n{err_text}")
    prof = json.loads(out_text.strip().splitlines()[-1])
    log(f"  profile at the path's shape: one _Dispatch.apply {prof['dispatch']}; one _Combine "
        f"backward {prof['combine_backward']}")
    for which, backward in (("dispatch", False), ("combine_backward", True)):
        names = {kernel_name(key): c for key, c in prof[which].items()}
        check(names == {"dispatch_kernel": 1}
              and all(("true>" in key) == backward for key in prof[which]),
              f"one {which} launched {prof[which]}, not {'K9c' if backward else 'K9a'} alone")
    t_checked = time.perf_counter()

    def timed(label, dtype, nn_, dd, ee, el, cap, e0, seed):
        """K9a-K9c at one shape: each arm's time, in turns, the better of
        two medians kept."""
        e_loc, slot, count, src, g, w = _moe_case(dev, dtype, nn_, dd, ee, k, cap, e0, el, seed)
        shape = (el, min(cap, k * nn_), dd)
        buf = moe_dispatch(src, torch.empty(shape, dtype=dtype, device=dev), e_loc, slot,
                           count=count)
        dst, dst_old, dbuf_old = (torch.empty(shape, dtype=dtype, device=dev) for _ in range(3))
        dgate_old, dgate_new = (torch.empty(k * nn_, dtype=torch.float32, device=dev)
                                for _ in range(2))
        out_old, out_any, copy_dst = (torch.empty((nn_, dd), dtype=dtype, device=dev)
                                      for _ in range(3))
        sel = (e_loc >= 0).nonzero()[:, 0]
        put_idx, put_src = (e_loc[sel].long(), slot[sel].long()), src[sel % nn_]
        held = int(sel.numel())
        held_tok = int((e_loc.view(k, nn_) >= 0).any(0).sum())  # tokens with a held slot
        # embedding_bag: token n's bag is its k rows of the flattened buffer,
        # a slot not held here row 0 at weight 0 (the buffer is finite)
        bag_idx = (e_loc.clamp(min=0).long() * shape[1] + slot.long()).view(k, nn_).t()
        bag_w = torch.where(e_loc >= 0, w, 0.0).view(k, nn_).t().to(dtype)
        bag_weight = buf.view(-1, dd)

        def bag():
            return F.embedding_bag(bag_idx, bag_weight, mode="sum", per_sample_weights=bag_w)

        want = moe_combine_reference(buf, w, e_loc, slot, nn_)
        bag_err = float((bag().float() - want.float()).abs().max())
        check(bag_err <= 2e-2 * float(want.float().abs().max()),
              f"embedding_bag at the {label} shape: {bag_err:.3g} from K9b's plain version")
        del want
        iters_plain = 30 if label == "path" else 10
        arms = {
            "moe_dispatch": {
                "kernel": lambda: moe_dispatch(src, dst, e_loc, slot, count=count),
                "baseline": lambda: old_dispatch(src, dst_old, e_loc, slot),
                "plain": lambda: moe_dispatch_reference(src, dst, e_loc, slot, count=count),
                "library": lambda: dst.index_put_(put_idx, put_src)},
            "moe_combine": {
                "kernel": lambda: moe_combine(buf, w, e_loc, slot, nn_),
                "baseline": lambda: old_combine(buf, w, e_loc, slot, out_old),
                "any_k": lambda: any_k_combine(buf, w, e_loc, slot, out_any),
                "copy": lambda: copy_dst.copy_(src),
                "plain": lambda: moe_combine_reference(buf, w, e_loc, slot, nn_),
                "library": bag},
            "moe_combine_backward": {
                "kernel": lambda: moe_combine_backward(g, buf, w, e_loc, slot, count, dst,
                                                       dgate_new),
                "baseline": lambda: old_backward(g, buf, w, e_loc, slot, count, dbuf_old,
                                                 dgate_old),
                "plain": lambda: (moe_dispatch_reference(g, dst, e_loc, slot, w, count=count),
                                  moe_gate_grad_reference(g, buf, e_loc, slot))},
        }
        row_b, desc_b = dd * src.element_size(), 8 * k * nn_  # a row; e_loc and slot
        buf_b = shape[0] * shape[1] * row_b
        # K9a reads the held rows and the counts and writes the whole buffer;
        # K9c reads g's rows of the tokens with a held slot (once, though
        # the kernel reads a token's row for each of its held slots), buf's
        # held rows, the weights and the counts, and writes the whole dbuf
        # and dgate
        moved = {"moe_dispatch": held * row_b + buf_b + desc_b + 4 * el,
                 "moe_combine": held * row_b + 4 * k * nn_ + desc_b + nn_ * row_b,
                 "moe_combine_backward": (held_tok + held) * row_b + buf_b + desc_b + 4 * el
                 + 2 * 4 * k * nn_}
        flops = {"moe_dispatch": 0, "moe_combine": 2 * held * dd,
                 "moe_combine_backward": 3 * held * dd}
        old_moved = buf_b + 2 * held * row_b + desc_b  # the baseline's zero fill, then its K9a
        library = {"moe_dispatch": "index_put_",
                   "moe_combine": f"embedding_bag (bf16 weights, {bag_err:.3g} off)"}
        out = {}
        for which, fns in arms.items():
            order = list(fns) + list(fns)[::-1]
            ms = {arm: [] for arm in fns}
            for arm in order:
                ms[arm].append(time_ms(fns[arm], flush,
                                       iters=iters_plain if arm == "plain" else 100))
            best = {arm: min(v) for arm, v in ms.items()}
            bound_ms, bound_by = bound(moved[which], flops[which])
            t = {"ms": best["kernel"], "plain_ms": best["plain"],
                 "library_ms": best.get("library"), "baseline_ms": best.get("baseline"),
                 "turns_ms": ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "bytes_moved": moved[which],
                 "bound_share": bound_ms / best["kernel"], "x_floor": best["kernel"] / floor_ms,
                 "held": held, "held_tokens": held_tok}
            if which == "moe_combine":
                t.update(any_k_ms=best["any_k"], copy_ms=best["copy"],
                         copy_bytes_moved=2 * nn_ * row_b, library_bf16_weights_err=bag_err)
            if which == "moe_dispatch":
                t["baseline_bytes_moved"] = old_moved
                t["baseline_bound_ms"] = old_moved / HBM_BYTES_PER_S * 1e3
                t["baseline_kernel_bytes_moved"] = 2 * held * row_b + desc_b
            if which == "moe_combine_backward":
                t["baseline_saved_floors"] = (best["baseline"] - best["kernel"]) / floor_ms
            out[which] = t
            base_name = {"moe_dispatch": "zero fill + K9a", "moe_combine": "K9b",
                         "moe_combine_backward": "pair (scaled K9a, then K9c)"}[which]
            log(f"  {which} at the {label} shape ({nn_} tokens x {dd} "
                f"{str(dtype).removeprefix('torch.')}, {held} slots of {held_tok} tokens held, "
                f"buffer {buf_b / 1e6:.1f} MB): kernel {t['ms'] * 1e3:.2f} us "
                f"({t['bound_share']:.0%} of its bound {bound_ms * 1e3:.2f} us, "
                f"{moved[which] / 1e6:.2f} MB at 3.35 TB/s; {t['x_floor']:.2f}x the floor "
                f"{floor_ms * 1e3:.2f} us), baseline {base_name} "
                f"{t['baseline_ms'] * 1e3:.2f} us ({t['baseline_ms'] / t['ms']:.2f}x)"
                + (f" [its bytes {old_moved / 1e6:.2f} MB, bound "
                   f"{t['baseline_bound_ms'] * 1e3:.2f} us; the baseline K9a alone "
                   f"{t['baseline_kernel_bytes_moved'] / 1e6:.2f} MB]" if which == "moe_dispatch"
                   else "")
                + (f" [{t['baseline_saved_floors']:.2f} floors saved; turns "
                   + " / ".join(f"{a} {v[0] * 1e3:.2f}, {v[1] * 1e3:.2f} us"
                                for a, v in ms.items() if a in ("kernel", "baseline")) + "]"
                   if which == "moe_combine_backward" else "")
                + (f", its generic loop {t['any_k_ms'] * 1e3:.2f} us (turns "
                   + " / ".join(f"{a} {v[0] * 1e3:.2f}, {v[1] * 1e3:.2f} us"
                                for a, v in ms.items() if a in ("kernel", "any_k"))
                   + f"), copy_ of {t['copy_bytes_moved'] / 1e6:.2f} MB "
                   f"{t['copy_ms'] * 1e3:.2f} us" if which == "moe_combine" else "")
                + f", plain {t['plain_ms'] * 1e3:.2f} us"
                + (f", {library[which]} {t['library_ms'] * 1e3:.2f} us"
                   if t["library_ms"] else ""))
        return out

    times = timed("path", bf16, n, d, e, e_local, capacity, e_local, 25)
    torch.cuda.empty_cache()
    wide = timed("wide", bf16, nw, dw, ew, ew, cap_w, 0, 26)
    torch.cuda.empty_cache()
    aims = {"K9b within 1.5x the floor at the path": times["moe_combine"]["x_floor"] <= 1.5,
            "K9a at least 50 % of its bound at the path":
                times["moe_dispatch"]["bound_share"] >= 0.5,
            "K9a at least 50 % of its bound at the wide shape":
                wide["moe_dispatch"]["bound_share"] >= 0.5,
            "K9b at least 50 % of its bound at the wide shape":
                wide["moe_combine"]["bound_share"] >= 0.5,
            "K9c at least 50 % of its bound at the path":
                times["moe_combine_backward"]["bound_share"] >= 0.5,
            "K9c faster than the baseline pair by at least one launch floor at the path":
                times["moe_combine_backward"]["baseline_saved_floors"] >= 1.0,
            "K9c at least 70 % of its bound at the wide shape":
                wide["moe_combine_backward"]["bound_share"] >= 0.7}
    for aim, hit in aims.items():
        log(f"  aim: {aim}: {'hit' if hit else 'missed'}")
    log(f"  (e) K9 checked and profiled in {t_checked - t_start:.1f} s, timed in "
        f"{time.perf_counter() - t_checked:.1f} s")
    # K6's float32 partials at the ring's tile
    b_, l_, h_, d_ = LONG_BATCH, LONG_LM["max_len"] // SP_SEQ, LONG_LM["num_heads"], \
        LONG_LM["head_dim"]
    gen = torch.Generator(device=dev).manual_seed(23)
    q, kk, v, gg = (torch.randn((b_, l_, h_, d_), generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(4))
    for causal in (True, False):
        out, lse = blockwise_attention_fwd(q, kk, v, causal=causal)
        out32, lse32 = blockwise_attention_fwd(q, kk, v, causal=causal, out_dtype=torch.float32)
        dq, delta = blockwise_attention_bwd_dq(q, kk, v, out, lse, gg, causal=causal)
        dq32, _ = blockwise_attention_bwd_dq(q, kk, v, out, lse, gg, causal=causal,
                                             out_dtype=torch.float32)
        dk, dv = blockwise_attention_bwd_dkv(q, kk, v, lse, delta, gg, causal=causal)
        dk32, dv32 = blockwise_attention_bwd_dkv(q, kk, v, lse, delta, gg, causal=causal,
                                                 out_dtype=torch.float32)
        torch.cuda.synchronize()
        same = all(a.dtype == torch.float32 and torch.equal(a.to(torch.bfloat16), b)
                   for a, b in ((out32, out), (dq32, dq), (dk32, dk), (dv32, dv)))
        check(same and torch.equal(lse32, lse), f"K6 float32 partials (causal={causal}): "
              "rounded to bf16 they are not the default launch's bits")
        log(f"  K6a-K6c float32 partials at ({b_}, {l_}, {h_}, {d_}) bf16 causal={causal}: "
            "rounded to bf16, bit-equal to the default launches (out, dq, dk, dv; lse equal)")
    lines = {"moe_dispatch": (137, "K9a"), "moe_combine": (143, "K9b"),
             "moe_combine_backward": (143, "K9c")}
    extra = ("baseline_ms", "bound_share", "x_floor", "baseline_bytes_moved",
             "baseline_bound_ms", "baseline_kernel_bytes_moved", "any_k_ms", "copy_ms",
             "copy_bytes_moved", "library_bf16_weights_err", "baseline_saved_floors",
             "turns_ms", "held_tokens")
    rows_out = []
    for which in K9_NAMES:
        t = times[which]
        row = {
            "name": which, "route": "cuda", "source": "tpuframe_torch/csrc/moe_gating.cu",
            "replaces": f"tpuframe/ops/moe_gating.py:{lines[which][0]}", "launches": None,
            "max_abs_err": err[which],
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": f"{n} tokens x {d} bf16, top {k}, experts {e_local}..{2 * e_local - 1} of "
                     f"{e}, {rows} rows an expert, {t['held']} slots held",
            "bytes_moved": t["bytes_moved"], "id": lines[which][1],
            **{key: t[key] for key in extra if key in t}}
        if which in wide:
            row["wide"] = dict(wide[which], shape=f"{nw} tokens x {dw} bf16, top {kw}, all "
                               f"{ew} experts, {cap_w} rows an expert (Mixtral-8x7B's width)")
        rows_out.append(row)
    for row in rows_out:
        row["aims"] = aims
    del flush
    return rows_out


#: the phases whose ranks are gloo processes on the one card: the script's
#: time varies most there, with the host
# -- phase 19: fault tolerance on one card ---------------------------------------

FAULT_STEPS = 8  # (a)/(b): the LM fit, two epochs of four batches
FAULT_EPOCH = 4
FAULT_EVERY = 2  # their checkpoint_interval_batches
FAULT_NOTICE = 2  # (a): PreemptNotice at the step site of index 2, during step 3
FAULT_TORN = 6  # (b): the snapshot of step 6 torn, RaiseAt at the next step's site
RES_FAULT_BATCH = 32  # (d) and (e): ResNet50-1K's global batch, four a epoch
RES_FAULT_LR = 0.01
MNIST_CFG = dict(epochs=2, batch_size=64, train_samples=256, eval_samples=128, lr=0.01, seed=42)
MNIST_KILL_STEP = 6  # (c): rank 1 killed before step 7 (epoch 2)
#: (e): LoseRank(1) before step 6, mid-epoch 2; the resume is from the epoch
#: boundary (step 4): a mid-epoch snapshot's loader position is refused at
#: another process count, in both packages (the loader's fingerprint)
ELASTIC_LOSE_STEP = 5
SERVE_FLOOD = 256  # (f): synthetic requests of the QueueFlood


def _fault_counters():
    """K1, K2a/K2b, K3a/K3b and K4 (one launch a step over every tensor)."""
    from tpuframe_torch.ops.fused_adamw import fused_adamw_multi_update_
    from tpuframe_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd

    return {**_k12(), "layer_norm_fwd": layer_norm_fwd, "layer_norm_bwd": layer_norm_bwd,
            "fused_adamw": fused_adamw_multi_update_}


def _zeroed(counters: dict) -> dict:
    for c in counters.values():
        c.launches = 0
    return counters


def _counts(counters: dict) -> dict:
    return {n: c.launches for n, c in counters.items()}


def _state_digest(state) -> str:
    """sha256 over every tensor of a ``TrainState``'s saveable dict (whole
    tensors: every rank calls it)."""
    import hashlib

    h = hashlib.sha256()

    def walk(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif torch.is_tensor(v):
                h.update(f"{prefix}{k}".encode())
                h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                         .numpy().tobytes())
    walk(state.state_dict())
    return h.hexdigest()


def fault_lm_parts(card: str, root: Path, dev: torch.device, cfg: dict, batch_size: int,
                   workers: int = 4) -> dict:
    """Phase 19 (a) and (b), one supervised fit of ``cfg`` (phase 6's
    GPT-2-small LM on the card) that meets both faults: the preemption
    notice during step 3 (attempt 1), then the torn snapshot of step 6 and
    a ``ChaosError`` at the next step (attempt 2), resumed by attempt 3 from
    the committed step 4.  Held bit-equal to an uninterrupted fit.  Returns
    their numbers."""
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.fault import (
        ChaosPlan,
        PreemptNotice,
        RaiseAt,
        RestartPolicy,
        Supervisor,
        TornCheckpoint,
    )
    from tpuframe_torch.fault import preempt
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import Callback, Trainer

    seq, vocab = cfg["max_len"], cfg["vocab_size"]
    # the LM's loss takes no K2 at this vocabulary (phase 6 holds it at 0)
    per_step = {"normalize": 0, "cross_entropy_fwd": 0, "cross_entropy_bwd": 0,
                "layer_norm_fwd": 2 * cfg["num_layers"] + 1,
                "layer_norm_bwd": 2 * cfg["num_layers"] + 1, "fused_adamw": 1}
    tele = get_telemetry()

    class Probe(Callback):
        """The step each attempt starts from, and when its first step starts."""

        def __init__(self):
            self.resumed, self.first_step_mono = [], []

        def on_fit_start(self, trainer):
            self.resumed.append(trainer.state.step)

        def on_step_start(self, trainer):
            if len(self.first_step_mono) < len(self.resumed):
                self.first_step_mono.append(time.monotonic())

    def make(directory=None, callbacks=()):
        model = TransformerLM(**cfg, device=dev, seed=0)
        data = NextTokenDataset(batch_size * FAULT_EPOCH, seq, vocab, seed=1)
        return Trainer(model, tx=fused_adamw(3e-4, weight_decay=1e-4),
                       train_dataloader=DataLoader(data, batch_size, shuffle=True, seed=0,
                                                   num_workers=workers),
                       precision="bf16", max_duration=f"{FAULT_STEPS}ba", log_interval=0,
                       callbacks=list(callbacks),
                       checkpointer=None if directory is None else Checkpointer(directory),
                       checkpoint_interval_batches=FAULT_EVERY if directory else None)

    straight = make()
    t0 = time.perf_counter()
    straight.fit()
    sync(dev)
    out = {"card": card, "uninterrupted_fit_s": time.perf_counter() - t0}

    directory = str(root / "lm")
    probe, restarts = Probe(), []

    def attempt():
        tr = make(directory, [probe])
        return tr, tr.fit()

    sup = Supervisor(RestartPolicy(max_restarts=1, max_preemptions=2, backoff_base_s=0.0),
                     checkpoint_dir=directory,
                     on_restart=lambda n, e: restarts.append(time.monotonic()))
    plan = ChaosPlan([PreemptNotice("step", step=FAULT_NOTICE),
                      TornCheckpoint(step=FAULT_TORN), RaiseAt("step", step=FAULT_TORN)])
    counters = _zeroed(_fault_counters())
    token = _mark(tele)
    t0 = time.perf_counter()
    try:
        with plan.active():
            tr, res = sup.run(attempt)
        sync(dev)
    finally:
        preempt.uninstall()  # the notice installed the process-wide watcher
    wall = time.perf_counter() - t0
    # this thread's events: (c) runs its launcher from another thread meanwhile
    me = threading.current_thread().name
    launches = _counts(counters)
    events = [e for e in _since(tele, token) if e.get("thread") == me]
    exit_step = FAULT_NOTICE + 1
    # attempt 1 to the exit, attempt 2 from it to the torn step, attempt 3
    # from the epoch-end step 4 to the end
    steps = exit_step + (FAULT_TORN - exit_step) + (FAULT_STEPS - FAULT_EPOCH)
    expected = {n: v * steps for n, v in per_step.items()}

    def named(name):
        return [e for e in events if e.get("name") == name]

    preempted, saves = named("fault/preempted"), named("fault/preempt_checkpoint")
    restart_ev, quarantined = named("fault/restart"), named("fault/quarantine")
    check(sup.preemptions == 1 and sup.retries == 1
          and probe.resumed == [0, exit_step, FAULT_EPOCH]
          and tr.state.step == FAULT_STEPS and res.error is None,
          f"(a, b) preemptions {sup.preemptions}, retries {sup.retries}, attempts from "
          f"{probe.resumed}, ended at step {tr.state.step}")
    check(len(preempted) == 1 and len(saves) == 1
          and preempted[0]["checkpoint"] == f"{directory}_intra/{exit_step}"
          and [e["failure_class"] for e in restart_ev] == ["preemption", "retryable"]
          and restart_ev[0]["delay_s"] == 0.0 and restart_ev[0]["budget"] == 2,
          f"(a) {len(preempted)} fault/preempted ({preempted}), {len(saves)} last-chance "
          f"snapshots, restarts {restart_ev}")
    check(len(quarantined) == 1 and quarantined[0]["step"] == FAULT_TORN,
          f"(b) quarantines {quarantined}")
    check(launches == expected, f"(a, b) launches {launches}, expected {expected}")
    equal, diff = _same_state(tr.state, straight.state)
    check(equal, f"(a, b) the preempted, torn and resumed fit is not bit-equal to the "
          f"uninterrupted one (max |diff| {diff:.3g})")
    (notice,) = named("fault/preempt_notice")
    notice_to_exit = float(preempted[0]["mono"]) - float(notice["mono"])
    save_s = float(saves[0]["dur_s"])
    first = [t - r for t, r in zip(probe.first_step_mono[1:], restarts)]
    nbytes = sum(t.numel() * t.element_size() for t in _state_tensors(tr.state))
    out["a"] = {"notice_to_preempted_s": notice_to_exit, "last_chance_save_s": save_s,
                "rest_s": notice_to_exit - save_s, "restart_to_first_step_s": first[0],
                "state_gb": nbytes / 1e9}
    out["b"] = {"restart_to_first_step_s": first[1]}
    out.update(supervised_s=wall, launches=launches)
    log(f"  (a) PreemptNotice during step {exit_step}: Preempted at its boundary "
        f"{notice_to_exit:.3f} s after the notice ({save_s:.3f} s the synchronous save of "
        f"{nbytes / 1e9:.3f} GB, {notice_to_exit - save_s:.3f} s the rest); restart (0 s "
        f"delay, preemption budget) to the first resumed step {first[0]:.3f} s, from step "
        f"{exit_step}")
    log(f"  (b) the snapshot of step {FAULT_TORN} torn, a ChaosError at the next step: one "
        f"fault/quarantine (step {quarantined[0]['step']}), a RETRYABLE restart to the first "
        f"step resumed from the committed step {FAULT_EPOCH} {first[1]:.3f} s; the fit of "
        f"three attempts ({wall:.2f} s) bit-equal to the uninterrupted {FAULT_STEPS}-step fit "
        f"(parameters and optimizer state); launches {launches} on {card}")
    return out


def _stamped_kill(stamp: str, step: int):
    """A ``KillWorker(SIGKILL)`` at ``step`` that first writes the wall time
    of its kill into ``stamp`` (the launching process times the loss's
    detection from it)."""
    import signal

    from tpuframe_torch.fault import KillWorker

    class StampedKill(KillWorker):
        def fire(self, ctx):
            Path(stamp).write_text(repr(time.time()))
            super().fire(ctx)

    return StampedKill("step", step, sig=signal.SIGKILL)


def mnist_killed_once(cfg: dict, flag: str, stamp: str):
    """Worker side of (c): example 01's ``train_mnist`` with K2 counted, on
    the first attempt rank 1 under ``KillWorker(SIGKILL)``.  Returns its
    value, the epoch its checkpoint held when it started, the counts and
    the eval batches a rank."""
    from tpuframe_torch.ckpt.meta import _read_meta_doc, latest_step
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.fault import ChaosPlan

    held = latest_step(cfg["ckpt_dir"])
    resume_epoch = _read_meta_doc(cfg["ckpt_dir"], held)["meta"]["epoch"] if held else 0
    plan = ChaosPlan()
    if os.environ["RANK"] == "1" and not os.path.exists(flag):
        Path(flag).write_text("armed")
        plan = ChaosPlan([_stamped_kill(stamp, MNIST_KILL_STEP)])
    with plan.active():
        value, counts = counted_call(_k12, "01_distributor_mnist", "train_mnist", cfg)
    evl = DataLoader(SyntheticImageDataset(n=cfg["eval_samples"], image_size=28, channels=1,
                                           num_classes=10, seed=cfg["seed"] + 1),
                     cfg["batch_size"], drop_last=False)
    return value, resume_epoch, counts, len(evl)


def _raise_preempted():
    from tpuframe_torch.fault import Preempted

    raise Preempted("spot reclaim", step=7)


def fault_mnist_part(card: str, root: Path, simulate: int | None = None) -> dict:
    """Phase 19 (c): example 01 (MNIST) through the ``Distributor`` and
    ``run_with_restarts`` on two gloo ranks of the card, rank 1 killed;
    then one worker whose fn raises ``Preempted`` exits 143."""
    import pickle

    import cloudpickle

    from tpuframe_torch.fault import PREEMPTED_EXIT, Preempted
    from tpuframe_torch.launch import Distributor, DistributorError, run_with_restarts

    cfg = {**MNIST_CFG, "tracking_uri": str(root / "mnist" / "mlruns"),
           "ckpt_dir": str(root / "mnist" / "ckpt")}
    flag, stamp = str(root / "mnist_killed"), str(root / "mnist_kill_time")
    # a worker whose fn raises Preempted exits 143, its typed frame written;
    # started first, it runs beside the launches below
    payload, result = str(root / "preempted.pkl"), str(root / "preempted_out.pkl")
    with open(payload, "wb") as f:
        cloudpickle.dump((_raise_preempted, (), {}), f)
    proc = subprocess.Popen([sys.executable, "-m", "tpuframe_torch.launch._worker", payload,
                             result], stderr=subprocess.PIPE,
                            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                                p for p in sys.path if p)})
    restarts = []
    dist = Distributor(num_processes=2, simulate_devices=simulate, timeout_s=600.0)
    t0 = time.time()
    value, resume_epoch, counts, n_eval = run_with_restarts(
        lambda: dist.run(mnist_killed_once, cfg, flag, stamp), max_restarts=1, backoff_s=0.0,
        on_restart=lambda n, e: restarts.append((time.time(), e)))
    t_result = time.time()
    steps_epoch = MNIST_CFG["train_samples"] // MNIST_CFG["batch_size"]
    check(value == "finished" and len(restarts) == 1 and os.path.exists(stamp),
          f"(c) result {value!r}, restarts {[repr(e) for _, e in restarts]}")
    err = restarts[0][1]
    check(isinstance(err, DistributorError) and err.returncode == -9 and err.rank == 1,
          f"(c) the restart's error {err!r}: not rank 1's SIGKILL")
    check(resume_epoch == 1, f"(c) the relaunch resumed at epoch {resume_epoch}, not 1")
    want = {"normalize": 0, "cross_entropy_fwd": steps_epoch + n_eval,
            "cross_entropy_bwd": steps_epoch}
    check(counts == want, f"(c) rank 0's launches {counts}, expected {want}")
    detect_s = restarts[0][0] - float(Path(stamp).read_text())
    relaunch_s = t_result - restarts[0][0]

    _, err_tail = proc.communicate(timeout=300)
    with open(result, "rb") as f:
        outcome = pickle.load(f)
    check(proc.returncode == PREEMPTED_EXIT and isinstance(outcome["error"], Preempted)
          and outcome["error"].step == 7,
          f"(c) the preempted worker exited {proc.returncode}: {err_tail[-500:]!r}")
    log(f"  (c) example 01 on 2 gloo ranks, rank 1 SIGKILLed before step "
        f"{MNIST_KILL_STEP + 1}: detected {detect_s:.2f} s after the kill (exit -9), one "
        f"RETRYABLE restart, relaunch to the result {relaunch_s:.2f} s (resumed from the "
        f"epoch-1 checkpoint), {t_result - t0:.2f} s in all; rank 0's launches {counts}; a "
        f"worker raising Preempted exits {proc.returncode} on {card}")
    return {"detect_s": detect_s, "relaunch_to_result_s": relaunch_s,
            "total_s": t_result - t0, "launches": counts, "preempted_exit": proc.returncode}


def fault_divergence_part(card: str, root: Path, dev: torch.device, image_size: int = 224,
                          batch_size: int = RES_FAULT_BATCH, workers: int = 8) -> dict:
    """Phase 19 (d): ResNet50-1K fit on f32 host batches, a NaN window of
    three batches against ``max_bad=2``: skipped steps, ``Divergence``, the
    rollback to the last healthy step, the next attempt at lr_scale 0.5."""
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.fault import (
        ChaosPlan,
        HealthPolicy,
        NaNAt,
        RestartPolicy,
        Supervisor,
        recovery_directive,
    )
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import Callback, Trainer

    directory = str(root / "resnet_d")
    seen = {"resumed": [], "scale": []}

    class Probe(Callback):
        def on_fit_start(self, trainer):
            seen["resumed"].append(trainer.state.step)
            seen["scale"].append(recovery_directive().lr_scale)

    def attempt():
        model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
        # float32 host batches: NaNAt poisons them before the copy (uint8 cannot)
        loader = DataLoader(SyntheticImageDataset(n=batch_size * 4, image_size=image_size,
                                                  num_classes=1000, seed=1),
                            batch_size, shuffle=True, seed=0, transfer_dtype="float32",
                            num_workers=workers)
        tr = Trainer(model, train_dataloader=loader, optimizer="sgd", lr=RES_FAULT_LR,
                     precision="bf16", normalize=(MEAN, STD), max_duration="2ep",
                     log_interval=0, eval_interval=0, checkpointer=Checkpointer(directory),
                     checkpoint_interval_batches=2, callbacks=[Probe()],
                     health=HealthPolicy(window=4, max_bad=2, warmup_steps=2, lr_backoff=0.5))
        return tr, tr.fit()

    tele = get_telemetry()
    plan = ChaosPlan([NaNAt(step=5, times=3)])  # the batches of steps 6, 7 and 8
    sup = Supervisor(RestartPolicy(max_restarts=0, max_divergences=1, backoff_base_s=0.0),
                     checkpoint_dir=directory)
    counters = _zeroed(_k12())
    token = _mark(tele)
    t0 = time.perf_counter()
    with plan.active():
        tr, res = sup.run(attempt)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts(counters)
    me = threading.current_thread().name  # (c) and (e) run beside this part
    events = [e for e in _since(tele, token) if e.get("thread") == me]
    names = [e.get("name") for e in events]
    rollbacks = [e for e in events if e.get("name") == "fault/rollback"]
    steps = 8 + 4  # attempt 1 to its divergence at step 8, attempt 2 from step 4
    expected = {n: steps for n in launches}
    finite = all(bool(torch.isfinite(p).all()) for p in tr.model.parameters())
    check(sup.divergences == 1 and seen["resumed"] == [0, 4] and seen["scale"] == [1.0, 0.5]
          and tr.state.step == 8 and res.error is None and finite,
          f"(d) divergences {sup.divergences}, attempts from {seen['resumed']} at lr_scale "
          f"{seen['scale']}, ended at step {tr.state.step}, parameters finite {finite}")
    check("health/bad_step" in names and "health/divergence" in names
          and len(rollbacks) == 1 and rollbacks[0]["quarantined"] == [6],
          f"(d) events {sorted(set(names))}, rollbacks {rollbacks}")
    check(launches == expected, f"(d) launches {launches}, expected {expected}")
    log(f"  (d) ResNet50-1K, batch {batch_size} f32 host batches, NaN in the batches of "
        f"steps 6-8: skipped, Divergence at step 8, rolled back to step 4 (the snapshot of "
        f"step 6 quarantined), re-entered at lr_scale 0.5 and completed {tr.state.step} "
        f"steps with finite parameters in {wall:.2f} s; launches {launches} on {card}")
    return {"supervised_s": wall, "launches": launches}


def elastic_worker(plan, ckpt_dir: str, out_dir: str, lose: bool, image_size: int,
                   batch_size: int):
    """Worker side of (e): ResNet50-1K under ZeRO-1 with AdamW over
    ``plan``, counted; on the first attempt the epoch-end checkpoint of step
    4 read back at this world and digested, and ``LoseRank(1)`` before step
    6.  Rank 0 writes its counts (and the digest) under ``out_dir``."""
    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.core import initialize
    from tpuframe_torch.core.runtime import MeshSpec
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.fault import ChaosPlan, LoseRank
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import Callback, Trainer, create_train_state

    rt = initialize(MeshSpec.from_mesh(plan.mesh))
    world, seen = rt.process_count, {}

    def model(seed):
        return ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=rt.device,
                        seed=seed)

    class Rec(Callback):
        def on_fit_start(self, trainer):
            seen["resume_step"] = trainer.state.step
            seen["digest"] = _state_digest(trainer.state)

        def on_epoch_start(self, trainer, epoch):
            if lose and epoch == 1:  # after the epoch-end save of step 4
                template = create_train_state(model(9), fused_adamw(1e-3), plan=plan, seed=9)
                Checkpointer(ckpt_dir).restore(template, step=4, plan=plan)
                ref = _state_digest(template)
                if rt.is_main:
                    Path(out_dir, "boundary.json").write_text(json.dumps(
                        {"digest": ref, "world": world}))

    loader = DataLoader(SyntheticImageDataset(n=batch_size * 4, image_size=image_size,
                                              num_classes=1000, seed=1),
                        batch_size, shuffle=True, seed=0, transfer_dtype="uint8")
    tr = Trainer(model(0), tx=fused_adamw(1e-3), train_dataloader=loader, plan=plan,
                 precision="bf16", normalize=(MEAN, STD), max_duration="2ep", log_interval=0,
                 eval_interval=0, checkpointer=Checkpointer(ckpt_dir), callbacks=[Rec()])
    tele = get_telemetry()
    token = _mark(tele)
    counters = _zeroed(_fault_counters())
    try:
        with ChaosPlan([LoseRank(1, ELASTIC_LOSE_STEP)] if lose else []).active():
            tr.fit()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        if rt.is_main:
            Path(out_dir, f"world{world}.json").write_text(json.dumps(_counts(counters)))
    restores = _since(tele, token, "ckpt/restore")
    return {"resume_step": seen["resume_step"], "digest": seen["digest"],
            "step": tr.state.step, "world": world,
            "reshards": len(_since(tele, token, "fault/reshard")),
            "restore_s": float(restores[0]["dur_s"]) if restores else None,
            "finite": all(bool(torch.isfinite(p).all()) for p in tr.model.parameters())}


def fault_elastic_part(card: str, root: Path, simulate: int | None = None,
                       image_size: int = 224, batch_size: int = RES_FAULT_BATCH) -> dict:
    """Phase 19 (e): ``run_elastic(min_world_size=1)`` over two gloo ranks of
    the card, ZeRO-1 over ``fsdp``, rank 1 lost mid-epoch: worlds [2, 1]."""
    from tpuframe_torch.core.runtime import MeshSpec
    from tpuframe_torch.fault import RestartPolicy
    from tpuframe_torch.launch import Distributor, run_elastic
    from tpuframe_torch.parallel import ParallelPlan
    from tpuframe_torch.track.telemetry import get_telemetry

    ckpt_dir, out_dir = str(root / "elastic"), root / "elastic_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    plan2 = ParallelPlan(mesh=MeshSpec(data=1, fsdp=2).build(2), zero_stage=1)
    worlds, spawn_s = [], []

    def train(ctx):
        worlds.append(ctx.world_size)
        t0 = time.perf_counter()
        try:
            return Distributor(num_processes=ctx.world_size, simulate_devices=simulate,
                               timeout_s=600.0).run(
                elastic_worker, ctx.plan, ckpt_dir, str(out_dir), ctx.attempt == 1,
                image_size, batch_size)
        finally:
            spawn_s.append(time.perf_counter() - t0)

    # counters and the directory, not the event window: (a, b), (d) and (f)
    # fill that window from the main thread meanwhile; only this part
    # resizes a world
    resizes = get_telemetry().registry.counter("fault/world_resizes")
    resizes0 = resizes.value
    t0 = time.perf_counter()
    got = run_elastic(train, plan=plan2, elastic_axis="fsdp", checkpoint_dir=ckpt_dir,
                      policy=RestartPolicy(max_restarts=1, backoff_base_s=0.0),
                      min_world_size=1)
    wall = time.perf_counter() - t0
    resized = int(resizes.value - resizes0)
    quarantined = [d for d in (ckpt_dir, ckpt_dir + "_intra")
                   if os.path.isdir(os.path.join(d, "_quarantine"))]
    boundary = json.loads((out_dir / "boundary.json").read_text())
    counts = {w: json.loads((out_dir / f"world{w}.json").read_text()) for w in (2, 1)}
    check(worlds == [2, 1] and resized == 1 and not quarantined,
          f"(e) worlds {worlds}, {resized} resizes, quarantines under {quarantined}")
    check(got["world"] == 1 and got["resume_step"] == 4 and got["step"] == 8
          and got["reshards"] >= 1 and got["finite"],
          f"(e) the world-1 attempt: {got}")
    check(boundary["world"] == 2 and got["digest"] == boundary["digest"],
          "(e) the state restored at world 1 differs from the snapshot read back at two ranks")
    want = {2: ELASTIC_LOSE_STEP, 1: 8 - 4}
    for w, n in want.items():
        expected = {"normalize": n, "cross_entropy_fwd": n, "cross_entropy_bwd": n,
                    "layer_norm_fwd": 0, "layer_norm_bwd": 0, "fused_adamw": n}
        check(counts[w] == expected, f"(e) world {w} rank 0's launches {counts[w]}, "
              f"expected {expected}")
    log(f"  (e) ResNet50-1K, ZeRO-1 over fsdp, AdamW (K4 on the owned slices), global batch "
        f"{batch_size}: rank 1 lost before step {ELASTIC_LOSE_STEP + 1}, worlds {worlds}, one "
        f"fault/world_resized, {got['reshards']} fault/reshard, no quarantine; the restore at "
        f"world 1 ({got['restore_s']:.3f} s) bit-equal to the snapshot read back at two ranks; "
        f"{got['step']} steps; attempts {[round(s, 2) for s in spawn_s]} s from launch to end, "
        f"{wall:.2f} s in all; rank 0's launches {counts} on {card}")
    return {"reshard_restore_s": got["restore_s"], "attempt_s": spawn_s, "total_s": wall,
            "launches": counts}


def fault_serve_part(card: str, dev: torch.device, model=None, image_size: int = 224) -> dict:
    """Phase 19 (f): ResNet50-1K behind ``ServeEngine`` (bf16, K1, float32
    requests) under a QueueFlood, a PoisonRequest, a SlowConsumer under the
    serve watchdog, and a drain through ``run_forever``."""
    from tpuframe_torch.fault import ChaosPlan, PoisonRequest, QueueFlood, SlowConsumer
    from tpuframe_torch.fault import preempt
    from tpuframe_torch.models import ResNet50, from_jax_variables, import_torch_resnet
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.parallel import align_model_dtype, bf16_compute
    from tpuframe_torch.serve import (
        InvalidRequest,
        RequestRejected,
        RequestShed,
        ServeEngine,
        ServeKnobs,
        ServingServer,
    )
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.track.watchdog import Watchdog
    from tpuframe_torch.train import make_predict_fn

    if model is None:
        model = ResNet50(num_classes=1000, device=dev)
        model.load_state_dict(from_jax_variables(
            random_jax_variables(import_torch_resnet(model.state_dict()), seed=0)))
    policy = bf16_compute()
    align_model_dtype(model, policy)
    predict = make_predict_fn(policy, functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=policy.compute_dtype))
    engine = ServeEngine(functools.partial(predict, model),
                         knobs=ServeKnobs(buckets=BUCKETS, slo_ms=500.0, queue_cap=64,
                                          shed_policy="shed-oldest", batch_wait_ms=20.0,
                                          watchdog_s=0.25),
                         item_shape=(image_size, image_size, 3), dtype="float32", device=dev)
    tele = get_telemetry()
    reg = tele.registry
    rng = np.random.default_rng(5)

    def request():
        return rng.uniform(0, 255, (image_size, image_size, 3)).astype(np.float32)

    watcher = preempt.install(signals=())  # run_forever's; no signal trapped here
    engine.start()
    counters = _zeroed({"normalize": normalize_images})
    batches0, shed0 = reg.counter("serve/batches").value, reg.counter("serve/shed").value
    out: dict = {"card": card}
    try:
        # QueueFlood: sheds fire, the admitted p99 within the SLO tracker's target
        target_ms = engine._slo.objectives.p99_ms
        plan = ChaosPlan([QueueFlood(SERVE_FLOOD, step=3)])
        lats = []
        with plan.active():
            for _ in range(40):
                try:
                    f = engine.submit(request())
                    f.result(timeout=120)
                except (RequestRejected, RequestShed):
                    continue
                lats.append(f.latency_s)
        lats.sort()
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))] * 1e3 if lats else float("inf")
        shed = reg.counter("serve/shed").value - shed0
        check(plan.fired_count() == 1 and shed > 0 and len(lats) > 0 and p99 <= target_ms,
              f"(f) flood: fired {plan.fired_count()}, {shed} shed, {len(lats)} of 40 served, "
              f"p99 {p99:.1f} ms against {target_ms} ms")
        out["flood"] = {"shed": shed, "served": len(lats), "p99_ms": p99,
                        "target_ms": target_ms}

        # PoisonRequest (the first submit under the plan): rejected at the
        # door, its seven batchmates bit-equal to a clean run of the seven
        xs = [request() for _ in range(8)]
        clean_xs = [x.copy() for x in xs[1:]]
        with ChaosPlan([PoisonRequest()]).active():
            futs, rejected = {}, []
            for i, x in enumerate(xs):
                try:
                    futs[i] = engine.submit(x)
                except InvalidRequest:
                    rejected.append(i)
            poisoned = {i: f.result(timeout=120) for i, f in futs.items()}
        clean = [f.result(timeout=120) for f in [engine.submit(x) for x in clean_xs]]
        same = all(torch.equal(a, b) for a, b in zip(poisoned.values(), clean))
        check(rejected == [0] and same and all(bool(torch.isfinite(v).all())
                                               for v in poisoned.values()),
              f"(f) poison: rejected {rejected}, batchmates bit-equal to the clean run {same}")

        # SlowConsumer past the serve/infer lease: the watchdog reports it
        wd = tele.attach_watchdog(Watchdog(deadlines={"serve/infer": 0.25},
                                           poll_interval_s=0.05))
        try:
            with ChaosPlan([SlowConsumer(stall_s=1.0)]).active():
                engine.submit(request()).result(timeout=120)
            stalls = [r for r in wd.reports if r["name"] == "serve/infer"]
        finally:
            wd.stop()
            tele.watchdog = None
        check(len(stalls) >= 1, f"(f) slow consumer: watchdog reports {list(wd.reports)}")

        # a watcher's notice through run_forever: zero dropped in-flight requests
        server = ServingServer(engine)
        runner = threading.Thread(target=server.run_forever, kwargs={"poll_s": 0.05},
                                  daemon=True)
        inflight = [engine.submit(request()) for _ in range(24)]
        runner.start()
        watcher.request("drain")
        runner.join(timeout=300)
        verdicts = [f.verdict for f in inflight]
        check(not runner.is_alive() and engine.draining and verdicts == ["ok"] * 24,
              f"(f) drain: run_forever returned {not runner.is_alive()}, verdicts {verdicts}")
    finally:
        engine.stop()
        preempt.uninstall()
    batches = int(reg.counter("serve/batches").value - batches0)
    launches = _counts(counters)
    check(launches == {"normalize": batches},
          f"(f) launches {launches} for {batches} served batches")
    out.update(launches=launches, batches=batches)
    log(f"  (f) ResNet50-1K serve, f32 requests: a flood of {SERVE_FLOOD} shed {shed:.0f}, "
        f"the clients' p99 {p99:.1f} ms within the SLO's {target_ms:.0f} ms; the poisoned "
        f"request rejected, its 7 batchmates bit-equal to a clean run; a 1 s slow consumer "
        f"reported by the serve watchdog ({len(stalls)} report); run_forever drained 24 "
        f"in-flight requests, none dropped; {batches} batches, launches {launches} on {card}")
    return out


def fault_phase(card: str, dev: torch.device = torch.device("cuda"), cfg: dict = LM,
                batch_size: int = LM_BATCH, image_size: int = 224,
                res_batch: int = RES_FAULT_BATCH, simulate: int | None = None,
                workers: int = 4, serve_model=None) -> dict:
    """Phase 19: fault tolerance on one card (module docstring).  Scratch
    under ``build/tpuframe_torch/fault_smoke/``, removed at the end.  The
    device and sizes are arguments so the phase can be rehearsed small on
    the CPU (``simulate=1`` puts the launcher's workers there)."""
    from tpuframe_torch.ops.build import BUILD_DIR

    root = BUILD_DIR / "fault_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    seconds, out = {}, {"card": card}

    def timed(part, fn):
        t0 = time.perf_counter()
        out[part] = fn()
        seconds[part] = time.perf_counter() - t0
        log(f"  ({part}) in {seconds[part]:.1f} s")

    try:
        # (c) and (e) are their launchers' workers, which spend most of their
        # time starting on the host's cores: they run from threads beside
        # (a, b), (d) and (f), which wait on the card and the disk
        failed: list[BaseException] = []

        def beside(part, fn):
            try:
                timed(part, fn)
            except BaseException as e:  # re-raised on this thread below
                failed.append(e)

        threads = [threading.Thread(target=beside, name=f"fault-phase-{part}", args=(part, fn))
                   for part, fn in (("c", lambda: fault_mnist_part(card, root, simulate)),
                                    ("e", lambda: fault_elastic_part(card, root, simulate,
                                                                     image_size, res_batch)))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        try:
            for part, fn in (("a, b", lambda: fault_lm_parts(card, root, dev, cfg, batch_size,
                                                              workers)),
                             ("d", lambda: fault_divergence_part(card, root, dev, image_size,
                                                                 res_batch, 2 * workers)),
                             ("f", lambda: fault_serve_part(card, dev, serve_model,
                                                            image_size))):
                timed(part, fn)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            for t in threads:
                t.join()
        seconds["all parts"] = time.perf_counter() - t0
        if failed:
            raise failed[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = seconds
    log("  fault_json " + json.dumps(out, default=str))
    return out


REMOTE_RUN_ID = ("0123456789abcdef" * 7)[:100]  # (a): past the process group's 64 bytes
REMOTE_HB_TIMEOUT_S = 3.0  # (d): a silent beacon this long is a lost rank
#: (d): a transport that lives on for a minute after its agent has exited,
#: as an ssh client can; the agent runs as its child, stdio inherited
LINGERING_TRANSPORT = ("import subprocess, sys, time\n"
                       "rc = subprocess.call(sys.argv[1:])\n"
                       "time.sleep(60)\n"
                       "sys.exit(rc)\n")


def remote_contract(run_id: str) -> dict:
    """Worker side of 20(a): the env contract as this agent sees it, its
    runtime, a gloo all-reduce, then the control plane's barrier,
    allgather and broadcast and ``broadcast_run_id`` across the agents."""
    import torch.distributed as dist

    from tpuframe_torch.core import initialize
    from tpuframe_torch.core.native import control_plane
    from tpuframe_torch.track import broadcast_run_id

    rt = initialize()
    x = torch.full((4,), float(rt.process_index + 1), device=rt.device)
    dist.all_reduce(x)
    cp = control_plane()
    cp.barrier()
    mine = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                                           "WORLD_SIZE", "TPUFRAME_HB_PORT")}
    mine.update(device=str(rt.device), backend=dist.get_backend(), sum=x.cpu().tolist(),
                pycache_prefix=sys.pycache_prefix)
    ranks = [json.loads(b) for b in cp.allgather_bytes(json.dumps(mine).encode())]
    token = cp.broadcast_bytes(os.urandom(32) if rt.process_index == 0 else None)
    got = broadcast_run_id(run_id if rt.is_main else None)
    agree = cp.allgather_bytes(token + got.encode())
    cp.barrier()
    return {"ranks": ranks, "agree": len(set(agree)) == 1 and len(token) == 32, "run_id": got}


def remote_mnist(cfg: dict) -> dict:
    """Worker side of 20(b): example 01's ``train_mnist`` with K2 counted,
    its first step's loss and its final eval summary recorded."""
    mod = _example("01_distributor_mnist")
    first, summaries = [], []
    real_step, real_summarize = mod.make_train_step, mod.summarize_metrics

    def make_train_step(**kw):
        step = real_step(**kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            if not first:
                first.append(float(metrics["loss_sum"]) / float(metrics["count"]))
            return state, metrics

        return recorded

    def summarize(acc, prefix=""):
        out = real_summarize(acc, prefix)
        summaries.append(dict(out))
        return out

    mod.make_train_step, mod.summarize_metrics = make_train_step, summarize
    try:
        value, counts = counted_call(_k12, "01_distributor_mnist", "train_mnist", cfg)
    finally:
        mod.make_train_step, mod.summarize_metrics = real_step, real_summarize
    return {"value": value, "counts": counts, "first_loss": first[0],
            "test": [s for s in summaries if "test_loss" in s][-1]}


def remote_raise():
    """Worker side of 20(c): rank 1 raises."""
    if os.environ["RANK"] == "1":
        print("rank 1 raises on purpose", file=sys.stderr)
        raise ValueError("planted failure on rank 1")
    return "ok"


def remote_hang(started: str):
    """Worker side of 20(d): says it has started, then hangs."""
    Path(started).write_text("hanging")
    time.sleep(120)


def remote_killed(stamp: str):
    """Worker side of 20(d): rank 1 SIGKILLs itself once its beacon was
    heard (the kill's time in ``stamp``); rank 0 hangs."""
    import signal

    if os.environ["RANK"] == "1":
        time.sleep(2.0)
        Path(stamp).write_text(repr(time.time()))
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(120)


def remote_checkpoint_part(card: str, root: Path, dev: torch.device) -> dict:
    """20(e): ROADMAP Queue 3 item 29 on the card: one failed write inside
    DCP, one retry, the step committed and read back."""
    from torch.distributed.checkpoint.filesystem import FileSystemWriter

    from tpuframe_torch.ckpt import Checkpointer
    from tpuframe_torch.track.telemetry import get_telemetry

    real, calls = FileSystemWriter.write_data, []

    def flaky(self, plan, planner):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("planted write failure")
        return real(self, plan, planner)

    counter = get_telemetry().registry.counter("ckpt/save_retries")
    before = counter.value
    state = {"w": torch.arange(1 << 20, dtype=torch.float32, device=dev)}
    t0 = time.perf_counter()
    with mock.patch.object(FileSystemWriter, "write_data", flaky), \
            Checkpointer(str(root / "retry_ck")) as ck:
        ck.save(state, step=3)
        steps = ck.all_steps()
        back, _ = ck.restore({"w": torch.zeros_like(state["w"])})
    save_s = time.perf_counter() - t0
    retries = counter.value - before
    check(retries == 1 and len(calls) == 2 and steps == [3] and torch.equal(back["w"], state["w"]),
          f"(e) retries {retries}, writes {len(calls)}, steps {steps}")
    log(f"  (e) a save whose write failed once inside DCP: {retries} retry, committed step "
        f"{steps}, read back bit-equal, {save_s:.2f} s with the backoff on {card}")
    return {"retries": retries, "writes": len(calls), "seconds": save_s}


@contextlib.contextmanager
def remote_launches(card: str, simulate: int | None = None):
    """Phase 20's launches, (a) to (d), each on a thread of its own while
    the body of the ``with`` runs (phase 19 in the script: the launches
    spend their time starting processes on the host's cores).  Yields the
    dict their results land in, with ``root``, the phase's scratch under
    ``build/tpuframe_torch/remote_smoke/``, removed at the end; a part's
    failure is raised when the block ends.  ``simulate=1`` puts every
    worker on the CPU, for a rehearsal."""
    import cloudpickle

    from tpuframe_torch.launch import (
        Distributor,
        RemoteDistributor,
        RemoteLaunchError,
        WorkerLostError,
    )
    from tpuframe_torch.launch.agent import ORPHANED_EXIT
    from tpuframe_torch.ops.build import BUILD_DIR

    root = BUILD_DIR / "remote_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    seconds, failed = {}, []
    out = {"card": card, "root": root, "seconds": seconds}
    want_dev = "cpu" if simulate else "cuda:0"

    def remote(**kw):
        kw.setdefault("connect", lambda host: [])
        return RemoteDistributor(["localhost", "localhost"], remote_python=sys.executable,
                                 simulate_devices=simulate, timeout_s=300.0, **kw)

    def mnist_cfg(run: str) -> dict:
        return {**MNIST_CFG, "tracking_uri": str(root / run / "mlruns"),
                "ckpt_dir": str(root / run / "ckpt")}

    def part_a():
        r = remote().run(remote_contract, REMOTE_RUN_ID)
        ranks = r["ranks"]
        check([(x["RANK"], x["LOCAL_RANK"], x["LOCAL_WORLD_SIZE"]) for x in ranks]
              == [("0", "0", "2"), ("1", "1", "2")], f"(a) the env contract {ranks}")
        check(all(x["backend"] == "gloo" and x["device"] == want_dev and x["sum"] == [3.0] * 4
                  and x["TPUFRAME_HB_PORT"] for x in ranks), f"(a) the runtimes {ranks}")
        check(all(x["pycache_prefix"] == sys.pycache_prefix for x in ranks),
              f"(a) the agents' bytecode prefix {[x['pycache_prefix'] for x in ranks]}, not "
              f"{sys.pycache_prefix}")
        check(r["agree"] and r["run_id"] == REMOTE_RUN_ID,
              f"(a) the control plane: agree {r['agree']}, run id {r['run_id']!r}")
        return {"ranks": ranks}

    def part_b(launcher: str, run: str):
        cfg = mnist_cfg(run)
        t0 = time.perf_counter()
        if launcher == "remote":
            r = remote().run(remote_mnist, cfg)
        else:
            r = Distributor(num_processes=2, simulate_devices=simulate,
                            timeout_s=300.0).run(remote_mnist, cfg)
        r["spawn_to_result_s"] = time.perf_counter() - t0
        check(r["value"] == "finished", f"(b) {run}: {r['value']!r}")
        return r

    def part_c():
        t0 = time.perf_counter()
        try:
            remote().run(remote_raise)
        except ValueError as e:
            cause = e.__cause__
            check(str(e) == "planted failure on rank 1" and isinstance(cause, RemoteLaunchError)
                  and cause.host == "localhost" and cause.rank == 1
                  and "rank 1 raises on purpose" in cause.stderr_tail,
                  f"(c) the failure {e!r} with cause {cause!r}")
            return {"seconds": time.perf_counter() - t0, "exit": cause.returncode}
        raise RuntimeError("chip_smoke check failed: (c) rank 1's exception did not surface")

    def part_d_kill():
        stamp = root / "killed_at"
        wrapper = [sys.executable, "-c", LINGERING_TRANSPORT]
        t0 = time.perf_counter()
        try:
            remote(connect=lambda host: list(wrapper),
                   heartbeat_timeout_s=REMOTE_HB_TIMEOUT_S).run(remote_killed, str(stamp))
        except WorkerLostError as e:
            raised = time.time()
            check(e.rank == 1 and stamp.exists(), f"(d) lost {e!r}, stamp {stamp.exists()}")
            # found after silent_s of silence; raised once its peers' grace ran out
            return {"silent_s": e.silent_s, "raised_s": raised - float(stamp.read_text()),
                    "total_s": time.perf_counter() - t0}
        raise RuntimeError("chip_smoke check failed: (d) the killed agent was not found")

    def part_d_orphan():
        started = root / "orphan_started"
        payload = cloudpickle.dumps((remote_hang, (str(started),), {}))
        header = json.dumps({"payload_bytes": len(payload), "env": {}}).encode() + b"\n"
        p = subprocess.Popen([sys.executable, "-u", "-m", "tpuframe_torch.launch.agent"],
                             stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL, env={**os.environ, "PYTHONPATH": (
                                 os.pathsep.join(p for p in sys.path if p))})
        try:
            p.stdin.write(header + payload)
            p.stdin.flush()
            deadline = time.monotonic() + 120
            while not started.exists() and p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.1)  # the fn hangs: the watchdog is armed
            check(started.exists(), f"(d) the orphan's fn never started (exit {p.poll()})")
            t0 = time.perf_counter()
            p.stdin.close()
            code = p.wait(timeout=20)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        exit_s = time.perf_counter() - t0
        check(code == ORPHANED_EXIT, f"(d) the orphaned agent exited {code}")
        return {"exit": code, "exit_s": exit_s}

    def timed(part, fn):
        t0 = time.perf_counter()
        try:
            out[part] = fn()
        except BaseException as e:  # raised on the main thread when the block ends
            failed.append(e)
        seconds[part] = time.perf_counter() - t0

    launches = [("a", part_a), ("b remote", lambda: part_b("remote", "remote")),
                ("b local 1", lambda: part_b("local", "local1")),
                ("b local 2", lambda: part_b("local", "local2")), ("c", part_c),
                ("d kill", part_d_kill), ("d orphan", part_d_orphan)]
    threads = [threading.Thread(target=timed, args=(part, fn), name=f"remote-phase-{part}")
               for part, fn in launches]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        yield out
    finally:
        for t in threads:
            t.join()
        seconds["all launches"] = time.perf_counter() - t0
        shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise failed[0]


def remote_report(card: str, out: dict) -> dict:
    """Phase 20's gates across its parts (the remote run against the two
    local ones), and its log lines; returns ``out``."""
    rb, l1, l2 = out["b remote"], out["b local 1"], out["b local 2"]
    check(rb["first_loss"] == l1["first_loss"] == l2["first_loss"],
          f"(b) first losses remote {rb['first_loss']!r}, local {l1['first_loss']!r} and "
          f"{l2['first_loss']!r}")
    for key in ("test_loss", "test_accuracy"):
        lo, hi = sorted((l1["test"][key], l2["test"][key]))
        gap = hi - lo
        check(lo - gap <= rb["test"][key] <= hi + gap,
              f"(b) the remote {key} {rb['test'][key]!r} outside the local runs' "
              f"[{lo!r}, {hi!r}] widened by their gap {gap!r}")
    check(rb["counts"] == l1["counts"] == l2["counts"]
          and rb["counts"]["cross_entropy_fwd"] > 0 and rb["counts"]["cross_entropy_bwd"] > 0,
          f"(b) K2 launches remote {rb['counts']}, local {l1['counts']} and {l2['counts']}")
    a, c, d, e = out["a"], out["c"], out["d kill"], out["d orphan"]
    log(f"  (a) two agents on localhost: LOCAL_RANK 0/1, LOCAL_WORLD_SIZE 2, "
        f"{a['ranks'][0]['backend']} on {a['ranks'][0]['device']}, the control plane's barrier, "
        f"allgather and broadcast agree, the 100-byte run id back whole, bytecode under "
        f"{sys.pycache_prefix}; {out['seconds']['a']:.2f} s on {card}")
    log(f"  (b) example 01 (MNIST): first loss {rb['first_loss']!r} on all three runs; rank 0's "
        f"test loss remote {rb['test']['test_loss']!r}, local {l1['test']['test_loss']!r} and "
        f"{l2['test']['test_loss']!r}; accuracy {rb['test']['test_accuracy']!r}, "
        f"{l1['test']['test_accuracy']!r}, {l2['test']['test_accuracy']!r}; K2 launches "
        f"{rb['counts']} on each; spawn to result: remote {rb['spawn_to_result_s']:.2f} s, local "
        f"{l1['spawn_to_result_s']:.2f} and {l2['spawn_to_result_s']:.2f} s (the three at once) "
        f"on {card}")
    log(f"  (c) rank 1's ValueError surfaced as itself, its cause a RemoteLaunchError (host "
        f"'localhost', rank 1, exit {c['exit']}, its stderr tail) in {c['seconds']:.2f} s")
    log(f"  (d) an orphaned agent exited {e['exit']} {e['exit_s']:.2f} s after its stdin closed; "
        f"a SIGKILLed agent behind a lingering transport was found by its silent beacon after "
        f"{d['silent_s']:.2f} s of silence (heartbeat timeout {REMOTE_HB_TIMEOUT_S} s), the run "
        f"raised WorkerLostError {d['raised_s']:.2f} s after the kill (its peers' 5 s grace "
        f"included), {d['total_s']:.2f} s from spawn on {card}")
    log(f"  phase 20's launches on threads: {json.dumps(out['seconds'], default=str)}")
    log("  remote_json " + json.dumps(out, default=str))
    return out


def remote_phase(card: str, dev: torch.device = torch.device("cuda"),
                 simulate: int | None = None) -> dict:
    """Phase 20 alone (module docstring): the launches, then (e), then the
    gates."""
    with remote_launches(card, simulate) as out:
        t0 = time.perf_counter()
        out["e"] = remote_checkpoint_part(card, out["root"], dev)
        out["seconds"]["e"] = time.perf_counter() - t0
    return remote_report(card, out)


# -- phase 21: the compile plane -------------------------------------------------

COMPILE_DIR = Path(__file__).resolve().parent / "build" / "tpuframe_torch" / "compile_smoke"
COMPILE_TIMED = 30  # synced steps of each arm, in three turns of ten
COMPILE_TURNS = 3
COMPILE_F32_BATCH = 16  # the f32 check of path (B): ResNet50 at 224 px
COMPILE_LM_F32 = dict(LM, num_layers=2, max_len=256)  # the f32 check of path (C): 2 layers
COMPILE_LM_F32_BATCH = 4
COMPILE_LOSS_RTOL = 1e-5
# Inductor fuses the model region's elementwise work and sums in its own
# order: the update of the f32 LM step is held within 1e-3 of its largest
# element (phase 17's rule for a changed order of sums), the ResNet50
# update as ROADMAP difference 2 holds a changed order (3e-2 of its norm)
COMPILE_LM_UPDATE_RTOL = 1e-3
COMPILE_LM_WARMUP = 4  # the warmup-cosine schedule of path (C)
COMPILE_LM_F32_INIT_LR = 3e-5  # the f32 pair's schedule starts here, not at 0
#: the parts of phase 21, each in a fresh process with the cache named (a
#: fresh directory, so its first user is cold); the parts of a stage run at
#: once, the stages in this order, sharing the host's cores
#: (COMPILE_THREADS each): the three parts of cold compiles alone; then
#: (c) and (f), each a cold compile then its timed steps; then (g)'s cold
#: compile beside the warm-cache parts (b) and (d).  Timed steps hold
#: ``card_timing``
COMPILE_STAGES = ((("e cold", "train"), ("a cold", "serve"), ("f32", "f32")),
                  (("c", "lm"), ("f", "long")),
                  (("g", "moe"), ("e warm, b", "train"), ("a warm, d", "serve")))
COMPILE_THREADS = 4
#: the niceness of phase 21's processes and of phase 3's card tests, which
#: run beside the main thread's phases 4 to 20: the host's cores go to the
#: main thread first, the long pole of the script (PERF.md §6)
SIDE_NICE = 5
#: phase 21's live processes, killed at exit whatever ended the script
_COMPILE_PROCS: list = []
COMPILE_TIMING_LOCK = COMPILE_DIR.parent / "card_timing.lock"


def _kill_compile_procs() -> None:
    for proc in _COMPILE_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


atexit.register(_kill_compile_procs)


@contextlib.contextmanager
def card_timing():
    """The card's timing lock, across processes (``flock`` on a file under
    ``build/``): phase 18(e) and phase 21's timed parts hold it, so none of
    them times kernels or steps while another's run."""
    import fcntl

    COMPILE_TIMING_LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(COMPILE_TIMING_LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile_registry() -> dict:
    from tpuframe_torch.track.telemetry import get_telemetry

    snap = get_telemetry().registry.snapshot()
    return {k: snap.get(f"compile/{k}", 0.0)
            for k in ("cache_hits", "cache_misses", "backend_compiles", "recompiles")}


def _res_trainer(dev, image_size: int, batch: int, steps: int, precompile: bool, callbacks=()):
    """Path (B): phase 5's ResNet50-1K Trainer (bf16, ``norm_dtype=bf16``,
    SGD lr 0.1 momentum 0.9, K1 normalizing on the card), no eval loader;
    returns it and the time just before its construction."""
    from tpuframe_torch.data import DataLoader, SyntheticImageDataset
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.train import Trainer

    model = ResNet50(num_classes=1000, norm_dtype=torch.bfloat16, device=dev, seed=0)
    train = DataLoader(SyntheticImageDataset(n=batch * steps, image_size=image_size,
                                             num_classes=1000, seed=1),
                       batch, shuffle=True, seed=0, transfer_dtype="uint8",
                       num_workers=8 if dev.type == "cuda" else 0)
    t0 = time.perf_counter()
    trainer = Trainer(model, train_dataloader=train, optimizer="sgd", lr=0.1, precision="bf16",
                      normalize=(MEAN, STD), max_duration=f"{steps}ba", log_interval=1,
                      callbacks=list(callbacks), precompile=precompile)
    return trainer, t0


def _train_executable(trainer, batch: dict):
    """The trainer's precompiled train step; ``batch`` cast in place to the
    dtypes of its signature (what the loader produces)."""
    from tpuframe_torch.compile.precompile import batch_signature

    ((sig, exe),) = [(s, e) for (kind, s), e in trainer._compiled.items() if kind == "train"]
    for k, _, dtype in sig:
        batch[k] = batch[k].to(getattr(torch, dtype))
    check((("train", batch_signature(batch)) in trainer._compiled),
          f"batch {batch_signature(batch)} is not the precompiled signature")
    return exe


def _turns(arms: dict, dev, timed: int = COMPILE_TIMED) -> dict:
    """Each arm's synced step times, ``timed`` of them in COMPILE_TURNS
    turns; median ms by arm."""
    times = {k: [] for k in arms}
    per = max(1, timed // COMPILE_TURNS)
    for _ in range(COMPILE_TURNS):
        for name, fn in arms.items():
            fn()  # one unsynced step settles the turn
            for _ in range(per):
                sync(dev)
                t0 = time.perf_counter()
                fn()
                sync(dev)
                times[name].append(time.perf_counter() - t0)
    return {k: statistics.median(v) * 1e3 for k, v in times.items()}


def _graphed_fit(trainer, dev, expected: dict, what: str, steps: int) -> dict:
    """The precompiled fit of ``steps`` steps: every step dispatchable, and
    on the card a replay of the train step's graph (its executable still
    dispatched, so no ``compile/aot_fallback``, and no recompile), the
    launches less the warm-up's equal to eager's."""
    from tpuframe_torch.compile.precompile import launch_counters

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    recompiles = _compile_registry()["recompiles"]
    t0 = time.perf_counter()
    result = trainer.fit()
    sync(dev)
    fit_s = time.perf_counter() - t0
    recompiles = _compile_registry()["recompiles"] - recompiles
    exes = [e for (kind, _), e in trainer._compiled.items() if kind == "train"]
    replays = exes[0].replays if len(exes) == 1 else None
    log(f"  {what}: the train executable replayed {replays} times in {steps} steps, "
        f"{recompiles:g} recompiles")
    check(replays == (steps if dev.type == "cuda" else 0) and recompiles == 0,
          f"{what}: train executables {len(exes)}, replays {replays} of {steps} steps, "
          f"recompiles {recompiles}")
    rep = trainer._precompile_report
    warm = {k: sum(s.get("warmup_launches", {}).get(k, 0) for s in rep["steps"])
            for k in counters}
    launches = {k: counters[k].launches for k in expected}
    graphed = {k: launches[k] - warm[k] for k in expected}
    log(f"  {what} precompiled fit in {fit_s:.2f} s: launches {launches}, the warm-up's "
        f"{ {k: warm[k] for k in expected} }, so the steps' {graphed} (eager's {expected}); "
        f"report {json.dumps(rep)}")
    check(graphed == expected, f"{what}: launches {graphed} != eager's {expected}")
    check(rep["steps"] and all(s.get("dispatchable") and s.get("graphed") == (dev.type == "cuda")
                               for s in rep["steps"]), f"{what}: not every step graphed: {rep}")
    check(all(math.isfinite(h["train_loss"]) for h in result.history), f"{what}: loss")
    return {"fit_s": fit_s, "launches": launches, "warmup_launches": warm, "graphed": graphed,
            "report": rep, "train_loss": result.history[-1]["train_loss"]}


def _part_train(mode: str, dev, card: str, image_size: int, batch: int, steps: int) -> dict:
    """(e) path (B)'s time to first step, from the Trainer's construction to
    the end of its first step: ``cold``, eager first (``ttfs_eager_s``),
    then with precompile on a cold cache; ``warm``, with precompile on the
    warm cache, then (b): the graphed fit, the graphed step against the
    eager one in turns, and their busy shares."""
    from tpuframe_torch.train import Callback

    def first_step(precompile: bool, n: int):
        first: dict = {}

        class FirstStep(Callback):
            def on_step_end(self, trainer):
                if "t" not in first:
                    sync(dev)
                    first["t"] = time.perf_counter()

        trainer, t0 = _res_trainer(dev, image_size, batch, n, precompile,
                                   callbacks=[FirstStep()])
        return trainer, t0, first

    res: dict = {}
    if mode == "cold":
        trainer, t0, first = first_step(False, 1)
        trainer.fit()
        res["ttfs_eager_s"] = first["t"] - t0
        del trainer
        trainer, t0, first = first_step(True, 1)
        trainer.fit()
        res["ttfs_s"] = first["t"] - t0
        res["report"] = trainer._precompile_report
        return res
    trainer, t0, first = first_step(True, steps)
    res["b"] = _graphed_fit(trainer, dev, {"normalize": steps, "cross_entropy_fwd": steps,
                                           "cross_entropy_bwd": steps}, "(b) ResNet50-1K",
                            steps)
    res["ttfs_s"] = first["t"] - t0
    rng = np.random.default_rng(3)
    xb = {"image": torch.from_numpy(rng.integers(0, 256, (batch, image_size, image_size, 3),
                                                 dtype=np.uint8)).to(dev),
          "label": torch.from_numpy(rng.integers(0, 1000, batch)).to(dev)}
    exe = _train_executable(trainer, xb)
    state, eager = trainer.state, trainer._train_step
    with card_timing():
        ms = _turns({"graphed": lambda: exe(state, xb), "eager": lambda: eager(state, xb)}, dev)
        if dev.type == "cuda":
            res["b"]["busy"] = {k: profile(fn, f"(b) {k} ResNet50 step of {batch}")
                                for k, fn in (("graphed", lambda: exe(state, xb)),
                                              ("eager", lambda: eager(state, xb)))}
    res["b"]["step_ms"] = ms
    res["b"]["memory"] = executable_memory_part(trainer, exe, state, xb, dev, card)
    log(f"  (b) ResNet50-1K train step of {batch} (bf16): graphed {ms['graphed']:.2f} ms = "
        f"{batch / ms['graphed'] * 1e3:.0f} img/s, eager {ms['eager']:.2f} ms = "
        f"{batch / ms['eager'] * 1e3:.0f} img/s (median of {COMPILE_TIMED} synced steps "
        f"each, in turns) on {card}")
    return res


def executable_memory_part(trainer, exe, state, xb: dict, dev, card: str) -> dict:
    """(f) of the track plane: the ``memory/executable`` record the
    Trainer's precompile made of the graphed train step (arguments: the
    state and the batch template; temporaries: the graph's private pool
    less the outputs), beside ``max_memory_allocated`` over three replays of it
    (a replay allocates nothing, so that counts the live tensors and not the
    pool) and the allocator's reserved bytes (the pool included)."""
    from tpuframe_torch.track.memory import executable_records

    recs = {k: v for k, v in executable_records().items() if k == exe.label}
    check(len(recs) == 1, f"(f) no memory/executable record of {exe.label}: "
          f"{sorted(executable_records())}")
    (rec,) = recs.values()
    peak = reserved = 0.0
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(3):
            exe(state, xb)
        sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        reserved = torch.cuda.memory_reserved(dev) / 2**20
    log(f"  (f) memory/executable of {rec['label']!r}: arguments {rec['argument_mb']} MiB, "
        f"outputs {rec['output_mb']} MiB, temporaries {rec['temp_mb']} MiB, peak "
        f"{rec['peak_mb']} MiB ({rec['peak_source']}); three replays' max_memory_allocated "
        f"{peak:.1f} MiB, reserved {reserved:.1f} MiB on {card}")
    check(rec["peak_mb"] >= rec["argument_mb"] > 0 and (
        dev.type != "cuda" or rec["peak_source"] == "graph_pool"), f"(f) the record: {rec}")
    return {"record": rec, "replay_peak_mb": peak, "reserved_mb": reserved}


def _part_serve(mode: str, dev, card: str, serve_px: int) -> dict:
    """(a) path (A)'s precompile (ResNet50-1K bf16 behind ``ServeEngine``,
    every bucket), timed; after the warm one, (d): a burst of 160 through
    the precompiled engine against the eager engine, K1 once a served
    batch, the logits within the bf16 tolerance."""
    from tpuframe_torch.compile.precompile import launch_counters
    from tpuframe_torch.models import ResNet50
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.parallel import align_model_dtype, bf16_compute
    from tpuframe_torch.serve import ServeEngine, ServeKnobs
    from tpuframe_torch.track.telemetry import get_telemetry
    from tpuframe_torch.train import make_predict_fn

    model = ResNet50(num_classes=1000, device=dev, seed=0)
    policy = bf16_compute()
    align_model_dtype(model, policy)
    predict = make_predict_fn(policy, functools.partial(
        normalize_images, mean=MEAN, std=STD, out_dtype=policy.compute_dtype))
    images = np.random.default_rng(1).integers(0, 256, (N_REQUESTS, serve_px, serve_px, 3),
                                               dtype=np.uint8)
    counters = launch_counters()
    reg = get_telemetry().registry
    res: dict = {}
    served = {}
    for arm in (("precompiled", "eager") if mode == "warm" else ("precompiled",)):
        engine = ServeEngine(functools.partial(predict, model),
                             knobs=ServeKnobs(buckets=BUCKETS, slo_ms=60_000, queue_cap=1024,
                                              batch_wait_ms=5.0),
                             item_shape=(serve_px, serve_px, 3), dtype="uint8", device=dev,
                             precompile=arm == "precompiled")
        t0 = time.perf_counter()
        engine.start()
        start_s = time.perf_counter() - t0
        if arm == "precompiled":
            res["seconds"] = start_s
            res["graphed"] = {b: e.graphed for b, e in engine._executables.items()}
            check(set(engine._executables) == set(BUCKETS) and all(
                e.graphed == (dev.type == "cuda") for e in engine._executables.values()),
                f"(a) {mode}: buckets {res['graphed']}, not every one graphed")
        if mode != "warm":
            engine.stop()
            return res
        futures: dict = {}

        def client(c: int) -> None:
            for i in range(c, N_REQUESTS, N_CLIENTS):
                futures[i] = engine.submit(images[i])

        for fn in counters.values():
            fn.launches = 0
        batches0 = reg.counter("serve/batches").value
        with card_timing():
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            served[arm] = {i: f.result(timeout=600) for i, f in futures.items()}
            wall = time.perf_counter() - t0
            check(engine.drain(timeout=120), f"(d) {arm} engine did not drain")
        n_batches = int(reg.counter("serve/batches").value - batches0)
        k1 = counters["normalize"].launches
        lat = sorted(f.latency_s * 1e3 for f in futures.values())
        res[arm] = {"start_s": start_s, "req_per_s": N_REQUESTS / wall,
                    "p50_ms": lat[len(lat) // 2],
                    "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                    "batches": n_batches, "k1_launches": k1}
        check(k1 == n_batches > 0, f"(d) {arm}: K1 launched {k1} times for {n_batches} batches")
        engine.stop()
    worst = max(float((served["precompiled"][i] - served["eager"][i]).abs().max())
                / float(served["eager"][i].abs().max()) for i in range(N_REQUESTS))
    res["logits_rel"] = worst
    log(f"  (d) ResNet50-1K served, {N_REQUESTS} requests from {N_CLIENTS} clients: precompiled "
        f"{json.dumps(res['precompiled'])}, eager {json.dumps(res['eager'])}; logits max "
        f"|diff| / max|logit| {worst:.3g} (tol {BF16_REL_TOL}) on {card}")
    check(worst <= BF16_REL_TOL, f"(d) logits rel {worst} > {BF16_REL_TOL}")
    return res


def _part_lm(dev, card: str, lm_cfg: dict, lm_batch: int, lm_steps: int) -> dict:
    """(c) path (C): the GPT-2-small LM (``COMPILE_LM``) with ``fused_adamw``
    under a warmup-cosine schedule through ``Trainer.fit`` precompiled (cold cache),
    K4's device lr against the host float, then the graphed step against
    the eager one in turns (tokens/s, MFU, busy)."""
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.ops.fused_adamw import fused_adamw_multi_update_
    from tpuframe_torch.train import Trainer
    from tpuframe_torch.train.schedules import warmup_cosine

    seq, vocab = lm_cfg["max_len"], lm_cfg["vocab_size"]
    sched = warmup_cosine(3e-4, COMPILE_LM_WARMUP, lm_steps + 40)
    model = TransformerLM(**lm_cfg, device=dev, seed=0)
    train = DataLoader(NextTokenDataset(lm_batch * lm_steps, seq, vocab, seed=1), lm_batch,
                       shuffle=True, seed=0, num_workers=4 if dev.type == "cuda" else 0)
    trainer = Trainer(model, tx=fused_adamw(sched, weight_decay=1e-4), train_dataloader=train,
                      precision="bf16", max_duration=f"{lm_steps}ba", log_interval=1,
                      precompile=True)
    # the schedule's table for every step this part takes (the fit's, then
    # the timed ones of both arms): the graph keeps its address
    trainer.init_state().reserve_lr(lm_steps + 4 * COMPILE_TIMED)
    n_ln = 2 * lm_cfg["num_layers"] + 1
    res = _graphed_fit(trainer, dev, {"layer_norm_fwd": n_ln * lm_steps,
                                      "layer_norm_bwd": n_ln * lm_steps,
                                      "fused_adamw": lm_steps, "cross_entropy_fwd": 0},
                       "(c) GPT-2-small LM", lm_steps)
    state = trainer.state
    # K4's lr from the schedule's device table against the host float of the
    # same schedule at the same count, over the LM's tensors
    k = int(state.updates)
    gen = torch.Generator(device=dev).manual_seed(0)
    ps = [p.detach().clone() for p in state.model.parameters()]
    gs = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype) * 1e-2 for p in ps]
    copies = []
    for lr in (float(sched(k)), state._lr_table[torch.tensor(k, device=dev)]):
        cp = [p.clone() for p in ps]
        mm = [torch.full_like(p, 1e-3, dtype=torch.float32) for p in ps]
        vv = [torch.full_like(p, 1e-6, dtype=torch.float32) for p in ps]
        cs_ = [torch.full((), k + 1, dtype=torch.int32, device=dev) for _ in ps]
        fused_adamw_multi_update_(cp, gs, mm, vv, cs_, lr=lr, weight_decay=1e-4)
        copies.append(cp + mm + vv)
    same = all(torch.equal(a, b) for a, b in zip(*copies))
    res["k4_lr_bit_equal"] = same
    log(f"  (c) K4 with the device lr (table[{k}] = {float(state._lr_table[k]):.9g}) against "
        f"the host float {sched(k):.9g}, {len(ps)} tensors: bit-equal {same}")
    check(same, "(c) K4's device lr is not bit-equal to the host form")
    del ps, gs, copies
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, vocab, (lm_batch, seq + 1))).to(dev)
    xl = {"image": toks[:, :-1].contiguous(), "label": toks[:, 1:].contiguous()}
    exe = _train_executable(trainer, xl)
    eager = trainer._train_step
    with card_timing():
        ms = _turns({"graphed": lambda: exe(state, xl), "eager": lambda: eager(state, xl)}, dev)
        if dev.type == "cuda":
            res["busy"] = {k: profile(fn, f"(c) {k} LM step of {lm_batch}x{seq}")
                           for k, fn in (("graphed", lambda: exe(state, xl)),
                                         ("eager", lambda: eager(state, xl)))}
    tokens = lm_batch * seq
    flops = _lm_flops(state.model, lm_cfg, lm_batch)
    res["step_ms"] = ms
    res["mfu"] = {k: flops / (v / 1e3) / BF16_FLOPS for k, v in ms.items()}
    log(f"  (c) LM train step of {lm_batch}x{seq}: graphed {ms['graphed']:.2f} ms = "
        f"{tokens / ms['graphed'] * 1e3:.0f} tokens/s (MFU {res['mfu']['graphed']:.4f}), eager "
        f"{ms['eager']:.2f} ms = {tokens / ms['eager'] * 1e3:.0f} tokens/s (MFU "
        f"{res['mfu']['eager']:.4f}) (median of {COMPILE_TIMED} synced steps each, in turns) "
        f"on {card}")
    return res


def _step_pair_check(make, step_of, batch, dev, what: str, loss_rtol: float,
                     update_rtol: float, by_norm: bool) -> dict:
    """One precompiled (graphed on the card) step against one eager step
    from identical states: the loss, and the update (parameters after the
    step less before) by its norm (``by_norm``) or its largest element."""
    from tpuframe_torch.compile.precompile import TensorSpec, precompile_step

    state_c, state_e = make(), make()
    step_c, step_e = step_of(), step_of()
    before = [p.detach().float().clone() for p in state_e.model.parameters()]
    template = {k: TensorSpec(tuple(v.shape), v.dtype, v.device) for k, v in batch.items()}
    exe = precompile_step(step_c, state_c, template, label=f"smoke/{what}")
    check(exe.graphed == (dev.type == "cuda"), f"{what}: graphed {exe.graphed}")
    _, mc = exe(state_c, batch)
    _, me = step_e(state_e, batch)
    loss_c = float(mc["loss_sum"] / mc["count"])
    loss_e = float(me["loss_sum"] / me["count"])
    loss_rel = abs(loss_c - loss_e) / abs(loss_e)
    upd_c = [p.detach().float() - b for p, b in zip(state_c.model.parameters(), before)]
    upd_e = [p.detach().float() - b for p, b in zip(state_e.model.parameters(), before)]
    if by_norm:
        diff = math.sqrt(sum(float((a - b).square().sum()) for a, b in zip(upd_c, upd_e)))
        ref = math.sqrt(sum(float(b.square().sum()) for b in upd_e))
    else:
        diff = max(float((a - b).abs().max()) for a, b in zip(upd_c, upd_e))
        ref = max(float(b.abs().max()) for b in upd_e)
    upd_rel = diff / max(ref, 1e-30)
    log(f"  {what}: precompiled vs eager first loss {loss_c:.7g} vs {loss_e:.7g} (rel "
        f"{loss_rel:.3g}, tol {loss_rtol}); update rel {upd_rel:.3g} "
        f"({'by norm' if by_norm else 'of its largest element'} {ref:.6g}, tol "
        f"{update_rtol})")
    check(ref > 0, f"{what}: the eager step did not move the parameters")
    check(loss_rel <= loss_rtol, f"{what}: first loss rel {loss_rel} > {loss_rtol}")
    check(upd_rel <= update_rtol, f"{what}: update rel {upd_rel} > {update_rtol}")
    return {"loss_rel": loss_rel, "update_rel": upd_rel, "update_ref": ref}


def _part_f32(dev, image_size: int, f32_batch: int, lm_f32: dict, lm_f32_batch: int) -> dict:
    """The f32 checks of paths (B) and (C): one precompiled step against one
    eager step from identical states."""
    from tpuframe_torch.models import ResNet50, TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.ops.normalize import normalize_images
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import create_train_state, make_optimizer
    from tpuframe_torch.train.schedules import warmup_cosine
    from tpuframe_torch.train.step import make_train_step

    rng = np.random.default_rng(3)
    x32 = {"image": torch.from_numpy(rng.integers(0, 256, (f32_batch, image_size, image_size, 3),
                                                  dtype=np.uint8)).to(dev),
           "label": torch.from_numpy(rng.integers(0, 1000, f32_batch)).to(dev)}
    tf = functools.partial(normalize_images, mean=MEAN, std=STD, out_dtype=torch.float32)
    out = {"b": _step_pair_check(
        lambda: create_train_state(ResNet50(num_classes=1000, device=dev, seed=0),
                                   make_optimizer("sgd", 0.1)),
        lambda: make_train_step(full_precision(),
                                batch_transform=lambda b: {**b, "image": tf(b["image"])}),
        x32, dev, "(b) f32 ResNet50 step", COMPILE_LOSS_RTOL, CPU_STEP_UPDATE_RTOL, by_norm=True)}
    t32 = torch.from_numpy(rng.integers(0, lm_f32["vocab_size"],
                                        (lm_f32_batch, lm_f32["max_len"] + 1))).to(dev)
    xl = {"image": t32[:, :-1].contiguous(), "label": t32[:, 1:].contiguous()}
    # the warmup starts above 0, so the pair's one step (updates 0) moves the
    # parameters by K4 reading a nonzero lr from the schedule's device table;
    # AdamW's eps as every f32 LM step check's (LM_STEP_ADAMW: at 1e-8 a
    # gradient element of rounding noise alone steps by ~lr either way)
    sched = warmup_cosine(3e-4, COMPILE_LM_WARMUP, 40, init_lr=COMPILE_LM_F32_INIT_LR)
    out["c"] = _step_pair_check(
        lambda: create_train_state(TransformerLM(**lm_f32, device=dev, seed=4),
                                   fused_adamw(sched, **LM_STEP_ADAMW)),
        lambda: make_train_step(full_precision()), xl, dev, "(c) f32 LM step at 2 layers",
        COMPILE_LOSS_RTOL, COMPILE_LM_UPDATE_RTOL, by_norm=False)
    return out


#: (f) and (g): the graphed and the eager fit's batches, and the synced
#: steps of each arm in turns
COMPILE_LONG_STEPS = 4
COMPILE_LONG_TIMED = 9
#: a graphed bf16 fit's first loss against the eager fit's (difference 1's
#: bf16 bound: Inductor fuses and sums the region's bf16 work its own way)
COMPILE_BF16_LOSS_RTOL = 2e-2
#: (f): long_ctx and long_remat at 6 of their 12 layers (widths, tokens
#: and attention as bench_lm.py's): at 12, (f) took 334 s beside phases
#: 4-20 and the script 1,208 s (PERF.md, PR 23); the 12 layers were
#: measured alone
COMPILE_LONG = dict(LONG_LM, num_layers=6)
#: (f)'s f32 pair: 2 layers of the long-context LM, 2 x 1024 tokens,
#: blockwise; the loss within 1e-6 relative (K6 is the same kernel in both
#: arms), the update within COMPILE_LM_UPDATE_RTOL of its largest element
COMPILE_LONG_F32 = dict(LONG_LM, num_layers=2, max_len=1024, attn_impl="blockwise")
COMPILE_LONG_F32_BATCH = 2
COMPILE_LONG_F32_LOSS_RTOL = 1e-6
#: (c): the GPT-2-small LM at 4 of its 12 layers (PR 22 ran all 12, a 197-293 s
#: part beside phases 4-20); (f)'s long_ctx graphs the 12 layers at the same
#: widths and tokens a step
COMPILE_LM = dict(LM, num_layers=4)
#: (g): the MoE LM at the path's widths and batch, 4 of its 12 layers: at
#: 12 its cold compile alone took 270 s of a 386 s part (PERF.md, PR 23),
#: which phase 21 beside phases 4-20 cannot pay inside the script's limit
COMPILE_MOE = dict(MOE_LM, num_layers=4)
#: (g)'s f32 pairs: 2 layers of the MoE LM, 2 x 512 tokens, at each of
#: MOE_CAPACITIES (0.25 drops slots)
COMPILE_MOE_F32 = dict(MOE_LM, num_layers=2, max_len=512)
COMPILE_MOE_F32_BATCH = 2


def _step_losses():
    """A Trainer callback keeping each step's mean loss in ``.losses``."""
    from tpuframe_torch.train import Callback

    class StepLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, trainer, metrics):
            self.losses.append(metrics["loss_sum"] / max(metrics["count"], 1.0))

    return StepLosses()


def _lm_flops(model, cfg: dict, batch: int) -> float:
    """A step's FLOPs by phase 6's formula, 6 N T plus attention's 3 x 4 B H
    L^2 Dh a layer; for a MoE LM N counts each token's k of E experts."""
    from tpuframe_torch.models import MoEMLP

    n = sum(p.numel() for p in model.parameters())
    for m in model.modules():
        if isinstance(m, MoEMLP):
            n -= (m.w_in.numel() + m.w_out.numel()) * (1 - m.top_k / m.num_experts)
    seq = cfg["max_len"]
    return (6 * n * batch * seq + 3 * 4 * batch * cfg["num_heads"] * seq * seq * cfg["head_dim"]
            * cfg["num_layers"])


def _lm_fit_pair(dev, card: str, what: str, cfg: dict, batch: int, steps: int,
                 expected: dict) -> dict:
    """(f) and (g): ``cfg``'s LM (bf16, ``fused_adamw`` under warmup-cosine)
    through ``Trainer.fit``: eagerly, then precompiled (a cold cache) and
    graphed from the same weights and batches, each fit's peak memory
    alone; the graphed fit's launches less the warm-up's eager's, its first
    loss within COMPILE_BF16_LOSS_RTOL of eager's; then the graphed step
    against the eager one in turns (tokens/s, MFU, busy, launches a step)."""
    from tpuframe_torch.compile.precompile import launch_counters
    from tpuframe_torch.data import DataLoader
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.train import Trainer
    from tpuframe_torch.train.schedules import warmup_cosine

    seq, vocab = cfg["max_len"], cfg["vocab_size"]
    counters = launch_counters()
    res: dict = {}
    for arm in ("eager", "graphed"):
        losses = _step_losses()
        model = TransformerLM(**cfg, device=dev, seed=0)
        train = DataLoader(NextTokenDataset(batch * steps, seq, vocab, seed=1), batch,
                           shuffle=True, seed=0)  # in process: no worker to start
        trainer = Trainer(model, train_dataloader=train, precision="bf16", log_interval=1,
                          tx=fused_adamw(warmup_cosine(3e-4, COMPILE_LM_WARMUP, steps + 40),
                                         weight_decay=1e-4),
                          max_duration=f"{steps}ba", precompile=arm == "graphed",
                          callbacks=[losses])
        trainer.init_state().reserve_lr(steps + 4 * COMPILE_LONG_TIMED)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        if arm == "graphed":
            res.update(_graphed_fit(trainer, dev, expected, what, steps))
        else:
            for fn in counters.values():
                fn.launches = 0
            trainer.fit()
            sync(dev)
            launches = {k: counters[k].launches for k in expected}
            check(launches == expected, f"{what} eager fit: launches {launches} != {expected}")
        res[f"peak_gb_{arm}"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                 if dev.type == "cuda" else 0.0)
        res[f"first_loss_{arm}"] = losses.losses[0]
        if arm == "eager":
            del trainer, model, train
    rel = abs(res["first_loss_graphed"] - res["first_loss_eager"]) / abs(res["first_loss_eager"])
    res["first_loss_rel"] = rel
    log(f"  {what}: first loss graphed {res['first_loss_graphed']!r}, eager "
        f"{res['first_loss_eager']!r} (rel {rel:.3g}, tol {COMPILE_BF16_LOSS_RTOL}); peak memory "
        f"graphed {res['peak_gb_graphed']:.3f} GB, eager {res['peak_gb_eager']:.3f} GB")
    check(rel <= COMPILE_BF16_LOSS_RTOL, f"{what}: first loss rel {rel} > {COMPILE_BF16_LOSS_RTOL}")
    state = trainer.state
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, vocab, (batch, seq + 1))).to(dev)
    xl = {"image": toks[:, :-1].contiguous(), "label": toks[:, 1:].contiguous()}
    exe = _train_executable(trainer, xl)
    eager = trainer._train_step
    with card_timing():
        ms = _turns({"graphed": lambda: exe(state, xl), "eager": lambda: eager(state, xl)}, dev,
                    timed=COMPILE_LONG_TIMED)
        if dev.type == "cuda":
            res["busy"] = {k: profile(fn, f"{what} {k} step of {batch}x{seq}")
                           for k, fn in (("graphed", lambda: exe(state, xl)),
                                         ("eager", lambda: eager(state, xl)))}
    flops = _lm_flops(state.model, cfg, batch)
    tokens = batch * seq
    res.update(step_ms=ms, tflop=flops / 1e12,
               mfu={k: flops / (v / 1e3) / BF16_FLOPS for k, v in ms.items()},
               tokens_per_s={k: tokens / (v / 1e3) for k, v in ms.items()})
    log(f"  {what} train step of {batch}x{seq}: graphed {ms['graphed']:.2f} ms = "
        f"{res['tokens_per_s']['graphed']:.0f} tokens/s (MFU {res['mfu']['graphed']:.4f}), eager "
        f"{ms['eager']:.2f} ms = {res['tokens_per_s']['eager']:.0f} tokens/s (MFU "
        f"{res['mfu']['eager']:.4f}), {flops / 1e12:.2f} TFLOP a step (median of "
        f"{COMPILE_LONG_TIMED} synced steps each, in turns) on {card}")
    del exe, eager, state, trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _part_long(dev, card: str, sizes: dict) -> dict:
    """(f): ``long_ctx``, then ``long_remat`` (K6a again in each block's
    recompute, its graphed peak below ``long_ctx``'s), then the f32 pair of
    the blockwise LM at 2 layers."""
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import create_train_state
    from tpuframe_torch.train.schedules import warmup_cosine
    from tpuframe_torch.train.step import make_train_step

    cfg, batch, steps = sizes["long_cfg"], sizes["long_batch"], sizes["long_steps"]
    layers, n_ln = cfg["num_layers"], 2 * cfg["num_layers"] + 1
    out = {}
    for name, remat in (("long_ctx", False), ("long_remat", True)):
        expected = {"blockwise_attention_fwd": layers * steps * (2 if remat else 1),
                    "blockwise_attention_bwd_dq": layers * steps,
                    "blockwise_attention_bwd_dkv": layers * steps,
                    "layer_norm_fwd": n_ln * steps + (2 * layers * steps if remat else 0),
                    "layer_norm_bwd": n_ln * steps, "fused_adamw": steps,
                    "cross_entropy_fwd": 0, "moe_dispatch": 0}
        out[name] = _lm_fit_pair(dev, card, f"(f) {name}", dict(cfg, remat=remat), batch, steps,
                                 expected)
    peaks = {k: out[k]["peak_gb_graphed"] for k in ("long_ctx", "long_remat")}
    log(f"  (f) graphed peak memory: long_remat {peaks['long_remat']:.3f} GB, long_ctx "
        f"{peaks['long_ctx']:.3f} GB")
    check(dev.type != "cuda" or peaks["long_remat"] < peaks["long_ctx"],
          f"(f) long_remat's graphed peak {peaks} is not below long_ctx's")
    f32, f32_batch = sizes["long_f32"], sizes["long_f32_batch"]
    t32 = torch.from_numpy(np.random.default_rng(4).integers(
        0, f32["vocab_size"], (f32_batch, f32["max_len"] + 1))).to(dev)
    xl = {"image": t32[:, :-1].contiguous(), "label": t32[:, 1:].contiguous()}
    sched = warmup_cosine(3e-4, COMPILE_LM_WARMUP, 40, init_lr=COMPILE_LM_F32_INIT_LR)
    out["f32"] = _step_pair_check(
        lambda: create_train_state(TransformerLM(**f32, device=dev, seed=4),
                                   fused_adamw(sched, **LM_STEP_ADAMW)),
        lambda: make_train_step(full_precision()), xl, dev,
        f"(f) f32 blockwise LM step at {f32['num_layers']} layers",
        COMPILE_LONG_F32_LOSS_RTOL, COMPILE_LM_UPDATE_RTOL, by_norm=False)
    return out


def _part_moe(dev, card: str, sizes: dict) -> dict:
    """(g): the one-process MoE LM (K9a-K9c), then its f32 pairs at 2 layers
    at each of MOE_CAPACITIES (0.25 drops slots)."""
    from tpuframe_torch.models import TransformerLM
    from tpuframe_torch.ops import fused_adamw
    from tpuframe_torch.parallel import full_precision
    from tpuframe_torch.train import create_train_state
    from tpuframe_torch.train.schedules import warmup_cosine
    from tpuframe_torch.train.step import make_train_step

    cfg, batch, steps = sizes["moe_cfg"], sizes["moe_batch"], sizes["moe_steps"]
    layers, n_ln = cfg["num_layers"], 2 * cfg["num_layers"] + 1
    expected = {"moe_dispatch": layers * steps, "moe_combine": 2 * layers * steps,
                "moe_combine_backward": layers * steps, "layer_norm_fwd": n_ln * steps,
                "layer_norm_bwd": n_ln * steps, "fused_adamw": steps,
                "blockwise_attention_fwd": 0, "cross_entropy_fwd": 0}
    out = {"moe": _lm_fit_pair(dev, card, "(g) MoE LM", cfg, batch, steps, expected)}
    f32, f32_batch = sizes["moe_f32"], sizes["moe_f32_batch"]
    t32 = torch.from_numpy(np.random.default_rng(5).integers(
        0, f32["vocab_size"], (f32_batch, f32["max_len"] + 1))).to(dev)
    xl = {"image": t32[:, :-1].contiguous(), "label": t32[:, 1:].contiguous()}
    sched = warmup_cosine(3e-4, COMPILE_LM_WARMUP, 40, init_lr=COMPILE_LM_F32_INIT_LR)

    def make(cf):
        model = TransformerLM(**f32, device=dev, seed=4)
        _set_capacity(model, cf)
        return create_train_state(model, fused_adamw(sched, **LM_STEP_ADAMW))

    for cf in MOE_CAPACITIES:
        out[f"f32_cf{cf}"] = _step_pair_check(
            lambda: make(cf), lambda: make_train_step(full_precision()), xl, dev,
            f"(g) f32 MoE LM step at {f32['num_layers']} layers, capacity factor {cf}",
            COMPILE_LONG_F32_LOSS_RTOL, COMPILE_LM_UPDATE_RTOL, by_norm=False)
    return out


def compile_child(part: str, out: str, card: str, sizes: dict) -> None:
    """One part of phase 21 in this fresh process (``COMPILE_STAGES``), its
    result as JSON in ``out``; the cache directory is the env's
    ``TPUFRAME_COMPILE_CACHE``, the flags are ``main``'s."""
    from tpuframe_torch.compile import cache as cc
    from tpuframe_torch.core import initialize

    dev = initialize(device=sizes.get("device")).device
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    import torch._inductor.config as inductor_config

    inductor_config.compile_threads = COMPILE_THREADS
    if dev.type == "cpu":
        # a rehearsal: compiles without code generation; a failed check is
        # logged (the launch counts fail there by design)
        import tpuframe_torch.compile.precompile as pc

        global check
        pc._BACKEND = sizes.get("backend", pc._BACKEND)
        check = lambda ok, msg: ok or log(f"  check failed: {msg[:300]}")  # noqa: E731
    before = _compile_registry()
    kind, _, mode = part.partition(" ")
    mode = mode.split(",")[0]
    if part.startswith("e "):
        res = _part_train(mode, dev, card, sizes["image_size"], sizes["batch"], sizes["steps"])
    elif part.startswith("a "):
        res = _part_serve(mode, dev, card, sizes["serve_px"])
    elif part == "c":
        res = _part_lm(dev, card, sizes["lm_cfg"], sizes["lm_batch"], sizes["lm_steps"])
    elif part == "f":
        res = _part_long(dev, card, sizes)
    elif part == "g":
        res = _part_moe(dev, card, sizes)
    else:
        res = _part_f32(dev, sizes["image_size"], sizes["f32_batch"], sizes["lm_f32"],
                        sizes["lm_f32_batch"])
    after = _compile_registry()
    res["compile"] = {k: after[k] - before[k] for k in after}
    res["cache_dir"] = cc.enabled_dir()
    res["cache_info"] = cc.cache_info()
    from torch._dynamo.utils import counters

    res["torch_counters"] = {g: dict(counters[g]) for g in ("inductor", "aot_autograd")}
    res["graph_breaks"] = dict(counters["graph_break"])
    with open(out, "w") as f:
        json.dump(res, f, default=str)


def compile_sizes(**cut) -> dict:
    """Phase 21's sizes, the full ones unless ``cut`` replaces some."""
    return {"image_size": 224, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "serve_px": 224,
            "lm_cfg": COMPILE_LM, "lm_batch": LM_BATCH, "lm_steps": LM_STEPS,
            "f32_batch": COMPILE_F32_BATCH, "lm_f32": COMPILE_LM_F32,
            "lm_f32_batch": COMPILE_LM_F32_BATCH, "long_cfg": COMPILE_LONG,
            "long_batch": LONG_BATCH,
            "long_steps": COMPILE_LONG_STEPS, "long_f32": COMPILE_LONG_F32,
            "long_f32_batch": COMPILE_LONG_F32_BATCH, "moe_cfg": COMPILE_MOE,
            "moe_batch": MOE_BATCH,
            "moe_steps": COMPILE_LONG_STEPS, "moe_f32": COMPILE_MOE_F32,
            "moe_f32_batch": COMPILE_MOE_F32_BATCH, **cut}


def compile_phase(card: str, sizes: dict | None = None, say=log) -> dict:
    """Phase 21: the compile plane, each part in a fresh process, in
    ``COMPILE_STAGES``' order (module docstring); ``say`` takes the lines
    (the parts' own lines come back with their output).  ``sizes`` cuts it
    down for a rehearsal (``device="cpu"`` and small shapes)."""
    sizes = compile_sizes(**(sizes or {}))
    shutil.rmtree(COMPILE_DIR, ignore_errors=True)
    COMPILE_DIR.mkdir(parents=True)
    results: dict = {}
    root = str(Path(__file__).resolve().parent)
    try:
        for stage in COMPILE_STAGES:
            procs = []
            for part, cache in stage:
                out = COMPILE_DIR / f"{part.replace(' ', '_').replace(',', '')}.json"
                env = dict(os.environ, TPUFRAME_COMPILE_CACHE=str(COMPILE_DIR / cache))
                code = (f"import os, sys; os.nice({SIDE_NICE}); sys.path.insert(0, {root!r}); "
                        "import chip_smoke as cs; "
                        f"cs.compile_child({part!r}, {str(out)!r}, {card!r}, {sizes!r})")
                proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                _COMPILE_PROCS.append(proc)
                procs.append((part, out, time.perf_counter(), proc))
            for part, out, t0, proc in procs:
                try:
                    stdout, stderr = proc.communicate(timeout=1500)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    stdout, stderr = proc.communicate()
                wall = time.perf_counter() - t0
                for line in stdout.splitlines():
                    if line.startswith("  "):
                        say(line)
                check(proc.returncode == 0, f"phase 21 part {part} exited {proc.returncode}: "
                      f"{stderr[-3000:]}")
                res = json.loads(out.read_text())
                res["process_s"] = wall
                results[part] = res
                say(f"  21 {part}: process {wall:.1f} s; compile {res['compile']}; cache "
                    f"{json.dumps(res['cache_info'])}")
    finally:
        shutil.rmtree(COMPILE_DIR, ignore_errors=True)
    dev_cuda = sizes.get("device", "cuda") != "cpu"
    for part in ("e warm, b", "a warm, d"):
        c = results[part]["compile"]
        check(c["backend_compiles"] == 0 and c["cache_hits"] >= 1 and c["cache_misses"] == 0,
              f"phase 21 {part}: the warm cache compiled: {c}")
    for part in ("e cold", "e warm, b"):
        steps = (results[part].get("report") or results[part]["b"]["report"])["steps"]
        check(steps and all(s.get("dispatchable") and s.get("graphed") == dev_cuda
                            for s in steps), f"phase 21 {part}: {steps}")
    ttfs = {"cold": results["e cold"]["ttfs_s"], "warm": results["e warm, b"]["ttfs_s"],
            "eager": results["e cold"]["ttfs_eager_s"]}
    serve = {m: results[f"a {m}" + (", d" if m == "warm" else "")]["seconds"]
             for m in ("cold", "warm")}
    say(f"  (e) time to first step of path (B): cold {ttfs['cold']:.2f} s, warm "
        f"{ttfs['warm']:.2f} s, eager {ttfs['eager']:.2f} s; (a) path (A)'s precompile: cold "
        f"{serve['cold']:.2f} s, warm {serve['warm']:.2f} s; on {card}")
    say(f"  (a) torch {torch.__version__} cache counters, cold: "
        f"{json.dumps(results['a cold']['torch_counters'])}; warm: "
        f"{json.dumps(results['a warm, d']['torch_counters'])}")
    for part in ("f", "g"):
        check(not results[part]["graph_breaks"],
              f"phase 21 {part}: graph breaks {results[part]['graph_breaks']}")
    summary = {"ttfs_s": ttfs, "serve_precompile_s": serve,
               "b": results["e warm, b"]["b"], "c": results["c"], "f": results["f"],
               "g": results["g"],
               "d": {k: results["a warm, d"][k] for k in ("precompiled", "eager", "logits_rel")},
               "f32": results["f32"], "compile": {p: r["compile"] for p, r in results.items()},
               "process_s": {p: r["process_s"] for p, r in results.items()}, "card": card}
    say("  compile_json " + json.dumps(summary, default=str))
    return summary


#: phase 3's card tests: a captured blockwise step's K6 counts over its
#: replays, and the graphed blockwise and MoE LM steps against eager
GRAPHED_TESTS = ("captured_blockwise_step_counts or graphed_blockwise_lm_step or "
                 "graphed_moe_lm_step")


def start_graphed_tests() -> subprocess.Popen:
    """``GRAPHED_TESTS`` of ``tests/test_torch_port_cuda.py`` in a pytest
    process (the kernels built by phase 2 are loaded from ``build/``)."""
    root = Path(__file__).resolve().parent
    # its few small compiles in process: a pool of compile workers would
    # start a torch in each beside phases 4 on
    proc = subprocess.Popen(
        [sys.executable, "-c", f"import os, sys; os.nice({SIDE_NICE}); import pytest; "
         "sys.exit(pytest.main(sys.argv[1:]))", str(root / "tests" / "test_torch_port_cuda.py"),
         "--noconftest", "-q", "-p", "no:cacheprovider", "-k", GRAPHED_TESTS],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, TORCHINDUCTOR_COMPILE_THREADS="1"))
    _COMPILE_PROCS.append(proc)
    return proc


def join_graphed_tests(proc: subprocess.Popen) -> None:
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    tail = out.strip().splitlines()[-1] if out.strip() else ""
    log(f"  phase 3's card tests ({GRAPHED_TESTS}): {tail}")
    check(proc.returncode == 0 and " passed" in tail and "skipped" not in tail
          and "deselected" in tail, f"phase 3's card tests exited {proc.returncode}: "
          f"{out[-3000:]}")


GLOO_PHASES = ("10", "15", "16", "17", "18", "19", "20")


class PhaseClock:
    """Each phase's wall seconds, from its ``== phase`` line to the next."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.current, self.since = None, time.perf_counter()

    def start(self, title: str) -> None:
        self.stop()
        self.current = title
        log(f"== phase {title}")

    def stop(self) -> None:
        """Ends the current phase, printing its seconds on a line of its own."""
        now = time.perf_counter()
        if self.current is not None:
            self.seconds[self.current] = now - self.since
            log(f"  phase {self.current}: {self.seconds[self.current]:.1f} s")
        self.current, self.since = None, now


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Smoke test of tpuframe_torch on one GPU")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phase 14's synthetic image volume")
    args = parser.parse_args(argv)
    clock = PhaseClock()
    clock.start("1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from tpuframe_torch.core.runtime import SIMULATE_ENV

    if os.environ.get(SIMULATE_ENV):
        # the launcher's CPU request would move the default device off the card
        print(f"chip_smoke: {SIMULATE_ENV}={os.environ[SIMULATE_ENV]!r} is set (the request "
              "for CPU workers); unset it to run on the card", file=sys.stderr)
        return 2
    # Python compiles each module it imports anew where it can neither read
    # nor write bytecode beside the source: on the card's host every process
    # compiled all of torch's sources (PERF.md §6), and this script starts
    # dozens (spawned ranks, the launcher's workers, loader workers).
    # This process (for what it imports from here on) and the ones it starts
    # keep their bytecode under build/ instead.
    pycache = str(Path(__file__).resolve().parent / "build" / "tpuframe_torch" / "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = pycache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {kind}, "
        f"count {torch.cuda.device_count()}")
    log(f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    clock.start("2: build")
    from tpuframe_torch.ops import build

    t0 = time.perf_counter()
    # the K2, K6, K9 and K9c baselines' and K9b's generic loop's nvcc run
    # beside the port's
    baseline, baseline_k6, baseline_k9, any_k, baseline_k9c = (
        start_baseline_build(src) for src in (BASELINE_CE, BASELINE_K6, BASELINE_K9, ANY_K_K9B,
                                              BASELINE_K9C))
    report = build.build()
    baseline, baseline_k6, baseline_k9, any_k, baseline_k9c = (baseline_library(h) for h in (
        baseline, baseline_k6, baseline_k9, any_k, baseline_k9c))
    log(f"  built {sorted(report)}, the K2, K6, K9 and K9c baselines and K9b's generic loop in "
        f"{time.perf_counter() - t0:.2f} s")
    regs = {}
    for name, text in [(n, r["log"]) for n, r in report.items()] + [
            (BASELINE_K6.stem, baseline_k6.build_log),
            (BASELINE_K9.stem, baseline_k9.build_log),
            (BASELINE_K9C.stem, baseline_k9c.build_log)]:
        regs[name] = ptxas_table(text)
        for fn, t in regs[name].items():
            log(f"  {name}: {fn} {t['registers']} registers, spill stores/loads "
                f"{t['spill_stores']}/{t['spill_loads']} bytes")
    if not report["moe_gating"]["cached"]:  # built here: ptxas spoke
        spills = {fn: t for fn, t in regs["moe_gating"].items()
                  if t["spill_stores"] or t["spill_loads"]}
        check(regs["moe_gating"] and not spills, f"moe_gating.cu spills: {spills}")

    clock.start("3: kernels")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    floor_ms = floor_phase(flush)
    log(f"  launch floor: {floor_ms * 1e3:.2f} us (the empty kernel, CUDA events after the "
        f"L2 flush) on {card}")
    k1 = kernel_phase(flush, floor_ms)
    log(f"  normalize 64x224x224x3 uint8->bf16: kernel {k1['ms'] * 1e3:.2f} us, "
        f"plain {k1['plain_ms'] * 1e3:.2f} us, torch.addcmul {k1['library_ms'] * 1e3:.2f} us, "
        f"bound {k1['bound_ms'] * 1e3:.2f} us "
        f"({k1['bytes_moved'] / 1e6:.2f} MB at 3.35 TB/s) on {card}")
    k2a, k2b = cross_entropy_phase(flush, floor_ms, baseline)
    k3a, k3b = layer_norm_phase(flush)
    from tpuframe_torch.models import TransformerLM

    k4 = adamw_phase(flush, [tuple(p.shape) for p in TransformerLM(**LM).parameters()])
    k5a, k5b, k5c = quant_wire_phase(flush)
    k6a, k6b, k6c = blockwise_phase(flush, baseline_k6)
    for k, fn in ((k6a, "attn_fwd_tc"), (k6b, "attn_bwd_dq_tc"), (k6c, "attn_bwd_dkv_tc")):
        k["ptxas"] = {f"D={d}": regs["blockwise_attention"].get(f"{fn}<{d}>")
                      for d in (16, 32, 64, 128)}
    del flush
    torch.cuda.empty_cache()
    from tpuframe_torch.ops.blockwise_attention import (
        blockwise_attention_bwd_dkv,
        blockwise_attention_bwd_dq,
        blockwise_attention_fwd,
    )

    k6_counters = (blockwise_attention_fwd, blockwise_attention_bwd_dq, blockwise_attention_bwd_dkv)
    for fn in k6_counters:  # phases 4 to 10 run no long context: K6 must stay at 0
        fn.launches = 0

    # phase 21's parts, each a fresh process, mostly Inductor compiling on
    # the host's cores, run one after another on a thread beside phases 4
    # to 20 (not phase 3's kernel timings; its timed parts not beside
    # 18(e)'s); their lines are printed when phase 21 joins them
    compile_lines: list[str] = []
    compile_out: dict = {}

    def compile_thread() -> None:
        try:
            compile_out["result"] = compile_phase(card, say=compile_lines.append)
        except BaseException as e:  # re-raised when phase 21 joins
            compile_out["error"] = e
        finally:
            compile_out["seconds"] = time.perf_counter() - compile_t0

    compile_runner = threading.Thread(target=compile_thread, name="phase-21", daemon=True)
    compile_t0 = time.perf_counter()
    compile_runner.start()
    # phase 3's card tests of the graphed K6 and K9 steps, a pytest process
    # beside phases 4 on, joined with phase 21
    graphed_tests = start_graphed_tests()

    clock.start("4: serve")
    serve_launches = slice_phase(card)["launches"]["normalize"]

    clock.start("5: train")
    train_launches, _ = train_phase(card)
    torch.cuda.empty_cache()

    clock.start("6: LM train")
    lm_launches, _ = lm_phase(card)
    torch.cuda.empty_cache()

    clock.start("7: checkpoint and resume")
    checkpoint_phase(card)
    torch.cuda.empty_cache()

    clock.start("8: compressed data-parallel train")
    dp_launches, _ = dp_phase(card)
    torch.cuda.empty_cache()

    clock.start("9: two ranks on one card")
    two_rank_phase(card)

    clock.start("10: uncompressed data parallelism on one card")
    ddp = ddp_phase(card)
    k6_early = [fn.launches for fn in k6_counters]
    log(f"  K6 launches over phases 4 to 10 in this process: {k6_early} (each rank of phase 10: "
        f"{[ddp['launches'][n] for n in K6_NAMES]})")
    check(k6_early == [0, 0, 0], f"K6 launched {k6_early} times in phases 4 to 10")
    torch.cuda.empty_cache()

    clock.start("11: ViT serve")
    vit = vit_serve_phase(card)
    torch.cuda.empty_cache()

    clock.start("12: long-context LM train")
    long_launches, long = long_context_phase(card)
    torch.cuda.empty_cache()

    # each kernel's launches on the main paths that run it: K1 serve and
    # train, K2 the ResNet train, K3 and K4 the LM train (where K1 and K2
    # launched no time), K5 the compressed train (which also runs K1 and K2,
    # at phase 5's counts)
    k1["launches"] = serve_launches + train_launches["normalize"]
    k1["launches_serve"] = serve_launches
    k1["launches_train"] = train_launches["normalize"]
    k2a["launches"] = train_launches["cross_entropy_fwd"]
    k2b["launches"] = train_launches["cross_entropy_bwd"]
    k3a["launches"] = lm_launches["layer_norm_fwd"]
    k3b["launches"] = lm_launches["layer_norm_bwd"]
    k4["launches"] = lm_launches["fused_adamw"]
    k5a["launches"] = dp_launches["bucket_abs_max"]
    k5b["launches"] = dp_launches["quant_encode"]
    k5c["launches"] = dp_launches["quant_decode"]
    # phase 10's launches on each of its two ranks, beside the other paths
    k1["launches_ddp"] = ddp["launches"]["normalize"]
    k2a["launches_ddp"] = ddp["launches"]["cross_entropy_fwd"]
    k2b["launches_ddp"] = ddp["launches"]["cross_entropy_bwd"]
    # K6 on the long-context LM's fit (phase 12), the long_remat fit beside
    # it; K3a also on the ViT serve (phase 11)
    for k, name in ((k6a, "blockwise_attention_fwd"), (k6b, "blockwise_attention_bwd_dq"),
                    (k6c, "blockwise_attention_bwd_dkv")):
        k["launches"] = long_launches["long_ctx"][name]
        k["launches_remat"] = long_launches["long_remat"][name]
    k1["launches_vit_serve"] = vit["launches"]["normalize"]
    k3a["launches_vit_serve"] = vit["launches"]["layer_norm_fwd"]
    k3a["launches_long_ctx"] = long_launches["long_ctx"]["layer_norm_fwd"]

    clock.start("13: launcher")
    launcher_phase(card)
    torch.cuda.empty_cache()

    clock.start("14: streaming")
    stream_launches, _ = streaming_phase(card, seed=args.seed)
    for k, name in ((k1, "normalize"), (k2a, "cross_entropy_fwd"), (k2b, "cross_entropy_bwd")):
        k["launches_streaming"] = stream_launches[name]
    torch.cuda.empty_cache()

    clock.start("15: overlapped and fused data parallelism on one card")
    overlap = overlap_phase(card)
    for k, name in ((k5a, "bucket_abs_max"), (k5b, "quant_encode"), (k5c, "quant_decode")):
        k["launches_grouped"] = overlap["launches"][name]
    torch.cuda.empty_cache()

    clock.start("16: ZeRO on one card")
    zero = zero_phase(card)
    k4["launches_zero"] = {n: v["fused_adamw"] for n, v in zero["launches"].items()}
    for k, name in ((k5a, "bucket_abs_max"), (k5b, "quant_encode"), (k5c, "quant_decode")):
        k["launches_zero_int8"] = zero["launches"]["zero_2_int8"][name]
    torch.cuda.empty_cache()

    clock.start("17: tensor and pipeline parallelism on one card")
    tp = tp_phase(card)
    for k, name in ((k2a, "cross_entropy_fwd"), (k2b, "cross_entropy_bwd"),
                    (k3a, "layer_norm_fwd"), (k3b, "layer_norm_bwd"), (k4, "fused_adamw")):
        k["launches_tp"] = [r[name] for r in tp["launches_tp"]]
        k["launches_tp_pp"] = [r[name] for r in tp["launches_tp_pp"]["interleaved"]]
        if "example07" in tp:
            k["launches_example07_tp2"] = tp["example07"]["launches"][name]
    torch.cuda.empty_cache()

    clock.start("18: sequence parallelism and MoE on one card")
    sp = sp_phase(card)
    ex06 = sp.get("example06", {})
    for k, name in zip((k6a, k6b, k6c), K6_NAMES):
        k["launches_ring"] = [r[name] for r in sp["launches_ring"]]
        k["launches_ulysses"] = [r[name] for r in sp["launches_ulysses"]]
        k["launches_example06"] = {run: v["launches"][name] for run, v in ex06.items()}
    torch.cuda.empty_cache()
    t18e = time.perf_counter()
    with card_timing():  # none of phase 21's timed parts runs meanwhile
        t_lock = time.perf_counter() - t18e
        k9a, k9b, k9c = moe_kernel_phase(floor_ms, baseline_k9, any_k, baseline_k9c)
    log(f"  (e) in {time.perf_counter() - t18e:.1f} s ({t_lock:.1f} s waiting for phase 21's "
        "timed parts)")
    for k, fn in ((k9a, "dispatch_kernel<"), (k9b, "combine_kernel"), (k9c, "dispatch_kernel<")):
        k["ptxas"] = {f: t for f, t in regs["moe_gating"].items() if f.startswith(fn)
                      and (fn != "dispatch_kernel<" or f.endswith(",1>") == (k is k9c))}
    for k in (k9a, k9b, k9c):
        k["launches"] = sp["launches_moe"][0][k["name"]]  # rank 0 of the MoE LM's bf16 steps
        k["launches_moe"] = [r[k["name"]] for r in sp["launches_moe"]]
        k["launches_example06"] = {run: v["launches"][k["name"]] for run, v in ex06.items()}
    torch.cuda.empty_cache()

    clock.start("19: fault tolerance on one card")
    # phase 20's launches, mostly their workers starting on the host's cores,
    # run on threads beside phase 19's parts
    with remote_launches(card) as remote:
        fault = fault_phase(card)
        # each kernel's launches on the parts of phase 19 that run it
        parts = {"a, b": fault["a, b"]["launches"], "c": fault["c"]["launches"],
                 "d": fault["d"]["launches"], "e": fault["e"]["launches"],
                 "f": fault["f"]["launches"]}
        for k, name in ((k1, "normalize"), (k2a, "cross_entropy_fwd"),
                        (k2b, "cross_entropy_bwd"), (k3a, "layer_norm_fwd"),
                        (k3b, "layer_norm_bwd"), (k4, "fused_adamw")):
            k["launches_fault"] = {p: (c.get(name) if p != "e" else {w: v.get(name)
                                                                     for w, v in c.items()})
                                   for p, c in parts.items()}
        torch.cuda.empty_cache()

        clock.start("20: remote launch on one card")
        # after phase 19: no other save is in flight in this process while
        # (e) plants its failed write
        t0 = time.perf_counter()
        remote["e"] = remote_checkpoint_part(card, remote["root"], torch.device("cuda"))
        remote["seconds"]["e"] = time.perf_counter() - t0
    remote_report(card, remote)
    for k, name in ((k2a, "cross_entropy_fwd"), (k2b, "cross_entropy_bwd")):
        k["launches_remote"] = {run: remote[run]["counts"][name]
                                for run in ("b remote", "b local 1", "b local 2")}
    torch.cuda.empty_cache()

    clock.start("21: compile plane")
    t21 = time.perf_counter()
    compile_runner.join()
    for line in compile_lines:
        log(line)
    log(f"  phase 21's parts took {compile_out['seconds']:.1f} s from their start after phase "
        f"3; the join waited {time.perf_counter() - t21:.1f} s")
    if "error" in compile_out:
        raise compile_out["error"]
    cp = compile_out["result"]
    join_graphed_tests(graphed_tests)
    for k, name, part in ((k1, "normalize", "b"), (k2a, "cross_entropy_fwd", "b"),
                          (k2b, "cross_entropy_bwd", "b"), (k3a, "layer_norm_fwd", "c"),
                          (k3b, "layer_norm_bwd", "c"), (k4, "fused_adamw", "c")):
        k["launches_graphed"] = cp[part]["graphed"][name]
        k["launches_graphed_warmup"] = cp[part]["warmup_launches"][name]
    k1["launches_graphed_serve"] = cp["d"]["precompiled"]["k1_launches"]
    # K6 on (f)'s graphed long_ctx fit (long_remat's beside it), K9 on (g)'s
    for k, name in zip((k6a, k6b, k6c, k9a, k9b, k9c), K6_NAMES + K9_NAMES):
        part = cp["f"]["long_ctx"] if name in K6_NAMES else cp["g"]["moe"]
        k["launches_graphed"] = part["graphed"][name]
        k["launches_graphed_warmup"] = part["warmup_launches"][name]
        if name in K6_NAMES:
            k["launches_graphed_remat"] = cp["f"]["long_remat"]["graphed"][name]

    clock.start("22: result")
    gloo = sum(v for t, v in clock.seconds.items() if t.split(":")[0] in GLOO_PHASES)
    log(f"  phases {', '.join(GLOO_PHASES)} (gloo ranks on the card): {gloo:.1f} s; all "
        f"phases: {sum(clock.seconds.values()):.1f} s")
    kernels = [k1, k2a, k2b, k3a, k3b, k4, k5a, k5b, k5c, k6a, k6b, k6c, k9a, k9b, k9c]
    for k in kernels:
        k["floor_ms"] = floor_ms  # beside bound_ms, which stays the byte or operation bound
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
