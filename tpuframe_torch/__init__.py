"""tpuframe_torch: the PyTorch and CUDA port of tpuframe, for NVIDIA Hopper.

Module paths mirror the JAX package (``tpuframe/serve/engine.py`` ->
``tpuframe_torch/serve/engine.py``).  The port imports torch and numpy,
never JAX or anything of ``tpuframe``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.

Ported so far: the serve path — ``ServeEngine`` over ``make_predict_fn``
over ``ResNet``, with the fused normalize kernel (``ops/normalize.py``,
``csrc/normalize.cu``) — and the one-card train path — ``Trainer.fit``
over the train and eval steps, training-mode BatchNorm, SGD/Adam/AdamW,
the schedules, the health sentinel and the ``DataLoader``, with the fused
cross entropy kernels (``ops/cross_entropy.py``, ``csrc/cross_entropy.cu``);
the LM train path with the LayerNorm and fused AdamW kernels
(``ops/layer_norm.py``, ``ops/fused_adamw.py``); and data-parallel training
through the compressed gradient wire — ``Trainer(plan=ParallelPlan(...),
grad_compression="int8")`` over ``torch.distributed``, with the amax,
encode and decode kernels (``ops/quant_wire.py``, ``csrc/quant_wire.cu``);
long context and ViT with the blockwise-attention kernels; and the
launcher path — ``launch.Distributor`` and ``TPUTrainer`` over local
workers with a heartbeat (``csrc/heartbeat.cpp``), ``core.Config``, the
MLflow file store and model registry, ``MnistNet``,
``TransferClassifier``, EMA and lion/lamb/adafactor, and the examples
under ``tpuframe_torch/examples``; the multi-host launch plane —
``launch.RemoteDistributor`` over ``python -m tpuframe_torch.launch.agent``
and the host control plane (``core.native.ControlPlane``,
``csrc/controlplane.cpp``); the compile plane (``compile``): the
persistent cache on Inductor's, precompile with the steps' model regions
compiled by Inductor and captured as CUDA graphs, the kernels K1-K4 as
``tpuframe::`` custom ops.
"""

__version__ = "0.1.0"
