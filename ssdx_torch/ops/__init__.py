"""Hand-written CUDA kernels of the port and their plain versions.

* :mod:`ssdx_torch.ops.stem` — the fused conv1 stem (``csrc/stem.cu``);
* :mod:`ssdx_torch.ops.nms` — the greedy DIoU-NMS keep mask (``csrc/nms.cu``);
* :mod:`ssdx_torch.ops.stem_train` — the train-mode stem, forward and
  backward (``csrc/stem_train.cu``);
* :mod:`ssdx_torch.ops.int8_conv` — the int8 3x3 and 1x1 convs of the
  quantized serving path with their fused epilogue, and the bare int8 and
  bf16 matmuls of the tensor-core probe (``csrc/int8_conv.cu``);
* :mod:`ssdx_torch.ops.pool` and :mod:`ssdx_torch.ops.bn_relu_pool` — the
  2x2 max pool and the fused BN + ReLU + pool, forward and backward
  (``csrc/pool.cu``, ``csrc/bn_relu_pool.cu``);
* :mod:`ssdx_torch.ops.repro` — the two probe ops of the data-parallel
  repro tool (``csrc/repro.cu``);
* :mod:`ssdx_torch.ops.native` — host C++ (no CUDA) behind the mAP matcher
  (``csrc/ssdx_native.cpp``), built with ``g++``.

A wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor (or raises); it never falls back.
Each module keeps a plain integer ``launches`` that its wrapper bumps once
per kernel launch; ``stem_train`` bumps it once per forward, which launches
the forward's kernels (its backward's launches follow from that forward).
"""
