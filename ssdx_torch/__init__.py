"""ssdx_torch — SSD300 automotive object detection in PyTorch for NVIDIA Hopper.

The PyTorch/CUDA counterpart of the JAX package ``ssdx``: the same network,
priors, post-processing, serving contract, int8 serving configuration and
training step, loop and checkpoints, with the kernels of those paths (the
fused conv1 stem, greedy DIoU-NMS, the train-mode stem with its backward,
and the int8 3x3 and 1x1 convs with their fused requantizing epilogue,
beside the bare int8 and bf16 matmuls of the tensor-core probe) written by
hand in CUDA C++ for ``sm_90a`` (``ssdx_torch/csrc``).  Public functions
keep the JAX package's NHWC layout so the two can be compared like with
like.  Data parallelism is one process per device under
``torch.distributed`` (``ssdx_torch/mesh.py``).

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``); with no GPU present they raise instead of carrying on
quietly on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "__version__"]

__version__ = "0.1.0"  # the JAX package's version: the two describe one system


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ssdx_torch runs on a CUDA GPU by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
