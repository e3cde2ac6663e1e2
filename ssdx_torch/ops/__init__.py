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
:func:`launch_counts`, :func:`launches_since` and :func:`add_launches` read
and move every such counter at once, so a CUDA graph's replays count what
its capture recorded.
"""
import sys

__all__ = ["launch_counts", "launches_since", "add_launches"]


def launch_counts() -> dict:
    """Every launch counter (an integer whose name starts with ``launches``)
    of the kernel modules imported so far, by ``(module, name)``."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod is not None and mod_name.startswith(__name__ + "."):
            for k, v in vars(mod).items():
                if k.startswith("launches") and type(v) is int:
                    out[(mod_name, k)] = v
    return out


def launches_since(before: dict) -> dict:
    """The counters that moved since ``before`` (a :func:`launch_counts`),
    and by how much."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()
            if v != before.get(k, 0)}


def add_launches(launched: dict, times: int = 1) -> None:
    """Add ``times`` x ``launched`` (a :func:`launches_since`) to the
    counters.  A CUDA graph's capture bumps the counters of the kernels it
    records but runs none: its owner takes them back (``times=-1``) and
    adds them once a replay, so every counter counts launches that ran."""
    for (mod_name, k), n in launched.items():
        mod = sys.modules[mod_name]
        setattr(mod, k, getattr(mod, k) + times * n)
