"""Keep mask of exact greedy (D)IoU-NMS over score-sorted candidates.

``nms_core_sorted(boxes [B,K,4], valid [B,K], thresh, labels=None,
kind="diou")`` returns the bool keep mask ``[B,K]`` in sorted order: box j
is kept iff it is valid and no kept earlier box i of the same label (of any
label when ``labels`` is None) has DIoU(i, j) > thresh, or IoU(i, j) with
``kind="iou"``.  On a CUDA tensor it launches
the hand-written kernel of ``csrc/nms.cu`` (whose header gives its bound,
design and why its mask is bit-exact); on a CPU tensor it runs
:func:`nms_core_sorted_ref`, the plain PyTorch version, which is also the
kernel's oracle on the card.  It replaces the JAX package's TPU kernel
``ssdx/ops/pallas_nms.py::nms_core_sorted``.
"""
from __future__ import annotations

import ctypes

import torch

from ..boxes import pairwise_diou, pairwise_iou
from . import _build

__all__ = ["nms_core_sorted", "nms_core_sorted_ref", "launches", "KINDS"]

KINDS = {"diou": pairwise_diou, "iou": pairwise_iou}  # the overlaps B1 computes

launches = 0  # kernel launches by nms_core_sorted

_lib = None


def nms_core_sorted_ref(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                        labels: torch.Tensor | None = None, kind: str = "diou"):
    """Plain version: the alternating fixpoint of ``ssdx/nms.py``, batched.

    Iterate ``s(j) = any i<j alive, of j's label, with O(i,j) > thresh``
    from "everyone alive" until nothing changes; the fixpoint is exact
    greedy NMS.
    """
    n = boxes.shape[1]
    after = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    sup = (KINDS[kind](boxes, boxes) > thresh) & after & valid[:, :, None]
    if labels is not None:
        sup &= labels[:, :, None] == labels[:, None, :]
    s = sup.any(dim=1)
    for _ in range(1, n):
        new = (sup & ~s[:, :, None]).any(dim=1)
        if torch.equal(new, s):
            break
        s = new
    return valid & ~s


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("nms")
        lib.ssdx_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.ssdx_nms_keep.restype = ctypes.c_int
        lib.ssdx_nms_max_k.restype = ctypes.c_int
        lib.ssdx_nms_scratch_words.argtypes = [ctypes.c_int]
        lib.ssdx_nms_scratch_words.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def nms_core_sorted(boxes: torch.Tensor, valid: torch.Tensor, thresh: float,
                    labels: torch.Tensor | None = None, kind: str = "diou") -> torch.Tensor:
    """Keep mask ``[B,K]`` (bool, sorted order) for greedy (D)IoU-NMS, per
    label when ``labels`` ([B,K] integers) is given."""
    global launches
    if kind not in KINDS:
        raise ValueError(f"nms_core_sorted: kind must be one of {sorted(KINDS)}, got {kind!r}")
    dev = boxes.device
    if dev.type == "cpu":
        return nms_core_sorted_ref(boxes, valid, thresh, labels, kind)
    if dev.type != "cuda":
        raise ValueError(f"nms_core_sorted: unsupported device {dev}")
    B, K, four = boxes.shape
    if four != 4 or tuple(valid.shape) != (B, K) or valid.device != dev:
        raise ValueError(f"nms_core_sorted: boxes {tuple(boxes.shape)}, valid "
                         f"{tuple(valid.shape)} on {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("nms_core_sorted takes float32 boxes and a bool mask")
    if labels is not None and (tuple(labels.shape) != (B, K) or labels.device != dev):
        raise ValueError(f"nms_core_sorted: labels {tuple(labels.shape)} on {labels.device}")
    lib = _kernel()
    if K > lib.ssdx_nms_max_k():
        raise ValueError(f"nms kernel takes K <= {lib.ssdx_nms_max_k()}, got {K}")
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads boxes as float4
        boxes = boxes.clone()
    v = valid.contiguous().view(torch.uint8)
    lab = None if labels is None else labels.to(torch.int32).contiguous()
    sup = torch.empty(B * lib.ssdx_nms_scratch_words(K), dtype=torch.int64, device=dev)
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = lib.ssdx_nms_keep(boxes.data_ptr(), v.data_ptr(),
                                None if lab is None else lab.data_ptr(), B, K, thresh,
                                int(kind == "iou"), sup.data_ptr(), keep.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    # The temporaries above are freed on return while the kernel may still
    # run; the caching allocator hands their memory only to later work on
    # this same stream, which runs after the kernel.
    if err:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    launches += 1
    return keep
