"""Batched, fixed-shape greedy (D)IoU non-maximum suppression.

Torch counterpart of ``ssdx/nms.py``: score-sort once (a stable argsort, so
invalid slots sink to the end in index order, as ``jnp.argsort`` does), run
the keep-mask core (:func:`ssdx_torch.ops.nms.nms_core_sorted`: the CUDA
kernel on the GPU, the plain fixpoint on the CPU) and scatter the mask back
to the original order.  Per-class NMS hands the core the sorted labels,
which compares them: boxes of different classes never suppress each other,
and the overlaps are those of the boxes as they are, whatever the number of
classes.  (The JAX package translates boxes by ``label * 4096`` instead;
at 80 classes that leaves float32 coordinates 1/32 px of precision.)
"""
from __future__ import annotations

import torch

from .ops.nms import nms_core_sorted

__all__ = ["batched_nms_mask", "nms_mask"]

def batched_nms_mask(
    boxes: torch.Tensor,  # [B, N, 4] xyxy
    scores: torch.Tensor,  # [B, N]
    valid: torch.Tensor,  # [B, N] bool
    labels: torch.Tensor | None,  # [B, N] int; None => class-agnostic
    iou_threshold: float,
    class_aware: bool = True,
    kind: str = "diou",
) -> torch.Tensor:
    """Bool keep mask [B, N] (original index space) for greedy NMS by
    ``kind``'s overlap: "diou" (the default) or "iou"."""
    neg = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-neg, dim=1, stable=True)  # descending; invalid last
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(valid, 1, order)
    lab = torch.gather(labels, 1, order) if class_aware and labels is not None else None
    keep_sorted = nms_core_sorted(b, v, iou_threshold, lab, kind)
    return torch.zeros_like(valid).scatter_(1, order, keep_sorted)


def nms_mask(
    boxes: torch.Tensor,  # [N, 4]
    scores: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N]
    iou_threshold: float,
    labels: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-image convenience wrapper around :func:`batched_nms_mask`."""
    return batched_nms_mask(
        boxes[None],
        scores[None],
        valid[None],
        None if labels is None else labels[None],
        iou_threshold,
        class_aware=labels is not None,
    )[0]
