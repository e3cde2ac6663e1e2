"""Batched, fixed-shape greedy DIoU non-maximum suppression.

Torch counterpart of ``ssdx/nms.py``: score-sort once (a stable argsort, so
invalid slots sink to the end in index order, as ``jnp.argsort`` does), run
the keep-mask core (:func:`ssdx_torch.ops.nms.nms_core_sorted`: the CUDA
kernel on the GPU, the plain fixpoint on the CPU) and scatter the mask back
to the original order.  Per-class NMS translates boxes by ``label * 4096``
so that boxes of different classes never suppress each other.
"""
from __future__ import annotations

import torch

from .ops.nms import nms_core_sorted

__all__ = ["batched_nms_mask", "nms_mask"]

_CLASS_OFFSET = 4096.0  # > any coordinate magnitude used (boxes live in [0, 300])


def batched_nms_mask(
    boxes: torch.Tensor,  # [B, N, 4] xyxy
    scores: torch.Tensor,  # [B, N]
    valid: torch.Tensor,  # [B, N] bool
    labels: torch.Tensor | None,  # [B, N] int; None => class-agnostic
    iou_threshold: float,
    class_aware: bool = True,
) -> torch.Tensor:
    """Bool keep mask [B, N] (original index space) for greedy DIoU-NMS."""
    if class_aware and labels is not None:
        boxes = boxes + labels.to(boxes.dtype)[..., None] * _CLASS_OFFSET

    neg = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-neg, dim=1, stable=True)  # descending; invalid last
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(valid, 1, order)
    keep_sorted = nms_core_sorted(b, v, iou_threshold)
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
