"""Box geometry: format conversion, the IoU family, SSD offset encode/decode.

Torch counterpart of ``ssdx/boxes.py``, op for op: the NMS kernel
(``csrc/nms.cu``) evaluates :func:`pairwise_diou` with this exact sequence
of float32 operations, so the two give bit-identical keep masks.  All
functions accept arbitrary leading batch dimensions.

Boxes are float tensors of shape ``[..., 4]``; two formats are used:
  * ``xyxy``   — (x1, y1, x2, y2)
  * ``cxcywh`` — (cx, cy, w, h)
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "cxcywh_to_xyxy",
    "xyxy_to_cxcywh",
    "box_area",
    "pairwise_iou",
    "pairwise_diou",
    "pairwise_ciou",
    "encode",
    "decode",
]

_EPS = 1e-7


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    c, s = boxes[..., :2], boxes[..., 2:]
    half = 0.5 * s
    return torch.cat([c - half, c + half], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    lo, hi = boxes[..., :2], boxes[..., 2:]
    return torch.cat([0.5 * (lo + hi), hi - lo], dim=-1)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; negative extents clamp to zero."""
    wh = torch.clamp(boxes_xyxy[..., 2:] - boxes_xyxy[..., :2], min=0.0)
    return wh[..., 0] * wh[..., 1]


def _pairwise_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection areas for all pairs: a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain IoU matrix for xyxy boxes: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    inter = _pairwise_intersection(a, b)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=_EPS)


def _enclosing_lt_rb(a: torch.Tensor, b: torch.Tensor):
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    return lt, rb


def pairwise_diou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance-IoU matrix (Zheng et al. 2020): IoU - d²(centers)/diag²(hull)."""
    iou = pairwise_iou(a, b)
    lt, rb = _enclosing_lt_rb(a, b)
    e = rb - lt
    diag2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]
    ca = 0.5 * (a[..., :2] + a[..., 2:])
    cb = 0.5 * (b[..., :2] + b[..., 2:])
    d = ca[..., :, None, :] - cb[..., None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return iou - d2 / torch.clamp(diag2, min=_EPS)


def pairwise_ciou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete-IoU matrix: DIoU minus the aspect-ratio consistency term."""
    diou = pairwise_diou(a, b)
    wa = torch.clamp(a[..., 2] - a[..., 0], min=_EPS)
    ha = torch.clamp(a[..., 3] - a[..., 1], min=_EPS)
    wb = torch.clamp(b[..., 2] - b[..., 0], min=_EPS)
    hb = torch.clamp(b[..., 3] - b[..., 1], min=_EPS)
    ang = torch.atan(wb / hb)[..., None, :] - torch.atan(wa / ha)[..., :, None]
    v = (4.0 / (math.pi**2)) * torch.square(ang)
    iou = pairwise_iou(a, b)
    alpha = v / torch.clamp(1.0 - iou + v, min=_EPS)
    return diou - alpha * v


def encode(
    gt_cxcywh: torch.Tensor,
    priors_cxcywh: torch.Tensor,
    variances: tuple[float, float] = (0.1, 0.2),
) -> torch.Tensor:
    """SSD offset targets (tx, ty, tw, th) for matched GT boxes vs priors.

    t_xy = (gt_c - prior_c) / prior_wh / v_c ;  t_wh = log(gt_wh/prior_wh) / v_s
    with a 1e-12 clamp on the ratio.
    """
    v_c, v_s = variances
    t_xy = (gt_cxcywh[..., :2] - priors_cxcywh[..., :2]) / priors_cxcywh[..., 2:] / v_c
    ratio = torch.clamp(gt_cxcywh[..., 2:] / priors_cxcywh[..., 2:], min=1e-12)
    t_wh = torch.log(ratio) / v_s
    return torch.cat([t_xy, t_wh], dim=-1)


def decode(
    loc: torch.Tensor,
    priors_cxcywh: torch.Tensor,
    variances: tuple[float, float] = (0.1, 0.2),
) -> torch.Tensor:
    """Inverse of :func:`encode`; returns normalized cxcywh boxes.

    cx = tx*v_c*w_p + cx_p ; w = w_p*exp(tw*v_s).
    """
    v_c, v_s = variances
    c = loc[..., :2] * v_c * priors_cxcywh[..., 2:] + priors_cxcywh[..., :2]
    s = priors_cxcywh[..., 2:] * torch.exp(loc[..., 2:] * v_s)
    return torch.cat([c, s], dim=-1)
