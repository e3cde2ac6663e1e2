"""Batched prior / ground-truth matching and target encoding.

Torch counterpart of ``ssdx/matching.py``.  Ground truth is padded to a
fixed ``G`` with a validity mask and the whole batch is matched at once
from one ``[B, P, G]`` CIoU matrix:

  * padded GT columns get ``_NEG``, below any real CIoU (range [-2, 1]);
  * forced bipartite step: each valid GT's best prior gets 2.0, so every GT
    has at least one positive;
  * pos = best IoU per prior >= ``iou_thresh``;
  * class targets are shifted by +1, background = 0; an image without
    valid GT gets an all-background target.

Every argmax takes the first index on ties, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import boxes as B

__all__ = ["Targets", "match_one", "build_targets"]

_NEG = -1e4


class Targets(NamedTuple):
    """Fixed-shape encoding targets for a batch.

    loc: [B, P, 4] offset targets (garbage on negatives -- always mask).
    cls: [B, P] int32 class targets, 0 = background.
    pos: [B, P] bool positive-prior mask.
    """

    loc: torch.Tensor
    cls: torch.Tensor
    pos: torch.Tensor


def _match(gt_xyxy, gt_labels, gt_valid, priors_cxcywh, priors_xyxy, iou_thresh, variances):
    """Batched matching: gt [B, G, 4], labels/valid [B, G]; priors [P, 4]."""
    P = priors_xyxy.shape[0]
    iou = B.pairwise_ciou(priors_xyxy, gt_xyxy)  # [B, P, G]
    valid = gt_valid[:, None, :]
    iou = torch.where(valid, iou, torch.full_like(iou, _NEG))

    best_prior_per_gt = torch.argmax(iou, dim=1)  # [B, G]
    prior_idx = torch.arange(P, device=iou.device)[None, :, None]
    forced = (prior_idx == best_prior_per_gt[:, None, :]) & valid
    iou = torch.where(forced, torch.full_like(iou, 2.0), iou)

    best_gt = torch.argmax(iou, dim=2)  # [B, P]
    best_iou = torch.amax(iou, dim=2)
    pos = best_iou >= iou_thresh

    # The JAX package picks the payload with a one-hot f32 matmul at full
    # precision; a gather is the same, exactly.
    gt_cxcywh = B.xyxy_to_cxcywh(gt_xyxy)
    matched = torch.gather(gt_cxcywh, 1, best_gt[..., None].expand(-1, -1, 4))
    label = torch.gather(gt_labels.long(), 1, best_gt)
    safe = torch.cat([matched[..., :2], torch.clamp(matched[..., 2:], min=1e-6)], dim=-1)
    loc_t = B.encode(safe, priors_cxcywh, variances)
    cls_t = torch.where(pos, label + 1, torch.zeros_like(label)).to(torch.int32)
    return loc_t, cls_t, pos


def match_one(
    gt_xyxy: torch.Tensor,  # [G, 4] normalized xyxy (padded)
    gt_labels: torch.Tensor,  # [G] int, 0..C-2 foreground ids (padded)
    gt_valid: torch.Tensor,  # [G] bool
    priors_cxcywh: torch.Tensor,  # [P, 4]
    priors_xyxy: torch.Tensor,  # [P, 4]
    iou_thresh: float,
    variances: tuple[float, float] = (0.1, 0.2),
):
    """Match one image's (padded) GT set against all priors:
    (loc [P, 4], cls [P] int32, pos [P] bool)."""
    loc, cls, pos = _match(gt_xyxy[None], gt_labels[None], gt_valid[None], priors_cxcywh,
                           priors_xyxy, iou_thresh, variances)
    return loc[0], cls[0], pos[0]


def build_targets(
    gt_xyxy: torch.Tensor,  # [B, G, 4] normalized xyxy
    gt_labels: torch.Tensor,  # [B, G]
    gt_valid: torch.Tensor,  # [B, G] bool
    priors_cxcywh: torch.Tensor,
    priors_xyxy: torch.Tensor,
    iou_thresh: float = 0.5,
    variances: tuple[float, float] = (0.1, 0.2),
) -> Targets:
    """Batched matching of the whole batch; GT boxes normalized to [0, 1]."""
    loc, cls, pos = _match(gt_xyxy, gt_labels, gt_valid.bool(), priors_cxcywh, priors_xyxy,
                           iou_thresh, variances)
    return Targets(loc=loc, cls=cls, pos=pos)
