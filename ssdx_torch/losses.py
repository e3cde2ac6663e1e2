"""Multibox loss: Smooth-L1 localization + hard-negative-mined cross-entropy.

Torch counterpart of ``ssdx/losses.py``.  Hard negatives are mined for the
whole batch at once with a rank mask (a double stable argsort), so the loss
is a fixed-shape computation with no host round trip:

  * loc loss: Smooth-L1 (beta=1) summed over positive priors, / total_pos,
    total_pos = clamp(sum(pos), 1);
  * conf loss: CE of all positives + the top ``floor(ratio * n_pos_i)``
    hardest negatives per image; images with zero positives still mine
    ``int(ratio)`` negatives;
  * returned as (ce_pos + ce_neg) / total_pos.
"""
from __future__ import annotations

import torch

__all__ = ["smooth_l1", "cross_entropy_per_prior", "multibox_loss"]


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Smooth-L1 (Huber), as torch's smooth_l1_loss."""
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def cross_entropy_per_prior(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-prior CE: logits [B, P, C], labels [B, P] int -> [B, P] float32."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - picked


def multibox_loss(
    loc_pred: torch.Tensor,  # [B, P, 4]
    cls_logits: torch.Tensor,  # [B, P, C]
    loc_target: torch.Tensor,  # [B, P, 4]
    cls_target: torch.Tensor,  # [B, P] int (0 = background)
    pos_mask: torch.Tensor,  # [B, P] bool
    neg_pos_ratio: float = 3.0,
    img_valid: torch.Tensor | None = None,  # [B] bool; None = all valid
    total_pos: torch.Tensor | None = None,  # scalar; None = this batch's own count
):
    """Return (total, loc_loss, conf_loss), each a float32 scalar tensor.

    ``img_valid`` excludes wrap-around padded tail images from every term
    (positives, mined negatives and the zero-positive ``int(ratio)`` floor),
    so a padded eval batch reports the loss of its real images alone.
    ``total_pos`` replaces the divisor ``clamp(sum(pos), 1)``: a rank that
    holds one shard of a global batch passes the global batch's count, and
    the shards' losses then add up to the global batch's loss.
    """
    posf = pos_mask.float()
    if img_valid is not None:
        posf = posf * img_valid.float()[:, None]
    num_pos = posf.sum(dim=1)  # [B]
    if total_pos is None:
        total_pos = torch.clamp(num_pos.sum(), min=1.0)

    # ---- localization (positives only) ----
    l1 = smooth_l1(loc_pred - loc_target).sum(dim=-1)  # [B, P]
    loc_loss = (l1 * posf).sum() / total_pos

    # ---- classification with hard-negative mining ----
    ce = cross_entropy_per_prior(cls_logits, cls_target)  # [B, P]
    ce_pos = (ce * posf).sum()

    # rank negatives per image by CE descending; positives go to the end
    neg_ce = torch.where(pos_mask, torch.full_like(ce, -torch.inf), ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)  # position of p in the sort
    max_negs = torch.where(
        num_pos == 0.0,
        torch.full_like(num_pos, float(int(neg_pos_ratio))),
        torch.floor(neg_pos_ratio * num_pos),
    )  # [B]
    if img_valid is not None:
        max_negs = max_negs * img_valid.float()
    neg_keep = (rank < max_negs[:, None]) & ~pos_mask
    ce_neg = torch.where(neg_keep, ce, torch.zeros_like(ce)).sum()

    conf_loss = (ce_pos + ce_neg) / total_pos
    return loc_loss + conf_loss, loc_loss, conf_loss
