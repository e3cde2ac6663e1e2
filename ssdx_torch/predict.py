"""Batched detection post-processing: decode, threshold, NMS, top-k.

Torch counterpart of ``ssdx/predict.py``, step for step, with fixed shapes
and no host synchronisation on the GPU:

  1. stage-1 ranking of priors by a monotone logit-space key
     (max foreground logit - logsumexp), top ``prior_top_k`` priors;
  2. softmax only for those priors; stage-2 top ``top_k_candidates``
     (prior, class) pairs;
  3. decode at stage-1 granularity to 300x300-pixel xyxy, clipped;
  4. batched per-class greedy NMS (:mod:`ssdx_torch.nms`) by DIoU, or by
     IoU with ``nms_kind="iou"`` (NVIDIA's SSD300 v1.1);
  5. final top ``max_per_img`` among the kept, valid pairs.

``prior_top_k``/``top_k_candidates`` default to 200/400, widened to
800/1600 when ``score_thresh < 0.1``.  Every top-k is a stable descending
sort cut to k, so ties go to the lower index first, as ``lax.top_k`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import boxes as B
from .model import IMAGE_SIZE
from .nms import batched_nms_mask
from .utils.profiling import span

__all__ = ["Detections", "postprocess", "to_pylist"]


class Detections(NamedTuple):
    """Fixed-size padded detections for a batch.

    boxes:  [B, D, 4] xyxy in 300x300 pixel coords.
    scores: [B, D] float32.
    labels: [B, D] int32 0-based foreground ids (0..C-2).
    valid:  [B, D] bool.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (as lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, i], ...]`` for x [B, N, D] and idx [B, M]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def postprocess(
    loc_all: torch.Tensor,  # [B, P, 4]
    conf_all: torch.Tensor,  # [B, P, C]
    priors_cxcywh: torch.Tensor,  # [P, 4]
    score_thresh: float = 0.2,
    nms_thresh: float = 0.5,
    max_per_img: int = 100,
    class_agnostic: bool = False,
    top_k_candidates: int | None = None,
    prior_top_k: int | None = None,
    variances: tuple[float, float] = (0.1, 0.2),
    nms_kind: str = "diou",
) -> Detections:
    """Decode + threshold + NMS for a whole batch.  The span
    ``ssdx_torch.predict.postprocess`` counts the stage-2 candidates
    (``nms_candidates``), B x K (``nms_slots``) and the candidates NMS keeps
    (``nms_kept``)."""
    if not (0.0 <= score_thresh < 1.0):
        raise ValueError(f"score_thresh must be in [0, 1), got {score_thresh}")
    if not (0.0 < nms_thresh < 1.0):
        raise ValueError(f"nms_thresh must be in (0, 1), got {nms_thresh}")
    if prior_top_k is None:
        prior_top_k = 200 if score_thresh >= 0.1 else 800
    if top_k_candidates is None:
        top_k_candidates = 2 * prior_top_k

    with span("ssdx_torch.predict.postprocess") as sp:
        Bsz, P, C = conf_all.shape
        n_fg = C - 1
        Kp = min(prior_top_k, P)
        K = min(top_k_candidates, Kp * n_fg)

        # stage 1: top priors by best foreground class, ranked in logit space
        key = conf_all[..., 1:].amax(dim=-1) - torch.logsumexp(conf_all, dim=-1)
        _, prior_sel = _top_k(key, Kp)  # [B, Kp]
        pair_scores = torch.softmax(_take(conf_all, prior_sel), dim=-1)[..., 1:]

        # decode the Kp selected priors once; pairs gather decoded boxes
        dec = B.decode(_take(loc_all, prior_sel), priors_cxcywh[prior_sel], variances)
        xyxy_p = torch.clamp(B.cxcywh_to_xyxy(dec), 0.0, 1.0) * IMAGE_SIZE

        # stage 2: top pairs among the selected priors' class columns
        top_scores, pair_idx = _top_k(pair_scores.reshape(Bsz, -1), K)
        cls_idx = (pair_idx % n_fg).to(torch.int32)  # [B, K]
        valid = top_scores > score_thresh
        sp.count(nms_candidates=valid, nms_slots=Bsz * K)
        xyxy = _take(xyxy_p, pair_idx // n_fg)

        keep = batched_nms_mask(xyxy, top_scores, valid, cls_idx, nms_thresh,
                                class_aware=not class_agnostic, kind=nms_kind)
        sp.count(nms_kept=keep & valid)

        kept_scores = torch.where(keep & valid, top_scores, torch.full_like(top_scores, -1.0))
        final_scores, sel = _top_k(kept_scores, max_per_img)
        return Detections(
            boxes=_take(xyxy, sel),
            scores=torch.clamp(final_scores, min=0.0),
            labels=torch.gather(cls_idx, 1, sel),
            valid=final_scores > 0,
        )


def to_pylist(det: Detections) -> list[dict]:
    """Padded :class:`Detections` -> a list of ``{"labels", "scores",
    "boxes"}`` numpy dicts per image (labels 0-based, boxes xyxy in 300x300
    pixel coordinates).  The first copy waits for the batch (span
    ``.wait``); the rest is the host's own (``.unpack``)."""
    with span("ssdx_torch.predict.to_pylist"):
        with span("ssdx_torch.predict.to_pylist.wait"):
            boxes = det.boxes.cpu().numpy()
        with span("ssdx_torch.predict.to_pylist.unpack"):
            scores = det.scores.cpu().numpy()
            labels = det.labels.cpu().numpy()
            valid = det.valid.cpu().numpy()
            out = []
            for b in range(boxes.shape[0]):
                m = valid[b]
                out.append(
                    {
                        "labels": labels[b][m].astype(np.int64),
                        "scores": scores[b][m].astype(np.float32),
                        "boxes": boxes[b][m].astype(np.float32),
                    }
                )
    return out
