"""The numbers that decide ``correct`` in the ``ssd300_resnet50_coco``
cells (``drivers/serve_batches_r50.py::judge`` says what is compared with
what): ``compare``'s per-image pairing (``compare.compare_image``), read
for answers of up to ``max_per_img`` detections (``compare``'s own
``detection_numbers`` takes 100 at most), and more.

* ``box_gap_p90`` and ``wrong_answers`` as ``compare`` defines them, on
  boxes narrower (or shorter) than ``MIN_SIDE`` pixels widened about their
  centre to it: random weights decode some boxes past the frame, which the
  clamp to [0, 300] leaves with no area, and two such boxes have no IoU to
  pair them by;
* ``invalid_answers``: images whose answer never came or has the wrong
  form (more than ``max_per_img`` detections among them);
* ``altered_answers``: images with a same-detection pair whose scores
  differ by more than ``compare.SCORE_TOL``;
* ``nms_overlaps``: pairs of one answer's detections of one class whose
  IoU, in float64 on the answer's own boxes, exceeds the NMS threshold by
  more than ``OVERLAP_TOL``: what greedy IoU-NMS never keeps, whatever the
  network before it;
* ``unpaired_share``: of every detection on both sides, the percentage
  that is not one half of a same-detection pair (same class, IoU at least
  ``compare.SAME_PRIOR_IOU``): detections that one side resolves
  differently at the NMS, or pushes out of the best ``max_per_img``;
* ``head_gap`` (with ``loc_gap`` and ``conf_gap``): the network's heads
  against the reference's, by norm.
"""
from __future__ import annotations

import numpy as np

from .compare import LONE_TOL, SAME_PRIOR_IOU, SCORE_TOL, _iou, compare_image, valid_answer

MIN_SIDE = 1.0  # px
OVERLAP_TOL = 1e-5  # float32 IoU against float64 on the same boxes


def widened(det: dict) -> dict:
    """``det`` with each box's sides at least ``MIN_SIDE`` pixels."""
    b = np.asarray(det["boxes"], np.float64).reshape(-1, 4).copy()
    for lo, hi in ((0, 2), (1, 3)):
        c, half = (b[:, lo] + b[:, hi]) / 2, np.maximum(b[:, hi] - b[:, lo], MIN_SIDE) / 2
        b[:, lo], b[:, hi] = c - half, c + half
    return dict(det, boxes=b)


def head_gap(heads: list, ref_heads: list) -> dict:
    """How far the program's heads lie from the reference's, over batches
    of (loc, conf): ``loc_gap`` and ``conf_gap``, each the norm of the
    difference over the norm of the reference's, and ``head_gap``, the
    larger."""
    out = {}
    for k, name in ((0, "loc_gap"), (1, "conf_gap")):
        d = sum(float((h[k].double() - r[k].double()).pow(2).sum())
                for h, r in zip(heads, ref_heads))
        n = sum(float(r[k].double().pow(2).sum()) for r in ref_heads)
        out[name] = (d / n) ** 0.5 if n else 0.0
    out["head_gap"] = max(out["loc_gap"], out["conf_gap"])
    return out


def overlaps(det: dict, thresh: float) -> int:
    """Pairs of ``det``'s same-class detections at IoU > thresh + OVERLAP_TOL."""
    b = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
    lab = np.asarray(det["labels"])
    if len(b) < 2:
        return 0
    same = np.triu(lab[:, None] == lab[None, :], 1)
    return int(((_iou(b, b) > thresh + OVERLAP_TOL) & same).sum())


def detection_numbers(answers: list, refs: list, score_thresh: float, max_per_img: int,
                      nms_thresh: float) -> dict:
    """``answers[i]`` is the program's answer for the image whose reference
    detections are ``refs[i]`` (None: never came)."""
    wrong, invalid, altered, over = 0, 0, 0, 0
    pairs, lone, same_pairs, dets = [], [], 0, 0
    for a, r in zip(answers, refs):
        if a is None or not valid_answer(a, max_per_img):
            wrong += 1
            invalid += 1
            continue
        over += overlaps(a, nms_thresh)
        n = compare_image(widened(a), widened(r), score_thresh)
        same = [p[0] for p in n["pairs"] if p[4] >= SAME_PRIOR_IOU]
        altered += int(max(same, default=0.0) > SCORE_TOL)
        wrong += int(max(n["lone"], default=0.0) > LONE_TOL or max(same, default=0.0) > SCORE_TOL)
        pairs += n["pairs"]
        lone += n["lone"]
        same_pairs += len(same)
        dets += len(a["labels"]) + len(r["labels"])
    P = np.asarray(pairs, np.float64).reshape(-1, 5)
    col = lambda c: P[:, c] if len(P) else np.zeros(1)
    return {"box_gap_p90": float(np.quantile(col(2), 0.9)), "wrong_answers": wrong,
            "invalid_answers": invalid, "altered_answers": altered, "nms_overlaps": over,
            "unpaired_share": 100.0 * (dets - 2 * same_pairs) / dets if dets else 0.0,
            "images": len(answers), "pairs": len(P), "detections": dets,
            "box_gap_mean": float(col(2).mean()), "score_gap_mean": float(col(0).mean()),
            "logit_gap_mean": float(col(1).mean()), "score_gap_max": float(col(0).max()),
            "lone": len(lone), "lone_margin": max(lone, default=0.0)}
