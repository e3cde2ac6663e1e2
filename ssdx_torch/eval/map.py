"""Mean Average Precision @ IoU 0.5 with per-class and area-split breakdown.

The port's own copy of ``ssdx/eval/map.py`` (numpy, host side): the COCO
evaluation protocol restricted to one IoU threshold, with torchmetrics'
``MeanAveragePrecision(iou_thresholds=[0.5], class_metrics=True)`` key set:

  * detections matched greedily in score order to the highest-IoU unmatched
    GT of the same class within the image (IoU >= threshold);
  * PR curve from the global score-sorted TP/FP sequence per class;
  * AP = 101-point interpolated precision (COCO recall grid, with the
    precision envelope), averaged;
  * map = mean over classes that have at least one GT box; classes without
    GT report -1;
  * COCO area ranges small/medium/large (area in [0,32^2], [32^2,96^2],
    [96^2,1e10], boundaries inclusive like pycocotools) with pycocotools'
    *ignore* semantics;
  * mar_1 / mar_10 / mar_100: recall with at most 1/10/100 top-scoring
    detections per image per class, from one matching pass.

The greedy matching runs in C++ (``ssdx_torch/ops/native.py``) where a
compiler is present; the numpy loop ``_match_with_ignore`` is its oracle and
the version for a machine without one.
"""
from __future__ import annotations

import numpy as np

from ..ops import native as _native

__all__ = ["MeanAP", "AREA_RANGES"]

_RECALL_GRID = np.linspace(0.0, 1.0, 101)

# COCO area splits (pixel^2, at the evaluated image scale — the reference
# evaluates at 300x300, matching its torchmetrics invocation).
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain IoU between xyxy box sets [N,4] x [M,4] -> [N,M]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-9, None)


def _box_area(boxes: np.ndarray) -> np.ndarray:
    return np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
        boxes[:, 3] - boxes[:, 1], 0, None
    )


def _match_with_ignore(
    det_boxes: np.ndarray,  # [nd,4], score-descending order
    gt_boxes: np.ndarray,  # [ng,4]
    gt_ig: np.ndarray,  # [ng] bool
    iou_thresh: float,
) -> tuple[np.ndarray, np.ndarray]:
    """pycocotools evaluateImg matching for one (image, class, area range).

    Returns (tp [nd] bool, matched_ignored [nd] bool): tp = matched to a
    non-ignored GT; matched_ignored = matched to an ignored GT (the caller
    drops those rows from the PR sequence).
    """
    nd, ng = len(det_boxes), len(gt_boxes)
    tp = np.zeros(nd, bool)
    mig = np.zeros(nd, bool)
    if nd == 0 or ng == 0:
        return tp, mig
    order = np.argsort(gt_ig, kind="stable")  # non-ignored GTs first
    iou = _iou_matrix(det_boxes, gt_boxes[order])
    ig_sorted = gt_ig[order]
    gt_matched = np.zeros(ng, bool)
    thresh = min(iou_thresh, 1.0 - 1e-10)
    for d in range(nd):
        best = thresh
        m = -1
        for g in range(ng):
            if gt_matched[g]:
                continue
            # once matched to a non-ignored GT, never trade for an ignored one
            if m > -1 and not ig_sorted[m] and ig_sorted[g]:
                break
            if iou[d, g] < best:
                continue
            best = iou[d, g]
            m = g
        if m > -1:
            gt_matched[m] = True
            if ig_sorted[m]:
                mig[d] = True
            else:
                tp[d] = True
    return tp, mig


class MeanAP:
    """Streaming mAP@tau accumulator with the torchmetrics update/compute API.

    ``update(preds, targets)`` takes the reference's ragged contract: lists of
    per-image dicts with 'boxes' (xyxy), 'scores' (preds only), 'labels'.
    ``compute()`` returns the full torchmetrics key set for a
    ``iou_thresholds=[0.5]`` run (map == map_50; map_75 is -1 as the
    threshold is not evaluated; all area/maxDet variants ARE evaluated).
    """

    def __init__(self, iou_threshold: float = 0.5, max_detections: int = 100):
        self.iou_threshold = float(iou_threshold)
        self.max_detections = int(max_detections)
        self.reset()

    def reset(self) -> None:
        # per class: list of per-image (scores_desc, det_boxes_desc, gt_boxes)
        self._entries: dict[int, list[tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}

    def update(self, preds: list[dict], targets: list[dict]) -> None:
        if len(preds) != len(targets):
            raise ValueError("preds and targets must have equal length")
        for pred, tgt in zip(preds, targets):
            self._update_one(pred, tgt)

    def _update_one(self, pred: dict, tgt: dict) -> None:
        gt_boxes = np.asarray(tgt["boxes"], np.float64).reshape(-1, 4)
        gt_labels = np.asarray(tgt["labels"], np.int64).reshape(-1)

        boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(pred["scores"], np.float64).reshape(-1)
        labels = np.asarray(pred["labels"], np.int64).reshape(-1)
        if len(scores) > self.max_detections:
            keep = np.argsort(-scores, kind="stable")[: self.max_detections]
            boxes, scores, labels = boxes[keep], scores[keep], labels[keep]

        for c in np.unique(np.concatenate([labels, gt_labels])):
            c = int(c)
            det_idx = np.flatnonzero(labels == c)
            gt_idx = np.flatnonzero(gt_labels == c)
            order = det_idx[np.argsort(-scores[det_idx], kind="stable")]
            self._entries.setdefault(c, []).append(
                (scores[order], boxes[order], gt_boxes[gt_idx])
            )

    # ---- per-(class, range) evaluation ----

    def _eval_class_range(self, c: int, lo: float, hi: float):
        """Returns (rows, n_gt, tp_at_k) for one class and area range.

        rows: [n,2] (score, is_tp) over non-ignored detections only.
        tp_at_k: dict k -> total TPs using only each image's top-k dets.
        """
        ks = (1, 10, self.max_detections)
        rows_s: list[np.ndarray] = []
        rows_t: list[np.ndarray] = []
        n_gt = 0
        tp_at_k = {k: 0 for k in ks}
        for scores, det_boxes, gt_boxes in self._entries.get(c, []):
            gt_area = _box_area(gt_boxes)
            # pycocotools: inclusive on both ends (area < lo or area > hi ignores)
            gt_ig = (gt_area < lo) | (gt_area > hi)
            n_gt += int((~gt_ig).sum())
            if len(scores) == 0:
                continue
            # the C++ loop covers every range (ignore-aware); the numpy loop
            # is for a machine without a compiler
            match = (_native.match_detections_ignore if _native.available()
                     else _match_with_ignore)
            tp, mig = match(det_boxes, gt_boxes, gt_ig, self.iou_threshold)
            det_area = _box_area(det_boxes)
            det_out = (det_area < lo) | (det_area > hi)
            # dtIg: matched-to-ignored, or unmatched with out-of-range area
            dt_ig = mig | (~tp & ~mig & det_out)
            keep = ~dt_ig
            rows_s.append(scores[keep])
            rows_t.append(tp[keep])
            for k in ks:
                tp_at_k[k] += int(tp[:k].sum())
        if rows_s:
            s = np.concatenate(rows_s)
            t = np.concatenate(rows_t)
        else:
            s = np.zeros(0)
            t = np.zeros(0, bool)
        return s, t, n_gt, tp_at_k

    @staticmethod
    def _ap_from_rows(scores: np.ndarray, tps: np.ndarray, n_gt: int) -> float:
        if n_gt == 0:
            return -1.0
        if len(scores) == 0:
            return 0.0
        order = np.argsort(-scores, kind="stable")
        tps = tps[order]
        tp = np.cumsum(tps)
        fp = np.cumsum(~tps)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-9)
        # precision envelope (monotone non-increasing from the right)
        prec_env = np.maximum.accumulate(precision[::-1])[::-1]
        # 101-point interpolation: precision at first recall >= r (COCO)
        idx = np.searchsorted(recall, _RECALL_GRID, side="left")
        interp = np.where(
            idx < len(prec_env), prec_env[np.minimum(idx, len(prec_env) - 1)], 0.0
        )
        return float(np.mean(interp))

    @staticmethod
    def _mean_valid(values: np.ndarray) -> float:
        valid = values > -1.0
        return float(values[valid].mean()) if valid.any() else -1.0

    def compute(self) -> dict:
        """Result dict with the torchmetrics key set for a single-threshold
        run (iou_thresholds=[0.5]): 'map' equals 'map_50'; 'map_75' reports
        -1 (threshold not evaluated, torchmetrics convention); area splits
        and mar_1/10/100 are computed at IoU 0.5."""
        classes = sorted(self._entries)
        n = len(classes)
        aps = {r: np.full(n, -1.0, np.float32) for r in AREA_RANGES}
        ars = {r: np.full(n, -1.0, np.float32) for r in AREA_RANGES}
        mar_k = {k: np.full(n, -1.0, np.float32) for k in (1, 10, self.max_detections)}

        for i, c in enumerate(classes):
            for rname, (lo, hi) in AREA_RANGES.items():
                s, t, n_gt, tp_at_k = self._eval_class_range(c, lo, hi)
                aps[rname][i] = self._ap_from_rows(s, t, n_gt)
                if n_gt > 0:
                    ars[rname][i] = tp_at_k[self.max_detections] / n_gt
                    if rname == "all":
                        for k in mar_k:
                            mar_k[k][i] = tp_at_k[k] / n_gt

        map_50 = self._mean_valid(aps["all"])
        return {
            "map": map_50,  # only IoU=0.5 is evaluated
            "map_50": map_50,
            "map_75": -1.0,
            "map_small": self._mean_valid(aps["small"]),
            "map_medium": self._mean_valid(aps["medium"]),
            "map_large": self._mean_valid(aps["large"]),
            "mar_1": self._mean_valid(mar_k[1]),
            "mar_10": self._mean_valid(mar_k[10]),
            "mar_100": self._mean_valid(mar_k[self.max_detections]),
            "mar_small": self._mean_valid(ars["small"]),
            "mar_medium": self._mean_valid(ars["medium"]),
            "mar_large": self._mean_valid(ars["large"]),
            "mar_100_per_class": ars["all"],
            "map_per_class": aps["all"],
            "classes": np.asarray(classes, np.int64),
        }
