"""The numbers that decide ``correct``: the program's answers against the
reference's, each number beside the limit of its cell.

Detections (serving cells).  Per image, the program's detections and the
reference's are paired one to one, same class, highest IoU first (at least
``PAIR_IOU``); a pair at IoU ``SAME_PRIOR_IOU`` or more is one detection
seen by both sides.  A detection with no same-class detection on the other
side at IoU ``COVER_IOU`` or more is lone; its margin is its score above
the larger of the score threshold and the reference's top-k cut (the least
score the candidate stages let through).  Two numbers:

* ``box_gap_p90``: the 90th percentile over all pairs of the largest
  coordinate gap, in pixels of the 300x300 frame: the precision of the
  whole forward and decode (of the statistics tried, the one that
  separates the program from its lower-precision control the most;
  ``PERF.md``);
* ``wrong_answers``: images whose answer never came, has the wrong form,
  has a lone detection with a margin above ``LONE_TOL``, or a
  same-detection pair whose scores differ by more than ``SCORE_TOL``: a
  lost, invented or altered answer (limit 0).  A detection one side keeps
  and the other drops at a threshold or at the top-k cut reads a small
  margin; one that the two sides resolve differently at the DIoU
  threshold overlaps its suppressor at an IoU above 0.3 and is not lone.

Training (``train_numbers``): the checked steps run at the middle of the
learning-rate schedule, where three steps from random weights move the
parameters far enough that the later steps' losses and the leaves' worst
gaps swing from run to run even in float32 (``PERF.md``).  Each leaf's
gradient and change are compared by norms: the gap between the two sides'
norms over the larger of the reference's norm and the median leaf's.
Compared: the first step's loss (``loss_gap``; the later steps' swing);
the first gradient's gap averaged over the leaves (``grad_gap_mean``:
float8 convolutions move every leaf, where the median and upper
percentiles separate them less); the worst gap of the leaves whose
gradients kernel B3 computes (``stem_grad_gap``: conv1_1 and conv1_2 with
their BatchNorm, whose near-cancelling sums read 0.04-0.21 in sound runs,
as the reference itself reads in bfloat16); and the median leaf's change
over the three steps (``update_gap_median``).  The three steps' losses,
the medians, upper percentiles and worst leaves are reported beside them.
Leaves whose reference gradient is below a thousandth of the median
leaf's (zero up to rounding, as a conv bias before BatchNorm) are left out.
"""
from __future__ import annotations

import numpy as np

PAIR_IOU = 0.5
SAME_PRIOR_IOU = 0.9
COVER_IOU = 0.25
LONE_TOL = 0.1  # sound runs read at most 0.018 (int8 cell), 0.005 (bf16 cells)
SCORE_TOL = 0.2  # sound runs read at most 0.068 (int8 cell), 0.019 (bf16 cells)
STEM_LEAVES = ("conv0.", "conv1.")  # conv1_1 and conv1_2 with their BatchNorm: kernel B3's


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def compare_image(prog: dict, ref: dict, score_thresh: float) -> dict:
    """Numbers of one image's detections (dicts of labels, scores, boxes)."""
    pl, ps, pb = (np.asarray(prog[k], np.float64) for k in ("labels", "scores", "boxes"))
    rl, rs, rb = (np.asarray(ref[k], np.float64) for k in ("labels", "scores", "boxes"))
    pb, rb = pb.reshape(-1, 4), rb.reshape(-1, 4)
    iou = _iou(pb, rb) if len(pb) and len(rb) else np.zeros((len(pb), len(rb)))
    same = pl[:, None] == rl[None, :]
    cand = np.where(same & (iou >= PAIR_IOU), iou, -1.0)
    pairs = []  # (|score gap|, |logit gap|, box gap px, box gap / box side, IoU)
    logit = lambda x: np.log(np.clip(x, 1e-6, 1 - 1e-6) / np.clip(1 - x, 1e-6, 1))
    while cand.size and cand.max() >= PAIR_IOU:
        i, j = np.unravel_index(np.argmax(cand), cand.shape)
        side = max(rb[j, 2] - rb[j, 0], rb[j, 3] - rb[j, 1], 1.0)
        gap = float(np.abs(pb[i] - rb[j]).max())
        pairs.append((abs(ps[i] - rs[j]), abs(logit(ps[i]) - logit(rs[j])), gap, gap / side,
                      iou[i, j]))
        cand[i, :] = cand[:, j] = -1.0
    floor = max(score_thresh, float(ref.get("cut", 0.0)))
    covered = same & (iou >= COVER_IOU)
    lone = [s - floor for s, c in zip(ps, covered.any(1)) if not c]
    lone += [s - floor for s, c in zip(rs, covered.any(0)) if not c]
    return {"pairs": pairs, "lone": lone}


def valid_answer(a, n_boxes_max: int = 100) -> bool:
    try:
        n = len(a["labels"])
        return (len(a["scores"]) == n and np.asarray(a["boxes"]).reshape(-1, 4).shape[0] == n
                and n <= n_boxes_max and bool(np.isfinite(np.asarray(a["scores"])).all()))
    except (KeyError, TypeError, ValueError):
        return False


def detection_numbers(answers: list, refs: list, score_thresh: float) -> dict:
    """``answers[i]`` is the program's answer for the image whose reference
    detections are ``refs[i]`` (None: never came)."""
    wrong, pairs, lone = 0, [], []
    for a, r in zip(answers, refs):
        if a is None or not valid_answer(a):
            wrong += 1
            continue
        n = compare_image(a, r, score_thresh)
        same = [p[0] for p in n["pairs"] if p[4] >= SAME_PRIOR_IOU]
        wrong += int(max(n["lone"], default=0.0) > LONE_TOL or max(same, default=0.0) > SCORE_TOL)
        pairs += n["pairs"]
        lone += n["lone"]
    P = np.asarray(pairs, np.float64).reshape(-1, 5)
    col = lambda c: P[:, c] if len(P) else np.zeros(1)
    return {"box_gap_p90": float(np.quantile(col(2), 0.9)), "wrong_answers": wrong,
            "images": len(answers), "pairs": len(P), "box_gap_mean": float(col(2).mean()),
            "score_gap_mean": float(col(0).mean()), "logit_gap_mean": float(col(1).mean()),
            "score_gap_max": float(col(0).max()), "lone": len(lone),
            "lone_margin": max(lone, default=0.0)}


def _gap(prog: float, ref: float, floor: float) -> float:
    return abs(prog - ref) / max(abs(ref), floor, 1e-30)


def leafwise_gap(prog: dict, ref: dict, names, among=None) -> tuple[float, str]:
    """Worst leaf of ``names`` by |‖prog‖ - ‖ref‖| / max(‖ref‖, the median
    ‖ref‖ of the leaves ``among`` (default ``names``)), and its name."""
    med = float(np.median([ref[n] for n in (names if among is None else among)]))
    return max((_gap(prog[n], ref[n], med), n) for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (three floats), ``grad_norms``
    and ``change_norms`` (leaf name -> norm); ``ref`` also gives the leaves
    compared through its gradient norms."""
    med = float(np.median(list(ref["grad_norms"].values())))
    names = [n for n, v in ref["grad_norms"].items() if v >= 1e-3 * med]
    stem = [n for n in names if n.startswith(STEM_LEAVES)]
    grad_worst, grad_leaf = leafwise_gap(prog["grad_norms"], ref["grad_norms"], names)
    update_worst, update_leaf = leafwise_gap(prog["change_norms"], ref["change_norms"], names)
    stem_grad, stem_grad_leaf = leafwise_gap(prog["grad_norms"], ref["grad_norms"], stem, names)
    stem_update, stem_update_leaf = leafwise_gap(prog["change_norms"], ref["change_norms"],
                                                 stem, names)
    med_gap = lambda k: float(np.median([_gap(prog[k][n], ref[k][n], 0.0) for n in names]))
    gmed = float(np.median([ref["grad_norms"][n] for n in names]))
    grad_gaps = [_gap(prog["grad_norms"][n], ref["grad_norms"][n], gmed) for n in names]
    loss_gaps = [_gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"])]
    return {
        "loss_gap": loss_gaps[0], "grad_gap_mean": float(np.mean(grad_gaps)),
        "stem_grad_gap": stem_grad, "update_gap_median": med_gap("change_norms"),
        "grad_gap_median": med_gap("grad_norms"),
        "grad_gap_p75": float(np.percentile(grad_gaps, 75)),
        "loss_gap_steps": max(loss_gaps), "stem_update_gap": stem_update,
        "grad_gap_worst": grad_worst, "update_gap_worst": update_worst,
        "grad_worst_leaf": grad_leaf, "update_worst_leaf": update_leaf,
        "stem_grad_leaf": stem_grad_leaf, "stem_update_leaf": stem_update_leaf,
        "losses": prog["losses"], "ref_losses": ref["losses"],
        "leaves": len(names), "leaves_left_out": len(ref["grad_norms"]) - len(names),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
