"""Check the NMS kernel B1 on one GPU against its plain version, bit for bit.

    python -m ssdx_torch.tools.check_nms

B1 (``ops.nms.nms_core_sorted``, ``csrc/nms.cu``) against
``nms_core_sorted_ref`` at B = 32 and B = 1, K = 1, 64, 65, 400, 1600 and
8192, on two kinds of candidates: "clustered" (boxes around a few centres,
long suppression chains; the last 7 of each row invalid) and "grid" (integer
coordinates on a small grid: duplicates, boxes that only touch, DIoUs that
repeat exactly; random invalid candidates and, at B > 1, one image with none
valid), class-aware by the 4096 offset that ``nms.py`` used to add, by
labels handed to the kernel, and agnostic, at the thresholds 0, 0.3, 0.5,
-0.2 (every pair takes the full overlap) and "tie": an overlap that pairs
of the data reach exactly, so that ties on the threshold decide; each by
DIoU and by IoU.  Then "coco": 80 classes, pairs placed 1e-4 either side
of the IoU and DIoU thresholds 0.5 (``near_threshold``), by labels.  The
keep masks must be equal bit for bit.  The plain version runs
on slices of at most ``ref_batch(K)`` images.  Prints one line per (B, K)
and exits non-zero on the first mismatch.  Correctness only:
``chip_smoke.py`` phase 7 and ``tools/profile_split.py`` time the kernel.
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ssdx_torch.ops import nms as nms_ops

BATCHES = (32, 1)
KS = (1, 64, 65, 400, 1600, 8192)
THRESHOLDS = (0.0, 0.3, 0.5, -0.2, "tie")
KINDS = ("diou", "iou")
CLASS_OFFSET = 4096.0  # the per-class translation nms.py used before it passed labels
CLASSES = ("offset", "labels", False)  # how classes are kept apart; False: agnostic


def _sorted(boxes, scores, labels, valid, class_aware):
    """Boxes, valid flags and labels (None unless ``class_aware`` is
    "labels") in descending score order, invalid candidates last, as
    ``nms.batched_nms_mask`` hands them to the core; ``class_aware``
    "offset" translates each box by its label x 4096 first."""
    if class_aware == "offset":
        boxes = boxes + labels.float()[..., None] * CLASS_OFFSET
    neg = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-neg, dim=1, stable=True)
    lab = torch.gather(labels, 1, order).int().contiguous() if class_aware == "labels" else None
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous(),
            torch.gather(valid, 1, order).contiguous(), lab)


def nms_inputs(dev, B, K, seed, class_aware="offset"):
    """Score-sorted candidates clustered around a few centres (long
    suppression chains), classes kept apart as ``class_aware`` says; the
    last 7 of each row invalid.  (boxes, valid, labels or None)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(30, 270, (B, 12, 2))
    pick = rng.integers(0, 12, (B, K))
    lo = centers[np.arange(B)[:, None], pick] + rng.normal(0, 6, (B, K, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(15, 50, (B, K, 2))], -1)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    scores = torch.as_tensor(rng.uniform(0.01, 1.0, (B, K)), dtype=torch.float32, device=dev)
    labels = torch.as_tensor(rng.integers(0, 5, (B, K)), device=dev)
    valid = torch.ones((B, K), dtype=torch.bool, device=dev)
    valid[:, -min(7, K):] = False
    return _sorted(boxes, scores, labels, valid, class_aware)


def grid_inputs(dev, B, K, seed, class_aware="offset"):
    """Integer boxes on a 24 x 24 grid, 1-6 wide: duplicates, boxes that only
    touch (intersection exactly 0), DIoUs that repeat exactly; a fifth of the
    candidates invalid, and at B > 1 image 0 with none valid."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 24, (B, K, 2))
    boxes = np.concatenate([lo, lo + rng.integers(1, 7, (B, K, 2))], -1)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    scores = torch.as_tensor(rng.uniform(0.01, 1.0, (B, K)), dtype=torch.float32, device=dev)
    labels = torch.as_tensor(rng.integers(0, 3, (B, K)), device=dev)
    valid = torch.as_tensor(rng.uniform(size=(B, K)) > 0.2, device=dev)
    if B > 1:
        valid[0] = False
    return _sorted(boxes, scores, labels, valid, class_aware)


def near_threshold(dev, B, K, seed, kind, thresh=0.5, gap=1e-4, classes=80):
    """80-class candidates in pairs whose overlap (``kind``) is ``thresh``
    +- ``gap`` on the boxes as they are: the first box of a pair a random
    box of 20-120 px, the second its copy shifted along x so that the
    overlap lands just above or below the threshold.  Behind a class offset
    of label x 4096 (1/32 px of float32 precision at label 79) such pairs
    can be decided either way; by labels they are decided on the boxes.
    Score-sorted, labels handed to the core."""
    rng = np.random.default_rng(seed)
    n = K // 2
    lo = rng.uniform(0, 180, (B, n, 2))
    wh = rng.uniform(20, 120, (B, n, 2))
    a = np.concatenate([lo, lo + wh], -1)
    target = thresh + np.where(rng.uniform(size=(B, n)) < 0.5, gap, -gap)
    w, h = wh[..., 0], wh[..., 1]
    if kind == "iou":  # IoU of a box and its copy shifted by s: (w-s)/(w+s)
        s = w * (1 - target) / (1 + target)
    else:  # solve DIoU(s) = target by bisection on the shift
        s_lo, s_hi = np.zeros_like(w), w.copy()
        for _ in range(80):
            s = (s_lo + s_hi) / 2
            iou = (w - s) / (w + s)
            d = iou - s * s / ((w + s) ** 2 + h * h)
            s_lo, s_hi = np.where(d > target, s, s_lo), np.where(d > target, s_hi, s)
        s = (s_lo + s_hi) / 2
    b = a.copy()
    b[..., 0] += s
    b[..., 2] += s
    boxes = np.stack([a, b], 2).reshape(B, 2 * n, 4)
    labels = np.repeat(rng.integers(0, classes, (B, n)), 2, axis=1)
    if K % 2:  # one more candidate, alone
        boxes = np.concatenate([boxes, np.tile([[[0.0, 0.0, 10.0, 10.0]]], (B, 1, 1))], 1)
        labels = np.concatenate([labels, np.zeros((B, 1), labels.dtype)], 1)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    scores = torch.as_tensor(np.sort(rng.uniform(0.05, 1.0, (B, K)))[:, ::-1].copy(),
                             dtype=torch.float32, device=dev)
    valid = torch.ones((B, K), dtype=torch.bool, device=dev)
    return _sorted(boxes, scores, torch.as_tensor(labels, device=dev), valid, "labels")


def tie_threshold(boxes, kind="diou") -> float:
    """An overlap in (0, 1) that pairs of the first image reach exactly: the
    median of the positive float32 overlaps among its first 64 boxes (0.25
    where there is none)."""
    n = min(64, boxes.shape[1])
    d = nms_ops.KINDS[kind](boxes[:1, :n], boxes[:1, :n]).flatten()
    d = d[(d > 0) & (d < 1)]
    return float(d.sort().values[len(d) // 2]) if len(d) else 0.25


def ref_batch(K: int) -> int:
    """Images per call of the plain version: its [B,K,K] temporaries stay
    near a gigabyte."""
    return max(1, min(32, (1 << 28) // (K * K)))


def keep_ref(boxes, valid, thresh, labels=None, kind="diou"):
    step = ref_batch(boxes.shape[1])
    return torch.cat([nms_ops.nms_core_sorted_ref(
        boxes[i:i + step], valid[i:i + step], thresh,
        None if labels is None else labels[i:i + step], kind)
        for i in range(0, boxes.shape[0], step)])


def _case(B, K, what, boxes, valid, labels, thresh, kind) -> int:
    got = nms_ops.nms_core_sorted(boxes, valid, thresh, labels, kind)
    ref = keep_ref(boxes, valid, thresh, labels, kind)
    if got.is_cuda:
        torch.cuda.synchronize()
    bad = int((got != ref).sum())
    if bad or got.shape != (B, K) or got.dtype != torch.bool:
        raise AssertionError(f"B1 B={B} K={K} {what} {kind} thresh={thresh!r}: "
                             f"{bad} of {B * K} keep bits differ")
    return int(got.sum())


def check(dev, batches=BATCHES, ks=KS, log=print) -> dict:
    """Every case bit for bit; returns {(B, K): (cases, kept)} and raises on
    the first mismatch."""
    res = {}
    for B in batches:
        for K in ks:
            cases = kept = 0
            for data, make in (("clustered", nms_inputs), ("grid", grid_inputs)):
                for classes in CLASSES:
                    boxes, valid, labels = make(dev, B, K, seed=K + 7 * B + bool(classes),
                                                class_aware=classes)
                    for kind in KINDS:
                        for t in THRESHOLDS:
                            thresh = tie_threshold(boxes, kind) if t == "tie" else t
                            kept += _case(B, K, f"{data} classes={classes}", boxes, valid,
                                          labels, thresh, kind)
                            cases += 1
            if K >= 2:
                for kind in KINDS:
                    boxes, valid, labels = near_threshold(dev, B, K, seed=K + B, kind=kind)
                    kept += _case(B, K, "coco near-threshold", boxes, valid, labels, 0.5, kind)
                    cases += 1
            log(f"B1 B={B:2d} K={K:4d}: {cases} cases (clustered and grid, classes by offset, "
                f"by labels and agnostic, DIoU and IoU, thresholds "
                f"{', '.join(map(str, THRESHOLDS))}; 80 classes near the threshold), {kept} kept "
                f"in all, keep masks equal to the plain version's bit for bit")
            res[(B, K)] = (cases, kept)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("check_nms: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    check(torch.device("cuda"), log=lambda *a: print(*a, flush=True))
    print("check_nms: all cases equal bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
