"""Check the NMS kernel B1 on one GPU against its plain version, bit for bit.

    python -m ssdx_torch.tools.check_nms

B1 (``ops.nms.nms_core_sorted``, ``csrc/nms.cu``) against
``nms_core_sorted_ref`` at B = 32 and B = 1, K = 1, 64, 65, 400, 1600 and
8192, on two kinds of candidates: "clustered" (boxes around a few centres,
long suppression chains; the last 7 of each row invalid) and "grid" (integer
coordinates on a small grid: duplicates, boxes that only touch, DIoUs that
repeat exactly; random invalid candidates and, at B > 1, one image with none
valid), class-aware (the 4096 offset of ``nms.py``) and agnostic, at the
thresholds 0, 0.3, 0.5, -0.2 (every pair takes the full DIoU) and "tie": a
DIoU that pairs of the data reach exactly, so that ties on the threshold
decide.  The keep masks must be equal bit for bit.  The plain version runs
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

from ssdx_torch.boxes import pairwise_diou
from ssdx_torch.ops import nms as nms_ops

BATCHES = (32, 1)
KS = (1, 64, 65, 400, 1600, 8192)
THRESHOLDS = (0.0, 0.3, 0.5, -0.2, "tie")
CLASS_OFFSET = 4096.0  # nms.py's per-class translation


def _sorted(boxes, scores, labels, valid, class_aware):
    """Class-offset boxes and valid flags in descending score order, invalid
    candidates last, as ``nms.batched_nms_mask`` hands them to the core."""
    if class_aware:
        boxes = boxes + labels.float()[..., None] * CLASS_OFFSET
    neg = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-neg, dim=1, stable=True)
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous(),
            torch.gather(valid, 1, order).contiguous())


def nms_inputs(dev, B, K, seed, class_aware=True):
    """Score-sorted, class-offset candidates clustered around a few centres
    (long suppression chains); the last 7 of each row invalid."""
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


def grid_inputs(dev, B, K, seed, class_aware=True):
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


def tie_threshold(boxes) -> float:
    """A DIoU in (0, 1) that pairs of the first image reach exactly: the
    median of the positive float32 DIoUs among its first 64 boxes (0.25
    where there is none)."""
    n = min(64, boxes.shape[1])
    d = pairwise_diou(boxes[:1, :n], boxes[:1, :n]).flatten()
    d = d[(d > 0) & (d < 1)]
    return float(d.sort().values[len(d) // 2]) if len(d) else 0.25


def ref_batch(K: int) -> int:
    """Images per call of the plain version: its [B,K,K] temporaries stay
    near a gigabyte."""
    return max(1, min(32, (1 << 28) // (K * K)))


def keep_ref(boxes, valid, thresh):
    step = ref_batch(boxes.shape[1])
    return torch.cat([nms_ops.nms_core_sorted_ref(boxes[i:i + step], valid[i:i + step], thresh)
                      for i in range(0, boxes.shape[0], step)])


def check(dev, batches=BATCHES, ks=KS, log=print) -> dict:
    """Every case bit for bit; returns {(B, K): (cases, kept)} and raises on
    the first mismatch."""
    res = {}
    for B in batches:
        for K in ks:
            cases = kept = 0
            for kind, make in (("clustered", nms_inputs), ("grid", grid_inputs)):
                for class_aware in (True, False):
                    boxes, valid = make(dev, B, K, seed=K + 7 * B + class_aware,
                                        class_aware=class_aware)
                    for t in THRESHOLDS:
                        thresh = tie_threshold(boxes) if t == "tie" else t
                        got = nms_ops.nms_core_sorted(boxes, valid, thresh)
                        ref = keep_ref(boxes, valid, thresh)
                        if got.is_cuda:
                            torch.cuda.synchronize()
                        bad = int((got != ref).sum())
                        if bad or got.shape != (B, K) or got.dtype != torch.bool:
                            raise AssertionError(
                                f"B1 B={B} K={K} {kind} class_aware={class_aware} "
                                f"thresh={thresh!r}: {bad} of {B * K} keep bits differ")
                        cases += 1
                        kept += int(got.sum())
            log(f"B1 B={B:2d} K={K:4d}: {cases} cases (clustered and grid, class-aware and "
                f"agnostic, thresholds {', '.join(map(str, THRESHOLDS))}), {kept} kept in all, "
                f"keep masks equal to the plain version's bit for bit")
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
