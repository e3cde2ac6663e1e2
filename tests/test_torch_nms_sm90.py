"""CPU model of the NMS kernel B1's Hopper design (csrc/nms.cu), which runs
only on the card.

The model walks the two kernels as they run: nms_sup_kernel's blocks over
the upper triangle only (the column-major enumeration and its float32
square root), each thread testing its 64 columns for the same label and a
non-zero intersection before the full IoU or DIoU (the exact early-out); then
nms_scan_kernel's chunks of 64 candidates, each staged as 64 rows x W
words into one of two buffers (the mbarrier phase it waits on), the 64
decisions resolved from the diagonal words in a serial chain, the kept
rows' later words ORed into the running mask one word a thread.  Words the
sup kernel never writes hold garbage, and the model fails if the scan uses
one.  Its keep mask is held equal to ``nms_core_sorted_ref`` (and, once, to
the JAX package's fixpoint); the early-out rule is checked on adversarial
pairs against the full DIoU.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx.nms import batched_nms_mask as jax_nms
import ssdx_torch.nms as nms_mod
from ssdx_torch.boxes import pairwise_diou
from ssdx_torch.nms import batched_nms_mask
from ssdx_torch.ops import nms as nms_ops

SRC = (Path(__file__).resolve().parents[1] / "ssdx_torch" / "csrc" / "nms.cu").read_text()


def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


COLS, MAX_WORDS, THREADS = _const("kCols"), _const("kMaxWords"), _const("kScanThreads")
ALL = (1 << 64) - 1
f32 = np.float32


def tri_block(tri: int) -> tuple[int, int]:
    """nms_sup_kernel's (rb, cb) of block ``tri``: cb from the float32
    square root, then corrected by the two loops."""
    cb = int((np.sqrt(f32(8.0) * f32(tri) + f32(1.0), dtype=f32) - f32(1.0)) * f32(0.5))
    while cb * (cb + 1) // 2 > tri:
        cb -= 1
    while (cb + 1) * (cb + 2) // 2 <= tri:
        cb += 1
    return tri - cb * (cb + 1) // 2, cb


def inter_of(boxes):
    """[B,K,K] float32 intersection areas, by inter_of()'s operations."""
    a, b = boxes[:, :, None, :], boxes[:, None, :, :]
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]),
                     min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]),
                     min=0.0)
    return iw * ih


def full_path(inter, thresh):
    """Which pairs run the full DIoU: those with a non-zero (or NaN)
    intersection, or all of them for a threshold below 0."""
    return inter != 0 if thresh >= 0 else torch.ones_like(inter, dtype=torch.bool)


def sup_kernel(boxes, valid, thresh, rng, labels=None, kind="diou"):
    """The words nms_sup_kernel<kind == "iou"> writes, in its [B][64W][W]
    scratch filled with garbage first, and which of them it wrote; with
    ``labels``, only same-label columns take the overlap."""
    B, K = valid.shape
    W = -(-K // COLS)
    words = rng.integers(0, ALL, size=(B, COLS * W, W), dtype=np.uint64, endpoint=True)
    written = np.zeros(words.shape, bool)
    todo = full_path(inter_of(boxes), thresh)
    if labels is not None:
        todo &= labels[:, :, None] == labels[:, None, :]
    hit = (todo & (nms_ops.KINDS[kind](boxes, boxes) > thresh)).numpy()
    v = valid.numpy()
    seen = set()
    for tri in range(W * (W + 1) // 2):
        rb, cb = tri_block(tri)
        assert rb <= cb < W and (rb, cb) not in seen
        seen.add((rb, cb))
        ncols = min(COLS, K - cb * COLS)
        for t in range(COLS):
            i = rb * COLS + t
            if i >= K:
                continue
            first = t + 1 if cb == rb else 0
            for b in range(B):
                if not v[b, i]:
                    continue  # never written, never read
                j = np.arange(first, ncols)
                bits = hit[b, i, cb * COLS + j]
                words[b, i, cb] = np.bitwise_or.reduce(
                    np.left_shift(np.uint64(1), j[bits].astype(np.uint64)), initial=np.uint64(0))
                written[b, i, cb] = True
    assert len(seen) == W * (W + 1) // 2  # the whole upper triangle, once
    return words, written


def scan_kernel(words, written, valid):
    """nms_scan_kernel, block by block: the keep mask [B,K]."""
    B, K = valid.shape
    W = words.shape[2]
    assert W <= MAX_WORDS and 2 * COLS * W * 8 <= 2 * COLS * MAX_WORDS * 8
    keep = np.zeros((B, K), bool)
    v = valid.numpy()
    for b in range(B):
        vmask = [sum(1 << i for i in range(COLS) if w * COLS + i < K and v[b, w * COLS + i])
                 for w in range(W)]
        removed = [0] * W
        last = max((w for w in range(W) if vmask[w]), default=-1)
        nchunks = last + 1
        slots, phases = [None, None], [0, 0]  # buffer contents, completed copies a barrier saw

        def issue(c):
            slots[c & 1] = (c, words[b, c * COLS:(c + 1) * COLS, :])  # 64 full rows
            phases[c & 1] += 1

        for c in range(min(2, nchunks)):
            issue(c)
        for c in range(nchunks):
            # mbar_wait(full[c & 1], (c >> 1) & 1) passes once copy c >> 1 of that slot landed
            assert phases[c & 1] == (c >> 1) + 1 and slots[c & 1][0] == c
            rows = slots[c & 1][1]
            rem, kept = removed[c] | (~vmask[c] & ALL), 0
            for i in range(COLS):
                if not (rem >> i) & 1:
                    assert written[b, c * COLS + i, c], "a kept row's diagonal word"
                    kept |= 1 << i
                    rem |= int(rows[i, c])
            for t in range(COLS):
                if c * COLS + t < K:
                    keep[b, c * COLS + t] = (kept >> t) & 1
            for tid in range(THREADS):
                for w in range(c + 1 + tid, W, THREADS):
                    acc = 0
                    for i in range(COLS):
                        if (kept >> i) & 1:
                            assert written[b, c * COLS + i, w], "a kept row's later word"
                            acc |= int(rows[i, w])
                    removed[w] |= acc
            if c + 2 < nchunks:
                issue(c + 2)
        assert not keep[b, nchunks * COLS:].any()
    return torch.as_tensor(keep)


def clustered(rng, B, K, class_offset):
    """Score-sorted candidates around a few centres (long suppression
    chains), the last 7 of each row invalid, image 1 with none valid."""
    centers = rng.uniform(30, 270, (B, 12, 2))
    pick = rng.integers(0, 12, (B, K))
    lo = centers[np.arange(B)[:, None], pick] + rng.normal(0, 6, (B, K, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(15, 50, (B, K, 2))], -1).astype(f32)
    labels = rng.integers(0, 3, (B, K))
    if class_offset:
        boxes = boxes + labels[..., None].astype(f32) * f32(4096.0)
    valid = np.ones((B, K), bool)
    valid[:, -min(7, K):] = False
    if B > 1:
        valid[1] = False
    return torch.as_tensor(boxes), torch.as_tensor(valid)


@pytest.mark.parametrize("class_offset", [True, False])
@pytest.mark.parametrize("K", [1, 63, 64, 65, 400, 1600])
def test_block_scan_equals_plain(K, class_offset):
    rng = np.random.default_rng(K + class_offset)
    B = 2 if K > 400 else 3
    boxes, valid = clustered(rng, B, K, class_offset)
    words, written = sup_kernel(boxes, valid, 0.3, rng)
    got = scan_kernel(words, written, valid)
    ref = nms_ops.nms_core_sorted_ref(boxes, valid, 0.3)
    assert torch.equal(got, ref)
    assert not got[1 % B].any() or B == 1
    if K >= 64:
        assert 0 < int(got.sum()) < int(valid.sum())  # suppression happened


@pytest.mark.parametrize("thresh", [0.0, 0.5, -0.2])
def test_block_scan_on_touching_grid(thresh):
    """Integer boxes on a small grid: duplicates, boxes that only touch, and
    (for thresh < 0) pairs that no overlap at all suppresses."""
    rng = np.random.default_rng(9)
    B, K = 2, 130
    lo = rng.integers(0, 12, (B, K, 2))
    boxes = torch.as_tensor(np.concatenate([lo, lo + rng.integers(1, 4, (B, K, 2))], -1)
                            .astype(f32))
    valid = torch.as_tensor(rng.uniform(size=(B, K)) > 0.2)
    words, written = sup_kernel(boxes, valid, thresh, rng)
    assert torch.equal(scan_kernel(words, written, valid),
                       nms_ops.nms_core_sorted_ref(boxes, valid, thresh))


def adversarial_pairs():
    """(a, b) pairs at the edge of overlapping: touching edges and corners,
    gaps and overlaps of one ulp (at 1 and behind the 4096 class offset),
    intersections that underflow to 0, and one pair of overlapping boxes."""
    up, down = np.nextafter(f32(1), f32(2)), np.nextafter(f32(1), f32(0))
    o = f32(4096.0)
    up_o, down_o = np.nextafter(o + 1, f32(1e9)), np.nextafter(o + 1, f32(0))
    tiny = f32(1e-30)
    pairs = [
        ([0, 0, 1, 1], [1, 0, 2, 1]),            # touching edge
        ([0, 0, 1, 1], [1, 1, 2, 2]),            # touching corner
        ([0, 0, 1, 1], [up, 0, 2, 1]),           # one ulp apart
        ([0, 0, 1, 1], [down, 0, 2, 1]),         # one ulp of overlap
        ([o, 0, o + 1, 1], [up_o, 0, o + 2, 1]),  # the same behind the offset
        ([o, 0, o + 1, 1], [down_o, 0, o + 2, 1]),
        ([0, 0, tiny, tiny], [0, 0, tiny, tiny]),  # overlap whose area underflows
        ([0, 0, 1, 1], [0, 0, 1, 1]),            # duplicates
        ([0, 0, 4, 4], [5, 5, 6, 6]),            # far apart
    ]
    a = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.float32)
    return torch.stack([a, b], 1)  # [n, 2, 4]: each pair as a two-box image


@pytest.mark.parametrize("thresh", [0.0, 0.3])
def test_early_out_exact(thresh):
    """For thresh >= 0, every pair whose intersection is exactly 0 has
    DIoU <= 0: skipping its divisions leaves the bit as the full DIoU sets it."""
    boxes = adversarial_pairs()
    inter = inter_of(boxes)[:, 0, 1]
    d = pairwise_diou(boxes, boxes)[:, 0, 1]
    assert (inter == 0).sum() >= 6 and (inter > 0).sum() >= 3
    assert (d[inter == 0] <= 0).all()
    skip = ~full_path(inter, thresh)
    assert torch.equal(d > thresh, (d > thresh) & ~skip)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool)
    words, written = sup_kernel(boxes, valid, thresh, np.random.default_rng(0))
    assert torch.equal(scan_kernel(words, written, valid),
                       nms_ops.nms_core_sorted_ref(boxes, valid, thresh))


def test_early_out_not_taken_below_zero():
    """For a negative threshold, pairs that do not overlap can suppress
    (touching boxes have DIoU -0.2 > -0.3): the kernel must run the full
    DIoU on every pair, and the model does."""
    boxes = adversarial_pairs()
    thresh = -0.3
    inter = inter_of(boxes)[:, 0, 1]
    d = pairwise_diou(boxes, boxes)[:, 0, 1]
    assert ((inter == 0) & (d > thresh)).any()  # an early-out would lose these bits
    assert full_path(inter, thresh).all()
    assert "if (thresh >= 0.0f)" in SRC and "inter_of(a, cols[j]) != 0.0f" in SRC
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool)
    words, written = sup_kernel(boxes, valid, thresh, np.random.default_rng(0))
    got = scan_kernel(words, written, valid)
    assert torch.equal(got, nms_ops.nms_core_sorted_ref(boxes, valid, thresh))
    assert not got[:, 1][(inter == 0) & (d > thresh)].any()


@pytest.mark.parametrize("W", [1, 2, 7, 25, 128])
def test_triangle_enumeration(W):
    """Blocks 0 .. W(W+1)/2 - 1 map to every (rb <= cb) once, column by
    column, as the launch grid of ssdx_nms_keep has them."""
    got = [tri_block(t) for t in range(W * (W + 1) // 2)]
    assert got == [(rb, cb) for cb in range(W) for rb in range(cb + 1)]
    assert "W * (W + 1) / 2" in SRC


@pytest.mark.parametrize("kind", ["iou", "diou"])
@pytest.mark.parametrize("K", [65, 400])
def test_block_scan_per_label_near_threshold(K, kind):
    """80 classes, pairs 1e-4 either side of the threshold 0.5 by IoU or
    DIoU (``tools/check_nms.py``'s coco case), classes kept apart by the
    labels the kernel compares: the modelled kernel equals the plain
    version, which equals a float64 per-class greedy loop."""
    from ssdx_torch.tools.check_nms import near_threshold

    boxes, valid, labels = near_threshold(torch.device("cpu"), 2, K, K, kind)
    words, written = sup_kernel(boxes, valid, 0.5, np.random.default_rng(K), labels, kind)
    got = scan_kernel(words, written, valid)
    ref = nms_ops.nms_core_sorted_ref(boxes, valid, 0.5, labels, kind)
    assert torch.equal(got, ref)
    assert torch.equal(got, greedy_f64(boxes, valid, labels, 0.5, kind))
    assert 0 < int(got.sum()) < int(valid.sum())


def test_cross_label_pairs_take_no_overlap():
    """The early-out tests the label before the intersection: a kept box
    suppresses nothing of another label, however it overlaps."""
    assert "col_label[j] == a_label && inter_of(a, cols[j]) != 0.0f" in SRC
    assert "if (j >= first && j < ncols && col_label[j] == a_label) todo" in SRC
    boxes = torch.tensor([[[0.0, 0, 10, 10]] * 4])  # duplicates
    valid = torch.ones((1, 4), dtype=torch.bool)
    labels = torch.tensor([[0, 1, 0, 1]], dtype=torch.int32)
    for thresh in (0.3, -0.5):
        words, written = sup_kernel(boxes, valid, thresh, np.random.default_rng(0), labels, "iou")
        assert scan_kernel(words, written, valid).tolist() == [[True, True, False, False]]


def greedy_f64(boxes, valid, labels, thresh, kind):
    """Greedy per-class NMS in float64, candidate by candidate."""
    o = nms_ops.KINDS[kind](boxes.double(), boxes.double())
    keep = torch.zeros_like(valid)
    for b in range(boxes.shape[0]):
        kept = []
        for j in range(boxes.shape[1]):
            if valid[b, j] and not any(labels[b, i] == labels[b, j] and o[b, i, j] > thresh
                                       for i in kept):
                kept.append(j)
        keep[b, kept] = True
    return keep


def test_model_equals_jax_package(monkeypatch):
    """The modelled kernel through batched_nms_mask's layout, against the
    JAX package's fixpoint (XLA) on the same numpy inputs."""
    rng = np.random.default_rng(4)
    B, K = 2, 400
    boxes, valid = clustered(rng, B, K, False)
    boxes, valid = boxes.numpy(), valid.numpy()
    valid[1] = True
    scores = rng.uniform(0.01, 1.0, (B, K)).astype(f32)
    labels = rng.integers(0, 3, (B, K)).astype(np.int32)
    ref = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                             jnp.asarray(labels), 0.3, class_aware=True, backend="xla"))

    def modelled(b, v, thresh, labels=None, kind="diou"):
        words, written = sup_kernel(b, v, thresh, rng, labels, kind)
        return scan_kernel(words, written, v)

    monkeypatch.setattr(nms_mod, "nms_core_sorted", modelled)
    got = batched_nms_mask(torch.as_tensor(boxes), torch.as_tensor(scores),
                           torch.as_tensor(valid), torch.as_tensor(labels), 0.3,
                           class_aware=True).numpy()
    np.testing.assert_array_equal(got, ref)
