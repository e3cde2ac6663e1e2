"""ssdx_torch.nms.batched_nms_mask (plain keep-mask core on the CPU) against
ssdx.nms.batched_nms_mask with the XLA fixpoint and with the Pallas kernel in
interpret mode.  Keep masks must be equal exactly.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx.nms import batched_nms_mask as jax_nms
from ssdx_torch.nms import batched_nms_mask
from ssdx_torch.ops import nms as nms_ops


def clustered(rng, B, n, n_clusters=12):
    """Boxes around a few centres: long suppression chains (as
    tests/test_pallas_nms.py)."""
    centers = rng.uniform(30, 270, (B, n_clusters, 2))
    pick = rng.integers(0, n_clusters, (B, n))
    lo = centers[np.arange(B)[:, None], pick] + rng.normal(0, 6, (B, n, 2))
    sz = rng.uniform(15, 50, (B, n, 2))
    boxes = np.concatenate([lo, lo + sz], -1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (B, n)).astype(np.float32)
    labels = rng.integers(0, 3, (B, n)).astype(np.int32)
    valid = np.ones((B, n), bool)
    valid[:, -7:] = False
    return boxes, scores, valid, labels


def _both(args, thresh, class_aware, backend):
    boxes, scores, valid, labels = args
    ref = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                             jnp.asarray(labels), thresh, class_aware=class_aware,
                             backend=backend))
    got = batched_nms_mask(torch.as_tensor(boxes), torch.as_tensor(scores),
                           torch.as_tensor(valid), torch.as_tensor(labels), thresh,
                           class_aware=class_aware).numpy()
    return ref, got


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("thresh", [0.3, 0.5])
@pytest.mark.parametrize("n", [400, 1600])  # serving and eval candidate counts
def test_matches_xla_fixpoint(n, thresh, class_aware):
    args = clustered(np.random.default_rng(0), 2, n)
    ref, got = _both(args, thresh, class_aware, "xla")
    assert got.dtype == bool and got.shape == (2, n)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size  # suppression actually happened


@pytest.mark.parametrize("n", [32, 600])
@pytest.mark.parametrize("class_aware", [False, True])
def test_matches_pallas_interpret(n, class_aware):
    args = clustered(np.random.default_rng(n), 2, n)
    ref, got = _both(args, 0.3 if class_aware else 0.5, class_aware, "pallas_interpret")
    np.testing.assert_array_equal(got, ref)


def test_core_wrapper_runs_plain_version_on_cpu():
    boxes, _, valid, _ = clustered(np.random.default_rng(9), 2, 64)
    b, v = torch.as_tensor(boxes), torch.as_tensor(valid)
    before = nms_ops.launches
    keep = nms_ops.nms_core_sorted(b, v, 0.4)
    assert nms_ops.launches == before  # no kernel on a CPU tensor
    assert torch.equal(keep, nms_ops.nms_core_sorted_ref(b, v, 0.4))
    with pytest.raises(ValueError, match="unsupported device"):
        nms_ops.nms_core_sorted(b.to("meta"), v.to("meta"), 0.4)


def _greedy_f64(boxes, scores, valid, labels, thresh, kind):
    """Per-class greedy NMS in float64, candidates in descending score."""
    overlap = nms_ops.KINDS[kind](torch.as_tensor(boxes).double(), torch.as_tensor(boxes).double())
    keep = np.zeros(valid.shape, bool)
    for b in range(boxes.shape[0]):
        kept = []
        for j in np.argsort(-np.where(valid[b], scores[b], -np.inf), kind="stable"):
            if valid[b, j] and not any(labels[b, i] == labels[b, j]
                                       and overlap[b, i, j] > thresh for i in kept):
                kept.append(j)
        keep[b, kept] = True
    return keep


@pytest.mark.parametrize("kind", ["iou", "diou"])
def test_per_class_nms_at_80_classes_is_exact_near_the_threshold(kind):
    """Pairs 1e-4 either side of 0.5 by ``kind``, 80 classes, scores
    shuffled: batched_nms_mask (the plain core on the CPU) keeps what a
    float64 per-class greedy loop keeps, bit for bit.  The class offset of
    label x 4096 that it replaced decides some of these pairs the other
    way (1/32 px of float32 precision at label 79)."""
    from ssdx_torch.tools.check_nms import near_threshold

    boxes, _, labels = near_threshold(torch.device("cpu"), 2, 400, 11, kind)
    rng = np.random.default_rng(11)
    perm = rng.permutation(400)
    boxes, labels = boxes[:, perm].numpy(), labels[:, perm].numpy()
    scores = rng.uniform(0.05, 1.0, (2, 400)).astype(np.float32)
    valid = np.ones((2, 400), bool)
    valid[:, :5] = False
    want = _greedy_f64(boxes, scores, valid, labels, 0.5, kind)
    got = batched_nms_mask(torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(valid),
                           torch.as_tensor(labels), 0.5, kind=kind).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()
    offset = torch.as_tensor(boxes) + torch.as_tensor(labels).float()[..., None] * 4096.0
    by_offset = batched_nms_mask(offset, torch.as_tensor(scores), torch.as_tensor(valid), None,
                                 0.5, class_aware=False, kind=kind).numpy()
    assert (by_offset != want).any()


def test_the_kind_is_checked():
    boxes, _, valid, labels = clustered(np.random.default_rng(3), 1, 16)
    with pytest.raises(ValueError, match="kind must be one of"):
        nms_ops.nms_core_sorted(torch.as_tensor(boxes), torch.as_tensor(valid), 0.5, kind="giou")
