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
