"""ssdx_torch.boxes and ssdx_torch.priors against the JAX package (CPU, f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx import boxes as JB
from ssdx import priors as JP
from ssdx_torch import boxes as TB
from ssdx_torch import priors as TP

ATOL = 1e-6


def _rand_boxes(rng, shape):
    lo = rng.uniform(0, 0.8, size=shape + (2,))
    sz = rng.uniform(0.05, 0.2, size=shape + (2,))
    return np.concatenate([lo, lo + sz], axis=-1).astype(np.float32)


@pytest.mark.parametrize("fn", ["cxcywh_to_xyxy", "xyxy_to_cxcywh", "box_area"])
def test_unary_matches_jax(fn):
    b = _rand_boxes(np.random.default_rng(0), (3, 40))
    ref = np.asarray(getattr(JB, fn)(jnp.asarray(b)))
    got = getattr(TB, fn)(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fn", ["pairwise_iou", "pairwise_diou", "pairwise_ciou"])
def test_pairwise_matches_jax(fn):
    rng = np.random.default_rng(1)
    a, b = _rand_boxes(rng, (2, 30)), _rand_boxes(rng, (2, 45))
    ref = np.asarray(getattr(JB, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(TB, fn)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert got.shape == (2, 30, 45)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_encode_decode_match_jax():
    rng = np.random.default_rng(2)
    priors = JP.create_priors()[:500]
    gt = JB.xyxy_to_cxcywh(jnp.asarray(_rand_boxes(rng, (500,))))
    ref_t = np.asarray(JB.encode(gt, jnp.asarray(priors)))
    got_t = TB.encode(torch.as_tensor(np.array(gt)), torch.as_tensor(priors)).numpy()
    np.testing.assert_allclose(got_t, ref_t, rtol=0, atol=ATOL)
    loc = rng.normal(0, 0.7, (500, 4)).astype(np.float32)
    ref_d = np.asarray(JB.decode(jnp.asarray(loc), jnp.asarray(priors)))
    got_d = TB.decode(torch.as_tensor(loc), torch.as_tensor(priors)).numpy()
    np.testing.assert_allclose(got_d, ref_d, rtol=0, atol=ATOL)


def test_priors_equal_jax():
    np.testing.assert_array_equal(TP.create_priors(), JP.create_priors())
    np.testing.assert_array_equal(
        TP.priors_xyxy(TP.create_priors()), JP.priors_xyxy(JP.create_priors()))
    assert TP.NUM_PRIORS == JP.NUM_PRIORS == 8732
    assert TP.BOXES_PER_LOCATION == JP.BOXES_PER_LOCATION
