"""ssdx_torch.losses against ssdx.losses on the same numpy inputs (CPU, f32).

Tolerance: rtol 1e-5 on each of (total, loc, conf).  Both sides sum the
same float32 terms in different orders; the mined negatives are the same
set because both rank with a stable sort.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx import priors as JP
from ssdx.losses import cross_entropy_per_prior as jax_ce
from ssdx.losses import multibox_loss as jax_loss
from ssdx.matching import build_targets as jax_targets
from ssdx_torch.losses import cross_entropy_per_prior, multibox_loss, smooth_l1

RTOL = 1e-5


def _random_case(seed, B=4, P=300, C=6):
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 1, (B, P, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (B, P, C)).astype(np.float32)
    loc_t = rng.normal(0, 1, (B, P, 4)).astype(np.float32)
    pos = rng.random((B, P)) < 0.05
    pos[2] = False  # an image with zero positives mines int(ratio) negatives
    cls_t = np.where(pos, rng.integers(1, C, (B, P)), 0).astype(np.int32)
    return loc, logits, loc_t, cls_t, pos


def _compare(args, img_valid=None, ratio=3.0):
    ref = jax_loss(*(jnp.asarray(a) for a in args), ratio,
                   img_valid=None if img_valid is None else jnp.asarray(img_valid))
    got = multibox_loss(*(torch.as_tensor(np.array(a)) for a in args), ratio,
                        img_valid=None if img_valid is None else torch.as_tensor(img_valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=RTOL)


@pytest.mark.parametrize("with_img_valid", [False, True])
@pytest.mark.parametrize("ratio", [3.0, 2.5])
def test_multibox_loss_matches_jax(with_img_valid, ratio):
    args = _random_case(0)
    img_valid = np.array([True, True, True, False]) if with_img_valid else None
    _compare(args, img_valid, ratio)


def test_multibox_loss_on_matched_targets_with_empty_image():
    """Targets from the JAX matcher, image 1 with all GT invalid (no
    positives at all), image 3 a padded tail."""
    rng = np.random.default_rng(1)
    B, G, C = 4, 5, 6
    pri = JP.create_priors()
    lo = rng.uniform(0.05, 0.6, (B, G, 2))
    boxes = np.concatenate([lo, np.minimum(lo + rng.uniform(0.05, 0.4, (B, G, 2)), 1.0)], -1)
    valid = np.ones((B, G), bool)
    valid[1] = False
    valid[0, 3:] = False
    tg = jax_targets(jnp.asarray(boxes, jnp.float32), jnp.asarray(rng.integers(0, 5, (B, G))),
                     jnp.asarray(valid), jnp.asarray(pri), jnp.asarray(JP.priors_xyxy(pri)), 0.4)
    assert not bool(np.asarray(tg.pos)[1].any())
    loc = rng.normal(0, 1, (B, pri.shape[0], 4)).astype(np.float32)
    logits = rng.normal(0, 2, (B, pri.shape[0], C)).astype(np.float32)
    args = (loc, logits, np.asarray(tg.loc), np.asarray(tg.cls), np.asarray(tg.pos))
    _compare(args)
    _compare(args, np.array([True, True, True, False]))


def test_pieces_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 2, (1000,)).astype(np.float32)
    from ssdx.losses import smooth_l1 as jax_sl1
    np.testing.assert_allclose(smooth_l1(torch.as_tensor(x)).numpy(),
                               np.asarray(jax_sl1(jnp.asarray(x))), rtol=RTOL)
    logits = rng.normal(0, 3, (2, 50, 6)).astype(np.float32)
    labels = rng.integers(0, 6, (2, 50)).astype(np.int32)
    np.testing.assert_allclose(
        cross_entropy_per_prior(torch.as_tensor(logits), torch.as_tensor(labels)).numpy(),
        np.asarray(jax_ce(jnp.asarray(logits), jnp.asarray(labels))), rtol=RTOL, atol=1e-6)
