"""ssdx_torch.matching against ssdx.matching on the same numpy GT (CPU, f32).

``cls`` and ``pos`` must be equal; ``loc`` on positives within atol 1e-5
(the CIoU matrix and the encoding are float32 on both sides, evaluated in
different orders).
"""
import jax.numpy as jnp
import numpy as np
import torch

from ssdx import priors as JP
from ssdx.matching import build_targets as jax_targets
from ssdx.matching import match_one as jax_match_one
from ssdx_torch import priors as P
from ssdx_torch.matching import build_targets, match_one

PRI = P.create_priors()
PRI_XYXY = P.priors_xyxy(PRI)


def _gt(seed, B=3, G=6):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.7, (B, G, 2))
    boxes = np.concatenate([lo, np.minimum(lo + rng.uniform(0.02, 0.5, (B, G, 2)), 1.0)], -1)
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[1, 2:] = False  # padded GT
    valid[2] = False      # an image without GT
    return boxes.astype(np.float32), labels, valid


def _check(got, ref):
    loc, cls, pos = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(got.pos.numpy(), pos)
    np.testing.assert_array_equal(got.cls.numpy(), cls)
    np.testing.assert_allclose(got.loc.numpy()[pos], loc[pos], rtol=0, atol=1e-5)


def test_build_targets_matches_jax():
    for seed in range(3):
        boxes, labels, valid = _gt(seed)
        ref = jax_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid),
                          jnp.asarray(PRI), jnp.asarray(JP.priors_xyxy(JP.create_priors())), 0.4)
        got = build_targets(torch.as_tensor(boxes), torch.as_tensor(labels),
                            torch.as_tensor(valid), torch.as_tensor(PRI),
                            torch.as_tensor(PRI_XYXY), 0.4)
        assert got.cls.dtype == torch.int32 and got.pos.dtype == torch.bool
        _check(got, ref)
        assert not got.pos[2].any() and (got.cls[2] == 0).all()  # empty image
        # every valid GT has a forced positive
        assert got.pos[0].sum() >= 6 and got.pos[1].sum() >= 2


def test_match_one_matches_jax():
    boxes, labels, valid = _gt(5)
    ref = jax_match_one(jnp.asarray(boxes[1]), jnp.asarray(labels[1]), jnp.asarray(valid[1]),
                        jnp.asarray(PRI), jnp.asarray(PRI_XYXY), 0.5)
    got = match_one(torch.as_tensor(boxes[1]), torch.as_tensor(labels[1]),
                    torch.as_tensor(valid[1]), torch.as_tensor(PRI), torch.as_tensor(PRI_XYXY),
                    0.5)
    pos = np.asarray(ref[2])
    np.testing.assert_array_equal(got[2].numpy(), pos)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy()[pos], np.asarray(ref[0])[pos], rtol=0, atol=1e-5)
