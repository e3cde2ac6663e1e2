"""ssdx_torch.predict.postprocess against ssdx.predict.postprocess (XLA NMS).

Logits are spiked as in tests/test_pallas_nms.py.  Valid masks and labels
must be equal; on the valid slots boxes agree within 1e-3 px and scores
within 1e-5 (softmax and logsumexp round differently in the two frameworks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx import priors as JP
from ssdx.predict import postprocess as jax_postprocess
from ssdx_torch.predict import postprocess, to_pylist


def spiked_logits(seed, B=2, n_spikes=40):
    rng = np.random.default_rng(seed)
    loc = rng.normal(0, 0.2, (B, 8732, 4)).astype(np.float32)
    conf = rng.normal(0, 0.2, (B, 8732, 6)).astype(np.float32)
    conf[..., 0] += 4.0
    for b in range(B):
        for p in rng.choice(8732, n_spikes, replace=False):
            conf[b, p, rng.integers(1, 6)] += rng.uniform(5.0, 10.0)
    return loc, conf


@pytest.mark.parametrize("class_agnostic", [False, True])
@pytest.mark.parametrize("score_thresh", [0.2, 0.05])
def test_postprocess_matches_jax(score_thresh, class_agnostic):
    loc, conf = spiked_logits(1)
    priors = JP.create_priors()
    kw = dict(score_thresh=score_thresh, nms_thresh=0.3, max_per_img=50,
              class_agnostic=class_agnostic)
    ref = jax_postprocess(jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
                          nms_backend="xla", **kw)
    got = postprocess(torch.as_tensor(loc), torch.as_tensor(conf),
                      torch.as_tensor(priors), **kw)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got.labels.numpy()[valid], np.asarray(ref.labels)[valid])
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(ref.boxes)[valid],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(ref.scores)[valid],
                               rtol=0, atol=1e-5)


def test_to_pylist_contract():
    loc, conf = spiked_logits(2, B=3)
    det = postprocess(torch.as_tensor(loc), torch.as_tensor(conf),
                      torch.as_tensor(JP.create_priors()), nms_thresh=0.3)
    out = to_pylist(det)
    assert len(out) == 3
    for b, d in enumerate(out):
        n = int(det.valid[b].sum())
        assert d["labels"].dtype == np.int64 and d["labels"].shape == (n,)
        assert d["scores"].dtype == np.float32 and d["boxes"].shape == (n, 4)
        assert np.all(d["scores"] > 0.2) and d["boxes"].max() <= 300.0


def test_detector_predict_with_precomputed_logits():
    from ssdx_torch.api import Detector

    det = Detector({"car": 0, "truck": 1, "bus": 2, "van": 3, "bike": 4},
                   width_mult=0.125, device="cpu")
    loc, conf = spiked_logits(4)
    got = det.predict(pre_loc_all=loc, pre_conf_all=conf, nms_thresh=0.3)
    ref = to_pylist(postprocess(torch.as_tensor(loc), torch.as_tensor(conf),
                                torch.as_tensor(JP.create_priors()), nms_thresh=0.3))
    assert len(got) == 2 and sum(len(d["labels"]) for d in got) > 0
    for g, r in zip(got, ref):
        for k in ("labels", "scores", "boxes"):
            np.testing.assert_array_equal(g[k], r[k])
    with pytest.raises(ValueError):
        det.predict()


def test_postprocess_rejects_bad_thresholds():
    loc, conf = spiked_logits(3, B=1)
    args = (torch.as_tensor(loc), torch.as_tensor(conf), torch.as_tensor(JP.create_priors()))
    with pytest.raises(ValueError):
        postprocess(*args, score_thresh=1.0)
    with pytest.raises(ValueError):
        postprocess(*args, nms_thresh=0.0)
