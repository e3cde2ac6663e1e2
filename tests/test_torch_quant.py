"""ssdx_torch.quant against ssdx.quant on the CPU: the same numpy inputs go
through the JAX functions and the port's (device "cpu"); each tolerance is
stated where it is used.  Calibration is compared in float32: in bf16 the
two frameworks accumulate differently and the amax differs in its last
digit, so the tests that follow calibration feed both sides the same
scales.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx import quant as jq
from ssdx.export import fold_batchnorm as jax_fold
from ssdx.ops.pallas_int8_conv import _layer_pad
from ssdx.predict import Detections as JaxDetections
from ssdx_torch import model as tmodel
from ssdx_torch import quant as tq
from ssdx_torch.predict import Detections
from ssdx_torch.weights import quant_from_jax, quant_to_jax
from torch_parity import random_variables

WIDTH = 0.125


@pytest.fixture(scope="module")
def folded():
    """BN-folded random params (numpy, JAX layout) at width 0.125."""
    v = random_variables(WIDTH, seed=3)
    return {k: {kk: {kkk: np.array(a) for kkk, a in vv.items()} if isinstance(vv, dict)
                else np.array(vv) for kk, vv in m.items()}
            for k, m in jax_fold(v)["params"].items()}


@pytest.fixture(scope="module")
def amax(folded):
    """A per-layer amax dict from a seed (the shapes of a calibration)."""
    rng = np.random.default_rng(11)
    return {s.name: rng.uniform(0.05, 6.0, folded[s.name]["Conv_0"]["kernel"].shape[2])
            .astype(np.float32) for s in jq._TOPOLOGY}


@pytest.fixture(scope="module")
def jax_qp(folded, amax):
    return jq.quantize_ssd(folded, amax, 6)


def test_topology_matches_jax_and_model_tables():
    """_TOPOLOGY is derived from model.BACKBONE, _POOL_AFTER and _TAPS and
    says what ssdx.quant._TOPOLOGY says."""
    assert len(tq._TOPOLOGY) == len(jq._TOPOLOGY) == 21
    for t, j in zip(tq._TOPOLOGY, jq._TOPOLOGY):
        assert (t.name, (t.kernel, t.kernel), t.stride, t.pad, t.dilation, t.tap, t.pool) == \
            (j.name, j.kernel, j.stride, _layer_pad(j), j.dilation, j.tap, j.pool)
    assert [s.name for s in tq._TOPOLOGY if s.tap is not None] == \
        [f"ConvBNRelu_{i}" for i in tmodel._TAPS]


def test_quantize_ssd_matches_jax(folded, amax, jax_qp):
    """Same params and amax: kernel_q bit for bit; in_scale, w_scale and
    bias to 1e-7 relative (both sides do the same float32 operations)."""
    got = quant_to_jax(tq.quantize_ssd(folded, amax, 6))
    assert got["num_classes"] == jax_qp.num_classes == 6
    for name, jl in jax_qp.layers.items():
        g = got["layers"][name]
        assert g["kernel_q"].dtype == np.int8
        np.testing.assert_array_equal(g["kernel_q"], np.asarray(jl.kernel_q), err_msg=name)
        for field in ("in_scale", "w_scale", "bias"):
            np.testing.assert_allclose(g[field], np.asarray(getattr(jl, field)),
                                       rtol=1e-7, atol=0, err_msg=f"{name}.{field}")
    for name, jh in jax_qp.heads.items():
        np.testing.assert_array_equal(got["heads"][name]["kernel"], np.asarray(jh["kernel"]))
        np.testing.assert_array_equal(got["heads"][name]["bias"], np.asarray(jh["bias"]))


def test_quant_from_jax_round_trip(jax_qp):
    """quant_from_jax keeps every number; kernel_q lands as OIHW int8 in
    channels-last memory, the heads fused with the box channels first."""
    qp = quant_from_jax(jax_qp)
    back = quant_to_jax(qp)
    for name, jl in jax_qp.layers.items():
        kq = qp.layers[name].kernel_q
        h, w, cin, cout = jl.kernel_q.shape
        assert kq.dtype == torch.int8 and tuple(kq.shape) == (cout, cin, h, w)
        assert kq.permute(0, 2, 3, 1).is_contiguous()
        for field in ("kernel_q", "in_scale", "w_scale", "bias"):
            np.testing.assert_array_equal(back["layers"][name][field],
                                          np.asarray(getattr(jl, field)))
    assert qp.heads[0]["weight"].shape[0] == 4 * (4 + 6)
    for name, jh in jax_qp.heads.items():
        np.testing.assert_array_equal(back["heads"][name]["kernel"], np.asarray(jh["kernel"]))


def test_stem_and_calibration_match_jax_f32(folded):
    """stem_bf16 and calibrate_act_scales in float32 on one image: the map
    within 1e-4 absolute, each amax within 1e-4 relative (summation order)."""
    x = np.random.default_rng(5).normal(0, 1, (1, 300, 300, 3)).astype(np.float32)
    ref = np.asarray(jq.stem_bf16(folded, jnp.asarray(x), jnp.float32))
    got = tq.stem_bf16(folded, torch.as_tensor(x), torch.float32)
    assert got.shape == (1, 150, 150, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)

    ref_amax = jq.calibrate_act_scales(folded, jnp.asarray(ref), jnp.float32)
    got_amax = tq.calibrate_act_scales(folded, torch.as_tensor(ref), torch.float32)
    assert set(got_amax) == set(ref_amax) and len(ref_amax) == 21
    for name, r in ref_amax.items():
        assert got_amax[name].dtype == np.float32 and got_amax[name].shape == r.shape
        np.testing.assert_allclose(got_amax[name], r, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("hw,ceil", [
    ((75, 75), False), ((75, 75), True), ((6, 8), False), ((6, 8), True),
    ((5, 7), False), ((5, 7), True), ((1, 3), True)])
def test_max_pool_int8_matches_jax(hw, ceil):
    """2x2/2 max pool on int8, odd extents included: exact.  Ceil mode pads
    with -128, so an all -128 window stays -128."""
    rng = np.random.default_rng(hw[0] * 10 + ceil)
    x = rng.integers(-128, 128, (2, *hw, 8)).astype(np.int8)
    x[0, -1, -1] = -128
    ref = np.asarray(jq._max_pool(jnp.asarray(x), ceil))
    got = tq._max_pool(torch.as_tensor(x), ceil)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    if hw[0] >= 2 and hw[1] >= 2:  # and PyTorch's own pool, on the same values in float32
        t = torch.as_tensor(x).permute(0, 3, 1, 2).float()
        lib = torch.nn.functional.max_pool2d(t, 2, 2, ceil_mode=ceil).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(got.numpy(), lib.numpy().astype(np.int8))


@pytest.fixture(scope="module")
def jax_walk(folded, jax_qp):
    """ssdx.quant.apply_int8 with the exact int32 contraction, one image."""
    feats = np.random.default_rng(9).uniform(0, 4, (1, 150, 150, 8)).astype(np.float32)
    loc, cls = jq.apply_int8(jax_qp, jnp.asarray(feats), jnp.float32, compute="int32")
    return feats, np.asarray(loc), np.asarray(cls)


@pytest.mark.parametrize("compute", ["int32", "f32", "auto"])
def test_apply_int8_matches_jax_int32(jax_qp, jax_walk, compute):
    """The plain walk against ssdx.quant.apply_int8(compute="int32"), weights
    carried by quant_from_jax, float32 heads.  Limits as the JAX suite's own
    (tests/test_pallas_int8_conv.py): the float32 epilogues may differ in
    the last place (XLA may fuse multiply and add), which can move a
    requantized value by one int8 step; heads within 0.25 absolute and
    fewer than 1 % of elements past 0.05."""
    feats, ref_loc, ref_cls = jax_walk
    qp = quant_from_jax(jax_qp)
    loc, cls = tq.apply_int8(qp, torch.as_tensor(feats), torch.float32, compute=compute)
    assert loc.shape == (1, 8732, 4) and cls.shape == (1, 8732, 6)
    assert loc.dtype == cls.dtype == torch.float32
    for g, r in ((loc.numpy(), ref_loc), (cls.numpy(), ref_cls)):
        diff = np.abs(g - r)
        assert diff.max() <= 0.25, diff.max()
        assert (diff > 0.05).mean() < 0.01, (diff > 0.05).mean()


def test_apply_int8_refuses_unknown_compute(jax_qp):
    with pytest.raises(ValueError, match="compute"):
        tq.apply_int8(quant_from_jax(jax_qp), torch.zeros(1, 150, 150, 8), compute="int4")


def test_conv_int_exact_is_exact_past_2_24():
    """All-127 operands at 9*1024 terms sum to 148,644,864 > 2^24: the
    float64 route returns it exactly where a float32 sum could not."""
    x = torch.full((1, 3, 3, 1024), 127, dtype=torch.int8)
    w = torch.full((16, 1024, 3, 3), 127, dtype=torch.int8)
    spec = tq._L("worst", 3, 1, 1, 1, None, None)
    y = tq.conv_int_exact(x, w, spec)
    assert y.dtype == torch.float64 and y.shape == (1, 3, 3, 16)
    assert int(y[0, 1, 1, 0]) == 9 * 1024 * 127 * 127
    assert int(y[0, 0, 0, 0]) == 4 * 1024 * 127 * 127


def test_detection_agreement_matches_jax():
    rng = np.random.default_rng(2)
    B, K = 2, 6
    lo = rng.uniform(10, 200, (B, K, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.uniform(20, 60, (B, K, 2)).astype(np.float32)], -1)
    labels = rng.integers(0, 5, (B, K)).astype(np.int32)
    scores = rng.uniform(0.2, 1, (B, K)).astype(np.float32)
    valid = np.ones((B, K), bool)
    valid[1, 4:] = False
    boxes_b = boxes + rng.normal(0, 3, boxes.shape).astype(np.float32)
    boxes_b[0, 0] += 200  # one box moved away
    labels_b = labels.copy()
    labels_b[0, 1] = (labels_b[0, 1] + 1) % 5  # one label flipped
    scores_b = scores - 0.05

    ref = jq.detection_agreement(
        JaxDetections(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                      jnp.asarray(valid)),
        JaxDetections(jnp.asarray(boxes_b), jnp.asarray(scores_b), jnp.asarray(labels_b),
                      jnp.asarray(valid)))
    t = torch.as_tensor
    got = tq.detection_agreement(
        Detections(t(boxes), t(scores), t(labels), t(valid)),
        Detections(t(boxes_b), t(scores_b), t(labels_b), t(valid)))
    assert 0.5 < ref["match_rate"] < 1.0
    assert got["match_rate"] == ref["match_rate"]
    assert got["mean_matched_iou"] == pytest.approx(ref["mean_matched_iou"], abs=1e-6)
    assert got["max_score_delta"] == pytest.approx(ref["max_score_delta"], abs=1e-6)
