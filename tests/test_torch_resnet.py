"""NVIDIA's SSD300 v1.1 in the port (``Detector(..., architecture="resnet50")``,
``ssdx_torch/model_resnet.py``) against the benchmark's plain reference
(``portbench/reference/ssd300_resnet50.py``), on the CPU at width 0.125 with
seeded weights whose BatchNorm statistics are calibrated on random images.

* forward, unfolded and folded, float32: loc and conf to 1e-4 relative
  (the folded one to 1e-6: the same CPU convolutions on the same weights);
* forward in bfloat16 against the reference with the configuration's
  roundings (conv inputs, weights, biases, outputs and residual sums in
  bf16, sums in float32): within 5 % by norm.  The random-weight trunk
  carries each block's rounding on and grows it: against the reference in
  float32 the bf16 heads differ by 17 % by norm at width 0.5, and against
  the emulated roundings by 2 %;
* the default boxes (``dboxes300_coco``) and the fused heads' layout;
* ``postprocess`` at 81 classes, IoU-NMS at 0.5, 200 a image, against the
  reference's ``detect``;
* what the detector refuses for this network (int8, weight exports, the
  VGG stem kernel, a train state), its spans and its NMS kind;
* host input staged in the detector's own dtype, for this network and for
  VGG16 (stem kernel on and off), with the heads of the plain copy's.

This file imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.drivers.serve_batches_r50 import tree
from portbench.reference import ssd300_resnet50 as ref
from ssdx_torch import model_resnet
from ssdx_torch.api import NETWORKS, Detector
from ssdx_torch.predict import postprocess
from ssdx_torch.priors import BOXES_PER_LOCATION, FEATURE_MAP_SIZES, NUM_PRIORS, create_priors_coco
from ssdx_torch.utils.profiling import recent_spans

WIDTH = 0.125
CLASSES = {f"class{i}": i for i in range(80)}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
    """Reference weights at width 0.125, BatchNorm calibrated on 4 images."""
    p = ref.init_params(2**31 + 5, 81, CPU, WIDTH)
    calib = np.random.default_rng(1).normal(0, 1, (4, 300, 300, 3))
    calib = torch.as_tensor(calib, dtype=torch.float32)
    with torch.no_grad():
        return ref.calibrate_bn(p, calib)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).normal(0, 1, (2, 300, 300, 3)).astype(np.float32)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _detector(params, **kw):
    kw = dict(dict(fold_bn=True, architecture="resnet50", width_mult=WIDTH, device="cpu"), **kw)
    return Detector(CLASSES, variables=tree(params), **kw)


@pytest.mark.parametrize("fold_bn,tol", [(False, 1e-4), (True, 1e-6)])
def test_forward_matches_the_reference_in_float32(params, images, fold_bn, tol):
    with torch.no_grad():
        want = ref.forward(ref.fold_bn(params), torch.as_tensor(images))
    got = _detector(params, fold_bn=fold_bn).forward(images)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.allclose(g, w, rtol=tol, atol=tol * float(w.abs().max()))


def test_forward_in_bf16_matches_the_references_roundings(params, images):
    with torch.no_grad():
        x = torch.as_tensor(images)
        emulated = ref.forward(ref.fold_bn(params), x, q=ref.BF16)
        f32 = ref.forward(ref.fold_bn(params), x)
    got = _detector(params, dtype=torch.bfloat16).forward(images)
    for g, e, f in zip(got, emulated, f32):
        assert _rel(g, e) < 0.05
        assert _rel(g, e) < _rel(g, f)  # the roundings, not the float32 network, are its match


def test_the_folded_tree_folds_every_conv_downsample_included(params):
    det = _detector(params)
    convs = [m for m in det.model.modules() if isinstance(m, model_resnet.ConvBN)]
    assert len(convs) == 53 and all(c.bn is None and c.conv.bias is not None for c in convs)
    assert sum(".downsample" in n for n, m in det.model.named_modules()
               if isinstance(m, model_resnet.ConvBN)) == 3
    unfolded = _detector(params, fold_bn=False)
    assert all(m.bn is not None and m.conv.bias is None for m in unfolded.model.modules()
               if isinstance(m, model_resnet.ConvBN))


def test_the_priors_are_dboxes300_coco():
    p = create_priors_coco()
    assert p.shape == (NUM_PRIORS, 4) == (8732, 4) and p.dtype == np.float32
    np.testing.assert_array_equal(p, ref.priors().numpy())
    np.testing.assert_allclose(p[0], [0.5 / 37.5, 0.5 / 37.5, 0.07, 0.07], rtol=1e-7)
    np.testing.assert_allclose(p[1, 2:], [math.sqrt(21 * 45) / 300] * 2, rtol=1e-7)
    np.testing.assert_allclose(p[2, 2:], [0.07 * math.sqrt(2), 0.07 / math.sqrt(2)], rtol=1e-6)
    np.testing.assert_allclose(p[4, :2], [1.5 / 37.5, 0.5 / 37.5], rtol=1e-7)  # (H, W, k) order
    assert p.min() >= 0.0 and p.max() <= 1.0
    last = p[-4:]  # the 1x1 level: fk = 1, centre 0.5, sizes clamped to 1
    np.testing.assert_allclose(last[:, :2], 0.5)
    assert last[:, 2:].max() == 1.0


def test_the_heads_layout(params, images):
    det = _detector(params)
    heads = det.model.heads
    assert [h.out_channels for h in heads] == [k * (4 + 81) for k in BOXES_PER_LOCATION]
    assert [h.in_channels for h in heads] == ref.tap_channels(WIDTH)
    loc, conf = det.forward(images)
    assert loc.shape == (2, 8732, 4) and conf.shape == (2, 8732, 81)
    # prior (i, j, k) of the 38x38 level reads head 0's channels k*4 .. and 4k + ... at (i, j)
    taps = det.model.extras(det.model.trunk(torch.as_tensor(images).permute(0, 3, 1, 2)))
    y = torch.nn.functional.conv2d(taps[0], heads[0].weight, heads[0].bias, padding=1)
    i, j, k = 5, 7, 3
    n = (i * FEATURE_MAP_SIZES[0][1] + j) * BOXES_PER_LOCATION[0] + k
    torch.testing.assert_close(loc[0, n], y[0, 4 * k:4 * k + 4, i, j], rtol=1e-6, atol=1e-6)
    c0 = 4 * BOXES_PER_LOCATION[0] + 81 * k
    torch.testing.assert_close(conf[0, n], y[0, c0:c0 + 81, i, j], rtol=1e-6, atol=1e-6)


def test_the_published_widths():
    n = lambda m: sum(p.numel() for p in m.parameters())
    full = model_resnet.SSD300ResNet50(81)
    bn_channels = sum(c for _, _, c, _, bn in model_resnet.conv_paths() if bn)
    assert n(model_resnet.SSD300ResNet50(81, fold_bn=True)) == 22_876_918  # a bias a channel
    assert n(full) == 22_876_918 + bn_channels  # BN's scale and bias in place of the bias
    assert full.trunk.out_channels == 1024 and full.extras.channels == [512, 512, 256, 256, 256]


def _logits(seed):
    """Heads whose softmax puts a few hundred pairs above 0.05 an image."""
    g = torch.Generator().manual_seed(seed)
    loc = torch.randn((2, NUM_PRIORS, 4), generator=g) * 0.5
    conf = torch.randn((2, NUM_PRIORS, 81), generator=g) * 2.0
    conf[..., 0] += 3.0
    return loc, conf


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_at_81_classes_matches_the_references_detect(seed):
    loc, conf = _logits(seed)
    pri = create_priors_coco()
    det = postprocess(loc, conf, torch.as_tensor(pri), score_thresh=0.05, nms_thresh=0.5,
                      max_per_img=200, nms_kind="iou")
    want = ref.detect(loc, conf, torch.as_tensor(pri), 0.05, 0.5, 200)
    for b in range(2):
        m = det.valid[b]
        w = want[b]
        assert w["n_candidates"] > 200 and len(w["labels"]) == int(m.sum()) == 200
        np.testing.assert_array_equal(det.labels[b][m].numpy(), w["labels"])
        np.testing.assert_allclose(det.scores[b][m].numpy(), w["scores"], rtol=1e-5)
        np.testing.assert_allclose(det.boxes[b][m].numpy(), w["boxes"], atol=2e-3)


def test_iou_and_diou_postprocess_differ_where_the_overlaps_do():
    """Two same-class boxes at IoU 0.52 and DIoU 0.49 (centres apart):
    IoU-NMS at 0.5 keeps one, DIoU-NMS both."""
    pri = torch.tensor([[0.5, 0.5, 0.2, 0.2], [0.5 + 0.2 * 0.316, 0.5, 0.2, 0.2]])
    rest = torch.full((NUM_PRIORS - 2, 4), 0.5) * torch.tensor([1, 1, 0.01, 0.01])
    pri = torch.cat([pri, rest])
    loc = torch.zeros((1, NUM_PRIORS, 4))
    conf = torch.full((1, NUM_PRIORS, 81), -20.0)
    conf[0, :, 0] = 20.0
    conf[0, :2, 0], conf[0, 0, 3], conf[0, 1, 3] = -20.0, 20.0, 19.0
    kept = {kind: int(postprocess(loc, conf, pri, 0.05, 0.5, 200, nms_kind=kind).valid.sum())
            for kind in ("iou", "diou")}
    assert kept == {"iou": 1, "diou": 2}


def test_the_detector_picks_the_architectures_nms_and_priors(params):
    det = _detector(params)
    assert det.nms_kind == "iou" == NETWORKS["resnet50"].nms_kind
    np.testing.assert_array_equal(det.priors.numpy(), create_priors_coco())
    vgg = Detector({"a": 0}, device="cpu", width_mult=0.25)
    assert vgg.nms_kind == "diou" and vgg.architecture == "vgg16"


def _staged(det, images, monkeypatch) -> torch.Tensor:
    """What ``Detector._stage`` hands the network, run on the CPU: the
    pinned buffer becomes a pageable one and the stream's wait a no-op."""
    empty = torch.empty
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", lambda *a, pin_memory=False, **kw: empty(*a, **kw))
        m.setattr(torch.cuda, "current_stream",
                  lambda device=None: types.SimpleNamespace(synchronize=lambda: None))
        return det._stage(torch.from_numpy(images))


@pytest.mark.parametrize("arch,stem_kernel", [("resnet50", False), ("vgg16", False),
                                              ("vgg16", True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_host_input_is_staged_in_the_networks_dtype(params, images, monkeypatch, arch,
                                                    stem_kernel, dtype):
    if arch == "resnet50":
        det = _detector(params, dtype=dtype)
    else:
        det = Detector({"a": 0}, device="cpu", width_mult=0.25, dtype=dtype, fold_bn=True,
                       stem_kernel=stem_kernel)
    x = _staged(det, images, monkeypatch)
    assert x.dtype == det.dtype == dtype and x.device == det.device
    assert torch.equal(x, torch.from_numpy(images).to(dtype))  # the host's round to nearest even
    with torch.inference_mode():
        got = det._forward_local(x)
        want = det._forward_local(torch.as_tensor(images))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_what_the_resnet_detector_refuses(params, tmp_path):
    det = _detector(params)
    with pytest.raises(ValueError, match="int8 quantization serves the vgg16 network"):
        det.quantize_int8(np.zeros((1, 300, 300, 3), np.float32))
    with pytest.raises(ValueError, match="from_weights loads the vgg16 network"):
        Detector.from_weights(tmp_path / "none.npz", CLASSES, architecture="resnet50")
    with pytest.raises(ValueError, match="no such stem"):
        Detector(CLASSES, architecture="resnet50", stem_kernel=True, fold_bn=True, device="cpu",
                 width_mult=WIDTH)
    with pytest.raises(ValueError, match="architecture must be one of"):
        Detector(CLASSES, architecture="resnet34", device="cpu")
    with pytest.raises(ValueError, match="load_train_state takes the vgg16"):
        det.load_train_state(None)


def test_the_model_opens_its_spans_inside_the_network(params, images):
    det = _detector(params)
    recent_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        det.predict(images[:1], score_thresh=0.05, max_per_img=200)
    recs = recent_spans()
    by = {r.name: r for r in recs}
    net = by["ssdx_torch.api.network"]
    for part in ("trunk", "extras", "heads"):
        r = by[f"ssdx_torch.model.{part}"]
        assert r.parent == net.id and net.start_ns <= r.start_ns <= r.end_ns <= net.end_ns
    post = by["ssdx_torch.predict.postprocess"].counts
    assert 0 < post["nms_kept"] <= post["nms_candidates"] <= post["nms_slots"] == 1600
