"""ssdx_torch.viz against ssdx.viz on the fixtures of tests/test_viz.py
(matplotlib on the Agg backend).  Both draw the same figure from the same
inputs, so the rendered pixels are compared exactly; tensors are accepted
where arrays are."""
import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch
from PIL import Image

from ssdx import viz as ref
from ssdx_torch import viz as port


def _pixels(fig):
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    import matplotlib.pyplot as plt

    plt.close(fig)
    return out


def _losses(n=3):
    return {
        "train_loss": [3.0 - i for i in range(n)],
        "train_loss_loc": [1.0] * n,
        "train_loss_conf": [2.0 - i for i in range(n)],
        "test_loss": [3.5 - i for i in range(n)],
        "test_loss_loc": [1.2] * n,
        "test_loss_conf": [2.3 - i for i in range(n)],
        "mAP": [{"map_50": 0.1 * (i + 1)} for i in range(n)],
    }


def test_plot_losses_equals_the_jax_package():
    fig = port.plot_losses(_losses())
    assert len(fig.axes) == 4
    np.testing.assert_array_equal(_pixels(fig), _pixels(ref.plot_losses(_losses())))


@pytest.mark.parametrize("breakage,error", [
    (lambda d: d.pop("mAP"), KeyError),
    (lambda d: d["train_loss"].__setitem__(0, float("nan")), ValueError),
    (lambda d: d.__setitem__("test_loss", d["test_loss"][:-1]), ValueError),
    (lambda d: d.__setitem__("train_loss", "oops"), TypeError),
])
def test_plot_losses_validation(breakage, error):
    bad = _losses()
    breakage(bad)
    with pytest.raises(error):
        port.plot_losses(bad)


@pytest.mark.parametrize("pred_ref", ["normalized", "current", "size"])
def test_show_with_box_equals_the_jax_package(pred_ref):
    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8)
    target = {"boxes": np.array([[5, 5, 30, 30]], np.float32), "labels": np.array([0])}
    pred = {"boxes": np.array([[0.1, 0.1, 0.5, 0.5]], np.float32), "labels": np.array([1])}
    kw = dict(class_to_idx={"car": 0, "truck": 1}, label=True, pred_label=True,
              pred_ref=pred_ref)
    want = _pixels(ref.show_with_box(img, target, pred_dict=pred, **kw))
    np.testing.assert_array_equal(_pixels(port.show_with_box(img, target, pred_dict=pred, **kw)),
                                  want)
    as_tensors = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    got = port.show_with_box(torch.as_tensor(img), as_tensors(target),
                             pred_dict=as_tensors(pred), **kw)
    np.testing.assert_array_equal(_pixels(got), want)


def test_show_with_box_rejects_bad_references():
    img = np.zeros((64, 64, 3), np.uint8)
    target = {"boxes": np.array([[5, 5, 30, 30]], np.float32), "labels": np.array([0])}
    pred = {"boxes": np.array([[0.1, 0.1, 0.5, 0.5]], np.float32), "labels": np.array([1])}
    with pytest.raises(ValueError):
        port.show_with_box(img, target, pred_dict=pred, pred_ref="bogus")
    with pytest.raises(ValueError):
        port.show_with_box(img, target, pred_dict=pred, pred_ref="size", pred_size=(0, 0))


def test_show_with_box_chw_float_input():
    img = np.random.default_rng(1).uniform(0, 1, (3, 48, 48)).astype(np.float32)
    empty = {"boxes": np.zeros((0, 4)), "labels": np.zeros(0)}
    want = _pixels(ref.show_with_box(img, empty))
    np.testing.assert_array_equal(_pixels(port.show_with_box(torch.as_tensor(img), empty)), want)
    np.testing.assert_array_equal(port._to_hwc_uint8(img), ref._to_hwc_uint8(img))
    np.testing.assert_array_equal(port._to_hwc_uint8(Image.fromarray(port._to_hwc_uint8(img))),
                                  ref._to_hwc_uint8(img))
    assert port._as_xyxy(None) is None and port._as_xyxy([1, 2, 3, 4]).shape == (1, 4)


class _StubDetector:
    idx_to_class = {0: "car"}

    def predict_pil(self, pil_img, **kw):
        return {"labels": np.array([0]), "scores": np.array([0.8]),
                "boxes": np.array([[10, 10, 100, 100]], np.float32)}


def test_side_by_side_equals_the_jax_package():
    img = Image.new("RGB", (640, 480), (10, 20, 30))
    out = port.side_by_side_prediction(_StubDetector(), pil_img=img, target_height=256)
    assert out.height == 256 and out.width == 2 * round(256 * 640 / 480)
    want = ref.side_by_side_prediction(_StubDetector(), pil_img=img, target_height=256)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
    with pytest.raises(TypeError):
        port.side_by_side_prediction(_StubDetector())
