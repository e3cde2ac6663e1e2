"""The port's C++ host kernels (ssdx_torch/ops/native.py, built with g++ from
ssdx_torch/csrc/ssdx_native.cpp) against the JAX package's (ssdx.ops.native)
and the numpy oracles, as tests/test_native.py holds the JAX package's.

Both libraries compile the same loops with the same flags, so every flag and
every kept index is compared exactly.  ``MeanAP`` with the C++ matcher
against without: mAP equal to float tolerance (np.isclose defaults).

The JAX package's library is a private build of this module
(``torch_parity.jax_native_private``), never the one the package builds
into its source tree, which other test workers may be writing.
"""
from pathlib import Path

import numpy as np
import pytest

from ssdx.ops import native as jax_native
from ssdx_torch.eval import map as mapmod
from ssdx_torch.eval.map import MeanAP, _match_with_ignore
from ssdx_torch.ops import _build, native
from torch_parity import jax_native_private, private_jax_native  # noqa: F401 (autouse fixture)


def _rand_boxes(rng, n, lo=0, hi=250, smin=10, smax=60):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(smin, smax, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_built_outside_the_source_tree():
    assert native.available()  # this machine has g++
    lib = _build.build_host("ssdx_native")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert not list(_build.CSRC.glob("*.so"))


def test_jax_matcher_survives_a_lost_build_race(tmp_path, monkeypatch):
    """A worker that lost the race for the in-tree build is left with
    ``_tried = True, _lib = None`` for its session; the private build still
    gives this module the real reference library."""
    in_tree = Path(jax_native.__file__).parent
    assert jax_native._LIB.parent != in_tree  # the module's private build is in force
    monkeypatch.setattr(jax_native, "_tried", True)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert not jax_native.available()
    rng = np.random.default_rng(11)
    gt = _rand_boxes(rng, 5)
    det = np.concatenate([gt + rng.normal(0, 3, gt.shape).astype(np.float32),
                          _rand_boxes(rng, 4)])
    with private_jax_native(tmp_path) as mod:
        assert mod is jax_native and mod.available()
        assert mod._LIB.parent == tmp_path and mod._lib is not None
        got = mod.match_detections(det, gt, 0.5)
        np.testing.assert_array_equal(got, native.match_detections(det, gt, 0.5))
        assert got.sum() > 0
    assert jax_native._tried and jax_native._lib is None  # the failed state is back


@pytest.mark.parametrize("seed", range(4))
def test_match_detections_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        gt = _rand_boxes(rng, 5)
        det = np.concatenate([gt + rng.normal(0, 4, gt.shape).astype(np.float32),
                              _rand_boxes(rng, 7)])[rng.permutation(12)]
        got = native.match_detections(det, gt, 0.5)
        np.testing.assert_array_equal(got, jax_native.match_detections(det, gt, 0.5))
        assert got.dtype == np.uint8 and got.sum() > 0


def test_match_empty_cases():
    det = _rand_boxes(np.random.default_rng(1), 3)
    none = np.zeros((0, 4), np.float32)
    assert native.match_detections(det, none, 0.5).sum() == 0
    assert len(native.match_detections(none, det, 0.5)) == 0
    tp, mig = native.match_detections_ignore(det, none, np.zeros(0, bool), 0.5)
    assert not tp.any() and not mig.any()


@pytest.mark.parametrize("thresh", [0.3, 0.5, 1.0])
def test_match_detections_ignore_vs_numpy_oracle_and_jax_package(thresh):
    rng = np.random.default_rng(7)
    matched = 0
    for _ in range(20):
        nd, ng = int(rng.integers(0, 15)), int(rng.integers(0, 8))
        det = _rand_boxes(rng, nd)
        k = min(nd, ng)  # half the GTs overlap detections, so matches occur
        gt = np.concatenate([det[:k] + rng.normal(0, 4, (k, 4)).astype(np.float32),
                             _rand_boxes(rng, max(0, ng - k))])[:ng]
        gt_ig = rng.uniform(size=ng) < 0.4
        tp, mig = native.match_detections_ignore(det, gt, gt_ig, thresh)
        for ref in (_match_with_ignore(det, gt, gt_ig, thresh),
                    jax_native.match_detections_ignore(det, gt, gt_ig, thresh)):
            np.testing.assert_array_equal(tp, ref[0])
            np.testing.assert_array_equal(mig, ref[1])
        matched += int(tp.sum() + mig.sum())
    assert matched > 0 or thresh == 1.0


@pytest.mark.parametrize("thresh", [0.3, 0.5])
def test_nms_diou_equals_the_jax_package_and_the_port_nms(thresh):
    import torch

    from ssdx_torch.ops.nms import nms_core_sorted_ref

    rng = np.random.default_rng(2)
    for _ in range(5):
        boxes = _rand_boxes(rng, 30)
        scores = rng.uniform(0, 1, 30).astype(np.float32)
        keep = native.nms_diou(boxes, scores, thresh)
        np.testing.assert_array_equal(keep, jax_native.nms_diou(boxes, scores, thresh))
        order = np.argsort(-scores, kind="stable")
        mask = nms_core_sorted_ref(torch.as_tensor(boxes[order])[None],
                                   torch.ones(1, 30, dtype=torch.bool), thresh)[0].numpy()
        np.testing.assert_array_equal(keep, order[mask])  # both in score order


def test_map_with_the_matcher_equals_without(monkeypatch):
    rng = np.random.default_rng(3)
    preds, targets = [], []
    for _ in range(6):
        gt = _rand_boxes(rng, 4)
        det = np.concatenate([gt + rng.normal(0, 3, gt.shape), _rand_boxes(rng, 3)])
        preds.append({"boxes": det, "scores": rng.uniform(0.1, 1, len(det)).astype(np.float32),
                      "labels": rng.integers(0, 3, len(det))})
        targets.append({"boxes": gt, "labels": rng.integers(0, 3, len(gt))})

    def run():
        m = MeanAP()
        m.update(preds, targets)
        return m.compute()

    calls = []
    real = native.match_detections_ignore
    monkeypatch.setattr(mapmod._native, "match_detections_ignore",
                        lambda *a: calls.append(1) or real(*a))
    with_native = run()
    assert calls  # MeanAP went through the C++ matcher
    monkeypatch.setattr(mapmod._native, "available", lambda: False)
    n = len(calls)
    without = run()
    assert len(calls) == n
    assert np.isclose(with_native["map_50"], without["map_50"])
    for k in ("map_per_class", "mar_100_per_class"):
        np.testing.assert_allclose(with_native[k], without[k])
    for k in ("map_small", "map_medium", "map_large", "mar_1", "mar_10", "mar_100"):
        assert np.isclose(with_native[k], without[k]), k
