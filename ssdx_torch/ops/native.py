"""ctypes loader for the host-side C++ kernels (``csrc/ssdx_native.cpp``).

The port's counterpart of ``ssdx/ops/native/__init__.py``: the greedy COCO
matchers behind ``MeanAP`` and an exact host DIoU-NMS.  The library is
compiled with ``g++`` at first use into the package's build directory
(``ops/_build.py``), never into the source tree.  ``available()`` is False
on a machine without a compiler, and callers then take their numpy
implementations.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import _build

__all__ = ["available", "match_detections", "match_detections_ignore", "nms_diou"]

_lock = threading.Lock()
_lib = None
_tried = False

_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build.build_host("ssdx_native")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32, f32 = ctypes.c_int32, ctypes.c_float
        lib.ssdx_match_detections.argtypes = [_F32, i32, _F32, i32, f32, _U8]
        lib.ssdx_match_detections.restype = None
        lib.ssdx_match_detections_ignore.argtypes = [_F32, i32, _F32, i32, _U8, f32, _U8, _U8]
        lib.ssdx_match_detections_ignore.restype = None
        lib.ssdx_nms_diou.argtypes = [_F32, _F32, i32, f32, _I32]
        lib.ssdx_nms_diou.restype = i32
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _f32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, np.float32)


def match_detections(det_boxes: np.ndarray, gt_boxes: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Greedy COCO matching: det_boxes [n,4] (score-descending) against
    gt_boxes [m,4]; returns uint8 TP flags [n]."""
    lib = _load()
    det, gt = _f32(det_boxes), _f32(gt_boxes)
    out = np.zeros(len(det), np.uint8)
    lib.ssdx_match_detections(det.ctypes.data_as(_F32), len(det), gt.ctypes.data_as(_F32),
                              len(gt), iou_thresh, out.ctypes.data_as(_U8))
    return out


def match_detections_ignore(det_boxes: np.ndarray, gt_boxes: np.ndarray, gt_ig: np.ndarray,
                            iou_thresh: float) -> tuple[np.ndarray, np.ndarray]:
    """Ignore-aware greedy COCO matching (pycocotools evaluateImg) for one
    (image, class, area-range) group.

    det_boxes [n,4] score-descending; gt_boxes [m,4]; gt_ig [m] bool (True =
    out-of-range GT).  Returns (tp [n] bool, matched_ignored [n] bool), the
    contract of ``ssdx_torch.eval.map._match_with_ignore``.  GTs are sorted
    non-ignored first here, which the C++ loop requires.
    """
    lib = _load()
    order = np.argsort(np.asarray(gt_ig, bool), kind="stable")
    det = _f32(det_boxes)
    gt = _f32(np.asarray(gt_boxes)[order])
    ig = np.ascontiguousarray(np.asarray(gt_ig, np.uint8)[order])
    tp = np.zeros(len(det), np.uint8)
    mig = np.zeros(len(det), np.uint8)
    lib.ssdx_match_detections_ignore(
        det.ctypes.data_as(_F32), len(det), gt.ctypes.data_as(_F32), len(gt),
        ig.ctypes.data_as(_U8), iou_thresh, tp.ctypes.data_as(_U8), mig.ctypes.data_as(_U8))
    return tp.astype(bool), mig.astype(bool)


def nms_diou(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Exact greedy DIoU-NMS; returns the kept indices in score-descending order."""
    lib = _load()
    b, s = _f32(boxes), _f32(scores)
    keep = np.zeros(len(b), np.int32)
    n = lib.ssdx_nms_diou(b.ctypes.data_as(_F32), s.ctypes.data_as(_F32), len(b), thresh,
                          keep.ctypes.data_as(_I32))
    return keep[:n].copy()
