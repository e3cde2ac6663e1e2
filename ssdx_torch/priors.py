"""SSD300 default boxes (priors): 8,732 normalized (cx, cy, w, h) rows.

The port's own copy of the numpy construction in the JAX package
(``ssdx/priors.py``).  Order is level -> row -> col -> k, where the k boxes
per location are [(s, s), (s', s'), then for each aspect ratio a:
(s*sqrt a, s/sqrt a), (s/sqrt a, s*sqrt a)]; the multibox heads flatten
their outputs in the same (H, W, k) order (``ssdx_torch/model.py``).

:func:`create_priors_coco` builds the default boxes of NVIDIA's SSD300
v1.1 (``dboxes300_coco`` in DeepLearningExamples' ``ssd/utils.py``), which
the ResNet-50 network (``ssdx_torch/model_resnet.py``) is trained on: the
same levels and boxes per location, sized from pixel scales and centred by
the levels' strides, in the same (H, W, k) order.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "FEATURE_MAP_SIZES",
    "ASPECT_RATIOS_PER_LEVEL",
    "BOXES_PER_LOCATION",
    "NUM_PRIORS",
    "create_priors",
    "create_priors_coco",
    "priors_xyxy",
]

FEATURE_MAP_SIZES = ((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1))
ASPECT_RATIOS_PER_LEVEL = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
# 2 squares + 2 rectangles per aspect ratio.
BOXES_PER_LOCATION = tuple(2 + 2 * len(a) for a in ASPECT_RATIOS_PER_LEVEL)
NUM_PRIORS = sum(
    k * h * w for k, (h, w) in zip(BOXES_PER_LOCATION, FEATURE_MAP_SIZES)
)  # 8732


def _level_whs(s_l: float, s_lp: float, aspect_ratios) -> np.ndarray:
    """Per-location (w, h) list for one pyramid level."""
    whs = [(s_l, s_l), (s_lp, s_lp)]
    for a in aspect_ratios:
        r = np.sqrt(a)
        whs.append((s_l * r, s_l / r))
        whs.append((s_l / r, s_l * r))
    return np.asarray(whs, dtype=np.float32)  # [k, 2]


def create_priors(
    s_min: float = 0.2, s_max: float = 0.9, clip: bool = True
) -> np.ndarray:
    """Return the [8732, 4] normalized (cx, cy, w, h) prior array.

    Scales follow the SSD paper: s_l = s_min + (s_max - s_min) * l / (L - 1)
    with an extra square of scale sqrt(s_l * s_{l+1}) and s_L = 1.0.
    """
    L = len(FEATURE_MAP_SIZES)
    s = [s_min + (s_max - s_min) * (l / (L - 1)) for l in range(L)] + [1.0]

    chunks = []
    for l, (H, W) in enumerate(FEATURE_MAP_SIZES):
        whs = _level_whs(s[l], float(np.sqrt(s[l] * s[l + 1])), ASPECT_RATIOS_PER_LEVEL[l])
        k = whs.shape[0]
        cy = (np.arange(H, dtype=np.float32) + 0.5) / H
        cx = (np.arange(W, dtype=np.float32) + 0.5) / W
        centers = np.stack(
            [np.broadcast_to(cx[None, :], (H, W)), np.broadcast_to(cy[:, None], (H, W))],
            axis=-1,
        )  # [H, W, 2]
        level = np.concatenate(
            [
                np.broadcast_to(centers[:, :, None, :], (H, W, k, 2)),
                np.broadcast_to(whs[None, None, :, :], (H, W, k, 2)),
            ],
            axis=-1,
        )
        chunks.append(level.reshape(-1, 4))

    priors = np.concatenate(chunks, axis=0)
    assert priors.shape == (NUM_PRIORS, 4)
    if clip:
        eps = 1e-6
        priors[:, 0:2] = np.clip(priors[:, 0:2], 0.0, 1.0)
        priors[:, 2:4] = np.clip(priors[:, 2:4], eps, 1.0)
    return priors


# dboxes300_coco: figure size, strides and the 7 pixel scales of the levels
COCO_FIG_SIZE = 300
COCO_STEPS = (8, 16, 32, 64, 100, 300)
COCO_SCALES = (21, 45, 99, 153, 207, 261, 315)


def create_priors_coco() -> np.ndarray:
    """Return NVIDIA's [8732, 4] (cx, cy, w, h) default boxes, float32.

    Level l has fk = 300 / step[l] (37.5 at the 38x38 level) and centres
    ((j + 0.5) / fk, (i + 0.5) / fk); its boxes are (sk1, sk1), (sk2, sk2)
    with sk1 = scale[l] / 300 and sk2 = sqrt(sk1 * scale[l+1] / 300), then
    (sk1 sqrt a, sk1 / sqrt a) both ways for each aspect ratio a.  Every
    column is clamped to [0, 1], as ``DefaultBoxes`` does; computed in
    float64, rounded once to float32.
    """
    chunks = []
    for l, (H, W) in enumerate(FEATURE_MAP_SIZES):
        fk = COCO_FIG_SIZE / COCO_STEPS[l]
        sk1 = COCO_SCALES[l] / COCO_FIG_SIZE
        sk2 = np.sqrt(sk1 * COCO_SCALES[l + 1] / COCO_FIG_SIZE)
        whs = [(sk1, sk1), (sk2, sk2)]
        for a in ASPECT_RATIOS_PER_LEVEL[l]:
            r = np.sqrt(a)
            whs += [(sk1 * r, sk1 / r), (sk1 / r, sk1 * r)]
        cy, cx = np.meshgrid((np.arange(H) + 0.5) / fk, (np.arange(W) + 0.5) / fk,
                             indexing="ij")
        level = np.empty((H, W, len(whs), 4))
        level[..., 0], level[..., 1] = cx[..., None], cy[..., None]
        level[..., 2:] = np.asarray(whs)[None, None]
        chunks.append(level.reshape(-1, 4))
    priors = np.clip(np.concatenate(chunks), 0.0, 1.0).astype(np.float32)
    assert priors.shape == (NUM_PRIORS, 4)
    return priors


def priors_xyxy(priors_cxcywh: np.ndarray) -> np.ndarray:
    """xyxy form of the priors, clamped to [0, 1]."""
    half = 0.5 * priors_cxcywh[:, 2:4]
    xyxy = np.concatenate(
        [priors_cxcywh[:, 0:2] - half, priors_cxcywh[:, 0:2] + half], axis=1
    )
    return np.clip(xyxy, 0.0, 1.0)
