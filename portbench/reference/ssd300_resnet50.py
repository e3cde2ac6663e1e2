"""Plain SSD300 v1.1 (ResNet-50 trunk, 81 classes) in float32 PyTorch: the
reference of the ``ssd300_resnet50_coco`` configuration.

Written from NVIDIA DeepLearningExamples, ``PyTorch/Detection/SSD``:
``ssd/model.py`` (``ResNet``: torchvision's ResNet-50 up to ``layer3``,
whose first block's strides are set to 1; ``SSD300``: five extra blocks and
a loc and a conf conv per tap; ``_init_weights``) and ``ssd/utils.py``
(``dboxes300_coco``, ``Encoder.decode_batch``), with the SSD paper
(arXiv:1512.02325) for the design.  No kernel, no cache, no batching tricks;
it imports neither the program nor the JAX package, and works out again
whatever the program derives (BatchNorm folding, default boxes, decoding,
NMS).  Convolutions run in float32 with TF32 off (``float32_matmuls``).

Departures from NVIDIA's code, each also in the configuration file:

* candidates: the program's two stages (the 800 priors with the best
  foreground probability, then the 1,600 best (prior, class) pairs of
  those) in place of ``decode_batch``'s 200 per class;
* layout: each tap's loc and conf outputs flattened in (row, column, box)
  order, the order of the fused heads and of :func:`priors` (a permutation
  of NVIDIA's ``view(B, 4, -1)`` (box, row, column) layout);
* weights: drawn from the seed with the published initialisers, and
  BatchNorm's statistics taken from calibration scenes (:func:`calibrate_bn`)
  in place of a trained checkpoint.

Parameters are a plain dict::

    {"convs": {path: {"w": OIHW, "bn": {"gamma", "beta", "mean", "var"}}},
     "loc": [{"w", "b"} x 6], "conf": [{"w", "b"} x 6]}

keyed by the module path the program's weights tree uses
(``trunk.conv1``, ``trunk.layer3.0.downsample``, ``extras.4.1``); the
trunk's and extras' convs have no bias (a folded conv gets ``"b"``).
Inputs are NHWC float32 ImageNet-normalized 300x300 images.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ssd300 import IMAGE_SIZE, float32_matmuls  # noqa: F401  (re-exported)

# (blocks, mid, out, stride of the first block) of layer1..layer3
STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 1))
# (mid, out, stride, padding) of the five extra blocks' 3x3 convs
EXTRAS = ((256, 512, 2, 1), (256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
          (128, 256, 1, 0))
FEATURE_MAPS = (38, 19, 10, 5, 3, 1)
STEPS = (8, 16, 32, 64, 100, 300)
SCALES = (21, 45, 99, 153, 207, 261, 315)
ASPECT_RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
BOXES_PER_LOCATION = tuple(2 + 2 * len(a) for a in ASPECT_RATIOS)
VARIANCES = (0.1, 0.2)
BN_EPS = 1e-5


def _w(f: int, width_mult: float) -> int:
    return max(8, int(f * width_mult) // 8 * 8)


def layout(width_mult: float = 1.0) -> list[tuple[str, int, int, int, int, int]]:
    """(path, cin, cout, kernel, stride, padding) of every BN'd conv in
    forward order; a bottleneck's ``downsample`` follows its ``conv3``."""
    w = lambda f: _w(f, width_mult)
    out = [("trunk.conv1", 3, w(64), 7, 2, 3)]
    cin = w(64)
    for s, (n, mid, cout, stride) in enumerate(STAGES, start=1):
        for i in range(n):
            st = stride if i == 0 else 1
            p = f"trunk.layer{s}.{i}"
            out += [(f"{p}.conv1", cin, w(mid), 1, 1, 0), (f"{p}.conv2", w(mid), w(mid), 3, st, 1),
                    (f"{p}.conv3", w(mid), w(cout), 1, 1, 0)]
            if i == 0:
                out.append((f"{p}.downsample", cin, w(cout), 1, st, 0))
            cin = w(cout)
    for e, (mid, cout, stride, pad) in enumerate(EXTRAS):
        out += [(f"extras.{e}.0", cin, w(mid), 1, 1, 0),
                (f"extras.{e}.1", w(mid), w(cout), 3, stride, pad)]
        cin = w(cout)
    return out


def tap_channels(width_mult: float = 1.0) -> list[int]:
    return [_w(1024, width_mult)] + [_w(c, width_mult) for _, c, _, _ in EXTRAS]


GEOMETRY = {path: (stride, pad) for path, _, _, _, stride, pad in layout()}


def priors() -> torch.Tensor:
    """[8732, 4] (cx, cy, w, h): ``dboxes300_coco``.  Level k has
    fk = 300 / step[k] and centres ((j + 0.5) / fk, (i + 0.5) / fk); its
    boxes (s, s), (s', s') with s = scale[k] / 300 and s' = sqrt(s *
    scale[k+1] / 300), then (s sqrt a, s / sqrt a) both ways for each ratio
    a; every column clamped to [0, 1].  Rows in (row, column, box) order."""
    rows = []
    for k, f in enumerate(FEATURE_MAPS):
        fk = IMAGE_SIZE / STEPS[k]
        s = SCALES[k] / IMAGE_SIZE
        whs = [(s, s), (math.sqrt(s * SCALES[k + 1] / IMAGE_SIZE),) * 2]
        for a in ASPECT_RATIOS[k]:
            r = math.sqrt(a)
            whs += [(s * r, s / r), (s / r, s * r)]
        for i in range(f):
            for j in range(f):
                for w, h in whs:
                    rows.append(((j + 0.5) / fk, (i + 0.5) / fk, w, h))
    return torch.tensor(rows, dtype=torch.float64).clamp(0.0, 1.0).float()


# ------------------------------------------------------------------ weights


def init_params(seed: int, num_classes: int, device, width_mult: float = 1.0) -> dict:
    """Seeded weights on ``device`` with NVIDIA's initialisers: the trunk's
    convs Kaiming-normal (fan-out, gain sqrt 2; torchvision's ``ResNet``),
    the extras' and heads' weights Xavier-uniform (``_init_weights``), the
    heads' biases U(+-1/sqrt(fan-in)) (``nn.Conv2d``'s default); BatchNorm
    scale 1, bias 0, statistics 0 and 1 until :func:`calibrate_bn`."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out = {"convs": {}, "loc": [], "conf": []}
    for path, cin, cout, k, _, _ in layout(width_mult):
        if path.startswith("trunk."):
            w = torch.randn((cout, cin, k, k), generator=g, device=device)
            w *= math.sqrt(2.0 / (cout * k * k))
        else:
            a = math.sqrt(6.0 / ((cin + cout) * k * k))
            w = (torch.rand((cout, cin, k, k), generator=g, device=device) * 2 - 1) * a
        out["convs"][path] = {"w": w, "bn": {
            "gamma": torch.ones(cout, device=device), "beta": torch.zeros(cout, device=device),
            "mean": torch.zeros(cout, device=device), "var": torch.ones(cout, device=device)}}
    for c, nd in zip(tap_channels(width_mult), BOXES_PER_LOCATION):
        for kind, n in (("loc", nd * 4), ("conf", nd * num_classes)):
            a = math.sqrt(6.0 / ((c + n) * 9))
            w = (torch.rand((n, c, 3, 3), generator=g, device=device) * 2 - 1) * a
            bb = 1.0 / math.sqrt(c * 9)
            b = (torch.rand(n, generator=g, device=device) * 2 - 1) * bb
            out[kind].append({"w": w, "b": b})
    return out


# ------------------------------------------------------------------ forward


def _same(t):
    return t


def _conv(x, c, path, q=_same):
    """The conv at ``path``; ``q`` rounds its input, weight, bias and output."""
    stride, pad = GEOMETRY[path]
    b = c.get("b")
    return q(F.conv2d(q(x), q(c["w"]), None if b is None else q(b), stride, pad))


def _bn(y, bn, stats: dict | None):
    """Eval-mode BatchNorm, or with ``stats`` batch statistics (biased
    variance), which are stored into ``bn`` as its running statistics."""
    if stats is not None:
        bn["mean"] = y.mean(dim=(0, 2, 3))
        bn["var"] = y.var(dim=(0, 2, 3), unbiased=False)
    scale = bn["gamma"] / torch.sqrt(bn["var"] + BN_EPS)
    return (y - bn["mean"][:, None, None]) * scale[:, None, None] + bn["beta"][:, None, None]


def _cbn(x, params, path, stats=None, q=_same):
    c = params["convs"][path]
    y = _conv(x, c, path, q)
    return y if c.get("bn") is None else _bn(y, c["bn"], stats)


def _bottleneck(x, params, p, stats=None, q=_same):
    y = F.relu(_cbn(x, params, f"{p}.conv1", stats, q))
    y = F.relu(_cbn(y, params, f"{p}.conv2", stats, q))
    y = _cbn(y, params, f"{p}.conv3", stats, q)
    s = _cbn(x, params, f"{p}.downsample", stats, q) if f"{p}.downsample" in params["convs"] else x
    return F.relu(q(y + s))


def heads(params, taps, q=_same):
    """Six taps (NCHW) -> (loc [B,8732,4], conf [B,8732,C])."""
    B = taps[0].shape[0]
    locs, confs = [], []
    for t, lh, ch, nd in zip(taps, params["loc"], params["conf"], BOXES_PER_LOCATION):
        C = ch["w"].shape[0] // nd
        yl = q(F.conv2d(q(t), q(lh["w"]), q(lh["b"]), padding=1))
        yc = q(F.conv2d(q(t), q(ch["w"]), q(ch["b"]), padding=1))
        locs.append(yl.permute(0, 2, 3, 1).reshape(B, -1, 4))
        confs.append(yc.permute(0, 2, 3, 1).reshape(B, -1, C))
    return torch.cat(locs, 1), torch.cat(confs, 1)


def forward(params, images, stats=None, q=None):
    """images [B,300,300,3] -> (loc, conf) in float32.  ``stats`` (a dict)
    switches BatchNorm to the batch's statistics and stores them
    (:func:`calibrate_bn`).  ``q``, when given, rounds what a network in a
    lower precision keeps in it: every conv's input, weight, bias and
    output, and every residual sum (:data:`BF16`, the serving
    configuration's precision; :data:`FP8`, the one below it); the sums
    themselves stay in float32."""
    q = q or _same
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_cbn(x, params, "trunk.conv1", stats, q)), 3, 2, 1)
    for s, (n, *_) in enumerate(STAGES, start=1):
        for i in range(n):
            x = _bottleneck(x, params, f"trunk.layer{s}.{i}", stats, q)
    taps = [x]
    for e in range(len(EXTRAS)):
        x = F.relu(_cbn(x, params, f"extras.{e}.0", stats, q))
        x = F.relu(_cbn(x, params, f"extras.{e}.1", stats, q))
        taps.append(x)
    return heads(params, taps, q)


def BF16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), back in float32."""
    return t.to(torch.bfloat16).float()


def FP8(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float8 e4m3 with one scale a tensor (its largest magnitude
    onto 448), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def calibrate_bn(params, images) -> dict:
    """Set every BatchNorm's statistics to those of ``images`` (one pass in
    batch-statistics mode, all images at once, biased variance), so that
    each layer's activations keep a trained network's unit scale through
    the residual blocks.  Returns ``params``, changed in place."""
    forward(params, images, stats={})
    return params


def fold_bn(params) -> dict:
    """BatchNorm folded into its conv: w * s, (b - mean) * s + beta with
    b = 0, s = gamma / sqrt(var + eps)."""
    convs = {}
    for path, c in params["convs"].items():
        bn = c["bn"]
        s = bn["gamma"] / torch.sqrt(bn["var"] + BN_EPS)
        convs[path] = {"w": c["w"] * s[:, None, None, None], "b": bn["beta"] - bn["mean"] * s,
                       "bn": None}
    return {"convs": convs, "loc": params["loc"], "conf": params["conf"]}


# ---------------------------------------------------------------- detection


def decode(loc, pri):
    c = pri[..., :2] + loc[..., :2] * VARIANCES[0] * pri[..., 2:]
    s = pri[..., 2:] * torch.exp(loc[..., 2:] * VARIANCES[1])
    return torch.cat([c - s / 2, c + s / 2], -1)


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of xyxy boxes a [N,4] against b [M,4]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-7)


def greedy_per_class(boxes: np.ndarray, labels: np.ndarray, thresh: float) -> list[int]:
    """Greedy NMS of score-sorted candidates, class by class: the indices
    kept, in score order."""
    d = iou(boxes, boxes)
    same = labels[:, None] == labels[None, :]
    alive = np.ones(len(boxes), bool)
    keep = []
    for i in range(len(boxes)):
        if alive[i]:
            keep.append(i)
            alive[i + 1:] &= ~((d[i, i + 1:] > thresh) & same[i, i + 1:])
    return keep


def detect(loc, conf, pri, score_thresh: float, nms_thresh: float, max_per_img: int,
           prior_top_k: int = 800, pair_top_k: int = 1600) -> list[dict]:
    """Detections of each image: the ``prior_top_k`` priors by their best
    foreground probability, the ``pair_top_k`` (prior, class) pairs of
    those by probability, pairs above ``score_thresh`` through greedy
    per-class IoU-NMS at ``nms_thresh`` on float64 boxes, the best
    ``max_per_img`` kept.  Boxes are xyxy in 300x300 pixels.  Also:
    ``n_candidates`` (pairs above the threshold, the NMS's work),
    ``same_class_pairs`` (pairs i < j of the ``pair_top_k``, i a
    candidate, of one class: the overlaps the NMS computes) and ``cut``,
    the least score a detection needs to be kept here: the weakest of the
    kept priors' best probability, of the kept pairs, and, where more than
    ``max_per_img`` survive the NMS, of the ``max_per_img`` returned (0
    where nothing is cut)."""
    prob = torch.softmax(conf.float(), -1)
    n_fg = prob.shape[-1] - 1
    out = []
    for b in range(prob.shape[0]):
        best = prob[b, :, 1:].amax(-1)
        sel = torch.sort(best, descending=True, stable=True).indices[:prior_top_k]
        pair = prob[b, sel, 1:].reshape(-1)
        top = torch.sort(pair, descending=True, stable=True).indices[:pair_top_k]
        score = pair[top].double().cpu().numpy()
        label = (top % n_fg).cpu().numpy()
        p_idx = sel[top // n_fg]
        box = (decode(loc[b, p_idx].double(), pri[p_idx].double()).clamp(0, 1)
               * IMAGE_SIZE).cpu().numpy()
        cut = max(float(best[sel[-1]]) if len(sel) == prior_top_k else 0.0,
                  float(score[-1]) if len(top) == pair_top_k else 0.0)
        cand = np.flatnonzero(score > score_thresh)  # already in descending order
        keep = cand[greedy_per_class(box[cand], label[cand], nms_thresh)] if len(cand) else cand
        if len(keep) > max_per_img:
            keep = keep[:max_per_img]
            cut = max(cut, float(score[keep[-1]]))
        same_pairs = int(sum(int((label[i + 1:] == label[i]).sum()) for i in cand))
        out.append({"labels": label[keep].astype(np.int64), "scores": score[keep],
                    "boxes": box[keep], "n_candidates": len(cand),
                    "same_class_pairs": same_pairs, "cut": cut})
    return out
