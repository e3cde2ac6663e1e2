"""Plain SSD300 in float32 PyTorch: the benchmark's reference.

Written from the SSD paper (Liu et al., arXiv:1512.02325, sections 2-3)
and the configuration files beside it, with no kernel, no cache and no
batching tricks, and independent of the program under test: it imports
neither the program nor the JAX package, and works out again whatever the
program derives from the shared inputs (BatchNorm folding, int8
calibration and quantization, priors, box decoding, matching, the loss,
the optimizer step).  Convolutions run in float32 with TF32 off
(``float32_matmuls``).

Parameters are a plain dict::

    {"convs": [{"w": OIHW, "b": [cout], "bn": {"gamma", "beta", "mean",
                "var"} or None} x 23],
     "loc": [{"w", "b"} x 6], "conf": [{"w", "b"} x 6]}

Inputs are NHWC float32 ImageNet-normalized 300x300 images; the heads'
outputs are flattened in (row, column, box) order, the order of the priors.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_SIZE = 300
# (cout, kernel, stride, padding, dilation, batchnorm) of the 23 convs
BACKBONE = (
    (64, 3, 1, 1, 1, True), (64, 3, 1, 1, 1, True),
    (128, 3, 1, 1, 1, True), (128, 3, 1, 1, 1, True),
    (256, 3, 1, 1, 1, True), (256, 3, 1, 1, 1, True), (256, 3, 1, 1, 1, True),
    (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True),
    (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True),
    (1024, 3, 1, 6, 6, True), (1024, 1, 1, 0, 1, True),
    (256, 1, 1, 0, 1, True), (512, 3, 2, 1, 1, True),
    (128, 1, 1, 0, 1, True), (256, 3, 2, 1, 1, True),
    (128, 1, 1, 0, 1, True), (256, 3, 1, 0, 1, False),
    (128, 1, 1, 0, 1, False), (256, 3, 1, 0, 1, False),
)
POOL_AFTER = {1: False, 3: False, 6: True, 9: False}  # True: ceil mode (75 -> 38)
TAPS = (9, 14, 16, 18, 20, 22)
FEATURE_MAPS = (38, 19, 10, 5, 3, 1)
ASPECT_RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
BOXES_PER_LOCATION = tuple(2 + 2 * len(a) for a in ASPECT_RATIOS)
VARIANCES = (0.1, 0.2)
BN_EPS = 1e-5
STEM = 2  # conv1_1, conv1_2: kept in floating point by the int8 configuration


@contextlib.contextmanager
def float32_matmuls():
    """Convolutions and matmuls in true float32 (no TF32) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def channels(width_mult: float = 1.0) -> list[tuple[int, int]]:
    out, cin = [], 3
    for cout, *_ in BACKBONE:
        cout = max(8, int(cout * width_mult) // 8 * 8)
        out.append((cin, cout))
        cin = cout
    return out


def priors() -> torch.Tensor:
    """[8732, 4] (cx, cy, w, h) in [0, 1]: scales 0.2..0.9 over six maps,
    an extra square of scale sqrt(s_k s_k+1), two boxes per aspect ratio."""
    L = len(FEATURE_MAPS)
    s = [0.2 + 0.7 * k / (L - 1) for k in range(L)] + [1.0]
    rows = []
    for k, f in enumerate(FEATURE_MAPS):
        whs = [(s[k], s[k]), (math.sqrt(s[k] * s[k + 1]),) * 2]
        for a in ASPECT_RATIOS[k]:
            r = math.sqrt(a)
            whs += [(s[k] * r, s[k] / r), (s[k] / r, s[k] * r)]
        for i in range(f):
            for j in range(f):
                for w, h in whs:
                    rows.append(((j + 0.5) / f, (i + 0.5) / f, w, h))
    p = torch.tensor(rows, dtype=torch.float64)
    p[:, :2] = p[:, :2].clamp(0.0, 1.0)
    p[:, 2:] = p[:, 2:].clamp(1e-6, 1.0)
    return p.float()


# ------------------------------------------------------------------ weights


def load_bundle(path, device) -> dict:
    """Parameters from a weights bundle: an ``.npz`` whose keys are
    slash-joined paths ``params/ConvBNRelu_i/{Conv_0,BatchNorm_0}/...``,
    ``params/{box,cls}_head_i/...`` and ``batch_stats/ConvBNRelu_i/
    BatchNorm_0/{mean,var}``, kernels in HWIO."""
    with np.load(path) as z:
        a = {k: z[k].astype(np.float32) for k in z.files}
    t = lambda k: torch.as_tensor(a[k], device=device)
    oihw = lambda k: t(k).permute(3, 2, 0, 1).contiguous()
    convs = []
    for i, (*_, bn) in enumerate(BACKBONE):
        p = f"params/ConvBNRelu_{i}"
        c = {"w": oihw(f"{p}/Conv_0/kernel"), "b": t(f"{p}/Conv_0/bias"), "bn": None}
        if bn:
            s = f"batch_stats/ConvBNRelu_{i}/BatchNorm_0"
            c["bn"] = {"gamma": t(f"{p}/BatchNorm_0/scale"), "beta": t(f"{p}/BatchNorm_0/bias"),
                       "mean": t(f"{s}/mean"), "var": t(f"{s}/var")}
        convs.append(c)
    head = lambda kind, i: {"w": oihw(f"params/{kind}_head_{i}/kernel"),
                            "b": t(f"params/{kind}_head_{i}/bias")}
    return {"convs": convs, "loc": [head("box", i) for i in range(6)],
            "conf": [head("cls", i) for i in range(6)]}


def init_params(seed: int, num_classes: int, device, width_mult: float = 1.0) -> dict:
    """Seeded training weights drawn on ``device`` in one call: He-normal
    kernels (variance 2 / fan-out, clipped at two standard deviations),
    zero biases, BatchNorm at identity."""
    chans = channels(width_mult)
    shapes = [(cout, cin, k, k) for (cin, cout), (_, k, *_) in zip(chans, BACKBONE)]
    for t, k in zip(TAPS, BOXES_PER_LOCATION):
        shapes += [(k * 4, chans[t][1], 3, 3), (k * num_classes, chans[t][1], 3, 3)]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=g, device=device)
    flat.clamp_(-2.0, 2.0)
    ws = []
    for s, chunk in zip(shapes, flat.split([math.prod(s) for s in shapes])):
        ws.append(chunk.view(s) * math.sqrt(2.0 / (s[0] * s[2] * s[3])))
    zeros = lambda n: torch.zeros(n, device=device)
    ones = lambda n: torch.ones(n, device=device)
    convs = []
    for w, (*_, bn) in zip(ws, BACKBONE):
        n = w.shape[0]
        convs.append({"w": w, "b": zeros(n), "bn": None if not bn else {
            "gamma": ones(n), "beta": zeros(n), "mean": zeros(n), "var": ones(n)}})
    heads = ws[len(BACKBONE):]
    return {"convs": convs,
            "loc": [{"w": w, "b": zeros(w.shape[0])} for w in heads[0::2]],
            "conf": [{"w": w, "b": zeros(w.shape[0])} for w in heads[1::2]]}


def leaves(params: dict) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every trained parameter, in a fixed order."""
    out = []
    for i, c in enumerate(params["convs"]):
        out += [(f"conv{i}.w", c["w"]), (f"conv{i}.b", c["b"])]
        if c["bn"] is not None:
            out += [(f"conv{i}.gamma", c["bn"]["gamma"]), (f"conv{i}.beta", c["bn"]["beta"])]
    for kind in ("loc", "conf"):
        for i, h in enumerate(params[kind]):
            out += [(f"{kind}{i}.w", h["w"]), (f"{kind}{i}.b", h["b"])]
    return out


# ------------------------------------------------------------------ forward


def _conv(x, c, i, q=None):
    _, _, stride, pad, dil, _ = BACKBONE[i]
    w = c["w"]
    if q is not None:
        x, w = q(x), q(w)
    y = F.conv2d(x, w, c["b"], stride, pad, dil)
    return y if q is None or not hasattr(q, "grad") else q.grad(y)


def _bn(y, bn, train: bool, q=None):
    if train:
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
        if getattr(q, "stats_dtype", None) is not None:
            mean, var = (t.to(q.stats_dtype).float() for t in (mean, var))
    else:
        mean, var = bn["mean"], bn["var"]
    scale = bn["gamma"] / torch.sqrt(var + BN_EPS)
    return (y - mean[:, None, None]) * scale[:, None, None] + bn["beta"][:, None, None]


def _pool(x, i):
    return F.max_pool2d(x, 2, 2, ceil_mode=POOL_AFTER[i])


def heads(params, taps, q=None):
    """Six taps (NCHW) -> (loc [B,8732,4], conf [B,8732,C])."""
    B = taps[0].shape[0]
    locs, confs = [], []
    for t, lh, ch in zip(taps, params["loc"], params["conf"]):
        wl, wc = lh["w"], ch["w"]
        if q is not None:
            t, wl, wc = q(t), q(wl), q(wc)
        yl, yc = F.conv2d(t, wl, lh["b"], padding=1), F.conv2d(t, wc, ch["b"], padding=1)
        if q is not None and hasattr(q, "grad"):
            yl, yc = q.grad(yl), q.grad(yc)
        C = ch["w"].shape[0] // (lh["w"].shape[0] // 4)
        locs.append(yl.permute(0, 2, 3, 1).reshape(B, -1, 4))
        confs.append(yc.permute(0, 2, 3, 1).reshape(B, -1, C))
    return torch.cat(locs, 1), torch.cat(confs, 1)


def forward(params, images, train: bool = False, q=None):
    """images [B,300,300,3] -> (loc, conf).  ``train`` normalizes with the
    batch's statistics (biased variance); ``q``, when given, is applied to
    every conv's input and weight (a lower-precision control)."""
    x = images.permute(0, 3, 1, 2)
    taps = []
    for i, c in enumerate(params["convs"]):
        y = _conv(x, c, i, q)
        if c["bn"] is not None:
            y = _bn(y, c["bn"], train, q)
        x = F.relu(y)
        if i in TAPS:
            taps.append(x)
        if i in POOL_AFTER:
            x = _pool(x, i)
    return heads(params, taps, q)


# ------------------------------------------------------------ int8 serving


def fold_bn(params) -> dict:
    """BatchNorm folded into its conv: w * s, (b - mean) * s + beta,
    s = gamma / sqrt(var + eps)."""
    convs = []
    for c in params["convs"]:
        if c["bn"] is None:
            convs.append({"w": c["w"], "b": c["b"], "bn": None})
            continue
        bn = c["bn"]
        s = bn["gamma"] / torch.sqrt(bn["var"] + BN_EPS)
        convs.append({"w": c["w"] * s[:, None, None, None],
                      "b": (c["b"] - bn["mean"]) * s + bn["beta"], "bn": None})
    return {"convs": convs, "loc": params["loc"], "conf": params["conf"]}


def stem(folded, images):
    """conv1_1, conv1_2 (+ReLU) and the first pool: NCHW [B,64,150,150]."""
    x = images.permute(0, 3, 1, 2)
    for i in range(STEM):
        x = F.relu(_conv(x, folded["convs"][i], i))
    return _pool(x, STEM - 1)


def calibrate(folded, images, chunk: int = 16) -> list[torch.Tensor]:
    """Per-channel max |input| of each post-stem conv over ``images``, in
    float32: the activation ranges that int8 serving scales to."""
    amax = [None] * len(BACKBONE)
    for s in range(0, images.shape[0], chunk):
        x = stem(folded, images[s:s + chunk])
        for i in range(STEM, len(BACKBONE)):
            a = x.abs().amax(dim=(0, 2, 3))
            amax[i] = a if amax[i] is None else torch.maximum(amax[i], a)
            x = F.relu(_conv(x, folded["convs"][i], i))
            if i in POOL_AFTER:
                x = _pool(x, i)
    return amax


def quantize(folded, amax, bits: int = 8) -> list:
    """Symmetric ``bits``-bit quantization of each post-stem conv: the input
    scale a[c] / L per input channel is folded into the weight, which is
    then quantized with one scale per output channel; L = 2^(bits-1) - 1."""
    L = 2 ** (bits - 1) - 1
    out = [None] * len(BACKBONE)
    for i in range(STEM, len(BACKBONE)):
        c = folded["convs"][i]
        s_in = amax[i].clamp(min=1e-12) / L
        wf = c["w"] * s_in[None, :, None, None]
        s_w = wf.abs().amax(dim=(1, 2, 3)).clamp(min=1e-30) / L
        out[i] = {"s_in": s_in, "s_w": s_w, "b": c["b"],
                  "wq": torch.clamp(torch.round(wf / s_w[:, None, None, None]), -L, L)}
    return out


def forward_quantized(folded, qlayers, images, bits: int = 8):
    """The quantized serving network: float32 stem, each post-stem conv on
    integer inputs and weights (summed exactly in float64), dequantized
    with its weight scales, biased and ReLU'd in float32; float32 heads."""
    L = 2 ** (bits - 1) - 1
    x = stem(folded, images)
    taps = []
    for i in range(STEM, len(BACKBONE)):
        ql = qlayers[i]
        xq = torch.clamp(torch.round(x / ql["s_in"][None, :, None, None]), -L, L)
        _, _, stride, pad, dil, _ = BACKBONE[i]
        acc = F.conv2d(xq.double(), ql["wq"].double(), None, stride, pad, dil).float()
        x = F.relu(acc * ql["s_w"][None, :, None, None] + ql["b"][None, :, None, None])
        if i in TAPS:
            taps.append(x)
        if i in POOL_AFTER:
            x = _pool(x, i)
    return heads(folded, taps)


def _fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """float8 training numerics with one scale per tensor: the value in
    e4m3 (amax onto 448), the gradient that flows back through it in e5m2
    (amax onto 57344), as float8 training recipes store them."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose gradient is stored in e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Fp8:
    """Each precision of a bf16 training configuration one step down: a
    conv's operands in float8 (``q(x)``, ``q(w)``) and the gradient of its
    output in float8 (``q.grad(y)``) where the configuration computes in
    bfloat16; BatchNorm statistics (``stats_dtype``), parameters and the
    optimizer's state (``param_dtype``) in bfloat16 where it keeps them in
    float32."""

    stats_dtype = torch.bfloat16
    param_dtype = torch.bfloat16

    def __call__(self, t):
        return _Fp8.apply(t)

    def grad(self, y):
        return _Fp8Grad.apply(y)


fake_quant_fp8 = Fp8()


class Fp8Convs(Fp8):
    """Float8 convolutions alone: statistics, parameters and optimizer state
    kept in float32 as the configuration states."""

    stats_dtype = None
    param_dtype = None


class _Bf16(torch.autograd.Function):
    """The value rounded to bfloat16, and the gradient through it."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class Bf16:
    """The configuration's own precisions, emulated: a conv's operands, its
    output and the output's gradient rounded to bfloat16, accumulation,
    BatchNorm statistics, parameters and optimizer state in float32."""

    stats_dtype = None
    param_dtype = None

    def __call__(self, t):
        return _Bf16.apply(t)

    def grad(self, y):
        return _Bf16.apply(y)


# ---------------------------------------------------------------- detection


def _xyxy(cxcywh):
    return torch.cat([cxcywh[..., :2] - cxcywh[..., 2:] / 2, cxcywh[..., :2] + cxcywh[..., 2:] / 2], -1)


def decode(loc, pri):
    c = pri[..., :2] + loc[..., :2] * VARIANCES[0] * pri[..., 2:]
    s = pri[..., 2:] * torch.exp(loc[..., 2:] * VARIANCES[1])
    return _xyxy(torch.cat([c, s], -1))


def diou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance-IoU of xyxy boxes a [N,4] against b [M,4]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
    iou = inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-7)
    e = np.maximum(a[:, None, 2:], b[None, :, 2:]) - np.minimum(a[:, None, :2], b[None, :, :2])
    d = (a[:, None, :2] + a[:, None, 2:]) / 2 - (b[None, :, :2] + b[None, :, 2:]) / 2
    return iou - (d ** 2).sum(-1) / np.maximum((e ** 2).sum(-1), 1e-7)


def detect(loc, conf, pri, score_thresh: float, nms_thresh: float, max_per_img: int,
           prior_top_k: int = 200, pair_top_k: int = 400) -> list[dict]:
    """Detections of each image: the ``prior_top_k`` priors by their best
    foreground probability, the ``pair_top_k`` (prior, class) pairs of
    those by probability, pairs above ``score_thresh`` through greedy
    per-class DIoU-NMS at ``nms_thresh``, the best ``max_per_img`` kept.
    Boxes are xyxy in 300x300 pixels; ``n_candidates`` counts the pairs
    above the threshold, the work the NMS is given; ``cut`` is the least
    score that the two top-k stages let through (0 where they cut nothing)."""
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
        # the least score a candidate needs here: the weakest of the kept
        # priors' best probability and the weakest of the kept pairs
        cut = max(float(best[sel[-1]]) if len(sel) == prior_top_k else 0.0,
                  float(score[-1]) if len(top) == pair_top_k else 0.0)
        cand = np.flatnonzero(score > score_thresh)  # already in descending order
        keep = []
        if len(cand):
            d = diou(box[cand], box[cand])
            same = label[cand][:, None] == label[cand][None, :]
            alive = np.ones(len(cand), bool)
            for i in range(len(cand)):
                if alive[i]:
                    keep.append(cand[i])
                    alive[i + 1:] &= ~((d[i, i + 1:] > nms_thresh) & same[i, i + 1:])
        keep = np.asarray(keep[:max_per_img], np.int64)
        out.append({"labels": label[keep].astype(np.int64), "scores": score[keep],
                    "boxes": box[keep], "n_candidates": len(cand), "cut": cut})
    return out


# ----------------------------------------------------------------- training


def ciou(a, b):
    """Complete-IoU of xyxy priors a [P,4] against boxes b [B,G,4] -> [B,P,G]."""
    a, b = a[None, :, None, :], b[:, None, :, :]
    lt, rb = torch.maximum(a[..., :2], b[..., :2]), torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[..., 2] - x[..., 0]).clamp(min=0) * (x[..., 3] - x[..., 1]).clamp(min=0)
    iou = inter / (area(a) + area(b) - inter).clamp(min=1e-7)
    e = torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])
    c2 = (e ** 2).sum(-1).clamp(min=1e-7)
    d2 = (((a[..., :2] + a[..., 2:]) - (b[..., :2] + b[..., 2:])) / 2).pow(2).sum(-1)
    wa, ha = (a[..., 2] - a[..., 0]).clamp(min=1e-7), (a[..., 3] - a[..., 1]).clamp(min=1e-7)
    wb, hb = (b[..., 2] - b[..., 0]).clamp(min=1e-7), (b[..., 3] - b[..., 1]).clamp(min=1e-7)
    v = 4 / math.pi ** 2 * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = v / (1 - iou + v).clamp(min=1e-7)
    return iou - d2 / c2 - alpha * v


def targets(boxes, labels, valid, pri, iou_thresh: float):
    """Match priors to ground truth: each box claims its best prior, every
    other prior takes its best box at CIoU >= ``iou_thresh``.  Returns
    (loc targets [B,P,4], class targets [B,P] with 0 = background, pos)."""
    P = pri.shape[0]
    m = ciou(_xyxy(pri).clamp(0, 1), boxes)
    m = torch.where(valid[:, None, :], m, torch.full_like(m, -1e4))
    best_prior = m.argmax(1)  # [B,G]
    forced = (torch.arange(P, device=m.device)[None, :, None] == best_prior[:, None, :]) \
        & valid[:, None, :]
    m = torch.where(forced, torch.full_like(m, 2.0), m)
    best_iou, best_gt = m.max(2)
    pos = best_iou >= iou_thresh
    g = torch.gather(boxes, 1, best_gt[..., None].expand(-1, -1, 4))
    gc = torch.cat([(g[..., :2] + g[..., 2:]) / 2, (g[..., 2:] - g[..., :2]).clamp(min=1e-6)], -1)
    t = torch.cat([(gc[..., :2] - pri[:, :2]) / pri[:, 2:] / VARIANCES[0],
                   torch.log((gc[..., 2:] / pri[:, 2:]).clamp(min=1e-12)) / VARIANCES[1]], -1)
    cls = torch.where(pos, torch.gather(labels.long(), 1, best_gt) + 1, torch.zeros_like(best_gt))
    return t, cls, pos


def multibox_loss(loc, conf, t, cls, pos, neg_ratio: float = 3.0):
    """Smooth-L1 over positives plus cross-entropy over positives and the
    ``floor(neg_ratio * positives)`` hardest negatives of each image (an
    image without positives keeps ``int(neg_ratio)``), over the positives."""
    posf = pos.float()
    n_pos = posf.sum(1)
    total = n_pos.sum().clamp(min=1)
    d = (loc - t).abs()
    l1 = torch.where(d < 1, 0.5 * d * d, d - 0.5).sum(-1)
    ce = torch.logsumexp(conf, -1) - torch.gather(conf, -1, cls[..., None])[..., 0]
    neg_ce = torch.where(pos, torch.full_like(ce, -math.inf), ce).detach()
    rank = torch.argsort(torch.argsort(-neg_ce, dim=1, stable=True), dim=1, stable=True)
    n_neg = torch.where(n_pos == 0, torch.full_like(n_pos, float(int(neg_ratio))),
                        torch.floor(neg_ratio * n_pos))
    neg = (rank < n_neg[:, None]) & ~pos
    return ((l1 * posf).sum() + (ce * posf).sum() + (ce * neg.float()).sum()) / total


def warmup_cosine(step: int, base_lr, warmup_steps, total_steps, min_lr) -> float:
    """Linear warm-up from 0, then a cosine from ``base_lr`` to ``min_lr``."""
    if step < warmup_steps:
        return base_lr * step / warmup_steps
    p = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0), 1.0)
    return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * p))


def sgd_nesterov(tensors, grads, bufs, lr, momentum, weight_decay):
    """One SGD step with Nesterov momentum; weight decay is added to the
    gradient before the momentum, and the first step's buffer is that sum."""
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(tensors, grads)):
            g = g + weight_decay * p
            bufs[i] = g.clone() if bufs[i] is None else momentum * bufs[i] + g
            p -= lr * (g + momentum * bufs[i])
