"""Batched detection augmentation on the device of its inputs.

The port's counterpart of ``ssdx/data/augment.py``: the torchvision v2 chain

    ToImage -> float32(scale) -> [RandomZoomOut(fill=0)] -> ConditionalIoUCrop
    -> SanitizeBoundingBoxes(min_size=1) -> RandomHorizontalFlip ->
    RandomPhotometricDistort -> Resize(300, antialias) -> Normalize(ImageNet)

as one sampled source window per image (zoom-out, IoU crop and the final
resize compose into a single antialiased resample), a flip, the photometric
ops and the normalization, all batched tensor ops.  Rejection sampling is a
fixed number of candidate draws with a first-valid-wins select, as in the
JAX package.

Every function is split into a sampler and a deterministic core.
:func:`sample_draws` makes all the random numbers of one batch
(:class:`AugmentDraws`, uniforms in [0, 1) and a channel permutation) from a
``torch.Generator``; :func:`augment_core` is a pure function of the batch and
those draws.  ``jax.random`` and a ``torch.Generator`` give different numbers
from the same seed, so the core is held to the JAX package on equal draws
and the sampler by its distribution (tests/test_torch_augment.py).

The resample is the JAX package's ``jax.image.scale_and_translate(method=
"linear", antialias=True)``, which no PyTorch call reproduces
(``F.interpolate(antialias=True)`` takes no source window): two per-axis
triangle-kernel weight matrices ``[out, in]`` per image, widened by the
downscaling factor, normalized, zero where the sample falls outside the
source (the zoom-out fill), applied as batched matrix products.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..model import IMAGE_SIZE

__all__ = ["AugmentConfig", "AugmentDraws", "sample_draws", "augment_core", "augment_batch",
           "preprocess_batch", "select_windows", "select_iou_crop", "transform_boxes",
           "resample", "hflip", "photometric_distort", "normalize", "IMAGENET_MEAN",
           "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class AugmentConfig(NamedTuple):
    """Training-augmentation hyperparameters (the reference notebook's)."""

    # RandomZoomOut (v2 defaults: side_ratio in [1, 4], fill=0)
    zoom_out_prob: float = 0.0  # the reference's best run disables zoom-out
    zoom_out_max: float = 4.0
    # ConditionalIoUCrop
    min_area_frac: float = 0.02
    small_min_scale: float = 0.4
    large_min_scale: float = 0.7
    max_scale: float = 1.0
    min_aspect_ratio: float = 0.75
    max_aspect_ratio: float = 1.33
    small_sampler_options: tuple = (0.0, 0.05, 0.1, 2.0)
    large_sampler_options: tuple = (0.05, 0.1, 0.3, 2.0)
    trials: int = 10
    # torchvision's outer loop redraws the option until the sentinel or a
    # success; the fixed-shape form stops after ``outer_rounds`` rounds
    outer_rounds: int = 8
    # SanitizeBoundingBoxes
    min_box_size: float = 1.0
    # RandomHorizontalFlip
    hflip_prob: float = 0.5
    # RandomPhotometricDistort (v2 defaults)
    photometric_prob: float = 0.5
    brightness: tuple = (0.875, 1.125)
    contrast: tuple = (0.5, 1.5)
    saturation: tuple = (0.5, 1.5)
    hue: tuple = (-0.05, 0.05)


class AugmentDraws(NamedTuple):
    """The random numbers of one batch; floats are uniform in [0, 1).

    zoom:       [B, 4]  zoom gate, side ratio, x and y placement.
    crop_opt:   [B, 2, R]  sampler-option draw per round (small, large policy).
    crop_u:     [B, 2, 4, R, T]  width, height, x, y of every candidate.
    flip:       [B]
    photo_gate: [B, 7]  brightness, contrast, saturation, hue, (unused),
                contrast-first, permutation gates (the JAX package's order).
    photo_f:    [B, 4]  brightness, contrast, saturation, hue factors.
    perm:       [B, 3]  int64 channel permutation.
    """

    zoom: torch.Tensor
    crop_opt: torch.Tensor
    crop_u: torch.Tensor
    flip: torch.Tensor
    photo_gate: torch.Tensor
    photo_f: torch.Tensor
    perm: torch.Tensor


def sample_draws(gen: torch.Generator, batch: int, cfg: AugmentConfig, device) -> AugmentDraws:
    """Draw one batch's random numbers on ``device`` (the generator's)."""
    R, T = cfg.outer_rounds, cfg.trials
    u = lambda *s: torch.rand(s, generator=gen, device=device)
    perm = torch.argsort(u(batch, 3), dim=1)  # a uniform random permutation per image
    return AugmentDraws(u(batch, 4), u(batch, 2, R), u(batch, 2, 4, R, T), u(batch),
                        u(batch, 7), u(batch, 4), perm)


# ---------------------------------------------------------------------------
# color ops (torchvision's functional semantics on float [0, 1] RGB); images
# are [B, H, W, 3] and factors [B]
# ---------------------------------------------------------------------------

def _per_image(f):
    return f[:, None, None, None]


def _grayscale(img):
    # ITU-R 601 luma, like torchvision's rgb_to_grayscale
    return 0.299 * img[..., 0:1] + 0.587 * img[..., 1:2] + 0.114 * img[..., 2:3]


def _adjust_brightness(img, f):
    return torch.clamp(img * _per_image(f), 0.0, 1.0)


def _adjust_contrast(img, f):
    mean = _grayscale(img).mean(dim=(-3, -2, -1), keepdim=True)
    return torch.clamp((img - mean) * _per_image(f) + mean, 0.0, 1.0)


def _adjust_saturation(img, f):
    g = _grayscale(img)
    return torch.clamp((img - g) * _per_image(f) + g, 0.0, 1.0)


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.amax(dim=-1)
    mn = img.amin(dim=-1)
    d = mx - mn
    safe = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(
        mx == r,
        torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = torch.where(d > 0, h / 6.0, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)

    def pick(choices):
        return torch.gather(torch.stack(choices, dim=-1), -1, i[..., None])[..., 0]

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def _adjust_hue(img, delta):
    h, s, v = _rgb_to_hsv(img)
    h = torch.remainder(h + delta[:, None, None], 1.0)
    return torch.clamp(_hsv_to_rgb(h, s, v), 0.0, 1.0)


def _between(u, lo_hi):
    return u * (lo_hi[1] - lo_hi[0]) + lo_hi[0]


def photometric_distort(img, gate, factor, perm, cfg: AugmentConfig):
    """v2.RandomPhotometricDistort on ``[B,H,W,3]`` for given draws: each op
    applied where its gate is under ``photometric_prob``, contrast before or
    after saturation and hue, then the channel permutation."""
    p = cfg.photometric_prob
    on = lambda k: _per_image(gate[:, k] < p)
    fb, fc = _between(factor[:, 0], cfg.brightness), _between(factor[:, 1], cfg.contrast)
    fs, fh = _between(factor[:, 2], cfg.saturation), _between(factor[:, 3], cfg.hue)
    contrast_first = _per_image(gate[:, 5] < 0.5)

    img = torch.where(on(0), _adjust_brightness(img, fb), img)
    img = torch.where(contrast_first & on(1), _adjust_contrast(img, fc), img)
    img = torch.where(on(2), _adjust_saturation(img, fs), img)
    img = torch.where(on(3), _adjust_hue(img, fh), img)
    img = torch.where(~contrast_first & on(1), _adjust_contrast(img, fc), img)
    permuted = torch.gather(img, -1, perm[:, None, None, :].expand(img.shape))
    return torch.where(on(6), permuted, img)


# ---------------------------------------------------------------------------
# geometry: one window = zoom-out + IoU crop + resize
# ---------------------------------------------------------------------------

def _window_iou(wins, boxes):
    """IoU of xyxy windows ``[..., 1, 4]`` with boxes ``[..., G, 4]``."""
    lt = torch.maximum(wins[..., :2], boxes[..., :2])
    rb = torch.minimum(wins[..., 2:], boxes[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_w = (wins[..., 2] - wins[..., 0]) * (wins[..., 3] - wins[..., 1])
    area_b = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0)
    return inter / torch.clamp(area_w + area_b - inter, min=1e-7)


def _identity(size):
    zero = torch.zeros_like(size)
    return torch.stack([zero, zero, size, size], dim=-1)


def _first(ok, dim):
    """Mask of the first True along ``dim``."""
    return ok & (torch.cumsum(ok.to(torch.int32), dim=dim) == 1)


def select_iou_crop(size, boxes, valid, min_scale, options, opt_u, u, cfg: AugmentConfig):
    """The fixed-shape form of torchvision v2 RandomIoUCrop's loop, for given
    draws: ``opt_u`` ``[B,R]`` picks one sampler option per round (an option
    >= 1 is the "no crop" sentinel), ``u`` ``[B,4,R,T]`` gives each round's
    candidate windows.  A candidate must meet the aspect bound, hold at least
    one box centre, and reach the round's option in IoU over the
    centre-inside boxes; the first valid candidate of the first successful
    round wins, else the identity.  ``size`` is ``[B]`` (the canvas side);
    returns xyxy windows ``[B,4]`` in canvas pixels."""
    identity = _identity(size)
    if boxes.shape[1] == 0:
        return identity
    options = torch.as_tensor(options, dtype=torch.float32, device=boxes.device)
    n_opt = options.shape[0]
    opt = options[torch.clamp((opt_u * n_opt).to(torch.int64), max=n_opt - 1)]  # [B, R]

    s = size[:, None, None]
    w = _between(u[:, 0], (min_scale, cfg.max_scale)) * s
    h = _between(u[:, 1], (min_scale, cfg.max_scale)) * s
    aspect = w / h
    aspect_ok = (aspect >= cfg.min_aspect_ratio) & (aspect <= cfg.max_aspect_ratio)
    x0 = u[:, 2] * (s - w)
    y0 = u[:, 3] * (s - h)
    wins = torch.stack([x0, y0, x0 + w, y0 + h], dim=-1)  # [B, R, T, 4]

    centers = 0.5 * (boxes[..., :2] + boxes[..., 2:])  # [B, G, 2]
    cx, cy = centers[:, None, None, :, 0], centers[:, None, None, :, 1]
    inside = ((cx > wins[..., 0:1]) & (cx < wins[..., 2:3])
              & (cy > wins[..., 1:2]) & (cy < wins[..., 3:4])) & valid[:, None, None, :]
    center_ok = inside.any(dim=-1)

    ious = _window_iou(wins[..., None, :], boxes[:, None, None, :, :])  # [B, R, T, G]
    # the IoU requirement counts the centre-inside boxes only
    ious = torch.where(inside, ious, torch.full_like(ious, -1.0))
    iou_ok = ious.amax(dim=-1) >= opt[:, :, None]

    cand_ok = aspect_ok & iou_ok & center_ok  # [B, R, T]
    sentinel = opt >= 1.0
    round_ok = sentinel | cand_ok.any(dim=-1)

    round_win = (wins * _first(cand_ok, -1)[..., None]).sum(dim=2)
    round_win = torch.where(sentinel[..., None], identity[:, None, :], round_win)  # [B, R, 4]
    win = (round_win * _first(round_ok, 1)[..., None]).sum(dim=1)
    return torch.where(round_ok.any(dim=1)[:, None], win, identity)


def select_windows(size: float, boxes, valid, draws: AugmentDraws, cfg: AugmentConfig):
    """The source window of every image, ``[B,4]`` xyxy in source pixels:
    optional zoom-out composed with the ConditionalIoUCrop.  Zoom-out places
    the image at an offset inside a larger zero-filled canvas; the crop is
    sampled on that canvas (its scale bounds, IoUs and the area-fraction
    policy choice are relative to it) and mapped back by the offset."""
    z = draws.zoom
    size_t = torch.full_like(z[:, 0], float(size))
    do_zoom = (z[:, 0] < cfg.zoom_out_prob) & (cfg.zoom_out_prob > 0)
    big = size_t * _between(z[:, 1], (1.0, cfg.zoom_out_max))
    zero = torch.zeros_like(size_t)
    canvas = torch.where(do_zoom, big, size_t)
    ox = torch.where(do_zoom, z[:, 2] * (big - size_t), zero)
    oy = torch.where(do_zoom, z[:, 3] * (big - size_t), zero)
    offset = torch.stack([ox, oy, ox, oy], dim=-1)
    cboxes = boxes + offset[:, None, :]

    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0)
    area_frac = torch.where(valid, area / (canvas * canvas)[:, None], torch.zeros_like(area))
    has_large = (area_frac >= cfg.min_area_frac).any(dim=1)

    crops = [select_iou_crop(canvas, cboxes, valid, scale, options, draws.crop_opt[:, k],
                             draws.crop_u[:, k], cfg)
             for k, (scale, options) in enumerate(
                 ((cfg.small_min_scale, cfg.small_sampler_options),
                  (cfg.large_min_scale, cfg.large_sampler_options)))]
    win = torch.where(has_large[:, None], crops[1], crops[0])
    win = torch.where(valid.any(dim=1)[:, None], win, _identity(canvas))  # no boxes: no crop
    return win - offset


def transform_boxes(boxes, valid, win, cfg: AugmentConfig, out_size: int):
    """Boxes into the window's output pixels, clamped; a box stays valid if
    its centre lies inside the window and it keeps ``min_box_size`` pixels
    (SanitizeBoundingBoxes and the IoU crop's centre rule)."""
    ww, wh = win[:, 2] - win[:, 0], win[:, 3] - win[:, 1]
    centers = 0.5 * (boxes[..., :2] + boxes[..., 2:])
    center_in = ((centers[..., 0] > win[:, None, 0]) & (centers[..., 0] < win[:, None, 2])
                 & (centers[..., 1] > win[:, None, 1]) & (centers[..., 1] < win[:, None, 3]))
    shift = torch.cat([win[:, :2], win[:, :2]], dim=-1)[:, None, :]
    scale = torch.stack([ww, wh, ww, wh], dim=-1)[:, None, :]
    out = torch.clamp((boxes - shift) / scale * out_size, 0.0, float(out_size))
    bw, bh = out[..., 2] - out[..., 0], out[..., 3] - out[..., 1]
    return out, valid & center_in & (bw >= cfg.min_box_size) & (bh >= cfg.min_box_size)


def _axis_weights(lo, extent, in_size: int, out_size: int):
    """Triangle-kernel resampling weights ``[B, out, in]`` that map the source
    interval ``[lo, lo + extent)`` of every image to ``out_size`` samples:
    the kernel is widened by the downscaling factor (antialiasing), each
    output's weights sum to 1, and an output whose centre falls outside the
    source gets zeros."""
    # scale, translation and the sample positions in the JAX package's order
    # of operations, so that the two agree to the last float32 bits
    scale = out_size / extent
    inv_scale = 1.0 / scale  # source pixels per output pixel, [B]
    translation = -lo * out_size / extent
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    j = torch.arange(out_size, dtype=lo.dtype, device=lo.device)
    i = torch.arange(in_size, dtype=lo.dtype, device=lo.device)
    sample = ((j + 0.5) * inv_scale[:, None] - (translation * inv_scale)[:, None]
              - 0.5)                                                      # [B, out]
    x = (sample[:, :, None] - i).abs() / kernel_scale[:, None, None]
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=2, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def resample(img, win, out_size: int):
    """``[B,S,S,3]`` float images -> ``[B,out,out,3]``: each image's xyxy
    source window ``win`` ``[B,4]`` (or ``[1,4]`` for all) resampled once,
    antialiased; source area outside the image resolves to 0."""
    H, W = img.shape[1], img.shape[2]
    wy = _axis_weights(win[:, 1], win[:, 3] - win[:, 1], H, out_size)
    wx = _axis_weights(win[:, 0], win[:, 2] - win[:, 0], W, out_size)
    rows = torch.matmul(wy, img.reshape(img.shape[0], H, W * 3))          # [B, out, W*3]
    rows = rows.reshape(-1, out_size, W, 3)
    return torch.einsum("bpw,bowc->bopc", wx.expand(rows.shape[0], -1, -1), rows)


def hflip(img, boxes, do_flip, out_size: int):
    """Flip the images and their output-pixel boxes where ``do_flip``."""
    flipped = torch.stack([out_size - boxes[..., 2], boxes[..., 1],
                           out_size - boxes[..., 0], boxes[..., 3]], dim=-1)
    return (torch.where(_per_image(do_flip), img.flip(2), img),
            torch.where(do_flip[:, None, None], flipped, boxes))


def normalize(img):
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def augment_core(images_u8, boxes, labels, valid, draws: AugmentDraws,
                 cfg: AugmentConfig = AugmentConfig(), out_size: int = IMAGE_SIZE):
    """The deterministic part of :func:`augment_batch`: the same batch and
    the same draws give the same output."""
    size = images_u8.shape[1]
    img = images_u8.to(torch.float32) / 255.0
    boxes = boxes.to(torch.float32)
    win = select_windows(size, boxes, valid, draws, cfg)
    out_boxes, valid = transform_boxes(boxes, valid, win, cfg, out_size)
    img = torch.clamp(resample(img, win, out_size), 0.0, 1.0)
    img, out_boxes = hflip(img, out_boxes, draws.flip < cfg.hflip_prob, out_size)
    img = photometric_distort(img, draws.photo_gate, draws.photo_f, draws.perm, cfg)
    return normalize(img), out_boxes / out_size, labels, valid


def augment_batch(gen: torch.Generator, images_u8, boxes, labels, valid,
                  cfg: AugmentConfig = AugmentConfig(), out_size: int = IMAGE_SIZE):
    """Batched training augmentation on the device of ``images_u8``.

    images_u8 ``[B,S,S,3]`` uint8; boxes ``[B,G,4]`` xyxy in source pixels;
    labels ``[B,G]``; valid ``[B,G]`` bool.  ``gen`` is a generator of that
    device.  Returns ``(images [B,out,out,3] normalized float32, boxes in
    [0, 1], labels, valid)``.
    """
    draws = sample_draws(gen, images_u8.shape[0], cfg, images_u8.device)
    return augment_core(images_u8, boxes, labels, valid, draws, cfg, out_size)


def preprocess_batch(images_u8, boxes, out_size: int = IMAGE_SIZE):
    """Eval and serving preprocessing: one antialiased resize to
    ``out_size`` and the ImageNet normalization; boxes go to [0, 1]."""
    size = images_u8.shape[1]
    img = images_u8.to(torch.float32) / 255.0
    win = torch.tensor([[0.0, 0.0, float(images_u8.shape[2]), float(size)]], device=img.device)
    img = torch.clamp(resample(img, win, out_size), 0.0, 1.0)
    return normalize(img), boxes / size
