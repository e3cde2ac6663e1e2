"""SSD300 detector network: VGG16+BN backbone, extra layers, multibox heads.

Torch counterpart of ``ssdx/model.py``.  Public layout is the JAX package's
NHWC: ``forward(x [B,300,300,3])`` returns ``(loc [B,8732,4], cls
[B,8732,C])`` in float32.  Inside, the convs run as NCHW-indexed tensors
whose memory is channels-last (an NHWC input permuted to NCHW is exactly
that), which is cuDNN's fast layout for bf16.

Numerics: float32 parameters; activations and convs in ``dtype``
(bfloat16 on the GPU); BatchNorm in float32; heads returned in float32.
``forward(x, train=True)`` is the training mode (batch-statistics BN, as
flax's ``use_running_average=False`` with momentum 0.9 and eps 1e-5).

  conv1(2x64) mp conv2(2x128) mp conv3(3x256) mp[ceil] conv4(3x512) -> tap 38x38x512
  mp conv5(3x512) conv6(3x3 d6 1024) conv7(1x1 1024)               -> tap 19x19x1024
  conv8_2 (1x1 256, 3x3 s2 512)                                    -> tap 10x10x512
  conv9_2 (1x1 128, 3x3 s2 256)                                    -> tap 5x5x256
  conv10_2(1x1 128, 3x3 v 256; no BN on 3x3)                       -> tap 3x3x256
  conv11_2(1x1 128, 3x3 v 256; no BN at all)                       -> tap 1x1x256

Each tap runs ONE fused head conv whose output channels are
``[k*4 box | k*C cls]``; it is flattened in (H, W, k) order to match the
prior order of ``ssdx_torch/priors.py``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .mesh import all_reduce_sum
from .priors import BOXES_PER_LOCATION, NUM_PRIORS, create_priors

__all__ = ["SSD300", "Heads", "multibox", "IMAGE_SIZE", "BACKBONE", "init_variables", "update_running_stats"]

IMAGE_SIZE = 300

# The 23 backbone convs in order: (cout, kernel, stride, padding, dilation, bn).
BACKBONE = (
    (64, 3, 1, 1, 1, True), (64, 3, 1, 1, 1, True),                            # conv1
    (128, 3, 1, 1, 1, True), (128, 3, 1, 1, 1, True),                          # conv2
    (256, 3, 1, 1, 1, True), (256, 3, 1, 1, 1, True), (256, 3, 1, 1, 1, True),  # conv3
    (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True),  # conv4
    (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True), (512, 3, 1, 1, 1, True),  # conv5
    (1024, 3, 1, 6, 6, True),                                                  # conv6
    (1024, 1, 1, 0, 1, True),                                                  # conv7
    (256, 1, 1, 0, 1, True), (512, 3, 2, 1, 1, True),                          # conv8
    (128, 1, 1, 0, 1, True), (256, 3, 2, 1, 1, True),                          # conv9
    (128, 1, 1, 0, 1, True), (256, 3, 1, 0, 1, False),                         # conv10
    (128, 1, 1, 0, 1, False), (256, 3, 1, 0, 1, False),                        # conv11
)
# 2x2/2 max pool after these layers (True = ceil mode: 75 -> 38); the pool
# after layer 9 follows the conv4_3 tap.
_POOL_AFTER = {1: False, 3: False, 6: True, 9: False}
_TAPS = (9, 14, 16, 18, 20, 22)
_STEM_LAYERS = 2  # conv1_1, conv1_2: the fused stem kernel's part


def _width(f: int, width_mult: float) -> int:
    return max(8, int(f * width_mult) // 8 * 8)


def backbone_channels(width_mult: float = 1.0) -> list[tuple[int, int]]:
    """(cin, cout) of each backbone conv."""
    out, cin = [], 3
    for cout, *_ in BACKBONE:
        cout = _width(cout, width_mult)
        out.append((cin, cout))
        cin = cout
    return out


BN_MOMENTUM = 0.9  # flax convention: running = 0.9 * running + 0.1 * batch


def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """flax's running-average update with the batch's biased ``var``."""
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)


class ConvBNRelu(nn.Module):
    """Conv (+ BatchNorm) + ReLU; BN statistics kept in float32.

    ``train=True`` normalises with the batch mean and the biased batch
    variance, one-pass ``E[y^2] - E[y]^2`` clamped at 0 in float32, as flax
    does, and updates the running statistics from them under ``no_grad``.
    (``F.batch_norm(training=True)`` would store the unbiased variance.)
    Under a ``mesh`` the two per-channel sums are all-reduced before the
    mean and variance are formed and the count is the global batch's, so
    the statistics, and through the differentiable all-reduce the
    gradient, are those of the whole batch (sync-BN).
    """

    def __init__(self, cin, cout, kernel, stride, padding, dilation, use_bn):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, dilation)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5) if use_bn else None

    def forward(self, x: torch.Tensor, train: bool = False, mesh=None) -> torch.Tensor:
        c = self.conv
        y = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride,
                     c.padding, c.dilation)
        bn = self.bn
        if bn is not None and train:
            yf = y.float()
            n = yf.numel() // yf.shape[1] * (1 if mesh is None else mesh.size)
            s1, s2 = yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))
            if mesh is not None:  # one all-reduce for both sums
                s1, s2 = all_reduce_sum(torch.stack([s1, s2]), mesh)
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            update_running_stats(bn, mean.detach(), var.detach())
            mul = torch.rsqrt(var + bn.eps) * bn.weight
            y = ((yf - mean[:, None, None]) * mul[:, None, None]
                 + bn.bias[:, None, None]).to(x.dtype)
        elif bn is not None:
            y = F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, bn.eps).to(x.dtype)
        return F.relu(y)


class Heads(nn.ModuleList):
    """The multibox heads of either network: one fused 3x3 conv per tap
    (``heads.i``) whose output channels are ``[k*4 box | k*C cls]``.
    ``forward(taps)`` takes the NCHW taps and returns (loc [B,P,4], cls
    [B,P,C]) in float32 (:func:`multibox`)."""

    def __init__(self, tap_channels, num_classes: int):
        super().__init__(nn.Conv2d(c, k * (4 + num_classes), 3, padding=1)
                         for c, k in zip(tap_channels, BOXES_PER_LOCATION))
        self.num_classes = num_classes

    def forward(self, taps: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        return multibox(taps, [(h.weight, h.bias) for h in self], self.num_classes)


def multibox(taps, convs, num_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused head convs (``convs``: (weight, bias) per tap, cast to the
    tap's dtype) on the NCHW ``taps``, flattened in (H, W, k) order to match
    the priors: (loc [B,P,4], cls [B,P,C]) in float32."""
    B, C = taps[0].shape[0], num_classes
    locs, clss = [], []
    for t, k, (w, b) in zip(taps, BOXES_PER_LOCATION, convs):
        y = F.conv2d(t, w.to(t.dtype), b.to(t.dtype), padding=1)
        y = y.permute(0, 2, 3, 1)  # (H, W, k) order, as the priors
        locs.append(y[..., : k * 4].reshape(B, -1, 4))
        clss.append(y[..., k * 4 :].reshape(B, -1, C))
    loc = torch.cat(locs, dim=1).float()
    cls = torch.cat(clss, dim=1).float()
    assert loc.shape[1] == NUM_PRIORS, loc.shape
    return loc, cls


def init_variables(num_classes: int, seed: int = 0, width_mult: float = 1.0) -> dict:
    """Random ``{'params', 'batch_stats'}`` tree in the JAX package's layout.

    Kernels are truncated normal (+-2 sigma) with variance 2/fan_out, biases
    zero, BN at identity (scale 1, bias 0, mean 0, var 1) — the same
    distributions as the JAX package's initializers, drawn from numpy.
    """
    rng = np.random.default_rng(seed)

    def kernel(k, cin, cout):
        std = np.sqrt(2.0 / (k * k * cout)) / 0.87962566103423978
        z = rng.standard_normal((k, k, cin, cout))
        while (bad := np.abs(z) > 2.0).any():
            z[bad] = rng.standard_normal(int(bad.sum()))
        return (z * std).astype(np.float32)

    params: dict = {}
    stats: dict = {}
    chans = backbone_channels(width_mult)
    for i, ((cin, cout), (_, k, *_, bn)) in enumerate(zip(chans, BACKBONE)):
        mod = {"Conv_0": {"kernel": kernel(k, cin, cout),
                          "bias": np.zeros(cout, np.float32)}}
        if bn:
            mod["BatchNorm_0"] = {"scale": np.ones(cout, np.float32),
                                  "bias": np.zeros(cout, np.float32)}
            stats[f"ConvBNRelu_{i}"] = {"BatchNorm_0": {
                "mean": np.zeros(cout, np.float32), "var": np.ones(cout, np.float32)}}
        params[f"ConvBNRelu_{i}"] = mod
    for i, (t, k) in enumerate(zip(_TAPS, BOXES_PER_LOCATION)):
        cin = chans[t][1]
        for name, f in (("box", k * 4), ("cls", k * num_classes)):
            params[f"{name}_head_{i}"] = {"kernel": kernel(3, cin, f),
                                         "bias": np.zeros(f, np.float32)}
    return {"params": params, "batch_stats": stats}


class SSD300(nn.Module):
    """SSD300 with a VGG16+BN backbone.

    ``fold_bn=True`` builds the BN-free serving variant whose weights come
    from :func:`ssdx_torch.export.fold_batchnorm`.  ``stem_input=True``
    makes ``forward`` take the post-stem map ``[B,150,150,64]`` (computed by
    :func:`ssdx_torch.ops.stem.stem_conv_pool`) and skip conv1_1, conv1_2
    and the first pool; their weights stay in the module, which the stem
    kernel reads.  ``width_mult`` scales every backbone channel count
    (rounded to a multiple of 8, at least 8) for fast tests; the reference
    architecture is ``width_mult=1.0``.

    What ``Detector`` reads of the class: ``init_variables`` (a random
    tree), ``create_priors`` and ``nms_kind`` (DIoU, the JAX package's
    postprocess).  Its weights stay float32 in every dtype: the stem kernel
    reads conv1_2's bias in float32.
    """

    init_variables = staticmethod(init_variables)
    create_priors = staticmethod(create_priors)
    nms_kind = "diou"

    def __init__(self, num_classes: int, fold_bn: bool = False,
                 stem_input: bool = False, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.fold_bn = fold_bn
        self.stem_input = stem_input
        self.width_mult = width_mult
        self.dtype = dtype
        chans = backbone_channels(width_mult)
        self.layers = nn.ModuleList(
            ConvBNRelu(cin, cout, k, s, p, d, bn and not fold_bn)
            for (cin, cout), (_, k, s, p, d, bn) in zip(chans, BACKBONE)
        )
        self.heads = Heads([chans[t][1] for t in _TAPS], num_classes)

    def forward(self, x: torch.Tensor, train: bool = False, stem_input: bool | None = None,
                mesh=None):
        """``train=True`` runs BatchNorm on batch statistics and updates the
        running ones; with a ``mesh`` (:mod:`ssdx_torch.mesh`) ``x`` is this
        rank's shard and the statistics are the global batch's.
        ``stem_input`` overrides the module's own setting for this call: the
        train step's fused route hands the pooled stem map of
        :func:`ssdx_torch.ops.stem_train.stem_train` to the full model."""
        if stem_input is None:
            stem_input = self.stem_input
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        taps = []
        for i in range(_STEM_LAYERS if stem_input else 0, len(self.layers)):
            x = self.layers[i](x, train, mesh)
            if i in _TAPS:
                taps.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 2, 2, ceil_mode=_POOL_AFTER[i])
        return self.heads(taps)
