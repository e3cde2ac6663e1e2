"""NVIDIA's SSD300 v1.1: a ResNet-50 trunk, five extra blocks, 81-class heads.

The second detector architecture of the port (``Detector(...,
architecture="resnet50")``), from NVIDIA DeepLearningExamples,
``PyTorch/Detection/SSD/ssd/model.py`` (``ResNet``, ``SSD300``); the SSD
design is arXiv:1512.02325.  Public layout as :mod:`ssdx_torch.model`:
``forward(x [B,300,300,3])`` returns ``(loc [B,8732,4], cls [B,8732,C])``
in float32; inside, channels-last NCHW tensors in ``dtype``, BatchNorm in
float32, convs without bias (``fold_bn=True`` gives every conv the bias of
its folded BatchNorm).

  trunk   conv1 7x7/2 64, BN, ReLU, maxpool 3x3/2 p1          300 -> 150 -> 75
          layer1 3 x bottleneck 64-64-256                      75
          layer2 4 x bottleneck 128-128-512, first stride 2    38
          layer3 6 x bottleneck 256-256-1024, stride 1         38 -> tap 38x38x1024
  extras  5 x [1x1 (no bias) + BN + ReLU, 3x3 (no bias) + BN + ReLU]:
          mid 256/256/128/128/128, out 512/512/256/256/256; the first three
          3x3 at stride 2 pad 1, the last two pad 0    -> taps 19/10/5/3/1
  heads   per tap one fused 3x3 conv (bias) of [k*4 box | k*C cls] channels,
          flattened in (H, W, k) order as the priors of
          :func:`ssdx_torch.priors.create_priors_coco`
          (:class:`ssdx_torch.model.Heads`, VGG16's too)

A bottleneck (torchvision v1.5, the stride on its 3x3) computes
``relu(branch(x) + shortcut(x))`` with ``branch = bn3(conv3(relu(bn2(conv2(
relu(bn1(conv1(x))))))))`` and ``shortcut`` the BN'd 1x1 ``downsample`` in
a stage's first block, ``x`` otherwise.  The trunk, the extras and the heads
are submodules called in turn, each inside a span
(``ssdx_torch.model.trunk`` / ``.extras`` / ``.heads``).

Weights are a ``{'params', 'batch_stats'}`` tree keyed by each conv's module
path (``trunk.layer3.0.downsample``, ``extras.2.1``, ``box_head_0``, ...):
``Conv_0/kernel`` HWIO (and ``Conv_0/bias`` once folded), ``BatchNorm_0/
{scale, bias}`` and ``batch_stats/<path>/BatchNorm_0/{mean, var}``, the
layout :func:`ssdx_torch.export.fold_batchnorm` folds and
:func:`ssdx_torch.weights.state_dict_from_jax` loads.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .model import Heads, _width
from .priors import BOXES_PER_LOCATION, create_priors_coco
from .utils.profiling import span

__all__ = ["SSD300ResNet50", "TRUNK_STAGES", "EXTRAS", "init_variables", "conv_paths"]

# (blocks, mid width, out width, first stride) of layer1..layer3; layer3's
# first block keeps stride 1, so the first tap is 38x38.
TRUNK_STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 1))
STEM_WIDTH = 64
# (mid, out, stride, padding) of the five extra blocks' 3x3 convs.
EXTRAS = ((256, 512, 2, 1), (256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
          (128, 256, 1, 0))
BN_EPS = 1e-5


class ConvBN(nn.Module):
    """A conv without bias and its BatchNorm (eval mode, float32), or with
    ``fold_bn`` the folded conv with a bias.  No ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, fold_bn=False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=fold_bn)
        self.bn = None if fold_bn else nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        b = None if c.bias is None else c.bias.to(x.dtype)
        y = F.conv2d(x, c.weight.to(x.dtype), b, c.stride, c.padding)
        if self.bn is not None:
            bn = self.bn
            y = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, 0.0, bn.eps).to(x.dtype)
        return y


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, cout, stride, fold_bn, downsample):
        super().__init__()
        self.conv1 = ConvBN(cin, mid, 1, fold_bn=fold_bn)
        self.conv2 = ConvBN(mid, mid, 3, stride, 1, fold_bn=fold_bn)
        self.conv3 = ConvBN(mid, cout, 1, fold_bn=fold_bn)
        self.downsample = ConvBN(cin, cout, 1, stride, fold_bn=fold_bn) if downsample else None

    def branch(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x if self.downsample is None else self.downsample(x)
        return F.relu(self.branch(x) + s)


class Trunk(nn.Module):
    """ResNet-50 up to layer3: [B,3,300,300] -> the 38x38 tap."""

    def __init__(self, width_mult: float, fold_bn: bool):
        super().__init__()
        w = lambda f: _width(f, width_mult)
        self.conv1 = ConvBN(3, w(STEM_WIDTH), 7, 2, 3, fold_bn=fold_bn)
        cin = w(STEM_WIDTH)
        layers = []
        for n, mid, cout, stride in TRUNK_STAGES:
            blocks = []
            for i in range(n):
                blocks.append(Bottleneck(cin, w(mid), w(cout), stride if i == 0 else 1,
                                         fold_bn, downsample=i == 0))
                cin = w(cout)
            layers.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3 = layers
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)
        return self.layer3(self.layer2(self.layer1(x)))


class Extras(nn.ModuleList):
    """The five extra blocks (``extras.i.0``, the 1x1, and ``extras.i.1``,
    the 3x3): the 38x38 tap -> [tap, 19, 10, 5, 3, 1]."""

    def __init__(self, cin: int, width_mult: float, fold_bn: bool):
        blocks = []
        for mid, cout, stride, pad in EXTRAS:
            mid, cout = _width(mid, width_mult), _width(cout, width_mult)
            blocks.append(nn.ModuleList([ConvBN(cin, mid, 1, fold_bn=fold_bn),
                                         ConvBN(mid, cout, 3, stride, pad, fold_bn=fold_bn)]))
            cin = cout
        super().__init__(blocks)
        self.channels = [b[1].conv.out_channels for b in blocks]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = [x]
        for a, b in self:
            x = F.relu(b(F.relu(a(x))))
            taps.append(x)
        return taps


def conv_paths(width_mult: float = 1.0,
               num_classes: int = 81) -> list[tuple[str, int, int, int, bool]]:
    """(tree key, cin, cout, kernel, batchnorm) of every conv, in forward
    order: the trunk's (downsample convs included), the extras', then
    ``box_head_i`` / ``cls_head_i`` (with bias, no BatchNorm)."""
    m = SSD300ResNet50(num_classes, width_mult=width_mult)
    out = []
    for name, mod in m.named_modules():
        if isinstance(mod, ConvBN):
            c = mod.conv
            out.append((name, c.in_channels, c.out_channels, c.kernel_size[0], True))
    for i, (head, k) in enumerate(zip(m.heads, BOXES_PER_LOCATION)):
        out.append((f"box_head_{i}", head.in_channels, k * 4, 3, False))
        out.append((f"cls_head_{i}", head.in_channels, k * num_classes, 3, False))
    return out


def init_variables(num_classes: int, seed: int = 0, width_mult: float = 1.0) -> dict:
    """Random weights with NVIDIA's initialisers, drawn from numpy: the
    trunk's convs Kaiming-normal (fan-out, ReLU gain; torchvision's
    ``ResNet``), the extras' and heads' weights Xavier-uniform
    (``SSD300._init_weights``), the heads' biases PyTorch's default
    U(+-1/sqrt(fan-in)); BatchNorm at identity (scale 1, bias 0, mean 0,
    var 1)."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, cin, cout, k, bn in conv_paths(width_mult, num_classes):
        if name.startswith("trunk."):
            w = rng.standard_normal((k, k, cin, cout)) * math.sqrt(2.0 / (cout * k * k))
        else:
            a = math.sqrt(6.0 / (cin * k * k + cout * k * k))
            w = rng.uniform(-a, a, (k, k, cin, cout))
        conv = {"kernel": w.astype(np.float32)}
        if not bn:
            b = 1.0 / math.sqrt(cin * k * k)
            conv["bias"] = rng.uniform(-b, b, cout).astype(np.float32)
            params[name] = conv
            continue
        params[name] = {"Conv_0": conv,
                        "BatchNorm_0": {"scale": np.ones(cout, np.float32),
                                        "bias": np.zeros(cout, np.float32)}}
        stats[name] = {"BatchNorm_0": {"mean": np.zeros(cout, np.float32),
                                       "var": np.ones(cout, np.float32)}}
    return {"params": params, "batch_stats": stats}


class SSD300ResNet50(nn.Module):
    """NVIDIA's SSD300 v1.1 for inference (BatchNorm on running statistics).

    ``fold_bn=True`` builds the BN-free serving variant whose weights come
    from :func:`ssdx_torch.export.fold_batchnorm`; ``width_mult`` thins
    every width (rounded to a multiple of 8, at least 8) for tests.
    Folded, the network holds conv weights and biases alone, and holds them
    in ``dtype``, the dtype the convs read, so no forward casts them again;
    loading float32 weights into it rounds them as ``.to(dtype)`` does.

    What ``Detector`` reads of the class: ``init_variables`` (a random
    tree), ``create_priors`` (NVIDIA's default boxes) and ``nms_kind`` (the
    IoU-NMS of NVIDIA's postprocess).
    """

    init_variables = staticmethod(init_variables)
    create_priors = staticmethod(create_priors_coco)
    nms_kind = "iou"

    def __init__(self, num_classes: int, fold_bn: bool = False, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.fold_bn = fold_bn
        self.width_mult = width_mult
        self.dtype = dtype
        self.trunk = Trunk(width_mult, fold_bn)
        self.extras = Extras(self.trunk.out_channels, width_mult, fold_bn)
        self.heads = Heads([self.trunk.out_channels] + self.extras.channels, num_classes)
        if fold_bn:
            self.to(dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        with span("ssdx_torch.model.trunk"):
            x = self.trunk(x)
        with span("ssdx_torch.model.extras"):
            taps = self.extras(x)
        with span("ssdx_torch.model.heads"):
            return self.heads(taps)
