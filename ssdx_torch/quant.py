"""Int8 post-training quantization of the serving path.

Torch counterpart of ``ssdx/quant.py``, with the same scheme and scope:

* **Scheme**: symmetric int8 (-127..127) with per-input-channel activation
  scales folded into the weights.  Each layer calibrates
  ``a[c] = amax|x[..., c]|`` and quantizes its input as
  ``x_q[c] = round(x[c] / s_x[c])``, ``s_x[c] = a[c] / 127``.  The channel
  scale cannot ride through the contraction, so it is folded into the
  conv's weights before they are quantized:
  ``Wf[cout, cin] = W * s_x[cin]``, then per-output-channel weight scales
  ``s_w[cout] = amax|Wf[cout]| / 127``.  The int8 conv then yields
  ``y = (x_q (*) W_q) * s_w[cout] + bias``: an int8 x int8 -> int32
  contraction and one elementwise epilogue (dequantize, bias, ReLU,
  requantize to the next layer's scales), so activations between layers are
  int8.
* **Scope**: the post-stem backbone, ``ConvBNRelu_2..22`` (``_TOPOLOGY``).
  The stem stays in bf16 (``ssdx_torch/ops/stem.py`` on the GPU, or
  :func:`stem_bf16`), and so do the multibox heads.  Max pools run on the
  int8 tensor (max commutes with a positive scale).
* **Inputs**: BN-folded parameters (``ssdx_torch/export.fold_batchnorm``) as
  the JAX-layout numpy tree that ``Detector.variables["params"]`` holds.

:func:`apply_int8` is the plain walk of the quantized network in PyTorch
ops.  It is the CPU path and the oracle of the hand-written int8 kernels
(``ssdx_torch/ops/int8_conv.py``), which serve the same network on the GPU.
It requantizes by dividing by the scale, as the JAX function does; the
kernels and their plain version multiply by the reciprocal, which can
differ by one int8 step on a rounding boundary.

Layouts: activations are NHWC at every public function.  A
:class:`QuantLayer` keeps ``kernel_q`` as an int8 tensor of logical shape
OIHW ``[cout, cin, kh, kw]`` in channels-last memory, that is
``[cout][kh][kw][cin]`` with the contraction axis contiguous: the shape
``F.conv2d`` takes and the memory order the kernels read.  The heads are
kept fused, one ``[k*(4+C), cin, 3, 3]`` float32 conv per tap with the box
channels first, as ``ssdx_torch/model.py`` keeps them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import _POOL_AFTER, _STEM_LAYERS, _TAPS, BACKBONE, multibox
from .weights import _fused_heads, _oihw, _t

__all__ = [
    "QuantLayer",
    "QuantizedSSD",
    "calibrate_act_scales",
    "quantize_ssd",
    "apply_int8",
    "stem_bf16",
    "detection_agreement",
]

_I8_MIN, _I8_MAX = -127, 127  # symmetric: keep -128 unused


class _L(NamedTuple):
    name: str
    kernel: int  # 1 or 3
    stride: int
    pad: int
    dilation: int
    tap: int | None  # tap index (taken after ReLU, before any pool)
    pool: str | None  # None | "std" | "ceil" (applied after the tap)


def _topology() -> tuple[_L, ...]:
    """The 21 post-stem layers, derived from the model's own tables."""
    out = []
    for i in range(_STEM_LAYERS, len(BACKBONE)):
        _, k, stride, pad, dilation, _ = BACKBONE[i]
        pool = None if i not in _POOL_AFTER else ("ceil" if _POOL_AFTER[i] else "std")
        tap = _TAPS.index(i) if i in _TAPS else None
        out.append(_L(f"ConvBNRelu_{i}", k, stride, pad, dilation, tap, pool))
    return tuple(out)


# Post-stem topology of SSD300 (ssdx_torch/model.py BACKBONE); input [B,150,150,64].
_TOPOLOGY: tuple[_L, ...] = _topology()


class QuantLayer(NamedTuple):
    kernel_q: torch.Tensor  # [cout, cin, kh, kw] int8, channels-last memory
    bias: torch.Tensor  # [cout] float32
    in_scale: torch.Tensor  # [cin] float32: per-channel scale of the int8 input
    w_scale: torch.Tensor  # [cout] float32: scale of the folded weight


class QuantizedSSD(NamedTuple):
    """The quantized serving network (post-stem), tensors on one device."""

    layers: dict  # name -> QuantLayer (int8 backbone)
    heads: list  # per tap: {"weight" [k*(4+C),cin,3,3], "bias"} float32
    num_classes: int


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _max_pool(x: torch.Tensor, ceil: bool) -> torch.Tensor:
    """2x2/2 max pool of an NHWC tensor of any dtype, int8 included.

    ``ceil`` pads bottom and right with the dtype's minimum (-128 for int8),
    so odd extents round up; otherwise the odd row and column are dropped.
    Written as the maximum of the four strided slices, which every dtype
    has on both devices (``F.max_pool2d`` has no integer kernel on CUDA, and
    on the CPU it refuses an int8 map of more than 127 elements).
    """
    B, H, W, C = x.shape
    if ceil and (H % 2 or W % 2):
        lo = torch.iinfo(x.dtype).min if not x.dtype.is_floating_point else -torch.inf
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2), value=lo)
    H2, W2 = x.shape[1] // 2, x.shape[2] // 2
    x = x[:, : 2 * H2, : 2 * W2]
    top = torch.maximum(x[:, 0::2, 0::2], x[:, 0::2, 1::2])
    bot = torch.maximum(x[:, 1::2, 0::2], x[:, 1::2, 1::2])
    return torch.maximum(top, bot)


def _conv(x, weight, bias, spec: _L, dtype):
    """NHWC conv + bias in ``dtype`` (weight float32 OIHW, cast here)."""
    b = None if bias is None else bias.to(dtype)
    y = F.conv2d(_nchw(x), weight.to(dtype), b, spec.stride, spec.pad, spec.dilation)
    return _nhwc(y)


# ------------------------------------------------------------------ bf16 stem


def stem_bf16(params: dict, images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain stem on BN-folded params: conv1_1 + ReLU, conv1_2 + ReLU, 2x2
    max pool; ``[B,300,300,3]`` -> ``[B,150,150,64]`` in ``dtype`` on the
    images' device.  The GPU serving path runs the fused stem kernel
    instead (``ssdx_torch/ops/stem.py``)."""
    dev = images.device
    x = images.to(dtype)
    spec = _L("stem", 3, 1, 1, 1, None, None)
    for name in ("ConvBNRelu_0", "ConvBNRelu_1"):
        c = params[name]["Conv_0"]
        x = F.relu(_conv(x, _oihw(c["kernel"], dev), _t(c["bias"], dev), spec, dtype))
    return _max_pool(x, ceil=False)


# ----------------------------------------------------------------- calibration


@torch.inference_mode()
def calibrate_act_scales(params: dict, feats: torch.Tensor, dtype=torch.bfloat16) -> dict:
    """One calibration pass: run the post-stem backbone in ``dtype`` on
    ``feats`` ``[B,150,150,64]`` and return ``{layer_name: amax [cin]}`` of
    each conv's input (numpy float32).  Call per batch and fold with
    ``np.maximum`` for multi-batch calibration.

    The amax is not bitwise portable between frameworks in bf16: cuDNN,
    PyTorch's CPU kernels and XLA accumulate in different orders, so the
    last bf16 digit can differ."""
    dev = feats.device
    amaxes = {}
    x = feats.to(dtype)
    for spec in _TOPOLOGY:
        amaxes[spec.name] = x.abs().amax(dim=(0, 1, 2)).float().cpu().numpy()
        c = params[spec.name]["Conv_0"]
        x = F.relu(_conv(x, _oihw(c["kernel"], dev), _t(c["bias"], dev), spec, dtype))
        if spec.pool:
            x = _max_pool(x, ceil=spec.pool == "ceil")
    return amaxes


def quantize_ssd(params: dict, act_scales: dict, num_classes: int,
                 device="cpu") -> QuantizedSSD:
    """Quantize BN-folded SSD300 params to the int8 serving form.

    ``params``: the JAX-layout numpy tree of folded parameters.
    ``act_scales``: per-layer per-channel input amax ``[cin]`` from
    :func:`calibrate_act_scales` (possibly ``np.maximum``-ed over several
    batches).  Each layer's activation scale is folded into its kernel
    before weight quantization (module docstring, "Scheme").  The arithmetic
    runs in float32 on the CPU, operation by operation as the JAX function,
    and the result is moved to ``device``.
    """
    dev = torch.device(device)
    layers = {}
    for spec in _TOPOLOGY:
        c = params[spec.name]["Conv_0"]
        w = _oihw(c["kernel"])
        in_scale = torch.clamp(_t(act_scales[spec.name]), min=1e-12) / _I8_MAX
        wf = w * in_scale[None, :, None, None]  # fold act scales into weights
        w_amax = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-30)
        w_scale = w_amax / _I8_MAX
        kernel_q = torch.clamp(torch.round(wf / w_scale[:, None, None, None]),
                               _I8_MIN, _I8_MAX).to(torch.int8)
        layers[spec.name] = QuantLayer(
            kernel_q=kernel_q.to(dev).contiguous(memory_format=torch.channels_last),
            bias=_t(c["bias"], dev),
            in_scale=in_scale.to(dev),
            w_scale=w_scale.to(dev),
        )
    heads = [{"weight": weight.to(dev).contiguous(memory_format=torch.channels_last),
              "bias": bias.to(dev)} for weight, bias in _fused_heads(params)]
    return QuantizedSSD(layers=layers, heads=heads, num_classes=num_classes)


# -------------------------------------------------------------- int8 forward


def _quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), _I8_MIN, _I8_MAX).to(torch.int8)


def conv_int_exact(xq: torch.Tensor, kernel_q: torch.Tensor, spec: _L) -> torch.Tensor:
    """int8 x int8 conv of an NHWC tensor with exact integer results, as
    float64 ``[B,Ho,Wo,cout]``.

    The contraction runs as a float64 ``F.conv2d``: every product and every
    partial sum is an integer of magnitude at most 9*1024*127^2 < 2^28, far
    inside float64's 53-bit mantissa, so the result is exact whatever the
    order of summation, on the CPU and on the GPU alike (CUDA has no
    integer convolution, and float32 is not enough: 9*1024*127^2 > 2^24)."""
    y = F.conv2d(_nchw(xq).double(), kernel_q.double(), None,
                 spec.stride, spec.pad, spec.dilation)
    return _nhwc(y)


def run_heads(qp: QuantizedSSD, taps: list) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused multibox heads on the six NHWC taps, in the taps' dtype
    (:func:`ssdx_torch.model.multibox`): ``(loc [B,8732,4], cls [B,8732,C])``
    float32."""
    return multibox([_nchw(t) for t in taps], [(h["weight"], h["bias"]) for h in qp.heads],
                    qp.num_classes)


@torch.inference_mode()
def apply_int8(qp: QuantizedSSD, feats: torch.Tensor, head_dtype=torch.bfloat16,
               compute: str = "auto"):
    """Int8 post-stem forward: feats ``[B,150,150,64]`` (from the stem) ->
    ``(loc [B,8732,4] f32, cls [B,8732,C] f32)``.

    Same taps, head convs and (H, W, k) flattening as ``SSD300.forward``;
    only the arithmetic of ``ConvBNRelu_2..22`` is int8.  Each layer: int8
    conv -> integer sums, then dequantize + bias + ReLU (+ tap) + requantize
    to the next layer's scales by a division; pools run on the int8 tensor.

    ``compute``: "int32" is the exact integer contraction
    (:func:`conv_int_exact`), the semantics the kernels are held to.  "f32"
    casts the int8 operands to float32 and rounds the conv's output: the
    fast CPU route; its sums are exact only while they stay below 2^24,
    which the deepest layers' worst case exceeds (on a GPU cuDNN may also
    run it in TF32).  "auto" picks "f32" for a CPU tensor and "int32"
    otherwise.
    """
    if compute == "auto":
        compute = "f32" if feats.device.type == "cpu" else "int32"
    if compute not in ("int32", "f32"):
        raise ValueError(f"compute must be auto, int32 or f32, got {compute!r}")

    def conv_q(xq, kernel_q, spec):
        if compute == "f32":
            y = F.conv2d(_nchw(xq).float(), kernel_q.float(), None,
                         spec.stride, spec.pad, spec.dilation)
            return torch.round(_nhwc(y))
        return conv_int_exact(xq, kernel_q, spec).float()

    taps: list[Any] = [None] * len(_TAPS)
    first = qp.layers[_TOPOLOGY[0].name]
    xq = _quantize_act(feats.float(), first.in_scale)
    for i, spec in enumerate(_TOPOLOGY):
        ql = qp.layers[spec.name]
        # in_scale is folded into kernel_q; w_scale alone dequantizes
        y = conv_q(xq, ql.kernel_q, spec) * ql.w_scale + ql.bias
        y = F.relu(y)
        if spec.tap is not None:
            taps[spec.tap] = y.to(head_dtype)
        nxt = _TOPOLOGY[i + 1] if i + 1 < len(_TOPOLOGY) else None
        if nxt is not None:
            xq = _quantize_act(y, qp.layers[nxt.name].in_scale)
            if spec.pool:
                xq = _max_pool(xq, ceil=spec.pool == "ceil")
    return run_heads(qp, taps)


# ----------------------------------------------------------------- validation


def detection_agreement(det_a, det_b) -> dict:
    """Compare two ``Detections`` batches (e.g. bf16 against int8 on the
    same images): fraction of matched detections (same label, IoU >= 0.5),
    mean IoU of the matches, and the largest score difference.  Host side."""
    from .boxes import pairwise_iou

    host = lambda t: torch.as_tensor(t).detach().cpu()
    n_match = n_total = 0
    ious, score_d = [], []
    for b in range(det_a.boxes.shape[0]):
        va, vb = host(det_a.valid[b]), host(det_b.valid[b])
        ba, la, sa = (host(x[b])[va] for x in (det_a.boxes, det_a.labels, det_a.scores))
        bb, lb, sb = (host(x[b])[vb] for x in (det_b.boxes, det_b.labels, det_b.scores))
        n_total += max(len(ba), len(bb))
        if len(ba) == 0 or len(bb) == 0:
            continue
        iou = pairwise_iou(ba.float(), bb.float())
        for i in range(len(ba)):
            j = int(torch.argmax(iou[i]))
            if iou[i, j] >= 0.5 and la[i] == lb[j]:
                n_match += 1
                ious.append(float(iou[i, j]))
                score_d.append(abs(float(sa[i]) - float(sb[j])))
    return {
        "match_rate": n_match / max(n_total, 1),
        "mean_matched_iou": float(np.mean(ious)) if ious else 0.0,
        "max_score_delta": float(np.max(score_d)) if score_d else 0.0,
    }
