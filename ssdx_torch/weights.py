"""Weights on disk -> the port's state dict.

``load_params`` reads the weights-only exports of the JAX package's
trainer (a pickle of ``{'params', 'batch_stats'}`` numpy trees, or the
compressed float16 ``.npz`` bundle whose keys are slash-joined tree paths).
``state_dict_from_jax`` maps such a tree onto either network,
:class:`ssdx_torch.model.SSD300` or
:class:`ssdx_torch.model_resnet.SSD300ResNet50` (whose tree keys each conv
module by its path): ``<module>/Conv_0`` -> ``<path>.conv`` (HWIO ->
OIHW), ``<module>/BatchNorm_0`` -> ``<path>.bn``, and ``box_head_i`` +
``cls_head_i`` -> the fused ``heads.i`` conv, box channels first.
``variables_from_torch`` is its inverse for SSD300: a model's weights back
to that tree, for comparisons with the JAX package and for weights-only
exports.
``quant_from_jax`` carries a quantized network of the JAX package
(``ssdx.quant.QuantizedSSD`` as numpy arrays) into the port's
:class:`ssdx_torch.quant.QuantizedSSD`, and ``quant_to_jax`` carries one back.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from .priors import BOXES_PER_LOCATION

__all__ = ["load_params", "state_dict_from_jax", "variables_from_torch",
           "quant_from_jax", "quant_to_jax"]


def load_params(path: str | Path) -> dict:
    """Load a weights-only export (pickle or .npz bundle);
    returns {'params', 'batch_stats'} of float32 numpy arrays."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":  # zip container = np.savez bundle (suffix-agnostic)
        out: dict = {}
        with np.load(path) as z:
            for key in z.files:
                parts = key.split("/")
                node = out
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = z[key].astype(np.float32)
        return out
    with open(path, "rb") as f:
        return pickle.load(f)


def _t(a, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _oihw(kernel, device=None) -> torch.Tensor:
    """HWIO kernel -> float32 tensor viewed as OIHW."""
    return _t(kernel, device).permute(3, 2, 0, 1)


def _fused_heads(tree: dict) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``box_head_i`` + ``cls_head_i`` of ``tree`` for i = 0, 1, ... as one
    conv each: (weight OIHW, bias) float32, the box channels first."""
    out, i = [], 0
    while f"box_head_{i}" in tree:
        box, cls = tree[f"box_head_{i}"], tree[f"cls_head_{i}"]
        out.append((
            _oihw(np.concatenate([np.asarray(box["kernel"]), np.asarray(cls["kernel"])], -1)),
            _t(np.concatenate([np.asarray(box["bias"]), np.asarray(cls["bias"])]))))
        i += 1
    return out


def state_dict_from_jax(variables: dict, fold_bn: bool) -> dict[str, torch.Tensor]:
    """State dict of ``SSD300(fold_bn=fold_bn)`` or
    ``SSD300ResNet50(fold_bn=fold_bn)`` from its weights tree.

    Each conv module's kernel, and its bias and BatchNorm where it has
    them; ``ConvBNRelu_i`` is SSD300's ``layers.i``, and the ResNet-50
    tree's names are module paths already.  With ``fold_bn=True`` the tree
    must already be folded (:func:`ssdx_torch.export.fold_batchnorm`);
    otherwise it must carry ``batch_stats`` for every BN layer.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for name, mod in params.items():
        if name.startswith(("box_head_", "cls_head_")):
            continue
        if fold_bn and "BatchNorm_0" in mod:
            raise ValueError(f"{name} still has BatchNorm_0: fold the tree first")
        path = name.replace("ConvBNRelu_", "layers.")
        sd[f"{path}.conv.weight"] = _oihw(mod["Conv_0"]["kernel"])
        if "bias" in mod["Conv_0"]:
            sd[f"{path}.conv.bias"] = _t(mod["Conv_0"]["bias"])
        if "BatchNorm_0" in mod:
            bn, st = mod["BatchNorm_0"], stats[name]["BatchNorm_0"]
            sd[f"{path}.bn.weight"] = _t(bn["scale"])
            sd[f"{path}.bn.bias"] = _t(bn["bias"])
            sd[f"{path}.bn.running_mean"] = _t(st["mean"])
            sd[f"{path}.bn.running_var"] = _t(st["var"])
            sd[f"{path}.bn.num_batches_tracked"] = torch.tensor(0)
    for i, (weight, bias) in enumerate(_fused_heads(params)):
        sd[f"heads.{i}.weight"], sd[f"heads.{i}.bias"] = weight, bias
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().contiguous().numpy()


def _hwio(weight: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(_np(weight).transpose(2, 3, 1, 0))


def _unfused_heads(heads) -> dict:
    """The inverse of :func:`_fused_heads`: (weight, bias) per tap ->
    ``box_head_i`` / ``cls_head_i`` {"kernel" HWIO, "bias"} numpy."""
    out = {}
    for i, ((weight, bias), k) in enumerate(zip(heads, BOXES_PER_LOCATION)):
        kernel, bias = _hwio(weight), _np(bias)
        out[f"box_head_{i}"] = {"kernel": np.ascontiguousarray(kernel[..., : 4 * k]),
                                "bias": bias[: 4 * k]}
        out[f"cls_head_{i}"] = {"kernel": np.ascontiguousarray(kernel[..., 4 * k:]),
                                "bias": bias[4 * k:]}
    return out


def variables_from_torch(model) -> dict:
    """``{'params', 'batch_stats'}`` float32 numpy tree in the JAX layout
    from an :class:`ssdx_torch.model.SSD300` (the inverse of
    :func:`state_dict_from_jax`)."""
    params: dict = {}
    stats: dict = {}
    for i, layer in enumerate(model.layers):
        name = f"ConvBNRelu_{i}"
        mod = {"Conv_0": {"kernel": _hwio(layer.conv.weight), "bias": _np(layer.conv.bias)}}
        if layer.bn is not None:
            mod["BatchNorm_0"] = {"scale": _np(layer.bn.weight), "bias": _np(layer.bn.bias)}
            stats[name] = {"BatchNorm_0": {"mean": _np(layer.bn.running_mean),
                                           "var": _np(layer.bn.running_var)}}
        params[name] = mod
    params.update(_unfused_heads((head.weight, head.bias) for head in model.heads))
    return {"params": params, "batch_stats": stats}


def quant_from_jax(qp, device="cpu"):
    """The port's ``QuantizedSSD`` from the JAX package's.

    ``qp`` has ``layers`` (name -> ``kernel_q`` HWIO int8, ``bias``,
    ``in_scale``, ``w_scale``), ``heads`` (``box_head_i`` / ``cls_head_i``
    -> ``kernel`` HWIO, ``bias``) and ``num_classes``; anything
    ``np.asarray`` reads will do.  The port keeps ``kernel_q`` as int8 of
    logical shape OIHW in channels-last memory (``[cout][kh][kw][cin]``,
    what both ``F.conv2d`` and the int8 kernels take) and the heads fused,
    one float32 OIHW conv per tap with the box channels first.
    """
    from .quant import QuantizedSSD, QuantLayer

    dev = torch.device(device)
    layers = {}
    for name, ql in qp.layers.items():
        kq = torch.as_tensor(np.array(ql.kernel_q), dtype=torch.int8).permute(3, 2, 0, 1)
        layers[name] = QuantLayer(
            kernel_q=kq.to(dev).contiguous(memory_format=torch.channels_last),
            bias=_t(ql.bias).to(dev), in_scale=_t(ql.in_scale).to(dev),
            w_scale=_t(ql.w_scale).to(dev))
    heads = [{"weight": weight.to(dev).contiguous(memory_format=torch.channels_last),
              "bias": bias.to(dev)} for weight, bias in _fused_heads(qp.heads)]
    return QuantizedSSD(layers=layers, heads=heads, num_classes=int(qp.num_classes))


def quant_to_jax(qp) -> dict:
    """The inverse of :func:`quant_from_jax` as plain numpy:
    ``{"layers": {name: {"kernel_q" HWIO int8, "bias", "in_scale",
    "w_scale"}}, "heads": {"box_head_i" / "cls_head_i": {"kernel" HWIO,
    "bias"}}, "num_classes"}``, the fields of ``ssdx.quant.QuantizedSSD``."""
    layers = {
        name: {"kernel_q": np.ascontiguousarray(
                   ql.kernel_q.detach().cpu().numpy().transpose(2, 3, 1, 0)),
               "bias": _np(ql.bias), "in_scale": _np(ql.in_scale), "w_scale": _np(ql.w_scale)}
        for name, ql in qp.layers.items()}
    heads = _unfused_heads((h["weight"], h["bias"]) for h in qp.heads)
    return {"layers": layers, "heads": heads, "num_classes": qp.num_classes}
