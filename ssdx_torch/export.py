"""Inference export transforms.

``fold_batchnorm`` folds trained BatchNorm statistics into the preceding
conv's kernel/bias (the standard serving-time transform):

    y = ((conv(x) - mean) / sqrt(var + eps)) * scale + bias
      = conv'(x) + bias'        with  k' = k * s,  b' = (b - mean) * s + bias,
                                      s = scale / sqrt(var + eps)

It works on the JAX-layout ``{'params', 'batch_stats'}`` tree that
:func:`ssdx_torch.weights.load_params` returns; the folded tree loads into
``SSD300(..., fold_bn=True)`` through
:func:`ssdx_torch.weights.state_dict_from_jax`.
"""
from __future__ import annotations

import torch

__all__ = ["fold_batchnorm"]

_BN_EPS = 1e-5


def fold_batchnorm(variables: dict, eps: float = _BN_EPS) -> dict:
    """Return ``{"params": ...}`` for the ``fold_bn=True`` model variant.

    Modules without BatchNorm (heads, the BN-free extra convs) pass through;
    folded kernels and biases are float32 tensors.  A conv with no bias (as
    every conv before a BatchNorm of :mod:`ssdx_torch.model_resnet`) folds
    as one whose bias is 0.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)

    def fold_module(name: str, module: dict) -> dict:
        if "BatchNorm_0" not in module:
            return module
        conv = module["Conv_0"]
        bn = module["BatchNorm_0"]
        mod_stats = stats[name]["BatchNorm_0"]
        s = t(bn["scale"]) / torch.sqrt(t(mod_stats["var"]) + eps)
        kernel = t(conv["kernel"]) * s  # [kh, kw, cin, cout] * [cout]
        b = t(conv["bias"]) if "bias" in conv else 0.0
        bias = (b - t(mod_stats["mean"])) * s + t(bn["bias"])
        return {"Conv_0": {"kernel": kernel, "bias": bias}}

    return {"params": {name: fold_module(name, mod) for name, mod in params.items()}}
