"""The fused SSD300 stem: conv1_1 + ReLU + conv1_2 + ReLU + 2x2 max pool.

``stem_conv_pool`` turns ``[B,300,300,3]`` images into the
``[B,150,150,64]`` map that ``SSD300(stem_input=True)`` takes.  On a CUDA
tensor it launches the hand-written kernel of ``csrc/stem.cu`` (bf16 in and
out, f32 accumulation, the 300x300x64 intermediates kept on chip, both
convolutions on wgmma; the source's header gives its bound and design, and
``csrc/stem_sm90.cuh`` the 3x3 64->64 core it shares with ``stem_train``).  On a CPU tensor it runs
:func:`stem_conv_pool_ref`, the plain PyTorch version, which is also the
kernel's oracle on the card.  It replaces the JAX package's TPU kernel
``ssdx/ops/pallas_stem.py::stem_conv_pool``.

Weights are the BN-folded conv1_1/conv1_2 parameters in PyTorch's OIHW
layout; images and output are NHWC.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .pool import sm_count

__all__ = ["stem_conv_pool", "stem_conv_pool_ref", "stem_available", "launches", "TILE_ROWS",
           "TILE_COLS", "TILES_PER_IMAGE", "grid_size", "tile_origin", "w1_operand"]

launches = 0  # kernel launches by stem_conv_pool

_H, _C = 300, 64
# The conv tile of the wgmma core (csrc/stem_sm90.cuh: TR, TW, TILES_X):
# 4 conv rows by 62 columns, 75 x 5 tiles an image, walked by persistent
# blocks in the order tile = block, block + grid, ...
TILE_ROWS, TILE_COLS = 4, 62
_TILES_X = -(-_H // TILE_COLS)
TILES_PER_IMAGE = (_H // TILE_ROWS) * _TILES_X
_lib = None


def grid_size(B, sms):
    """Persistent blocks of a launch over ``B`` images on a card of ``sms``
    streaming multiprocessors, one block each (the stem kernel and every
    launch of stem_train that contracts: conv1_stats, stage2, dw2, dw1)."""
    return min(B * TILES_PER_IMAGE, sms)


def stem_available(params) -> bool:
    """True when ``params`` (an ``SSD300`` state dict, or its
    ``named_parameters()`` as a dict) carries the two stem convs this kernel
    needs."""
    try:
        return all(f"layers.{i}.conv.{k}" in params for i in (0, 1) for k in ("weight", "bias"))
    except TypeError:
        return False


def tile_origin(t):
    """``(image, first conv row, first conv column)`` of tile ``t``, as the
    core's ``tile_of`` computes it."""
    b, rem = divmod(t, TILES_PER_IMAGE)
    return b, (rem // _TILES_X) * TILE_ROWS, (rem % _TILES_X) * TILE_COLS


def w1_operand(w1):
    """conv1_1's OIHW weights ``[64,3,3,3]`` as the kernels' B operand (B2's
    conv1_1, B3's conv1_stats): bf16 ``[64][32]``, ``[co][(dr*3 + dc)*3 +
    ci]``, columns 27..31 zero."""
    return F.pad(w1.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(_C, 27), (0, 5)).contiguous()


def stem_conv_pool_ref(images, w1, b1, w2, b2, dtype=torch.bfloat16):
    """Plain version: conv -> ReLU -> (round to ``dtype``) -> conv -> ReLU ->
    2x2/2 max pool, every step a PyTorch op in ``dtype``."""
    x = images.permute(0, 3, 1, 2).to(dtype)
    y1 = F.relu(F.conv2d(x, w1.to(dtype), b1.to(dtype), padding=1))
    y2 = F.relu(F.conv2d(y1, w2.to(dtype), b2.to(dtype), padding=1))
    return F.max_pool2d(y2, 2).permute(0, 2, 3, 1).contiguous()


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("stem")
        lib.ssdx_stem_forward.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
        lib.ssdx_stem_forward.restype = ctypes.c_int
        _lib = lib
    return _lib


def stem_conv_pool(images, w1, b1, w2, b2, dtype=torch.bfloat16):
    """``[B,300,300,3]`` -> ``[B,150,150,64]`` in ``dtype``.

    CPU tensors take the plain version; CUDA tensors take the kernel, which
    computes in bfloat16 only.
    """
    global launches
    dev = images.device
    if dev.type == "cpu":
        return stem_conv_pool_ref(images, w1, b1, w2, b2, dtype)
    if dev.type != "cuda":
        raise ValueError(f"stem_conv_pool: unsupported device {dev}")
    if dtype != torch.bfloat16:
        raise ValueError(f"the stem kernel computes in bfloat16, not {dtype}")
    B = images.shape[0]
    if tuple(images.shape[1:]) != (_H, _H, 3):
        raise ValueError(f"stem_conv_pool takes [B,300,300,3], got {tuple(images.shape)}")
    shapes = [tuple(t.shape) for t in (w1, b1, w2, b2)]
    if shapes != [(_C, 3, 3, 3), (_C,), (_C, _C, 3, 3), (_C,)]:
        raise ValueError(f"stem weights must be [64,3,3,3], [64], [64,64,3,3], [64]; "
                         f"got {shapes}")
    if any(t.device != dev for t in (w1, b1, w2, b2)):
        raise ValueError("stem_conv_pool: images and weights must share a device")
    bf = torch.bfloat16
    x = images.to(bf).contiguous()
    w1p = w1_operand(w1)
    b1p = b1.to(bf).float().contiguous()
    w2p = w2.to(bf).permute(0, 2, 3, 1).reshape(_C, 9 * _C).contiguous()  # [co][tap*64+ci]
    b2p = b2.float().contiguous()
    out = torch.empty((B, _H // 2, _H // 2, _C), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        err = _kernel().ssdx_stem_forward(
            x.data_ptr(), w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(),
            b2p.data_ptr(), out.data_ptr(), B, grid_size(B, sm_count(dev)),
            torch.cuda.current_stream(dev).cuda_stream)
    # The temporaries above are freed on return while the kernel may still
    # run; the caching allocator hands their memory only to later work on
    # this same stream, which runs after the kernel.
    if err:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    launches += 1
    return out
