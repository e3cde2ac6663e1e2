"""The two probe ops of the data-parallel repro tool
(``ssdx_torch/tools/repro_dist_kernels.py``).

``ew(x)`` is ``tanh(x) * 1.5`` on float32 and ``mm(x, y)`` is ``x [M,K] bf16 @
y [K,N] bf16 -> [M,N] float32`` with float32 accumulation, both row-major.  On
a CUDA tensor each launches its hand-written kernel: ``ew`` the one of
``csrc/repro.cu``, ``mm`` the "nn" kernel of ``csrc/gemm_sm90.cu`` (TMA +
wgmma, through ``ops/gemm.py``); the sources' headers give the bounds and the
designs.  On a CPU tensor each runs its plain PyTorch version (:func:`ew_ref`,
:func:`mm_ref`), which is also the kernel's oracle on the card.  They replace
the TPU kernels ``_ew_kernel`` and ``_mm_kernel`` of
``scripts/repro_shardmap_pallas.py``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, gemm

__all__ = ["ew", "ew_ref", "mm", "mm_ref", "launches_ew", "launches_mm"]

launches_ew = 0  # kernel launches by ew
launches_mm = 0  # kernel launches by mm

_lib = None


def ew_ref(x):
    """Plain version of :func:`ew`."""
    return torch.tanh(x) * 1.5


def mm_ref(x, y):
    """Plain version of :func:`mm`: a float32 product of the bf16 values."""
    return x.float() @ y.float()


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("repro")
        p = ctypes.c_void_p
        lib.ssdx_repro_ew.argtypes = [p, p, ctypes.c_longlong, p]
        lib.ssdx_repro_ew.restype = ctypes.c_int
        _lib = lib
    return _lib


def ew(x):
    """``tanh(x) * 1.5``, float32, any shape.  CPU tensors take the plain
    version; CUDA tensors take the kernel."""
    global launches_ew
    dev = x.device
    if dev.type == "cpu":
        return ew_ref(x)
    if dev.type != "cuda":
        raise ValueError(f"ew: unsupported device {dev}")
    if x.dtype != torch.float32 or x.numel() == 0:
        raise ValueError(f"ew takes a non-empty float32 tensor, got {x.dtype} {tuple(x.shape)}")
    xc = gemm.aligned(x)
    out = torch.empty_like(xc)
    with torch.cuda.device(dev):
        err = _kernel().ssdx_repro_ew(xc.data_ptr(), out.data_ptr(), xc.numel(),
                                      torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ew kernel launch failed: CUDA error {err}")
    launches_ew += 1
    return out


def _check_mm(x, y):
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16 or y.device != x.device:
        raise ValueError("mm takes two bfloat16 matrices on one device")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"mm: x [M,K] and y [K,N], got {tuple(x.shape)} and {tuple(y.shape)}")
    (M, K), N = x.shape, y.shape[1]
    if M < 1 or M % 16 or N < 1 or N % 64 or K < 1 or K % 32:
        raise ValueError(f"the mm kernel needs M % 16 == 0, N % 64 == 0 and K % 32 == 0, "
                         f"got M={M}, N={N}, K={K}")


def mm(x, y):
    """``x [M,K] bf16 @ y [K,N] bf16 -> [M,N] float32``.  CPU tensors take the
    plain version; CUDA tensors take the kernel, which needs M to be a
    multiple of 16, N of 64 and K of 32.  The kernel's tile and its order
    over K do not depend on M: a row's result does not depend on which rows
    share the call."""
    global launches_mm
    dev = x.device
    if dev.type == "cpu":
        return mm_ref(x, y)
    if dev.type != "cuda":
        raise ValueError(f"mm: unsupported device {dev}")
    _check_mm(x, y)
    xc, yc = gemm.aligned(x), gemm.aligned(y)
    out = torch.empty((x.shape[0], y.shape[1]), dtype=torch.float32, device=dev)
    gemm.nn(xc, yc, out)
    launches_mm += 1
    return out
