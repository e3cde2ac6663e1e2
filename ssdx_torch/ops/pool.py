"""2x2 stride-2 max pool on NHWC with an even tie split in the backward.

``max_pool_2x2(y)`` pools ``[B,H,W,C]`` to ``[B,H//2,W//2,C]``.  On a CUDA
tensor it runs :class:`MaxPool2x2`, whose forward and backward launch the
hand-written kernels of ``csrc/pool.cu`` (the source's header gives the
bound and the design).  On a CPU tensor it runs :class:`MaxPool2x2Ref`, the
plain PyTorch version, which is also the kernels' oracle on the card.  It
replaces the JAX package's ``ssdx/ops/pallas_pool.py::max_pool_2x2``, whose
backward is a TPU kernel.

Contract (both versions):
  * floor mode: an odd last row or column belongs to no window, and its
    gradient is 0;
  * forward: the window's maximum, exact in any float type;
  * backward: ``dy = where(y == p, g / cnt, 0)`` with ``cnt`` the number of
    positions equal to the window's maximum (1..4): tied maxima split the
    cotangent evenly (``F.max_pool2d`` gives it all to the first).  The share
    is taken in float32 (float64 for float64 tensors) and rounded once;
  * the kernels take bfloat16 and float32 with ``C % 8 == 0`` and do not
    propagate NaN (a NaN never equals the maximum).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["max_pool_2x2", "max_pool_2x2_ref", "MaxPool2x2", "MaxPool2x2Ref", "launches",
           "launches_fwd"]

launches = 0      # backwards of max_pool_2x2 that launched pool_bwd_kernel
launches_fwd = 0  # forwards that launched pool_fwd_kernel

_SMS: dict[int, int] = {}  # streaming multiprocessors per device index
_THREADS = 256
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_lib = None


# ------------------------------------------------------------ plain version


def _compute_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def windows(t, ceil: bool = False, fill: float = 0.0):
    """``[B,H,W,C]`` -> the ``[B,Hp,2,Wp,2,C]`` view of its 2x2 windows:
    floor mode crops an odd last row or column, ceil mode pads it with
    ``fill``."""
    B, H, W, C = t.shape
    if ceil:
        if H % 2 or W % 2:
            t = torch.nn.functional.pad(t, (0, 0, 0, W % 2, 0, H % 2), value=fill)
        Hp, Wp = (H + 1) // 2, (W + 1) // 2
    else:
        Hp, Wp = H // 2, W // 2
        t = t[:, :2 * Hp, :2 * Wp]
    return t.reshape(B, Hp, 2, Wp, 2, C)


def unwindows(w, H: int, W: int):
    """The inverse of :func:`windows`: back to ``[B,H,W,C]``, cropping ceil
    mode's padding or filling floor mode's odd last row or column with 0."""
    B, Hp, _, Wp, _, C = w.shape
    t = w.reshape(B, 2 * Hp, 2 * Wp, C)
    if 2 * Hp < H or 2 * Wp < W:
        t = torch.nn.functional.pad(t, (0, 0, 0, W - 2 * Wp, 0, H - 2 * Hp))
    return t[:, :H, :W]


def route(win, pmax, g, hit_extra=None, tie_split: bool = True):
    """Route the pooled cotangent ``g`` ``[B,Hp,Wp,C]`` to the positions of
    ``win`` ``[B,Hp,2,Wp,2,C]`` equal to ``pmax`` ``[B,Hp,1,Wp,1,C]`` (and
    where ``hit_extra`` holds); tied positions split it evenly, or each take
    all of it when ``tie_split`` is off.  The result has ``g``'s type."""
    hit = win == pmax
    if hit_extra is not None:
        hit = hit & hit_extra
    share = g[:, :, None, :, None, :]
    if tie_split:
        cnt = hit.sum(dim=(2, 4), keepdim=True).to(g.dtype)
        share = share / torch.clamp(cnt, min=1.0)
    return torch.where(hit, share, torch.zeros((), dtype=g.dtype, device=g.device))


class MaxPool2x2Ref(torch.autograd.Function):
    """The plain version: tensor ops on the window view."""

    @staticmethod
    def forward(ctx, y):
        p = windows(y).amax(dim=(2, 4))
        ctx.save_for_backward(y, p)
        return p

    @staticmethod
    def backward(ctx, g):
        y, p = ctx.saved_tensors
        ct = _compute_dtype(y.dtype)
        d = route(windows(y), p[:, :, None, :, None, :], g.to(ct)).to(y.dtype)
        return unwindows(d, y.shape[1], y.shape[2])


def max_pool_2x2_ref(y):
    """The plain version, on any device."""
    return MaxPool2x2Ref.apply(y)


# ------------------------------------------------------------- kernel route


def bind(source: str, sigs: dict):
    """Build and load ``csrc/<source>.cu`` and declare its C entries, each of
    which returns a CUDA error code."""
    lib = _build.load(source)
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def launch(lib, name, *args):
    """Call one C entry on the current stream; tensors go in as pointers."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*conv, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"kernel {name} failed: CUDA error {err}")


def _kernel():
    global _lib
    if _lib is None:
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
        _lib = bind("pool", {
            "ssdx_pool_fwd": [P, P, I, I, I, I, I, I, S],
            "ssdx_pool_bwd": [P, P, P, P, I, I, I, I, I, I, S],
        })
    return _lib


def _launch(name, *args):
    launch(_kernel(), name, *args)


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM, 114 on
    an H100 PCIe), read once per device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _grid(items: int, device) -> int:
    return max(1, min(-(-items // _THREADS), 32 * sm_count(device)))


def _aligned(t):
    """Contiguous, and on the 16-byte boundary the kernels' loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class MaxPool2x2(torch.autograd.Function):
    """The kernel route: pool_fwd_kernel and pool_bwd_kernel (csrc/pool.cu)."""

    @staticmethod
    def forward(ctx, y):
        global launches_fwd
        y = _aligned(y.detach())
        B, H, W, C = y.shape
        p = torch.empty((B, H // 2, W // 2, C), dtype=y.dtype, device=y.device)
        _launch("ssdx_pool_fwd", y, p, B, H, W, C, _DTYPES[y.dtype],
                _grid(p.numel() // 8, y.device))
        launches_fwd += 1
        ctx.save_for_backward(y, p)
        return p

    @staticmethod
    def backward(ctx, g):
        global launches
        y, p = ctx.saved_tensors
        B, H, W, C = y.shape
        g = _aligned(g.to(y.dtype))
        dy = torch.empty_like(y)
        items = B * ((H + 1) // 2) * ((W + 1) // 2) * (C // 8)
        _launch("ssdx_pool_bwd", y, p, g, dy, B, H, W, C, _DTYPES[y.dtype],
                _grid(items, y.device))
        launches += 1
        return dy


def check_nhwc(name: str, t, max_channels: int | None = None) -> None:
    """Raise for what the NHWC kernels of this package do not take."""
    if t.dim() != 4 or min(t.shape) < 1:
        raise ValueError(f"{name} takes a non-empty [B,H,W,C] tensor, got {tuple(t.shape)}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"the {name} kernels take bfloat16 or float32, not {t.dtype}")
    C = t.shape[3]
    if C % 8 or (max_channels is not None and C > max_channels):
        rule = "C % 8 == 0" + (f" and C <= {max_channels}" if max_channels else "")
        raise ValueError(f"the {name} kernels need {rule}, got C={C}")
    if t.shape[0] * t.shape[1] * t.shape[2] >= 2 ** 31:
        raise ValueError(f"{name}: B*H*W must stay below 2^31, got {tuple(t.shape)}")


def max_pool_2x2(y):
    """2x2/2 max pool of NHWC ``y``, differentiable with an even tie split.

    CPU tensors take the plain version; CUDA tensors take the kernels.
    """
    dev = y.device
    if dev.type == "cpu":
        return MaxPool2x2Ref.apply(y)
    if dev.type != "cuda":
        raise ValueError(f"max_pool_2x2: unsupported device {dev}")
    check_nhwc("max_pool_2x2", y)
    return MaxPool2x2.apply(y)
