"""The bare matrix products on Hopper: binding and tile plan of
``csrc/gemm_sm90.cu`` (TMA loads, ``wgmma``; its header gives bound and
design).

Two public wrappers launch these kernels: ``int8_conv.int8_mm_raw`` and
``bf16_mm_raw`` (kernel S1, "nt": ``a [M,K] . b_t [N,K]^T``) and
``repro.mm`` (kernel S2b, "nn": ``x [M,K] . y [K,N]``).  They check shapes
and devices and count launches; this module only launches.  Every launch
goes on the current stream of the operands' device, so a caller needs no
``torch.cuda.device`` context.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["TILES", "plan_nt", "aligned", "nt", "nn"]

# block tiles (BM, BN) the nt kernels are built for: BM / 64 consumer
# warpgroups.  The nn kernel runs 64 x 128 whatever the shape, so a row's
# sums never depend on M.
TILES = ((128, 256), (128, 128), (64, 128))
_SMS = {}  # streaming multiprocessors per device index
_fns = None


@functools.lru_cache(maxsize=1024)
def plan_nt(M: int, N: int, sms: int = 132, tiles=TILES) -> tuple[int, int]:
    """Block tile (BM, BN), of ``tiles``, for an ``[M,N]`` output on ``sms``
    SMs (the nt kernels are built for ``TILES``, the int8 conv kernel of
    ``int8_conv.py`` for ``int8_conv.CONV_TILES`` one block an SM).

    One block runs per SM, so the time goes as the number of waves times
    the time of one tile, taken here as BM * (BN + 64): its products plus a
    fixed cost of about 64 columns (the A tile's loads, the pipeline's fill,
    the epilogue).  The first of the cheapest in ``tiles`` wins: 2048^2
    takes 128 x 256 (128 tiles, one wave on 132 SMs), 1024^2 64 x 128."""
    best = None
    for bm, bn in tiles:
        n = -(-M // bm) * -(-N // bn)
        cost = -(-n // sms) * bm * (bn + 64)
        if best is None or cost < best[0]:
            best = (cost, (bm, bn))
    return best[1]


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as TMA wants; copies only when not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.load("gemm_sm90")
        p, i = ctypes.c_void_p, ctypes.c_int
        fns = {torch.int8: lib.ssdx_gemm_s8s32_nt, torch.bfloat16: lib.ssdx_gemm_bf16f32_nt,
               "nn": lib.ssdx_gemm_bf16f32_nn}
        for fn in fns.values():
            fn.restype = i
        for dtype in (torch.int8, torch.bfloat16):
            fns[dtype].argtypes = [p, p, p, i, i, i, i, i, i, p]  # a, b, out, M, N, K, bm, bn, device, stream
        fns["nn"].argtypes = [p, p, p, i, i, i, i, p]  # x, y, out, M, N, K, device, stream
        _fns = fns
    return _fns


def _sms(index: int) -> int:
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def nt(a: torch.Tensor, b_t: torch.Tensor, out: torch.Tensor) -> None:
    """``out [M,N] = a [M,K] . b_t [N,K]^T``: int8 -> int32 or bf16 -> float32,
    in :func:`plan_nt`'s tiles.  All three on one CUDA device, contiguous,
    16-byte aligned."""
    (M, K), N = a.shape, b_t.shape[0]
    index = a.device.index
    bm, bn = plan_nt(M, N, _sms(index))
    err = _kernels()[a.dtype](a.data_ptr(), b_t.data_ptr(), out.data_ptr(), M, N, K, bm, bn,
                              index, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"gemm_sm90 nt kernel launch failed: CUDA error {err}")


def nn(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> None:
    """``out [M,N] = x [M,K] . y [K,N]``, bf16 -> float32, in 64 x 128
    tiles.  All three on one CUDA device, contiguous, 16-byte aligned."""
    (M, K), N = x.shape, y.shape[1]
    index = x.device.index
    err = _kernels()["nn"](x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, index,
                           torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"gemm_sm90 nn kernel launch failed: CUDA error {err}")
