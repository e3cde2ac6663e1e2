"""Int8 convolutions of the quantized serving path, and the int8 matmul probe.

``int8_conv`` is one quantized conv layer: int8 x int8 -> int32, then
``relu(acc * w_scale + bias)``, then requantization to the next layer's
per-channel int8 grid (a multiply by the reciprocal scale, round half to
even, clip to +-127) and/or the float tap that feeds the bf16 heads.  On a
CUDA tensor it launches the hand-written kernel of ``csrc/int8_conv.cu``:
an implicit GEMM on the TMA + ``wgmma`` main loop of ``csrc/sm90.cuh``
with the epilogue fused (the source's header gives bound and design), for
3x3 layers of any stride, dilation and padding (entry point
``ssdx_int8_conv3``) and 1x1 layers (``ssdx_int8_mm``), in the block tile
that :func:`plan` picks for the layer.  On a CPU tensor it runs
:func:`int8_conv_ref`, the plain PyTorch version, which is also the
kernel's oracle on the card.  It replaces the JAX package's TPU kernels
``ssdx/ops/pallas_int8_conv.py::int8_conv`` (``_conv3_kernel`` and
``_mm_kernel``); ``apply_int8_kernels`` is the counterpart of
``apply_int8_pallas`` there.  :func:`a_load` gives the kernel's loader
the addresses it reads, so that the CPU tests hold them.

``int8_mm_raw`` and ``bf16_mm_raw`` are bare matmuls (int8 -> int32 and
bf16 -> f32), the counterpart of ``scripts/bench_int8_mxu.py::_pallas_mm``.
They launch the nt kernels of ``csrc/gemm_sm90.cu`` (through
``ops/gemm.py``); ``ssdx_torch/tools/bench_int8_mm.py`` times them.

Layouts: activations NHWC ``[B,H,W,C]``; ``kernel_q`` int8 of logical
shape OIHW (``ssdx_torch/quant.py``), read as ``[cout][kh][kw][cin]``; the
matmuls take ``a [M,K]`` and ``b_t [N,K]``, both with K contiguous.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import quant
from . import _build, gemm

__all__ = ["int8_conv", "int8_conv_ref", "apply_int8_kernels", "ConvPlan", "plan",
           "ALoad", "a_load", "int8_mm_raw", "int8_mm_raw_ref", "bf16_mm_raw",
           "bf16_mm_raw_ref", "launches", "launches_conv3", "launches_mm", "launches_raw"]

launches = 0  # kernel launches by int8_conv: launches_conv3 + launches_mm
launches_conv3 = 0  # ... for 3x3 layers
launches_mm = 0  # ... for 1x1 layers
launches_raw = 0  # kernel launches by int8_mm_raw and bf16_mm_raw

_EMITS = ("int8", "f32", "both")
_TAP_KIND = {torch.bfloat16: 1, torch.float32: 2}
_lib = None


def _out_size(n: int, k: int, stride: int, dilation: int, pad: int) -> int:
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def _check_emit(emit, next_in_scale):
    if emit not in _EMITS:
        raise ValueError(f"emit must be one of {_EMITS}, got {emit!r}")
    if emit != "f32" and next_in_scale is None:
        raise ValueError(f"emit={emit!r} needs next_in_scale")


def _epilogue_ref(acc, w_scale, bias, inv_ns, emit, tap_dtype):
    """acc float32 [.., cout] (integer valued) -> int8, the tap, or both.
    Every step is its own PyTorch op, so each rounds once: multiply, add,
    max, multiply by the reciprocal, round half to even, clip."""
    y = torch.relu(acc * w_scale + bias)
    if emit == "f32":
        return y.to(tap_dtype)
    q = torch.clamp(torch.round(y * inv_ns), -127, 127).to(torch.int8)
    return q if emit == "int8" else (q, y.to(tap_dtype))


def int8_conv_ref(xq, kernel_q, w_scale, bias, next_in_scale=None, *, stride=1,
                  dilation=1, pad, emit="int8", tap_dtype=torch.float32):
    """Plain version of :func:`int8_conv`, on any device.

    The contraction is ``quant.conv_int_exact``: a float64 ``F.conv2d``,
    exact because every partial sum is an integer below 2^28 (float32 would
    not do: 9*1024*127^2 > 2^24, and CUDA has no integer convolution).  The
    sums are then rounded to float32 once, as an int32 -> float32 conversion
    rounds them, and the epilogue runs op by op in float32."""
    _check_emit(emit, next_in_scale)
    k = kernel_q.shape[-1]
    spec = quant._L("layer", k, stride, pad, dilation, None, None)
    acc = quant.conv_int_exact(xq, kernel_q, spec).float()
    inv_ns = None if next_in_scale is None else torch.reciprocal(next_in_scale.float())
    return _epilogue_ref(acc, w_scale.float(), bias.float(), inv_ns, emit, tap_dtype)


class ConvPlan(NamedTuple):
    """A layer's launch: its geometry, the implicit GEMM's M (output
    pixels), N (``cout``) and K (bytes of a weight row), how the kernel's
    loader fills A (``LOADERS``) in stages of ``kb`` bytes of K, and the
    block tile ``bm x bn`` with ``ctas`` blocks an SM, its count of k-blocks,
    tiles and waves (tiles over the blocks the card holds at once)."""
    B: int
    H: int
    W: int
    cin: int
    cout: int
    k: int
    stride: int
    dilation: int
    pad: int
    Ho: int
    Wo: int
    M: int
    K: int
    loader: str
    kb: int
    bm: int
    bn: int
    ctas: int
    nk: int
    tiles: int
    waves: float


BK = 128  # bytes of K per stage of the kernel's ring (csrc/sm90.cuh)
# How the kernel fills a stage of A (csrc/int8_conv.cu, enum Loader), from
# what a_load gives it:
#   tiled   1x1 layers: A is x as an [M, cin] matrix, one TMA copy a stage;
#   im2col  3x3 layers with cin a multiple of 64 (and, for an odd multiple,
#           a wave of two-block tiles): one TMA copy in im2col mode a stage,
#           kb channels of one tap at every pixel of the tile;
#   copies  the other 3x3 layers: 16-byte cp.async copies by the loader's
#           threads, one a row and 16-byte chunk (a stage may span taps).
LOADERS = {"copies": 0, "tiled": 1, "im2col": 2}
# block tiles of one block an SM (under a wave, or the copies loader);
# the TMA loaders take 128 x 128 two blocks an SM from a wave on
CONV_TILES = ((128, 128), (64, 128))
# (bm, bn, blocks an SM, kb) the kernel is built for (launch_conv)
BUILT = ((128, 128, 2, 64), (128, 128, 2, BK), (128, 128, 1, BK), (64, 128, 1, BK))
_PAST_M = -(1 << 30)  # a row table's top and left past M: every tap out of bounds


@functools.lru_cache(maxsize=1024)
def plan(x_shape, cout: int, k: int, stride: int = 1, dilation: int = 1, pad: int = 0,
         sms: int = 132) -> ConvPlan:
    """The launch of one layer on ``sms`` SMs.

    The loader is the ``LOADERS`` rule.  A TMA loader takes 128 x 128 tiles
    two blocks an SM, so that one block's epilogue (about 9 us on an H100)
    runs beside the other's main loop, unless the grid has under one wave of
    them; otherwise, and for the copies loader, the tile is the cheapest of
    ``CONV_TILES`` by ``gemm.plan_nt``'s cost, one block an SM.  Cin an odd
    multiple of 64 in im2col takes 64-byte k-blocks, which only the
    two-block tile has."""
    B, H, W, cin = x_shape  # a tuple (torch.Size is one): plans are cached
    Ho, Wo = (_out_size(n, k, stride, dilation, pad) for n in (H, W))
    M, K = B * Ho * Wo, k * k * cin
    cdiv = lambda a, b: -(-a // b)
    pairs = cdiv(M, 128) * cdiv(cout, 128) >= sms
    if k == 1:
        loader = "tiled"
    elif (cin % 64 == 0 and pad <= 127 and 2 * dilation - pad <= 128
          and 2 * dilation <= 254  # the map's corner limits
          and (cin % BK == 0 or pairs)):
        loader = "im2col"
    else:
        loader = "copies"
    kb = 64 if loader == "im2col" and cin % BK else BK
    if pairs and loader != "copies":
        bm, bn, ctas = 128, 128, 2
    else:
        (bm, bn), ctas = gemm.plan_nt(M, cout, sms, CONV_TILES), 1
    tiles = cdiv(M, bm) * cdiv(cout, bn)
    return ConvPlan(B, H, W, cin, cout, k, stride, dilation, pad, Ho, Wo, M, K, loader, kb, bm,
                    bn, ctas, cdiv(K, kb), tiles, tiles / (sms * ctas))


class ALoad(NamedTuple):
    """What the kernel's loader is given to fill A, the implicit im2col
    matrix ``[M, K]`` (:func:`a_load`).  ``rows`` and ``kblocks`` are int32
    ``[n, 4]`` tables, empty for the tiled loader:

    * im2col: ``rows[t] = (w, h, n, 0)``, the window corner of tile t's first
      pixel, where the map's box starts its walk (along W, then H, then N, at
      ``stride`` steps between the corners ``lower`` and ``size - 1 +
      upper``); ``kblocks[kb] = (channel, offset_w, offset_h, 0)``: the
      k-block's tap moves every pixel of the walk by the offsets and the copy
      reads ``kb`` channels from ``channel``, zeros outside x.
    * copies: ``rows[m] = (n * H * W, top, left, 0)`` for every row of every
      tile (rows past M lie far outside x); ``kblocks[8 * kb + j] = (dy, dx,
      channel, in_k)`` for 16-byte chunk j of k-block kb.  The chunk of row
      m reads x's byte ``(n * H * W + (top + dy) * W + left + dx) * cin +
      channel`` where ``in_k`` is 1 and that pixel lies in x, else zeros.

    ``lower`` and ``upper`` are the im2col map's corner bounds (0 for the
    other loaders)."""
    rows: torch.Tensor
    kblocks: torch.Tensor
    lower: int
    upper: int


def a_load(p: ConvPlan) -> ALoad:
    """The loader's tables and the im2col map's corner bounds for one plan,
    on the CPU: the one source of the kernel's A addresses."""
    empty = torch.zeros((0, 4), dtype=torch.int32)
    if p.loader == "tiled":
        return ALoad(empty, empty, 0, 0)
    step = p.kb if p.loader == "im2col" else 16  # an im2col k-block, a 16-byte chunk
    kbytes = torch.arange(p.nk * p.kb // step, dtype=torch.int64) * step
    tap, ch = kbytes // p.cin, kbytes % p.cin
    dy, dx = (tap // p.k) * p.dilation, (tap % p.k) * p.dilation
    tiles_m = -(-p.M // p.bm)
    m = torch.arange(tiles_m * (p.bm if p.loader == "copies" else 1), dtype=torch.int64)
    if p.loader == "im2col":
        m = m * p.bm
    n, r = m // (p.Ho * p.Wo), m % (p.Ho * p.Wo)
    top, left = (r // p.Wo) * p.stride - p.pad, (r % p.Wo) * p.stride - p.pad
    zero = torch.zeros_like(m)
    if p.loader == "im2col":
        rows = torch.stack([left, top, n, zero], 1)
        kblocks = torch.stack([ch, dx, dy, torch.zeros_like(ch)], 1)
        return ALoad(rows.to(torch.int32), kblocks.to(torch.int32), -p.pad,
                     p.pad - p.dilation * (p.k - 1))
    past = m >= p.M
    rows = torch.stack([torch.where(past, zero, n * p.H * p.W),
                        torch.where(past, zero + _PAST_M, top),
                        torch.where(past, zero + _PAST_M, left), zero], 1)
    kblocks = torch.stack([dy, dx, ch, (kbytes < p.K).to(torch.int64)], 1)
    return ALoad(rows.to(torch.int32), kblocks.to(torch.int32), 0, 0)


@functools.lru_cache(maxsize=1024)
def _a_load_on(p: ConvPlan, index: int) -> ALoad:
    """:func:`a_load` with its tables on CUDA device ``index``, made once a
    plan."""
    a = a_load(p)
    dev = torch.device("cuda", index)
    return a._replace(rows=a.rows.to(dev), kblocks=a.kblocks.to(dev))


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("int8_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ssdx_int8_conv3, lib.ssdx_int8_mm):
            # x, w, rows, kblocks, w_scale, bias, inv_ns, out_q, out_tap, B, H,
            # W, Cin, Cout, Ho, Wo, stride, lower, upper, tap_kind, loader, bm,
            # bn, ctas, device, stream
            fn.argtypes = [p] * 9 + [i] * 16 + [p]
            fn.restype = i
        _lib = lib
    return _lib


def _check_kernel_args(xq, kernel_q, w_scale, bias, next_in_scale, stride, dilation, pad,
                       emit, tap_dtype):
    """What the kernel takes, or ValueError: int8 ``[B,H,W,cin]`` and
    ``[cout,cin,k,k]`` with k 1 or 3 and cin, cout multiples of 16; a 1x1
    layer of stride 1 without padding; a float32 or bf16 tap; ``[cout]``
    scales on the input's device; a non-empty output."""
    _check_emit(emit, next_in_scale)
    if xq.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise ValueError(f"int8_conv takes int8 operands, got {xq.dtype}, {kernel_q.dtype}")
    if xq.dim() != 4 or kernel_q.dim() != 4:
        raise ValueError(f"int8_conv: x [B,H,W,cin] and kernel [cout,cin,k,k], got "
                         f"{tuple(xq.shape)} and {tuple(kernel_q.shape)}")
    B, H, W, cin = xq.shape
    cout, cin_w, k, k2 = kernel_q.shape
    if cin_w != cin or k != k2 or k not in (1, 3):
        raise ValueError(f"int8_conv: kernel {tuple(kernel_q.shape)} does not fit "
                         f"input {tuple(xq.shape)} (1x1 or 3x3, OIHW)")
    if cin % 16 or cout % 16:
        raise ValueError(f"the int8 kernel needs cin and cout to be multiples of 16, "
                         f"got {cin} and {cout}")
    if k == 1 and (stride != 1 or dilation != 1 or pad != 0):
        raise ValueError("a 1x1 layer is a plain matmul: stride 1, no padding")
    if stride < 1 or dilation < 1 or pad < 0:
        raise ValueError(f"int8_conv: stride {stride}, dilation {dilation}, pad {pad}")
    if tap_dtype not in _TAP_KIND:
        raise ValueError(f"tap_dtype must be float32 or bfloat16, got {tap_dtype}")
    vecs = [w_scale, bias] + ([] if next_in_scale is None else [next_in_scale])
    if any(t.device != xq.device for t in [kernel_q] + vecs):
        raise ValueError("int8_conv: input, kernel and scales must share a device")
    if any(tuple(t.shape) != (cout,) for t in vecs):
        raise ValueError(f"int8_conv: w_scale, bias and next_in_scale must be [{cout}]")
    if min(B, *(_out_size(n, k, stride, dilation, pad) for n in (H, W))) < 1:
        raise ValueError(f"int8_conv: empty output for input {tuple(xq.shape)}")


def int8_conv(xq, kernel_q, w_scale, bias, next_in_scale=None, *, stride=1,
              dilation=1, pad, emit="int8", tap_dtype=torch.float32):
    """One quantized conv layer.

    ``xq`` ``[B,H,W,cin]`` int8; ``kernel_q`` ``[cout,cin,k,k]`` int8 with
    the input scales folded in (``quant.quantize_ssd``), k 1 or 3;
    ``w_scale``, ``bias`` ``[cout]`` float32.  ``emit="int8"`` requantizes
    to ``next_in_scale`` ``[cout]``; ``emit="f32"`` returns the float
    activation in ``tap_dtype`` (float32 or bfloat16); ``emit="both"``
    returns the (int8, tap) pair from one pass.  Outputs are
    ``[B,Ho,Wo,cout]``, strided outputs computed directly.

    CPU tensors take the plain version; CUDA tensors take the kernel, which
    needs ``cin`` and ``cout`` to be multiples of 16 (``_check_kernel_args``),
    in :func:`plan`'s tile and loader, with :func:`a_load`'s tables.
    """
    global launches, launches_conv3, launches_mm
    dev = xq.device
    kw = dict(stride=stride, dilation=dilation, pad=pad, emit=emit, tap_dtype=tap_dtype)
    if dev.type == "cpu":
        return int8_conv_ref(xq, kernel_q, w_scale, bias, next_in_scale, **kw)
    if dev.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {dev}")
    B, H, W, cin = xq.shape
    cout, _, k, _ = kernel_q.shape
    _check_kernel_args(xq, kernel_q, w_scale, bias, next_in_scale, stride, dilation, pad, emit,
                       tap_dtype)
    p = plan(xq.shape, cout, k, stride, dilation, pad, gemm._sms(dev.index))

    x = gemm.aligned(xq)
    w = gemm.aligned(kernel_q.permute(0, 2, 3, 1))  # [cout][kh][kw][cin]
    ws, b = w_scale.float().contiguous(), bias.float().contiguous()
    inv = None if next_in_scale is None else torch.reciprocal(next_in_scale.float()).contiguous()
    out_q = out_tap = None
    if emit != "f32":
        out_q = torch.empty((B, p.Ho, p.Wo, cout), dtype=torch.int8, device=dev)
    if emit != "int8":
        out_tap = torch.empty((B, p.Ho, p.Wo, cout), dtype=tap_dtype, device=dev)
    a = _a_load_on(p, dev.index)
    ptr = lambda t: None if t is None or t.numel() == 0 else t.data_ptr()
    lib = _kernel()
    fn = lib.ssdx_int8_conv3 if k == 3 else lib.ssdx_int8_mm
    err = fn(ptr(x), ptr(w), ptr(a.rows), ptr(a.kblocks), ptr(ws), ptr(b), ptr(inv), ptr(out_q),
             ptr(out_tap), p.B, p.H, p.W, p.cin, p.cout, p.Ho, p.Wo, p.stride, a.lower, a.upper,
             0 if out_tap is None else _TAP_KIND[tap_dtype], LOADERS[p.loader], p.bm, p.bn,
             p.ctas, dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    # Temporaries freed on return are reused only by later work on this
    # stream, which runs after the kernel.
    if err:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err}")
    launches += 1
    if k == 3:
        launches_conv3 += 1
    else:
        launches_mm += 1
    if emit == "int8":
        return out_q
    return out_tap if emit == "f32" else (out_q, out_tap)


# --------------------------------------------------------- full backbone


@torch.inference_mode()
def apply_int8_kernels(qp, feats: torch.Tensor, head_dtype=torch.bfloat16):
    """Int8 post-stem forward with every conv through :func:`int8_conv`:
    same contract as ``quant.apply_int8``.

    feats ``[B,150,150,64]`` (from the stem) -> ``(loc [B,8732,4] f32, cls
    [B,8732,C] f32)``.  Tap layers with a successor emit the head-dtype tap
    and the requantized int8 input of the next layer from one pass; the
    last layer emits the tap alone; every other layer requantizes in the
    kernel, so activations between layers stay int8.  Pools run on int8;
    the heads are one fused conv per tap in ``head_dtype``.
    """
    topo = quant._TOPOLOGY
    taps = [None] * 6
    xq = quant._quantize_act(feats.float(), qp.layers[topo[0].name].in_scale)
    for i, spec in enumerate(topo):
        ql = qp.layers[spec.name]
        nxt = topo[i + 1] if i + 1 < len(topo) else None
        kw = dict(stride=spec.stride, dilation=spec.dilation, pad=spec.pad)
        if nxt is None:
            taps[spec.tap] = int8_conv(xq, ql.kernel_q, ql.w_scale, ql.bias, emit="f32",
                                       tap_dtype=head_dtype, **kw)
            break
        next_scale = qp.layers[nxt.name].in_scale
        if spec.tap is not None:
            xq, taps[spec.tap] = int8_conv(xq, ql.kernel_q, ql.w_scale, ql.bias, next_scale,
                                           emit="both", tap_dtype=head_dtype, **kw)
        else:
            xq = int8_conv(xq, ql.kernel_q, ql.w_scale, ql.bias, next_scale, emit="int8", **kw)
        if spec.pool:
            xq = quant._max_pool(xq, ceil=spec.pool == "ceil")
    return quant.run_heads(qp, taps)


# ------------------------------------------------------------ bare matmuls


def int8_mm_raw_ref(a, b_t):
    """Plain int8 matmul ``a [M,K] @ b_t [N,K]^T`` -> int32, exact: a
    float64 matmul of integers far below 2^53."""
    return (a.double() @ b_t.double().t()).to(torch.int32)


def bf16_mm_raw_ref(a, b_t):
    """Plain bf16 matmul with float32 accumulation -> float32."""
    return a.float() @ b_t.float().t()


def _check_mm_raw(a, b_t, dtype, name):
    if a.dtype != dtype or b_t.dtype != dtype or b_t.device != a.device:
        raise ValueError(f"{name} takes two {dtype} matrices on one device")
    if a.dim() != 2 or b_t.dim() != 2:
        raise ValueError(f"{name}: a [M,K] and b_t [N,K], got {tuple(a.shape)} and "
                         f"{tuple(b_t.shape)}")
    (M, K), (N, K2) = a.shape, b_t.shape
    kmul = 16 // a.element_size()
    if min(M, N, K) < 1 or K != K2 or K % kmul or N % 16:
        raise ValueError(f"{name}: a [M,K] and b_t [N,K] with K a multiple of {kmul} and "
                         f"N of 16, got {tuple(a.shape)} and {tuple(b_t.shape)}")


def _mm_raw(a, b_t, dtype, out_dtype, ref, name):
    global launches_raw
    dev = a.device
    if dev.type == "cpu":
        return ref(a, b_t)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check_mm_raw(a, b_t, dtype, name)
    a, b_t = gemm.aligned(a), gemm.aligned(b_t)
    out = torch.empty((a.shape[0], b_t.shape[0]), dtype=out_dtype, device=dev)
    gemm.nt(a, b_t, out)
    launches_raw += 1
    return out


def int8_mm_raw(a, b_t):
    """``a [M,K] int8 @ b_t [N,K]^T int8 -> [M,N] int32`` on the int8 tensor
    cores (``wgmma``): the kernel takes any M, N a multiple of 16, K of 16.
    CPU tensors take :func:`int8_mm_raw_ref`."""
    return _mm_raw(a, b_t, torch.int8, torch.int32, int8_mm_raw_ref, "int8_mm_raw")


def bf16_mm_raw(a, b_t):
    """``a [M,K] bf16 @ b_t [N,K]^T bf16 -> [M,N] float32``: the same kernel
    on the bf16 tensor cores, the control beside :func:`int8_mm_raw`, with
    K a multiple of 8.  CPU tensors take :func:`bf16_mm_raw_ref`."""
    return _mm_raw(a, b_t, torch.bfloat16, torch.float32, bf16_mm_raw_ref, "bf16_mm_raw")
