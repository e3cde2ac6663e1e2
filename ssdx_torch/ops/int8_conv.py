"""Int8 convolutions of the quantized serving path, and the int8 matmul probe.

``int8_conv`` is one quantized conv layer: int8 x int8 -> int32, then
``relu(acc * w_scale + bias)``, then requantization to the next layer's
per-channel int8 grid (a multiply by the reciprocal scale, round half to
even, clip to +-127) and/or the float tap that feeds the bf16 heads.  On a
CUDA tensor it launches the hand-written kernels of ``csrc/int8_conv.cu``
(an implicit GEMM on the int8 tensor cores with the epilogue fused; the
source's header gives bound and design): the 3x3 kernel for 3x3 layers of
any stride, dilation and padding, the matmul kernel for 1x1 layers.  On a
CPU tensor it runs :func:`int8_conv_ref`, the plain PyTorch version, which
is also the kernels' oracle on the card.  It replaces the JAX package's
TPU kernels ``ssdx/ops/pallas_int8_conv.py::int8_conv`` (``_conv3_kernel``
and ``_mm_kernel``); ``apply_int8_kernels`` is the counterpart of
``apply_int8_pallas`` there.

``int8_mm_raw`` and ``bf16_mm_raw`` are bare matmuls (int8 -> int32 and
bf16 -> f32), the counterpart of ``scripts/bench_int8_mxu.py::_pallas_mm``.
They launch the TMA + wgmma kernels of ``csrc/gemm_sm90.cu`` (through
``ops/gemm.py``), not this module's conv kernels;
``ssdx_torch/tools/bench_int8_mm.py`` times them.

Layouts: activations NHWC ``[B,H,W,C]``; ``kernel_q`` int8 of logical
shape OIHW (``ssdx_torch/quant.py``), read as ``[cout][kh][kw][cin]``; the
matmuls take ``a [M,K]`` and ``b_t [N,K]``, both with K contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from .. import quant
from . import _build, gemm

__all__ = ["int8_conv", "int8_conv_ref", "apply_int8_kernels", "int8_mm_raw",
           "int8_mm_raw_ref", "bf16_mm_raw", "bf16_mm_raw_ref", "launches",
           "launches_conv3", "launches_mm", "launches_raw"]

launches = 0  # kernel launches by int8_conv: launches_conv3 + launches_mm
launches_conv3 = 0  # ... of the 3x3 kernel
launches_mm = 0  # ... of the 1x1 matmul kernel
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


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("int8_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ssdx_int8_conv3, lib.ssdx_int8_mm):
            # x, w, w_scale, bias, inv_ns, out_q, out_tap, B, H, W, Cin, Cout,
            # Ho, Wo, stride, dilation, pad, tap_kind, stream
            fn.argtypes = [p] * 7 + [i] * 11 + [p]
            fn.restype = i
        _lib = lib
    return _lib


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

    CPU tensors take the plain version; CUDA tensors take the kernels, which
    need ``cin`` and ``cout`` to be multiples of 16.
    """
    global launches, launches_conv3, launches_mm
    dev = xq.device
    kw = dict(stride=stride, dilation=dilation, pad=pad, emit=emit, tap_dtype=tap_dtype)
    if dev.type == "cpu":
        return int8_conv_ref(xq, kernel_q, w_scale, bias, next_in_scale, **kw)
    if dev.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {dev}")
    _check_emit(emit, next_in_scale)
    if xq.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise ValueError(f"int8_conv takes int8 operands, got {xq.dtype}, {kernel_q.dtype}")
    B, H, W, cin = xq.shape
    cout, cin_w, k, k2 = kernel_q.shape
    if cin_w != cin or k != k2 or k not in (1, 3):
        raise ValueError(f"int8_conv: kernel {tuple(kernel_q.shape)} does not fit "
                         f"input {tuple(xq.shape)} (1x1 or 3x3, OIHW)")
    if cin % 16 or cout % 16:
        raise ValueError(f"the int8 kernels need cin and cout to be multiples of 16, "
                         f"got {cin} and {cout}")
    if k == 1 and (stride != 1 or dilation != 1 or pad != 0):
        raise ValueError("the 1x1 kernel is a plain matmul: stride 1, no padding")
    if tap_dtype not in _TAP_KIND:
        raise ValueError(f"tap_dtype must be float32 or bfloat16, got {tap_dtype}")
    vecs = [w_scale, bias] + ([] if next_in_scale is None else [next_in_scale])
    if any(t.device != dev for t in [kernel_q] + vecs):
        raise ValueError("int8_conv: input, kernel and scales must share a device")
    if any(tuple(t.shape) != (cout,) for t in vecs):
        raise ValueError(f"int8_conv: w_scale, bias and next_in_scale must be [{cout}]")
    Ho, Wo = (_out_size(n, k, stride, dilation, pad) for n in (H, W))
    if min(B, Ho, Wo) < 1:
        raise ValueError(f"int8_conv: empty output for input {tuple(xq.shape)}")

    x = xq.contiguous()
    w = kernel_q.permute(0, 2, 3, 1).contiguous()  # [cout][kh][kw][cin]
    ws, b = w_scale.float().contiguous(), bias.float().contiguous()
    inv = None if next_in_scale is None else torch.reciprocal(next_in_scale.float()).contiguous()
    out_q = out_tap = None
    if emit != "f32":
        out_q = torch.empty((B, Ho, Wo, cout), dtype=torch.int8, device=dev)
    if emit != "int8":
        out_tap = torch.empty((B, Ho, Wo, cout), dtype=tap_dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernel()
    fn = lib.ssdx_int8_conv3 if k == 3 else lib.ssdx_int8_mm
    with torch.cuda.device(dev):
        err = fn(ptr(x), ptr(w), ptr(ws), ptr(b), ptr(inv), ptr(out_q), ptr(out_tap),
                 B, H, W, cin, cout, Ho, Wo, stride, dilation, pad,
                 0 if out_tap is None else _TAP_KIND[tap_dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
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
    return quant.run_heads(qp, taps, head_dtype)


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
