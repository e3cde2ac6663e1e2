"""The train-mode stem: conv1_1 + BN + ReLU + conv1_2 + BN + ReLU + 2x2 pool,
with batch-statistics BatchNorm and its own backward.

``stem_train`` turns ``[B,300,300,3]`` images into the pooled
``[B,150,150,64]`` map that ``SSD300.forward(p, train=True,
stem_input=True)`` takes, and returns both BNs' biased batch statistics for
the caller's running-average update.  On a CUDA tensor it runs
:class:`StemTrain`, whose forward and backward launch the hand-written
kernels of ``csrc/stem_train.cu`` (the source's header gives the launches,
the bound and the design).  On a CPU tensor it runs :class:`StemTrainRef`,
the plain PyTorch version, which is also the kernel's oracle on the card.
It replaces the JAX package's TPU kernel
``ssdx/ops/pallas_stem_train.py::stem_train``.

Contract (both versions; ``r()`` rounds to ``dtype``):
  * x, w1, b1 and w2 are rounded to ``dtype``; b2 stays float32;
  * y1 = r(conv1_1(x) + b1); its statistics are one-pass
    ``E[y^2] - E[y]^2`` clamped at 0, in float32, n = B*300*300;
  * y1n = r(relu(y1*a1 + c1)) with a = gamma*inv, c = beta - mean*gamma*inv;
  * y2 = r(conv1_2(y1n) + b2), statistics likewise;
  * p = r(maxpool(relu(y2*a2 + c2)));
  * backward from dp only (the statistics' cotangents are zero by
    contract): pool routing recomputed from y2, only positive maxima take
    gradient and tied maxima split it evenly; dt2 = r(.) with the BN2 sums
    taken before rounding; dy2 = r(BN2 backward); dt1 = conv1_2^T(dy2) *
    [t1 > 0] = r(.) with the BN1 sums before rounding; dy1 = r(BN1
    backward); dW2 = sum y1n^T dy2, dW1 = sum patches^T dy1;
  * dx, db1 and db2 are exact zeros (train-mode BN subtracts the batch
    mean, so the conv biases cannot move the output).

Under a ``mesh`` (:mod:`ssdx_torch.mesh`; the JAX kernel's ``axis_name``)
``x`` is this rank's shard of the global batch: the per-channel sums of both
BNs are all-reduced between the launches and ``n`` counts the global batch,
so the statistics are the global batch's on every rank.  The backward uses
the all-reduced BN sums inside dy2 and dy1 and returns this rank's *local*
sums as dgamma and dbeta, and local dW1 and dW2: the train step's gradient
all-reduce adds them up over the ranks.

Weights are PyTorch's OIHW; images and the pooled map are NHWC.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..mesh import all_reduce_sum
from . import _build
from .pool import sm_count
from .stem import grid_size, w1_operand

__all__ = ["stem_train", "stem_train_ref", "stem_train_reference_params", "pool_routing_ref",
           "StemTrain", "StemTrainRef", "launches"]

launches = 0  # forwards of stem_train that launched the kernels

_H, _C = 300, 64
_lib = None


# ------------------------------------------------------------ plain version


def _r(t, dtype):
    """Round to ``dtype``, compute on in float32."""
    return t.to(dtype).float()


def _col(v):
    return v[None, :, None, None]


def _global_n(B, mesh):
    """Pixels per channel of the global batch (every rank holds ``B`` images)."""
    return B * _H * _H * (1 if mesh is None else mesh.size)


def _batch_stats(y, n, eps, mesh=None):
    """(mean, biased var, rsqrt(var + eps)) of NCHW ``y`` over N, H, W, and
    over the ranks of ``mesh``."""
    sums = all_reduce_sum(torch.cat([y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))]), mesh)
    return _stats_from_sums(sums, n, eps)


def _affine(g, be, mean, inv):
    return g * inv, be - mean * g * inv


def _ref_forward(x, w1, b1, g1, be1, w2, b2, g2, be2, eps, dtype, mesh=None):
    n = _global_n(x.shape[0], mesh)
    xin = _r(x.permute(0, 3, 1, 2), dtype)
    y1 = _r(F.conv2d(xin, _r(w1, dtype), _r(b1, dtype), padding=1), dtype)
    mean1, var1, inv1 = _batch_stats(y1, n, eps, mesh)
    a1, c1 = _affine(g1, be1, mean1, inv1)
    y1n = _r(F.relu(y1 * _col(a1) + _col(c1)), dtype)
    y2 = _r(F.conv2d(y1n, _r(w2, dtype), b2.float(), padding=1), dtype)
    mean2, var2, inv2 = _batch_stats(y2, n, eps, mesh)
    a2, c2 = _affine(g2, be2, mean2, inv2)
    p = F.max_pool2d(F.relu(y2 * _col(a2) + _col(c2)), 2).to(dtype)
    return p.permute(0, 2, 3, 1).contiguous(), (mean1, var1, inv1, mean2, var2, inv2), y1, y2


def _global_sums(s1, s2, mesh):
    """The BN backward's two sums over every rank's shard; the local ones
    stay the returned dbeta and dgamma."""
    if mesh is None:
        return s1, s2
    both = all_reduce_sum(torch.cat([s1, s2]), mesh)
    return both[:_C], both[_C:]


def _up(t):
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def pool_routing_ref(t, dp):
    """Backward of the 2x2/2 max pool of ``t`` (NCHW, >= 0) for the pooled
    cotangent ``dp`` (NCHW): only positive maxima take gradient, and tied
    maxima split it evenly."""
    pmax = _up(F.max_pool2d(t, 2))
    hit = (t == pmax) & (pmax > 0)
    cnt = F.avg_pool2d(hit.float(), 2) * 4.0
    return torch.where(hit, _up(dp.float() / torch.clamp(cnt, min=1.0)), 0.0)


def _ref_backward(dp, x, w1, w2, g1, be1, g2, be2, y1, y2, stats, dtype, mesh=None):
    mean1, var1, inv1, mean2, var2, inv2 = stats
    n = _global_n(x.shape[0], mesh)
    y1, y2 = y1.float(), y2.float()
    a1, c1 = _affine(g1, be1, mean1, inv1)
    a2, c2 = _affine(g2, be2, mean2, inv2)

    dt2 = pool_routing_ref(F.relu(y2 * _col(a2) + _col(c2)), dp.permute(0, 3, 1, 2))
    xh2 = (y2 - _col(mean2)) * _col(inv2)
    s1_2, s2_2 = dt2.sum((0, 2, 3)), (dt2 * xh2).sum((0, 2, 3))  # this rank's
    s1_2g, s2_2g = _global_sums(s1_2, s2_2, mesh)
    dy2 = _r(_col(g2 * inv2) * (_r(dt2, dtype) - (_col(s1_2g / n) + xh2 * _col(s2_2g / n))),
             dtype)

    w2r = _r(w2, dtype)
    dy1n = torch.nn.grad.conv2d_input(y1.shape, w2r, dy2, padding=1)
    dt1 = torch.where(y1 * _col(a1) + _col(c1) > 0, dy1n, 0.0)
    xh1 = (y1 - _col(mean1)) * _col(inv1)
    s1_1, s2_1 = dt1.sum((0, 2, 3)), (dt1 * xh1).sum((0, 2, 3))
    s1_1g, s2_1g = _global_sums(s1_1, s2_1, mesh)
    dy1 = _r(_col(g1 * inv1) * (_r(dt1, dtype) - (_col(s1_1g / n) + xh1 * _col(s2_1g / n))),
             dtype)

    y1n = _r(F.relu(y1 * _col(a1) + _col(c1)), dtype)
    dw2 = torch.nn.grad.conv2d_weight(y1n, w2.shape, dy2, padding=1)
    xin = _r(x.permute(0, 3, 1, 2), dtype)
    dw1 = torch.nn.grad.conv2d_weight(xin, w1.shape, dy1, padding=1)
    return dw1, s2_1, s1_1, dw2, s2_2, s1_2


# ------------------------------------------------------- autograd plumbing


def _save(ctx, x, keep, bn, y1, y2, stats, eps, dtype):
    ctx.save_for_backward(*keep, *bn, y1, y2, *stats)
    ctx.nkeep, ctx.eps, ctx.dtype = len(keep), eps, dtype
    ctx.x_meta = (x.shape, x.dtype)
    mean1, var1, _, mean2, var2, _ = stats
    ctx.mark_non_differentiable(mean1, var1, mean2, var2)
    return mean1, var1, mean2, var2


def _unsave(ctx):
    s, k = ctx.saved_tensors, ctx.nkeep
    return s[:k], s[k:k + 4], s[k + 4], s[k + 5], s[k + 6:]


def _grads(ctx, dp, dw1, dg1, dbe1, dw2, dg2, dbe2):
    """Gradients of (x, w1, b1, g1, be1, w2, b2, g2, be2, eps, dtype, mesh)."""
    zeros = lambda: torch.zeros(_C, dtype=torch.float32, device=dp.device)
    dx = None
    if ctx.needs_input_grad[0]:
        dx = torch.zeros(ctx.x_meta[0], dtype=ctx.x_meta[1], device=dp.device)
    return dx, dw1, zeros(), dg1, dbe1, dw2, zeros(), dg2, dbe2, None, None, None


class StemTrainRef(torch.autograd.Function):
    """The plain version: every step a PyTorch op in float32 on values
    rounded to ``dtype`` where the contract rounds."""

    @staticmethod
    def forward(ctx, x, w1, b1, g1, be1, w2, b2, g2, be2, eps, dtype, mesh=None):
        bn = tuple(t.float() for t in (g1, be1, g2, be2))
        ctx.mesh = mesh
        p, stats, y1, y2 = _ref_forward(x, w1, b1, *bn[:2], w2, b2, *bn[2:], eps, dtype, mesh)
        return (p, *_save(ctx, x, (x, w1, w2), bn, y1.to(dtype), y2.to(dtype), stats, eps,
                          dtype))

    @staticmethod
    def backward(ctx, dp, *_stat_cotangents):
        (x, w1, w2), (g1, be1, g2, be2), y1, y2, stats = _unsave(ctx)
        grads = _ref_backward(dp, x, w1, w2, g1, be1, g2, be2, y1, y2, stats, ctx.dtype,
                              ctx.mesh)
        return _grads(ctx, dp, *grads)


def stem_train_ref(x, w1, b1, g1, be1, w2, b2, g2, be2, eps=1e-5, dtype=torch.bfloat16,
                   mesh=None):
    """The plain version, on any device: ``(p, mean1, var1, mean2, var2)``."""
    return StemTrainRef.apply(x, w1, b1, g1, be1, w2, b2, g2, be2, eps, dtype, mesh)


# ------------------------------------------------------------- kernel route


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("stem_train")
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
        sigs = {
            "ssdx_st_conv1": [P, P, P, P, P, I, I, S],
            "ssdx_st_stage2": [I, P, P, P, P, P, P, P, P, I, I, S],
            "ssdx_st_pool": [P, P, P, I, I, S],
            "ssdx_st_route": [P, P, P, P, P, I, I, S],
            "ssdx_st_dw2": [P, P, P, I, I, S],
            "ssdx_st_dw1": [P, P, P, P, P, I, I, S],
            "ssdx_st_colsum": [P, I, I, P, S],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _lib = lib
    return _lib


def _launch(name, *args):
    """Call one C entry on the current stream; tensors go in as pointers."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(_kernel(), name)(*conv, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"stem_train kernel {name} failed: CUDA error {err}")


def _colsum(part):
    """Fixed-order sum of the partial rows ``[n, K]`` -> ``[K]`` (a kernel)."""
    out = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    _launch("ssdx_st_colsum", part, part.shape[0], part.shape[1], out)
    return out


def _vec(rows, dev):
    """Per-channel vectors as the ``[16, 64]`` float32 block the kernels read."""
    return F.pad(torch.stack([r.float() for r in rows]), (0, 0, 0, 16 - len(rows)))


def _stats_from_sums(sums, n, eps):
    mean = sums[:_C] / n
    var = torch.clamp(sums[_C:] / n - mean * mean, min=0.0)
    return mean, var, torch.rsqrt(var + eps)


def _empty(shape, dtype, dev):
    return torch.empty(shape, dtype=dtype, device=dev)


def _kernel_forward(x, w1, b1, g1, be1, w2, b2, g2, be2, eps, mesh=None):
    bf, f32, dev = torch.bfloat16, torch.float32, x.device
    B, sms = x.shape[0], sm_count(dev)
    n = _global_n(B, mesh)
    xb = x.detach().to(bf).contiguous()
    w1p = w1_operand(w1.detach())
    b1p = b1.detach().to(bf).float().contiguous()
    w2p = w2.detach().to(bf).permute(0, 2, 3, 1).reshape(_C, 9 * _C).contiguous()  # [co][tap*64+ci]

    y1 = _empty((B, _H, _H, _C), bf, dev)
    grid = grid_size(B, sms)
    part = _empty((grid, 2 * _C), f32, dev)
    _launch("ssdx_st_conv1", xb, w1p, b1p, y1, part, B, grid)
    mean1, var1, inv1 = _stats_from_sums(all_reduce_sum(_colsum(part), mesh), n, eps)
    a1, c1 = _affine(g1, be1, mean1, inv1)

    y2, y1n = _empty((B, _H, _H, _C), bf, dev), _empty((B, _H, _H, _C), bf, dev)
    grid = grid_size(B, sms)
    part = _empty((grid, 2 * _C), f32, dev)
    _launch("ssdx_st_stage2", 0, y1, None, w2p, _vec([a1, c1, b2.detach()], dev), None,
            y2, y1n, part, B, grid)
    mean2, var2, inv2 = _stats_from_sums(all_reduce_sum(_colsum(part), mesh), n, eps)
    a2, c2 = _affine(g2, be2, mean2, inv2)

    p = _empty((B, _H // 2, _H // 2, _C), bf, dev)
    _launch("ssdx_st_pool", y2, _vec([a2, c2], dev), p, B, 16 * sms)
    return p, (mean1, var1, inv1, mean2, var2, inv2), y1, y2, xb, y1n


def _kernel_backward(dp, xb, w2, y1n, g1, be1, g2, be2, y1, y2, stats, mesh=None):
    mean1, var1, inv1, mean2, var2, inv2 = stats
    bf, f32, dev = torch.bfloat16, torch.float32, dp.device
    B, sms = dp.shape[0], sm_count(dev)
    n = _global_n(B, mesh)
    a1, c1 = _affine(g1, be1, mean1, inv1)
    a2, c2 = _affine(g2, be2, mean2, inv2)
    dpb = dp.to(bf).contiguous()

    # D: pool routing -> dt2, BN2 sums
    dt2 = _empty(y2.shape, bf, dev)
    grid = 4 * sms
    part = _empty((grid, 2 * _C), f32, dev)
    _launch("ssdx_st_route", y2, dpb, _vec([a2, c2, inv2, mean2], dev), dt2, part, B, grid)
    sums = _colsum(part)
    s1_2, s2_2 = sums[:_C], sums[_C:]  # this rank's: the returned dbeta2, dgamma2
    s1_2g, s2_2g = _global_sums(s1_2, s2_2, mesh)

    # E: BN2 backward (dy2, kept for dW2), conv1_2^T, ReLU mask -> dt1, BN1 sums
    # [ci][dr'][dc'][co] = w2[co][ci][2-dr'][2-dc']
    w2t = w2.detach().to(bf).flip(2, 3).permute(1, 2, 3, 0).reshape(_C, 9 * _C).contiguous()
    dt1, dy2 = _empty(y1.shape, bf, dev), _empty(y1.shape, bf, dev)
    grid = grid_size(B, sms)
    part = _empty((grid, 2 * _C), f32, dev)
    vec_e = _vec([g2 * inv2, mean2, inv2, s1_2g / n, s2_2g / n, a1, c1, mean1, inv1], dev)
    _launch("ssdx_st_stage2", 1, dt2, y2, w2t, vec_e, y1, dt1, dy2, part, B, grid)
    sums = _colsum(part)
    s1_1, s2_1 = sums[:_C], sums[_C:]
    s1_1g, s2_1g = _global_sums(s1_1, s2_1, mesh)

    # dW2: split-K over conv tiles, one slice per SM
    grid = grid_size(B, sms)
    part = _empty((grid, 9 * _C * _C), f32, dev)
    _launch("ssdx_st_dw2", y1n, dy2, part, B, grid)
    del dy2
    dw2 = _colsum(part).view(3, 3, _C, _C).permute(3, 2, 0, 1).contiguous()

    # F: BN1 backward and dW1, split-K over conv tiles, one slice per SM
    grid = grid_size(B, sms)
    part = _empty((grid, 27 * _C), f32, dev)
    vec_f = _vec([g1 * inv1, mean1, inv1, s1_1g / n, s2_1g / n], dev)
    _launch("ssdx_st_dw1", xb, y1, dt1, vec_f, part, B, grid)
    dw1 = _colsum(part).view(3, 3, 3, _C).permute(3, 2, 0, 1).contiguous()
    return dw1, s2_1, s1_1, dw2, s2_2, s1_2


class StemTrain(torch.autograd.Function):
    """The kernel route: the forward launches conv1_stats, stage2<0> and pool,
    the backward route, stage2<1>, dw2 and dw1 (csrc/stem_train.cu), with
    fixed-order colsum reductions between them."""

    @staticmethod
    def forward(ctx, x, w1, b1, g1, be1, w2, b2, g2, be2, eps, dtype, mesh=None):
        bn = tuple(t.detach().float() for t in (g1, be1, g2, be2))
        ctx.mesh = mesh
        p, stats, y1, y2, xb, y1n = _kernel_forward(x, w1, b1, *bn[:2], w2, b2, *bn[2:], eps,
                                                    mesh)
        return (p, *_save(ctx, x, (xb, w2, y1n), bn, y1, y2, stats, eps, dtype))

    @staticmethod
    def backward(ctx, dp, *_stat_cotangents):
        (xb, w2, y1n), (g1, be1, g2, be2), y1, y2, stats = _unsave(ctx)
        grads = _kernel_backward(dp, xb, w2, y1n, g1, be1, g2, be2, y1, y2, stats, ctx.mesh)
        return _grads(ctx, dp, *grads)


def stem_train_reference_params(params):
    """``(w1, b1, g1, be1, w2, b2, g2, be2)`` from an ``SSD300`` state dict
    (or its ``named_parameters()`` as a dict): conv1_1's and conv1_2's OIHW
    kernels and biases and their BN scales and shifts, in
    :func:`stem_train`'s argument order."""
    return tuple(params[f"layers.{i}.{k}"] for i in (0, 1)
                 for k in ("conv.weight", "conv.bias", "bn.weight", "bn.bias"))


def stem_train(x, w1, b1, g1, be1, w2, b2, g2, be2, eps=1e-5, dtype=torch.bfloat16,
               mesh=None):
    """``[B,300,300,3]`` images -> ``(p [B,150,150,64], mean1, var1, mean2,
    var2)``, differentiable in the weights and BN parameters.

    CPU tensors take the plain version; CUDA tensors take the kernels, which
    compute in bfloat16 only.  With a ``mesh``, ``x`` is this rank's shard and
    the statistics are the global batch's (see the module docstring).
    """
    global launches
    dev = x.device
    args = (x, w1, b1, g1, be1, w2, b2, g2, be2)
    if dev.type == "cpu":
        return StemTrainRef.apply(*args, eps, dtype, mesh)
    if dev.type != "cuda":
        raise ValueError(f"stem_train: unsupported device {dev}")
    if dtype != torch.bfloat16:
        raise ValueError(f"the stem_train kernels compute in bfloat16, not {dtype}")
    if x.dim() != 4 or tuple(x.shape[1:]) != (_H, _H, 3) or x.shape[0] < 1:
        raise ValueError(f"stem_train takes [B,300,300,3], got {tuple(x.shape)}")
    shapes = [tuple(t.shape) for t in args[1:]]
    want = [(_C, 3, 3, 3)] + [(_C,)] * 3 + [(_C, _C, 3, 3)] + [(_C,)] * 3
    if shapes != want:
        raise ValueError(f"stem_train weights must be {want}; got {shapes}")
    if any(t.device != dev for t in args[1:]):
        raise ValueError("stem_train: images and weights must share a device")
    out = StemTrain.apply(*args, eps, dtype, mesh)
    launches += 1
    return out
