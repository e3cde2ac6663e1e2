"""Train-mode BatchNorm + ReLU + 2x2/2 max pool on NHWC, with its own backward.

``bn_relu_pool(x, gamma, beta)`` returns ``(p, mean, var)``: the pooled map
and the biased batch statistics for the caller's running-average update.
On a CUDA tensor it runs :class:`BnReluPool`, whose forward and backward
launch the hand-written kernels of ``csrc/bn_relu_pool.cu`` (four passes of
one persistent kernel that streams tiles of x through shared memory by bulk
copies, and two small kernels that add their partial sums in a fixed order
and do the per-channel arithmetic; the source's header gives the bound and
the design, :func:`tiles` the tile geometry).
On a CPU tensor it runs :class:`BnReluPoolRef`, the plain PyTorch version,
which is also the kernels' oracle on the card.  It replaces the JAX package's
``ssdx/ops/fused_bn_pool.py::bn_relu_pool`` and its Pallas passes; that
function's ``backend`` argument is not carried over: the device of ``x``
chooses.

Contract (both versions; float32 throughout, float64 for float64 inputs):
  * mean = E[x], var = max(E[x^2] - E[x]^2, 0) over B, H, W in one pass
    (biased variance), returned in float32;
  * inv = rsqrt(var + eps), a = gamma*inv, b = beta - mean*a;
  * y = relu(x*a + b) with the product and the sum rounded separately (no
    fused multiply-add), never stored; p = the window's maximum, rounded
    once to ``x``'s type.  This is the Pallas path of the JAX function; its
    XLA path computes y in the input type;
  * windows: floor mode drops an odd last row or column from the pool (it
    stays in the statistics); ``ceil=True`` pools it with positions past the
    edge at -inf, as PyTorch's ``ceil_mode`` does;
  * backward, from the cotangents of all three outputs (a missing one counts
    as zeros): the pooled cotangent goes to the positions whose y equals the
    window's maximum where that maximum is > 0 (ReLU's subgradient at 0 is
    0); tied positions split it evenly, or each take all of it with
    ``tie_split=False``; the routed dy stays in float32;
    s1 = sum dy = dbeta, s2 = sum dy*xhat = dgamma, xhat = (x - mean)*inv;
    dx = gamma*inv*(dy - (s1 + xhat*s2)/n) + gmean/n + gvar*(2/n)*(x - mean),
    rounded once to ``x``'s type;
  * the kernels take bfloat16 and float32 with ``C % 8 == 0`` and
    ``C <= 2048``; their sums have a fixed order, so two runs agree bit for
    bit.
"""
from __future__ import annotations

import ctypes

import torch

from .pool import _DTYPES, _aligned, _compute_dtype, bind, check_nhwc, launch, sm_count
from .pool import route, unwindows, windows

__all__ = ["bn_relu_pool", "bn_relu_pool_ref", "BnReluPool", "BnReluPoolRef", "tiles",
           "launches", "launches_bwd"]

launches = 0      # forwards of bn_relu_pool that launched stats + apply
launches_bwd = 0  # backwards that launched reduce + dx

_MAX_C = 2048
_CONSUMERS = 256   # csrc/bn_relu_pool.cu kConsumers: threads that read the tiles
_BLOCKS_PER_SM = 2  # the pipeline kernel's __launch_bounds__
_lib = None


# ------------------------------------------------------------ plain version


def _stats(xf):
    mean = xf.mean(dim=(0, 1, 2))
    var = torch.clamp((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
    return mean, var


def _affine(gamma, beta, mean, var, eps):
    inv = torch.rsqrt(var + eps)
    a = gamma * inv
    return inv, a, beta - mean * a


def _ref_forward(x, gamma, beta, eps, ceil):
    ct = _compute_dtype(x.dtype)
    xf = x.to(ct)
    mean, var = _stats(xf)
    _, a, b = _affine(gamma.to(ct), beta.to(ct), mean, var, eps)
    y = torch.relu(xf * a + b)
    p = windows(y, ceil, float("-inf")).amax(dim=(2, 4))
    return p.to(x.dtype), mean, var


def _ref_backward(x, gamma, beta, mean, var, eps, ceil, tie_split, gp, gmean, gvar):
    ct = _compute_dtype(x.dtype)
    B, H, W, C = x.shape
    n = B * H * W
    xf, gamma, beta = x.to(ct), gamma.to(ct), beta.to(ct)
    inv, a, b = _affine(gamma, beta, mean, var, eps)
    win = windows(torch.relu(xf * a + b), ceil, float("-inf"))
    pmax = win.amax(dim=(2, 4), keepdim=True)
    dy = unwindows(route(win, pmax, gp.to(ct), pmax > 0, tie_split), H, W)
    xhat = (xf - mean) * inv
    s1 = dy.sum(dim=(0, 1, 2))
    s2 = (dy * xhat).sum(dim=(0, 1, 2))
    dx = (gamma * inv) * (dy - (s1 / n + xhat * (s2 / n)))
    dx = dx + gmean.to(ct) / n + gvar.to(ct) * (2.0 / n) * (xf - mean)
    return dx.to(x.dtype), s2, s1


class BnReluPoolRef(torch.autograd.Function):
    """The plain version: every step a PyTorch op."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, ceil, tie_split):
        p, mean, var = _ref_forward(x, gamma, beta, eps, ceil)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.cfg = (eps, ceil, tie_split)
        return p, mean, var

    @staticmethod
    def backward(ctx, gp, gmean, gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = _ref_backward(x, gamma, beta, mean, var, *ctx.cfg, gp, gmean, gvar)
        return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None, None


def bn_relu_pool_ref(x, gamma, beta, eps: float = 1e-5, ceil: bool = False,
                     tie_split: bool = True):
    """The plain version, on any device: ``(p, mean, var)``."""
    return BnReluPoolRef.apply(x, gamma, beta, eps, ceil, tie_split)


# ------------------------------------------------------------- kernel route


def _kernel():
    global _lib
    if _lib is None:
        P, I, Fl, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        Geo = ctypes.POINTER(ctypes.c_int)
        _lib = bind("bn_relu_pool", {
            "ssdx_brp_stats": [P, P, Geo, I, I, S],
            "ssdx_brp_stats_finalize": [P, I, I, Fl, Fl, P, P, P, P, P, S],
            "ssdx_brp_apply": [P, P, P, Geo, I, I, S],
            "ssdx_brp_reduce": [P, P, P, P, Geo, I, I, I, S],
            "ssdx_brp_reduce_finalize": [P, I, I, Fl, P, P, P, P, S],
            "ssdx_brp_dx": [P, P, P, P, P, Geo, I, I, I, S],
        })
    return _lib


def _launch(name, *args):
    launch(_kernel(), name, *args)


def _pooled(H, W, ceil):
    return ((H + 1) // 2, (W + 1) // 2) if ceil else (H // 2, W // 2)


def tiles(B: int, H: int, W: int, C: int, ceil: bool, mode: str) -> dict:
    """The tile geometry of one pass of the pipeline kernel.

    A band is the input rows 2P and 2P + 1 of one image; a tile is ``tw``
    columns of a band (``nq`` tiles a band, the last one ragged), in which
    consumer thread (slot, cg) takes window ``slot`` and channels 8*cg ..
    8*cg + 7: ``G = C/8`` channel groups, ``slots = 256 // G`` windows, so
    a tile row holds ``tw * C <= 4096`` elements.  stats and dx walk all
    (H+1)/2 bands of an image (every pixel); apply and reduce the Hp pooled
    ones, none where no window is pooled.  stats and reduce write one partial
    row per band.
    """
    if mode not in ("stats", "apply", "reduce", "dx"):
        raise ValueError(mode)
    Hp, Wp = _pooled(H, W, ceil)
    G = C // 8
    slots = _CONSUMERS // G
    tw = 2 * slots
    if mode in ("stats", "dx"):
        bands = (H + 1) // 2
    else:
        bands = Hp if Wp > 0 else 0
    return dict(B=B, H=H, W=W, C=C, Hp=Hp, Wp=Wp, G=G, slots=slots, tw=tw,
                nq=-(-W // tw), bands=bands, nbands=B * bands)


_GEO = ("B", "H", "W", "C", "Hp", "Wp", "G", "slots", "tw", "nq", "bands", "nbands")


def _geo(t: dict):
    return (ctypes.c_int * len(_GEO))(*(t[k] for k in _GEO))


def _grid(t: dict, dev) -> int:
    """Persistent blocks: two an SM, never more than there are bands."""
    return min(t["nbands"], _BLOCKS_PER_SM * sm_count(dev))


def _kernel_forward(x, gamma, beta, eps, ceil):
    """``(p, mean, var, vec)``; ``vec`` ``[4,C]`` holds a, b, inv and mean for
    the backward."""
    f32, dev = torch.float32, x.device
    B, H, W, C = x.shape
    n = B * H * W
    dt = _DTYPES[x.dtype]
    t = tiles(B, H, W, C, ceil, "stats")
    part = torch.empty((t["nbands"], 2 * C), dtype=f32, device=dev)
    _launch("ssdx_brp_stats", x, part, _geo(t), dt, _grid(t, dev))
    mean, var = torch.empty(C, dtype=f32, device=dev), torch.empty(C, dtype=f32, device=dev)
    vec = torch.empty((4, C), dtype=f32, device=dev)
    _launch("ssdx_brp_stats_finalize", part, t["nbands"], C, float(n), float(eps), gamma, beta,
            mean, var, vec)
    Hp, Wp = _pooled(H, W, ceil)
    p = torch.empty((B, Hp, Wp, C), dtype=x.dtype, device=dev)
    t = tiles(B, H, W, C, ceil, "apply")
    if t["nbands"]:
        _launch("ssdx_brp_apply", x, vec, p, _geo(t), dt, _grid(t, dev))
    return p, mean, var, vec


def _kernel_backward(x, vec, ceil, tie_split, gp, gmean, gvar):
    """``(dx, dgamma, dbeta)`` from the forward's ``vec``."""
    f32, dev = torch.float32, x.device
    B, H, W, C = x.shape
    n = B * H * W
    dt = _DTYPES[x.dtype]
    g = _aligned(gp.to(x.dtype))

    t = tiles(B, H, W, C, ceil, "reduce")
    part = torch.empty((t["nbands"], 2 * C), dtype=f32, device=dev)
    if t["nbands"]:
        _launch("ssdx_brp_reduce", x, g, vec, part, _geo(t), int(tie_split), dt, _grid(t, dev))
    fin = torch.empty((4, C), dtype=f32, device=dev)  # s1, s2, A, B0
    _launch("ssdx_brp_reduce_finalize", part, t["nbands"], C, float(n), vec,
            gmean.to(f32).contiguous(), gvar.to(f32).contiguous(), fin)
    dx = torch.empty_like(x)
    t = tiles(B, H, W, C, ceil, "dx")
    _launch("ssdx_brp_dx", x, g, vec, fin, dx, _geo(t), int(tie_split), dt, _grid(t, dev))
    return dx, fin[1], fin[0]


class BnReluPool(torch.autograd.Function):
    """The kernel route: the forward launches stats, stats_finalize and
    apply, the backward reduce, reduce_finalize and dx (csrc/bn_relu_pool.cu)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, ceil, tie_split):
        global launches
        xk = _aligned(x.detach())
        gk, bk = gamma.detach().float().contiguous(), beta.detach().float().contiguous()
        p, mean, var, vec = _kernel_forward(xk, gk, bk, eps, ceil)
        launches += 1
        ctx.save_for_backward(xk, vec)
        ctx.cfg = (ceil, tie_split)
        ctx.param_dtypes = (gamma.dtype, beta.dtype)
        return p, mean, var

    @staticmethod
    def backward(ctx, gp, gmean, gvar):
        global launches_bwd
        x, vec = ctx.saved_tensors
        dx, dgamma, dbeta = _kernel_backward(x, vec, *ctx.cfg, gp, gmean, gvar)
        launches_bwd += 1
        dg, db = ctx.param_dtypes
        return dx, dgamma.to(dg), dbeta.to(db), None, None, None


def bn_relu_pool(x, gamma, beta, eps: float = 1e-5, ceil: bool = False, tie_split: bool = True):
    """Train-mode BN + ReLU + 2x2/2 max pool of NHWC ``x`` -> ``(p, mean,
    var)``, differentiable in ``x``, ``gamma`` and ``beta`` through all three
    outputs.

    CPU tensors take the plain version; CUDA tensors take the kernels.
    """
    dev = x.device
    if x.dim() != 4 or gamma.shape != (x.shape[-1],) or beta.shape != gamma.shape:
        raise ValueError(f"bn_relu_pool takes x [B,H,W,C] and gamma, beta [C]; got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, {tuple(beta.shape)}")
    if gamma.device != dev or beta.device != dev:
        raise ValueError("bn_relu_pool: x, gamma and beta must share a device")
    if dev.type == "cpu":
        return BnReluPoolRef.apply(x, gamma, beta, eps, ceil, tie_split)
    if dev.type != "cuda":
        raise ValueError(f"bn_relu_pool: unsupported device {dev}")
    check_nhwc("bn_relu_pool", x, _MAX_C)
    return BnReluPool.apply(x, gamma, beta, eps, ceil, tie_split)
