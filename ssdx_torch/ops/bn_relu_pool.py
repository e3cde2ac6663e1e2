"""Train-mode BatchNorm + ReLU (+ 2x2/2 max pool) on NHWC, with its own backward.

``bn_relu_pool(x, gamma, beta)`` returns ``(p, mean, var)``: the pooled map
and the biased batch statistics for the caller's running-average update.
``bn_relu(x, gamma, beta)`` is its pool-free twin, ``(y, mean, var)`` with y
of x's shape: the train step's BatchNorm + ReLU layers that no pool follows
at once (``model.ConvBNRelu`` on a CUDA tensor outside a mesh).
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

``bn_relu``'s contract is the same without the window: y = relu(x*a + b)
rounded once to ``x``'s type; the backward masks dy by y > 0 (y in float32,
before the rounding) and takes the BN backward above.  It moves 5 x |x|
with each input and output once (x, y; x, dy, dx) and 8 x |x| with the
second read of x that each BN barrier forces; the kernels are B6's four
passes in their pool-free mode (see the source's header), one flat tile
walk over the B*H*W pixels (:func:`flat_tiles`).  ``bn_relu`` refuses what
the kernels do not take on every device, so a shape that passes on the CPU
passes on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .pool import _DTYPES, _aligned, _compute_dtype, bind, check_nhwc, launch, sm_count
from .pool import route, unwindows, windows

__all__ = ["bn_relu_pool", "bn_relu_pool_ref", "BnReluPool", "BnReluPoolRef", "tiles",
           "bn_relu", "bn_relu_ref", "BnRelu", "BnReluRef", "flat_tiles",
           "launches", "launches_bwd", "launches_bn_relu", "launches_bn_relu_bwd"]

launches = 0      # forwards of bn_relu_pool that launched stats + apply
launches_bwd = 0  # backwards that launched reduce + dx
launches_bn_relu = 0      # forwards of bn_relu that launched its stats + apply
launches_bn_relu_bwd = 0  # and backwards that launched its reduce + dx

_MAX_C = 2048
_CONSUMERS = 256   # csrc/bn_relu_pool.cu kConsumers: threads that read the tiles
_BLOCKS_PER_SM = 2  # the pipeline kernel's __launch_bounds__
_BANDS = 4 * 2 * 132  # flat_tiles: about four bands for each block of an H100 SXM's grid
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


def _bn_backward(x, xf, gamma, mean, inv, dy, gmean, gvar):
    """``(dx, dgamma, dbeta)`` from the routed or masked ``dy`` in float32."""
    n = x.shape[0] * x.shape[1] * x.shape[2]
    ct = xf.dtype
    xhat = (xf - mean) * inv
    s1 = dy.sum(dim=(0, 1, 2))
    s2 = (dy * xhat).sum(dim=(0, 1, 2))
    dx = (gamma * inv) * (dy - (s1 / n + xhat * (s2 / n)))
    dx = dx + gmean.to(ct) / n + gvar.to(ct) * (2.0 / n) * (xf - mean)
    return dx.to(x.dtype), s2, s1


def _ref_backward(x, gamma, beta, mean, var, eps, ceil, tie_split, gp, gmean, gvar):
    ct = _compute_dtype(x.dtype)
    H, W = x.shape[1], x.shape[2]
    xf, gamma, beta = x.to(ct), gamma.to(ct), beta.to(ct)
    inv, a, b = _affine(gamma, beta, mean, var, eps)
    win = windows(torch.relu(xf * a + b), ceil, float("-inf"))
    pmax = win.amax(dim=(2, 4), keepdim=True)
    dy = unwindows(route(win, pmax, gp.to(ct), pmax > 0, tie_split), H, W)
    return _bn_backward(x, xf, gamma, mean, inv, dy, gmean, gvar)


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


def _ref_bn_relu_forward(x, gamma, beta, eps):
    ct = _compute_dtype(x.dtype)
    xf = x.to(ct)
    mean, var = _stats(xf)
    _, a, b = _affine(gamma.to(ct), beta.to(ct), mean, var, eps)
    return torch.relu(xf * a + b).to(x.dtype), mean, var


def _ref_bn_relu_backward(x, gamma, beta, mean, var, eps, gy, gmean, gvar):
    ct = _compute_dtype(x.dtype)
    xf, gamma, beta = x.to(ct), gamma.to(ct), beta.to(ct)
    inv, a, b = _affine(gamma, beta, mean, var, eps)
    dy = torch.where(xf * a + b > 0, gy.to(ct), 0.0)
    return _bn_backward(x, xf, gamma, mean, inv, dy, gmean, gvar)


class BnReluRef(torch.autograd.Function):
    """The plain version of :func:`bn_relu`: every step a PyTorch op."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, var = _ref_bn_relu_forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps = eps
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = _ref_bn_relu_backward(x, gamma, beta, mean, var, ctx.eps,
                                                  gy, gmean, gvar)
        return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None


def bn_relu_ref(x, gamma, beta, eps: float = 1e-5):
    """The plain version of :func:`bn_relu`, on any device: ``(y, mean, var)``."""
    return BnReluRef.apply(x, gamma, beta, eps)


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
            "ssdx_bnr_stats": [P, P, Geo, I, I, S],
            "ssdx_bnr_apply": [P, P, P, Geo, I, I, S],
            "ssdx_bnr_reduce": [P, P, P, P, Geo, I, I, S],
            "ssdx_bnr_dx": [P, P, P, P, P, Geo, I, I, S],
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


def flat_tiles(B: int, H: int, W: int, C: int) -> dict:
    """The tile geometry of :func:`bn_relu`'s four passes.

    Without the pool the map is one flat run of ``N = B*H*W`` pixels (handed
    to the kernel as ``B = H = 1, W = N``): a tile is ``tw = 2 * slots``
    consecutive pixels with all C channels, in which consumer thread (slot,
    cg) takes pixels 2*slot, 2*slot + 1 and channels 8*cg .. 8*cg + 7, so
    the tile's x (and dy) hold ``tw * C <= 4096`` elements each.  A band is
    ``nq`` consecutive tiles, the last band's tail past N empty; every pass
    walks the same bands, and stats and reduce write one partial row per
    band.  ``nq`` depends on the shape alone, so the sums' order does too:
    about ``_BANDS`` bands where the map is large, at least 32 pixels a band,
    so that a band's partial row (8 C bytes) stays within an eighth of the
    bytes of x the band reads in bfloat16.
    """
    N = B * H * W
    G = C // 8
    slots = _CONSUMERS // G
    tw = 2 * slots
    ntiles = -(-N // tw)
    nq = max(-(-ntiles // _BANDS), -(-32 // tw))
    nbands = -(-ntiles // nq)
    return dict(B=1, H=1, W=N, C=C, Hp=0, Wp=0, G=G, slots=slots, tw=tw, nq=nq,
                bands=nbands, nbands=nbands)


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


def _kernel_bn_relu_forward(x, gamma, beta, eps):
    """``(y, mean, var, vec)``, as :func:`_kernel_forward` without the pool."""
    f32, dev = torch.float32, x.device
    B, H, W, C = x.shape
    dt, t = _DTYPES[x.dtype], flat_tiles(B, H, W, C)
    geo, grid = _geo(t), _grid(t, dev)
    part = torch.empty((t["nbands"], 2 * C), dtype=f32, device=dev)
    _launch("ssdx_bnr_stats", x, part, geo, dt, grid)
    mean, var = torch.empty(C, dtype=f32, device=dev), torch.empty(C, dtype=f32, device=dev)
    vec = torch.empty((4, C), dtype=f32, device=dev)
    _launch("ssdx_brp_stats_finalize", part, t["nbands"], C, float(B * H * W), float(eps),
            gamma, beta, mean, var, vec)
    y = torch.empty_like(x)
    _launch("ssdx_bnr_apply", x, vec, y, geo, dt, grid)
    return y, mean, var, vec


def _kernel_bn_relu_backward(x, vec, gy, gmean, gvar):
    """``(dx, dgamma, dbeta)`` from the forward's ``vec``."""
    f32, dev = torch.float32, x.device
    B, H, W, C = x.shape
    dt, t = _DTYPES[x.dtype], flat_tiles(B, H, W, C)
    geo, grid = _geo(t), _grid(t, dev)
    dy = _aligned(gy.to(x.dtype))
    part = torch.empty((t["nbands"], 2 * C), dtype=f32, device=dev)
    _launch("ssdx_bnr_reduce", x, dy, vec, part, geo, dt, grid)
    fin = torch.empty((4, C), dtype=f32, device=dev)  # s1, s2, A, B0
    _launch("ssdx_brp_reduce_finalize", part, t["nbands"], C, float(B * H * W), vec,
            gmean.to(f32).contiguous(), gvar.to(f32).contiguous(), fin)
    dx = torch.empty_like(x)
    _launch("ssdx_bnr_dx", x, dy, vec, fin, dx, geo, dt, grid)
    return dx, fin[1], fin[0]


class BnRelu(torch.autograd.Function):
    """The kernel route of :func:`bn_relu`: the forward launches stats,
    stats_finalize and apply, the backward reduce, reduce_finalize and dx,
    each pipeline pass in its pool-free mode (csrc/bn_relu_pool.cu)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        global launches_bn_relu
        xk = _aligned(x.detach())
        gk, bk = gamma.detach().float().contiguous(), beta.detach().float().contiguous()
        y, mean, var, vec = _kernel_bn_relu_forward(xk, gk, bk, eps)
        launches_bn_relu += 1
        ctx.save_for_backward(xk, vec)
        ctx.param_dtypes = (gamma.dtype, beta.dtype)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        global launches_bn_relu_bwd
        x, vec = ctx.saved_tensors
        dx, dgamma, dbeta = _kernel_bn_relu_backward(x, vec, gy, gmean, gvar)
        launches_bn_relu_bwd += 1
        dg, db = ctx.param_dtypes
        return dx, dgamma.to(dg), dbeta.to(db), None


def _check_args(name, x, gamma, beta):
    if x.dim() != 4 or gamma.shape != (x.shape[-1],) or beta.shape != gamma.shape:
        raise ValueError(f"{name} takes x [B,H,W,C] and gamma, beta [C]; got "
                         f"{tuple(x.shape)}, {tuple(gamma.shape)}, {tuple(beta.shape)}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError(f"{name}: x, gamma and beta must share a device")


def bn_relu(x, gamma, beta, eps: float = 1e-5):
    """Train-mode BN + ReLU of NHWC ``x`` -> ``(y, mean, var)``, y of x's
    shape and type, differentiable in ``x``, ``gamma`` and ``beta`` through
    all three outputs.

    CPU tensors take the plain version; CUDA tensors take the kernels.  On
    every device it refuses C % 8 != 0 and C > 2048, what the kernels do not
    take.
    """
    _check_args("bn_relu", x, gamma, beta)
    C = x.shape[-1]
    if C % 8 or C > _MAX_C:
        raise ValueError(f"the bn_relu kernels need C % 8 == 0 and C <= {_MAX_C}, got C={C}")
    dev = x.device
    if dev.type == "cpu":
        return BnReluRef.apply(x, gamma, beta, eps)
    if dev.type != "cuda":
        raise ValueError(f"bn_relu: unsupported device {dev}")
    check_nhwc("bn_relu", x, _MAX_C)
    return BnRelu.apply(x, gamma, beta, eps)


def bn_relu_pool(x, gamma, beta, eps: float = 1e-5, ceil: bool = False, tie_split: bool = True):
    """Train-mode BN + ReLU + 2x2/2 max pool of NHWC ``x`` -> ``(p, mean,
    var)``, differentiable in ``x``, ``gamma`` and ``beta`` through all three
    outputs.

    CPU tensors take the plain version; CUDA tensors take the kernels.
    """
    _check_args("bn_relu_pool", x, gamma, beta)
    dev = x.device
    if dev.type == "cpu":
        return BnReluPoolRef.apply(x, gamma, beta, eps, ceil, tie_split)
    if dev.type != "cuda":
        raise ValueError(f"bn_relu_pool: unsupported device {dev}")
    check_nhwc("bn_relu_pool", x, _MAX_C)
    return BnReluPool.apply(x, gamma, beta, eps, ceil, tie_split)
