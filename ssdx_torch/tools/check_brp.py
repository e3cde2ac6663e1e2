"""Check the BN + ReLU + pool kernels B6, and their pool-free twin, on one GPU
against their plain versions.

    python -m ssdx_torch.tools.check_brp

B6 (``ops.bn_relu_pool.bn_relu_pool``, ``csrc/bn_relu_pool.cu``) forward
and backward, with non-zero cotangents for mean and var, against
``bn_relu_pool_ref`` at the four ``BRP_CASES`` shapes (the stem's
``[16,300,300,64]``, the next two pooled stages of the network, the third
with the odd 75 -> 38 ceil pool, and a tie / ReLU-boundary input) and at
two shapes at the edges of the contract (``EDGE_CASES``: C = 2048, and C =
24, whose 3 channel groups leave threads idle), in bfloat16 and float32,
with ``tie_split`` on and off.  Limits (``chip_smoke.py`` phase 15's): p
within one bf16 step of the plain version, mean and var within 1e-5 of
their largest magnitude, dx within 0.02 L2-relative, dgamma and dbeta within
1e-3 of their largest magnitude; and two runs of the kernels identical bit
for bit.  Then the pool-free twin (``ops.bn_relu_pool.bn_relu``) at the
shapes of the train step's 18 BN + ReLU layers outside the stem
(``LAYER_SHAPES``, 10 distinct), bf16 and f32, with zero cotangents for
mean and var (the train step's), against ``bn_relu_ref`` within
the same limits, and two runs bit for bit.  Prints one line per case and
exits non-zero on the first failure.
Correctness only: ``chip_smoke.py`` phase 16 and ``tools/profile_split.py``
time the kernels.  Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from ssdx_torch.ops import bn_relu_pool as brp_ops

# (shape, ceil, ties)
BRP_CASES = (((16, 300, 300, 64), False, False), ((16, 150, 150, 128), False, False),
             ((16, 75, 75, 256), True, False), ((4, 61, 59, 64), False, True))
EDGE_CASES = (((2, 5, 7, 2048), True, False), ((3, 9, 11, 24), False, True))
# The conv outputs of the train step's 18 BN + ReLU layers outside the stem
# (model.BACKBONE layers 2-19) at bs=16, full width, in order.
LAYER_SHAPES = (((16, 150, 150, 128),) * 2 + ((16, 75, 75, 256),) * 3
                + ((16, 38, 38, 512),) * 3 + ((16, 19, 19, 512),) * 3
                + ((16, 19, 19, 1024),) * 2
                + ((16, 19, 19, 256), (16, 10, 10, 512), (16, 10, 10, 128), (16, 5, 5, 256),
                   (16, 5, 5, 128)))
DTYPES = (torch.bfloat16, torch.float32)
BF16_STEP = 2.0 ** -7  # largest relative gap between neighbouring bfloat16 values
STAT_RTOL, DX_RTOL, PARAM_RTOL = 1e-5, 0.02, 1e-3


def brp_inputs(dev, shape, ceil, seed, ties=False, dtype=torch.bfloat16):
    """x, gamma, beta and the three cotangents (mean's and var's non-zero)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std=1.0, mean=0.0: torch.randn(*s, generator=gen, device=dev) * std + mean
    B, H, W, C = shape
    x = r(*shape)
    if ties:  # half-step values: tied maxima, and windows that the ReLU zeroes whole
        x = (x * 2).round() / 2
    Hp, Wp = ((H + 1) // 2, (W + 1) // 2) if ceil else (H // 2, W // 2)
    return ([x.to(dtype), r(C, std=0.2, mean=1.0), r(C, std=0.2)],
            [r(B, Hp, Wp, C).to(dtype), r(C), r(C)])


def grads_of(fn, inputs, outs_cot):
    """One forward and backward of fn(*inputs) with the cotangents
    ``outs_cot``; returns (outputs, gradients of the inputs)."""
    xs = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*xs)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, outs_cot)
    return [o.detach() for o in out], [x.grad for x in xs]


def check_case(dev, shape, ceil, ties, dtype, tie_split, seed, log=print) -> float:
    """One case; returns max |p_kernel - p_plain| and raises past a limit."""
    ins, cots = brp_inputs(dev, shape, ceil, seed, ties, dtype)
    fn = lambda x, g, b: brp_ops.bn_relu_pool(x, g, b, 1e-5, ceil, tie_split)
    ref = lambda x, g, b: brp_ops.bn_relu_pool_ref(x, g, b, 1e-5, ceil, tie_split)
    kout, kgrad = grads_of(fn, ins, cots)
    kout2, kgrad2 = grads_of(fn, ins, cots)
    rout, rgrad = grads_of(ref, ins, cots)
    if ins[0].is_cuda:
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(kout + kgrad, kout2 + kgrad2))
    kp, rp = kout[0].float(), rout[0].float()
    gap = (kp - rp).abs()
    p_ok = bool((gap <= BF16_STEP * torch.maximum(kp.abs(), rp.abs()) + 1e-6).all())
    stat = [((k - r).abs().max() / r.abs().max()).item() for k, r in zip(kout[1:], rout[1:])]
    dx = ((kgrad[0].float() - rgrad[0].float()).norm() / rgrad[0].float().norm()).item()
    dgb = [((k - r).abs().max() / r.abs().max()).item() for k, r in zip(kgrad[1:], rgrad[1:])]
    name = str(dtype).replace("torch.", "")
    log(f"bn_relu_pool kernels vs plain, {tuple(shape)} {name} ceil={ceil} "
        f"tie_split={tie_split}{' (ties, ReLU boundary)' if ties else ''}: p "
        f"{int((gap > 0).sum())} of {gap.numel()} differ, max |k-r| {gap.max().item():.3e} "
        f"(limit one bf16 step); mean {stat[0]:.2e}, var {stat[1]:.2e} (limit {STAT_RTOL:g} of "
        f"max); dx |k-r|/|r| {dx:.3e} (limit {DX_RTOL:g}); dgamma {dgb[0]:.2e}, dbeta "
        f"{dgb[1]:.2e} (limit {PARAM_RTOL:g} of max); two runs identical: {same}")
    ok = (p_ok and kout[0].shape == rout[0].shape and kout[0].dtype == dtype
          and max(stat) < STAT_RTOL and dx < DX_RTOL and max(dgb) < PARAM_RTOL and same
          and all(torch.isfinite(t.float()).all() for t in kout + kgrad))
    if not ok:
        raise AssertionError(f"bn_relu_pool {tuple(shape)} {name} ceil={ceil} "
                             f"tie_split={tie_split} outside its limits")
    return gap.max().item()


def bn_relu_inputs(dev, shape, seed, dtype=torch.bfloat16):
    """x, gamma, beta and the cotangents of y (a gradient's scale), mean and
    var (zeros: the train step reads them only for the running averages)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std=1.0, mean=0.0: torch.randn(*s, generator=gen, device=dev) * std + mean
    C = shape[-1]
    zero = torch.zeros(C, device=dev)
    return [r(*shape, mean=0.1).to(dtype), r(C, std=0.2, mean=1.0), r(C, std=0.2)], \
        [r(*shape, std=1e-3).to(dtype), zero, zero]


def check_bn_relu_case(dev, shape, dtype, seed, log=print) -> float:
    """One bn_relu case; returns max |y_kernel - y_plain| and raises past a
    limit.  The limits are B6's: the kernels' sums run in another order than
    PyTorch's, so mean and var differ in their last bits and y by at most one
    rounding of the output.  The few pixels whose float32 y lies within that
    of 0 take the other side of the ReLU in the two versions; each moves
    dbeta by its |dy| and dgamma by its |dy * xhat|, which a single one can
    bring past 1e-3 of the largest magnitude (one of 11.8 M pixels did in
    float32 at [16,38,38,512]), so the limits of dgamma and dbeta add, per
    channel, the sum of those terms over the pixels whose sign differs."""
    ins, cots = bn_relu_inputs(dev, shape, seed, dtype)
    fn = lambda x, g, b: brp_ops.bn_relu(x, g, b, 1e-5)
    ref = lambda x, g, b: brp_ops.bn_relu_ref(x, g, b, 1e-5)
    kout, kgrad = grads_of(fn, ins, cots)
    kout2, kgrad2 = grads_of(fn, ins, cots)
    rout, rgrad = grads_of(ref, ins, cots)
    kstat, rstat = kout[1:], rout[1:]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(kout + kgrad, kout2 + kgrad2))
    ky, ry = kout[0].float(), rout[0].float()
    gap = (ky - ry).abs()
    y_ok = bool((gap <= BF16_STEP * torch.maximum(ky.abs(), ry.abs()) + 1e-6).all())
    stat = [((k - r).abs().max() / r.abs().max()).item() for k, r in zip(kstat, rstat)]
    dx = ((kgrad[0].float() - rgrad[0].float()).norm() / rgrad[0].float().norm()).item()
    flip = (ky > 0) != (ry > 0)  # rounding keeps the sign: the masks of the two versions
    dy = cots[0].float() * flip
    xhat = (ins[0].float() - rstat[0]) * torch.rsqrt(rstat[1] + 1e-5)
    allow = [(dy * xhat).abs().sum((0, 1, 2)), dy.abs().sum((0, 1, 2))]  # dgamma, dbeta
    dgb, gb_ok = [], True
    for k, r, extra in zip(kgrad[1:], rgrad[1:], allow):
        dgb.append(((k - r).abs().max() / r.abs().max()).item())
        gb_ok &= bool(((k - r).abs() <= PARAM_RTOL * r.abs().max() + extra).all())
    name = str(dtype).replace("torch.", "")
    log(f"bn_relu kernels vs plain, {tuple(shape)} {name}: y {int((gap > 0).sum())} of "
        f"{gap.numel()} differ, max |k-r| {gap.max().item():.3e} (limit one bf16 step), "
        f"{int(flip.sum())} across the ReLU; mean {stat[0]:.2e}, var {stat[1]:.2e} (limit "
        f"{STAT_RTOL:g} of max); dx |k-r|/|r| {dx:.3e} (limit {DX_RTOL:g}); dgamma "
        f"{dgb[0]:.2e}, dbeta {dgb[1]:.2e} of max (limit {PARAM_RTOL:g} of max + the pixels "
        f"across the ReLU); two runs identical: {same}")
    ok = (y_ok and kout[0].shape == rout[0].shape and kout[0].dtype == dtype
          and max(stat) < STAT_RTOL and dx < DX_RTOL and gb_ok and same
          and all(torch.isfinite(t.float()).all() for t in kout + kgrad))
    if not ok:
        raise AssertionError(f"bn_relu {tuple(shape)} {name} outside its limits")
    return gap.max().item()


def check_bn_relu(dev, shapes=tuple(dict.fromkeys(LAYER_SHAPES)), dtypes=DTYPES,
                  log=print) -> dict:
    """Every distinct layer shape in every dtype; returns the largest |y|
    error per dtype."""
    worst = {}
    for dtype in dtypes:
        for i, shape in enumerate(shapes):
            err = check_bn_relu_case(dev, shape, dtype, 40 + i, log)
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    return worst


def check(dev, cases=BRP_CASES + EDGE_CASES, dtypes=DTYPES, log=print) -> dict:
    """Every case in every dtype with tie_split on and off; returns the
    largest |p| error per dtype."""
    worst = {}
    for dtype in dtypes:
        for i, (shape, ceil, ties) in enumerate(cases):
            for tie_split in (True, False):
                err = check_case(dev, shape, ceil, ties, dtype, tie_split, 15 + i, log)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("check_brp: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log = lambda *a: print(*a, flush=True)
    check(torch.device("cuda"), log=log)
    check_bn_relu(torch.device("cuda"), log=log)
    print("check_brp: every case within its limits, two runs bit for bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
