"""Train-mode stem, piece by piece, at bs=16 on one GPU (forward + backward).

    python -m ssdx_torch.tools.stem_train_experiments VARIANT [--bs 16] [--iters 20] [--profile]

The port's counterpart of ``scripts/stem_train_experiments.py``: it times
each piece of the stem block (conv1_1 + BN + ReLU + conv1_2 + BN + ReLU +
2x2 pool at 300x300, bfloat16) and the fused reformulations beside the
library routes they are weighed against.

Variants:
  c11         conv 3->64, forward + dW (no dx: the image is data)   cuDNN
  c11_im2col  the same as patches (F.unfold) + one matmul           cuBLAS
  c12         conv 64->64, forward + dW + dx                        cuDNN
  c12f/c12dx/c12dw   its forward only / forward + dx / forward + dW cuDNN
  bn          train-mode BatchNorm + ReLU at [B,300,300,64]         F.batch_norm
  pool        2x2 max pool with the even tie split                  kernel B5
  bnpool      BN + ReLU + pool, unfused                             F.batch_norm, F.max_pool2d
  brp         the fused BN + ReLU + pool op                         kernel B6
  brp_nosplit the same with tie_split off                           kernel B6
  stem        the whole block: cuDNN convs, F.batch_norm, pool B5
  stem_fused  the whole block with B6 as its tail

B5 is ``ssdx_torch.ops.pool.max_pool_2x2`` and B6
``ssdx_torch.ops.bn_relu_pool.bn_relu_pool``, the hand-written kernels; the
other variants are PyTorch's library calls on channels-last tensors.  Each
iteration is one forward and one backward with random cotangents (1e-3 for
the batch statistics of the fused op), timed with CUDA events over four
distinct inputs after a warm-up.  ``--profile`` adds the host's time to enqueue
an iteration and, from ``torch.profiler``, the device's busy time and launches
per iteration with the kernels that take most of it.  Every printed line ends
with the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess

import torch
import torch.nn.functional as F

from ssdx_torch.ops import bn_relu_pool as brp_ops
from ssdx_torch.ops import pool as pool_ops

__all__ = ["VARIANTS", "build_variant", "run", "profile", "main"]

VARIANTS = ("c11", "c11_im2col", "c12", "c12f", "c12dx", "c12dw", "bn", "pool", "bnpool",
            "brp", "brp_nosplit", "stem", "stem_fused")
_EPS = 1e-5
_N_INPUTS = 4


def _nchw(t):
    """NHWC tensor -> its NCHW view (channels-last memory), as cuDNN takes it."""
    return t.permute(0, 3, 1, 2)


def _bn_relu(y, gamma, beta):
    return F.relu(F.batch_norm(y, None, None, gamma, beta, training=True, eps=_EPS))


def build_variant(variant: str, bs: int = 16, size: int = 300, device="cuda", seed: int = 0):
    """``(step, inputs)``: ``step(inputs[i])`` runs one forward and backward
    of ``variant`` on the i-th of four distinct inputs.  Inputs, cotangents
    and weights are drawn on ``device`` from ``seed`` at the scales of the
    JAX script, and only those the variant reads."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dev, bf = torch.device(device), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std=1.0, mean=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    def four(shape):
        return [normal(shape, dtype=bf) for _ in range(_N_INPUTS)]

    images = variant in ("c11", "c11_im2col", "stem", "stem_fused")
    x3 = four((bs, size, size, 3)) if images else None
    x64 = None if images else four((bs, size, size, 64))
    full_cot = variant in ("c11", "c11_im2col", "c12", "c12dx", "c12dw", "bn")
    g64 = four((bs, size, size, 64)) if full_cot else None
    gp = None if full_cot else four((bs, size // 2, size // 2, 64))
    cl = dict(memory_format=torch.channels_last)
    w11 = normal((64, 3, 3, 3), 0.1, dtype=bf).contiguous(**cl).requires_grad_()
    w12 = normal((64, 64, 3, 3), 0.05, dtype=bf).contiguous(**cl).requires_grad_()
    gamma = [normal(64, 0.2, 1.0).requires_grad_() for _ in range(2)]
    beta = [normal(64, 0.2).requires_grad_() for _ in range(2)]
    gstat = torch.full((64,), 1e-3, device=dev)
    params = [w11, w12, *gamma, *beta]

    def backward(outs, cots, leaves):
        """Backward into ``leaves`` (and the parameters), gradients dropped."""
        for p in params:
            p.grad = None
        torch.autograd.backward(outs, cots, inputs=[p for p in leaves if p.requires_grad])

    def leaf(x):
        return x.detach().requires_grad_()

    if variant == "c11":
        def step(i):
            backward([F.conv2d(_nchw(x3[i]), w11, padding=1)], [_nchw(g64[i])], [w11])
    elif variant == "c11_im2col":
        def step(i):
            patches = F.unfold(_nchw(x3[i]), 3, padding=1)       # [B, 27, H*W], (ci, dr, dc)
            y = patches.transpose(1, 2) @ w11.reshape(64, 27).t()  # [B, H*W, 64]
            backward([y], [g64[i].reshape(bs, -1, 64)], [w11])
    elif variant in ("c12", "c12f", "c12dx", "c12dw"):
        def step(i):
            x = leaf(x64[i]) if variant in ("c12", "c12dx") else x64[i]
            w = w12 if variant in ("c12", "c12dw") else w12.detach()
            y = F.conv2d(_nchw(x), w, padding=1)
            if variant != "c12f":
                backward([y], [_nchw(g64[i])], [x, w])
    elif variant == "bn":
        def step(i):
            x = leaf(x64[i])
            backward([_bn_relu(_nchw(x), gamma[1], beta[1])], [_nchw(g64[i])],
                     [x, gamma[1], beta[1]])
    elif variant == "pool":
        def step(i):
            x = leaf(x64[i])
            backward([pool_ops.max_pool_2x2(x)], [gp[i]], [x])
    elif variant == "bnpool":
        def step(i):
            x = leaf(x64[i])
            p = F.max_pool2d(_bn_relu(_nchw(x), gamma[1], beta[1]), 2)
            backward([p], [_nchw(gp[i])], [x, gamma[1], beta[1]])
    elif variant in ("brp", "brp_nosplit"):
        def step(i):
            x = leaf(x64[i])
            outs = brp_ops.bn_relu_pool(x, gamma[1], beta[1], _EPS, False, variant == "brp")
            backward(list(outs), [gp[i], gstat, gstat], [x, gamma[1], beta[1]])
    else:  # stem, stem_fused
        def step(i):
            y = _bn_relu(F.conv2d(_nchw(x3[i]), w11, padding=1), gamma[0], beta[0])
            y = F.conv2d(y, w12, padding=1)
            if variant == "stem":
                y = _bn_relu(y, gamma[1], beta[1]).permute(0, 2, 3, 1)  # NHWC view
                outs, cots = [pool_ops.max_pool_2x2(y)], [gp[i]]
            else:
                outs = list(brp_ops.bn_relu_pool(y.permute(0, 2, 3, 1), gamma[1], beta[1],
                                                 _EPS, False, True))
                cots = [gp[i], gstat, gstat]
            backward(outs, cots, params)

    return step, list(range(_N_INPUTS))


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _cuda_ms(fn, inputs, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn(x), cycling over distinct inputs."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(variant: str, step, inputs, iters: int, log=print, top: int = 6) -> dict:
    """Host enqueue time, and device time by kernel, per iteration of ``step``."""
    import time
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        step(inputs[i % len(inputs)])
    enqueue = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            step(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / iters / 1e3, e.count / iters, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0), reverse=True)
    busy, ops = sum(r[0] for r in rows), sum(r[1] for r in rows)
    card = _card()
    log(f"stem_train[{variant}] profile: host enqueue {enqueue:.3f} ms/iter, device busy "
        f"{busy:.3f} ms/iter in {ops:.0f} launches  ({card})")
    for ms, count, key in rows[:top]:
        log(f"  {ms:7.4f} ms x{count:g}  {key[:80]}  ({card})")
    return {"enqueue_ms": enqueue, "busy_ms": busy, "launches": ops}


def run(variant: str, bs: int = 16, iters: int = 20, log=print, with_profile: bool = False) -> dict:
    """Time one variant on the card; returns its ms per iteration and the
    launches of B5 and B6 that the timed and warm-up iterations made."""
    if not torch.cuda.is_available():
        raise RuntimeError("stem_train_experiments: needs a CUDA device")
    step, inputs = build_variant(variant, bs)
    before = (pool_ops.launches_fwd, pool_ops.launches, brp_ops.launches, brp_ops.launches_bwd)
    ms = _cuda_ms(step, inputs, iters)
    after = (pool_ops.launches_fwd, pool_ops.launches, brp_ops.launches, brp_ops.launches_bwd)
    counts = dict(zip(("pool_fwd", "pool_bwd", "brp_fwd", "brp_bwd"),
                      (a - b for a, b in zip(after, before))))
    log(f"stem_train[{variant}]: {ms:7.3f} ms/iter bs={bs} bf16, kernel launches {counts}  "
        f"({_card()})")
    out = {"variant": variant, "ms": ms, "launches": counts}
    if with_profile:
        out["profile"] = profile(variant, step, inputs, iters, log)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", choices=VARIANTS)
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also print host enqueue time and device time by kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stem_train_experiments: needs a CUDA device")
    run(args.variant, args.bs, args.iters, with_profile=args.profile)


if __name__ == "__main__":
    main()
