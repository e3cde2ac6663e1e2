"""Check the two stem kernels on one GPU against their plain versions.

    python -m ssdx_torch.tools.check_stem

B2 (``ops.stem.stem_conv_pool``, ``csrc/stem.cu``) at B = 1, 3, 5, 8 and 32
against ``stem_conv_pool_ref`` in bf16: max |k - r| / (|r| + 1) < 0.05; and
every image bit-identical whatever B it is computed in (the first B images
of the B = 32 batch).  B3 (``ops.stem_train.stem_train``,
``csrc/stem_train.cu``) forward and backward at bs = 2 and 16 against
``stem_train_ref``: p within max |k - r| / (|r| + 1) < 0.05, each batch
statistic within 1e-3 of its largest magnitude, each of dw1, dg1, dbe1,
dw2, dg2, dbe2 within 0.05 L2-relative, and dx, db1, db2 exactly 0; and two
runs of B3 on the same inputs equal bit for bit (outputs, statistics and
gradients).  Prints one line per check and exits non-zero on the first
failure.  Correctness only: ``chip_smoke.py`` phases 7 and 10 time the
kernels.  Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from ssdx_torch.ops import _build
from ssdx_torch.ops import stem as stem_ops
from ssdx_torch.ops import stem_train as stem_train_ops

B2_BATCHES = (1, 3, 5, 8, 32)
B3_BATCHES = (2, 16)
P_RTOL = 0.05      # max |k - r| / (|r| + 1) of the bf16 maps
STAT_RTOL = 1e-3   # of the statistic's largest magnitude
GRAD_RTOL = 0.05   # L2-relative
GRAD_NAMES = ("dx", "dw1", "db1", "dg1", "dbe1", "dw2", "db2", "dg2", "dbe2")
ZERO_GRADS = ("dx", "db1", "db2")


def rel_err(k, r) -> float:
    """max |k - r| / (|r| + 1) in float32."""
    k, r = k.float(), r.float()
    return ((k - r).abs() / (r.abs() + 1.0)).max().item()


def stem_inputs(dev, B, seed=0):
    """bf16 images and the serving stem's weights at the scale of the JAX test."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std: torch.randn(*s, generator=g, device=dev) * std
    w = (r(64, 3, 3, 3, std=0.15), r(64, std=0.3), r(64, 64, 3, 3, std=0.08), r(64, std=0.3))
    return r(B, 300, 300, 3, std=1.0).to(torch.bfloat16), w


def check_b2(dev, batches=B2_BATCHES, log=print) -> dict:
    """B2 against the plain version at each B, and each image equal across
    the B's; returns {B: (rel, max abs err)}."""
    x, w = stem_inputs(dev, max(batches))
    full = stem_ops.stem_conv_pool(x, *w)
    res = {}
    for B in batches:
        got = stem_ops.stem_conv_pool(x[:B], *w)
        ref = stem_ops.stem_conv_pool_ref(x[:B], *w)
        torch.cuda.synchronize()
        if got.shape != (B, 150, 150, 64) or got.dtype != torch.bfloat16:
            raise AssertionError(f"B2 at B={B}: {tuple(got.shape)} {got.dtype}")
        rel = rel_err(got, ref)
        abs_err = (got.float() - ref.float()).abs().max().item()
        same = torch.equal(got, full[:B])
        log(f"B2 B={B:2d}: max |k-r|/(|r|+1) = {rel:.3e} (limit {P_RTOL}), max |k-r| = "
            f"{abs_err:.3e}; images equal to the B={max(batches)} batch's: {same}")
        if not (torch.isfinite(got.float()).all() and rel < P_RTOL and same):
            raise AssertionError(f"B2 at B={B}: rel {rel}, equal across B: {same}")
        res[B] = (rel, abs_err)
    return res


def stem_train_inputs(dev, B, seed=0):
    """bf16 images and pooled cotangents at bs=B and the train stem's
    parameters: conv weights at stem_inputs' scales, BN scales near 1 and
    shifts near 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std, mean=0.0: torch.randn(*s, generator=g, device=dev) * std + mean
    w = (r(64, 3, 3, 3, std=0.15), r(64, std=0.3), r(64, std=0.1, mean=1.0), r(64, std=0.1),
         r(64, 64, 3, 3, std=0.08), r(64, std=0.3), r(64, std=0.1, mean=1.0), r(64, std=0.1))
    x = r(B, 300, 300, 3, std=1.0).to(torch.bfloat16)
    dp = r(B, 150, 150, 64, std=1.0).to(torch.bfloat16)
    return x, dp, w


def fwd_bwd(fn, x, dp, w):
    """One forward and backward of fn; returns (outputs, grads of x and w)."""
    ps = [t.detach().clone().requires_grad_() for t in w]
    xx = x.detach().clone().requires_grad_()
    out = fn(xx, *ps)
    torch.autograd.backward(out[0], dp)
    return [o.detach() for o in out], [xx.grad] + [p.grad for p in ps]


def check_b3(dev, B, log=print) -> dict:
    """B3 against the plain version at bs=B; returns the errors by name."""
    x, dp, w = stem_train_inputs(dev, B)
    kout, kgrad = fwd_bwd(stem_train_ops.stem_train, x, dp, w)
    rout, rgrad = fwd_bwd(stem_train_ops.stem_train_ref, x, dp, w)
    torch.cuda.synchronize()
    kp, rp = kout[0], rout[0]
    if kp.shape != (B, 150, 150, 64) or kp.dtype != torch.bfloat16:
        raise AssertionError(f"B3 at bs={B}: {tuple(kp.shape)} {kp.dtype}")
    errs = {"p": rel_err(kp, rp), "max_abs_err": (kp.float() - rp.float()).abs().max().item()}
    ok = bool(torch.isfinite(kp.float()).all()) and errs["p"] < P_RTOL
    for name, k, r in zip(("mean1", "var1", "mean2", "var2"), kout[1:], rout[1:]):
        errs[name] = ((k - r).abs().max() / r.abs().max()).item()
        ok &= errs[name] < STAT_RTOL
    for name, k, r in zip(GRAD_NAMES, kgrad, rgrad):
        if name in ZERO_GRADS:
            errs[name] = k.abs().max().item()
            ok &= errs[name] == 0.0
        else:
            errs[name] = ((k - r).norm() / r.norm()).item()
            ok &= bool(torch.isfinite(k).all()) and errs[name] < GRAD_RTOL
    log(f"B3 bs={B}: p max |k-r|/(|r|+1) = {errs['p']:.3e} (limit {P_RTOL}), max |k-r| = "
        f"{errs['max_abs_err']:.3e}; statistics (limit {STAT_RTOL}) "
        + ", ".join(f"{n} {errs[n]:.3e}" for n in ("mean1", "var1", "mean2", "var2"))
        + f"; gradients (limit {GRAD_RTOL} L2-relative; dx, db1, db2 exactly 0) "
        + ", ".join(f"{n} {errs[n]:.3e}" for n in GRAD_NAMES))
    if not ok:
        raise AssertionError(f"B3 at bs={B} is off: {errs}")
    return errs


def check_b3_repeat(dev, B=16, log=print) -> bool:
    """Two runs of B3 on the same inputs give the same bits."""
    x, dp, w = stem_train_inputs(dev, B, seed=1)
    a = fwd_bwd(stem_train_ops.stem_train, x, dp, w)
    b = fwd_bwd(stem_train_ops.stem_train, x, dp, w)
    torch.cuda.synchronize()
    same = all(torch.equal(s, t) for s, t in zip(a[0] + a[1], b[0] + b[1]))
    log(f"B3 bs={B}: two runs identical bit for bit: {same}")
    if not same:
        raise AssertionError("two runs of B3 differ")
    return same


def run(log=print) -> dict:
    """Every check; returns the errors it printed."""
    if not torch.cuda.is_available():
        raise RuntimeError("check_stem needs a CUDA device")
    dev = torch.device("cuda")
    _build.build("stem", "stem_train")
    for name in ("stem", "stem_train"):
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    res = {"b2": check_b2(dev, log=log)}
    res["b3"] = {B: check_b3(dev, B, log=log) for B in B3_BATCHES}
    res["b3_repeat"] = check_b3_repeat(dev, log=log)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("check_stem: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    run()
    print("check_stem: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
