"""Do the int8 tensor cores pay on this card?  A matmul probe on one GPU.

    python -m ssdx_torch.tools.bench_int8_mm [--size 2048] [--iters 50]

Times, at M = N = K = ``size``:
  kernel-int8  the hand-written int8 x int8 -> int32 matmul
               (``ops.int8_conv.int8_mm_raw``: the main loop of the int8 1x1
               conv kernel with a raw int32 store);
  kernel-bf16  the same tiling on the bf16 tensor cores, bf16 x bf16 -> f32
               (``ops.int8_conv.bf16_mm_raw``), as the control;
  torch-int8   ``torch._int_mm`` (cuBLASLt), the library's int8 matmul, with
               its second operand row-major and column-major (the faster of
               the two is the yardstick);
  torch-bf16   ``torch.matmul`` in bf16, the library's bf16 matmul;
beside the card's dense peaks (1,979 TOP/s int8, 989 TFLOP/s bf16) as
bounds.  Both kernels are first checked against their plain versions
(int8: exact).  Timing is by CUDA events over ``iters`` launches after a
warm-up, cycling over distinct operands.  The counterpart of the JAX
package's ``scripts/bench_int8_mxu.py``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess

import torch

from ssdx_torch.ops import int8_conv as ic

PEAK_INT8 = 1979e12  # H100 SXM, dense, at the 700 W limit (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16_RTOL = 1e-3  # bf16 kernel against float32 matmul: max |k - r| / (|r| + 1)


def cuda_ms(fn, inputs, iters=50, warmup=5) -> float:
    """Mean ms per call of fn(*x), cycling over distinct inputs."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(size: int = 2048, iters: int = 50, log=print) -> dict:
    """Check and time the four matmuls; returns the numbers it printed."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_int8_mm needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ri = lambda: torch.randint(-127, 128, (size, size), generator=g, device=dev,
                               dtype=torch.int8)
    ops8 = [(ri(), ri()) for _ in range(4)]  # (a [M,K], b_t [N,K])
    opsbf = [((a.float() / 127).to(torch.bfloat16), (b.float() / 127).to(torch.bfloat16))
             for a, b in ops8]
    lib8 = [(a, b.t().contiguous()) for a, b in ops8]  # torch._int_mm takes b [K,N]
    lib8_col = [(a, b.t()) for a, b in ops8]           # ... also as a column-major view
    libbf = [(a, b.t()) for a, b in opsbf]

    a, b_t = ops8[0]
    got, ref = ic.int8_mm_raw(a, b_t), ic.int8_mm_raw_ref(a, b_t)
    lib = torch._int_mm(*lib8[0])
    torch.cuda.synchronize()
    mismatches = int((got != ref).sum()) + int((got != lib).sum())
    log(f"int8 kernel vs plain (float64 matmul) and torch._int_mm at {size}^3: "
        f"{mismatches} mismatches (must be 0)")
    if mismatches:
        raise AssertionError(f"int8_mm_raw disagrees on {mismatches} elements")
    gotf, reff = ic.bf16_mm_raw(*opsbf[0]), ic.bf16_mm_raw_ref(*opsbf[0])
    torch.cuda.synchronize()
    rel = ((gotf - reff).abs() / (reff.abs() + 1.0)).max().item()
    log(f"bf16 kernel vs plain (float32 matmul): max |k-r|/(|r|+1) = {rel:.3e} "
        f"(limit {BF16_RTOL})")
    if not rel < BF16_RTOL:
        raise AssertionError(f"bf16_mm_raw is off by {rel}")

    flops = 2 * size ** 3
    res = {
        "size": size,
        "max_abs_err": float(mismatches),
        "bf16_rel_err": rel,
        "kernel_int8_ms": cuda_ms(ic.int8_mm_raw, ops8, iters),
        "kernel_bf16_ms": cuda_ms(ic.bf16_mm_raw, opsbf, iters),
        "torch_int8_ms": min(cuda_ms(torch._int_mm, lib8, iters),
                             cuda_ms(torch._int_mm, lib8_col, iters)),
        "torch_bf16_ms": cuda_ms(torch.matmul, libbf, iters),
        "plain_int8_ms": cuda_ms(ic.int8_mm_raw_ref, ops8, max(2, iters // 10), warmup=1),
        "bound_int8_ms": max(flops / PEAK_INT8, (2 * size * size + 4 * size * size) / PEAK_BYTES) * 1e3,
        "bound_bf16_ms": max(flops / PEAK_BF16, (4 * size * size + 4 * size * size) / PEAK_BYTES) * 1e3,
    }
    for name, key, unit in (("kernel-int8", "kernel_int8_ms", "TOP/s"),
                            ("kernel-bf16", "kernel_bf16_ms", "TFLOP/s"),
                            ("torch-int8", "torch_int8_ms", "TOP/s"),
                            ("torch-bf16", "torch_bf16_ms", "TFLOP/s"),
                            ("plain-int8", "plain_int8_ms", "TOP/s")):
        log(f"  {name:12s}: {res[key]:9.4f} ms  {flops / res[key] / 1e9:8.1f} {unit}")
    log(f"  bounds      : int8 {res['bound_int8_ms']:.4f} ms at 1,979 TOP/s, "
        f"bf16 {res['bound_bf16_ms']:.4f} ms at 989 TFLOP/s (dense peaks)")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8_mm: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    run(args.size, args.iters)


if __name__ == "__main__":
    main()
