"""Do the int8 tensor cores pay on this card?  A matmul probe on one GPU.

    python -m ssdx_torch.tools.bench_int8_mm [--size 2048] [--iters 50]

Times, at M = N = K = ``size``:
  kernel-int8  the hand-written int8 x int8 -> int32 matmul
               (``ops.int8_conv.int8_mm_raw``: the "nt" kernel of
               ``csrc/gemm_sm90.cu``, TMA loads and wgmma);
  kernel-bf16  the same kernel on the bf16 tensor cores, bf16 x bf16 -> f32
               (``ops.int8_conv.bf16_mm_raw``), as the control;
  torch-int8   ``torch._int_mm`` (cuBLASLt), the library's int8 matmul, with
               its second operand row-major and column-major (the faster of
               the two is the yardstick);
  torch-bf16   ``torch.matmul`` in bf16, the library's bf16 matmul (its
               output is bf16: half the bytes of the kernel's);
  torch-bf16f32  ``torch.mm(..., out_dtype=torch.float32)``, the library call
               of the kernel's own function;
beside the card's dense peaks (1,979 TOP/s int8, 989 TFLOP/s bf16) as
bounds.  Both kernels are first checked against their plain versions
(int8: exact, and equal to ``torch._int_mm``).  Each is timed twice: by
CUDA events over ``iters`` launches after a warm-up, cycling over distinct
operands (the time a caller waits, host cost included), and by the device
time of its own kernel under ``torch.profiler`` (:func:`device_time`).  The
host's cost of one call (:func:`host_ms`) is measured on a small product,
where the card keeps up with the host.  The counterpart of the JAX
package's ``scripts/bench_int8_mxu.py``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import time

import torch

from ssdx_torch.ops import int8_conv as ic
from ssdx_torch.tools.roofline import PEAK_INT8, bound_ms

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


def counted(names, iters, kernel=None):
    """The names of a profiler window's device records that count towards
    ``iters`` calls, or None when the window has lost records.  With
    ``kernel`` (a part of a kernel's name) only the kernels so named count,
    and there must be exactly one per call; without it every record counts,
    and each name must occur the same whole number of times in every call:
    a multiple of ``iters``."""
    if kernel is not None:
        names = [n for n in names if kernel in n]
        return names if len(names) == iters else None
    counts = collections.Counter(names)
    return names if counts and all(c % iters == 0 for c in counts.values()) else None


# Idle seconds at each end of a profiler window.  The profiler keeps only
# device records that it places inside the window's host-clock interval; a
# window whose kernels run from its first to its last instant can lose its
# edge records (or, if short, all of them) to any error in placing device
# times on the host clock.
WINDOW_PAD_S = 0.025
lost_windows = []  # (records counted, calls) of each window that lost records


def _window(fn, inputs, iters) -> list:
    """The device records of one profiler window over ``iters`` calls of
    fn(*x), run ``WINDOW_PAD_S`` from either end of the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _warm(fn, inputs) -> None:
    for x in inputs[:2]:
        fn(*x)
    torch.cuda.synchronize()


def device_time(fn, inputs, iters=20, tries=3, kernel=None) -> tuple[float | None, list]:
    """Device time per call of fn(*x) under ``torch.profiler`` over
    ``iters`` calls, and the distinct names of the kernels it counted
    (:func:`counted`).  A window that has lost records (on the card it
    happens, in some runs, to whole windows; each loss is kept in
    ``lost_windows``) is run again, at most ``tries`` times in all; then the
    time is None: not measured."""
    _warm(fn, inputs)
    for _ in range(tries):
        events = _window(fn, inputs, iters)
        names = counted([e.name for e in events], iters, kernel)
        if names is not None:
            us = sum(e.time_range.elapsed_us() for e in events if kernel is None or kernel in e.name)
            return us / iters / 1e3, sorted(set(names))
        lost_windows.append((sum(kernel is None or kernel in e.name for e in events), iters))
    return None, []


def device_times(fn, inputs, kernels, iters=20, tries=3) -> dict:
    """Device time per call of each of ``kernels`` (a part of a kernel's
    name; fn(*x) launches each once), all from one profiler window, so that
    they can be compared; each is None when every window lost records."""
    _warm(fn, inputs)
    for _ in range(tries):
        events = _window(fn, inputs, iters)
        names = [e.name for e in events]
        if all(counted(names, iters, k) is not None for k in kernels):
            return {k: sum(e.time_range.elapsed_us() for e in events if k in e.name) / iters / 1e3
                    for k in kernels}
        lost_windows.append((len(events), iters))
    return dict.fromkeys(kernels)


def device_ms(fn, inputs, iters=20, tries=3, kernel=None) -> float | None:
    """The time of :func:`device_time` alone."""
    return device_time(fn, inputs, iters, tries, kernel)[0]


def short_name(names) -> str | None:
    """Kernel names as the profiler gives them, without return type,
    anonymous namespace and parameters, joined by "; "."""
    return "; ".join(re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n) for n in names) or None


def fmt(ms, spec="9.4f") -> str:
    """A time from :func:`device_ms`, or "not measured"."""
    return "not measured" if ms is None else format(ms, spec)


def host_ms(fn, inputs, iters=200) -> float:
    """Host time per call of fn(*x), without waiting for the card: on
    operands small enough that the card keeps up, the cost of one call."""
    for x in inputs[:2]:
        fn(*x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3


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
    mm_f32 = lambda a, b: torch.mm(a, b, out_dtype=torch.float32)

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
    small = [(a[:64, :256].contiguous(), b[:64, :256].contiguous()) for a, b in ops8]
    dev8, names8 = device_time(ic.int8_mm_raw, ops8, kernel="gemm_kernel")
    devbf, namesbf = device_time(ic.bf16_mm_raw, opsbf, kernel="gemm_kernel")
    res = {
        "size": size,
        "kernel_int8_device_ms": dev8,
        "kernel_bf16_device_ms": devbf,
        "kernel_int8_name": short_name(names8),
        "kernel_bf16_name": short_name(namesbf),
        "max_abs_err": float(mismatches),
        "bf16_rel_err": rel,
        "kernel_int8_ms": cuda_ms(ic.int8_mm_raw, ops8, iters),
        "kernel_bf16_ms": cuda_ms(ic.bf16_mm_raw, opsbf, iters),
        "torch_int8_ms": min(cuda_ms(torch._int_mm, lib8, iters),
                             cuda_ms(torch._int_mm, lib8_col, iters)),
        "torch_bf16_ms": cuda_ms(torch.matmul, libbf, iters),
        "plain_int8_ms": cuda_ms(ic.int8_mm_raw_ref, ops8, max(2, iters // 10), warmup=1),
        "torch_int8_device_ms": min((t for t in (device_ms(torch._int_mm, lib8),
                                                 device_ms(torch._int_mm, lib8_col))
                                     if t is not None), default=None),
        "torch_bf16_device_ms": device_ms(torch.matmul, libbf),
        "torch_bf16f32_ms": cuda_ms(mm_f32, libbf, iters),
        "torch_bf16f32_device_ms": device_ms(mm_f32, libbf),
        "kernel_host_ms": host_ms(ic.int8_mm_raw, small),
        "torch_host_ms": host_ms(torch._int_mm, [(a, b.t()) for a, b in small]),
        "bound_int8_ms": bound_ms(flops, 2 * size * size + 4 * size * size, PEAK_INT8)[0],
        "bound_bf16_ms": bound_ms(flops, 4 * size * size + 4 * size * size)[0],
    }
    for name, key, unit in (("kernel-int8", "kernel_int8", "TOP/s"),
                            ("kernel-bf16", "kernel_bf16", "TFLOP/s"),
                            ("torch-int8", "torch_int8", "TOP/s"),
                            ("torch-bf16", "torch_bf16", "TFLOP/s"),
                            ("torch-bf16f32", "torch_bf16f32", "TFLOP/s")):
        ev, dv = res[key + "_ms"], res[key + "_device_ms"]
        rate = "" if dv is None else f"  {flops / dv / 1e9:8.1f} {unit} (device)"
        log(f"  {name:13s}: {ev:9.4f} ms by events, {fmt(dv)} ms on the device{rate}")
    log(f"  kernels      : int8 {res['kernel_int8_name']}, bf16 {res['kernel_bf16_name']}")
    log(f"  plain-int8   : {res['plain_int8_ms']:9.4f} ms by events (float64 matmul)")
    log(f"  host cost of one call (M = N = 64, K = 256, no wait): int8_mm_raw "
        f"{res['kernel_host_ms'] * 1e3:.2f} us, torch._int_mm {res['torch_host_ms'] * 1e3:.2f} us")
    log(f"  bounds       : int8 {res['bound_int8_ms']:.4f} ms at 1,979 TOP/s, "
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
