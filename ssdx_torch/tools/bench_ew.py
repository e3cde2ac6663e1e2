"""The repro tool's elementwise kernel (S2a) against the launch floor, on one GPU.

    python -m ssdx_torch.tools.bench_ew [--iters 50]

Measures, by the device time of each kernel under ``torch.profiler``
(:mod:`ssdx_torch.tools.bench_int8_mm`):
  floor  the empty kernel of ``csrc/repro.cu``, one block of 256 threads on
         the same stream: the least device time of a launch.  It takes
         turns with ``ew`` at ``[256,256]`` in one profiler window
         (:func:`floor_and_ew`), so the two are read side by side;
  ew     ``tanh(x) * 1.5`` (``ops.repro.ew``) on float32 at the repro tool's
         ``[256,256]``, at 2^22 and at 2^26 values, beside the library's
         ``torch.tanh(x) * 1.5`` (two launches), and both by CUDA events.
Each size's bound is max(floor, bytes / 3.35 TB/s), x read once and the
output written once: at ``[256,256]`` the floor, at 2^26 values (256 MiB
each way) 0.160 ms of bytes.  The kernel's share of its bound is bound /
time.  S2a counts as settled when it reaches at least half its bound at
2^26 values and at most 1.5 times the floor at ``[256,256]``.  Every size,
and an odd length, is checked against ``ew_ref`` within 1e-6 first.
Prints the card, one line a measurement, and last one JSON object.  Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ssdx_torch.ops import repro
from ssdx_torch.tools.bench_int8_mm import cuda_ms, device_time, device_times

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
EW_ATOL = 1e-6  # tanhf against PyTorch's tanh need not agree in the last bit
SIZES = {"[256,256]": (256, 256), "2^22": (1 << 22,), "2^26": (1 << 26,)}
SMALL = "[256,256]"


def check(dev, log=print) -> float:
    """Max |ew - ew_ref| over every size and an odd length (the tail)."""
    g = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    for name, shape in [*SIZES.items(), ("2^26 + 3", ((1 << 26) + 3,))]:
        x = torch.randn(*shape, generator=g, device=dev) * 3
        e = (repro.ew(x) - repro.ew_ref(x)).abs().max().item()
        assert e <= EW_ATOL, (name, e)
        worst = max(worst, e)
        del x
    log(f"ew against ew_ref: max |k-r| = {worst:.3e} over {len(SIZES) + 1} sizes "
        f"(limit {EW_ATOL})")
    return worst


def fmt(v, spec=".5f") -> str:
    return "not measured" if v is None else format(v, spec)


def inputs(name: str, g) -> list:
    """Distinct float32 inputs of one size: two at 2^26 values, else four."""
    shape = SIZES[name]
    n = 2 if name == "2^26" else 4
    return [(torch.randn(*shape, generator=g, device=g.device),) for _ in range(n)]


def floor_and_ew(xs, iters: int = 50) -> tuple[float | None, float | None]:
    """Device ms of the empty kernel and of ``ew`` per call, from one
    profiler window in which they take turns on the inputs ``xs``."""
    dev = xs[0][0].device
    t = device_times(lambda x: (repro.empty(dev), repro.ew(x)), xs, ("empty_kernel", "ew_kernel"),
                     iters=iters)
    return t["empty_kernel"], t["ew_kernel"]


def row(name: str, xs, floor: float, iters: int, k_dev=None) -> dict:
    """One size's times, bound and share; ``k_dev`` is ew's device ms where
    it was already measured (beside the floor)."""
    numel = xs[0][0].numel()
    if k_dev is None:
        k_dev, _ = device_time(repro.ew, xs, iters=iters, kernel="ew_kernel")
    lib = lambda x: torch.tanh(x) * 1.5
    lib_dev, _ = device_time(lib, xs, iters=iters)
    bytes_ms = 2 * numel * 4 / PEAK_BYTES * 1e3
    bound = max(floor, bytes_ms)
    return {"values": numel, "device_ms": k_dev, "ms": cuda_ms(repro.ew, xs, iters=iters),
            "library_device_ms": lib_dev, "library_ms": cuda_ms(lib, xs, iters=iters),
            "bytes_ms": bytes_ms, "bound_ms": bound,
            "bound_by": "launch floor" if floor >= bytes_ms else "bytes",
            "share": None if k_dev is None else bound / k_dev,
            "vs_floor": None if k_dev is None else k_dev / floor}


def run(iters: int = 50, floor: float | None = None, check_first: bool = True,
        log=print) -> dict:
    """Check ``ew`` (unless ``check_first`` is False) and time it at every
    size.  Given the ``floor`` (measured beside ``ew`` at ``[256,256]`` by
    the caller), only the larger sizes are timed."""
    dev = torch.device("cuda")
    out = {"max_abs_err": check(dev, log) if check_first else None, "sizes": {}}
    g = torch.Generator(device=dev).manual_seed(8)
    names = list(SIZES)
    if floor is None:
        xs = inputs(SMALL, g)
        floor, k_dev = floor_and_ew(xs, iters)
        assert floor is not None, "the profiler lost the empty kernel's records in every window"
        log(f"launch floor: empty kernel (1 block of 256 threads) {floor:.5f} ms on the device, "
            f"in turns with ew at {SMALL}")
        out["sizes"][SMALL] = row(SMALL, xs, floor, iters, k_dev)
    names.remove(SMALL)
    out["floor_ms"] = floor
    for name in names:
        xs = inputs(name, g)
        out["sizes"][name] = row(name, xs, floor, iters)
        del xs
    for name, r in out["sizes"].items():
        log(f"ew {name} f32 ({r['values']} values): {fmt(r['device_ms'])} ms on the device "
            f"({fmt(r['vs_floor'], '.2f')}x the floor), {r['ms']:.5f} by events; library "
            f"torch.tanh(x) * 1.5 {fmt(r['library_device_ms'])} / {r['library_ms']:.5f}; bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}; bytes {r['bytes_ms']:.6f}), share "
            f"{fmt(r['share'], '.3f')}")
    if SMALL in out["sizes"]:
        small, large = out["sizes"][SMALL], out["sizes"]["2^26"]
        out["settled"] = (large["share"] is not None and large["share"] >= 0.5
                          and small["vs_floor"] is not None and small["vs_floor"] <= 1.5)
        log(f"S2a {'settled' if out['settled'] else 'below its bound: redesign'}: "
            f"share at 2^26 {fmt(large['share'], '.3f')} (>= 0.5), {SMALL} at "
            f"{fmt(small['vs_floor'], '.2f')}x the floor (<= 1.5)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(run(args.iters)))


if __name__ == "__main__":
    main()
