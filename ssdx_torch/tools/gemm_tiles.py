"""Device time of the matmul kernels of ``csrc/gemm_sm90.cu`` by block tile
and by K, on one GPU: the measurements behind ``ops/gemm.py``'s tile plan.

    python -m ssdx_torch.tools.gemm_tiles

Prints, as profiler device ms per call (``bench_int8_mm.device_ms``):
  tiles  the nt kernels (int8 -> int32, bf16 -> f32) at 2048^3 and 1024^3
         with every block tile of ``gemm.TILES``, the planned one marked,
         and the nn kernel (its one 64 x 128 tile) at 1024^3, each beside
         the library call of the same function (``torch._int_mm``,
         ``torch.mm(out_dtype=float32)``);
  K      the nt kernels at M = N = 2048 (their planned 128 x 256 tile) and
         the nn kernel at M = N = 1024 over K, with a least-squares line:
         its slope is the main loop's time per 1024 of K, its intercept
         what a launch costs whatever K (pipeline fill, epilogue, launch).
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ssdx_torch.ops import gemm
from ssdx_torch.tools.bench_int8_mm import device_ms, fmt

KERNEL = "gemm_kernel"  # the kernels' name in the profiler


def _operands(g, dtype, rows, cols, n=3):
    if dtype == torch.int8:
        return [torch.randint(-127, 128, (rows, cols), generator=g, device="cuda",
                              dtype=torch.int8) for _ in range(n)]
    return [torch.randn(rows, cols, generator=g, device="cuda").to(dtype) for _ in range(n)]


def _nt_tile(a, b_t, out, tile):
    """``gemm.nt`` in the given block tile rather than the planned one."""
    (M, K), N = a.shape, b_t.shape[0]
    index = a.device.index
    err = gemm._kernels()[a.dtype](a.data_ptr(), b_t.data_ptr(), out.data_ptr(), M, N, K, *tile,
                                   index, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"gemm_sm90 nt kernel launch failed: CUDA error {err}")


def _nt_ms(g, dtype, M, N, K, tile):
    a, b = _operands(g, dtype, M, K), _operands(g, dtype, N, K)
    out = torch.empty(M, N, dtype=torch.int32 if dtype == torch.int8 else torch.float32,
                      device="cuda")
    return device_ms(lambda x, y: _nt_tile(x, y, out, tile), list(zip(a, b)), 30, kernel=KERNEL)


def _nn_ms(g, M, N, K):
    x, y = _operands(g, torch.bfloat16, M, K), _operands(g, torch.bfloat16, K, N)
    out = torch.empty(M, N, dtype=torch.float32, device="cuda")
    return device_ms(lambda p, q: gemm.nn(p, q, out), list(zip(x, y)), 30, kernel=KERNEL)


def tiles(g, log=print) -> None:
    for size in (2048, 1024):
        for dtype in (torch.int8, torch.bfloat16):
            a, b = _operands(g, dtype, size, size), _operands(g, dtype, size, size)
            if dtype == torch.int8:
                lib = device_ms(lambda x, y: torch._int_mm(x, y.t()), list(zip(a, b)), 30)
                name = "torch._int_mm"
            else:
                lib = device_ms(lambda x, y: torch.mm(x, y.t(), out_dtype=torch.float32),
                                list(zip(a, b)), 30)
                name = "torch.mm(out_dtype=float32)"
            plan = gemm.plan_nt(size, size)
            row = ", ".join(f"{bm}x{bn}{'*' if (bm, bn) == plan else ''} "
                            f"{fmt(_nt_ms(g, dtype, size, size, size, (bm, bn)), '.5f')}"
                            for bm, bn in gemm.TILES)
            log(f"nt {str(dtype)[6:]} {size}^3 by tile (* planned): {row}; "
                f"{name} {fmt(lib, '.5f')}")
    x, y = _operands(g, torch.bfloat16, 1024, 1024), _operands(g, torch.bfloat16, 1024, 1024)
    lib = device_ms(lambda p, q: torch.mm(p, q, out_dtype=torch.float32), list(zip(x, y)), 30)
    log(f"nn bfloat16 1024^3, tile 64x128: {fmt(_nn_ms(g, 1024, 1024, 1024), '.5f')}; "
        f"torch.mm(out_dtype=float32) {fmt(lib, '.5f')}")


def k_sweep(g, log=print) -> None:
    runs = [(f"nt {str(d)[6:]} 2048x2048, tile 128x256",
             lambda K, d=d: _nt_ms(g, d, 2048, 2048, K, (128, 256)), (128, 1024, 2048, 4096))
            for d in (torch.int8, torch.bfloat16)]
    runs.append(("nn bfloat16 1024x1024, tile 64x128",
                 lambda K: _nn_ms(g, 1024, 1024, K), (64, 512, 1024, 2048)))
    for name, fn, ks in runs:
        ms = [fn(K) for K in ks]
        got = [(k, t) for k, t in zip(ks, ms) if t is not None]
        line = ""
        if len(got) >= 2:
            slope, icept = np.polyfit(*np.asarray(got, float).T, 1)
            line = f"; line: {slope * 1024:.5f} ms per 1024 of K + {icept:.5f} ms"
        log(f"{name} by K: " + ", ".join(f"K={k} {fmt(t, '.5f')}" for k, t in zip(ks, ms)) + line)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_tiles: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    g = torch.Generator(device="cuda").manual_seed(0)
    tiles(g)
    k_sweep(g)


if __name__ == "__main__":
    main()
