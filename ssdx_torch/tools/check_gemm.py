"""Check the bare matrix-product kernels of ``csrc/gemm_sm90.cu`` on one GPU.

    python -m ssdx_torch.tools.check_gemm

Builds the source and runs each entry point through its wrapper against its
plain version on the card:
  nt int8  ``int8_mm_raw`` (S1) on ragged shapes whose plans take every
           block tile of ``gemm.TILES``, and on full-size ones: equal to
           ``int8_mm_raw_ref`` (a float64 matmul, exact) and to
           ``torch._int_mm``, bit for bit;
  nt bf16  ``bf16_mm_raw`` (S1's control) on the same shapes: within
           ``RTOL`` of the largest magnitude of ``bf16_mm_raw_ref``;
  nn bf16  ``repro.mm`` (S2b) on ragged and full-size shapes, with M, N and
           K all different so that a transposed operand cannot pass: within
           ``RTOL``; and a 512-row shard equal bit for bit to the same rows
           of the whole product (the repro tool's inside = outside);
  threads  both kinds again from a thread that has made no CUDA call (the
           repro tool runs its cases in one): the same results.
Prints one line per case and exits non-zero on the first disagreement.
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
import threading

import torch

from ssdx_torch.ops import _build, gemm
from ssdx_torch.ops import int8_conv as ic
from ssdx_torch.ops import repro

RTOL = 1e-3  # of the largest magnitude: exact bf16 products summed in f32 in another order

# (M, N, K) of the nt kernels: ragged M, N past a tile, K past a stage, the
# plans of the last two 128 x 128 and 128 x 256; then full-size shapes
NT_RAGGED = ((1, 16, 16), (1000, 48, 80), (300, 272, 400), (1100, 1008, 272), (2000, 2000, 400))
NT_FULL = ((1024, 1024, 1024), (2048, 1024, 512), (2048, 2048, 2048))
# (M, N, K) of the nn kernel: M, N and K all different
NN_CASES = ((16, 64, 32), (1008, 192, 96), (208, 320, 544), (1024, 1024, 1024))


def _int8(g, *shape):
    return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)


def _bf16(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def _rel(got, ref) -> float:
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def check_nt(M, N, K, seed=0, log=print) -> tuple[float, float]:
    """int8 and bf16 nt kernels at one shape, through their wrappers;
    returns (int8 mismatches, bf16 relative error)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a, b_t = _int8(g, M, K), _int8(g, N, K)
    got = ic.int8_mm_raw(a, b_t)
    ref = ic.int8_mm_raw_ref(a, b_t)
    bad = int((got != ref).sum())
    if M > 16 and N % 8 == 0 and K % 8 == 0:  # torch._int_mm's own shape rules
        bad += int((got != torch._int_mm(a, b_t.t())).sum())
    af, bf = _bf16(g, M, K), _bf16(g, N, K)
    rel = _rel(ic.bf16_mm_raw(af, bf), ic.bf16_mm_raw_ref(af, bf))
    torch.cuda.synchronize()
    bm, bn = gemm.plan_nt(M, N, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"nt {M}x{N}x{K} tile {bm}x{bn}: int8 {bad} mismatches, "
        f"bf16 max |k-r| {rel:.2e} of max |r|")
    if bad or not rel <= RTOL:
        raise AssertionError(f"nt kernel disagrees at {M}x{N}x{K} tile {bm}x{bn}: {bad}, {rel}")
    return float(bad), rel


def check_nn(M, N, K, seed=0, log=print) -> float:
    """The nn kernel at one shape, through repro.mm; returns the relative
    error."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, y = _bf16(g, M, K), _bf16(g, K, N)
    rel = _rel(repro.mm(x, y), repro.mm_ref(x, y))
    log(f"nn {M}x{N}x{K}: max |k-r| {rel:.2e} of max |r|")
    if not rel <= RTOL:
        raise AssertionError(f"nn kernel disagrees at {M}x{N}x{K}: {rel}")
    return rel


def check_shard(x, y, rows=512, log=print) -> None:
    """``mm(x[rows:], y)`` equals ``mm(x, y)[rows:]`` bit for bit."""
    whole, shard = repro.mm(x, y), repro.mm(x[rows:], y)
    same = torch.equal(shard, whole[rows:])
    log(f"nn shard x[{rows}:] of {tuple(x.shape)} against the same rows of the whole "
        f"product: {'equal bit for bit' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("a shard's rows differ from the whole product's")


def check_in_thread(log=print) -> None:
    """An nt and an nn product from a fresh thread equal the same products
    from this one, bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(2)
    a, b_t = _int8(g, 300, 400), _int8(g, 272, 400)
    x, y = _bf16(g, 208, 544), _bf16(g, 544, 320)
    here = ic.int8_mm_raw(a, b_t), repro.mm(x, y)
    there = []
    th = threading.Thread(target=lambda: there.extend((ic.int8_mm_raw(a, b_t), repro.mm(x, y))))
    th.start()
    th.join()
    torch.cuda.synchronize()
    same = len(there) == 2 and all(torch.equal(p, q) for p, q in zip(here, there))
    log(f"nt and nn from a fresh thread: {'equal bit for bit' if same else 'FAILED or DIFFERENT'}")
    if not same:
        raise AssertionError("the kernels do not run alike from a fresh thread")


def run(log=print) -> dict:
    """Every check; returns the largest errors seen."""
    errs = {"int8": 0.0, "bf16": 0.0, "nn": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = {gemm.plan_nt(M, N, sms) for M, N, _ in NT_RAGGED}
    if planned != set(gemm.TILES):
        raise AssertionError(f"the ragged shapes take the tiles {planned}, not all of {gemm.TILES}")
    for M, N, K in NT_RAGGED + NT_FULL:
        bad, rel = check_nt(M, N, K, log=log)
        errs["int8"], errs["bf16"] = max(errs["int8"], bad), max(errs["bf16"], rel)
    for M, N, K in NN_CASES:
        errs["nn"] = max(errs["nn"], check_nn(M, N, K, log=log))
    g = torch.Generator(device="cuda").manual_seed(1)
    check_shard(_bf16(g, 1024, 1024), _bf16(g, 1024, 1024), log=log)
    check_in_thread(log=log)
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("check_gemm: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build("gemm_sm90")
    for line in _build.build_logs.get("gemm_sm90", "").splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print(f"  ptxas[gemm_sm90]: {line.strip()}")
    errs = run()
    print(f"check_gemm: all cases agree; largest errors {errs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
