"""The bare matrix products of the port (S1: ``int8_mm_raw``, ``bf16_mm_raw``;
S2b: ``repro.mm``) on the CPU, and what of their CUDA kernel
(``ssdx_torch/csrc/gemm_sm90.cu``) can be checked without a card.

* S1's plain versions against the body of the TPU kernel,
  ``scripts/bench_int8_mxu.py::_pallas_mm`` (``jnp.dot`` of one block with
  ``preferred_element_type``), written out here because the script fixes its
  grid at 2048^3, and run through ``pl.pallas_call(..., interpret=True)`` at
  M = N = 256, K = 512 with 128-wide blocks: int8 exact; bf16 products summed
  in float32 in another order within 1e-5 relative.
* The wrappers' shape rules for the card (``_check_mm_raw``, ``_check_mm``):
  what the kernels take passes (ragged shapes included) and what they do
  not take raises ``ValueError``.  A CPU tensor takes the plain version,
  whatever its shape, and counts no launch.
* The tile plan of the nt kernels (``ops/gemm.py::plan_nt``): the tiles
  the kernel is built for, one wave where one wave fits, every one of them
  on ``tools/check_gemm.py``'s ragged shapes; and one tile for the nn
  kernel whatever the shape.
* The profiler window's counting rule of ``tools/bench_int8_mm.py``
  (``counted``): a window that lost records gives no time.
* The source itself, with the header it includes (``csrc/sm90.cuh``): TMA
  and wgmma, no mma.sync, WMMA or per-thread cp.async; the old raw modes and
  WMMA tile gone from ``int8_conv.cu`` and ``repro.cu``.
The kernels run on the card in ``python -m ssdx_torch.tools.check_gemm`` and
``chip_smoke.py`` phases 11 and 18.
"""
import functools
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssdx_torch.ops import gemm, repro
from ssdx_torch.ops import int8_conv as ic
from ssdx_torch.tools import bench_int8_mm, check_gemm

CSRC = Path(__file__).resolve().parents[1] / "ssdx_torch" / "csrc"


def _mm_kernel(a_ref, b_ref, o_ref, *, acc_t):
    o_ref[...] = jnp.dot(a_ref[...], b_ref[...], preferred_element_type=acc_t)


def _pallas_mm(a, b, acc_t, block=128):
    """scripts/bench_int8_mxu.py::_pallas_mm at any M, N, K: full-K blocks."""
    (M, K), N = a.shape, b.shape[1]
    return pl.pallas_call(
        functools.partial(_mm_kernel, acc_t=acc_t),
        grid=(M // block, N // block),
        in_specs=[pl.BlockSpec((block, K), lambda i, j: (i, 0)),
                  pl.BlockSpec((K, block), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((block, block), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((M, N), acc_t), interpret=True)(a, b)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_s1_plain_versions_equal_the_tpu_kernel_body(kind):
    rng = np.random.default_rng(6)
    a8 = rng.integers(-127, 128, (256, 512)).astype(np.int8)
    b8 = rng.integers(-127, 128, (256, 512)).astype(np.int8)  # b_t [N,K]
    if kind == "int8":
        ref = np.asarray(_pallas_mm(jnp.asarray(a8), jnp.asarray(b8.T), jnp.int32))
        got = ic.int8_mm_raw_ref(torch.as_tensor(a8), torch.as_tensor(b8))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        a = (a8.astype(np.float32) / 127).astype(jnp.bfloat16)
        b = (b8.astype(np.float32) / 127).astype(jnp.bfloat16)
        ref = np.asarray(_pallas_mm(jnp.asarray(a), jnp.asarray(b.T), jnp.float32))
        to_torch = lambda x: torch.as_tensor(x.astype(np.float32)).to(torch.bfloat16)
        got = ic.bf16_mm_raw_ref(to_torch(a), to_torch(b))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------------- shape rules


def _nt_args(dtype, M, N, K, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        mk = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)
    else:
        mk = lambda *s: torch.randn(*s, generator=g).to(torch.bfloat16)
    return mk(M, K), mk(N, K)


@pytest.mark.parametrize("fn,ref,dtype,shape", [
    (ic.int8_mm_raw, ic.int8_mm_raw_ref, torch.int8, (1000, 48, 80)),
    (ic.int8_mm_raw, ic.int8_mm_raw_ref, torch.int8, (1, 16, 16)),
    (ic.bf16_mm_raw, ic.bf16_mm_raw_ref, torch.bfloat16, (1000, 48, 80)),
    (ic.bf16_mm_raw, ic.bf16_mm_raw_ref, torch.bfloat16, (3, 16, 8))])
def test_nt_wrappers_take_ragged_shapes(fn, ref, dtype, shape):
    M, N, K = shape
    a, b_t = _nt_args(dtype, M, N, K)
    ic._check_mm_raw(a, b_t, dtype, "mm")  # the kernel takes it
    before = ic.launches_raw
    got = fn(a, b_t)
    assert ic.launches_raw == before and got.shape == (M, N)
    torch.testing.assert_close(got, ref(a, b_t), rtol=0, atol=0)
    if dtype == torch.int8:
        np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64)
                                      @ b_t.numpy().astype(np.int64).T)


@pytest.mark.parametrize("dtype,shapes", [
    (torch.int8, ((4, 24), (16, 24))),      # K not a multiple of 16
    (torch.int8, ((4, 32), (24, 32))),      # N not a multiple of 16
    (torch.int8, ((4, 32), (16, 48))),      # K differs
    (torch.int8, ((0, 32), (16, 32))),      # no rows
    (torch.bfloat16, ((4, 12), (16, 12))),  # K not a multiple of 8
    (torch.bfloat16, ((4, 16), (8, 16)))])  # N not a multiple of 16
def test_nt_wrappers_refuse_what_the_kernel_does_not_take(dtype, shapes):
    (M, K), (N, K2) = shapes
    a = torch.zeros(M, K, dtype=dtype)
    b_t = torch.zeros(N, K2, dtype=dtype)
    with pytest.raises(ValueError):
        ic._check_mm_raw(a, b_t, dtype, "mm")


def test_nt_wrappers_refuse_other_types_and_ranks():
    a, b_t = _nt_args(torch.int8, 16, 16, 16)
    with pytest.raises(ValueError, match="takes two"):
        ic._check_mm_raw(a, b_t.to(torch.bfloat16), torch.int8, "int8_mm_raw")
    with pytest.raises(ValueError, match="takes two"):
        ic._check_mm_raw(a, b_t, torch.bfloat16, "bf16_mm_raw")
    with pytest.raises(ValueError):
        ic._check_mm_raw(a[None], b_t, torch.int8, "int8_mm_raw")
    with pytest.raises(ValueError, match="unsupported device"):
        ic.int8_mm_raw(a.to("meta"), b_t.to("meta"))


def test_mm_takes_a_ragged_shape_and_its_shards_agree():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1008, 96, generator=g).to(torch.bfloat16)
    y = torch.randn(96, 192, generator=g).to(torch.bfloat16)
    repro._check_mm(x, y)  # the kernel takes it
    before = repro.launches_mm
    whole = repro.mm(x, y)
    assert repro.launches_mm == before and whole.shape == (1008, 192)
    torch.testing.assert_close(whole, x.float() @ y.float(), rtol=0, atol=0)
    assert torch.equal(repro.mm(x[512:], y), whole[512:])


@pytest.mark.parametrize("shapes", [
    ((24, 32), (32, 64)),   # M not a multiple of 16
    ((16, 32), (32, 96)),   # N not a multiple of 64
    ((16, 48), (48, 64)),   # K not a multiple of 32
    ((16, 32), (64, 64)),   # K differs
    ((0, 32), (32, 64))])   # no rows
def test_mm_refuses_what_the_kernel_does_not_take(shapes):
    x = torch.zeros(*shapes[0], dtype=torch.bfloat16)
    y = torch.zeros(*shapes[1], dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        repro._check_mm(x, y)


def test_mm_refuses_other_types_and_devices():
    x = torch.zeros(16, 32, dtype=torch.bfloat16)
    y = torch.zeros(32, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        repro._check_mm(x.float(), y)
    with pytest.raises(ValueError, match="unsupported device"):
        repro.mm(x.to("meta"), y.to("meta"))


@pytest.mark.parametrize("kind", ["int8", "bf16", "mm"])
def test_cpu_route_is_the_plain_version_whatever_the_shape(kind):
    """On the CPU the wrappers do not apply the kernel's shape rules: N = 24
    (nt) and M = 24, N = 96, K = 48 (nn) are computed, not refused."""
    g = torch.Generator().manual_seed(7)
    if kind == "mm":
        x = torch.randn(24, 48, generator=g).to(torch.bfloat16)
        y = torch.randn(48, 96, generator=g).to(torch.bfloat16)
        with pytest.raises(ValueError):
            repro._check_mm(x, y)
        before = repro.launches_mm
        torch.testing.assert_close(repro.mm(x, y), repro.mm_ref(x, y), rtol=0, atol=0)
        assert repro.launches_mm == before
        return
    dtype = torch.int8 if kind == "int8" else torch.bfloat16
    fn, ref = ((ic.int8_mm_raw, ic.int8_mm_raw_ref) if kind == "int8"
               else (ic.bf16_mm_raw, ic.bf16_mm_raw_ref))
    a, b_t = _nt_args(dtype, 5, 24, 32, seed=7)
    with pytest.raises(ValueError):
        ic._check_mm_raw(a, b_t, dtype, "mm")
    before = ic.launches_raw
    torch.testing.assert_close(fn(a, b_t), ref(a, b_t), rtol=0, atol=0)
    assert ic.launches_raw == before


def test_aligned_copies_only_a_misaligned_operand():
    x = torch.randn(4, 64).to(torch.bfloat16)
    assert gemm.aligned(x) is x
    odd = torch.randn(5, 7).to(torch.bfloat16)[1:]  # starts 14 bytes in
    assert odd.data_ptr() % 16 != 0
    fixed = gemm.aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and fixed.is_contiguous() and torch.equal(fixed, odd)


# --------------------------------------------------------------- tile plan


@pytest.mark.parametrize("M,N,want", [
    (2048, 2048, (128, 256)),   # 128 tiles: one wave on 132 SMs
    (2048, 1024, (128, 128)),   # 128 tiles of 128 x 128 rather than 64 of 128 x 256
    (1024, 1024, (64, 128)),    # 128 tiles of 64 x 128 rather than 64 of 128 x 128
    (1000, 48, (64, 128)),      # one narrow column of tiles
    (8192, 8192, (128, 256))])  # many waves: the widest tile moves the fewest bytes
def test_plan_nt_picks_the_tile_by_waves(M, N, want):
    assert gemm.plan_nt(M, N) == want


def test_plan_nt_passes_over_a_larger_tile_only_for_fewer_waves():
    waves = lambda M, N, t: -(-(-(-M // t[0]) * -(-N // t[1])) // 132)
    for M in (1, 64, 300, 1024, 2048, 4096):
        for N in (16, 48, 256, 1024, 2048):
            tile = gemm.plan_nt(M, N)
            assert tile in gemm.TILES
            for other in gemm.TILES:
                if other[0] * other[1] > tile[0] * tile[1]:
                    assert waves(M, N, other) >= waves(M, N, tile), (M, N, tile, other)


def test_check_gemm_ragged_shapes_take_every_tile():
    """check_gemm holds every tile the nt kernels are built for against the
    plain version through the wrappers, on an H100's 132 SMs."""
    assert {gemm.plan_nt(M, N) for M, N, _ in check_gemm.NT_RAGGED} == set(gemm.TILES)


def test_nn_tile_is_one_for_every_shape():
    """The nn kernel's tile, and with it its order over K, never depends on
    M: neither gemm.nn nor the C entry point takes a tile, and the source
    builds the nn kernel in one tile."""
    assert list(inspect.signature(gemm.nn).parameters) == ["x", "y", "out"]
    assert list(inspect.signature(gemm.nt).parameters) == ["a", "b_t", "out"]
    src = _src("gemm_sm90.cu")
    entry = re.search(r'extern "C" int ssdx_gemm_bf16f32_nn\(([^)]*)\)', src).group(1)
    assert "bm" not in entry and "bn" not in entry
    assert re.findall(r"launch<\w+, (\d+), (\d+), true>", src) == [("64", "128")]
    assert re.findall(r"gemm\.nn\(([^)]*)\)", inspect.getsource(repro.mm)) == ["xc, yc, out"]


# ---------------------------------------------------------- profiler window


GEMM = "void (anonymous namespace)::gemm_kernel<int, 128, 256, false>(CUtensorMap_st, int, int)"


@pytest.mark.parametrize("names,kernel,ok", [
    ([GEMM] * 20, "gemm_kernel", True),
    ([GEMM] * 19, "gemm_kernel", False),                       # one record lost
    ([GEMM] * 20 + ["Memset (Device)"] * 3, "gemm_kernel", True),  # others do not count
    (["tanh"] * 20 + ["mul"] * 20, None, True),                # two kernels a call
    (["tanh"] * 20 + ["mul"] * 10, None, False),               # half of one lost
    (["tanh"] * 40, None, True),                               # one name twice a call
    ([], None, False)])                                        # nothing recorded
def test_device_time_counts_whole_windows_only(names, kernel, ok):
    got = bench_int8_mm.counted(names, 20, kernel)
    assert (got is not None) == ok
    if ok and kernel is not None:
        assert len(got) == 20 and all(kernel in n for n in got)


def test_short_name_drops_return_type_namespace_and_parameters():
    assert bench_int8_mm.short_name([GEMM]) == "gemm_kernel<int, 128, 256, false>"
    assert bench_int8_mm.short_name([]) is None


# ------------------------------------------------------------------ source


def _src(name):
    """The source with the csrc headers it includes (the main loop is
    csrc/sm90.cuh's), code only, comments out."""
    text = (CSRC / name).read_text()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        text += (CSRC / header).read_text()
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("needle", ["cp.async.bulk.tensor.2d", "wgmma.mma_async",
                                    "mbarrier.try_wait.parity", "setmaxnreg",
                                    "__grid_constant__ const CUtensorMap"])
def test_gemm_source_uses_tma_and_wgmma(needle):
    assert needle in _src("gemm_sm90.cu")


@pytest.mark.parametrize("pattern", [r"mma\.sync", r"wmma", r"cp\.async\.(ca|cg)", r"ldmatrix",
                                     r"cublas|cutlass/gemm"])
def test_gemm_source_has_no_older_tensor_core_path(pattern):
    assert not re.search(pattern, _src("gemm_sm90.cu"))


def test_gemm_source_exports_what_the_binding_loads():
    src = _src("gemm_sm90.cu")
    for name in ("ssdx_gemm_s8s32_nt", "ssdx_gemm_bf16f32_nt", "ssdx_gemm_bf16f32_nn"):
        assert re.search(rf'extern "C" int {name}\(', src), name
    # every tile the plan may ask for is built, and no other
    built = {tuple(map(int, t)) for t in re.findall(r"bm == (\d+) && bn == (\d+)", src)}
    assert built == set(gemm.TILES)


@pytest.mark.parametrize("name,gone", [
    ("int8_conv.cu", ["ssdx_int8_mm_raw", "ssdx_bf16_mm_raw", "kRawInt32", "kRawBf16",
                      "launch_raw", "m16n8k16"]),
    ("repro.cu", ["mm_kernel", "ssdx_repro_mm", "wmma"])])
def test_old_matmul_kernels_are_gone(name, gone):
    src = _src(name)
    for word in gone:
        assert word not in src, (name, word)
