// Int8 convolutions of the quantized SSD300 serving path, for Hopper (sm_90a).
//
// Replaces: ssdx/ops/pallas_int8_conv.py, int8_conv (the TPU kernels
// _conv3_kernel, B4a, and _mm_kernel, B4b).
//
// Contract (ssdx_torch/ops/int8_conv.py): x [B,H,W,Cin] int8 NHWC, weights
// [Cout][kh][kw][Cin] int8 (K = kh*kw*Cin contiguous per output channel),
// w_scale, bias, inv_ns [Cout] float32.  For every output pixel and channel
//   acc = sum over taps and cin of x * w            (int32, exact)
//   y   = max(acc * w_scale + bias, 0)              (two roundings, no FMA)
//   q   = clip(rint(y * inv_ns), -127, 127)         (int8; rint = half to even)
//   tap = y rounded once to bf16, or y itself in f32
// and out_q and/or out_tap [B,Ho,Wo,Cout] are written.  The results equal
// the plain PyTorch version bit for bit: the contraction is integer math,
// exact in any order, and the epilogue repeats its float32 operations one by
// one (__fmul_rn / __fadd_rn, and the file is built with -fmad=false).
//
// Design: one implicit GEMM, M = B*Ho*Wo output pixels by N = Cout by
// K = kh*kw*Cin, on the main loop of sm90.cuh (the one of the bare matmuls in
// gemm_sm90.cu): a ring of k-blocks in shared memory, full and empty
// mbarriers, consumer warpgroups on wgmma.mma_async s8.s8 -> s32 with 64 x BN
// accumulators, a loader warpgroup (or warp).  One kernel takes every layer:
// 3x3 of any stride, dilation and padding, and 1x1 as the one-tap case.  The
// caller plans the launch (ops/int8_conv.py, plan): the loader, the block
// tile (64 x 128 one block an SM, 128 x 128 one or two) and the k-block
// (128 bytes in the 128-byte swizzle, or 64 in the 64-byte one), and gives
// the loader its addresses (a_load there): tables of rows and k-blocks in
// device memory and the im2col map's corner bounds.
//   B, the weights [Cout, K], is a plain K-major matrix: one TMA copy of
// BN rows x KB bytes per stage, zero-filled past K and Cout.
//   A is the im2col matrix [M, K], never formed.  Three loaders fill it:
//   TILED (1x1): x is the [M, Cin] matrix, one TMA copy a stage.
//   IM2COL (3x3, Cin a multiple of 64): one TMA copy a stage in im2col mode.
// The map's box walks the window corners of BM consecutive output pixels,
// between the corner bounds (-pad and pad - 2 * dil) at `stride` steps along
// W, then H, then N, and every pixel is moved by the k-block's tap offsets,
// (kx, ky) * dil; the copy reads KB channels there, zeros where the pixel
// lies outside x.  The loader's thread reads the corner of the tile's first
// pixel from the row table and the channel and offsets of each k-block from
// the k-block table; the hardware does the rest.  Cin = 64 takes 64-byte
// k-blocks, one tap each.
//   COPIES (the other 3x3 layers: Cin not a multiple of 64): the loader's
// 128 threads copy 16-byte chunks with cp.async, each at the pixel its tap
// reaches, zero-filled by the copy's source size where that lies in the
// padding, past M or past K; a k-block may span taps.  Thread t copies chunk
// t % 8 of rows t / 8 + 16 i: the row table gives each row's image and
// window corner, the k-block table each chunk's tap offsets and channel; the
// row's swizzle is fixed by t.  Each thread's copies arrive on the stage's full barrier when
// they land (cp.async.mbarrier.arrive.noinc): 128 arrivals and the one with
// B's bytes a phase; the consumers fence the stage into the async proxy
// before wgmma reads it.  On an H100 this loader feeds the main loop at
// about half the rate of the TMA ones (PERF.md), so the planner keeps it to
// what they cannot load.
//   The epilogue reads the accumulator fragment, applies the contract's
// float32 steps with the tile's w_scale, bias and inv_ns held in shared
// memory, stages the int8 and tap tiles in the idle ring in the 128-byte
// swizzle, and TMA stores them as [M, Cout] rows, clipped at M and Cout.  A
// block spends about 9 us on its prologue and epilogue on an H100, with
// nothing else on its SM: the two-block 128 x 128 tile (a 96 KB ring each,
// one loader warp, 288 threads of up to 112 registers) runs one block's
// epilogue beside the other's main loop, and the planner takes it wherever
// a TMA loader has a wave of such tiles.
//
// Bound: 2*M*N*K operations at the dense int8 peak (1,979 TOP/s) against the
// input, weights and outputs moved once at 3.35 TB/s.  The 3x3 layers are
// bound by operations, the 1x1 layers of 1024 channels by bytes.  The 3x3
// loaders read each input pixel up to nine times, from L2.
#include "sm90.cuh"

namespace {

using namespace sm90;

// How the loader fills A, the activations (ops/int8_conv.py, plan).
enum Loader { COPIES = 0, TILED = 1, IM2COL = 2 };

struct Geom {
  int H, W, Cin, Cout;
  int M;  // B*Ho*Wo
  int K;  // bytes of one weight row: ks*ks*Cin
  int loader;  // Loader
};

// 16 bytes from global to shared memory, of which the first src_bytes are
// read and the rest zero-filled (src_bytes 0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The map's box of x [B,H,W,C] in im2col mode (pixels x channel bytes):
// the pixels the box walks from the corner (w, h, n), each moved by the
// tap's offsets (ow, oh), channels from c; zeros where they fall outside x.
__device__ __forceinline__ void tma_load_im2col(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                int c, int w, int h, int n, uint16_t ow,
                                                uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c), "r"(w), "r"(h), "r"(n), "h"(ow), "h"(oh)
      : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed,
// counting as one of the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ float relu_affine(int acc, float ws, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), ws), b), 0.0f);
}

// clip(rint(y * inv), -127, 127) as the bits of an int8.  Clipping first
// gives the same value (rint maps [-127, 127] into itself), and adding
// 1.5 * 2^23 rounds to an integer, ties to even, which the low byte of the
// sum's bits then holds: full-rate adds in place of two conversions.
__device__ __forceinline__ uint32_t requant(float y, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(y, inv), -127.0f), 127.0f);
  return (uint32_t)__float_as_int(__fadd_rn(v, 12582912.0f)) & 0xffu;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte `b` of row r of a staged tile: boxes of 64 rows x 128 bytes, 8,192
// bytes apart, each in the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int r, int b) {
  return (b >> 7) * 8192 + r * 128 + ((((b >> 4) & 7) ^ (r & 7)) << 4) + (b & 15);
}

// ------------------------------------------------------------------ loaders

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TILED and IM2COL, by one thread: per stage, the TMA copies of A and B.
// im2col: `corner` is the tile's row (w, h, n), `kblocks` the k-block table
// (channel, offset w, offset h), one entry read a stage ahead.
template <class T, int KB>
__device__ __forceinline__ void load_tma(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                         const CUtensorMap* map_x, const CUtensorMap* map_w,
                                         const int4* __restrict__ kblocks, const Geom g,
                                         int4 corner, int m0, int n0, int nk) {
  prefetch_map(map_x);
  prefetch_map(map_w);
  const bool im2col = g.loader == IM2COL;
  int4 next = im2col ? __ldg(kblocks) : make_int4(0, 0, 0, 0);
  for (int kb = 0; kb < nk; ++kb) {
    const int4 q = next;
    if (im2col && kb + 1 < nk) next = __ldg(kblocks + kb + 1);
    const int s = kb % T::STAGES;
    mbar_wait(&empty[s], ((kb / T::STAGES) & 1) ^ 1);  // the first round passes at once
    unsigned char* sa = smem + s * T::STAGE_BYTES;
    mbar_expect_tx(&full[s], T::STAGE_BYTES);  // out-of-bounds parts count, zero-filled
    if (im2col)
      tma_load_im2col(sa, map_x, &full[s], q.x, corner.x, corner.y, corner.z, (uint16_t)q.y,
                      (uint16_t)q.z);
    else
      tma_load_2d(sa, map_x, &full[s], kb * KB, m0);
    tma_load_2d(sa + T::A_BYTES, map_w, &full[s], kb * KB, n0);
  }
}

// COPIES, by the loader warpgroup's thread t: the tile's rows of the row
// table (n * H * W, top, left) into shared memory, then per stage the TMA
// copy of B (thread 0) and 16-byte copies of A, with this thread's chunk of
// the k-block table (dy, dx, channel, in K) read a stage ahead.
template <class T, int BM>
__device__ __forceinline__ void load_copies(const int8_t* __restrict__ x,
                                            const int4* __restrict__ row_table,
                                            const int4* __restrict__ kblocks, unsigned char* smem,
                                            int4* rows, uint64_t* full, uint64_t* empty,
                                            const CUtensorMap* map_w, const Geom g, int m0,
                                            int n0, int nk, int t) {
  for (int r = t; r < BM; r += 128) rows[r] = __ldg(row_table + m0 + r);
  named_barrier(1, 128);
  if (t == 0) prefetch_map(map_w);
  const int c = t & 7, r0 = t >> 3;  // chunk of the k-block, first row (and r % 8 of all)
  const uint32_t a0 = smem_u32(smem) + r0 * 128 + ((c ^ (r0 & 7)) << 4);
  int4 next = __ldg(kblocks + c);
  for (int kb = 0; kb < nk; ++kb) {
    const int4 q = next;  // dy, dx, channel, in K
    if (kb + 1 < nk) next = __ldg(kblocks + 8 * (kb + 1) + c);
    const int s = kb % T::STAGES;
    mbar_wait(&empty[s], ((kb / T::STAGES) & 1) ^ 1);
    if (t == 0) {
      mbar_expect_tx(&full[s], T::B_BYTES);
      tma_load_2d(smem + s * T::STAGE_BYTES + T::A_BYTES, map_w, &full[s], kb * BK, n0);
    }
    const uint32_t a = a0 + s * T::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int4 v = rows[r0 + 16 * i];
      const int iy = v.y + q.x, ix = v.z + q.y;
      const bool ok = q.w && (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
      const int8_t* src = x;
      if (ok) src = x + ((long long)v.x + (long long)iy * g.W + ix) * g.Cin + q.z;
      cp_async16(a + i * 16 * 128, src, ok ? 16 : 0);
    }
    cp_async_arrive(&full[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Threads of a block: the consumer warpgroups and a loader warpgroup, or,
// two blocks an SM, a loader warp (TMA loaders only, no setmaxnreg: 288
// threads of up to 112 registers).
template <int BM, int BN, int CTAS>
constexpr int threads() {
  return CTAS == 2 ? Tile<BM, BN>::CONSUMERS * 128 + 32 : Tile<BM, BN>::THREADS;
}

// Block b computes the tile (b / n_tiles, b % n_tiles).  emit_q: write the
// int8 output through map_q; tap_kind 0 = no tap, 1 = bf16, 2 = f32, through
// map_tap.  CTAS blocks share an SM, each on a ring of RING / CTAS bytes;
// KB bytes of K a stage.
template <int BM, int BN, int CTAS, int KB>
__global__ void __launch_bounds__(threads<BM, BN, CTAS>(), CTAS)
conv_kernel(const int8_t* __restrict__ x, const int4* __restrict__ row_table,
            const int4* __restrict__ kblocks, __grid_constant__ const CUtensorMap map_x,
            __grid_constant__ const CUtensorMap map_w,
            __grid_constant__ const CUtensorMap map_q, __grid_constant__ const CUtensorMap map_tap,
            const float* __restrict__ w_scale, const float* __restrict__ bias,
            const float* __restrict__ inv_ns, int emit_q, int tap_kind, Geom g, int n_tiles) {
  using T = Tile<BM, BN, RING / CTAS, KB>;
  constexpr int STAGES = T::STAGES;
  static_assert(CTAS == 1 || T::CONSUMERS == 2, "two blocks an SM: 128-row tiles");
  static_assert(KB == BK || CTAS == 2, "64-byte k-blocks: im2col in the two-block tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int4* rows = reinterpret_cast<int4*>(empty + STAGES);  // COPIES: the tile's rows of row_table
  float* cols = reinterpret_cast<float*>(rows + BM);    // w_scale, bias, inv_ns of BN columns
  const int tile_m = blockIdx.x / n_tiles, m0 = tile_m * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int wg = threadIdx.x / 128;
  const int nk = (g.K + KB - 1) / KB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // COPIES: the loader's 128 threads, and the arrive with B's bytes; else
      // the one arrive with the bytes of A and B
      mbar_init(&full[s], g.loader == COPIES ? 128 + 1 : 1);
      mbar_init(&empty[s], 4 * T::CONSUMERS);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {
    // ---------------------------------------------------------------- loader
    if constexpr (CTAS == 1 && T::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int t = threadIdx.x - T::CONSUMERS * 128;
    if (g.loader != COPIES) {
      if (t == 0)
        load_tma<T, KB>(smem, full, empty, &map_x, &map_w, kblocks, g,
                        g.loader == IM2COL ? __ldg(row_table + tile_m) : make_int4(0, 0, 0, 0),
                        m0, n0, nk);
    } else if constexpr (CTAS == 1 && KB == BK) {
      load_copies<T, BM>(x, row_table, kblocks, smem, rows, full, empty, &map_w, g, m0, n0, nk,
                         t);
    }
  } else {
    // ------------------------------------------------------------- consumers
    if constexpr (CTAS == 1 && T::CONSUMERS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    for (int i = threadIdx.x; i < BN; i += 128 * T::CONSUMERS) {  // read in the epilogue
      const int n = n0 + i;
      const bool in = n < g.Cout;
      cols[i] = in ? w_scale[n] : 0.0f;
      cols[BN + i] = in ? bias[n] : 0.0f;
      cols[2 * BN + i] = in && emit_q ? inv_ns[n] : 0.0f;
    }
    int acc[BN / 2];
    if (g.loader == COPIES)
      consume<int, BM, BN, false, true, RING / CTAS, KB>(acc, smem, full, empty, nk, wg);
    else
      consume<int, BM, BN, false, false, RING / CTAS, KB>(acc, smem, full, empty, nk, wg);
    const int lane = threadIdx.x & 31;

    // ------------------------------------------------------------- epilogue
    // Once every consumer is done with the ring, each warpgroup stages its
    // 64 rows there: the int8 tile (BN / 128 boxes), then the tap tile (BN /
    // 64 boxes of bf16 or BN / 32 of f32); a thread's two neighbouring
    // columns go in one store.  One thread hands the boxes to TMA.
    named_barrier(2, 128 * T::CONSUMERS);  // also makes cols visible
    unsigned char* sq = smem + wg * 64 * BN * 5;
    unsigned char* st = sq + 64 * BN;
    const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * (lane & 3);  // this thread's columns n and n + 1
      const float2 ws = *reinterpret_cast<const float2*>(cols + n);
      const float2 bs = *reinterpret_cast<const float2*>(cols + BN + n);
      const float2 inv = *reinterpret_cast<const float2*>(cols + 2 * BN + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float y0 = relu_affine(acc[4 * j + 2 * h], ws.x, bs.x);
        const float y1 = relu_affine(acc[4 * j + 2 * h + 1], ws.y, bs.y);
        if (emit_q)
          *reinterpret_cast<uint16_t*>(sq + swizzled(r, n)) =
              (uint16_t)(requant(y0, inv.x) | (requant(y1, inv.y) << 8));
        if (tap_kind == 1)
          *reinterpret_cast<uint32_t*>(st + swizzled(r, 2 * n)) = pack_bf16(y0, y1);
        else if (tap_kind == 2)
          *reinterpret_cast<float2*>(st + swizzled(r, 4 * n)) = make_float2(y0, y1);
      }
    }
    fence_proxy_async();
    named_barrier(3 + wg, 128);
    const int row = m0 + wg * 64;
    if ((threadIdx.x & 127) == 0 && row < g.M) {
      if (emit_q)
        for (int b = 0; b < BN / 128 && n0 + 128 * b < g.Cout; ++b)
          tma_store_2d(&map_q, sq + b * 8192, n0 + 128 * b, row);
      const int per_box = tap_kind == 1 ? 64 : 32;  // values of a 128-byte box row
      if (tap_kind)
        for (int b = 0; b < BN / per_box && n0 + per_box * b < g.Cout; ++b)
          tma_store_2d(&map_tap, st + b * 8192, n0 + per_box * b, row);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// -------------------------------------------------------------------- host side

template <int BM, int BN, int CTAS, int KB = BK>
int launch(const void* x, const void* rows, const void* kblocks, const CUtensorMap& map_x,
           const CUtensorMap& map_w, const CUtensorMap& map_q, const CUtensorMap& map_tap,
           const void* w_scale, const void* bias, const void* inv_ns, int emit_q, int tap_kind,
           const Geom& g, int dev, void* stream) {
  using T = Tile<BM, BN, RING / CTAS, KB>;
  constexpr int SMEM = T::SMEM + BM * 16 + 3 * BN * 4;  // + row table + column parameters
  static unsigned long long configured = 0;  // one bit per device
  cudaError_t err =
      reserve_smem((const void*)conv_kernel<BM, BN, CTAS, KB>, SMEM, dev, configured);
  const int n_tiles = (g.Cout + BN - 1) / BN;
  const long long tiles = (long long)((g.M + BM - 1) / BM) * n_tiles;
  if (err == cudaSuccess && (tiles <= 0 || tiles > 0x7fffffffLL)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    conv_kernel<BM, BN, CTAS, KB>
        <<<(unsigned)tiles, threads<BM, BN, CTAS>(), SMEM, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int4*)rows, (const int4*)kblocks, map_x, map_w, map_q, map_tap,
        (const float*)w_scale, (const float*)bias,
        (const float*)inv_ns, emit_q, tap_kind, g, n_tiles);
    err = cudaGetLastError();
  }
  return (int)err;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// x [B,H,W,C] int8 read in im2col mode: boxes of `pixels` output pixels x
// kb channels (128, or 64 in the 64-byte swizzle).  The corners bound the
// window's top-left corner, from `lower` to (W - 1) + `upper` along W (and
// H), walked at `stride`: Wo positions a row.
bool make_im2col_map(CUtensorMap* map, const void* x, int B, int H, int W, int C, int stride,
                     int lower, int upper, int pixels, int kb) {
  static EncodeIm2col enc = nullptr;
  if (enc == nullptr) enc = (EncodeIm2col)driver_entry("cuTensorMapEncodeIm2col");
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  const int lo[2] = {lower, lower}, hi[2] = {upper, upper};
  const cuuint32_t steps[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, lo, hi,
             (cuuint32_t)kb, (cuuint32_t)pixels, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             kb == BK ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_conv(int ks, const void* x, const void* w, const void* rows, const void* kblocks,
                const void* w_scale, const void* bias, const void* inv_ns, void* out_q,
                void* out_tap, int B, int H, int W, int Cin, int Cout, int Ho, int Wo, int stride,
                int lower, int upper, int tap_kind, int loader, int bm, int bn, int ctas, int dev,
                void* stream) {
  const long long M = (long long)B * Ho * Wo;
  if (M <= 0 || M > 0x7fffffffLL || (long long)B * H * W > 0x7fffffffLL || Cin <= 0 ||
      Cin % 16 || Cout <= 0 || Cout % 16 || stride < 1)
    return (int)cudaErrorInvalidValue;
  if (tap_kind < 0 || tap_kind > 2 || (out_q == nullptr && tap_kind == 0) ||
      (out_tap == nullptr) != (tap_kind == 0) || (out_q != nullptr && inv_ns == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || (out_q && !aligned16(out_q)) ||
      (out_tap && !aligned16(out_tap)))
    return (int)cudaErrorInvalidValue;
  if ((loader == TILED) != (ks == 1) || loader < COPIES || loader > IM2COL ||
      (loader != TILED && (rows == nullptr || kblocks == nullptr || !aligned16(rows) ||
                           !aligned16(kblocks))) ||
      (loader == IM2COL && (Cin % 64 || lower < -127 || lower > 0 || upper < -128 || upper > 127)))
    return (int)cudaErrorInvalidValue;
  const OnDevice on(dev);
  if (on.err != cudaSuccess) return (int)on.err;
  // im2col with Cin an odd multiple of 64: 64-byte k-blocks, one tap each,
  // in the two-block 128 x 128 tile only
  const int kb = loader == IM2COL && Cin % BK ? 64 : BK;
  if (kb != BK && (bm != 128 || bn != 128 || ctas != 2)) return (int)cudaErrorInvalidValue;
  const CUtensorMapSwizzle swz =
      kb == BK ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const Geom g{H, W, Cin, Cout, (int)M, ks * ks * Cin, loader};
  CUtensorMap mx = {}, mw, mq = {}, mt = {};
  const int tap_size = tap_kind == 1 ? 2 : 4;
  const CUtensorMapDataType tap_type =
      tap_kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if ((loader == TILED && !make_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Cin, M, BK, bm)) ||
      (loader == IM2COL &&
       !make_im2col_map(&mx, x, B, H, W, Cin, stride, lower, upper, bm, kb)) ||
      !make_map(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.K, Cout, kb, bn, swz) ||
      (out_q && !make_map(&mq, out_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Cout, M, 128, 64)) ||
      (tap_kind && !make_map(&mt, out_tap, tap_type, tap_size, Cout, M, 128 / tap_size, 64)))
    return (int)cudaErrorInvalidValue;
  const int emit_q = out_q != nullptr;
  if (kb != BK)
    return launch<128, 128, 2, 64>(x, rows, kblocks, mx, mw, mq, mt, w_scale, bias, inv_ns,
                                   emit_q, tap_kind, g, dev, stream);
  if (bm == 128 && bn == 128 && ctas == 1)
    return launch<128, 128, 1>(x, rows, kblocks, mx, mw, mq, mt, w_scale, bias, inv_ns,
                               emit_q, tap_kind, g, dev, stream);
  if (bm == 128 && bn == 128 && ctas == 2 && loader != COPIES)
    return launch<128, 128, 2>(x, rows, kblocks, mx, mw, mq, mt, w_scale, bias, inv_ns,
                               emit_q, tap_kind, g, dev, stream);
  if (bm == 64 && bn == 128 && ctas == 1)
    return launch<64, 128, 1>(x, rows, kblocks, mx, mw, mq, mt, w_scale, bias, inv_ns,
                              emit_q, tap_kind, g, dev, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns the CUDA error of the launch (0 = success).  All pointers are
// device pointers on device `dev`, 16-byte aligned; out_q or out_tap may be
// null (tap_kind 0 = no tap, 1 = bf16, 2 = f32; inv_ns is read only with
// out_q).  rows, kblocks, lower and upper are the loader's addresses
// (ops/int8_conv.py, a_load; the tables are null for TILED).  loader is a
// Loader; (bm, bn, ctas) the block tile and blocks an SM: (128, 128, 1),
// (128, 128, 2) with a TMA loader, or (64, 128, 1).

extern "C" int ssdx_int8_conv3(const void* x, const void* w, const void* rows,
                               const void* kblocks, const void* w_scale, const void* bias,
                               const void* inv_ns, void* out_q, void* out_tap, int B, int H,
                               int W, int Cin, int Cout, int Ho, int Wo, int stride, int lower,
                               int upper, int tap_kind, int loader, int bm, int bn, int ctas,
                               int dev, void* stream) {
  return launch_conv(3, x, w, rows, kblocks, w_scale, bias, inv_ns, out_q, out_tap, B, H, W, Cin,
                     Cout, Ho, Wo, stride, lower, upper, tap_kind, loader, bm, bn, ctas, dev,
                     stream);
}

// 1x1 conv: [B*H*W, Cin] . [Cout, Cin]^T with the same epilogue.
extern "C" int ssdx_int8_mm(const void* x, const void* w, const void* rows, const void* kblocks,
                            const void* w_scale, const void* bias, const void* inv_ns,
                            void* out_q, void* out_tap, int B, int H, int W, int Cin, int Cout,
                            int Ho, int Wo, int stride, int lower, int upper, int tap_kind,
                            int loader, int bm, int bn, int ctas, int dev, void* stream) {
  if (stride != 1 || lower != 0 || upper != 0 || Ho != H || Wo != W)
    return (int)cudaErrorInvalidValue;
  return launch_conv(1, x, w, rows, kblocks, w_scale, bias, inv_ns, out_q, out_tap, B, H, W, Cin,
                     Cout, Ho, Wo, stride, lower, upper, tap_kind, loader, bm, bn, ctas, dev,
                     stream);
}
