// The Hopper (sm_90a) core that the stem kernels share: the 3x3, 64 -> 64
// convolution at 300^2 as an implicit GEMM on wgmma.  Included by stem.cu
// (B2, the serving stem: conv1_2) and stem_train.cu (B3: stage2<0>, the
// forward conv1_2; stage2<1>, its data gradient with the flipped weights;
// dw2, its weight gradient).  Beside it, conv1_1's input window and im2col
// (K = 27 padded to 32) and its m64n64k16 contraction, which B2 builds for
// its y1 halo and B3 for conv1_stats and dw1 (see load_x below).
//
// The GEMM is transposed against the usual im2col form: M is the 64
// output channels, with the weights as the A operand [64][576] (K = tap *
// 64 + input channel), and N is pixels, read from a haloed tile of the
// input map in shared memory.  With pixels as M and N = 64 channels an
// m64n64k16 reads 4 KB of shared memory for 131 kFLOP, the SM's whole
// shared-memory rate at the bf16 peak; here an m64n128k16 reads 6 KB for
// 262 kFLOP, three quarters of it.
//
// A tile is TR = 4 conv rows by TW = 62 columns; each of the two consumer
// warpgroups computes two of its rows as one m64n128 accumulator whose 128
// columns are two rows of HW = 64 pixels: conv column c of tile row r is
// column r * 64 + c, and columns 62, 63 of each row are computed and thrown
// away.  That is what makes every tap a plain shift: the input halo tile is
// HR = 6 rows of 64 pixels (origin one row up and one column left of the
// tile), pixel p = hr * 64 + hc, and tap (dr, dc) of output column n reads
// halo pixel n + (2 * wg + dr) * 64 + dc.
//
// Layout (why not the 128-byte swizzle): both operands are in wgmma's
// no-swizzle ("interleave") layout of 8 x 16-byte core matrices.  The halo
// keeps each 16-byte chunk of 8 channels of all its pixels together:
// chunk c of pixel p at (c * HALO_LD + p) * 16.  A pixel shift is then a
// 16-byte shift of the descriptor's start address, and any start that is a
// multiple of 16 bytes is valid; in the 128-byte swizzle a one-pixel shift
// changes the swizzle phase of every row, which the base-offset field or a
// restaging per tap would have to undo.  HALO_LD = 393 is odd, so the eight
// chunks of one pixel, which eight neighbouring threads write, fall in
// eight different bank groups.  The weights: chunk kc of row m at
// kc * 1024 + m * 16.  For a K-major operand the descriptor's leading byte
// offset (LBO) is the distance between the two 16-byte K chunks of a k16
// step and the stride byte offset (SBO) the distance between groups of 8
// rows; for an MN-major operand (dw2's, where K is pixels) LBO steps 8 K
// rows and SBO 8 M or N columns.  tests/test_torch_stem_sm90.py models
// every descriptor of this file on the CPU.
#pragma once

#include "sm90.cuh"

namespace stem90 {

constexpr int H = 300, W = 300, C = 64;
constexpr int TR = 4;                        // conv rows of a tile
constexpr int TW = 62;                       // conv columns of a tile
constexpr int HW = 64;                       // pixels of a tile row, halo included
constexpr int HR = TR + 2;                   // halo rows
constexpr int HALO_PIX = HR * HW;            // 384
constexpr int HALO_LD = 393;                 // pixels between channel chunks (+ 9 of padding)
constexpr int TILES_Y = H / TR;              // 75
constexpr int TILES_X = (W + TW - 1) / TW;   // 5
constexpr int TILES = TILES_Y * TILES_X;     // 375 per image
constexpr int K2 = 9 * C;                    // 576
constexpr int W_BYTES = K2 * C * 2;          // 73,728
constexpr int HALO_BYTES = 8 * HALO_LD * 16; // 50,304
constexpr int N_WG = 128;                    // pixels of one warpgroup's accumulator
constexpr int STAGE_LD = 144;                // bytes per pixel in an epilogue staging tile
constexpr int STAGE_BYTES = N_WG * STAGE_LD; // 18,432 per warpgroup
static_assert(H % TR == 0, "tiles cover the rows exactly");
static_assert((2 * 1 + 2) * HW + 2 + N_WG - 1 < HALO_LD, "the last tap's read stays in a chunk");

struct Tile {
  int b, r0, c0;  // image, first conv row, first conv column
};

__device__ __forceinline__ Tile tile_of(int t) {
  const int b = t / TILES, rem = t % TILES;
  return {b, (rem / TILES_X) * TR, (rem % TILES_X) * TW};
}

// No-swizzle matrix descriptor (layout 0).
__device__ __forceinline__ uint64_t desc0(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return sm90::desc(addr, lbo, sbo, 0);
}

// Stage the A operand [64][576] bf16 (row-major in device memory) into the
// no-swizzle K-major layout at `ws`: 16-byte chunk kc of row m at
// kc * 1024 + m * 16.
__device__ __forceinline__ void stage_weights(const __nv_bfloat16* __restrict__ a,
                                              unsigned char* ws) {
  const int4* src = reinterpret_cast<const int4*>(a);
  for (int v = threadIdx.x; v < C * K2 / 8; v += blockDim.x) {
    const int m = v / (K2 / 8), kc = v % (K2 / 8);
    *reinterpret_cast<int4*>(ws + kc * 1024 + m * 16) = src[v];
  }
}

// Zero the 9 padding pixels after each chunk's 384: the last taps of the
// thrown-away columns read them, and dw2 multiplies them by zeros.
__device__ __forceinline__ void zero_halo_pad(unsigned char* halo) {
  for (int v = threadIdx.x; v < 8 * (HALO_LD - HALO_PIX); v += blockDim.x) {
    const int c = v / (HALO_LD - HALO_PIX), p = HALO_PIX + v % (HALO_LD - HALO_PIX);
    *reinterpret_cast<int4*>(halo + (c * HALO_LD + p) * 16) = make_int4(0, 0, 0, 0);
  }
}

// wgmma m64n64k16 and m64n32k16, bf16 in, f32 accumulated; TA / TB: the
// operand is MN-major (1) or K-major (0).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The convolution of the warpgroup's two tile rows 2 * wg, 2 * wg + 1:
// acc = W . halo over the 9 taps and 64 input channels, 36 wgmma m64n128k16.
// conv_begin zeroes acc; conv_taps<T0, T1> issues taps T0 .. T1 - 1, so
// that a caller can do other work between groups of taps while the tensor
// cores run (a warp that issues all 36 at once waits at the issue);
// conv_end commits; the caller waits (sm90::wgmma_wait<0>).  acc[4j + e]
// holds output channel co(e) = 16 * warp + lane / 4 + 8 * (e >> 1) at
// column n = 8j + 2 * (lane % 4) + (e & 1) (tile row 2 * wg + n / 64,
// column n % 64).
__device__ __forceinline__ void conv_begin(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sm90::fence_operand(acc[i]);
  sm90::wgmma_fence();
}

template <int T0, int T1>
__device__ __forceinline__ void conv_taps(float (&acc)[64], uint32_t ws, uint32_t halo, int wg) {
#pragma unroll
  for (int tap = T0; tap < T1; ++tap) {
    const uint32_t shift = ((2 * wg + tap / 3) * HW + tap % 3) * 16;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t da = desc0(ws + (tap * 8 + 2 * s) * 1024, 1024, 128);
      const uint64_t db = desc0(halo + shift + 2 * s * HALO_LD * 16, HALO_LD * 16, 128);
      sm90::wgmma_bf16_128<0>(acc, da, db);
    }
  }
}

__device__ __forceinline__ void conv_end(float (&acc)[64]) {
  sm90::wgmma_commit();
#pragma unroll
  for (int i = 0; i < 64; ++i) sm90::fence_operand(acc[i]);
}

// Four 8x8 bf16 tiles between an accumulator's fragment and shared memory,
// transposed: register m of the thread holds (row lane / 4, columns
// 2 * (lane % 4) and + 1) of tile m, which is stored as (or loaded from)
// its columns as rows of 16 bytes; lane L gives the address of row L % 8 of
// tile L / 8.  For the core's accumulator, tile rows are 8 channels and
// tile columns 8 pixels, so each pixel's 8 channels become 16 bytes.
__device__ __forceinline__ void stmatrix_x4_trans(void* row, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(sm90::smem_u32(row)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// The same without the transpose: row r of tile m is the fragment's row r.
__device__ __forceinline__ void stmatrix_x4(void* row, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(sm90::smem_u32(row)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* row, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_u32(row)) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__bfloat162float(h.x), __bfloat162float(h.y));
}

// cp.async of 4 bytes, or 4 zeros where !valid (nothing is read then).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(sm90::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// cp.async of 16 bytes, or 16 zeros where !valid (nothing is read then).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(sm90::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// ------------------------------------------------------------ conv1_1
// conv1_1 (3 -> 64 channels) runs on the tensor cores from an im2col: a
// window of input rows is staged, and ROWS x 64 im2col pixels are built from
// it, pixel p = hr * 64 + hc reading window rows hr .. hr + 2 and columns
// hc .. hc + 2.  With the window's columns from c0 - 2, pixel hc is image
// column c0 - 1 + hc: B2 builds the y1 halo of its tile (ROWS = HR, window
// rows from r0 - 2), B3 the tile's own rows (ROWS = TR, window rows from
// r0 - 1), whose pixels are hc = 1 .. 62.
constexpr int X_COLS = HW + 2;                 // 66 input columns
constexpr int X_WORDS = X_COLS * 3 / 2;        // 99 four-byte words a row
constexpr int X_LD = 400;                      // bytes per staged input row

// Copy XROWS input rows xr0 .. of image b, columns c0 - 2 .. c0 + 63, 3
// channels, to `xs` with 4-byte cp.async (NT threads), zeros outside the
// image.  x's 1,800-byte rows are not 16-byte aligned, so no wider copy or
// TMA tile fits; c0 is even, so the image's edges fall on word boundaries.
template <int XROWS, int NT>
__device__ __forceinline__ void load_x(const __nv_bfloat16* __restrict__ x, int b, int xr0, int c0,
                                       unsigned char* xs) {
  for (int v = threadIdx.x; v < XROWS * X_WORDS; v += NT) {
    const int xr = v / X_WORDS, wi = v % X_WORDS;
    const int gr = xr0 + xr, col = c0 - 2 + (2 * wi) / 3;
    const bool valid = gr >= 0 && gr < H && col >= 0 && col < W;
    const long long e = (((long long)b * H + gr) * W + (c0 - 2)) * 3 + 2 * wi;
    cp_async4(xs + xr * X_LD + wi * 4, valid ? x + e : x, valid);
  }
}

// im2col of ROWS x 64 pixels from the staged window, by NT threads of
// which this is thread t: chunk c (K = 8c .. 8c + 7 of K = (dr*3 + dc)*3 +
// ci, 27..31 zero) of pixel p at (c * ROWS * 64 + p) * 16 bytes, for chunks
// C0 .. C1 - 1.
template <int ROWS, int NT, int C0 = 0, int C1 = 4>
__device__ __forceinline__ void build_im2col(const unsigned char* xcur, unsigned char* im, int t) {
  const __nv_bfloat16* xsb = reinterpret_cast<const __nv_bfloat16*>(xcur);
#pragma unroll
  for (int c = C0; c < C1; ++c) {
    for (int p = t; p < ROWS * HW; p += NT) {
      const int hr = p >> 6, hc = p & 63;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = 8 * c + e;
        v[e] = k < 27 ? xsb[(hr + k / 9) * (X_LD / 2) + (hc + (k / 3) % 3) * 3 + k % 3]
                      : __float2bfloat16(0.0f);
      }
      *reinterpret_cast<int4*>(im + (c * ROWS * HW + p) * 16) = *reinterpret_cast<const int4*>(v);
    }
  }
}

// Stage w1 [64][32] bf16 ([co][(dr*3 + dc)*3 + ci], 27..31 zero) as the B
// operand, K-major: chunk kc of row co at kc * 1024 + co * 16.
template <int NT>
__device__ __forceinline__ void stage_w1(const __nv_bfloat16* __restrict__ w1, unsigned char* w1s) {
  const int4* src = reinterpret_cast<const int4*>(w1);  // 4 chunks a row
  for (int v = threadIdx.x; v < C * 4; v += NT)
    *reinterpret_cast<int4*>(w1s + (v & 3) * 1024 + (v >> 2) * 16) = src[v];
}

// conv1_1 of im2col pixels 64 * m0 .. 64 * (m0 + NI) - 1 (an im2col of ld
// pixels a chunk): pixels as M, the 64 output channels as N, 2 k-steps,
// both operands K-major; issued and committed, the caller waits
// (sm90::wgmma_wait<0>).  a[i][4j + 2h + e] holds pixel 64 * (m0 + i) +
// 16 * warp + lane / 4 + 8h at channel 8j + 2 * (lane % 4) + e.
template <int NI>
__device__ __forceinline__ void conv1_1(float (&a)[NI][32], uint32_t im, uint32_t w1s, int ld,
                                        int m0) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      a[i][j] = 0.0f;
      sm90::fence_operand(a[i][j]);
    }
  sm90::wgmma_fence();
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t da = desc0(im + (2 * s * ld + 64 * (m0 + i)) * 16, ld * 16, 128);
      const uint64_t db = desc0(w1s + 2 * s * 1024, 1024, 128);
      wgmma_64<0, 0>(a[i], da, db);
    }
  sm90::wgmma_commit();
}

}  // namespace stem90
