// Train-mode SSD300 stem for Hopper (sm_90a): conv1_1 + BN + ReLU + conv1_2 +
// BN + ReLU + 2x2/2 max pool, forward and backward, BN in batch statistics.
//
// Replaces: ssdx/ops/pallas_stem_train.py, stem_train (the TPU kernels
// _ka_kernel .. _kf_kernel and their custom VJP).
//
// Layout: NHWC, image [B,300,300,3] bf16; the full-size buffers y1, y2, dt2
// and dt1 are [B,300,300,64] bf16 in device memory; the pooled map and its
// cotangent [B,150,150,64] bf16.  None of the TPU layout carries over (the
// pair-packed [B,300*160,128] buffers, the 40-channel patch that carried b1
// through the matmul, the lane masks, the smaller block of kernel E).
//
// Launches (the two BN barriers force them; the per-channel glue between
// them -- sums -> mean, var, inv and the affine vectors -- is PyTorch):
//   forward   conv1_stats  y1 = bf16(conv1_1(x) + b1) on wgmma from an
//                          im2col (K = 27 padded to 32), per-block
//                          sum/sumsq of the rounded y1
//             stage2<0>    y1n = bf16(relu(y1*a1 + c1)) on a haloed tile in
//                          shared memory (written out for dw2), conv1_2 on
//                          the wgmma core of stem_sm90.cuh, y2 = bf16(acc +
//                          b2), per-block sum/sumsq of the rounded y2
//             pool         p = bf16(maxpool(relu(y2*a2 + c2)))
//   backward  route        pool routing recomputed from y2: only positive
//                          maxima take gradient, tied maxima split it evenly;
//                          dt2 in bf16, BN2 sums taken before rounding
//             stage2<1>    dy2 = bf16(BN2 backward) on a haloed tile,
//                          written out for dw2, conv1_2^T (flipped,
//                          transposed w2) on the same core, dt1 =
//                          dy1n*[t1 > 0] in bf16, BN1 sums before rounding
//             dw2          dW2 = sum over pixels of y1n^T dy2: wgmma with
//                          M = (tap, ci), N = co, K = pixels, split over
//                          one slice of tiles per block
//             dw1          dy1 = bf16(BN1 backward); dW1 = dy1^T patches:
//                          wgmma with M = co, N = 32 (K = 27 padded), K =
//                          pixels, split over one slice of tiles per block
//             colsum       every cross-block reduction: per-block partial
//                          rows summed in a fixed order (no atomics, so two
//                          runs give the same statistics and gradients)
//
// Bound at B = 16: 2*B*300^2*64*(27 + 576 + 576 + 576 + 27) operations =
// 328 GFLOP, 0.33 ms at 989 TFLOP/s dense bf16, against 101 MB of inputs
// and outputs (image, dp, p, weights, gradients; 0.03 ms at 3.35 TB/s):
// bound by operations.  This design also moves y1, y2, dt2, dt1 and the
// dw2 operands y1n and dy2 (184 MB each) through device memory across the
// BN barriers, each written once and read once to three times, about 2 GB
// (0.6 ms).  Per launch the two K = 27 ones are bound by those bytes:
// conv1_stats writes y1 and reads x (193 MB, 0.058 ms; its 5 GFLOP take
// 0.005 ms), dw1 reads dt1, y1 and x (377 MB, 0.113 ms).
//
// Every launch that contracts runs on wgmma with persistent blocks of one
// per SM walking the core's tiles of 4 conv rows x 62 columns
// (stem_sm90.cuh).  stage2<0>, stage2<1> and dw2: the weights staged once
// per block; in stage2 each thread fetches the next tile's halo into
// registers while the tensor cores work on this one, between groups of
// taps, and stage2<1> copies the y1 it needs for the ReLU mask into shared
// memory with cp.async in the same window; both write their operand on the
// tile's own pixels (y1n, dy2), which dw2 copies instead of recomputing.
// conv1_stats and dw1 (four warpgroups, one tile row each) build conv1_1's
// im2col of the tile's 4 x 64 pixel slots (slot hc at column c0 - 1 + hc,
// hc = 1 .. 62 the tile's own) from an input window that cp.async brings one
// tile ahead, as B2 does: conv1_stats writes y1 through a staging row with
// 16-byte stores while the next tile's im2col is built beside the tensor
// cores; dw1 brings the next tile's dt1 and y1 rows by bulk copies on an
// mbarrier (with per-thread cp.async of 16 bytes a pixel chunk it took 0.28
// ms) while it turns this tile's into the dy1 operand.  Measured
// at B = 16 on an H100 80GB HBM3 at 700 W (PERF.md): conv1_stats
// 0.104-0.107 ms, dw1 0.174-0.178 ms.  The per-block statistics are summed
// per thread over the block's tiles, then over lanes, warps and warpgroups
// in a fixed order, and by colsum across blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "stem_sm90.cuh"

namespace {

constexpr int kH = 300, kW = 300, kC = 64;
constexpr int kPH = kH / 2, kPW = kW / 2;
constexpr int kThreads = 256;
constexpr int kVecRows = 16;                      // per-channel vectors handed in
constexpr size_t kVecBytes = kVecRows * kC * 4;   // 4096

// stage2 shared memory: weights, two halos, two staging tiles, vectors, sums
constexpr int kPrefetch = stem90::HALO_PIX * 8 / kThreads;  // 12 halo chunks a thread
constexpr size_t kS2OffHalo = stem90::W_BYTES;
constexpr size_t kS2OffStage = kS2OffHalo + 2 * stem90::HALO_BYTES;
constexpr size_t kS2OffVec = kS2OffStage + 2 * stem90::STAGE_BYTES;
constexpr size_t kS2OffRed = kS2OffVec + kVecBytes;
constexpr size_t kS2Smem = kS2OffRed + 2 * 2 * kC * 4 + 1024;  // + alignment
static_assert(stem90::HALO_PIX * 8 % kThreads == 0, "whole halo chunks a thread");

// dw2: three warpgroups, one per tap row dr; its shared memory: two
// buffers of the operands (the y1n halo, then dy2)
constexpr int kDwThreads = 384;
constexpr int kDyPix = stem90::TR * stem90::HW;   // 256 output pixels a tile
constexpr int kDyLd = 257;                        // pixels between dy2's channel chunks
constexpr size_t kW2OffDy = stem90::HALO_BYTES;
constexpr size_t kW2Buf = kW2OffDy + 8 * kDyLd * 16;
constexpr size_t kW2Smem = 2 * kW2Buf + 1024;

// conv1_stats and dw1: four warpgroups, one tile row each, on conv1_1's
// im2col of a tile's 4 x 64 pixel slots
constexpr int kWide = 4 * 128;
constexpr int kImPix = stem90::TR * stem90::HW;                 // 256
constexpr int kImBytes = 4 * kImPix * 16;                       // 16,384
constexpr int kXBytes = (stem90::TR + 2) * stem90::X_LD;        // 2,400: input window
// conv1_stats shared memory: w1, two im2cols, two windows, a staging row
// per warpgroup, the block's sums by warp
constexpr int kC1Stage = stem90::HW * stem90::STAGE_LD;        // 9,216
constexpr size_t kC1OffIm = 4 * kC * 16;
constexpr size_t kC1OffX = kC1OffIm + 2 * kImBytes;
constexpr size_t kC1OffStage = kC1OffX + 2 * kXBytes;
constexpr size_t kC1OffRed = kC1OffStage + 4 * kC1Stage;
constexpr size_t kC1Smem = kC1OffRed + 16 * 2 * kC * 4 + 1024;  // + alignment
// dw1 shared memory: two buffers of a tile's dt1 and y1 ([slot][64
// channels], as the bulk copies bring its rows) and its input window; the
// dy1 operand; the im2col; warpgroups 1-3's sums; the buffers' mbarriers
constexpr size_t kF_Map = kImPix * kC * 2;                      // 32,768
constexpr size_t kF_OffY = kF_Map;
constexpr size_t kF_OffX = 2 * kF_Map;
constexpr size_t kF_Buf = kF_OffX + kXBytes;
constexpr size_t kF_OffDy = 2 * kF_Buf;
constexpr size_t kF_OffIm = kF_OffDy + 8 * kDyLd * 16;
constexpr size_t kF_OffRed = kF_OffIm + kImBytes;
constexpr size_t kF_OffBar = kF_OffRed + 3 * kC * 32 * 4;
constexpr size_t kF_Smem = kF_OffBar + 2 * 8 + 1024;            // + alignment
static_assert(kC1OffStage % 16 == 0 && kF_Buf % 16 == 0 && kF_OffDy % 16 == 0 &&
              kF_OffIm % 16 == 0 && kF_OffBar % 8 == 0, "alignment");
static_assert(kF_Smem <= 232448, "dw1 fits the 227 KB a block may use");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int q = 0; q < 8; ++q) out[q] = __bfloat162float(h[q]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16(in[q]);
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(h);
}

// BN affine y*a + c, rounded operation by operation as the plain version
// (no contraction into an FMA), so every kernel that recomputes it agrees.
__device__ __forceinline__ float affine(float y, float a, float c) {
  return __fadd_rn(__fmul_rn(y, a), c);
}

// BN backward, elementwise: ginv * (dt - (k1 + xhat * k2)), xhat = (y - mu) * inv.
__device__ __forceinline__ float bn_bwd(float dt, float y, float ginv, float mu, float inv,
                                        float k1, float k2) {
  const float xh = __fmul_rn(__fadd_rn(y, -mu), inv);
  return __fmul_rn(ginv, __fadd_rn(dt, -__fadd_rn(k1, __fmul_rn(xh, k2))));
}

__device__ __forceinline__ size_t pix_off(int b, int r, int c) {
  return (((size_t)b * kH + r) * kW + c) * kC;
}

// Reduce per-thread (8 channels of group tid & 7) sum / second sums to one
// partial row [2][64] of this block, in a fixed order.
__device__ __forceinline__ void block_partials_cg8(const float* s, const float* q, float* red,
                                                   float* __restrict__ part_row) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    red[tid * 16 + k] = s[k];
    red[tid * 16 + 8 + k] = q[k];
  }
  __syncthreads();
  if (tid < 2 * kC) {
    const int which = tid / kC, c = tid % kC, g = c >> 3, k = c & 7;
    float acc = 0.0f;
    for (int j = 0; j < kThreads / 8; ++j) acc += red[(g + 8 * j) * 16 + which * 8 + k];
    part_row[tid] = acc;
  }
}

// ------------------------------------------------------------ forward A
//
// conv1_stats: block j takes tiles j, j + grid, ... of the core's tiling.
// A tile's conv1_1 is 4 m64n64k16 tiles (pixels as M, the 64 channels as N,
// K = 32) of 2 k-steps, one tile row per warpgroup, from the im2col of the
// tile's 4 x 64 slots; w1 [64][32] bf16 is B2's operand.  The epilogue adds
// b1 in f32, rounds to bf16, sums the rounded values and their squares per
// thread (slots that are the tile's own pixels only), and stores y1 through
// a staging row [slot][64 channels] so that each pixel's 128 bytes leave as
// eight 16-byte stores from neighbouring threads.  Four warpgroups, not
// two, so that the per-tile work (im2col, epilogue, stores) has 16 warps to
// hide its latencies.

// Slot hc of an im2col row of tile T: one of the tile's own pixels?
__device__ __forceinline__ bool own_pixel(const stem90::Tile& T, int hc) {
  return hc >= 1 && hc <= stem90::TW && T.c0 - 1 + hc < kW;
}

// The input window of tile t: rows r0-1 .. r0+4, columns c0-2 .. c0+63.
__device__ __forceinline__ void conv1_window(const __nv_bfloat16* __restrict__ x, int t,
                                             unsigned char* xs) {
  const stem90::Tile T = stem90::tile_of(t);
  stem90::load_x<stem90::TR + 2, kWide>(x, T.b, T.r0 - 1, T.c0, xs);
}

// The tile's im2col from its window: two of the four chunks a thread.
__device__ __forceinline__ void conv1_im2col(const unsigned char* xs, unsigned char* im) {
  const int tid = threadIdx.x;
  if (tid < kImPix)
    stem90::build_im2col<stem90::TR, kImPix, 0, 2>(xs, im, tid);
  else
    stem90::build_im2col<stem90::TR, kImPix, 2, 4>(xs, im, tid - kImPix);
}

__global__ void __launch_bounds__(kWide, 1)
conv1_stats_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1, __nv_bfloat16* __restrict__ y1,
                   float* __restrict__ part, int B) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  unsigned char* im = smem + kC1OffIm;
  unsigned char* xs = smem + kC1OffX;
  float* red = reinterpret_cast<float*>(smem + kC1OffRed);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* stage = smem + kC1OffStage + wg * kC1Stage;
  stem90::stage_w1<kWide>(w1, smem);

  float b1r[16], s[16], sq[16];  // at this thread's channels 8j + 2q + e: [2j + e]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b1r[2 * j + e] = b1[8 * j + 2 * q + e];
      s[2 * j + e] = sq[2 * j + e] = 0.0f;
    }

  // Prologue: tile blockIdx.x's window and im2col, the next window in flight.
  const int ntiles = B * stem90::TILES;
  if ((int)blockIdx.x < ntiles) conv1_window(x, blockIdx.x, xs);
  stem90::cp_async_commit();
  stem90::cp_async_wait_all();
  __syncthreads();
  conv1_im2col(xs, im);
  if ((int)(blockIdx.x + gridDim.x) < ntiles) conv1_window(x, blockIdx.x + gridDim.x, xs + kXBytes);
  stem90::cp_async_commit();
  sm90::fence_proxy_async();
  __syncthreads();

  const uint32_t w1a = sm90::smem_u32(smem), ima = sm90::smem_u32(im);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    // This tile's im2col is in buffer it & 1; the next tile's window is in
    // flight in buffer (it + 1) & 1.
    const stem90::Tile T = stem90::tile_of(tile);
    float a1[1][32];
    stem90::conv1_1<1>(a1, ima + (it & 1) * kImBytes, w1a, kImPix, wg);
    // The next tile's im2col while the tensor cores run, then the window after it.
    const int next = tile + gridDim.x;
    if (next < ntiles) {
      stem90::cp_async_wait_all();
      __syncthreads();  // its window is in (every thread's copies)
      conv1_im2col(xs + ((it + 1) & 1) * kXBytes, im + ((it + 1) & 1) * kImBytes);
      if (next + (int)gridDim.x < ntiles)
        conv1_window(x, next + gridDim.x, xs + (it & 1) * kXBytes);
      stem90::cp_async_commit();
      sm90::fence_proxy_async();
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 32; ++j) sm90::fence_operand(a1[0][j]);

    // + b1, bf16, the sums of the rounded values -> staging row (slot, then
    // channels; a tile (8 slots, chunk j) as its 8 rows of 16 bytes)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p0 = 16 * warp + 8 * h;  // slot of this 8-pixel group
      const bool own = own_pixel(T, p0 + (lane >> 2));
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        uint32_t rr[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = j0 + m;
          const float v0 = round_bf16(a1[0][4 * j + 2 * h] + b1r[2 * j]);
          const float v1 = round_bf16(a1[0][4 * j + 2 * h + 1] + b1r[2 * j + 1]);
          if (own) {
            s[2 * j] += v0;
            sq[2 * j] += v0 * v0;
            s[2 * j + 1] += v1;
            sq[2 * j + 1] += v1 * v1;
          }
          rr[m] = stem90::pack_bf16x2(v0, v1);
        }
        stem90::stmatrix_x4(stage + (p0 + (lane & 7)) * stem90::STAGE_LD + (j0 + (lane >> 3)) * 16,
                            rr);
      }
    }
    sm90::named_barrier(1 + wg, 128);
    for (int v = t; v < stem90::HW * 8; v += 128) {
      const int hc = v >> 3, c = v & 7;
      if (own_pixel(T, hc))
        *reinterpret_cast<int4*>(y1 + pix_off(T.b, T.r0 + wg, T.c0 - 1 + hc) + c * 8) =
            *reinterpret_cast<const int4*>(stage + hc * stem90::STAGE_LD + c * 16);
    }
    __syncthreads();  // the next im2col is written; this tile's wgmmas and staging reads are done
  }
  stem90::cp_async_wait_all();

  // ---- the block's partial sums, fixed order: lanes, then warps and warpgroups ----
#pragma unroll
  for (int k = 0; k < 16; ++k)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
      sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], o);
    }
  if (lane < 4) {
    float* r = red + (wg * 4 + warp) * 2 * kC;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        r[8 * j + 2 * q + e] = s[2 * j + e];
        r[kC + 8 * j + 2 * q + e] = sq[2 * j + e];
      }
  }
  __syncthreads();
  if (tid < 2 * kC) {
    float acc = 0.0f;
    for (int g = 0; g < 16; ++g) acc += red[g * 2 * kC + tid];
    part[(size_t)blockIdx.x * 2 * kC + tid] = acc;
  }
}

// ------------------------------------------- forward B / backward E (stage 2)
//
// MODE 0: src = y1; vec rows 0 a1, 1 c1, 2 b2; out = y2, and aux = y1n,
//         the operand on the tile's own pixels, for dw2.
// MODE 1: src = dt2, src2 = y2, y1; vec rows 0 ginv2, 1 mu2, 2 inv2,
//         3 S1_2/n, 4 S2_2/n, 5 a1, 6 c1, 7 mu1, 8 inv1; out = dt1, and
//         aux = dy2, the operand on the tile's own pixels, for dw2.
// w is the core's A operand [64][576] bf16 ([m][tap*64 + k]): MODE 0 w2 as
// [co][dr][dc][ci], MODE 1 the flipped transpose [ci][dr'][dc'][co] =
// w2[co][ci][2-dr'][2-dc'] (OIHW).  Block j takes tiles j, j + grid, ...
// and writes one partial row [2][64] of the block's sums.

// A 16-byte chunk of 8 bf16 values to and from floats in registers.
__device__ __forceinline__ void unpack8(const int4& raw, float* out) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int q = 0; q < 8; ++q) out[q] = __bfloat162float(h[q]);
}

__device__ __forceinline__ int4 pack8(const float* in) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16(in[q]);
  return *reinterpret_cast<const int4*>(h);
}

// Halo pixel of fetch slot i of this thread (its channel chunk is tid & 7).
__device__ __forceinline__ bool halo_pixel(const stem90::Tile& T, int i, int& pix, int& gr,
                                           int& gc) {
  pix = (threadIdx.x >> 3) + (kThreads / 8) * i;
  gr = T.r0 - 1 + (pix >> 6);
  gc = T.c0 - 1 + (pix & 63);
  return gr >= 0 && gr < kH && gc >= 0 && gc < kW;
}

// Fetch slots I0 .. I1 - 1 of the raw halo of tile t into registers (src,
// and src2 in MODE 1).
template <int MODE, int I0 = 0, int I1 = kPrefetch>
__device__ __forceinline__ void halo_fetch(const __nv_bfloat16* __restrict__ src,
                                           const __nv_bfloat16* __restrict__ src2, int t,
                                           int4 (&ra)[kPrefetch], int4 (&rb)[kPrefetch]) {
  const stem90::Tile T = stem90::tile_of(t);
  const int c = threadIdx.x & 7;
#pragma unroll
  for (int i = I0; i < I1; ++i) {
    int pix, gr, gc;
    ra[i] = rb[i] = make_int4(0, 0, 0, 0);
    if (halo_pixel(T, i, pix, gr, gc)) {
      const size_t off = pix_off(T.b, gr, gc) + c * 8;
      ra[i] = __ldg(reinterpret_cast<const int4*>(src + off));
      if (MODE == 1) rb[i] = __ldg(reinterpret_cast<const int4*>(src2 + off));
    }
  }
}

// Slots I0 .. I1 - 1 of the operand of tile t from the fetched registers:
// MODE 0 bf16(relu(y1*a1 + c1)), MODE 1 bf16(BN2 backward); zero outside
// the image.  The thread's eight channels are fixed (tid & 7), so their
// vectors are read once a call.
template <int MODE, int I0 = 0, int I1 = kPrefetch>
__device__ __forceinline__ void halo_store(const int4 (&ra)[kPrefetch], const int4 (&rb)[kPrefetch],
                                           int t, unsigned char* halo, const float* vs) {
  const stem90::Tile T = stem90::tile_of(t);
  const int c = threadIdx.x & 7;
  constexpr int NV = MODE == 0 ? 2 : 5;
  float cf[NV][8];
#pragma unroll
  for (int r = 0; r < NV; ++r) {
    const float4* v4 = reinterpret_cast<const float4*>(vs + r * kC + c * 8);
    *reinterpret_cast<float4*>(&cf[r][0]) = v4[0];
    *reinterpret_cast<float4*>(&cf[r][4]) = v4[1];
  }
#pragma unroll
  for (int i = I0; i < I1; ++i) {
    int pix, gr, gc;
    float o[8];
    if (halo_pixel(T, i, pix, gr, gc)) {
      float a[8];
      unpack8(ra[i], a);
      if constexpr (MODE == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = fmaxf(affine(a[k], cf[0][k], cf[1][k]), 0.0f);
      } else {
        float yv[8];
        unpack8(rb[i], yv);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = bn_bwd(a[k], yv[k], cf[0][k], cf[1][k], cf[2][k], cf[3][k], cf[NV - 1][k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = 0.0f;
    }
    *reinterpret_cast<int4*>(halo + (c * stem90::HALO_LD + pix) * 16) = pack8(o);
  }
}

// Output pixel n (0..127) of warpgroup wg's accumulator: inside the image?
__device__ __forceinline__ bool out_pixel(const stem90::Tile& T, int wg, int n, int& r, int& col) {
  r = T.r0 + 2 * wg + (n >> 6);
  col = T.c0 + (n & 63);
  return (n & 63) < stem90::TW && col < kW;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
stage2_kernel(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ src2,
              const __nv_bfloat16* __restrict__ w, const float* __restrict__ vec,
              const __nv_bfloat16* __restrict__ y1, __nv_bfloat16* __restrict__ out,
              __nv_bfloat16* __restrict__ aux, float* __restrict__ part, int B) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  unsigned char* halo = smem + kS2OffHalo;
  float* vs = reinterpret_cast<float*>(smem + kS2OffVec);
  float* red = reinterpret_cast<float*>(smem + kS2OffRed);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* stage = smem + kS2OffStage + wg * stem90::STAGE_BYTES;
  stem90::stage_weights(w, smem);
  stem90::zero_halo_pad(halo);
  stem90::zero_halo_pad(halo + stem90::HALO_BYTES);
  for (int v = tid; v < kVecRows * kC; v += kThreads) vs[v] = vec[v];
  __syncthreads();

  // this thread's two output channels and their epilogue constants
  int co[2];
  float e0[2], e1[2], e2[2], e3[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    co[h] = 16 * warp + (lane >> 2) + 8 * h;
    e0[h] = vs[(MODE == 0 ? 2 : 5) * kC + co[h]];  // b2 | a1
    e1[h] = vs[6 * kC + co[h]];                    // c1
    e2[h] = vs[7 * kC + co[h]];                    // mu1
    e3[h] = vs[8 * kC + co[h]];                    // inv1
  }
  float s[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};

  // Two halo buffers: the tensor cores read tile t's while the threads write
  // tile t + grid's from the registers fetched during tile t - grid, and
  // fetch tile t + 2 * grid's, a third of the slots between each group of
  // three taps.
  const uint32_t wa = sm90::smem_u32(smem);
  const int ntiles = B * stem90::TILES;
  int4 ra[kPrefetch], rb[kPrefetch];
  if ((int)blockIdx.x < ntiles) {
    halo_fetch<MODE>(src, src2, blockIdx.x, ra, rb);
    halo_store<MODE>(ra, rb, blockIdx.x, halo, vs);
    if ((int)(blockIdx.x + gridDim.x) < ntiles)
      halo_fetch<MODE>(src, src2, blockIdx.x + gridDim.x, ra, rb);
  }
  sm90::fence_proxy_async();
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const stem90::Tile T = stem90::tile_of(tile);
    unsigned char* cur = halo + (it & 1) * stem90::HALO_BYTES;
    unsigned char* nxt = halo + ((it + 1) & 1) * stem90::HALO_BYTES;
    __syncthreads();  // cur is written; the last tile's wgmmas and staging reads are done

    float acc[64];
    const uint32_t ca = sm90::smem_u32(cur);
    const int next = tile + gridDim.x, after = next + gridDim.x;
    stem90::conv_begin(acc);
    stem90::conv_taps<0, 3>(acc, wa, ca, wg);
    if (next < ntiles) {
      halo_store<MODE, 0, 4>(ra, rb, next, nxt, vs);
      if (after < ntiles) halo_fetch<MODE, 0, 4>(src, src2, after, ra, rb);
    }
    stem90::conv_taps<3, 6>(acc, wa, ca, wg);
    if (next < ntiles) {
      halo_store<MODE, 4, 8>(ra, rb, next, nxt, vs);
      if (after < ntiles) halo_fetch<MODE, 4, 8>(src, src2, after, ra, rb);
    }
    stem90::conv_taps<6, 9>(acc, wa, ca, wg);
    stem90::conv_end(acc);
    if (next < ntiles) {
      halo_store<MODE, 8, 12>(ra, rb, next, nxt, vs);
      if (after < ntiles) halo_fetch<MODE, 8, 12>(src, src2, after, ra, rb);
    }
    if (MODE == 1) {  // y1 of this warpgroup's output pixels, for the ReLU mask
      for (int v = t; v < stem90::N_WG * 8; v += 128) {
        int r, col;
        if (out_pixel(T, wg, v >> 3, r, col))
          stem90::cp_async16z(stage + (v >> 3) * stem90::STAGE_LD + (v & 7) * 16,
                              y1 + pix_off(T.b, r, col) + (v & 7) * 8, true);
      }
      stem90::cp_async_commit();
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) sm90::fence_operand(acc[i]);
    if (MODE == 1) {
      stem90::cp_async_wait_all();
      sm90::named_barrier(1 + wg, 128);
    }

    // epilogue: acc[4j + 2h + e] is channel co[h] at column n = 8j + 2q + e;
    // four 8x8 tiles (j0 + m / 2, h = m % 2) at a time go to and from the
    // staging tile through stmatrix / ldmatrix (transposed: pixel rows).
    const int lim = min(stem90::TW, kW - T.c0);  // valid columns of a tile row
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 2) {
      const int mi = lane >> 3;
      unsigned char* row = stage + (8 * (j0 + (mi >> 1)) + (lane & 7)) * stem90::STAGE_LD +
                           (16 * warp + 8 * (mi & 1)) * 2;
      uint32_t rr[4];
      if (MODE == 1) stem90::ldmatrix_x4_trans(row, rr);  // y1
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = j0 + (m >> 1), h = m & 1;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = ((8 * j + 2 * q + e) & 63) < lim;
          const float v = acc[4 * j + 2 * h + e];
          if (MODE == 0) {
            o[e] = round_bf16(v + e0[h]);  // y2 = bf16(conv + b2)
            if (valid) {
              s[h] += o[e];
              sq[h] += o[e] * o[e];
            }
          } else {
            const float2 y2v = stem90::unpack_bf16x2(rr[m]);
            const float yv = e ? y2v.y : y2v.x;
            o[e] = affine(yv, e0[h], e1[h]) > 0.0f ? v : 0.0f;
            if (valid) {
              s[h] += o[e];
              sq[h] += o[e] * __fmul_rn(__fadd_rn(yv, -e2[h]), e3[h]);
            }
          }
        }
        rr[m] = stem90::pack_bf16x2(o[0], o[1]);
      }
      stem90::stmatrix_x4_trans(row, rr);
    }
    sm90::named_barrier(1 + wg, 128);
    // out from the staging tile; aux, the operand on the same pixels, from
    // the halo (pixel n of the warpgroup is halo pixel (2wg + 1) * 64 + n + 1)
    for (int v = t; v < stem90::N_WG * 8; v += 128) {
      int r, col;
      const int n = v >> 3, c = v & 7;
      if (out_pixel(T, wg, n, r, col)) {
        const size_t off = pix_off(T.b, r, col) + c * 8;
        *reinterpret_cast<int4*>(out + off) =
            *reinterpret_cast<const int4*>(stage + n * stem90::STAGE_LD + c * 16);
        *reinterpret_cast<int4*>(aux + off) = *reinterpret_cast<const int4*>(
            cur + (c * stem90::HALO_LD + (2 * wg + 1) * stem90::HW + n + 1) * 16);
      }
    }
    sm90::fence_proxy_async();  // the next halo's writes, before the tensor cores read it
  }

  // ---- the block's partial sums, fixed order: lanes, then warpgroups ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
    if (q == 0) {
      red[wg * 2 * kC + co[h]] = s[h];
      red[wg * 2 * kC + kC + co[h]] = sq[h];
    }
  }
  __syncthreads();
  if (tid < 2 * kC) part[(size_t)blockIdx.x * 2 * kC + tid] = red[tid] + red[2 * kC + tid];
}

// ------------------------------------------------------------ forward C

__global__ void __launch_bounds__(kThreads)
pool_kernel(const __nv_bfloat16* __restrict__ y2, const float* __restrict__ vec,
            __nv_bfloat16* __restrict__ p, int B) {
  __shared__ float vs[2 * kC];  // a2, c2
  if (threadIdx.x < 2 * kC) vs[threadIdx.x] = vec[threadIdx.x];
  __syncthreads();
  const size_t total = (size_t)B * kPH * kPW * 8;
  for (size_t item = (size_t)blockIdx.x * kThreads + threadIdx.x; item < total;
       item += (size_t)gridDim.x * kThreads) {
    const int cg = (int)(item & 7);
    const size_t pp = item >> 3;
    const int Q = (int)(pp % kPW), P = (int)((pp / kPW) % kPH), b = (int)(pp / (kPW * kPH));
    const size_t base = pix_off(b, 2 * P, 2 * Q) + cg * 8;
    float v[4][8];
    load8(y2 + base, v[0]);
    load8(y2 + base + kC, v[1]);
    load8(y2 + base + (size_t)kW * kC, v[2]);
    load8(y2 + base + (size_t)kW * kC + kC, v[3]);
    float m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float a = vs[cg * 8 + k], c = vs[kC + cg * 8 + k];
      m[k] = fmaxf(fmaxf(fmaxf(affine(v[0][k], a, c), 0.0f), fmaxf(affine(v[1][k], a, c), 0.0f)),
                   fmaxf(fmaxf(affine(v[2][k], a, c), 0.0f), fmaxf(affine(v[3][k], a, c), 0.0f)));
    }
    store8(p + pp * kC + cg * 8, m);
  }
}

// ----------------------------------------------------------- backward D

__global__ void __launch_bounds__(kThreads)
route_kernel(const __nv_bfloat16* __restrict__ y2, const __nv_bfloat16* __restrict__ dp,
             const float* __restrict__ vec, __nv_bfloat16* __restrict__ dt2,
             float* __restrict__ part, int B) {
  __shared__ float vs[4 * kC];  // a2, c2, inv2, mu2
  __shared__ float red[kThreads * 16];
  const int tid = threadIdx.x;
  vs[tid] = vec[tid];  // kThreads == 4 * kC
  __syncthreads();
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.0f;
  const size_t total = (size_t)B * kPH * kPW * 8;
  for (size_t item = (size_t)blockIdx.x * kThreads + tid; item < total;
       item += (size_t)gridDim.x * kThreads) {
    const int cg = (int)(item & 7);  // == tid & 7: the stride is a multiple of 8
    const size_t pp = item >> 3;
    const int Q = (int)(pp % kPW), P = (int)((pp / kPW) % kPH), b = (int)(pp / (kPW * kPH));
    const size_t base = pix_off(b, 2 * P, 2 * Q) + cg * 8;
    const size_t off[4] = {base, base + kC, base + (size_t)kW * kC, base + (size_t)kW * kC + kC};
    float v[4][8], d[4][8], g[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) load8(y2 + off[i], v[i]);
    load8(dp + pp * kC + cg * 8, g);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = cg * 8 + k;
      const float a = vs[c], cc = vs[kC + c], inv = vs[2 * kC + c], mu = vs[3 * kC + c];
      float t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = fmaxf(affine(v[i][k], a, cc), 0.0f);
      const float pm = fmaxf(fmaxf(t[0], t[1]), fmaxf(t[2], t[3]));
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) cnt += (t[i] == pm && pm > 0.0f) ? 1 : 0;
      const float gs = g[k] / fmaxf((float)cnt, 1.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d[i][k] = (t[i] == pm && pm > 0.0f) ? gs : 0.0f;
        s[k] += d[i][k];
        q[k] += d[i][k] * __fmul_rn(__fadd_rn(v[i][k], -mu), inv);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) store8(dt2 + off[i], d[i]);
  }
  __syncthreads();
  block_partials_cg8(s, q, red, part + (size_t)blockIdx.x * 2 * kC);
}

// ---------------------------------------------------------- backward dW2
//
// Block j accumulates dW2 [576][64] over tiles j, j + grid, ...: warpgroup
// dr holds the three taps (dr, 0..2) as m64n64 accumulators (M = ci, N =
// co).  Both operands were written by the stage-2 launches, y1n by
// stage2<0> and dy2 by stage2<1>, so a tile's operands are plain copies:
// cp.async brings the y1n halo and dy2 on the tile's 4 x 64 output pixels
// (zeros outside the image and in the thrown-away columns) straight into
// the core's layout, one tile ahead into the second buffer.  K is the
// output pixels, 16 a step, and tap (dr, dc) of pixel p reads halo pixel
// p + dr * 64 + dc.  Both operands are MN-major: 8 channels of a pixel are
// 16 contiguous bytes and pixels are 16 bytes apart.

__device__ __forceinline__ void dw2_fetch(const __nv_bfloat16* __restrict__ y1n,
                                          const __nv_bfloat16* __restrict__ dy2, int t,
                                          unsigned char* buf) {
  const stem90::Tile T = stem90::tile_of(t);
  const int c = threadIdx.x & 7;
  for (int pix = threadIdx.x >> 3; pix < stem90::HALO_PIX; pix += kDwThreads / 8) {
    const int gr = T.r0 - 1 + (pix >> 6), gc = T.c0 - 1 + (pix & 63);
    const bool inside = gr >= 0 && gr < kH && gc >= 0 && gc < kW;
    stem90::cp_async16z(buf + (c * stem90::HALO_LD + pix) * 16,
                        inside ? y1n + pix_off(T.b, gr, gc) + c * 8 : y1n, inside);
  }
  for (int pix = threadIdx.x >> 3; pix < kDyPix; pix += kDwThreads / 8) {
    const int gc = T.c0 + (pix & 63);
    const bool valid = (pix & 63) < stem90::TW && gc < kW;
    stem90::cp_async16z(buf + kW2OffDy + (c * kDyLd + pix) * 16,
                        valid ? dy2 + pix_off(T.b, T.r0 + (pix >> 6), gc) + c * 8 : dy2, valid);
  }
}

__global__ void __launch_bounds__(kDwThreads, 1)
dw2_kernel(const __nv_bfloat16* __restrict__ y1n, const __nv_bfloat16* __restrict__ dy2,
           float* __restrict__ part, int B) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  const int tid = threadIdx.x, dr = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  stem90::zero_halo_pad(smem);
  stem90::zero_halo_pad(smem + kW2Buf);
  sm90::fence_proxy_async();

  float acc[3][32];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.0f;

  const int ntiles = B * stem90::TILES;
  if ((int)blockIdx.x < ntiles) dw2_fetch(y1n, dy2, blockIdx.x, smem);
  stem90::cp_async_commit();
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    unsigned char* cur = smem + (it & 1) * kW2Buf;
    stem90::cp_async_wait_all();
    sm90::fence_proxy_async();
    __syncthreads();  // this tile's copies are in; the last tile's wgmmas are done
    if (tile + (int)gridDim.x < ntiles)
      dw2_fetch(y1n, dy2, tile + gridDim.x, smem + ((it + 1) & 1) * kW2Buf);
    stem90::cp_async_commit();

    const uint32_t ha = sm90::smem_u32(cur), da0 = ha + kW2OffDy;
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::fence_operand(acc[d][i]);
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kDyPix / 16; ++s) {
      const uint64_t db = stem90::desc0(da0 + s * 16 * 16, 128, kDyLd * 16);
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        const uint64_t da =
            stem90::desc0(ha + (16 * s + dr * stem90::HW + dc) * 16, 128, stem90::HALO_LD * 16);
        stem90::wgmma_64<1, 1>(acc[dc], da, db);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::fence_operand(acc[d][i]);
  }
  stem90::cp_async_wait_all();

  // acc[dc][4j + 2h + e]: ci = 16 * warp + lane / 4 + 8h, co = 8j + 2 * (lane % 4) + e
  float* prow = part + (size_t)blockIdx.x * (9 * kC * kC);
#pragma unroll
  for (int dc = 0; dc < 3; ++dc)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = 16 * warp + (lane >> 2) + 8 * h, co = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(prow + ((dr * 3 + dc) * kC + ci) * kC + co) =
            make_float2(acc[dc][4 * j + 2 * h], acc[dc][4 * j + 2 * h + 1]);
      }
}

// ---------------------------------------------------------- backward dW1
//
// vec rows: 0 ginv1, 1 mu1, 2 inv1, 3 S1_1/n, 4 S2_1/n.  Block j accumulates
// dW1 over tiles j, j + grid, ... as one m64n32 accumulator split over its
// four warpgroups: M = co with A = dy1 MN-major (chunk-major [8][kDyLd]
// [16 B] as dw2 stages dy2), N = the 32 patch values (27 and 5 zeros) with
// B = conv1_1's im2col MN-major ([4 chunks][256 pixels][16 B]), K = the
// tile's 256 pixel slots, warpgroup wg taking the 4 k-steps of tile row wg.
// A tile's dt1 and y1 rows (62 or 52 pixels of 128 bytes, contiguous in
// device memory) come one tile ahead by bulk copies on the buffer's
// mbarrier, which keep the copy off the threads' instruction stream, and
// its input window by cp.async; dy1 = bf16(BN1 backward) goes from them
// into the operand's layout, 0 on the slots that are not the tile's pixels.

__device__ __forceinline__ void dw1_fetch(const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ y1,
                                          const __nv_bfloat16* __restrict__ dt1, int t,
                                          unsigned char* buf, uint64_t* bar) {
  const stem90::Tile T = stem90::tile_of(t);
  if (threadIdx.x == 0) {
    const uint32_t bytes = min(stem90::TW, kW - T.c0) * kC * 2;  // own slots 1 .. of each row
    sm90::fence_proxy_async();  // the threads' reads of the buffer, before the copies overwrite it
    sm90::mbar_expect_tx(bar, 2 * stem90::TR * bytes);
#pragma unroll
    for (int hr = 0; hr < stem90::TR; ++hr) {
      const size_t off = pix_off(T.b, T.r0 + hr, T.c0);
      sm90::bulk_load(buf + (hr * stem90::HW + 1) * kC * 2, dt1 + off, bytes, bar);
      sm90::bulk_load(buf + kF_OffY + (hr * stem90::HW + 1) * kC * 2, y1 + off, bytes, bar);
    }
  }
  stem90::load_x<stem90::TR + 2, kWide>(x, T.b, T.r0 - 1, T.c0, buf + kF_OffX);
}

__global__ void __launch_bounds__(kWide, 1)
dw1_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y1,
           const __nv_bfloat16* __restrict__ dt1, const float* __restrict__ vec,
           float* __restrict__ part, int B) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  unsigned char* dy = smem + kF_OffDy;
  unsigned char* im = smem + kF_OffIm;
  float* red = reinterpret_cast<float*>(smem + kF_OffRed);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kF_OffBar);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int c = tid & 7;  // this thread's channel chunk in the dy1 pass
  if (tid == 0) {
    sm90::mbar_init(&bar[0], 1);  // thread 0's arrive; the bytes come with the copies
    sm90::mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float cf[5][8];
#pragma unroll
  for (int r = 0; r < 5; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) cf[r][k] = vec[r * kC + c * 8 + k];
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  __syncthreads();

  const int ntiles = B * stem90::TILES;
  if ((int)blockIdx.x < ntiles) dw1_fetch(x, y1, dt1, blockIdx.x, smem, &bar[0]);
  stem90::cp_async_commit();
  const uint32_t dya = sm90::smem_u32(dy), ima = sm90::smem_u32(im);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const unsigned char* cur = smem + (it & 1) * kF_Buf;
    stem90::cp_async_wait_all();
    sm90::mbar_wait(&bar[it & 1], (it >> 1) & 1);
    __syncthreads();  // this tile's window is in; the last tile's wgmmas and reads are done
    if (tile + (int)gridDim.x < ntiles)
      dw1_fetch(x, y1, dt1, tile + gridDim.x, smem + ((it + 1) & 1) * kF_Buf, &bar[(it + 1) & 1]);
    stem90::cp_async_commit();

    const stem90::Tile T = stem90::tile_of(tile);
#pragma unroll
    for (int i = 0; i < kImPix * 8 / kWide; ++i) {
      const int pix = (tid >> 3) + i * (kWide / 8);
      float o[8];
      if (own_pixel(T, pix & 63)) {
        float dt[8], yv[8];
        unpack8(*reinterpret_cast<const int4*>(cur + pix * kC * 2 + c * 16), dt);
        unpack8(*reinterpret_cast<const int4*>(cur + kF_OffY + pix * kC * 2 + c * 16), yv);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = bn_bwd(dt[k], yv[k], cf[0][k], cf[1][k], cf[2][k], cf[3][k], cf[4][k]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = 0.0f;
      }
      *reinterpret_cast<int4*>(dy + (c * kDyLd + pix) * 16) = pack8(o);  // dy1 rounded to bf16
    }
    conv1_im2col(cur + kF_OffX, im);
    sm90::fence_proxy_async();
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 16; ++i) sm90::fence_operand(acc[i]);
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 4 * wg; s < 4 * wg + 4; ++s) {
      const uint64_t da = stem90::desc0(dya + s * 16 * 16, 128, kDyLd * 16);
      const uint64_t db = stem90::desc0(ima + s * 16 * 16, 128, kImPix * 16);
      stem90::wgmma_32<1, 1>(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) sm90::fence_operand(acc[i]);
  }
  stem90::cp_async_wait_all();

  // acc[4j + 2h + e] is dW1[k][co] at co = 16 * warp + lane / 4 + 8h, k = 8j +
  // 2 * (lane % 4) + e; warpgroups 1-3 leave their sums in shared memory,
  // warpgroup 0 adds them to its own in a fixed order
  const int co0 = 16 * warp + (lane >> 2), k0 = 2 * (lane & 3);
  if (wg > 0)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int co = co0 + 8 * ((i >> 1) & 1), k = k0 + 8 * (i >> 2) + (i & 1);
      red[(wg - 1) * 32 * kC + k * kC + co] = acc[i];
    }
  __syncthreads();
  if (wg == 0) {
    float* prow = part + (size_t)blockIdx.x * 27 * kC;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int co = co0 + 8 * ((i >> 1) & 1), k = k0 + 8 * (i >> 2) + (i & 1);
      const float* r = red + k * kC + co;
      if (k < 27) prow[k * kC + co] = ((acc[i] + r[0]) + r[32 * kC]) + r[2 * 32 * kC];
    }
  }
}

// ------------------------------------------------- fixed-order column sums

__global__ void __launch_bounds__(1024)
colsum_kernel(const float* __restrict__ in, int n, int K, float* __restrict__ out) {
  __shared__ float red[32][33];
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + c;
  float s = 0.0f;
  if (col < K)
    for (int i = g; i < n; i += 32) s += in[(size_t)i * K + col];
  red[g][c] = s;
  __syncthreads();
  if (g == 0 && col < K) {
    float t = 0.0f;
    for (int j = 0; j < 32; ++j) t += red[j][c];
    out[col] = t;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// `grid` is the number of blocks, and so the number of partial rows written.

// w1 [64][32] bf16 as B2 takes it; partial rows [2][64] (sum, sum of squares).
extern "C" int ssdx_st_conv1(const void* x, const void* w1, const float* b1, void* y1,
                             float* part, int B, int grid, cudaStream_t stream) {
  cudaError_t e = allow_smem(conv1_stats_kernel, kC1Smem);
  if (e != cudaSuccess) return (int)e;
  conv1_stats_kernel<<<grid, kWide, kC1Smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(w1), b1,
      reinterpret_cast<__nv_bfloat16*>(y1), part, B);
  return (int)cudaGetLastError();
}

// Partial rows: `grid`, one per persistent block.
// aux: the operand on the tiles' own pixels, y1n (mode 0) or dy2 (mode 1).
extern "C" int ssdx_st_stage2(int mode, const void* src, const void* src2, const void* w,
                              const float* vec, const void* y1, void* out, void* aux,
                              float* part, int B, int grid, cudaStream_t stream) {
  const auto* s = reinterpret_cast<const __nv_bfloat16*>(src);
  const auto* s2 = reinterpret_cast<const __nv_bfloat16*>(src2);
  const auto* wp = reinterpret_cast<const __nv_bfloat16*>(w);
  const auto* y = reinterpret_cast<const __nv_bfloat16*>(y1);
  auto* o = reinterpret_cast<__nv_bfloat16*>(out);
  auto* d = reinterpret_cast<__nv_bfloat16*>(aux);
  cudaError_t e;
  if (mode == 0) {
    if ((e = allow_smem(stage2_kernel<0>, kS2Smem)) != cudaSuccess) return (int)e;
    stage2_kernel<0><<<grid, kThreads, kS2Smem, stream>>>(s, s2, wp, vec, y, o, d, part, B);
  } else {
    if ((e = allow_smem(stage2_kernel<1>, kS2Smem)) != cudaSuccess) return (int)e;
    stage2_kernel<1><<<grid, kThreads, kS2Smem, stream>>>(s, s2, wp, vec, y, o, d, part, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int ssdx_st_pool(const void* y2, const float* vec, void* p, int B, int grid,
                            cudaStream_t stream) {
  pool_kernel<<<grid, kThreads, 0, stream>>>(reinterpret_cast<const __nv_bfloat16*>(y2), vec,
                                             reinterpret_cast<__nv_bfloat16*>(p), B);
  return (int)cudaGetLastError();
}

extern "C" int ssdx_st_route(const void* y2, const void* dp, const float* vec, void* dt2,
                             float* part, int B, int grid, cudaStream_t stream) {
  route_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(y2), reinterpret_cast<const __nv_bfloat16*>(dp),
      vec, reinterpret_cast<__nv_bfloat16*>(dt2), part, B);
  return (int)cudaGetLastError();
}

// Partial rows of 576 * 64 floats ([tap][ci][co]).
extern "C" int ssdx_st_dw2(const void* y1n, const void* dy2, float* part, int B, int grid,
                           cudaStream_t stream) {
  cudaError_t e = allow_smem(dw2_kernel, kW2Smem);
  if (e != cudaSuccess) return (int)e;
  dw2_kernel<<<grid, kDwThreads, kW2Smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(y1n), reinterpret_cast<const __nv_bfloat16*>(dy2),
      part, B);
  return (int)cudaGetLastError();
}

// Partial rows of 27 * 64 floats ([(dr*3 + dc)*3 + ci][co]).
extern "C" int ssdx_st_dw1(const void* x, const void* y1, const void* dt1, const float* vec,
                           float* part, int B, int grid, cudaStream_t stream) {
  cudaError_t e = allow_smem(dw1_kernel, kF_Smem);
  if (e != cudaSuccess) return (int)e;
  dw1_kernel<<<grid, kWide, kF_Smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(y1),
      reinterpret_cast<const __nv_bfloat16*>(dt1), vec, part, B);
  return (int)cudaGetLastError();
}

extern "C" int ssdx_st_colsum(const float* in, int n, int K, float* out, cudaStream_t stream) {
  colsum_kernel<<<(K + 31) / 32, 1024, 0, stream>>>(in, n, K, out);
  return (int)cudaGetLastError();
}
