// Fused SSD300 stem for Hopper (sm_90a): conv1_1 + ReLU + conv1_2 + ReLU +
// 2x2/2 max pool, BN already folded into the conv weights.
//
// Replaces: ssdx/ops/pallas_stem.py, stem_conv_pool (TPU kernel _stem_kernel
// with the host helpers build_stem_patches and pack_stem_weights).
//
// Contract: x [B,300,300,3] bf16 NHWC; w1 [27][64] f32 (HWIO conv1_1
// weights rounded to bf16, row (dr*3+dc)*3+ci), b1 [64] f32 (rounded to
// bf16); w2 [9][64][64] bf16 (HWIO conv1_2, [tap][ci][co]), b2 [64] f32.
// out [B,150,150,64] bf16 = maxpool(relu(conv(y1, w2) + b2)) with
// y1 = bf16(relu(conv(x, w1) + b1)); SAME padding, y1 outside the image is
// 0.  Sums accumulate in f32; y1 is rounded to bf16 before conv1_2, as the
// TPU kernel stores it in the compute dtype.
//
// Bound: 2*B*300^2*64*(27+576) operations, 6.95 GFLOP per image (222 GFLOP
// at B = 32, 0.22 ms at the H100's 989 TFLOP/s dense bf16), against
// 109 MB of input and output at B = 32 (0.03 ms at 3.35 TB/s): compute
// bound.  What matters is that the 300x300x64 intermediates (y1 and the
// conv1_2 output, 23 MB per image in bf16) never go to device memory.
//
// Design: none of the TPU layout carries over (its 128-lane pair packing,
// the pair stride 151 -> 160 and the -1e9 "kill" rows exist for the MXU).
// One block of 8 warps computes one (image, 8x16 tile of pooled output):
//   * it stages the 20x36x3 input window (f32), w1, b1 and all of w2 in
//     shared memory;
//   * conv1_1 (depth 27) runs as scalar f32 FMAs into an 18x34x64 bf16 y1
//     tile in shared memory (zero outside the image);
//   * conv1_2 is an implicit GEMM of depth 9*64 = 576 on the tensor cores
//     (WMMA 16x16x16 bf16, f32 accumulate): warp w owns conv rows 2w and
//     2w+1 of the 16x32 conv tile, as four 16-pixel M tiles by four
//     16-channel N tiles; each tap's A operand is a strided view of the y1
//     tile, so there is no im2col;
//   * the epilogue stages two accumulator tiles at a time in shared memory,
//     takes the 2x2 max of the raw sums, then adds b2 and applies ReLU
//     (pool before bias is exact: max is monotone and the bias uniform over
//     the window), and stores bf16.
// Shared rows are padded from 64 to 80 channels (160 bytes) so that the 16
// rows of a WMMA fragment spread over all banks.  About 217 KB of dynamic
// shared memory: one block per SM.  A simple design, right first; a later
// version can move to wgmma and TMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kH = 300, kW = 300, kC = 64;
constexpr int kPH = kH / 2, kPW = kW / 2;
constexpr int kTPH = 8, kTPW = 16;                // pooled tile
constexpr int kTH = 2 * kTPH, kTW = 2 * kTPW;     // conv tile 16x32
constexpr int kYH = kTH + 2, kYW = kTW + 2;       // y1 tile 18x34
constexpr int kXH = kYH + 2, kXW = kYW + 2;       // input tile 20x36
constexpr int kLd = 80;                           // padded channel stride (bf16)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;             // = kTH / 2

constexpr size_t kW2Bytes = 9 * kC * kLd * 2;           // 92160
constexpr size_t kY1Bytes = kYH * kYW * kLd * 2;        // 97920
constexpr size_t kXBytes = kXH * kXW * 3 * 4;           // 8640
constexpr size_t kW1Bytes = 27 * kC * 4;                // 6912
constexpr size_t kB1Bytes = kC * 4;                     // 256
constexpr size_t kStageBytes = kWarps * 2 * 256 * 4;    // 16384
constexpr size_t kOffY1 = kW2Bytes;
constexpr size_t kOffX = kOffY1 + kY1Bytes;
constexpr size_t kOffW1 = kOffX + kXBytes;
constexpr size_t kOffB1 = kOffW1 + kW1Bytes;
constexpr size_t kOffStage = kOffB1 + kB1Bytes;
constexpr size_t kSmem = kOffStage + kStageBytes;       // 222272
static_assert(kOffY1 % 32 == 0 && kOffStage % 32 == 0, "WMMA needs 32-byte alignment");

__global__ void __launch_bounds__(kThreads, 1)
stem_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
            const float* __restrict__ b2, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + kOffY1);
  float* xs = reinterpret_cast<float*>(smem + kOffX);
  float* w1s = reinterpret_cast<float*>(smem + kOffW1);
  float* b1s = reinterpret_cast<float*>(smem + kOffB1);
  float* stage = reinterpret_cast<float*>(smem + kOffStage);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int P0 = blockIdx.y * kTPH, Q0 = blockIdx.x * kTPW;  // pooled origin
  const int R0 = 2 * P0, C0 = 2 * Q0;                        // conv origin

  // ---- stage weights and the input window in shared memory ----
  {
    const int4* src = reinterpret_cast<const int4*>(w2);     // 8 int4 per 64-ch row
    for (int v = tid; v < 9 * kC * 8; v += kThreads) {
      const int row = v >> 3, part = v & 7;
      reinterpret_cast<int4*>(w2s + row * kLd)[part] = src[v];
    }
    for (int v = tid; v < 27 * kC; v += kThreads) w1s[v] = w1[v];
    if (tid < kC) b1s[tid] = b1[tid];
    const __nv_bfloat16* xb = x + (size_t)b * kH * kW * 3;
    for (int v = tid; v < kXH * kXW * 3; v += kThreads) {
      const int ci = v % 3, col = (v / 3) % kXW, row = v / (3 * kXW);
      const int gr = R0 - 2 + row, gc = C0 - 2 + col;
      float val = 0.0f;
      if (gr >= 0 && gr < kH && gc >= 0 && gc < kW)
        val = __bfloat162float(xb[((size_t)gr * kW + gc) * 3 + ci]);
      xs[v] = val;
    }
  }
  __syncthreads();

  // ---- conv1_1 + ReLU -> y1 tile (bf16), zero outside the image ----
  // work item = (8-channel group, y1 pixel); a warp's lanes share the
  // channel group, so the weight reads are broadcasts
  for (int item = tid; item < 8 * kYH * kYW; item += kThreads) {
    const int cg = item / (kYH * kYW), pix = item % (kYH * kYW);
    const int yr = pix / kYW, yc = pix % kYW;
    const int gr = R0 - 1 + yr, gc = C0 - 1 + yc;
    __align__(16) __nv_bfloat16 vals[8];
    if (gr >= 0 && gr < kH && gc >= 0 && gc < kW) {
      float acc[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = b1s[cg * 8 + q];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            const float xv = xs[((yr + dr) * kXW + (yc + dc)) * 3 + ci];
            const float* wr = w1s + ((dr * 3 + dc) * 3 + ci) * kC + cg * 8;
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[q] = fmaf(xv, wr[q], acc[q]);
          }
#pragma unroll
      for (int q = 0; q < 8; ++q) vals[q] = __float2bfloat16(fmaxf(acc[q], 0.0f));
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) vals[q] = __float2bfloat16(0.0f);
    }
    *reinterpret_cast<int4*>(y1s + pix * kLd + cg * 8) = *reinterpret_cast<const int4*>(vals);
  }
  __syncthreads();

  // ---- conv1_2: implicit GEMM on the tensor cores ----
  const int warp = tid >> 5, lane = tid & 31;
  // M tile mt = 2*rr + hh: conv row 2*warp + rr, columns 16*hh .. 16*hh+15
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) wmma::fill_fragment(acc[mt][nn], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dr = tap / 3, dc = tap % 3;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
        wmma::load_matrix_sync(bf[nn], w2s + (tap * kC + kk * 16) * kLd + nn * 16, kLd);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int yr = 2 * warp + (mt >> 1) + dr;   // y1 tile row
        const int yc = 16 * (mt & 1) + dc;          // first y1 tile column
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, y1s + (yr * kYW + yc) * kLd + kk * 16, kLd);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) wmma::mma_sync(acc[mt][nn], af, bf[nn], acc[mt][nn]);
      }
    }
  }

  // ---- epilogue: 2x2 max of the raw sums, + b2, ReLU, bf16 store ----
  float* st = stage + warp * 2 * 256;  // [2 conv rows][16 px][16 ch]
  const int P = P0 + warp;             // this warp's pooled row
  __nv_bfloat16* ob = out + (size_t)b * kPH * kPW * kC;
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      wmma::store_matrix_sync(st, acc[hh][nn], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, acc[2 + hh][nn], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = lane + 32 * q;          // 8 pooled columns x 16 channels
        const int pc = idx >> 4, ch = idx & 15;
        const int m0 = 2 * pc;
        const float v = fmaxf(fmaxf(st[m0 * 16 + ch], st[(m0 + 1) * 16 + ch]),
                              fmaxf(st[256 + m0 * 16 + ch], st[256 + (m0 + 1) * 16 + ch]));
        const int Q = Q0 + 8 * hh + pc;
        if (P < kPH && Q < kPW)
          ob[((size_t)P * kPW + Q) * kC + nn * 16 + ch] =
              __float2bfloat16(fmaxf(v + b2[nn * 16 + ch], 0.0f));
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Launch the stem on `stream`; returns cudaGetLastError() after the launch.
extern "C" int ssdx_stem_forward(const void* x, const float* w1, const float* b1,
                                 const void* w2, const float* b2, void* out, int B,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((kPW + kTPW - 1) / kTPW, (kPH + kTPH - 1) / kTPH, B);
  stem_kernel<<<grid, kThreads, kSmem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), w1, b1,
      reinterpret_cast<const __nv_bfloat16*>(w2), b2,
      reinterpret_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
