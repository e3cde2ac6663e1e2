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
//   forward   conv1_stats  y1 = bf16(conv1_1(x) + b1), per-block sum/sumsq
//             stage2<0>    y1n = bf16(relu(y1*a1 + c1)) on a haloed tile in
//                          shared memory, conv1_2 as a WMMA implicit GEMM,
//                          y2 = bf16(acc + b2), per-block sum/sumsq
//             pool         p = bf16(maxpool(relu(y2*a2 + c2)))
//   backward  route        pool routing recomputed from y2: only positive
//                          maxima take gradient, tied maxima split it evenly;
//                          dt2 in bf16, BN2 sums taken before rounding
//             stage2<1>    dy2 = bf16(BN2 backward) on a haloed tile,
//                          conv1_2^T (flipped, transposed w2) as the same
//                          implicit GEMM, dt1 = dy1n*[t1 > 0] in bf16, BN1
//                          sums before rounding
//             dw2          dW2 = sum over pixels of y1n^T dy2: WMMA, split-K
//                          over one slice of tiles per block
//             dw1          dy1 = bf16(BN1 backward); dW1 = patches^T dy1 in
//                          f32 FMAs, one slice of rows per block
//             colsum       every cross-block reduction: per-block partial
//                          rows summed in a fixed order (no atomics, so two
//                          runs give the same statistics and gradients)
//
// Bound at B = 16: 2*B*300^2*64*(27 + 576 + 576 + 576 + 27) operations =
// 328 GFLOP, 0.33 ms at 989 TFLOP/s dense bf16, against 101 MB of inputs
// and outputs (image, dp, p, weights, gradients; 0.03 ms at 3.35 TB/s):
// bound by operations.  This design also moves y1 and y2 (184 MB each)
// through device memory across the BN barriers, written once and read two
// or three times, about 1.2 GB (0.36 ms).  This first version is simple:
// WMMA on mma.sync with one block per SM for the 3x3x64 convolutions, f32
// FMAs for the 3-channel conv1_1 and its weight gradient; wgmma and TMA
// are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kH = 300, kW = 300, kC = 64;
constexpr int kPH = kH / 2, kPW = kW / 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLd = 80;                           // padded channel stride (bf16)
constexpr int kXW = kW + 2;                       // one input row with SAME padding
constexpr int kTH = 16, kTW = 32;                 // stage-2 conv tile
constexpr int kYH = kTH + 2, kYW = kTW + 2;       // its halo, 18x34
constexpr int kTilesY = (kH + kTH - 1) / kTH;     // 19
constexpr int kTilesX = (kW + kTW - 1) / kTW;     // 10
constexpr int kVecRows = 16;                      // per-channel vectors handed in

// stage2 shared memory
constexpr size_t kWBytes = 9 * kC * kLd * 2;            // 92160
constexpr size_t kHaloBytes = kYH * kYW * kLd * 2;      // 97920
constexpr size_t kStageBytes = kWarps * 256 * 4;        // 8192
constexpr size_t kRedBytes = kWarps * 32 * 8 * 4;       // 8192
constexpr size_t kVecBytes = kVecRows * kC * 4;         // 4096
constexpr size_t kS2OffHalo = kWBytes;
constexpr size_t kS2OffStage = kS2OffHalo + kHaloBytes;
constexpr size_t kS2OffRed = kS2OffStage + kStageBytes;
constexpr size_t kS2OffVec = kS2OffRed + kRedBytes;
constexpr size_t kS2Smem = kS2OffVec + kVecBytes;       // 210560
static_assert(kS2OffHalo % 32 == 0 && kS2OffStage % 32 == 0, "WMMA needs 32-byte alignment");

// dw2 shared memory
constexpr size_t kDyBytes = kTH * kTW * kLd * 2;        // 81920
constexpr size_t kW2OffDy = kHaloBytes;
constexpr size_t kW2OffVec = kW2OffDy + kDyBytes;
constexpr size_t kW2Smem = kW2OffVec + kVecBytes;       // 183936
static_assert(kW2OffDy % 32 == 0, "WMMA needs 32-byte alignment");
constexpr int kW2MTiles = 9 * kC / 16;                  // 36 (tap, ci) row tiles
constexpr int kW2PerWarp = kW2MTiles / 2;               // 18: two warps per N tile

// dw1 shared memory
constexpr size_t kF_X = 3 * kXW * 3;                    // floats
constexpr size_t kF_Dy = kW * kC;                       // floats
constexpr size_t kF_Vec = 5 * kC;                       // floats
constexpr size_t kF_Smem = (kF_X + kF_Dy + kF_Vec) * 4; // 88952

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

// Stage the three input rows r-1 .. r+1 (zero outside the image) as f32.
__device__ __forceinline__ void stage_x_rows(const __nv_bfloat16* __restrict__ x, int b, int r,
                                             float* xs) {
  for (int v = threadIdx.x; v < 3 * kXW * 3; v += blockDim.x) {
    const int ci = v % 3, col = (v / 3) % kXW, dr = v / (3 * kXW);
    const int gr = r - 1 + dr, gc = col - 1;
    float val = 0.0f;
    if (gr >= 0 && gr < kH && gc >= 0 && gc < kW)
      val = __bfloat162float(x[(((size_t)b * kH + gr) * kW + gc) * 3 + ci]);
    xs[v] = val;
  }
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

__global__ void __launch_bounds__(kThreads)
conv1_stats_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, __nv_bfloat16* __restrict__ y1,
                   float* __restrict__ part, int B) {
  __shared__ float xs[3 * kXW * 3];
  __shared__ float w1s[27 * kC];
  __shared__ float b1s[kC];
  __shared__ float red[kThreads * 16];
  const int tid = threadIdx.x, cg = tid & 7;
  for (int v = tid; v < 27 * kC; v += kThreads) w1s[v] = w1[v];
  if (tid < kC) b1s[tid] = b1[tid];
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.0f;

  for (int row = blockIdx.x; row < B * kH; row += gridDim.x) {
    const int b = row / kH, r = row % kH;
    __syncthreads();  // the previous row's readers of xs are done
    stage_x_rows(x, b, r, xs);
    __syncthreads();
    // item = (pixel, 8-channel group); 256 % 8 == 0 keeps cg fixed per thread
    for (int item = tid; item < kW * 8; item += kThreads) {
      const int px = item >> 3;
      float acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = b1s[cg * 8 + k];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            const float xv = xs[(dr * kXW + px + dc) * 3 + ci];
            const float* wr = w1s + ((dr * 3 + dc) * 3 + ci) * kC + cg * 8;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] = fmaf(xv, wr[k], acc[k]);
          }
      float out[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        out[k] = round_bf16(acc[k]);  // statistics of the rounded y1
        s[k] += out[k];
        q[k] += out[k] * out[k];
      }
      store8(y1 + pix_off(b, r, px) + cg * 8, out);
    }
  }
  __syncthreads();
  block_partials_cg8(s, q, red, part + (size_t)blockIdx.x * 2 * kC);
}

// ------------------------------------------- forward B / backward E (stage 2)
//
// MODE 0: src = y1; vec rows 0 a1, 1 c1, 2 b2; out = y2.
// MODE 1: src = dt2, src2 = y2, y1; vec rows 0 ginv2, 1 mu2, 2 inv2,
//         3 S1_2/n, 4 S2_2/n, 5 a1, 6 c1, 7 mu1, 8 inv1; out = dt1.
// w is [tap][k][n] bf16: MODE 0 w2 as [dr][dc][ci][co], MODE 1 the flipped
// transpose [dr'][dc'][co][ci] = w2[2-dr'][2-dc'][ci][co].
// One block of 8 warps computes one (image, 16x32 conv tile); warp w owns
// conv rows 2w and 2w+1 as four 16-pixel M tiles by four 16-channel N tiles.

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
stage2_kernel(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ src2,
              const __nv_bfloat16* __restrict__ w, const float* __restrict__ vec,
              const __nv_bfloat16* __restrict__ y1, __nv_bfloat16* __restrict__ out,
              float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + kS2OffHalo);
  float* stage = reinterpret_cast<float*>(smem + kS2OffStage);
  float* red = reinterpret_cast<float*>(smem + kS2OffRed);
  float* vs = reinterpret_cast<float*>(smem + kS2OffVec);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int R0 = blockIdx.y * kTH, C0 = blockIdx.x * kTW;

  {
    const int4* wsrc = reinterpret_cast<const int4*>(w);  // 8 int4 per 64-wide row
    for (int v = tid; v < 9 * kC * 8; v += kThreads) {
      const int row = v >> 3, part8 = v & 7;
      reinterpret_cast<int4*>(ws + row * kLd)[part8] = wsrc[v];
    }
    for (int v = tid; v < kVecRows * kC; v += kThreads) vs[v] = vec[v];
  }
  __syncthreads();

  // ---- the haloed operand tile (bf16), zero outside the image ----
  for (int item = tid; item < 8 * kYH * kYW; item += kThreads) {
    const int cg = item / (kYH * kYW), pix = item % (kYH * kYW);
    const int gr = R0 - 1 + pix / kYW, gc = C0 - 1 + pix % kYW;
    float o[8];
    if (gr >= 0 && gr < kH && gc >= 0 && gc < kW) {
      const size_t off = pix_off(b, gr, gc) + cg * 8;
      float a[8];
      load8(src + off, a);
      if (MODE == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = cg * 8 + k;
          o[k] = fmaxf(affine(a[k], vs[c], vs[kC + c]), 0.0f);
        }
      } else {
        float yv[8];
        load8(src2 + off, yv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = cg * 8 + k;
          o[k] = bn_bwd(a[k], yv[k], vs[c], vs[kC + c], vs[2 * kC + c], vs[3 * kC + c],
                        vs[4 * kC + c]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = 0.0f;
    }
    store8(hs + pix * kLd + cg * 8, o);
  }
  __syncthreads();

  // ---- implicit GEMM on the tensor cores, depth 9 * 64 ----
  const int warp = tid >> 5, lane = tid & 31;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) wmma::fill_fragment(acc[mt][nn], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    const int dr = tap / 3, dc = tap % 3;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr[4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
        wmma::load_matrix_sync(bfr[nn], ws + (tap * kC + kk * 16) * kLd + nn * 16, kLd);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int yr = 2 * warp + (mt >> 1) + dr;
        const int yc = 16 * (mt & 1) + dc;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afr;
        wmma::load_matrix_sync(afr, hs + (yr * kYW + yc) * kLd + kk * 16, kLd);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) wmma::mma_sync(acc[mt][nn], afr, bfr[nn], acc[mt][nn]);
      }
    }
  }

  // ---- epilogue: one 16x16 tile at a time through shared memory ----
  float* st = stage + warp * 256;
  const int ch = lane & 15;
  float s[4], q[4];
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    s[nn] = q[nn] = 0.0f;
    const int c = nn * 16 + ch;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      wmma::store_matrix_sync(st, acc[mt][nn], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = R0 + 2 * warp + (mt >> 1);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int px = (lane >> 4) + 2 * k;
        const int col = C0 + 16 * (mt & 1) + px;
        if (row < kH && col < kW) {
          const float v = st[px * 16 + ch];
          const size_t off = pix_off(b, row, col) + c;
          if (MODE == 0) {
            const float h = round_bf16(v + vs[2 * kC + c]);  // y2 = bf16(conv + b2)
            out[off] = __float2bfloat16(h);
            s[nn] += h;
            q[nn] += h * h;
          } else {
            const float yv = __bfloat162float(y1[off]);
            const float dt = affine(yv, vs[5 * kC + c], vs[6 * kC + c]) > 0.0f ? v : 0.0f;
            out[off] = __float2bfloat16(dt);
            s[nn] += dt;
            q[nn] += dt * __fmul_rn(__fadd_rn(yv, -vs[7 * kC + c]), vs[8 * kC + c]);
          }
        }
      }
      __syncwarp();
    }
  }

  // ---- per-block partial sums, fixed order ----
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    red[(warp * 32 + lane) * 8 + nn] = s[nn];
    red[(warp * 32 + lane) * 8 + 4 + nn] = q[nn];
  }
  __syncthreads();
  if (tid < 2 * kC) {
    const int which = tid / kC, c = tid % kC, nn = c >> 4, cl = c & 15;
    float total = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) {
      total += red[(wp * 32 + cl) * 8 + which * 4 + nn];
      total += red[(wp * 32 + cl + 16) * 8 + which * 4 + nn];
    }
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    part[(size_t)blk * 2 * kC + tid] = total;
  }
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
// vec rows: 0 a1, 1 c1, 2 ginv2, 3 mu2, 4 inv2, 5 S1_2/n, 6 S2_2/n.
// Block j accumulates dW2 [576][64] over tiles j, j + grid, ...: warp w owns
// N tile w & 3 and M tiles 18*(w >> 2) .. +18, M = (tap, ci).  The A operand
// (ci x pixel) is a column-major view of the y1n halo tile, B (pixel x co)
// the dy2 tile; each K step is 16 pixels of one conv row.

__global__ void __launch_bounds__(kThreads, 1)
dw2_kernel(const __nv_bfloat16* __restrict__ y1, const __nv_bfloat16* __restrict__ dt2,
           const __nv_bfloat16* __restrict__ y2, const float* __restrict__ vec,
           float* __restrict__ part, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(smem + kW2OffDy);
  float* vs = reinterpret_cast<float*>(smem + kW2OffVec);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = warp & 3, mh = warp >> 2;
  for (int v = tid; v < kVecRows * kC; v += kThreads) vs[v] = vec[v];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kW2PerWarp];
#pragma unroll
  for (int mm = 0; mm < kW2PerWarp; ++mm) wmma::fill_fragment(acc[mm], 0.0f);

  const int ntiles = B * kTilesY * kTilesX;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int bx = t % kTilesX, by = (t / kTilesX) % kTilesY, b = t / (kTilesX * kTilesY);
    const int R0 = by * kTH, C0 = bx * kTW;
    __syncthreads();  // vec staged; the previous tile's MMAs are done
    for (int item = tid; item < 8 * kYH * kYW; item += kThreads) {
      const int cg = item / (kYH * kYW), pix = item % (kYH * kYW);
      const int gr = R0 - 1 + pix / kYW, gc = C0 - 1 + pix % kYW;
      float o[8];
      if (gr >= 0 && gr < kH && gc >= 0 && gc < kW) {
        float a[8];
        load8(y1 + pix_off(b, gr, gc) + cg * 8, a);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = cg * 8 + k;
          o[k] = fmaxf(affine(a[k], vs[c], vs[kC + c]), 0.0f);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = 0.0f;
      }
      store8(hs + pix * kLd + cg * 8, o);
    }
    for (int item = tid; item < 8 * kTH * kTW; item += kThreads) {
      const int cg = item / (kTH * kTW), pix = item % (kTH * kTW);
      const int gr = R0 + pix / kTW, gc = C0 + pix % kTW;
      float o[8];
      if (gr < kH && gc < kW) {
        const size_t off = pix_off(b, gr, gc) + cg * 8;
        float dt[8], yv[8];
        load8(dt2 + off, dt);
        load8(y2 + off, yv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = cg * 8 + k;
          o[k] = bn_bwd(dt[k], yv[k], vs[2 * kC + c], vs[3 * kC + c], vs[4 * kC + c],
                        vs[5 * kC + c], vs[6 * kC + c]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = 0.0f;
      }
      store8(ds + pix * kLd + cg * 8, o);
    }
    __syncthreads();

    for (int i = 0; i < kTH; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, ds + (i * kTW + 16 * hh) * kLd + n * 16, kLd);
#pragma unroll
        for (int mm = 0; mm < kW2PerWarp; ++mm) {
          const int m = mh * kW2PerWarp + mm, tap = m >> 2, cib = m & 3;
          const int dr = tap / 3, dc = tap % 3;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> afr;
          wmma::load_matrix_sync(afr, hs + ((i + dr) * kYW + 16 * hh + dc) * kLd + cib * 16, kLd);
          wmma::mma_sync(acc[mm], afr, bfr, acc[mm]);
        }
      }
    }
  }

  float* prow = part + (size_t)blockIdx.x * (9 * kC * kC);
#pragma unroll
  for (int mm = 0; mm < kW2PerWarp; ++mm) {
    const int m = mh * kW2PerWarp + mm;
    wmma::store_matrix_sync(prow + (size_t)m * 16 * kC + n * 16, acc[mm], kC, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------- backward dW1
//
// vec rows: 0 ginv1, 1 mu1, 2 inv1, 3 S1_1/n, 4 S2_1/n.  Block j takes image
// rows j, j + grid, ...: dy1 of the row (bf16 values) goes to shared memory,
// then thread (g = tid >> 6, co = tid & 63) accumulates dW1[k][co] for
// k = g, g + 4, ... < 27, k = (dr*3 + dc)*3 + ci.

__global__ void __launch_bounds__(kThreads)
dw1_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y1,
           const __nv_bfloat16* __restrict__ dt1, const float* __restrict__ vec,
           float* __restrict__ part, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* dys = xs + kF_X;
  float* vs = dys + kF_Dy;
  const int tid = threadIdx.x, cg = tid & 7, co = tid & 63, g = tid >> 6;
  for (int v = tid; v < 5 * kC; v += kThreads) vs[v] = vec[v];
  int xoff[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int k = g + 4 * j < 27 ? g + 4 * j : 0;
    const int tap = k / 3, ci = k % 3;
    xoff[j] = ((tap / 3) * kXW + tap % 3) * 3 + ci;
  }
  float acc[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) acc[j] = 0.0f;

  for (int row = blockIdx.x; row < B * kH; row += gridDim.x) {
    const int b = row / kH, r = row % kH;
    __syncthreads();
    stage_x_rows(x, b, r, xs);
    for (int item = tid; item < kW * 8; item += kThreads) {
      const int px = item >> 3;
      const size_t off = pix_off(b, r, px) + cg * 8;
      float dt[8], yv[8];
      load8(dt1 + off, dt);
      load8(y1 + off, yv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = cg * 8 + k;
        dys[px * kC + c] = round_bf16(bn_bwd(dt[k], yv[k], vs[c], vs[kC + c], vs[2 * kC + c],
                                             vs[3 * kC + c], vs[4 * kC + c]));
      }
    }
    __syncthreads();
    for (int p = 0; p < kW; ++p) {
      const float d = dys[p * kC + co];
      const float* xp = xs + p * 3;
#pragma unroll
      for (int j = 0; j < 7; ++j) acc[j] = fmaf(xp[xoff[j]], d, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    const int k = g + 4 * j;
    if (k < 27) part[(size_t)blockIdx.x * 27 * kC + k * kC + co] = acc[j];
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

extern "C" int ssdx_st_conv1(const void* x, const float* w1, const float* b1, void* y1,
                             float* part, int B, int grid, cudaStream_t stream) {
  conv1_stats_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), w1, b1,
      reinterpret_cast<__nv_bfloat16*>(y1), part, B);
  return (int)cudaGetLastError();
}

// Partial rows: B * 19 * 10, one per conv tile.
extern "C" int ssdx_st_stage2(int mode, const void* src, const void* src2, const void* w,
                              const float* vec, const void* y1, void* out, float* part, int B,
                              cudaStream_t stream) {
  const dim3 grid(kTilesX, kTilesY, B);
  const auto* s = reinterpret_cast<const __nv_bfloat16*>(src);
  const auto* s2 = reinterpret_cast<const __nv_bfloat16*>(src2);
  const auto* wp = reinterpret_cast<const __nv_bfloat16*>(w);
  const auto* y = reinterpret_cast<const __nv_bfloat16*>(y1);
  auto* o = reinterpret_cast<__nv_bfloat16*>(out);
  cudaError_t e;
  if (mode == 0) {
    if ((e = allow_smem(stage2_kernel<0>, kS2Smem)) != cudaSuccess) return (int)e;
    stage2_kernel<0><<<grid, kThreads, kS2Smem, stream>>>(s, s2, wp, vec, y, o, part);
  } else {
    if ((e = allow_smem(stage2_kernel<1>, kS2Smem)) != cudaSuccess) return (int)e;
    stage2_kernel<1><<<grid, kThreads, kS2Smem, stream>>>(s, s2, wp, vec, y, o, part);
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
extern "C" int ssdx_st_dw2(const void* y1, const void* dt2, const void* y2, const float* vec,
                           float* part, int B, int grid, cudaStream_t stream) {
  cudaError_t e = allow_smem(dw2_kernel, kW2Smem);
  if (e != cudaSuccess) return (int)e;
  dw2_kernel<<<grid, kThreads, kW2Smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(y1), reinterpret_cast<const __nv_bfloat16*>(dt2),
      reinterpret_cast<const __nv_bfloat16*>(y2), vec, part, B);
  return (int)cudaGetLastError();
}

// Partial rows of 27 * 64 floats ([(dr*3 + dc)*3 + ci][co]).
extern "C" int ssdx_st_dw1(const void* x, const void* y1, const void* dt1, const float* vec,
                           float* part, int B, int grid, cudaStream_t stream) {
  cudaError_t e = allow_smem(dw1_kernel, kF_Smem);
  if (e != cudaSuccess) return (int)e;
  dw1_kernel<<<grid, kThreads, kF_Smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(y1),
      reinterpret_cast<const __nv_bfloat16*>(dt1), vec, part, B);
  return (int)cudaGetLastError();
}

extern "C" int ssdx_st_colsum(const float* in, int n, int K, float* out, cudaStream_t stream) {
  colsum_kernel<<<(K + 31) / 32, 1024, 0, stream>>>(in, n, K, out);
  return (int)cudaGetLastError();
}
