// Train-mode BatchNorm + ReLU + 2x2/2 max pool on NHWC for Hopper (sm_90a),
// forward and backward, in four passes.
//
// Replaces: ssdx/ops/fused_bn_pool.py, bn_relu_pool (the Pallas bodies
// _fwd_stats_kernel, _fwd_apply_kernel, _bwd_reduce_kernel, _bwd_dx_kernel).
//
//   stats    x -> per-block partial rows [sum | sum of squares] in float32
//   apply    y = relu(x*a + b) in float32, p = max over the window, rounded
//            once at the store; the full-size y never reaches device memory
//   reduce   recompute y, route the pooled cotangent g to the positions
//            equal to the window's maximum where that maximum is > 0
//            (ReLU's subgradient at 0 is 0), tied maxima splitting g evenly
//            (or each taking all of it, tie_split = 0); per-block partial
//            rows [s1 = sum dy | s2 = sum dy*xhat]
//   dx       the same routing, then dx = gi*dy + (x - mu)*A + B0 with
//            A = gvar*2/n - gi*inv*s2/n and B0 = gmean/n - gi*s1/n, which is
//            the BN backward plus the cotangents of the mean and var outputs
// Between the passes two small kernels add the partial rows in a fixed order
// and do the per-channel arithmetic in float32:
//   stats_finalize   sums -> mean, var = max(E[x^2] - mean^2, 0),
//                    inv = rsqrt(var + eps), a = gamma*inv, b = beta - mean*a
//   reduce_finalize  sums -> s1 (= dbeta), s2 (= dgamma), A, B0
// so a forward is three launches and a backward three, with no PyTorch op
// between them.  The backward takes a, b, inv and mean as the forward stored
// them (a [4,C] float32 row block), never recomputed.
//
// Routing: the backward must pick the positions the forward's maximum came
// from.  The TPU version stores two mask planes for that, because XLA may
// contract x*a + b differently in two programs.  Here all three passes call
// one device function, bn_relu(), written with __fmul_rn and __fadd_rn, so no
// pass can contract it into an FMA and y has the same bits everywhere: the
// backward recomputes the routing from x, which it has to read anyway for
// xhat, with the forward's own a and b, and no mask or index is stored (a
// byte per window would add a write to the forward and a read to each
// backward pass).
//
// Shapes: any B, H, W >= 1, C % 8 == 0 and C <= 2048, bfloat16 or float32,
// floor mode (H/2 x W/2 windows; an odd last row or column is in the
// statistics and takes the BN part of dx but no routed gradient) or ceil
// mode ((H+1)/2 x (W+1)/2 windows, positions past the edge count as -inf).
// None of the TPU layout carries over (the pair-packed [M,2,W/2,2C] view, the
// 2C % 128 and W/2 >= 8 conditions, the 8-row padded partials, the mask
// planes).
//
// Bound: bytes.  With each input and output counted once (x, p; x, g, dx)
// forward + backward move 3.5 x |x|: 645.1 MB at [16,300,300,64] bf16, 0.193
// ms at 3.35 TB/s.  Each BN barrier forces a second read of x (stats then
// apply, reduce then dx), so these four passes move 5.75 x |x| = 1,059.8 MB,
// 0.316 ms.  One thread takes 8 channels of one window; every access is one
// 16-byte load or store (two for float32).  In stats, reduce and dx a thread
// keeps one channel group for the whole kernel, so its per-channel vectors
// and partial sums stay in registers, and no atomics are used: two runs give
// the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Blocks per SM that reduce_kernel and dx_kernel are compiled for.  Uncapped
// they take 176 registers, so one block fits an SM and too few loads are in
// flight; two blocks cap them at 128 registers at the price of 120-280 bytes
// of spills and run faster.  Three blocks (80 registers) spill several times
// as much and ran slower than no cap at all.
constexpr int kMinBlocks = 2;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int q = 0; q < 8; ++q) out[q] = __bfloat162float(h[q]);
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16(in[q]);
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(h);
}

__device__ __forceinline__ void store8(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(in[4], in[5], in[6], in[7]);
}

// The normalized activation, rounded operation by operation: the one
// definition every pass uses (see "Routing" above).
__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.0f);
}

// Thread -> (channel group cg, slot): a block walks `slots` pixels or
// windows at a time and a thread keeps its channel group throughout.
// Threads past slots * G (when G does not divide the block) stay idle.
struct Lane {
  int cg, slot, slots;
  bool active;
};

__device__ __forceinline__ Lane lane_of(int G) {
  Lane l;
  l.slots = kThreads / G;
  l.cg = threadIdx.x % G;
  l.slot = threadIdx.x / G;
  l.active = l.slot < l.slots;
  return l;
}

__device__ __forceinline__ void load_row8(const float* __restrict__ vec, int row, int C, int cg,
                                          float* out) {
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = vec[(size_t)row * C + cg * 8 + k];
}

// Per-thread sums s, q of 8 channels -> this block's partial row [2][C],
// added over the slots in a fixed order.
__device__ __forceinline__ void block_partials(const float* s, const float* q, float* red,
                                               float* __restrict__ part_row, int C) {
  const int tid = threadIdx.x, G = C / 8, slots = kThreads / G;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    red[tid * 16 + k] = s[k];
    red[tid * 16 + 8 + k] = q[k];
  }
  __syncthreads();
  for (int o = tid; o < 2 * C; o += kThreads) {
    const int which = o / C, c = o % C, g = c >> 3, k = c & 7;
    float acc = 0.0f;
    for (int j = 0; j < slots; ++j) acc += red[(j * G + g) * 16 + which * 8 + k];
    part_row[o] = acc;
  }
}

// ------------------------------------------------------------------- stats

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, float* __restrict__ part, int npix, int C) {
  __shared__ float red[kThreads * 16];
  const Lane l = lane_of(C / 8);
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.0f;
  if (l.active) {
    for (size_t pix = (size_t)blockIdx.x * l.slots + l.slot; pix < (size_t)npix;
         pix += (size_t)gridDim.x * l.slots) {
      float v[8];
      load8(x + pix * C + l.cg * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[k] += v[k];
        q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }
  block_partials(s, q, red, part + (size_t)blockIdx.x * 2 * C, C);
}

// ------------------------------------------------------------------- apply
// vec rows: 0 a, 1 b.

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ vec, T* __restrict__ p, int B,
             int H, int W, int C, int Hp, int Wp) {
  const int G = C / 8;
  const size_t total = (size_t)B * Hp * Wp * G;
  for (size_t item = (size_t)blockIdx.x * kThreads + threadIdx.x; item < total;
       item += (size_t)gridDim.x * kThreads) {
    const int cg = (int)(item % G);
    const size_t w = item / G;
    const int Q = (int)(w % Wp), P = (int)((w / Wp) % Hp), b = (int)(w / ((size_t)Wp * Hp));
    float a[8], c[8], m[8];
    load_row8(vec, 0, C, cg, a);
    load_row8(vec, 1, C, cg, c);
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * P + (i >> 1), col = 2 * Q + (i & 1);
      if (r < H && col < W) {  // past the edge only in ceil mode
        float v[8];
        load8(x + (((size_t)b * H + r) * W + col) * C + cg * 8, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], bn_relu(v[k], a[k], c[k]));
      }
    }
    store8(p + w * C + cg * 8, m);
  }
}

// ------------------------------------------------------ backward: routing
//
// Loads the window (P, Q) of image b, recomputes y and returns the routed
// cotangent d[i][k] of its four positions (0 where a position is past the
// edge or the window was not pooled) and the loaded x in v.

template <typename T>
__device__ __forceinline__ void route_window(const T* __restrict__ x, const T* __restrict__ g,
                                             const float* a, const float* c, int b, int P, int Q,
                                             int cg, int H, int W, int C, int Hp, int Wp,
                                             int tie_split, float v[4][8], float d[4][8],
                                             bool in[4]) {
  float y[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * P + (i >> 1), col = 2 * Q + (i & 1);
    in[i] = r < H && col < W;
    if (in[i]) {
      load8(x + (((size_t)b * H + r) * W + col) * C + cg * 8, v[i]);
#pragma unroll
      for (int k = 0; k < 8; ++k) y[i][k] = bn_relu(v[i][k], a[k], c[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[i][k] = 0.0f;
        y[i][k] = -CUDART_INF_F;
      }
    }
  }
  if (P >= Hp || Q >= Wp) {  // floor mode's odd last row or column
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) d[i][k] = 0.0f;
    return;
  }
  float gg[8];
  load8(g + (((size_t)b * Hp + P) * Wp + Q) * C + cg * 8, gg);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float pm = fmaxf(fmaxf(y[0][k], y[1][k]), fmaxf(y[2][k], y[3][k]));
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) cnt += (y[i][k] == pm && pm > 0.0f) ? 1 : 0;
    const float share = tie_split ? gg[k] / fmaxf((float)cnt, 1.0f) : gg[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i][k] = (y[i][k] == pm && pm > 0.0f) ? share : 0.0f;
  }
}

// vec rows: 0 a, 1 b, 2 inv, 3 mu.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
reduce_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ vec,
              float* __restrict__ part, int B, int H, int W, int C, int Hp, int Wp,
              int tie_split) {
  __shared__ float red[kThreads * 16];
  const Lane l = lane_of(C / 8);
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.0f;
  if (l.active) {
    float a[8], c[8], inv[8], mu[8];
    load_row8(vec, 0, C, l.cg, a);
    load_row8(vec, 1, C, l.cg, c);
    load_row8(vec, 2, C, l.cg, inv);
    load_row8(vec, 3, C, l.cg, mu);
    const size_t nwin = (size_t)B * Hp * Wp;
    for (size_t w = (size_t)blockIdx.x * l.slots + l.slot; w < nwin;
         w += (size_t)gridDim.x * l.slots) {
      const unsigned wi = (unsigned)w, row = wi / Wp;
      const int Q = (int)(wi - row * Wp), b = (int)(row / Hp), P = (int)(row - b * Hp);
      float v[4][8], d[4][8];
      bool in[4];
      route_window(x, g, a, c, b, P, Q, l.cg, H, W, C, Hp, Wp, tie_split, v, d, in);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s[k] += d[i][k];
          q[k] = fmaf(d[i][k], (v[i][k] - mu[k]) * inv[k], q[k]);
        }
    }
  }
  block_partials(s, q, red, part + (size_t)blockIdx.x * 2 * C, C);
}

// vec rows: 0 a (= gamma*inv, dx's factor of dy), 1 b, 2 inv, 3 mu; fin rows:
// 0 s1, 1 s2, 2 A, 3 B0.  The index space covers every pixel: (H+1)/2 x
// (W+1)/2 windows, of which Hp x Wp were pooled.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dx_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ vec,
          const float* __restrict__ fin, T* __restrict__ dx, int B, int H, int W, int C, int Hp,
          int Wp, int tie_split) {
  const Lane l = lane_of(C / 8);
  if (!l.active) return;
  float a[8], c[8], mu[8], A[8], B0[8];
  load_row8(vec, 0, C, l.cg, a);
  load_row8(vec, 1, C, l.cg, c);
  load_row8(vec, 3, C, l.cg, mu);
  load_row8(fin, 2, C, l.cg, A);
  load_row8(fin, 3, C, l.cg, B0);
  const int Hc = (H + 1) / 2, Wc = (W + 1) / 2;
  const size_t nwin = (size_t)B * Hc * Wc;
  for (size_t w = (size_t)blockIdx.x * l.slots + l.slot; w < nwin;
       w += (size_t)gridDim.x * l.slots) {
    const unsigned wi = (unsigned)w, row = wi / Wc;
    const int Q = (int)(wi - row * Wc), b = (int)(row / Hc), P = (int)(row - b * Hc);
    float v[4][8], d[4][8];
    bool in[4];
    route_window(x, g, a, c, b, P, Q, l.cg, H, W, C, Hp, Wp, tie_split, v, d, in);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!in[i]) continue;
      float o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        o[k] = fmaf(a[k], d[i][k], fmaf(v[i][k] - mu[k], A[k], B0[k]));
      const int r = 2 * P + (i >> 1), col = 2 * Q + (i & 1);
      store8(dx + (((size_t)b * H + r) * W + col) * C + l.cg * 8, o);
    }
  }
}

// ------------------------------------- fixed-order sums and the channel math
//
// One block per 32 channels: 32 groups of threads each add every 32nd partial
// row, then group 0 adds the 32 group sums in order and does the arithmetic.

__device__ __forceinline__ void column_sums(const float* __restrict__ part, int n, int C, int col,
                                            float red[2][32][33], float& t0, float& t1) {
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  float s0 = 0.0f, s1 = 0.0f;
  if (col < C)
    for (int i = g; i < n; i += 32) {
      s0 += part[(size_t)i * 2 * C + col];
      s1 += part[(size_t)i * 2 * C + C + col];
    }
  red[0][g][c] = s0;
  red[1][g][c] = s1;
  __syncthreads();
  t0 = t1 = 0.0f;
  if (g == 0)
    for (int j = 0; j < 32; ++j) {
      t0 += red[0][j][c];
      t1 += red[1][j][c];
    }
}

// part [n][2][C] -> mean, var [C] and vec rows 0 a, 1 b, 2 inv, 3 mu.
__global__ void __launch_bounds__(1024)
stats_finalize_kernel(const float* __restrict__ part, int n, int C, float count, float eps,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      float* __restrict__ mean, float* __restrict__ var,
                      float* __restrict__ vec) {
  __shared__ float red[2][32][33];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31);
  float sum, sq;
  column_sums(part, n, C, col, red, sum, sq);
  if ((threadIdx.x >> 5) == 0 && col < C) {
    const float mu = sum / count;
    const float va = fmaxf(__fsub_rn(sq / count, __fmul_rn(mu, mu)), 0.0f);
    const float inv = rsqrtf(va + eps);
    const float a = gamma[col] * inv;
    mean[col] = mu;
    var[col] = va;
    vec[col] = a;
    vec[C + col] = __fsub_rn(beta[col], __fmul_rn(mu, a));
    vec[2 * C + col] = inv;
    vec[3 * C + col] = mu;
  }
}

// part [n][2][C] -> fin rows 0 s1, 1 s2, 2 A = gvar*2/n - a*inv*s2/n,
// 3 B0 = gmean/n - a*s1/n  (a = gamma*inv).
__global__ void __launch_bounds__(1024)
reduce_finalize_kernel(const float* __restrict__ part, int n, int C, float count,
                       const float* __restrict__ vec, const float* __restrict__ gmean,
                       const float* __restrict__ gvar, float* __restrict__ fin) {
  __shared__ float red[2][32][33];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31);
  float s1, s2;
  column_sums(part, n, C, col, red, s1, s2);
  if ((threadIdx.x >> 5) == 0 && col < C) {
    const float a = vec[col], inv = vec[2 * C + col];
    fin[col] = s1;
    fin[C + col] = s2;
    fin[2 * C + col] = gvar[col] * (2.0f / count) - a * inv * (s2 / count);
    fin[3 * C + col] = gmean[col] / count - a * (s1 / count);
  }
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// dtype: 0 = bfloat16, 1 = float32.  `grid` is the number of blocks, and for
// stats and reduce the number of partial rows [2][C] written.

#define SSDX_BRP_DISPATCH(KERNEL, ...)                                          \
  if (dtype == 0) {                                                             \
    using T = __nv_bfloat16;                                                    \
    KERNEL<T><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);                      \
  } else {                                                                      \
    using T = float;                                                            \
    KERNEL<T><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);                      \
  }                                                                             \
  return (int)cudaGetLastError();

extern "C" int ssdx_brp_stats(const void* x, float* part, int npix, int C, int dtype, int grid,
                              cudaStream_t stream) {
  SSDX_BRP_DISPATCH(stats_kernel, reinterpret_cast<const T*>(x), part, npix, C)
}

extern "C" int ssdx_brp_apply(const void* x, const float* vec, void* p, int B, int H, int W,
                              int C, int Hp, int Wp, int dtype, int grid, cudaStream_t stream) {
  SSDX_BRP_DISPATCH(apply_kernel, reinterpret_cast<const T*>(x), vec, reinterpret_cast<T*>(p), B,
                    H, W, C, Hp, Wp)
}

extern "C" int ssdx_brp_reduce(const void* x, const void* g, const float* vec, float* part,
                               int B, int H, int W, int C, int Hp, int Wp, int tie_split,
                               int dtype, int grid, cudaStream_t stream) {
  SSDX_BRP_DISPATCH(reduce_kernel, reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(g),
                    vec, part, B, H, W, C, Hp, Wp, tie_split)
}

extern "C" int ssdx_brp_dx(const void* x, const void* g, const float* vec, const float* fin,
                           void* dx, int B, int H, int W, int C, int Hp, int Wp, int tie_split,
                           int dtype, int grid, cudaStream_t stream) {
  SSDX_BRP_DISPATCH(dx_kernel, reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(g), vec,
                    fin, reinterpret_cast<T*>(dx), B, H, W, C, Hp, Wp, tie_split)
}

// n = the partial rows that stats or reduce wrote; count = B*H*W.

extern "C" int ssdx_brp_stats_finalize(const float* part, int n, int C, float count, float eps,
                                       const float* gamma, const float* beta, float* mean,
                                       float* var, float* vec, cudaStream_t stream) {
  stats_finalize_kernel<<<(C + 31) / 32, 1024, 0, stream>>>(part, n, C, count, eps, gamma, beta,
                                                            mean, var, vec);
  return (int)cudaGetLastError();
}

extern "C" int ssdx_brp_reduce_finalize(const float* part, int n, int C, float count,
                                        const float* vec, const float* gmean, const float* gvar,
                                        float* fin, cudaStream_t stream) {
  reduce_finalize_kernel<<<(C + 31) / 32, 1024, 0, stream>>>(part, n, C, count, vec, gmean, gvar,
                                                             fin);
  return (int)cudaGetLastError();
}
