// 2x2 stride-2 max pool on NHWC for Hopper (sm_90a): forward and backward.
//
// Replaces: ssdx/ops/pallas_pool.py, max_pool_2x2 (the Pallas body _bwd_kernel
// behind _pool_bwd_pallas, and the XLA forward _pool_fwd_packed).
//
//   forward   p[b,P,Q,c]  = max of the window y[b, 2P..2P+1, 2Q..2Q+1, c]
//   backward  dy = where(y == p, g / cnt, 0), cnt = positions of the window
//             equal to its maximum (1..4), the share g / cnt taken in float32
//             and rounded once to the tensor's type: tied maxima split the
//             cotangent evenly.
//
// Shapes: any B, H, W >= 1 with C % 8 == 0, bfloat16 or float32.  The pool is
// the floor mode of the JAX op (H/2 x W/2 windows): an odd last row or column
// belongs to no window and its dy is 0, written by the same kernel.  None of
// the TPU layout carries over (the pair-packed [M,2,W/2,2C] view, the
// 2C % 128 and W/2 >= 8 conditions, the row blocks sized for VMEM).
//
// Bound: bytes.  The forward reads y and writes p (1.25 x |y|), the backward
// reads y, p, g and writes dy (2.5 x |y|); at [16,300,300,64] bf16 that is
// 230.4 MB and 460.8 MB, 0.069 ms and 0.138 ms at 3.35 TB/s.  There is no
// reuse, so the design is one pass: one thread takes 8 channels of one
// window, every access is one 16-byte load or store (two for float32) with
// neighbouring threads on neighbouring addresses, and the arithmetic stays in
// float32 registers (exact for bfloat16 values).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// item -> (8-channel group, window column, window row, image) over a
// [B, rows, cols, G] index space.
struct Item {
  int cg, Q, P, b;
};

__device__ __forceinline__ Item split(size_t item, int G, int cols, int rows) {
  Item it;
  it.cg = (int)(item % G);
  const size_t w = item / G;
  it.Q = (int)(w % cols);
  it.P = (int)((w / cols) % rows);
  it.b = (int)(w / ((size_t)cols * rows));
  return it;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_fwd_kernel(const T* __restrict__ y, T* __restrict__ p, int B, int H, int W, int C) {
  const int Hp = H / 2, Wp = W / 2, G = C / 8;
  const size_t total = (size_t)B * Hp * Wp * G;
  for (size_t item = (size_t)blockIdx.x * kThreads + threadIdx.x; item < total;
       item += (size_t)gridDim.x * kThreads) {
    const Item it = split(item, G, Wp, Hp);
    const size_t base = (((size_t)it.b * H + 2 * it.P) * W + 2 * it.Q) * C + it.cg * 8;
    const size_t row = (size_t)W * C;
    float v[4][8], m[8];
    load8(y + base, v[0]);
    load8(y + base + C, v[1]);
    load8(y + base + row, v[2]);
    load8(y + base + row + C, v[3]);
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = fmaxf(fmaxf(v[0][k], v[1][k]), fmaxf(v[2][k], v[3][k]));
    store8(p + (((size_t)it.b * Hp + it.P) * Wp + it.Q) * C + it.cg * 8, m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const T* __restrict__ y, const T* __restrict__ p, const T* __restrict__ g,
                T* __restrict__ dy, int B, int H, int W, int C) {
  // The index space covers every pixel: (H+1)/2 x (W+1)/2 windows, of which
  // the H/2 x W/2 whole ones were pooled.
  const int Hp = H / 2, Wp = W / 2, Hc = (H + 1) / 2, Wc = (W + 1) / 2, G = C / 8;
  const size_t total = (size_t)B * Hc * Wc * G;
  const size_t row = (size_t)W * C;
  for (size_t item = (size_t)blockIdx.x * kThreads + threadIdx.x; item < total;
       item += (size_t)gridDim.x * kThreads) {
    const Item it = split(item, G, Wc, Hc);
    const size_t base = (((size_t)it.b * H + 2 * it.P) * W + 2 * it.Q) * C + it.cg * 8;
    float d[4][8];
    if (it.P >= Hp || it.Q >= Wp) {  // the odd last row or column: no window
#pragma unroll
      for (int k = 0; k < 8; ++k) d[0][k] = 0.0f;
      const bool right = 2 * it.Q + 1 < W, below = 2 * it.P + 1 < H;
      store8(dy + base, d[0]);
      if (right) store8(dy + base + C, d[0]);
      if (below) store8(dy + base + row, d[0]);
      continue;  // right && below would be a whole window
    }
    const size_t po = (((size_t)it.b * Hp + it.P) * Wp + it.Q) * C + it.cg * 8;
    float v[4][8], pm[8], gg[8];
    load8(y + base, v[0]);
    load8(y + base + C, v[1]);
    load8(y + base + row, v[2]);
    load8(y + base + row + C, v[3]);
    load8(p + po, pm);
    load8(g + po, gg);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) cnt += (v[i][k] == pm[k]) ? 1 : 0;
      const float share = gg[k] / fmaxf((float)cnt, 1.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i][k] = (v[i][k] == pm[k]) ? share : 0.0f;
    }
    store8(dy + base, d[0]);
    store8(dy + base + C, d[1]);
    store8(dy + base + row, d[2]);
    store8(dy + base + row + C, d[3]);
  }
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// dtype: 0 = bfloat16, 1 = float32.  `grid` is the number of blocks.

extern "C" int ssdx_pool_fwd(const void* y, void* p, int B, int H, int W, int C, int dtype,
                             int grid, cudaStream_t stream) {
  if (dtype == 0)
    pool_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(y), reinterpret_cast<__nv_bfloat16*>(p), B, H, W,
        C);
  else
    pool_fwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float*>(y), reinterpret_cast<float*>(p), B, H, W, C);
  return (int)cudaGetLastError();
}

extern "C" int ssdx_pool_bwd(const void* y, const void* p, const void* g, void* dy, int B, int H,
                             int W, int C, int dtype, int grid, cudaStream_t stream) {
  if (dtype == 0)
    pool_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(y), reinterpret_cast<const __nv_bfloat16*>(p),
        reinterpret_cast<const __nv_bfloat16*>(g), reinterpret_cast<__nv_bfloat16*>(dy), B, H, W,
        C);
  else
    pool_bwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float*>(y), reinterpret_cast<const float*>(p),
        reinterpret_cast<const float*>(g), reinterpret_cast<float*>(dy), B, H, W, C);
  return (int)cudaGetLastError();
}
