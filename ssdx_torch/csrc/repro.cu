// The two probe kernels of the data-parallel repro tool
// (ssdx_torch/tools/repro_dist_kernels.py), for Hopper (sm_90a).
//
// Replaces: scripts/repro_shardmap_pallas.py, _ew_kernel (through case_tiny)
// and _mm_kernel (through case_matmul): the TPU kernels that the script runs
// outside and inside shard_map to tell a fault of a kernel from a fault of
// the data-parallel wrapper.
//
// ew:  out = tanh(x) * 1.5 on n float32 values.  One thread handles four
//      values with one 16-byte load and one 16-byte store; a tail that is
//      not a multiple of four goes value by value.  Bound by bytes (x read
//      once, out written once, at 3.35 TB/s); at the tool's 256x256 input
//      that is 0.16 us, far below the cost of a launch.
//
// mm:  out [M,N] float32 = x [M,K] bf16 @ y [K,N] bf16, both row-major as
//      the TPU kernel takes them (a rank's row shard of x against the whole
//      y), accumulated in float32 in the order of k, so a row's result does
//      not depend on which rows share its launch: a shard computed alone
//      equals the same rows of the whole product bit for bit.  A block of 4
//      warps computes a 64x64 tile; K is walked in slices of 32 through
//      shared memory (rows padded by 8 values against bank conflicts); each
//      warp owns 32x32 of the tile as 2x2 WMMA fragments (16x16x16, bf16 in,
//      f32 accumulate).  Rows of x past M are read as zero and never stored,
//      so M need only be a multiple of 16; N a multiple of 64 and K of 32.
//      Bound by operations (2*M*N*K at 989 TFLOP/s: 2.2 us at 1024^3); a
//      simple tile like this one, with plain loads and no pipeline, is far
//      from that, and at 1024^3 fills 256 blocks on 132 SMs.  A cp.async or
//      TMA ring and wgmma are what a faster version would use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

__global__ void ew_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i + 3 < n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(tanhf(v.x) * 1.5f, tanhf(v.y) * 1.5f, tanhf(v.z) * 1.5f, tanhf(v.w) * 1.5f);
  } else {
    for (long long j = i; j < n; ++j) out[j] = tanhf(x[j]) * 1.5f;
  }
}

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8;  // shared row strides in bf16 values
constexpr int LDB = BN + 8;
constexpr int MM_THREADS = 128;

__global__ void __launch_bounds__(MM_THREADS)
mm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
          float* __restrict__ out, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 sA[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 sB[BK * LDB];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 32 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 64 rows x 32 values = 256 segments of 8 values (16 bytes)
#pragma unroll
    for (int s = tid; s < BM * BK / 8; s += MM_THREADS) {
      const int r = s >> 2, c = (s & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(sA + r * LDA + c) = v;
    }
    // B tile: 32 rows x 64 values = 256 segments
#pragma unroll
    for (int s = tid; s < BK * BN / 8; s += MM_THREADS) {
      const int r = s >> 3, c = (s & 7) * 8;
      *reinterpret_cast<uint4*>(sB + r * LDB + c) =
          *reinterpret_cast<const uint4*>(y + (size_t)(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sB + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + wm * 32 + i * 16;
    if (m >= M) continue;  // M is a multiple of 16: a fragment is whole or absent
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * 32 + j * 16;
      wmma::store_matrix_sync(out + (size_t)m * N + n, acc[i][j], N, wmma::mem_row_major);
    }
  }
}

}  // namespace

// Each returns the CUDA error of the launch (0 = success).  All pointers are
// device pointers, 16-byte aligned.

extern "C" int ssdx_repro_ew(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = ((n + 3) / 4 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ew_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ssdx_repro_mm(const void* x, const void* y, void* out, int M, int N, int K,
                             void* stream) {
  if (M <= 0 || M % 16 || N <= 0 || N % BN || K <= 0 || K % BK) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  mm_kernel<<<grid, MM_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}
