// The elementwise probe kernel of the data-parallel repro tool
// (ssdx_torch/tools/repro_dist_kernels.py), for Hopper (sm_90a).
//
// Replaces: scripts/repro_shardmap_pallas.py, _ew_kernel (through case_tiny):
// one of the TPU kernels that the script runs outside and inside shard_map to
// tell a fault of a kernel from a fault of the data-parallel wrapper.  Its
// other kernel, _mm_kernel (through case_matmul), is the "nn" kernel of
// csrc/gemm_sm90.cu, which replaced this file's WMMA tile.
//
// ew:  out = tanh(x) * 1.5 on n float32 values.  One thread handles four
//      values with one 16-byte load and one 16-byte store; a tail that is
//      not a multiple of four goes value by value.  Bound by bytes (x read
//      once, out written once, at 3.35 TB/s); at the tool's 256x256 input
//      that is 0.16 us, far below the cost of a launch.
#include <cuda_runtime.h>
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

}  // namespace

// Returns the CUDA error of the launch (0 = success).  Both pointers are
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
