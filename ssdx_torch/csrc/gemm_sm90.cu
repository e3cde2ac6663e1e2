// The bare matrix products of the port on Hopper (sm_90a): one main loop of
// TMA tile loads and wgmma, with a raw int32 or float32 store.
//
// Replaces: scripts/bench_int8_mxu.py:55, _pallas_mm (the int8 tensor-core
// probe, s8 x s8 -> s32, and its bf16 -> f32 control: kernel S1, through
// ssdx_torch/ops/int8_conv.py int8_mm_raw and bf16_mm_raw), and
// scripts/repro_shardmap_pallas.py:88, _mm_kernel (the repro tool's bf16 ->
// f32 matmul: kernel S2b, through ssdx_torch/ops/repro.py mm).
//
// Entry points (each returns the CUDA error of the launch, 0 = success):
//   ssdx_gemm_s8s32_nt    a [M,K] int8 . b_t [N,K] int8 -> out [M,N] int32
//   ssdx_gemm_bf16f32_nt  a [M,K] bf16 . b_t [N,K] bf16 -> out [M,N] float32
//   ssdx_gemm_bf16f32_nn  x [M,K] bf16 . y [K,N] bf16   -> out [M,N] float32
// all row-major and dense.  In "nt" both operands are K-major, the only
// layout int8 wgmma takes; in "nn" the second operand is N-major and goes
// through wgmma's transpose bit, which 16-bit types allow.
//
// Bound: 2*M*N*K operations at the dense peak (1,979 TOP/s int8, 989
// TFLOP/s bf16) against each operand read once and the output written once
// at 3.35 TB/s.  At 2048^3 S1 is bound by operations: 0.0087 ms in int8,
// 0.0174 ms in bf16.  S2b at 1024^3 is bound by bytes, 0.0025 ms (the 4 MB
// float32 output), just above its operations' 0.0022 ms.
//
// Design (the ring, the loader/consumer split and the main loop are
// sm90.cuh's, shared with int8_conv.cu).  A block computes a BM x BN output
// tile: BM / 64 consumer
// warpgroups of 64 rows each and one loader warpgroup.  The tiles are 128 x
// 256, 128 x 128 and 64 x 128; the nt caller picks one for the wave count
// (ssdx_torch/ops/gemm.py), the nn kernel always runs 64 x 128.  K is walked
// 128 bytes at a time (128 int8 or 64 bf16 values, four wgmma k-steps of 32
// bytes) through a ring of 4-8 stages in shared memory, 192 KB in all.  One
// thread of the loader issues the TMA copies of a stage (cp.async.bulk.tensor,
// 128-byte swizzle, the tensor maps passed as __grid_constant__ parameters)
// against the stage's "full" mbarrier; the consumers wait on it, run
// wgmma.mma_async from the swizzled tiles, keep one group of wgmmas in
// flight and hand the stage before back through its "empty" mbarrier.  With
// two consumers setmaxnreg gives them 232 registers a thread (a 64 x 256
// accumulator is 128) and the loader 40.  TMA zero-fills what lies past M,
// N or K, so the main loop has no masks.  The epilogue stages the
// accumulators in the idle ring, swizzled, and TMA stores them in boxes of
// 64 rows x 32 values, clipped at M and N.  The K order of a product and its
// tile do not depend on M, and K is never split: a row's result does not
// depend on which rows share its launch, which the repro tool's shard checks
// rely on.
//
// What bounds it here: per k-block the SM's shared memory takes the TMA
// writes of a stage and the wgmma reads of A (per warpgroup) and B (once per
// warpgroup), about 125 bytes a cycle at the int8 peak for 128 x 256 tiles,
// at its limit of 128, and more than it for narrower tiles; and a one-wave
// grid writes its whole output after its main loop, with nothing to hide it.
#include "sm90.cuh"

namespace {

using namespace sm90;

// Bytes of one operand value, and the output's type, by accumulator: int8 ->
// int32, bf16 -> float32.
template <typename Acc> struct Operand;
template <> struct Operand<int> {
  static constexpr int SIZE = 1;
  static constexpr CUtensorMapDataType OUT = CU_TENSOR_MAP_DATA_TYPE_INT32;
};
template <> struct Operand<float> {
  static constexpr int SIZE = 2;
  static constexpr CUtensorMapDataType OUT = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

__device__ __forceinline__ void store2(void* o, int x, int y) {
  *reinterpret_cast<int2*>(o) = make_int2(x, y);
}
__device__ __forceinline__ void store2(void* o, float x, float y) {
  *reinterpret_cast<float2*>(o) = make_float2(x, y);
}

// ------------------------------------------------------------------ the kernel
// Acc int (int8 operands) or float (bf16 operands); N_MAJOR_B: the second
// operand is y [K,N] (nn) rather than b_t [N,K] (nt).  Block b computes the
// tile (b / n_tiles, b % n_tiles); nk stages of 128 bytes of K.
template <typename Acc, int BM, int BN, bool N_MAJOR_B>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS, 1)
gemm_kernel(__grid_constant__ const CUtensorMap map_a, __grid_constant__ const CUtensorMap map_b,
            __grid_constant__ const CUtensorMap map_c, int nk, int n_tiles) {
  using T = Tile<BM, BN>;
  constexpr int STAGES = T::STAGES;
  constexpr int KVALS = BK / Operand<Acc>::SIZE;  // K values per stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the loader's arrive; the bytes come with the copies
      mbar_init(&empty[s], 4 * T::CONSUMERS);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {
    // ---------------------------------------------------------------- loader
    if constexpr (T::CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == T::CONSUMERS * 128) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);  // the first round passes at once
        unsigned char* sa = smem + s * T::STAGE_BYTES;
        unsigned char* sb = sa + T::A_BYTES;
        mbar_expect_tx(&full[s], T::STAGE_BYTES);  // out-of-bounds parts count, zero-filled
        tma_load_2d(sa, &map_a, &full[s], kb * KVALS, m0);
        if constexpr (N_MAJOR_B) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)  // 64 k-rows x 64 columns (128 bytes) each
            tma_load_2d(sb + j * 8192, &map_b, &full[s], n0 + 64 * j, kb * 64);
        } else {
          tma_load_2d(sb, &map_b, &full[s], kb * KVALS, n0);
        }
      }
    }
  } else {
    // ------------------------------------------------------------- consumers
    if constexpr (T::CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Acc acc[BN / 2];
    consume<Acc, BM, BN, N_MAJOR_B>(acc, smem, full, empty, nk, wg);
    const int lane = threadIdx.x & 31;

    // ------------------------------------------------------------- epilogue
    // Once every consumer is done with the ring, each warpgroup stages its
    // 64 x BN accumulators there as BN / 32 boxes of 64 rows x 128 bytes in
    // the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8):
    // the fragment's stores hit every bank), and one thread hands the boxes
    // to TMA, which writes whole lines and clips rows past M, columns past N.
    named_barrier(1, 128 * T::CONSUMERS);
    unsigned char* stage = smem + wg * 64 * BN * 4;
    const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int chunk = (j & 3) * 2 + ((lane & 3) >> 1);  // 16-byte chunk in its box's row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        store2(stage + (j >> 2) * 8192 + r * 128 + ((chunk ^ (r & 7)) << 4) + (lane & 1) * 8,
               acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
#pragma unroll
      for (int b = 0; b < BN / 32; ++b) tma_store_2d(&map_c, stage + b * 8192, n0 + 32 * b, m0 + wg * 64);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// -------------------------------------------------------------------- host side

// Launch on `stream`, which belongs to the current device `dev`; the output,
// [M,N] of 4-byte values, is written in boxes of 64 rows x 32 values.
template <typename Acc, int BM, int BN, bool N_MAJOR_B>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, void* out, int M, int N,
           int nk, int dev, void* stream) {
  CUtensorMap map_c;
  if (!make_map(&map_c, out, Operand<Acc>::OUT, 4, N, M, 32, 64)) return (int)cudaErrorInvalidValue;
  using T = Tile<BM, BN>;
  auto kernel = gemm_kernel<Acc, BM, BN, N_MAJOR_B>;
  static unsigned long long configured = 0;  // one bit per device
  cudaError_t err =
      reserve_smem((const void*)gemm_kernel<Acc, BM, BN, N_MAJOR_B>, T::SMEM, dev, configured);
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * n_tiles;
  if (err == cudaSuccess && (tiles <= 0 || tiles > 0x7fffffffLL)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) {
    kernel<<<(unsigned)tiles, T::THREADS, T::SMEM, (cudaStream_t)stream>>>(map_a, map_b, map_c,
                                                                             nk, n_tiles);
    err = cudaGetLastError();
  }
  return (int)err;
}

// The block tiles the nt caller may ask for, (BM, BN).
template <typename Acc>
int launch_tile(int bm, int bn, const CUtensorMap& map_a, const CUtensorMap& map_b, void* out,
                int M, int N, int nk, int dev, void* stream) {
  if (bm == 128 && bn == 256) return launch<Acc, 128, 256, false>(map_a, map_b, out, M, N, nk, dev, stream);
  if (bm == 128 && bn == 128) return launch<Acc, 128, 128, false>(map_a, map_b, out, M, N, nk, dev, stream);
  if (bm == 64 && bn == 128) return launch<Acc, 64, 128, false>(map_a, map_b, out, M, N, nk, dev, stream);
  return (int)cudaErrorInvalidValue;
}

// nt: a [M,K] and b_t [N,K], K-major.
template <typename Acc>
int gemm_nt(const void* a, const void* b_t, void* out, int M, int N, int K, int bm, int bn,
            int dev, void* stream) {
  constexpr int esize = Operand<Acc>::SIZE;
  const CUtensorMapDataType type =
      esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (M <= 0 || N <= 0 || N % 16 || K <= 0 || (K * esize) % 16) return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(b_t) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const OnDevice on(dev);
  if (on.err != cudaSuccess) return (int)on.err;
  const int kv = BK / esize;  // K values per stage
  CUtensorMap ma, mb;
  if (!make_map(&ma, a, type, esize, K, M, kv, bm) || !make_map(&mb, b_t, type, esize, K, N, kv, bn))
    return (int)cudaErrorInvalidValue;
  return launch_tile<Acc>(bm, bn, ma, mb, out, M, N, (K + kv - 1) / kv, dev, stream);
}

}  // namespace

// Each returns the CUDA error of the launch (0 = success).  All pointers are
// device pointers on device `dev`, 16-byte aligned.  The nt entry points take
// the block tile (bm, bn): (128, 256), (128, 128) or (64, 128); the nn one
// always runs 64 x 128.

// a [M,K] int8, b_t [N,K] int8 -> out [M,N] int32; N % 16 == 0, K % 16 == 0
extern "C" int ssdx_gemm_s8s32_nt(const void* a, const void* b_t, void* out, int M, int N, int K,
                                  int bm, int bn, int dev, void* stream) {
  return gemm_nt<int>(a, b_t, out, M, N, K, bm, bn, dev, stream);
}

// a [M,K] bf16, b_t [N,K] bf16 -> out [M,N] float32; N % 16 == 0, K % 8 == 0
extern "C" int ssdx_gemm_bf16f32_nt(const void* a, const void* b_t, void* out, int M, int N,
                                    int K, int bm, int bn, int dev, void* stream) {
  return gemm_nt<float>(a, b_t, out, M, N, K, bm, bn, dev, stream);
}

// x [M,K] bf16, y [K,N] bf16 -> out [M,N] float32; N % 8 == 0, K % 8 == 0.
// One tile whatever the shape, so a row's sums never depend on M.
extern "C" int ssdx_gemm_bf16f32_nn(const void* x, const void* y, void* out, int M, int N, int K,
                                    int dev, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(y) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const OnDevice on(dev);
  if (on.err != cudaSuccess) return (int)on.err;
  CUtensorMap mx, my;
  if (!make_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, 64, 64) ||
      !make_map(&my, y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, 64, 64))
    return (int)cudaErrorInvalidValue;
  return launch<float, 64, 128, true>(mx, my, out, M, N, (K + 63) / 64, dev, stream);
}
