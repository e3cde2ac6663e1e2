// Int8 convolutions of the quantized SSD300 serving path, for Hopper (sm_90a).
//
// Replaces: ssdx/ops/pallas_int8_conv.py, int8_conv (the TPU kernels
// _conv3_kernel and _mm_kernel).  The bare matmuls of the int8 probe
// (scripts/bench_int8_mxu.py, _pallas_mm), which were this kernel with a raw
// store, moved to csrc/gemm_sm90.cu: a TMA + wgmma main loop that a later
// version of these convolutions can reuse behind an implicit-GEMM loader.
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
// and the epilogue below repeats its float32 operations one by one
// (__fmul_rn / __fadd_rn, and the file is built with -fmad=false).
//
// Design: one implicit GEMM, M = B*Ho*Wo output pixels by N = Cout by
// K = kh*kw*Cin, templated on the filter size (3x3 with any stride,
// dilation and padding; 1x1 = a plain matmul) and on the epilogue.  What
// the TPU kernel did for its own hardware does not come across: no padded
// flat image, no lane-concatenated taps, no dense stride-1 output cropped
// on the host.  A block of 8 warps computes a 128x128 output tile; K is
// walked in 64-byte slices through a 4-stage cp.async ring in shared
// memory.  A 16-byte segment of K lies inside one filter tap (Cin is a
// multiple of 16), so the loader turns each segment into one predicated
// 16-byte copy: padding, the ragged last tile of M and the tail of K are
// zero-filled by the copy's source size, never read.  Shared rows are
// padded from 64 to 80 bytes so that ldmatrix is conflict free.  Each warp
// owns 64x32 of the tile and runs mma.sync.m16n8k32 (s8 x s8 -> s32).
// The weight rows of a warp's 32 channels are permuted on their way into
// shared memory so that a thread's accumulators are 8 neighbouring
// channels of one pixel: the epilogue stores 8 int8 (8 bytes) or 8 bf16
// (16 bytes) at once, straight from registers.
//
// Bound: 2*M*N*K operations over the card's dense int8 rate (1,979 TOP/s;
// mma.sync reaches a part of what wgmma does) against the input, weights
// and outputs moved once at 3.35 TB/s.  The 3x3 layers of 256 channels and
// more are bound by operations, the 64- and 128-channel layers on the
// 150x150 map and the 1x1 layers are close to the bytes.  Two blocks of 8
// warps per SM hide the latency of the copies and of ldmatrix; a 128x256
// tile with 64x64 warps (half the shared-memory reads per mma, but one block
// per SM) measured slower on every layer of the network.  wgmma, TMA,
// split-K for the small late layers and a persistent grid are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;    // output pixels per block
constexpr int BN = 128;    // output channels per block
constexpr int BK = 64;     // bytes of K per pipeline stage
constexpr int LDS = BK + 16;  // shared row stride in bytes
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 81,920: two blocks per SM

struct Geom {
  int H, W, Cin, Cout, Ho, Wo, stride, dil, pad;
  int M;  // B*Ho*Wo
  int K;  // bytes of one weight row: kh*kw*Cin
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// 16 x 8 x 32 bytes of K: s8 x s8 -> s32
__device__ __forceinline__ void mma_tile(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One thread's 8 neighbouring channels of one pixel: dequantize, bias,
// ReLU, then requantize and/or emit the tap.
__device__ __forceinline__ void conv_epilogue(const int (&v)[8], const float (&ws)[8],
                                              const float (&bs)[8], const float (&inv)[8],
                                              int8_t* out_q, void* out_tap, int tap_kind,
                                              size_t off) {
  float y[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    y[c] = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(v[c]), ws[c]), bs[c]), 0.0f);
  }
  if (out_q != nullptr) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float q = fminf(fmaxf(rintf(__fmul_rn(y[c], inv[c])), -127.0f), 127.0f);
      w[c >> 2] |= ((uint32_t)(__float2int_rn(q)) & 0xffu) << (8 * (c & 3));
    }
    *reinterpret_cast<uint2*>(out_q + off) = make_uint2(w[0], w[1]);
  }
  if (tap_kind == 1) {
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out_tap) + off;
    *reinterpret_cast<uint4*>(o) = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                                              pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
  } else if (tap_kind == 2) {
    float* o = reinterpret_cast<float*>(out_tap) + off;
    *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(y[4], y[5], y[6], y[7]);
  }
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 2)
igemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ w_scale, const float* __restrict__ bias,
             const float* __restrict__ inv_ns, int8_t* __restrict__ out_q,
             void* __restrict__ out_tap, int tap_kind, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int n_tiles = (g.Cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;

  // ---- loader: this thread copies segment `seg` of rows lrow and lrow+64
  const int seg = tid & 3, lrow = tid >> 2;
  const int8_t* a_base[2];
  int a_iy0[2], a_ix0[2];
  bool a_ok[2], b_ok[2];
  const int8_t* b_base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + lrow + 64 * h;
    a_ok[h] = m < g.M;
    const int mm = a_ok[h] ? m : 0;
    if (KS == 1) {
      a_base[h] = x + (size_t)mm * g.Cin;
      a_iy0[h] = a_ix0[h] = 0;
    } else {
      const int hw = g.Ho * g.Wo;
      const int b = mm / hw, r = mm - b * hw;
      const int oy = r / g.Wo, ox = r - oy * g.Wo;
      a_base[h] = x + (size_t)b * g.H * g.W * g.Cin;
      a_iy0[h] = oy * g.stride - g.pad;
      a_ix0[h] = ox * g.stride - g.pad;
    }
    // shared row r holds channel perm(r): within each group of 32 rows,
    // row j*8 + q (n-tile j, column q) holds channel (q/2)*8 + j*2 + q%2
    const int r = lrow + 64 * h, j = (r >> 3) & 3, q = r & 7;
    const int n = n0 + (r & ~31) + (q >> 1) * 8 + j * 2 + (q & 1);
    b_ok[h] = n < g.Cout;
    b_base[h] = w + (size_t)(b_ok[h] ? n : 0) * g.K;
  }

  auto load_stage = [&](int stage, int kc) {
    unsigned char* sA = smem + stage * STAGE_BYTES;
    unsigned char* sB = sA + BM * LDS;
    const int k = kc * BK + seg * 16;
    const bool kin = k < g.K;
    int dy = 0, dx = 0, ci = k;
    if (KS == 3) {
      const int tap = k / g.Cin;
      ci = k - tap * g.Cin;
      const int ky = tap / 3;
      dy = ky * g.dil;
      dx = (tap - ky * 3) * g.dil;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = lrow + 64 * h;
      bool p = kin && a_ok[h];
      const int8_t* src = x;
      if (KS == 1) {
        if (p) src = a_base[h] + k;
      } else {
        const int iy = a_iy0[h] + dy, ix = a_ix0[h] + dx;
        p = p && (unsigned)iy < (unsigned)g.H && (unsigned)ix < (unsigned)g.W;
        if (p) src = a_base[h] + ((size_t)iy * g.W + ix) * g.Cin + ci;
      }
      cp_async16(sA + row * LDS + seg * 16, src, p ? 16 : 0);
      const bool pb = kin && b_ok[h];
      cp_async16(sB + row * LDS + seg * 16, pb ? b_base[h] + k : w, pb ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int nk = (g.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k32: A rows x 32 bytes of K, B stored [n][k])
  const int a_row = wm * 64 + (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 16;

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kc has landed; everyone is done with stage kc-1
    const int next = kc + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next);
    cp_async_commit();

    const unsigned char* sA = smem + (kc % STAGES) * STAGE_BYTES;
    const unsigned char* sB = sA + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], sA + (a_row + i * 16) * LDS + ks * 32 + a_k);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldmatrix_x4(b[jp], sB + (b_row + jp * 16) * LDS + ks * 32 + b_k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tile(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: thread (q, t) of a warp holds, for rows q and q+8 of each
  // 16-row tile, channels t*8 .. t*8+7 of the warp's 32 (acc[i][j][2h+e] is
  // channel t*8 + j*2 + e)
  const int q = lane >> 2, t = lane & 3;
  const int n = n0 + wn * 32 + t * 8;
  if (n >= g.Cout) return;  // Cout is a multiple of 8: all 8 channels or none
  float ws[8], bs[8], inv[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    ws[c] = w_scale[n + c];
    bs[c] = bias[n + c];
    inv[c] = out_q != nullptr ? inv_ns[n + c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + q + h * 8;
      if (m >= g.M) continue;
      const size_t off = (size_t)m * g.Cout + n;
      int v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j * 2] = acc[i][j][h * 2];
        v[j * 2 + 1] = acc[i][j][h * 2 + 1];
      }
      conv_epilogue(v, ws, bs, inv, out_q, out_tap, tap_kind, off);
    }
  }
}

template <int KS>
int launch(const void* x, const void* w, const void* w_scale, const void* bias,
           const void* inv_ns, void* out_q, void* out_tap, int tap_kind, const Geom& g,
           void* stream) {
  auto kernel = igemm_kernel<KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((g.M + BM - 1) / BM) * ((g.Cout + BN - 1) / BN);
  if (tiles <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)w_scale, (const float*)bias,
      (const float*)inv_ns, (int8_t*)out_q, out_tap, tap_kind, g);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_conv(const void* x, const void* w, const void* w_scale, const void* bias,
                const void* inv_ns, void* out_q, void* out_tap, int B, int H, int W, int Cin,
                int Cout, int Ho, int Wo, int stride, int dil, int pad, int tap_kind,
                void* stream) {
  const long long M = (long long)B * Ho * Wo;
  if (M <= 0 || M > 0x7fffffffLL || Cin % 16 || Cout % 16) return (int)cudaErrorInvalidValue;
  if (out_q == nullptr && tap_kind == 0) return (int)cudaErrorInvalidValue;
  const Geom g{H, W, Cin, Cout, Ho, Wo, stride, dil, pad, (int)M, KS * KS * Cin};
  return launch<KS>(x, w, w_scale, bias, inv_ns, out_q, out_tap, tap_kind, g, stream);
}

}  // namespace

// Each returns the CUDA error of the launch (0 = success).  All pointers are
// device pointers; out_q or out_tap may be null (tap_kind 0 = no tap, 1 =
// bf16, 2 = f32).

extern "C" int ssdx_int8_conv3(const void* x, const void* w, const void* w_scale,
                               const void* bias, const void* inv_ns, void* out_q,
                               void* out_tap, int B, int H, int W, int Cin, int Cout, int Ho,
                               int Wo, int stride, int dil, int pad, int tap_kind,
                               void* stream) {
  return launch_conv<3>(x, w, w_scale, bias, inv_ns, out_q, out_tap, B, H, W, Cin, Cout, Ho,
                        Wo, stride, dil, pad, tap_kind, stream);
}

// 1x1 conv: [B*H*W, Cin] @ [Cout, Cin]^T with the same epilogue.
extern "C" int ssdx_int8_mm(const void* x, const void* w, const void* w_scale,
                            const void* bias, const void* inv_ns, void* out_q, void* out_tap,
                            int B, int H, int W, int Cin, int Cout, int Ho, int Wo, int stride,
                            int dil, int pad, int tap_kind, void* stream) {
  if (stride != 1 || pad != 0 || Ho != H || Wo != W) return (int)cudaErrorInvalidValue;
  return launch_conv<1>(x, w, w_scale, bias, inv_ns, out_q, out_tap, B, H, W, Cin, Cout, Ho,
                        Wo, stride, dil, pad, tap_kind, stream);
}
