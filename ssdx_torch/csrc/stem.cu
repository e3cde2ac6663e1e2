// Fused SSD300 stem for Hopper (sm_90a): conv1_1 + ReLU + conv1_2 + ReLU +
// 2x2/2 max pool, BN already folded into the conv weights.
//
// Replaces: ssdx/ops/pallas_stem.py, stem_conv_pool (TPU kernel _stem_kernel
// with the host helpers build_stem_patches and pack_stem_weights).
//
// Contract: x [B,300,300,3] bf16 NHWC; w1 [64][32] bf16 (OIHW conv1_1
// weights as [co][(dr*3 + dc)*3 + ci], columns 27..31 zero), b1 [64] f32
// (rounded to bf16); w2 [64][576] bf16 (conv1_2 as [co][(dr*3 + dc)*64 +
// ci]), b2 [64] f32.  out [B,150,150,64] bf16 = maxpool(relu(conv(y1, w2) +
// b2)) with y1 = bf16(relu(conv(x, w1) + b1)); SAME padding, y1 outside the
// image is 0.  Sums accumulate in f32; y1 is rounded to bf16 before conv1_2,
// as the TPU kernel stores it in the compute dtype; the pool is taken before
// the bias, which is exact (max is monotone and the bias uniform over the
// window).
//
// Bound: 2*B*300^2*64*(27+576) operations, 6.95 GFLOP per image (222 GFLOP
// at B = 32, 0.22 ms at the H100's 989 TFLOP/s dense bf16), against 109 MB
// of input and output at B = 32 (0.03 ms at 3.35 TB/s): compute bound.  The
// 300x300x64 intermediates (y1 and the conv1_2 output, 23 MB per image in
// bf16) never go to device memory.
//
// Design (stem_sm90.cuh has the shared conv core and conv1_1's window,
// im2col and contraction, which B3 builds too): a persistent grid of one
// block per SM, two consumer warpgroups, walks the tiles of 4 conv rows by
// 62 columns (2 x 31 pooled pixels) of every image, tile blockIdx.x,
// + gridDim.x, ...  The weights go to shared memory once per block, in the
// layout wgmma reads.  Per tile:
//   * the input windows (8 x 66 x 3, zero outside the image) are copied
//     with cp.async two tiles ahead (double-buffered), and the next tile's
//     im2col is built while the tensor cores run this tile's conv1_2;
//   * conv1_1 runs on the tensor cores: K = 27 padded to 32 (zero weights),
//     an im2col of the window's 6 x 64 y1 halo pixels built in shared
//     memory, pixels as M (3 m64n64k16 tiles of 2 k-steps per warpgroup);
//     the epilogue adds b1, applies ReLU, rounds to bf16 (zero outside the
//     image) and writes the y1 halo tile in the core's layout;
//   * conv1_2 is the core (36 wgmma m64n128k16 per warpgroup);
//   * the 2x2 pool is a max inside each thread's fragment (adjacent columns
//     and the row at +64 sit in the same thread), then + b2, ReLU, bf16;
//     the pooled row goes through shared memory so that each 31-pixel run
//     of NHWC output is written with 16-byte stores.
// An image's output is computed by one tile independently of B and of the
// block that takes it: no reduction crosses blocks.
#include "stem_sm90.cuh"

namespace {

using namespace stem90;

constexpr int kThreads = 256;
constexpr int kXRows = HR + 2;                // 8 input rows
constexpr int kXBytes = kXRows * X_LD;        // 3,200
constexpr int kImLd = HALO_PIX;               // im2col pixels between its 4 k-chunks
constexpr int kPooled = TW / 2;               // 31 pooled columns a tile
constexpr int kPStage = 32 * STAGE_LD;        // pooled staging per warpgroup

constexpr int kOffW2 = 0;
constexpr int kOffW1 = kOffW2 + W_BYTES;             // [4 chunks][64 co][16 B]
constexpr int kOffHalo = kOffW1 + 4 * 64 * 16;
constexpr int kOffIm = kOffHalo + HALO_BYTES;        // [4 chunks][384 px][16 B]
constexpr int kOffX = kOffIm + 4 * kImLd * 16;
constexpr int kOffStage = kOffX + 2 * kXBytes;
constexpr int kOffBias = kOffStage + 2 * kPStage;
constexpr int kSmem = kOffBias + 2 * C * 4 + 1024;   // + alignment
static_assert(kOffHalo % 16 == 0 && kOffIm % 16 == 0 && kOffStage % 16 == 0, "alignment");

// The input window of tile t, rows r0-2 .. r0+5 (the y1 halo's rows and
// theirs), into `xs`; the core's conv1_1 helpers do the rest.
__device__ __forceinline__ void load_window(const __nv_bfloat16* __restrict__ x, int t,
                                            unsigned char* xs) {
  const Tile T = tile_of(t);
  stem90::load_x<kXRows, kThreads>(x, T.b, T.r0 - 2, T.c0, xs);
}

template <int C0 = 0, int C1 = 4>
__device__ __forceinline__ void halo_im2col(const unsigned char* xcur, unsigned char* im) {
  stem90::build_im2col<HR, kThreads, C0, C1>(xcur, im, threadIdx.x);
}

__global__ void __launch_bounds__(kThreads, 1)
stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
            const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
            const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int B) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::align1024(smem_raw);
  unsigned char* w2s = smem + kOffW2;
  unsigned char* w1s = smem + kOffW1;
  unsigned char* halo = smem + kOffHalo;
  unsigned char* im = smem + kOffIm;
  unsigned char* xs = smem + kOffX;
  float* b1s = reinterpret_cast<float*>(smem + kOffBias);
  float* b2s = b1s + C;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* stage = smem + kOffStage + wg * kPStage;

  stage_weights(w2, w2s);
  stage_w1<kThreads>(w1, w1s);
  zero_halo_pad(halo);
  if (tid < C) {
    b1s[tid] = b1[tid];
    b2s[tid] = b2[tid];
  }
  // Prologue: tile blockIdx.x's window and im2col, the next window in flight.
  const int ntiles = B * TILES;
  if ((int)blockIdx.x < ntiles) load_window(x, blockIdx.x, xs);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  halo_im2col(xs, im);
  if ((int)(blockIdx.x + gridDim.x) < ntiles) load_window(x, blockIdx.x + gridDim.x, xs + kXBytes);
  cp_async_commit();
  sm90::fence_proxy_async();
  __syncthreads();

  float b1r[16];  // b1 of this thread's columns of conv1_1's fragment: 8j + 2q, + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b1r[2 * j] = b1s[8 * j + 2 * q];
    b1r[2 * j + 1] = b1s[8 * j + 2 * q + 1];
  }
  const uint32_t w1a = sm90::smem_u32(w1s), w2a = sm90::smem_u32(w2s);
  const uint32_t ha = sm90::smem_u32(halo), ima = sm90::smem_u32(im);
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    // The im2col of this tile is in place; the window of the next is in
    // flight in buffer (it + 1) & 1.
    const Tile T = tile_of(tile);

    // ---- conv1_1 on the tensor cores: pixels 192*wg .. +191 as M, co as N ----
    {
      float a1[3][32];
      conv1_1<3>(a1, ima, w1a, kImLd, 3 * wg);
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 32; ++j) sm90::fence_operand(a1[i][j]);

      // + b1, ReLU, bf16, zero outside the image -> y1 halo: tile (pixels p0 ..
      // p0 + 7, channels 8j .. 8j + 7) is chunk j of those pixels, stored
      // four chunks at a time with stmatrix.
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p0 = 64 * (3 * wg + i) + 16 * warp + 8 * h;
          const int p = p0 + (lane >> 2);  // this thread's pixel
          const int gr = T.r0 - 1 + (p >> 6), gc = T.c0 - 1 + (p & 63);
          const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += 4) {
            uint32_t rr[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int j = j0 + m;
              const float v0 = inside ? fmaxf(a1[i][4 * j + 2 * h] + b1r[2 * j], 0.0f) : 0.0f;
              const float v1 = inside ? fmaxf(a1[i][4 * j + 2 * h + 1] + b1r[2 * j + 1], 0.0f) : 0.0f;
              rr[m] = pack_bf16x2(v0, v1);
            }
            stmatrix_x4(halo + ((j0 + (lane >> 3)) * HALO_LD + p0 + (lane & 7)) * 16, rr);
          }
        }
    }
    sm90::fence_proxy_async();
    __syncthreads();

    // ---- conv1_2: the core ----
    // The next tile's im2col between groups of taps, while the tensor cores run.
    float acc[64];
    const int next = tile + gridDim.x;
    const unsigned char* xn = xs + ((it + 1) & 1) * kXBytes;
    conv_begin(acc);
    conv_taps<0, 3>(acc, w2a, ha, wg);
    if (next < ntiles) {
      cp_async_wait_all();
      __syncthreads();  // its window is in (every thread's copies)
      halo_im2col<0, 2>(xn, im);
    }
    conv_taps<3, 6>(acc, w2a, ha, wg);
    if (next < ntiles) {
      halo_im2col<2, 4>(xn, im);
      if (next + (int)gridDim.x < ntiles) load_window(x, next + gridDim.x, xs + (it & 1) * kXBytes);
      cp_async_commit();
      sm90::fence_proxy_async();
    }
    conv_taps<6, 9>(acc, w2a, ha, wg);
    conv_end(acc);
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) sm90::fence_operand(acc[i]);

    // ---- 2x2 max of the raw sums, + b2, ReLU, bf16 -> staging -> NHWC ----
    const int co0 = 16 * warp + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pc = 4 * j + q;
      const float v0 = fmaxf(fmaxf(acc[4 * j], acc[4 * j + 1]), fmaxf(acc[4 * j + 32], acc[4 * j + 33]));
      const float v1 = fmaxf(fmaxf(acc[4 * j + 2], acc[4 * j + 3]), fmaxf(acc[4 * j + 34], acc[4 * j + 35]));
      __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(stage + pc * STAGE_LD);
      row[co0] = __float2bfloat16(fmaxf(v0 + b2s[co0], 0.0f));
      row[co0 + 8] = __float2bfloat16(fmaxf(v1 + b2s[co0 + 8], 0.0f));
    }
    sm90::named_barrier(1 + wg, 128);
    const int P = T.r0 / 2 + wg, Q0 = T.c0 / 2;
    __nv_bfloat16* orow = out + (((size_t)T.b * (H / 2) + P) * (W / 2)) * C;
    for (int v = t; v < kPooled * 8; v += 128) {
      const int pc = v >> 3, c = v & 7;
      if (Q0 + pc < W / 2)
        *reinterpret_cast<int4*>(orow + (size_t)(Q0 + pc) * C + c * 8) =
            *reinterpret_cast<const int4*>(stage + pc * STAGE_LD + c * 16);
    }
    __syncthreads();  // the next im2col is written; this tile's wgmmas and stores are done
  }
  cp_async_wait_all();
}

}  // namespace

// Launch the stem on `stream` over `grid` persistent blocks; returns
// cudaGetLastError() after the launch.
extern "C" int ssdx_stem_forward(const void* x, const void* w1, const float* b1, const void* w2,
                                 const float* b2, void* out, int B, int grid,
                                 cudaStream_t stream) {
  if (B <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmem);
  if (e != cudaSuccess) return (int)e;
  stem_kernel<<<grid, kThreads, kSmem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const __nv_bfloat16*>(w1), b1,
      reinterpret_cast<const __nv_bfloat16*>(w2), b2, reinterpret_cast<__nv_bfloat16*>(out), B);
  return (int)cudaGetLastError();
}
