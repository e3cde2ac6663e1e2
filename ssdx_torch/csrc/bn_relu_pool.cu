// Train-mode BatchNorm + ReLU on NHWC for Hopper (sm_90a), forward and
// backward, in four passes: with the 2x2/2 max pool folded in (B6, POOL =
// true), or without it (B6's pool-free twin, POOL = false).
//
// Replaces: ssdx/ops/fused_bn_pool.py, bn_relu_pool (the Pallas bodies
// _fwd_stats_kernel, _fwd_apply_kernel, _bwd_reduce_kernel, _bwd_dx_kernel).
// The pool-free twin replaces no TPU kernel: the JAX model leaves the train
// step's other BN + ReLU layers to XLA, which fuses them; in PyTorch they
// were ~10 ops and their autograd a layer, most of a train step's device time.
//
//   stats    x -> per-band partial rows [sum | sum of squares] in float32
//   apply    y = relu(x*a + b) in float32; with the pool, p = max over the
//            window, rounded once at the store (the full-size y never reaches
//            device memory); without it, y rounded once, every pixel
//   reduce   recompute y; with the pool, route the pooled cotangent g to the
//            positions equal to the window's maximum where that maximum is
//            > 0 (ReLU's subgradient at 0 is 0), tied maxima splitting g
//            evenly (or each taking all of it, tie_split = 0); without it,
//            mask the cotangent dy by y > 0; per-band partial rows
//            [s1 = sum dy | sum dy*(x - mu)] of the routed or masked dy
//   dx       the same routing or mask, then dx = gi*dy + (x - mu)*A + B0 with
//            A = gvar*2/n - gi*inv*s2/n and B0 = gmean/n - gi*s1/n, which is
//            the BN backward plus the cotangents of the mean and var outputs
// Between the passes two small kernels add the partial rows in a fixed order
// and do the per-channel arithmetic in float32:
//   stats_finalize   sums -> mean, var = max(E[x^2] - mean^2, 0),
//                    inv = rsqrt(var + eps), a = gamma*inv, b = beta - mean*a
//   reduce_finalize  sums -> s1 (= dbeta), s2 = inv * sum dy*(x - mu)
//                    (= dgamma), A, B0
// so a forward is three launches and a backward three, with no PyTorch op
// between them.  The backward takes a, b, inv and mean as the forward stored
// them (a [4,C] float32 row block), never recomputed.
//
// Routing: the backward must pick the positions the forward's maximum came
// from (or where the ReLU passed).  The TPU version stores two mask planes
// for that, because XLA may contract x*a + b differently in two programs.
// Here all passes call one device function, bn_relu(), written with
// __fmul_rn and __fadd_rn, so no pass can contract it into an FMA and y has
// the same bits everywhere: the backward recomputes the routing from x,
// which it has to read anyway for xhat, with the forward's own a and b, and
// no mask or index is stored.
//
// Shapes: any B, H, W >= 1, C % 8 == 0 and C <= 2048, bfloat16 or float32.
// With the pool: floor mode (H/2 x W/2 windows; an odd last row or column is
// in the statistics and takes the BN part of dx but no routed gradient) or
// ceil mode ((H+1)/2 x (W+1)/2 windows, positions past the edge count as
// -inf).  None of the TPU layout carries over (the pair-packed [M,2,W/2,2C]
// view, the 2C % 128 and W/2 >= 8 conditions, the 8-row padded partials, the
// mask planes).
//
// Bound: bytes.  With the pool, each input and output counted once (x, p; x,
// g, dx), forward + backward move 3.5 x |x|: 645.1 MB at [16,300,300,64]
// bf16, 0.193 ms at 3.35 TB/s.  Each BN barrier forces a second read of x
// (stats then apply, reduce then dx), so these four passes move 5.75 x |x| =
// 1,059.8 MB, 0.316 ms.  Without the pool, 5 x |x| once each (x, y; x, dy,
// dx) and 8 x |x| with the second reads: at the train step's 18 BN layers
// outside the stem (220,125,184 values a step at bs=16, bf16) 2.20 GB, 0.657
// ms, and 3.52 GB, 1.051 ms.  The design below streams every pass at the
// bandwidth, keeps nothing but x, y, dy and dx of map size in device
// memory, and stores each output once, rounded once.
//
// Design: the four passes are one persistent kernel, pipe_kernel<T, MODE,
// POOL>, two blocks an SM, that streams x (and g or dy) through shared
// memory.  With the pool, a band is the input rows 2P and 2P+1 of one image
// (a pooled row); a tile is a run of tw = 2 * slots columns of a band with
// all C channels, so its two rows hold at most kRowElems elements each (8 KB
// in bfloat16), plus the slots pooled columns of g the tile's windows take
// (reduce, dx).  Without the pool the map is one flat run of N = B*H*W
// pixels (BN does not care where a row ends): a tile is tw = 2 * slots
// pixels of it, in the stage's first row, with dy's tw pixels in its second
// (reduce, dx), and a band is nq consecutive tiles.  One producer thread
// issues a tile as up to three 1-D bulk copies on the stage's "full"
// mbarrier, into a ring of kRingBytes (4 stages in bfloat16, 2 in float32),
// and waits on the stage's "empty" mbarrier before it refills it; so the
// bytes in flight per SM are set by the ring, not by the consumers'
// registers (kernels that held a window in registers reached 37 % of the
// bound in the backward, at 128 registers with spills).  256 consumer
// threads read the tiles from shared memory: thread (slot, cg) takes window
// `slot` of every tile (without the pool: pixels 2*slot and 2*slot + 1) and
// channels 8*cg .. 8*cg + 7, in two halves of 4, with its sums in registers
// and the pass's per-channel vectors (a, b, mu, A, B0) in shared memory, so
// that no pass spills at 2 blocks an SM.  dx (and the pool-free y) is
// written over the tile's x in the stage, and the producer copies the rows
// out with bulk stores before it refills the stage: whole rows of C
// channels leave in one copy each, where the threads' own stores would
// write 8 bytes apart.  Blocks walk bands blockIdx.x, blockIdx.x +
// gridDim.x, ... and each band's tiles in order; stats and reduce write one
// partial row per band (each thread's sums over the band's tiles, then the
// slots added in order through shared memory), so the sums have one fixed
// order whatever the grid, and two runs give the same bits.  The finalize
// kernels add the band rows in a fixed tree.  The tile geometry (slots, tw,
// tiles per band, bands) comes from the wrapper (ops/bn_relu_pool.py,
// tiles() and flat_tiles()), which the CPU tests model.
#include "sm90.cuh"

#include <math_constants.h>

namespace {

using sm90::bulk_load;
using sm90::bulk_store;
using sm90::fence_proxy_async;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_barrier;

enum Mode { STATS = 0, APPLY = 1, REDUCE = 2, DX = 3 };

constexpr int kConsumers = 256;                 // 8 consumer warps
constexpr int kBlock = kConsumers + 32;         // and one producer warp
constexpr int kRowElems = 4096;                 // one input row of a tile: tw * C
// A stage: rows 2P, 2P + 1, then g (with the pool); x's pixels, then dy's (without).
constexpr int kStageElems = 2 * kRowElems + kRowElems / 2;
constexpr int kRingBytes = 81920;
constexpr int kRedStride = 17;                  // floats per consumer in the band sums
constexpr int kSmem = 128 + kRingBytes + kConsumers * kRedStride * 4;  // + the vectors
constexpr int kMaxC = 2048;

// Rows of per-channel vectors (C floats each) that a pass keeps in shared
// memory: a, b (apply); and mu (reduce); and A, B0 (dx).
#define SSDX_VEC_ROWS(MODE) ((MODE) == STATS ? 0 : (MODE) == APPLY ? 2 : (MODE) == REDUCE ? 3 : 5)

template <typename T>
constexpr int kStages = kRingBytes / (kStageElems * (int)sizeof(T));  // 4 bf16, 2 f32

// The shape and the tile geometry of one launch.  With the pool, bands: per
// image (Hc for stats and dx, Hp for apply and reduce); nbands = B * bands.
// Without it the map is one row of W = N pixels (B = H = 1, Hp = Wp = 0) and
// bands = nbands runs of nq tiles.
struct Geom {
  int B, H, W, C, Hp, Wp, G, slots, tw, nq, bands, nbands, tie_split;
};

// Four channels of one pixel as loaded (8 bytes in bfloat16, 16 in float32),
// each converted to float32 where it is used.  A thread takes its 8 channels
// in two halves of 4, so a window's pixels, its routed outputs and the
// channels' vectors stay within 96 registers without spills.
template <typename T>
struct Px;

template <>
struct Px<__nv_bfloat16> {
  uint2 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float operator[](int k) const {  // k is a constant once unrolled
    const uint32_t w = k < 2 ? u.x : u.y;
    return __uint_as_float(k & 1 ? (w & 0xffff0000u) : (w << 16));
  }
  // Round f to channel k (each even channel before its odd neighbour).
  __device__ __forceinline__ void set(int k, float f) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(f));
    uint32_t& w = k < 2 ? u.x : u.y;
    w = k & 1 ? (w & 0xffffu) | (h << 16) : h;
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint2*>(p) = u;
  }
};

template <>
struct Px<float> {
  float4 u;
  __device__ __forceinline__ void load(const float* p) { u = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float operator[](int k) const {
    return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  }
  __device__ __forceinline__ void set(int k, float f) {
    (k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w) = f;
  }
  __device__ __forceinline__ void store(float* p) const { *reinterpret_cast<float4*>(p) = u; }
};

// The normalized activation, rounded operation by operation: the one
// definition every pass uses (see "Routing" above).
__device__ __forceinline__ float bn_relu(float x, float a, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(x, a), b), 0.0f);
}

// g / cnt for the tie split, cnt in 0..4: exact by a power-of-two product
// except for cnt = 3, which divides (the plain version divides by
// max(cnt, 1)).
__device__ __forceinline__ float share_of(float g, int cnt, int tie_split) {
  if (!tie_split || cnt <= 1) return g;
  return cnt == 3 ? __fdiv_rn(g, 3.0f) : g * (cnt == 2 ? 0.5f : 0.25f);
}

// ------------------------------------------------------------ the pipeline
//
// vec rows: 0 a, 1 b, 2 inv, 3 mu; fin rows: 0 s1, 1 s2, 2 A, 3 B0.  g: the
// pooled cotangent (POOL) or dy (reduce, dx).  out: p or y (apply) or dx
// (dx); part: the band rows [nbands][2][C] (stats, reduce).

template <typename T, int MODE, bool POOL>
__global__ void __launch_bounds__(kBlock, 2)
pipe_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ vec,
            const float* __restrict__ fin, T* __restrict__ out, float* __restrict__ part,
            const Geom o) {
  constexpr int S = kStages<T>;
  // Passes whose output leaves by the producer's bulk stores, from the stage.
  constexpr bool kStores = MODE == DX || (!POOL && MODE == APPLY);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  T* ring = reinterpret_cast<T*>(smem + 128);
  float* red = reinterpret_cast<float*>(smem + 128 + kRingBytes);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive; the bytes come with the copies
      mbar_init(&empty[s], kConsumers / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------------------ producer
    if (tid != kConsumers) return;
    // A tile's place: image b, band P (input rows 2P, 2P + 1), columns c0 ..
    // c0 + ncol, pooled columns Q0 .. Q0 + slots, by its index in the walk.
    // Without the pool: pixels c0 .. c0 + ncol of the flat map (ncol = 0 for
    // the empty tiles past its end in the last band).
    auto where = [&](int j, int& b, int& P, int& c0, int& Q0, uint32_t& row_bytes) {
      const int band = blockIdx.x + (j / o.nq) * gridDim.x, q = j % o.nq;
      if (POOL) {
        b = band / o.bands;
        P = band - b * o.bands;
        c0 = q * o.tw;
        Q0 = q * o.slots;
      } else {
        b = P = Q0 = 0;
        c0 = (band * o.nq + q) * o.tw;
      }
      row_bytes = (uint32_t)(max(min(o.tw, o.W - c0), 0) * o.C * (int)sizeof(T));
    };
    // dx (and the pool-free y): the consumers wrote tile j's rows over its x
    // in stage j % S; copy them out, and wait until the copy has read them
    // before the stage is filled again.
    auto store_tile = [&](int j) {
      int b, P, c0, Q0;
      uint32_t row_bytes;
      where(j, b, P, c0, Q0, row_bytes);
      const T* st = ring + (j % S) * kStageElems;
      T* dst = out + (((size_t)b * o.H + 2 * P) * o.W + c0) * o.C;
      if (row_bytes) bulk_store(dst, st, row_bytes);
      if (POOL && 2 * P + 1 < o.H)
        bulk_store(dst + (size_t)o.W * o.C, st + kRowElems, row_bytes);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    };
    const int nb = (o.nbands - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int ntiles = nb * o.nq;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % S;
      if (it >= S) {
        mbar_wait(&empty[s], (it / S - 1) & 1);
        if (kStores) store_tile(it - S);
      }
      int b, P, c0, Q0;
      uint32_t row_bytes;
      where(it, b, P, c0, Q0, row_bytes);
      const int r = 2 * P;
      const bool two_rows = POOL && r + 1 < o.H;
      T* st = ring + s * kStageElems;
      uint32_t g_bytes = 0;  // g's pooled columns, or dy's pixels (second row of the stage)
      if (POOL && (MODE == REDUCE || MODE == DX) && P < o.Hp && Q0 < o.Wp)
        g_bytes = (uint32_t)(min(o.slots, o.Wp - Q0) * o.C * (int)sizeof(T));
      if (!POOL && (MODE == REDUCE || MODE == DX)) g_bytes = row_bytes;
      mbar_expect_tx(&full[s], row_bytes * (two_rows ? 2 : 1) + g_bytes);
      const T* xr = x + (((size_t)b * o.H + r) * o.W + c0) * o.C;
      if (row_bytes) bulk_load(st, xr, row_bytes, &full[s]);
      if (two_rows) bulk_load(st + kRowElems, xr + (size_t)o.W * o.C, row_bytes, &full[s]);
      if (g_bytes && POOL)
        bulk_load(st + 2 * kRowElems, g + (((size_t)b * o.Hp + P) * o.Wp + Q0) * o.C, g_bytes,
                  &full[s]);
      if (g_bytes && !POOL) bulk_load(st + kRowElems, g + (size_t)c0 * o.C, g_bytes, &full[s]);
    }
    if (kStores) {
      for (int j = max(ntiles - S, 0); j < ntiles; ++j) {
        mbar_wait(&empty[j % S], (j / S) & 1);
        store_tile(j);
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  // The per-channel vectors this pass needs, rows of `vs` in shared memory:
  // 0 a, 1 b (apply, reduce, dx), 2 mu (reduce, dx), 3 A, 4 B0 (dx).
  const int C = o.C, cg = tid % o.G, slot = tid / o.G;
  const bool active = slot < o.slots;
  float* vs = red + kConsumers * kRedStride;
  for (int i = tid; i < SSDX_VEC_ROWS(MODE) * C; i += kConsumers) {
    const int row = i / C, ch = i - row * C;
    vs[i] = row < 2 ? vec[i] : row == 2 ? vec[3 * C + ch] : fin[(row - 1) * C + ch];
  }
  named_barrier(1, kConsumers);
  int it = 0;
  for (int band = blockIdx.x; band < o.nbands; band += gridDim.x) {
    const int b = band / o.bands, P = band - b * o.bands;
    float s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.0f;
    for (int q = 0; q < o.nq; ++q, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      T* st = ring + s * kStageElems;
      const int Q = q * o.slots + slot, col = 2 * Q;
      // Without the pool: the thread's two pixels p0, p0 + 1 of the flat map
      // (local 2*slot, 2*slot + 1 in the stage's first row, dy in its second).
      const int p0 = (band * o.nq + q) * o.tw + 2 * slot;
      if (!POOL && active && p0 < o.W) {
        const bool in[2] = {true, p0 + 1 < o.W};
        T* px = st + 2 * slot * C + cg * 8;
#pragma unroll
        for (int h = 0; h < 8; h += 4) {  // channels cg*8 + h .. + 3
          Px<T> v[2], d[2], r[2];  // r: y or dx of the two pixels, packed as x is
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (in[i]) {
              v[i].load(px + i * C + h);
              if (MODE == REDUCE || MODE == DX) d[i].load(px + kRowElems + i * C + h);
            }
          const int ch = cg * 8 + h;
          if (MODE == STATS) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (in[i])
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  s1[h + k] += v[i][k];
                  s2[h + k] = fmaf(v[i][k], v[i][k], s2[h + k]);
                }
            continue;
          }
          const float4 va = *reinterpret_cast<const float4*>(vs + ch);
          const float4 vc = *reinterpret_cast<const float4*>(vs + C + ch);
          const float4 vm = MODE == APPLY ? va : *reinterpret_cast<const float4*>(vs + 2 * C + ch);
          const float a4[4] = {va.x, va.y, va.z, va.w}, c4[4] = {vc.x, vc.y, vc.z, vc.w};
          const float mu4[4] = {vm.x, vm.y, vm.z, vm.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float y = bn_relu(v[i][k], a4[k], c4[k]);
              if (MODE == APPLY) {
                r[i].set(k, y);
                continue;
              }
              const float dm = in[i] && y > 0.0f ? d[i][k] : 0.0f;  // dy where the ReLU passed
              if (MODE == REDUCE) {
                // s1 = sum dy, s2 = sum dy * (x - mu); reduce_finalize scales s2 by inv
                if (in[i]) {
                  s1[h + k] += dm;
                  s2[h + k] = fmaf(dm, v[i][k] - mu4[k], s2[h + k]);
                }
              } else {
                const float A = vs[3 * C + ch + k], B0 = vs[4 * C + ch + k];
                r[i].set(k, fmaf(a4[k], dm, fmaf(v[i][k] - mu4[k], A, B0)));
              }
            }
          if (MODE != REDUCE)  // over the x it was computed from; the producer copies it out
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (in[i]) r[i].store(px + i * C + h);
        }
      } else if (POOL && active && col < o.W) {
        // the window's four positions: rows 2P, 2P + 1 by columns col, col + 1
        bool in[4];
        T* px[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          in[i] = 2 * P + (i >> 1) < o.H && col + (i & 1) < o.W;
          px[i] = st + (i >> 1) * kRowElems + (2 * slot + (i & 1)) * C + cg * 8;
        }
        const bool pooled = P < o.Hp && Q < o.Wp;
#pragma unroll
        for (int h = 0; h < 8; h += 4) {  // channels cg*8 + h .. + 3
          Px<T> v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (in[i]) v[i].load(px[i] + h);
          const int ch = cg * 8 + h;
          float4 va = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vc = va;
          if (MODE != STATS) {
            va = *reinterpret_cast<const float4*>(vs + ch);
            vc = *reinterpret_cast<const float4*>(vs + C + ch);
          }
          const float a4[4] = {va.x, va.y, va.z, va.w}, c4[4] = {vc.x, vc.y, vc.z, vc.w};
          if (MODE == STATS) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (in[i])
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  s1[h + k] += v[i][k];
                  s2[h + k] = fmaf(v[i][k], v[i][k], s2[h + k]);
                }
          } else if (MODE == APPLY) {
            if (Q < o.Wp) {  // floor mode's odd last column is pooled by no window
              Px<T> m;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                float mk = -CUDART_INF_F;
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  if (in[i]) mk = fmaxf(mk, bn_relu(v[i][k], a4[k], c4[k]));
                m.set(k, mk);
              }
              m.store(out + (((size_t)b * o.Hp + P) * o.Wp + Q) * C + ch);
            }
          } else {
            // Route the pooled cotangent, channel by channel: position i takes
            // `share` where its y equals the window's maximum pm > 0 (0 where
            // the window was not pooled or pm is 0).
            const float4 vm = *reinterpret_cast<const float4*>(vs + 2 * C + ch);
            const float mu4[4] = {vm.x, vm.y, vm.z, vm.w};
            Px<T> gg, r[4];  // r: dx of the four positions, packed as x is
            if (pooled) gg.load(st + 2 * kRowElems + slot * C + ch);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float y[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                y[i] = in[i] ? bn_relu(v[i][k], a4[k], c4[k]) : -CUDART_INF_F;
              const float pm = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
              int cnt = 0;
              float t = 0.0f;  // sum of (x - mu) over the hit positions
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (y[i] == pm) {
                  ++cnt;
                  if (MODE == REDUCE) t += v[i][k] - mu4[k];
                }
              const float share =
                  pooled && pm > 0.0f ? share_of(gg[k], cnt, o.tie_split) : 0.0f;
              if (MODE == REDUCE) {
                // s1 = sum dy, s2 = sum dy * (x - mu); reduce_finalize scales s2 by inv
                s1[h + k] = fmaf(share, (float)cnt, s1[h + k]);
                s2[h + k] = fmaf(share, t, s2[h + k]);
              } else {
                const float A = vs[3 * C + ch + k], B0 = vs[4 * C + ch + k];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float d = y[i] == pm ? share : 0.0f;
                  r[i].set(k, fmaf(a4[k], d, fmaf(v[i][k] - mu4[k], A, B0)));
                }
              }
            }
            if (MODE == DX)  // over the x it was computed from; the producer copies it out
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (in[i]) r[i].store(px[i] + h);
          }
        }
      }
      if (kStores) fence_proxy_async();  // the output in the stage, before the bulk copy reads it
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[s]);
    }
    if (MODE == STATS || MODE == REDUCE) {
      // the band's partial row: every thread's sums, the slots added in order
      float* mine = red + tid * kRedStride;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        mine[k] = s1[k];
        mine[8 + k] = s2[k];
      }
      named_barrier(1, kConsumers);
      for (int oc = tid; oc < 2 * C; oc += kConsumers) {
        const int which = oc / C, ch = oc - which * C, gi = ch >> 3, k = ch & 7;
        float acc = 0.0f;
        for (int j = 0; j < o.slots; ++j) acc += red[(j * o.G + gi) * kRedStride + which * 8 + k];
        part[(size_t)band * 2 * C + oc] = acc;
      }
      named_barrier(1, kConsumers);
    }
  }
}

// ------------------------------------- fixed-order sums and the channel math
//
// One block of 1,024 threads per kFinChannels channels, both columns of each
// (sum and sum of squares, or s1 and s2): row group g of kFinGroups adds the
// partial rows g, g + kFinGroups, ... in order (four loads in flight), then
// the group sums are added pairwise in a fixed tree, and the first
// kFinChannels threads do the arithmetic.  The order depends on n alone.

constexpr int kFinChannels = 4;
constexpr int kFinGroups = 1024 / (2 * kFinChannels);  // 128

__device__ __forceinline__ void column_sums(const float* __restrict__ part, int n, int C,
                                            float (*red)[2 * kFinChannels + 1], int& ch,
                                            float& t0, float& t1) {
  const int j = threadIdx.x % (2 * kFinChannels), grp = threadIdx.x / (2 * kFinChannels);
  ch = blockIdx.x * kFinChannels + j % kFinChannels;
  const int col = (j / kFinChannels) * C + ch;
  float s = 0.0f;
  if (ch < C)
    for (int i = grp; i < n; i += 4 * kFinGroups) {
      float u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = i + kFinGroups * k;
        u[k] = row < n ? part[(size_t)row * 2 * C + col] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) s += u[k];
    }
  red[grp][j] = s;
  __syncthreads();
  for (int stride = kFinGroups / 2; stride > 0; stride >>= 1) {
    if (grp < stride) red[grp][j] += red[grp + stride][j];
    __syncthreads();
  }
  t0 = red[0][j % kFinChannels];
  t1 = red[0][kFinChannels + j % kFinChannels];
}

// part [n][2][C] -> mean, var [C] and vec rows 0 a, 1 b, 2 inv, 3 mu.
__global__ void __launch_bounds__(1024)
stats_finalize_kernel(const float* __restrict__ part, int n, int C, float count, float eps,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      float* __restrict__ mean, float* __restrict__ var,
                      float* __restrict__ vec) {
  __shared__ float red[kFinGroups][2 * kFinChannels + 1];
  int col;
  float sum, sq;
  column_sums(part, n, C, red, col, sum, sq);
  if (threadIdx.x < kFinChannels && col < C) {
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

// part [n][2][C] (sums of dy and of dy * (x - mu)) -> fin rows 0 s1, 1 s2 =
// inv * sum dy * (x - mu), 2 A = gvar*2/n - a*inv*s2/n, 3 B0 = gmean/n -
// a*s1/n  (a = gamma*inv).
__global__ void __launch_bounds__(1024)
reduce_finalize_kernel(const float* __restrict__ part, int n, int C, float count,
                       const float* __restrict__ vec, const float* __restrict__ gmean,
                       const float* __restrict__ gvar, float* __restrict__ fin) {
  __shared__ float red[kFinGroups][2 * kFinChannels + 1];
  int col;
  float s1, t;
  column_sums(part, n, C, red, col, s1, t);
  if (threadIdx.x < kFinChannels && col < C) {
    const float a = vec[col], inv = vec[2 * C + col];
    const float s2 = t * inv;
    fin[col] = s1;
    fin[C + col] = s2;
    fin[2 * C + col] = gvar[col] * (2.0f / count) - a * inv * (s2 / count);
    fin[3 * C + col] = gmean[col] / count - a * (s1 / count);
  }
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// dtype: 0 = bfloat16, 1 = float32.  The pipeline entries take the shape
// and tile geometry of ops/bn_relu_pool.py's tiles() (ssdx_brp_*, with the
// pool) or flat_tiles() (ssdx_bnr_*, without it) and `grid` blocks.

template <typename T, int MODE, bool POOL>
static int launch_pipe(const void* x, const void* g, const float* vec, const float* fin,
                       void* out, float* part, const Geom& o, int grid, cudaStream_t stream) {
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = sm90::reserve_smem((const void*)pipe_kernel<T, MODE, POOL>,
                           kSmem + SSDX_VEC_ROWS(MODE) * kMaxC * 4, dev, configured);
  if (e != cudaSuccess) return (int)e;
  pipe_kernel<T, MODE, POOL><<<grid, kBlock, kSmem + SSDX_VEC_ROWS(MODE) * o.C * 4, stream>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(g), vec, fin,
      reinterpret_cast<T*>(out), part, o);
  return (int)cudaGetLastError();
}

template <int MODE, bool POOL = true>
static int dispatch(const void* x, const void* g, const float* vec, const float* fin, void* out,
                    float* part, const int* geo, int tie_split, int dtype, int grid,
                    cudaStream_t stream) {
  const Geom o{geo[0], geo[1], geo[2], geo[3], geo[4],  geo[5],   geo[6],
               geo[7], geo[8], geo[9], geo[10], geo[11], tie_split};
  return dtype == 0
             ? launch_pipe<__nv_bfloat16, MODE, POOL>(x, g, vec, fin, out, part, o, grid, stream)
             : launch_pipe<float, MODE, POOL>(x, g, vec, fin, out, part, o, grid, stream);
}

// geo: B, H, W, C, Hp, Wp, G, slots, tw, nq, bands, nbands (12 ints, host memory).

extern "C" int ssdx_brp_stats(const void* x, float* part, const int* geo, int dtype, int grid,
                              cudaStream_t stream) {
  return dispatch<STATS>(x, nullptr, nullptr, nullptr, nullptr, part, geo, 0, dtype, grid,
                         stream);
}

extern "C" int ssdx_brp_apply(const void* x, const float* vec, void* p, const int* geo,
                              int dtype, int grid, cudaStream_t stream) {
  return dispatch<APPLY>(x, nullptr, vec, nullptr, p, nullptr, geo, 0, dtype, grid, stream);
}

extern "C" int ssdx_brp_reduce(const void* x, const void* g, const float* vec, float* part,
                               const int* geo, int tie_split, int dtype, int grid,
                               cudaStream_t stream) {
  return dispatch<REDUCE>(x, g, vec, nullptr, nullptr, part, geo, tie_split, dtype, grid,
                          stream);
}

extern "C" int ssdx_brp_dx(const void* x, const void* g, const float* vec, const float* fin,
                           void* dx, const int* geo, int tie_split, int dtype, int grid,
                           cudaStream_t stream) {
  return dispatch<DX>(x, g, vec, fin, dx, nullptr, geo, tie_split, dtype, grid, stream);
}

// The pool-free twin: y and dy have x's shape.

extern "C" int ssdx_bnr_stats(const void* x, float* part, const int* geo, int dtype, int grid,
                              cudaStream_t stream) {
  return dispatch<STATS, false>(x, nullptr, nullptr, nullptr, nullptr, part, geo, 0, dtype, grid,
                                stream);
}

extern "C" int ssdx_bnr_apply(const void* x, const float* vec, void* y, const int* geo,
                              int dtype, int grid, cudaStream_t stream) {
  return dispatch<APPLY, false>(x, nullptr, vec, nullptr, y, nullptr, geo, 0, dtype, grid,
                                stream);
}

extern "C" int ssdx_bnr_reduce(const void* x, const void* dy, const float* vec, float* part,
                               const int* geo, int dtype, int grid, cudaStream_t stream) {
  return dispatch<REDUCE, false>(x, dy, vec, nullptr, nullptr, part, geo, 0, dtype, grid,
                                 stream);
}

extern "C" int ssdx_bnr_dx(const void* x, const void* dy, const float* vec, const float* fin,
                           void* dx, const int* geo, int dtype, int grid, cudaStream_t stream) {
  return dispatch<DX, false>(x, dy, vec, fin, dx, nullptr, geo, 0, dtype, grid, stream);
}

// n = the partial rows that stats or reduce wrote; count = B*H*W.

extern "C" int ssdx_brp_stats_finalize(const float* part, int n, int C, float count, float eps,
                                       const float* gamma, const float* beta, float* mean,
                                       float* var, float* vec, cudaStream_t stream) {
  const int grid = (C + kFinChannels - 1) / kFinChannels;
  stats_finalize_kernel<<<grid, 1024, 0, stream>>>(part, n, C, count, eps, gamma, beta, mean, var,
                                                   vec);
  return (int)cudaGetLastError();
}

extern "C" int ssdx_brp_reduce_finalize(const float* part, int n, int C, float count,
                                        const float* vec, const float* gmean, const float* gvar,
                                        float* fin, cudaStream_t stream) {
  const int grid = (C + kFinChannels - 1) / kFinChannels;
  reduce_finalize_kernel<<<grid, 1024, 0, stream>>>(part, n, C, count, vec, gmean, gvar, fin);
  return (int)cudaGetLastError();
}
