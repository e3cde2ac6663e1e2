// Greedy (D)IoU-NMS keep mask over score-sorted candidates, for Hopper (sm_90a).
//
// Replaces: ssdx/ops/pallas_nms.py, nms_core_sorted (the TPU kernels
// _nms_kernel, K <= 512, and _nms_tiled_kernel, K > 512).
//
// Contract: boxes [B,K,4] float32 xyxy, already sorted by score
// (descending); valid [B,K] bool; labels [B,K] int32 or null.  With the
// overlap O(i, j) = DIoU(i, j), or IoU(i, j) when the caller asks for IoU,
// keep[b,j] is true iff valid[b,j] and no KEPT earlier box i < j of the same
// label (any label, when labels is null) has O(i, j) > thresh: exact greedy
// per-class NMS on the boxes as they are, the same mask as the plain
// version (ssdx_torch/ops/nms.py, nms_core_sorted_ref) and, for DIoU, as the
// TPU fixpoint.
//
// Exactness: the mask must equal the plain version's bit for bit, and an
// overlap that lands on the threshold decides it.  So iou() and diou() below
// are the exact operation sequences of ssdx_torch/boxes.py pairwise_iou and
// pairwise_diou, each step rounded on its own (a box's area and centre are
// computed once, by the same operations), and this file is compiled with
// -fmad=false so that nvcc contracts no multiply-add into an FMA.  Division
// is IEEE (no fast-math), as in PyTorch's elementwise kernels.  Classes are
// kept apart by comparing labels, not by translating boxes, so the
// coordinates keep their float32 precision whatever the number of classes.
//
// Design: two kernels back to back on one stream; candidates go in chunks
// of 64, one 64-bit word per chunk.
//   1. nms_sup_kernel<kIoU>, one block of 64 threads per (row chunk rb,
//      column chunk cb >= rb, image): only the W(W+1)/2 blocks of the upper
//      triangle are launched, and nothing below it is written.  Bit j of
//      sup[b][i][cb] is set when i < j, valid[i], label[i] == label[j] and
//      O(i, j) > thresh.  Exact early-out: where the intersection is exactly
//      0, iou is 0 and DIoU = -d2 / max(diag2, eps) <= 0 (or NaN), so for
//      thresh >= 0 the bit is clear without either division.  A thread first
//      tests the 64 columns for the same label and a non-zero intersection
//      (a few operations each) and then runs the full overlap only on those,
//      so cross-class pairs and distant boxes cost no division; for a
//      negative thresh every same-label column takes the full path.  The
//      bitmask ([B][64W][W] words, 320 KB an image at K = 1600) is scratch
//      the wrapper allocates; rows past K and words below the diagonal are
//      never written nor used.
//   2. nms_scan_kernel, one block of 128 threads per image, in chunks of 64
//      candidates.  The sup rows of a chunk (64 x W words, contiguous) come
//      into shared memory by one bulk copy on an mbarrier, two chunks ahead
//      of use (double-buffered).  One thread resolves the chunk's 64
//      decisions from the diagonal words in a serial chain of bit
//      operations on registers; then every thread ORs the kept rows' words
//      of one later chunk into the running "removed" mask in shared memory.
//      The chain per image is K/64 staged chunks instead of K dependent
//      loads from L2.  Chunks past the last valid candidate are not read:
//      their keep bytes are written 0.
// One kernel serves every K up to kMaxWords * 64 = 8192 (128 KB of buffers).
//
// Bound: the overlap of the same-label pairs (i valid, j > i), about 31
// float32 operations each for DIoU and 14 for IoU, and a label compare for
// every pair, over the card's float32 rate, against reading boxes, labels
// and valid and writing keep once: a few microseconds at the serving shapes
// (B = 32, K = 400 or 1600), so launch latency and the serial scan set the
// pace.
#include "sm90.cuh"

namespace {

using sm90::bulk_load;
using sm90::fence_proxy_async;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;

constexpr int kCols = 64;          // candidates per bitmask word / chunk
constexpr int kMaxWords = 128;     // K <= 128 * 64 = 8192
constexpr int kScanThreads = 128;  // one later word per thread in the OR step

// A box and what diou() needs of it alone: area and centre, each by the
// operations pairwise_diou uses.
struct Cand {
  float x0, y0, x1, y1, area, cx, cy;
};

__device__ __forceinline__ Cand cand_of(float4 v) {
  Cand c;
  c.x0 = v.x; c.y0 = v.y; c.x1 = v.z; c.y1 = v.w;
  c.area = fmaxf(v.z - v.x, 0.0f) * fmaxf(v.w - v.y, 0.0f);
  c.cx = 0.5f * (v.x + v.z);
  c.cy = 0.5f * (v.y + v.w);
  return c;
}

__device__ __forceinline__ float inter_of(const Cand& a, const Cand& b) {
  const float ltx = fmaxf(a.x0, b.x0);
  const float lty = fmaxf(a.y0, b.y0);
  const float rbx = fminf(a.x1, b.x1);
  const float rby = fminf(a.y1, b.y1);
  const float iw = fmaxf(rbx - ltx, 0.0f);
  const float ih = fmaxf(rby - lty, 0.0f);
  return iw * ih;
}

constexpr float kEps = (float)1e-7;  // the double 1e-7 rounded to float, as in PyTorch

__device__ __forceinline__ float iou(const Cand& a, const Cand& b) {
  // inter / max(union, eps)
  const float inter = inter_of(a, b);
  const float uni = (a.area + b.area) - inter;
  return inter / fmaxf(uni, kEps);
}

__device__ __forceinline__ float diou(const Cand& a, const Cand& b) {
  const float eps = kEps;
  const float v = iou(a, b);
  // enclosing box diagonal
  const float ex = fmaxf(a.x1, b.x1) - fminf(a.x0, b.x0);
  const float ey = fmaxf(a.y1, b.y1) - fminf(a.y0, b.y0);
  const float diag2 = ex * ex + ey * ey;
  // centre distance
  const float dx = a.cx - b.cx;
  const float dy = a.cy - b.cy;
  const float d2 = dx * dx + dy * dy;
  return v - d2 / fmaxf(diag2, eps);
}

// blockIdx.x enumerates the upper triangle column by column: column chunk cb
// holds row chunks 0..cb, at offsets cb(cb+1)/2 ...
template <bool kIoU>
__global__ void __launch_bounds__(kCols)
nms_sup_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
               const int* __restrict__ labels, int K, int W, float thresh,
               unsigned long long* __restrict__ sup) {
  const int t = threadIdx.x, b = blockIdx.y, tri = blockIdx.x;
  int cb = (int)((sqrtf(8.0f * (float)tri + 1.0f) - 1.0f) * 0.5f);
  while (cb * (cb + 1) / 2 > tri) --cb;
  while ((cb + 1) * (cb + 2) / 2 <= tri) ++cb;
  const int rb = tri - cb * (cb + 1) / 2;
  const float4* bx = reinterpret_cast<const float4*>(boxes + (size_t)b * K * 4);
  const int* lab = labels ? labels + (size_t)b * K : nullptr;
  __shared__ Cand cols[kCols];
  __shared__ int col_label[kCols];
  const int ncols = min(kCols, K - cb * kCols);
  if (t < ncols) {
    cols[t] = cand_of(bx[cb * kCols + t]);
    col_label[t] = lab ? lab[cb * kCols + t] : 0;
  }
  __syncthreads();
  const int i = rb * kCols + t;
  if (i >= K || !valid[(size_t)b * K + i]) return;  // such rows are never read
  const Cand a = cand_of(bx[i]);
  const int a_label = lab ? lab[i] : 0;
  const int first = cb == rb ? t + 1 : 0;
  unsigned long long todo = 0ULL;  // columns that need the full overlap
  if (thresh >= 0.0f) {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j >= first && j < ncols && col_label[j] == a_label && inter_of(a, cols[j]) != 0.0f)
        todo |= 1ULL << j;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j >= first && j < ncols && col_label[j] == a_label) todo |= 1ULL << j;
  }
  unsigned long long bits = 0ULL;
  while (todo) {
    const int j = __ffsll((long long)todo) - 1;
    todo &= todo - 1ULL;
    if ((kIoU ? iou(a, cols[j]) : diou(a, cols[j])) > thresh) bits |= 1ULL << j;
  }
  sup[((size_t)b * W * kCols + i) * W + cb] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const unsigned long long* __restrict__ sup, const uint8_t* __restrict__ valid,
                int K, int W, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned long long buf[];  // [2][64 * W]
  __shared__ unsigned long long removed[kMaxWords], vmask[kMaxWords], kept_sh;
  __shared__ __align__(8) uint64_t full[2];
  __shared__ int last;  // the last chunk that holds a valid candidate, or -1
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long* S = sup + (size_t)b * W * kCols * W;
  const uint8_t* V = valid + (size_t)b * K;
  uint8_t* out = keep + (size_t)b * K;
  const uint32_t chunk_bytes = kCols * W * 8;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    last = -1;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = warp; w < W; w += kScanThreads / 32) {
    const int j = w * kCols + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, j < K && V[j]);
    const unsigned hi = __ballot_sync(0xffffffffu, j + 32 < K && V[j + 32]);
    if (lane == 0) {
      vmask[w] = (unsigned long long)lo | ((unsigned long long)hi << 32);
      removed[w] = 0ULL;
    }
  }
  __syncthreads();
  if (tid < W && vmask[tid]) atomicMax(&last, tid);
  __syncthreads();
  const int nchunks = last + 1;
  if (tid == 0)
    for (int c = 0; c < 2 && c < nchunks; ++c) {
      mbar_expect_tx(&full[c], chunk_bytes);
      bulk_load(buf + c * kCols * W, S + (size_t)c * kCols * W, chunk_bytes, &full[c]);
    }

  for (int c = 0; c < nchunks; ++c) {
    const unsigned long long* rows = buf + (c & 1) * kCols * W;
    mbar_wait(&full[c & 1], (c >> 1) & 1);
    if (tid == 0) {
      // the 64 decisions of the chunk, in order, from its diagonal words
      unsigned long long rem = removed[c] | ~vmask[c], kept = 0ULL;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const unsigned long long d = rows[i * W + c];
        if (!((rem >> i) & 1ULL)) {
          kept |= 1ULL << i;
          rem |= d;
        }
      }
      kept_sh = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_sh;
    if (tid < kCols && c * kCols + tid < K) out[c * kCols + tid] = (kept >> tid) & 1ULL;
    // the kept rows' later words into the removed mask, one word a thread
    for (int w = c + 1 + tid; w < W; w += kScanThreads) {
      unsigned long long acc = 0ULL;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if ((kept >> i) & 1ULL) acc |= rows[i * W + w];
      removed[w] |= acc;
    }
    __syncthreads();  // buffer c & 1 is read; removed[c + 1] is final
    if (tid == 0 && c + 2 < nchunks) {
      fence_proxy_async();
      mbar_expect_tx(&full[c & 1], chunk_bytes);
      bulk_load(buf + (c & 1) * kCols * W, S + (size_t)(c + 2) * kCols * W, chunk_bytes,
                &full[c & 1]);
    }
  }
  for (int j = nchunks * kCols + tid; j < K; j += kScanThreads) out[j] = 0;
}

}  // namespace

extern "C" int ssdx_nms_max_k() { return kMaxWords * kCols; }

// Words of the sup scratch an image needs: [64W][W] with W = ceil(K/64).
extern "C" long long ssdx_nms_scratch_words(int K) {
  const long long W = (K + kCols - 1) / kCols;
  return W * kCols * W;
}

// boxes [B,K,4] f32 (16-byte aligned), valid [B,K] u8, labels [B,K] i32 or
// null (class-agnostic), iou: 1 for IoU, 0 for DIoU; sup scratch of
// B * ssdx_nms_scratch_words(K) u64, keep [B,K] u8 out.  Returns
// cudaGetLastError() after the launches.
extern "C" int ssdx_nms_keep(const float* boxes, const uint8_t* valid, const int* labels, int B,
                             int K, float thresh, int iou, unsigned long long* sup,
                             uint8_t* keep, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > ssdx_nms_max_k()) return (int)cudaErrorInvalidValue;
  const int W = (K + kCols - 1) / kCols;
  const int smem = 2 * kCols * W * 8;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static unsigned long long configured = 0;
  e = sm90::reserve_smem((const void*)nms_scan_kernel, 2 * kCols * kMaxWords * 8, dev,
                         configured);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(W * (W + 1) / 2, B);
  if (iou)
    nms_sup_kernel<true><<<grid, kCols, 0, stream>>>(boxes, valid, labels, K, W, thresh, sup);
  else
    nms_sup_kernel<false><<<grid, kCols, 0, stream>>>(boxes, valid, labels, K, W, thresh, sup);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_scan_kernel<<<B, kScanThreads, smem, stream>>>(sup, valid, K, W, keep);
  return (int)cudaGetLastError();
}
