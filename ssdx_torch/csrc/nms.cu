// Greedy DIoU-NMS keep mask over score-sorted candidates, for Hopper (sm_90a).
//
// Replaces: ssdx/ops/pallas_nms.py, nms_core_sorted (the TPU kernels
// _nms_kernel, K <= 512, and _nms_tiled_kernel, K > 512).
//
// Contract: boxes [B,K,4] float32 xyxy, already sorted by score (descending)
// and offset by class; valid [B,K] bool.  keep[b,j] is true iff valid[b,j]
// and no KEPT earlier box i < j has DIoU(i, j) > thresh: exact greedy NMS,
// the same mask as the TPU fixpoint and as the plain version
// (ssdx_torch/ops/nms.py, nms_core_sorted_ref).
//
// Exactness: the mask must equal the plain version's bit for bit, and a
// DIoU that lands on the threshold decides it (the class offset of 4096
// leaves float32 coordinates about 5e-4 of precision).  So diou() below is
// the exact operation sequence of ssdx_torch/boxes.py pairwise_diou, each
// step rounded on its own, and this file is compiled with -fmad=false so
// that nvcc contracts no multiply-add into an FMA.  Division is IEEE
// (no fast-math), as in PyTorch's elementwise kernels.
//
// Design: the TPU's whole-matrix fixpoint and tile-sequential forms suit a
// core that runs its grid in order; here two kernels run back to back on
// one stream.
//   1. nms_sup_kernel, one block of 64 threads per (64-row block,
//      64-column block, image): bit j of sup[b][i][j/64] is set when
//      i < j, valid[i] and DIoU(i, j) > thresh.  Blocks below the diagonal
//      write zeros.  The bitmask (K*ceil(K/64)*8 bytes per image, 320 KB at
//      K = 1600) is scratch the wrapper allocates.
//   2. nms_scan_kernel, one warp per image: walks i in score order with a
//      running "removed" bitmask spread over the lanes (one 64-bit word per
//      lane per 2048 candidates); a kept row ORs its sup row into it.  Only
//      kept rows are read.
// One kernel serves every K up to kMaxWordsPerLane * 32 * 64 = 8192.
//
// Bound: the DIoU of the K*(K-1)/2 ordered pairs, about 31 float32
// operations each, over the card's float32 rate, against reading boxes and
// valid and writing keep once: a few microseconds at the serving shape
// (B = 32, K = 400), so launch latency and the serial scan set the pace.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;           // candidates per bitmask word / block
constexpr int kMaxWordsPerLane = 4;  // K <= 4 * 32 * 64 = 8192

__device__ __forceinline__ float diou(const float* a, const float* b) {
  // iou = inter / max(union, eps)
  const float ltx = fmaxf(a[0], b[0]);
  const float lty = fmaxf(a[1], b[1]);
  const float rbx = fminf(a[2], b[2]);
  const float rby = fminf(a[3], b[3]);
  const float iw = fmaxf(rbx - ltx, 0.0f);
  const float ih = fmaxf(rby - lty, 0.0f);
  const float inter = iw * ih;
  const float area_a = fmaxf(a[2] - a[0], 0.0f) * fmaxf(a[3] - a[1], 0.0f);
  const float area_b = fmaxf(b[2] - b[0], 0.0f) * fmaxf(b[3] - b[1], 0.0f);
  const float uni = (area_a + area_b) - inter;
  const float eps = (float)1e-7;  // the double 1e-7 rounded to float, as in PyTorch
  const float iou = inter / fmaxf(uni, eps);
  // enclosing box diagonal
  const float ex = fmaxf(a[2], b[2]) - fminf(a[0], b[0]);
  const float ey = fmaxf(a[3], b[3]) - fminf(a[1], b[1]);
  const float diag2 = ex * ex + ey * ey;
  // centre distance
  const float dx = 0.5f * (a[0] + a[2]) - 0.5f * (b[0] + b[2]);
  const float dy = 0.5f * (a[1] + a[3]) - 0.5f * (b[1] + b[3]);
  const float d2 = dx * dx + dy * dy;
  return iou - d2 / fmaxf(diag2, eps);
}

__global__ void __launch_bounds__(kCols)
nms_sup_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
               int K, int W, float thresh, unsigned long long* __restrict__ sup) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int i = rb * kCols + t;
  const float* bx = boxes + (size_t)b * K * 4;
  __shared__ float cols[kCols * 4];
  const int ncols = min(kCols, K - cb * kCols);
  if (t < ncols) {
    const float4 v = reinterpret_cast<const float4*>(bx)[cb * kCols + t];
    cols[t * 4 + 0] = v.x;
    cols[t * 4 + 1] = v.y;
    cols[t * 4 + 2] = v.z;
    cols[t * 4 + 3] = v.w;
  }
  __syncthreads();
  if (i >= K) return;
  unsigned long long bits = 0ULL;
  if (cb >= rb && valid[(size_t)b * K + i]) {
    const float4 v = reinterpret_cast<const float4*>(bx)[i];
    const float a[4] = {v.x, v.y, v.z, v.w};
    for (int j = (cb == rb) ? t + 1 : 0; j < ncols; ++j) {
      if (diou(a, &cols[j * 4]) > thresh) bits |= 1ULL << j;
    }
  }
  sup[((size_t)b * K + i) * W + cb] = bits;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ sup,
                const uint8_t* __restrict__ valid, int K, int W,
                uint8_t* __restrict__ keep) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const unsigned long long* S = sup + (size_t)b * K * W;
  const uint8_t* V = valid + (size_t)b * K;
  uint8_t* out = keep + (size_t)b * K;
  unsigned long long removed[kMaxWordsPerLane];
#pragma unroll
  for (int s = 0; s < kMaxWordsPerLane; ++s) removed[s] = 0ULL;

  for (int i = 0; i < K; ++i) {
    const int w = i >> 6;
    // word w lives in lane (w % 32), slot (w / 32); pick it without
    // indexing the register array dynamically
    unsigned long long mine = 0ULL;
#pragma unroll
    for (int s = 0; s < kMaxWordsPerLane; ++s)
      if (s == (w >> 5)) mine = removed[s];
    const unsigned long long word = __shfl_sync(0xffffffffu, mine, w & 31);
    const bool kept = V[i] && !((word >> (i & 63)) & 1ULL);  // warp-uniform
    if (lane == 0) out[i] = kept;
    if (kept) {
#pragma unroll
      for (int s = 0; s < kMaxWordsPerLane; ++s) {
        const int ww = s * 32 + lane;
        if (ww < W) removed[s] |= S[(size_t)i * W + ww];
      }
    }
  }
}

}  // namespace

extern "C" int ssdx_nms_max_k() { return kMaxWordsPerLane * 32 * kCols; }

// boxes [B,K,4] f32, valid [B,K] u8, sup scratch [B,K,ceil(K/64)] u64,
// keep [B,K] u8 out.  Returns cudaGetLastError() after the launches.
extern "C" int ssdx_nms_keep(const float* boxes, const uint8_t* valid, int B, int K,
                             float thresh, unsigned long long* sup, uint8_t* keep,
                             cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > ssdx_nms_max_k()) return (int)cudaErrorInvalidValue;
  const int W = (K + kCols - 1) / kCols;
  nms_sup_kernel<<<dim3(W, W, B), kCols, 0, stream>>>(boxes, valid, K, W, thresh, sup);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_scan_kernel<<<B, 32, 0, stream>>>(sup, valid, K, W, keep);
  return (int)cudaGetLastError();
}
