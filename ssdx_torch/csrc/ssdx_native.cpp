// Host-side kernels of the port (C ABI, loaded with ctypes): plain C++, no
// CUDA.  The port's own copy of the JAX package's
// ssdx/ops/native/ssdx_native.cpp, with the same entry points.
//
// The metric and NMS hot paths on the host are loops that numpy cannot
// vectorise:
//
//   * ssdx_match_detections: greedy COCO-style detection<->GT matching for
//     one (image, class) group: detections in score-descending order each
//     claim the highest-IoU unmatched GT with IoU >= thresh.  This is the
//     O(n_det * n_gt) inner loop of mAP accumulation
//     (ssdx_torch/eval/map.py);
//   * ssdx_match_detections_ignore: the same with pycocotools' ignore
//     semantics for the area ranges;
//   * ssdx_nms_diou: exact greedy DIoU-NMS on the host, an oracle for tests.
//
// Build: g++ -O3 -march=native -shared -fPIC, by ssdx_torch/ops/_build.py at
// first use.  Plain C ABI, no Python.h: marshalling is ctypes + numpy.

#include <cstdint>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

inline float box_area(const float* b) {
  const float w = b[2] - b[0];
  const float h = b[3] - b[1];
  return (w > 0.f ? w : 0.f) * (h > 0.f ? h : 0.f);
}

inline float iou(const float* a, const float* b) {
  const float ix1 = std::max(a[0], b[0]);
  const float iy1 = std::max(a[1], b[1]);
  const float ix2 = std::min(a[2], b[2]);
  const float iy2 = std::min(a[3], b[3]);
  const float iw = ix2 - ix1;
  const float ih = iy2 - iy1;
  const float inter = (iw > 0.f ? iw : 0.f) * (ih > 0.f ? ih : 0.f);
  const float uni = box_area(a) + box_area(b) - inter;
  return inter / (uni > 1e-9f ? uni : 1e-9f);
}

inline float diou(const float* a, const float* b) {
  const float ex1 = std::min(a[0], b[0]);
  const float ey1 = std::min(a[1], b[1]);
  const float ex2 = std::max(a[2], b[2]);
  const float ey2 = std::max(a[3], b[3]);
  const float dw = ex2 - ex1;
  const float dh = ey2 - ey1;
  const float diag2 = dw * dw + dh * dh;
  const float cax = 0.5f * (a[0] + a[2]);
  const float cay = 0.5f * (a[1] + a[3]);
  const float cbx = 0.5f * (b[0] + b[2]);
  const float cby = 0.5f * (b[1] + b[3]);
  const float d2 = (cax - cbx) * (cax - cbx) + (cay - cby) * (cay - cby);
  return iou(a, b) - d2 / (diag2 > 1e-9f ? diag2 : 1e-9f);
}

}  // namespace

extern "C" {

// Greedy COCO matching for one (image, class) group.
// det_boxes: [n_det, 4] xyxy, already sorted by score descending.
// gt_boxes:  [n_gt, 4] xyxy.
// tp_out:    [n_det] -> 1 if matched (true positive), else 0.
void ssdx_match_detections(const float* det_boxes, int32_t n_det,
                           const float* gt_boxes, int32_t n_gt,
                           float iou_thresh, uint8_t* tp_out) {
  std::vector<uint8_t> taken(static_cast<size_t>(n_gt > 0 ? n_gt : 0), 0);
  for (int32_t d = 0; d < n_det; ++d) {
    float best = -1.f;
    int32_t best_g = -1;
    const float* db = det_boxes + 4 * d;
    for (int32_t g = 0; g < n_gt; ++g) {
      if (taken[g]) continue;
      const float v = iou(db, gt_boxes + 4 * g);
      if (v > best) {
        best = v;
        best_g = g;
      }
    }
    if (best_g >= 0 && best >= iou_thresh) {
      taken[best_g] = 1;
      tp_out[d] = 1;
    } else {
      tp_out[d] = 0;
    }
  }
}

// Ignore-aware greedy COCO matching (pycocotools evaluateImg semantics) for
// one (image, class, area-range) group — the kernel behind the mAP area
// splits (ssdx_torch/eval/map.py::_match_with_ignore is the numpy oracle).
// det_boxes: [n_det, 4] xyxy, score-descending order.
// gt_boxes:  [n_gt, 4] xyxy, PRE-SORTED so non-ignored GTs come first.
// gt_ig:     [n_gt] 1 = ignored GT (out of the area range).
// tp_out:    [n_det] 1 = matched a non-ignored GT (true positive).
// mig_out:   [n_det] 1 = matched an ignored GT (dropped from the PR rows).
// Matching rules (identical to pycocotools): a detection takes the
// highest-IoU unmatched GT with IoU >= thresh, later GT wins ties; once a
// non-ignored GT is held, it is never traded for an ignored one.
void ssdx_match_detections_ignore(const float* det_boxes, int32_t n_det,
                                  const float* gt_boxes, int32_t n_gt,
                                  const uint8_t* gt_ig, float iou_thresh,
                                  uint8_t* tp_out, uint8_t* mig_out) {
  std::vector<uint8_t> taken(static_cast<size_t>(n_gt > 0 ? n_gt : 0), 0);
  const float thresh =
      iou_thresh < 1.f - 1e-10f ? iou_thresh : 1.f - 1e-10f;
  for (int32_t d = 0; d < n_det; ++d) {
    tp_out[d] = 0;
    mig_out[d] = 0;
    const float* db = det_boxes + 4 * d;
    float best = thresh;
    int32_t m = -1;
    for (int32_t g = 0; g < n_gt; ++g) {
      if (taken[g]) continue;
      if (m > -1 && !gt_ig[m] && gt_ig[g]) break;
      const float v = iou(db, gt_boxes + 4 * g);
      if (v < best) continue;
      best = v;
      m = g;
    }
    if (m > -1) {
      taken[m] = 1;
      if (gt_ig[m]) mig_out[d] = 1; else tp_out[d] = 1;
    }
  }
}

// Exact greedy DIoU-NMS.  boxes [n,4] xyxy, scores [n].
// keep_out [n] receives kept indices (original index space, score-desc
// order); returns the number kept.
int32_t ssdx_nms_diou(const float* boxes, const float* scores, int32_t n,
                      float thresh, int32_t* keep_out) {
  std::vector<int32_t> order(static_cast<size_t>(n > 0 ? n : 0));
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return scores[a] > scores[b]; });
  std::vector<uint8_t> dead(static_cast<size_t>(n > 0 ? n : 0), 0);
  int32_t n_keep = 0;
  for (size_t oi = 0; oi < order.size(); ++oi) {
    const int32_t i = order[oi];
    if (dead[i]) continue;
    keep_out[n_keep++] = i;
    const float* bi = boxes + 4 * i;
    for (size_t oj = oi + 1; oj < order.size(); ++oj) {
      const int32_t j = order[oj];
      if (dead[j]) continue;
      if (diou(bi, boxes + 4 * j) > thresh) dead[j] = 1;
    }
  }
  return n_keep;
}

}  // extern "C"
