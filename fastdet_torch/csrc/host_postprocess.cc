// Anchor decode + class-aware greedy NMS from deploy-mode output maps:
// the host half of HybridPipeline (fastdet_torch/native.py builds this file
// with the host compiler at first use and loads it with ctypes).
//
// Matches the on-device postprocess semantics (fastdet_torch/ops/
// {decode,nms}.py): box decode xy=(v*2-0.5+cell)*stride,
// wh=(v*2)^2*anchor (sigmoid already baked into the deploy maps),
// obj-gated best-class confidence with a double threshold, greedy
// suppression in score order within each class.  OpenMP over images.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

typedef struct {
  float x1, y1, x2, y2; /* pixels in model-input coordinates */
  float score;          /* obj * best-class probability */
  int cls;
} FDBox;

/* s16 / s32: NHWC float maps (B, h, w, 4*anchor_num + anchor_num +
 * classes) with sigmoid (reg, obj) and softmax (cls) applied.  anchors:
 * 2 scales * anchor_num * 2 floats, pixel units, stride-16 scale first.
 * out holds B*max_det FDBox; counts B ints.  Returns 0 on success. */
int fd_postprocess(const float* s16, const float* s32, int batch,
                   int h16, int w16, int h32, int w32, int anchor_num,
                   int classes, const float* anchors, int input_w,
                   int input_h, float conf_thres, float iou_thres,
                   int max_det, FDBox* out, int* counts);
int fd_version(void);

}  // extern "C"

namespace {

struct Cand {
  float x1, y1, x2, y2, score;
  int cls;
};

inline float iou(const Cand& a, const Cand& b) {
  const float ix1 = std::max(a.x1, b.x1);
  const float iy1 = std::max(a.y1, b.y1);
  const float ix2 = std::min(a.x2, b.x2);
  const float iy2 = std::min(a.y2, b.y2);
  const float iw = std::max(0.f, ix2 - ix1);
  const float ih = std::max(0.f, iy2 - iy1);
  const float inter = iw * ih;
  const float area_a = (a.x2 - a.x1) * (a.y2 - a.y1);
  const float area_b = (b.x2 - b.x1) * (b.y2 - b.y1);
  return inter / (area_a + area_b - inter + 1e-9f);
}

void decode_scale(const float* map, int h, int w, int anchor_num,
                  int classes, const float* anchors, float stride,
                  float conf_thres, std::vector<Cand>* cands) {
  const int ch = 4 * anchor_num + anchor_num + classes;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const float* cell = map + (y * w + x) * ch;
      const float* cls_p = cell + 5 * anchor_num;  // softmax probs, shared
      for (int a = 0; a < anchor_num; ++a) {
        const float obj = cell[4 * anchor_num + a];
        if (obj <= conf_thres) continue;
        // best class for this anchor: argmax(cls * obj)
        int best = 0;
        float best_p = cls_p[0];
        for (int c = 1; c < classes; ++c) {
          if (cls_p[c] > best_p) { best_p = cls_p[c]; best = c; }
        }
        const float score = best_p * obj;
        if (score <= conf_thres) continue;
        const float* r = cell + 4 * a;
        const float cx = (r[0] * 2.f - 0.5f + x) * stride;
        const float cy = (r[1] * 2.f - 0.5f + y) * stride;
        const float bw = (r[2] * 2.f) * (r[2] * 2.f) * anchors[a * 2];
        const float bh = (r[3] * 2.f) * (r[3] * 2.f) * anchors[a * 2 + 1];
        cands->push_back({cx - bw / 2.f, cy - bh / 2.f, cx + bw / 2.f,
                          cy + bh / 2.f, score, best});
      }
    }
  }
}

}  // namespace

extern "C" int fd_postprocess(const float* s16, const float* s32, int batch,
                              int h16, int w16, int h32, int w32,
                              int anchor_num, int classes,
                              const float* anchors, int input_w,
                              int input_h, float conf_thres, float iou_thres,
                              int max_det, FDBox* out, int* counts) {
  (void)input_w;
  const int ch = 4 * anchor_num + anchor_num + classes;
  const long n16 = (long)h16 * w16 * ch;
  const long n32 = (long)h32 * w32 * ch;
  const float stride16 = (float)input_h / h16;
  const float stride32 = (float)input_h / h32;

#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; ++b) {
    std::vector<Cand> cands;
    decode_scale(s16 + b * n16, h16, w16, anchor_num, classes, anchors,
                 stride16, conf_thres, &cands);
    decode_scale(s32 + b * n32, h32, w32, anchor_num, classes,
                 anchors + anchor_num * 2, stride32, conf_thres, &cands);

    std::stable_sort(cands.begin(), cands.end(),
                     [](const Cand& a, const Cand& c) {
                       return a.score > c.score;
                     });

    std::vector<char> removed(cands.size(), 0);
    int n_out = 0;
    FDBox* row = out + (long)b * max_det;
    for (size_t i = 0; i < cands.size() && n_out < max_det; ++i) {
      if (removed[i]) continue;
      row[n_out++] = {cands[i].x1, cands[i].y1, cands[i].x2, cands[i].y2,
                      cands[i].score, cands[i].cls};
      for (size_t j = i + 1; j < cands.size(); ++j) {
        if (removed[j] || cands[j].cls != cands[i].cls) continue;
        if (iou(cands[i], cands[j]) > iou_thres) removed[j] = 1;
      }
    }
    counts[b] = n_out;
  }
  return 0;
}

extern "C" int fd_version(void) { return 2; }
