// Native evaluation kernels for the KITTI-3D AP engine.
//
// C++ rebuild of the reference's numba kernels (equivalents of:
//  - rotated-rectangle IoU matrix: tridet/evaluators/rotate_iou.py:25-327
//    (numba CUDA) — here: Sutherland–Hodgman convex clipping + OpenMP,
//  - 3D IoU from BEV intersection x vertical overlap: rotate_iou.py:330-357,
//  - greedy TP/FP matching + threshold extraction + fused PR statistics:
//    tridet/evaluators/kitti_3d_evaluator.py:749-1038).
//
// The matching semantics (ignore rules, assigned_ignored_det handling,
// strict `overlap > min_overlap` comparisons) are preserved exactly; the
// geometry uses the same clockwise-rotation corner convention
// (rotate_iou.py:205-226) in double precision.
//
// The port's copy of dd3d_tpu/evaluators/native/kitti_eval.cpp, code unchanged.
// Built by dd3d_tpu_torch/kernels with the JAX package's flags:
// g++ -O3 -fopenmp -shared -fPIC kitti_eval.cpp -o libkitti_eval.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// box: [cx, cy, dx, dy, angle]; clockwise rotation (rotate_iou.py:205-226).
inline void box_corners(const double* b, Pt* c) {
  const double ac = std::cos(b[4]), as = std::sin(b[4]);
  const double hx = b[2] / 2.0, hy = b[3] / 2.0;
  const double xs[4] = {-hx, -hx, hx, hx};
  const double ys[4] = {-hy, hy, hy, -hy};
  for (int i = 0; i < 4; ++i) {
    c[i].x = ac * xs[i] + as * ys[i] + b[0];
    c[i].y = -as * xs[i] + ac * ys[i] + b[1];
  }
}

inline double poly_area(const Pt* p, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return std::abs(a) / 2.0;
}

// Clip polygon `in` (n verts) against half-plane on the inner side of edge
// a->b of a polygon with orientation sign `orient`.
inline int clip_edge(const Pt* in, int n, const Pt& a, const Pt& b, double orient, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = in[i];
    const Pt& nxt = in[(i + 1) % n];
    const double dc = orient * cross(a, b, cur);
    const double dn = orient * cross(a, b, nxt);
    if (dc >= 0) out[m++] = cur;
    if ((dc >= 0) != (dn >= 0)) {
      const double t = dc / (dc - dn);
      out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
    }
  }
  return m;
}

inline double signed_area2(const Pt* p, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) a += p[i].x * p[(i + 1) % n].y - p[(i + 1) % n].x * p[i].y;
  return a;
}

// Intersection area of two convex quads.
double quad_intersection_area(const Pt* p, const Pt* q) {
  Pt buf1[16], buf2[16];
  int n = 4;
  std::memcpy(buf1, p, 4 * sizeof(Pt));
  const double orient = signed_area2(q, 4) >= 0 ? 1.0 : -1.0;
  Pt* cur = buf1;
  Pt* nxt = buf2;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_edge(cur, n, q[e], q[(e + 1) % 4], orient, nxt);
    std::swap(cur, nxt);
  }
  if (n < 3) return 0.0;
  return poly_area(cur, n);
}

double rotated_pair(const double* b1, const double* b2, int criterion) {
  Pt c1[4], c2[4];
  box_corners(b1, c1);
  box_corners(b2, c2);
  const double inter = quad_intersection_area(c1, c2);
  const double a1 = b1[2] * b1[3];
  const double a2 = b2[2] * b2[3];
  if (criterion == -1) return inter / std::max(a1 + a2 - inter, 1e-12);
  if (criterion == 0) return inter / std::max(a1, 1e-12);
  if (criterion == 1) return inter / std::max(a2, 1e-12);
  return inter;
}

}  // namespace

extern "C" {

// boxes: (N, 5), qboxes: (K, 5) -> out (N, K)
void rotated_iou_matrix(const double* boxes, int64_t n, const double* qboxes, int64_t k,
                        int criterion, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < k; ++j) {
      out[i * k + j] = rotated_pair(boxes + i * 5, qboxes + j * 5, criterion);
    }
  }
}

// boxes: (N, 7) = [x, y, z, l, h, w, ry] camera frame (y = bottom face);
// rinc: (N, K) BEV intersection AREA in/out -> 3D IoU.
// cf. d3_box_overlap_kernel, rotate_iou.py:330-357 (camera_coordinate=True).
void d3_box_overlap_inplace(const double* boxes, int64_t n, const double* qboxes, int64_t k,
                            int criterion, double* rinc) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < k; ++j) {
      double& r = rinc[i * k + j];
      if (r > 0) {
        const double iw = std::min(boxes[i * 7 + 1], qboxes[j * 7 + 1]) -
                          std::max(boxes[i * 7 + 1] - boxes[i * 7 + 4],
                                   qboxes[j * 7 + 1] - qboxes[j * 7 + 4]);
        if (iw > 0) {
          const double v1 = boxes[i * 7 + 3] * boxes[i * 7 + 4] * boxes[i * 7 + 5];
          const double v2 = qboxes[j * 7 + 3] * qboxes[j * 7 + 4] * qboxes[j * 7 + 5];
          const double inc = iw * r;
          double ua;
          if (criterion == -1) ua = v1 + v2 - inc;
          else if (criterion == 0) ua = v1;
          else if (criterion == 1) ua = v2;
          else ua = inc;
          r = inc / ua;
        } else {
          r = 0.0;
        }
      }
    }
  }
}

namespace {

inline double angle_diff(double x, double y, double period) {
  double diff = std::fmod(x - y + period / 2, period);
  if (diff < 0) diff += period;  // C++ fmod keeps sign; python % does not
  diff -= period / 2;
  if (diff > M_PI) diff -= 2 * M_PI;
  return diff;
}

inline double scale_iou(const double* g, const double* d) {
  const double inter = std::min(g[0], d[0]) * std::min(g[1], d[1]) * std::min(g[2], d[2]);
  const double vg = g[0] * g[1] * g[2];
  const double vd = d[0] * d[1] * d[2];
  return inter / (vg + vd - inter);
}

}  // namespace

// Greedy matching WITHOUT fp computation: extract matched-detection scores.
// overlaps: (det, gt). Returns number of thresholds written to out.
// cf. compute_threshold_jit, kitti_3d_evaluator.py:749-810.
int64_t compute_threshold(const double* overlaps, int64_t det_size, int64_t gt_size,
                          const double* dt_scores, const int64_t* ignored_gt,
                          const int64_t* ignored_det, double min_overlap, double* out) {
  const double NO_DET = -3.0e38;
  bool* assigned = new bool[det_size]();
  int64_t n_out = 0;
  for (int64_t i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = NO_DET;
    for (int64_t j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1 || assigned[j]) continue;
      const double ov = overlaps[j * gt_size + i];
      if (ov > min_overlap && dt_scores[j] > valid_detection) {
        det_idx = j;
        valid_detection = dt_scores[j];
      }
    }
    if (valid_detection == NO_DET) {
      // fn += (ignored_gt[i] == 0) — not needed here
    } else if (ignored_gt[i] == 1 || ignored_det[det_idx] == 1) {
      assigned[det_idx] = true;
    } else {
      out[n_out++] = dt_scores[det_idx];
      assigned[det_idx] = true;
    }
  }
  delete[] assigned;
  return n_out;
}

// Full TP/FP statistics at one score threshold for one image.
// gt_data layout per row (9): bbox(4), rotation_y, alpha, dims(3)
// dt_data layout per row (10): bbox(4), rotation_y, alpha, dims(3), score
// out: [tp, fp, fn, error_yaw, similarity, match_degree, confidence_error,
//       scale_error]
// cf. compute_statistics_jit, kitti_3d_evaluator.py:910-1038.
void compute_statistics(const double* overlaps, int64_t det_size, int64_t gt_size,
                        const double* gt_data, const double* dt_data,
                        const int64_t* ignored_gt, const int64_t* ignored_det,
                        double min_overlap, double thresh, int compute_angular,
                        double* out) {
  const double NO_DET = -3.0e38;
  bool* assigned = new bool[det_size]();
  bool* ignored_threshold = new bool[det_size]();
  for (int64_t j = 0; j < det_size; ++j)
    if (dt_data[j * 10 + 9] < thresh) ignored_threshold[j] = true;

  int64_t tp = 0, fp = 0, fn = 0;
  double error_yaw = 0, similarity = 0, match_degree = 0, conf_err = 0, scale_err = 0;
  double* delta_yaw = new double[gt_size];
  double* delta_alpha = new double[gt_size];
  int64_t delta_idx = 0;

  for (int64_t i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = NO_DET;
    double max_overlap = -3.0e38;
    double target_scale_iou = 0;
    bool assigned_ignored_det = false;

    for (int64_t j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j]) continue;
      const double ov = overlaps[j * gt_size + i];
      if (ov > min_overlap && (ov > max_overlap || assigned_ignored_det) && ignored_det[j] == 0) {
        max_overlap = ov;
        target_scale_iou = scale_iou(gt_data + i * 9 + 6, dt_data + j * 10 + 6);
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (ov > min_overlap && valid_detection == NO_DET && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == NO_DET && ignored_gt[i] == 0) {
      fn += 1;
    } else if (valid_detection != NO_DET && (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = true;
    } else if (valid_detection != NO_DET) {
      tp += 1;
      match_degree += std::abs(max_overlap);
      scale_err += 1.0 - std::abs(target_scale_iou);
      conf_err += -std::log(dt_data[det_idx * 10 + 9]);
      if (compute_angular) {
        delta_yaw[delta_idx] = std::abs(
            angle_diff(gt_data[i * 9 + 4], dt_data[det_idx * 10 + 4], 2 * M_PI));
        delta_alpha[delta_idx] = gt_data[i * 9 + 5] - dt_data[det_idx * 10 + 5];
        delta_idx += 1;
      }
      assigned[det_idx] = true;
    }
  }

  for (int64_t j = 0; j < det_size; ++j) {
    if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 || ignored_threshold[j])) fp += 1;
  }
  if (compute_angular) {
    if (tp > 0 || fp > 0) {
      for (int64_t i = 0; i < delta_idx; ++i) {
        error_yaw += delta_yaw[i];
        similarity += (1.0 + std::cos(delta_alpha[i])) / 2.0;
      }
    } else {
      error_yaw = -1;
      similarity = -1;
    }
  }

  out[0] = (double)tp;
  out[1] = (double)fp;
  out[2] = (double)fn;
  out[3] = error_yaw;
  out[4] = similarity;
  out[5] = match_degree;
  out[6] = conf_err;
  out[7] = scale_err;

  delete[] assigned;
  delete[] ignored_threshold;
  delete[] delta_yaw;
  delete[] delta_alpha;
}

// Fused statistics over a batch of images x thresholds, accumulating into
// pr (num_thresholds x 8). Arrays are concatenated over images; *_nums give
// per-image counts. cf. fused_compute_statistics, kitti_3d_evaluator.py:850-907.
void fused_compute_statistics(const double* overlaps,  // (total_dt, total_gt) block-diagonal layout
                              double* pr, int64_t num_images, int64_t num_thresholds,
                              const int64_t* gt_nums, const int64_t* dt_nums,
                              const double* gt_datas, const double* dt_datas,
                              const int64_t* ignored_gts, const int64_t* ignored_dets,
                              double min_overlap, const double* thresholds,
                              int compute_angular, int64_t total_gt) {
  int64_t gt_off = 0, dt_off = 0;
  for (int64_t im = 0; im < num_images; ++im) {
    const int64_t ng = gt_nums[im], nd = dt_nums[im];
    // Per-image overlap submatrix: rows dt_off..dt_off+nd over the full
    // gt stride (total_gt); build a compact copy.
    double* sub = new double[std::max<int64_t>(nd * ng, 1)];
    for (int64_t j = 0; j < nd; ++j)
      for (int64_t i = 0; i < ng; ++i)
        sub[j * ng + i] = overlaps[(dt_off + j) * total_gt + (gt_off + i)];

    double out[8];
    for (int64_t t = 0; t < num_thresholds; ++t) {
      compute_statistics(sub, nd, ng, gt_datas + gt_off * 9, dt_datas + dt_off * 10,
                         ignored_gts + gt_off, ignored_dets + dt_off, min_overlap,
                         thresholds[t], compute_angular, out);
      pr[t * 8 + 0] += out[0];
      pr[t * 8 + 1] += out[1];
      pr[t * 8 + 2] += out[2];
      pr[t * 8 + 5] += out[5];
      pr[t * 8 + 6] += out[6];
      pr[t * 8 + 7] += out[7];
      if (out[3] != -1) pr[t * 8 + 3] += out[3];
      if (out[4] != -1) pr[t * 8 + 4] += out[4];
    }
    delete[] sub;
    gt_off += ng;
    dt_off += nd;
  }
}

}  // extern "C"
