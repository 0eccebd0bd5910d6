// crog_tpu_torch native host ops: the readers' cv2-parity affine warp, the
// even-odd polygon fill of the grasp maps and their separable gaussian blur.
// Counterpart of crog_tpu/native/hostops.cpp: the same arithmetic and the
// same C signatures of warp_affine_u8/_f32, polygon_fill and
// gaussian_blur_f64 (its axis-aligned aliases of the warp are left out), so
// the two packages' host batches agree bit for bit.
//
// The reference leaned on OpenCV/skimage C++ kernels for its input pipeline
// (cv2.warpAffine letterboxing utils/dataset.py:858-890, skimage polygon
// rasterization :652-676, gaussian blur :673-676).  These are the host-side
// hot path between PNG decode and the copy to the card; natively they run
// without the interpreter lock (ctypes.CDLL releases it for each call), so
// the loader's threads warp beside the step that launches the kernels.
//
// Exposed as a plain C ABI consumed via ctypes (crog_tpu_torch/native).
// Numerics: the warp matches cv2.warpAffine (OpenCV 5) ARITHMETIC — float32
// coordinates from a float32-cast cofactor inverse, FMA-contracted lerps
// (linear) / FMA-chained 4-tap dots with c3 = 1-c0-c1-c2 coefficients
// (cubic), round-half-even uint8 rounding — pinned by the vendored cv2
// goldens in tests/data/cv2_goldens.npz.  Polygon/gaussian match
// skimage/scipy semantics.  MUST be compiled with -ffp-contract=off and
// WITHOUT -ffast-math: contraction is applied exactly where cv2 applies it
// and nowhere else.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Affine {
  double a, b, c, d, e, f;  // [a b c; d e f]
};

// cv2.invertAffineTransform cofactor formula (double), see ops/affine.py.
inline Affine invert(const Affine& m) {
  double det = m.a * m.e - m.b * m.d;
  det = det != 0.0 ? 1.0 / det : 0.0;
  double ia = m.e * det, ib = -m.b * det;
  double id = -m.d * det, ie = m.a * det;
  return {ia, ib, -ia * m.c - ib * m.f, id, ie, -id * m.c - ie * m.f};
}

// OpenCV interpolateCubic in float32: last coefficient closes the partition
// of unity.  Plain mul/add (no contraction; build flags enforce it).
inline void cubic_coeffs_f32(float f, float* c) {
  const float A = -0.75f;
  c[0] = ((A * (f + 1.0f) - 5.0f * A) * (f + 1.0f) + 8.0f * A) * (f + 1.0f) -
         4.0f * A;
  c[1] = ((A + 2.0f) * f - (A + 3.0f)) * f * f + 1.0f;
  c[2] = ((A + 2.0f) * (1.0f - f) - (A + 3.0f)) * (1.0f - f) * (1.0f - f) +
         1.0f;
  c[3] = 1.0f - c[0] - c[1] - c[2];
}

template <typename T>
inline float tapf(const T* img, int h, int w, int c, int x, int y, int ch,
                  float border) {
  if (x < 0 || x >= w || y < 0 || y >= h) return border;
  return static_cast<float>(img[(static_cast<int64_t>(y) * w + x) * c + ch]);
}

template <typename T>
void warp_affine_impl(const T* src, int sh, int sw, int c, const double* mat,
                      int oh, int ow, int interp /*0 nearest,1 linear,2 cubic*/,
                      const double* border, T* dst) {
  Affine fwd{mat[0], mat[1], mat[2], mat[3], mat[4], mat[5]};
  Affine inv64 = invert(fwd);
  const float ia = static_cast<float>(inv64.a), ib = static_cast<float>(inv64.b),
              ic = static_cast<float>(inv64.c), id = static_cast<float>(inv64.d),
              ie = static_cast<float>(inv64.e), iff = static_cast<float>(inv64.f);
  std::vector<float> bval(c);
  for (int ch = 0; ch < c; ++ch) {
    double b = border[ch];
    if (sizeof(T) == 1) b = std::min(255.0, std::max(0.0, std::nearbyint(b)));
    bval[ch] = static_cast<float>(b);
  }
  for (int y = 0; y < oh; ++y) {
    const float yf = static_cast<float>(y);
    for (int x = 0; x < ow; ++x) {
      const float xf = static_cast<float>(x);
      // float32 coordinate chain, plain mul/add (cv2 parity)
      float sx = ia * xf + ib * yf + ic;
      float sy = id * xf + ie * yf + iff;
      for (int ch = 0; ch < c; ++ch) {
        float v = 0.0f;
        if (interp == 0) {
          int ix = static_cast<int>(std::nearbyintf(sx));
          int iy = static_cast<int>(std::nearbyintf(sy));
          v = tapf(src, sh, sw, c, ix, iy, ch, bval[ch]);
        } else if (interp == 1) {
          int x0 = static_cast<int>(std::floor(sx));
          int y0 = static_cast<int>(std::floor(sy));
          float fx = sx - static_cast<float>(x0);
          float fy = sy - static_cast<float>(y0);
          float v00 = tapf(src, sh, sw, c, x0, y0, ch, bval[ch]);
          float v01 = tapf(src, sh, sw, c, x0 + 1, y0, ch, bval[ch]);
          float v10 = tapf(src, sh, sw, c, x0, y0 + 1, ch, bval[ch]);
          float v11 = tapf(src, sh, sw, c, x0 + 1, y0 + 1, ch, bval[ch]);
          float p0 = std::fmaf(fx, v01 - v00, v00);
          float p1 = std::fmaf(fx, v11 - v10, v10);
          v = std::fmaf(fy, p1 - p0, p0);
        } else {
          int x0 = static_cast<int>(std::floor(sx));
          int y0 = static_cast<int>(std::floor(sy));
          float fx = sx - static_cast<float>(x0);
          float fy = sy - static_cast<float>(y0);
          float wx[4], wy[4];
          cubic_coeffs_f32(fx, wx);
          cubic_coeffs_f32(fy, wy);
          float rows[4];
          for (int j = 0; j < 4; ++j) {
            float t0 = tapf(src, sh, sw, c, x0 - 1, y0 + j - 1, ch, bval[ch]);
            float t1 = tapf(src, sh, sw, c, x0, y0 + j - 1, ch, bval[ch]);
            float t2 = tapf(src, sh, sw, c, x0 + 1, y0 + j - 1, ch, bval[ch]);
            float t3 = tapf(src, sh, sw, c, x0 + 2, y0 + j - 1, ch, bval[ch]);
            rows[j] = std::fmaf(
                wx[3], t3,
                std::fmaf(wx[2], t2, std::fmaf(wx[1], t1, wx[0] * t0)));
          }
          v = std::fmaf(
              wy[3], rows[3],
              std::fmaf(wy[2], rows[2],
                        std::fmaf(wy[1], rows[1], wy[0] * rows[0])));
        }
        int64_t o = (static_cast<int64_t>(y) * ow + x) * c + ch;
        if (sizeof(T) == 1) {  // uint8: round-half-even + clip (cv2 parity)
          dst[o] = static_cast<T>(std::min(
              255.0f, std::max(0.0f, std::nearbyintf(v))));
        } else {
          dst[o] = static_cast<T>(v);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

void warp_affine_u8(const uint8_t* src, int sh, int sw, int c,
                    const double* mat, int oh, int ow, int interp,
                    const double* border, uint8_t* dst) {
  warp_affine_impl<uint8_t>(src, sh, sw, c, mat, oh, ow, interp, border, dst);
}

void warp_affine_f32(const float* src, int sh, int sw, int c,
                     const double* mat, int oh, int ow, int interp,
                     const double* border, float* dst) {
  warp_affine_impl<float>(src, sh, sw, c, mat, oh, ow, interp, border, dst);
}

// Even-odd polygon fill over the vertex bounding box, writing `value` into a
// float64 canvas (matches crog_tpu.ops.rects.polygon_indices semantics:
// r = first axis of the vertex arrays; canvas indexed [cc, rr] by callers).
void polygon_fill(const double* vr, const double* vc, int n, double* canvas,
                  int canvas_h, int canvas_w, int clip_r, int clip_c,
                  double value) {
  double rmin = vr[0], rmax = vr[0], cmin = vc[0], cmax = vc[0];
  for (int i = 1; i < n; ++i) {
    rmin = std::min(rmin, vr[i]); rmax = std::max(rmax, vr[i]);
    cmin = std::min(cmin, vc[i]); cmax = std::max(cmax, vc[i]);
  }
  int r0 = std::max(0, static_cast<int>(rmin));
  int r1 = static_cast<int>(std::ceil(rmax));
  int c0 = std::max(0, static_cast<int>(cmin));
  int c1 = static_cast<int>(std::ceil(cmax));
  if (clip_r > 0) r1 = std::min(clip_r - 1, r1);
  if (clip_c > 0) c1 = std::min(clip_c - 1, c1);
  for (int r = r0; r <= r1; ++r) {
    for (int c = c0; c <= c1; ++c) {
      bool inside = false;
      int j = n - 1;
      for (int i = 0; i < n; ++i) {
        if (((vr[i] > r) != (vr[j] > r)) &&
            (c < (vc[j] - vc[i]) * (r - vr[i]) / (vr[j] - vr[i]) + vc[i])) {
          inside = !inside;
        }
        j = i;
      }
      // callers pass (x, y) as (vr, vc); the canvas write is [cc, rr]
      if (inside && c >= 0 && c < canvas_h && r >= 0 && r < canvas_w) {
        canvas[static_cast<int64_t>(c) * canvas_w + r] = value;
      }
    }
  }
}

// Separable gaussian blur, float64, edge padding, truncate=4.0.
void gaussian_blur_f64(const double* src, int h, int w, double sigma,
                       double* dst) {
  int radius = static_cast<int>(4.0 * sigma + 0.5);
  std::vector<double> k(2 * radius + 1);
  double s = 0.0;
  for (int i = -radius; i <= radius; ++i) {
    k[i + radius] = std::exp(-0.5 * (i / sigma) * (i / sigma));
    s += k[i + radius];
  }
  for (auto& v : k) v /= s;
  std::vector<double> tmp(static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      double acc = 0.0;
      for (int i = -radius; i <= radius; ++i) {
        int yy = std::min(h - 1, std::max(0, y + i));
        acc += k[i + radius] * src[static_cast<int64_t>(yy) * w + x];
      }
      tmp[static_cast<int64_t>(y) * w + x] = acc;
    }
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      double acc = 0.0;
      for (int i = -radius; i <= radius; ++i) {
        int xx = std::min(w - 1, std::max(0, x + i));
        acc += k[i + radius] * tmp[static_cast<int64_t>(y) * w + xx];
      }
      dst[static_cast<int64_t>(y) * w + x] = acc;
    }
  }
}

}  // extern "C"
