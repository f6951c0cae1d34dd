// Rotated 3D box IoU (bottom-centered box7): the host-side evaluation IoU
// of the port, a copy of the JAX package's `native/src/iou3d.cc`.
//
// The reference computes evaluation IoU in native code (mmdet3d's
// `iou3d_cuda`, consumed by BaseInstance3DBoxes.overlaps -> indoor_eval).
// This is its host-side C++ equivalent: BEV rectangle intersection by
// Sutherland-Hodgman convex clipping x z-extent overlap. Used by
// fcaf3d_tpu_torch.core.eval through ctypes (`native/__init__.py` builds
// it with the JAX package's flags, so the float32 results are bitwise its
// results); the numpy path of core/eval.py is the plain version.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 iou3d.cc -o libfcaf3d_native.so
#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

struct P {
  double x, y;
};

inline double cross(const P& o, const P& a, const P& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Clip convex CCW polygon `in[n]` by the half-plane left of edge a->b.
// Output has at most n+1 vertices.
int clip_edge(const P* in, int n, const P& a, const P& b, P* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const P& cur = in[i];
    const P& nxt = in[(i + 1) % n];
    double dc = cross(a, b, cur);
    double dn = cross(a, b, nxt);
    if (dc >= 0) out[m++] = cur;
    if ((dc >= 0) != (dn >= 0)) {
      double t = dc / (dc - dn);
      out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
    }
  }
  return m;
}

// BEV corners, matching core/eval.py _bev_corners_np (clockwise-for-
// positive yaw rotation; CCW vertex order).
void corners(double x, double y, double dx, double dy, double a, P* c) {
  static const double sx[4] = {0.5, -0.5, -0.5, 0.5};
  static const double sy[4] = {0.5, 0.5, -0.5, -0.5};
  double ca = std::cos(a), sa = std::sin(a);
  for (int k = 0; k < 4; ++k) {
    double cx = sx[k] * dx, cy = sy[k] * dy;
    c[k] = {cx * ca + cy * sa + x, -cx * sa + cy * ca + y};
  }
}

double polygon_area(const P* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const P& a = p[i];
    const P& b = p[(i + 1) % n];
    s += a.x * b.y - a.y * b.x;
  }
  return 0.5 * std::fabs(s);
}

double inter_area(const P* c1, const P* c2) {
  P buf1[16], buf2[16];
  for (int i = 0; i < 4; ++i) buf1[i] = c1[i];
  P* in = buf1;
  P* out = buf2;
  int n = 4;
  for (int e = 0; e < 4 && n > 2; ++e) {
    n = clip_edge(in, n, c2[e], c2[(e + 1) % 4], out);
    std::swap(in, out);
  }
  return n > 2 ? polygon_area(in, n) : 0.0;
}

}  // namespace

extern "C" {

// boxes: row-major [n, 7] float32 (x, y, z_bottom, dx, dy, dz, yaw).
// out: row-major [n1, n2] float32 3D IoU.
void iou3d_pairwise(const float* b1, int64_t n1, const float* b2, int64_t n2,
                    float* out) {
  for (int64_t i = 0; i < n1; ++i) {
    const float* a = b1 + i * 7;
    P ca[4];
    corners(a[0], a[1], a[3], a[4], a[6], ca);
    double va = (double)a[3] * a[4] * a[5];
    double za0 = a[2], za1 = a[2] + a[5];
    for (int64_t j = 0; j < n2; ++j) {
      const float* b = b2 + j * 7;
      P cb[4];
      corners(b[0], b[1], b[3], b[4], b[6], cb);
      double zo = std::min(za1, (double)b[2] + b[5]) -
                  std::max(za0, (double)b[2]);
      double iou = 0.0;
      if (zo > 0) {
        double inter = inter_area(ca, cb) * zo;
        double vb = (double)b[3] * b[4] * b[5];
        iou = inter / std::max(va + vb - inter, 1e-8);
      }
      out[i * n2 + j] = (float)iou;
    }
  }
}

}  // extern "C"
