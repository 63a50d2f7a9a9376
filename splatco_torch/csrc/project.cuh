// The EWA projection's arithmetic, shared by csrc/project_fwd.cu and
// csrc/project_bwd.cu.  `forward` repeats, operation for operation, the
// torch ops of `covariance_cols` and `project_cols`
// (splatco_torch/ops/projection.py), and `vjp_view` then `vjp_rotation`
// those of `_project_bwd_plain`, the hand-written VJP beside them.  The
// sources are built with --fmad=false, so no multiply and add contract
// into one rounding; `/` is IEEE round-to-nearest division (`div_cot`
// gives the same bits) and `sqrtf` IEEE square root (no fast math), as
// torch's eager kernels compute them.
//
// The Python scalars of the formula meet float32 tensors and are rounded
// to float32 there, as torch rounds a Python float (static_cast<float> of
// the double): the literals below are written as casts of doubles, and
// the camera's focal lengths, frustum limits and image size arrive
// rounded.  Torch's NaN rules: `clamp` and `clamp_min` return a NaN value
// as it is (fminf / fmaxf would drop it), `where` selects bits unchanged.
#pragma once

#include <cuda_runtime.h>

namespace project {

constexpr int kThreads = 256;

// the float32 roundings of the formula's Python constants
#define PROJ_F32(x) static_cast<float>(x)
__device__ __forceinline__ float k_near() { return PROJ_F32(0.2); }
__device__ __forceinline__ float k_hw_eps() { return PROJ_F32(1e-7); }
__device__ __forceinline__ float k_z_eps() { return PROJ_F32(1e-8); }
__device__ __forceinline__ float k_lowpass() { return PROJ_F32(0.3); }
__device__ __forceinline__ float k_lambda_min() { return PROJ_F32(0.1); }
__device__ __forceinline__ float k_norm_min() { return PROJ_F32(1e-12); }
#undef PROJ_F32

// The camera: the transposed world->view and full projection matrices
// [4, 4] row-major on the device (m[r][c] at m[4 r + c]), and the scalars
// of `project_cols` rounded to float32: focal_x = W / (2 tan_fovx),
// focal_y, limx = 1.3 tan_fovx, limy, W, H.
struct Camera {
  const float* vm;
  const float* pm;
  float fx, fy, limx, limy, width, height;
};

// torch.clamp(v, lo, hi) with lo <= hi: NaN stays NaN
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.clamp_min(v, lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// p . m[:, col] as `xform` adds it: ((p0 m0 + p1 m1) + p2 m2) + m3
__device__ __forceinline__ float xform(const float* m, int col, float p0,
                                       float p1, float p2) {
  return ((p0 * m[col] + p1 * m[4 + col]) + p2 * m[8 + col]) + m[12 + col];
}

// a / b (IEEE) for a dividend that is often zero, a cotangent of a row
// that gets no gradient: the division's fast path hands a zero dividend to
// its slow path, so a zero over a nonzero or infinite divisor is given its
// signed zero directly (the division sees a dividend of 1 there).  The
// same bits as a / b for every a and b.
__device__ __forceinline__ float div_cot(float a, float b) {
  const bool zero = a == 0.0f && fabsf(b) > 0.0f;
  // an opaque copy: the compiler would otherwise divide a itself, since q
  // is not read where zero holds
  float d = zero ? 1.0f : a;
  asm("mov.f32 %0, %0;" : "+f"(d));
  const float q = d / b;
  return zero ? __uint_as_float((__float_as_uint(a) ^ __float_as_uint(b)) &
                                0x80000000u)
              : q;
}

// one gaussian's inputs
struct Row {
  float p0, p1, p2;      // mean
  float s0, s1, s2;      // scale
  float q0, q1, q2, q3;  // quaternion (w, x, y, z), not normalised
};

__device__ __forceinline__ Row load_row(const float* __restrict__ means,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ quats,
                                        long long i) {
  Row r;
  r.p0 = means[3 * i];
  r.p1 = means[3 * i + 1];
  r.p2 = means[3 * i + 2];
  r.s0 = scales[3 * i];
  r.s1 = scales[3 * i + 1];
  r.s2 = scales[3 * i + 2];
  r.q0 = quats[4 * i];
  r.q1 = quats[4 * i + 1];
  r.q2 = quats[4 * i + 2];
  r.q3 = quats[4 * i + 3];
  return r;
}

// covariance_cols' normalised quaternion (w, x, y, z) = q / n, n =
// clamp_min(|q|, 1e-12)
struct Quat {
  float n_raw, n, w, x, y, z;
};

__device__ __forceinline__ Quat normalise(float q0, float q1, float q2,
                                          float q3) {
  Quat u;
  u.n_raw = sqrtf(((q0 * q0 + q1 * q1) + q2 * q2) + q3 * q3);
  u.n = clamp_min(u.n_raw, k_norm_min());
  u.w = q0 / u.n;
  u.x = q1 / u.n;
  u.y = q2 / u.n;
  u.z = q3 / u.n;
  return u;
}

// R of the normalised quaternion, r[row][col]
struct Rot {
  float r[3][3];
};

__device__ __forceinline__ Rot rotation(const Quat& u) {
  const float w = u.w, x = u.x, y = u.y, z = u.z;
  Rot m;
  m.r[0][0] = 1.0f - 2.0f * (y * y + z * z);
  m.r[0][1] = 2.0f * (x * y - w * z);
  m.r[0][2] = 2.0f * (x * z + w * y);
  m.r[1][0] = 2.0f * (x * y + w * z);
  m.r[1][1] = 1.0f - 2.0f * (x * x + z * z);
  m.r[1][2] = 2.0f * (y * z - w * x);
  m.r[2][0] = 2.0f * (x * z - w * y);
  m.r[2][1] = 2.0f * (y * z + w * x);
  m.r[2][2] = 1.0f - 2.0f * (x * x + y * y);
  return m;
}

// the forward's values the outputs and the VJP read
struct Terms {
  // covariance_cols
  Quat u;
  Rot m;
  float v0, v1, v2;
  float xx, xy, xz, yy, yz, zz;
  // project_cols
  float tz, hx, hy, p_w, safe_z;
  float qx, qy, cx, cy, tx, ty, inv_z, inv_z2;
  float a0, a2, b1, b2;
  float m0[3], m1[3];
  float cov00, cov01, cov11, det, inv_det;
  bool det_ok;
};

// Sigma = R diag(s^2) R^T's column (xx, ...) as `sig` adds it
__device__ __forceinline__ float sig(const Terms& t, int a, int b) {
  return ((t.v0 * t.m.r[a][0]) * t.m.r[b][0] +
          (t.v1 * t.m.r[a][1]) * t.m.r[b][1]) +
         (t.v2 * t.m.r[a][2]) * t.m.r[b][2];
}

// u^T Sigma w as `quad` adds it
__device__ __forceinline__ float quad(const Terms& t, const float* u,
                                      const float* w) {
  return (u[0] * ((t.xx * w[0] + t.xy * w[1]) + t.xz * w[2]) +
          u[1] * ((t.xy * w[0] + t.yy * w[1]) + t.yz * w[2])) +
         u[2] * ((t.xz * w[0] + t.yz * w[1]) + t.zz * w[2]);
}

// `covariance_cols` then `project_cols` up to the conic's inverse
// determinant: every value the conic, the means and the VJP need.
__device__ __forceinline__ Terms forward(const Row& in, const Camera& c) {
  Terms t;
  // covariance_cols: the normalised quaternion, R, Sigma's six columns
  t.u = normalise(in.q0, in.q1, in.q2, in.q3);
  t.m = rotation(t.u);
  t.v0 = in.s0 * in.s0;
  t.v1 = in.s1 * in.s1;
  t.v2 = in.s2 * in.s2;
  t.xx = sig(t, 0, 0);
  t.xy = sig(t, 0, 1);
  t.xz = sig(t, 0, 2);
  t.yy = sig(t, 1, 1);
  t.yz = sig(t, 1, 2);
  t.zz = sig(t, 2, 2);

  // project_cols: view and clip coordinates
  const float* vm = c.vm;
  const float tx_v = xform(vm, 0, in.p0, in.p1, in.p2);
  const float ty_v = xform(vm, 1, in.p0, in.p1, in.p2);
  t.tz = xform(vm, 2, in.p0, in.p1, in.p2);
  t.hx = xform(c.pm, 0, in.p0, in.p1, in.p2);
  t.hy = xform(c.pm, 1, in.p0, in.p1, in.p2);
  const float hw = xform(c.pm, 3, in.p0, in.p1, in.p2);
  t.p_w = 1.0f / (hw + k_hw_eps());

  // the frustum clamp on the point the Jacobian is taken at
  t.safe_z = fabsf(t.tz) < k_z_eps() ? k_z_eps() : t.tz;
  t.qx = tx_v / t.safe_z;
  t.qy = ty_v / t.safe_z;
  t.cx = clamp(t.qx, -c.limx, c.limx);
  t.cy = clamp(t.qy, -c.limy, c.limy);
  t.tx = t.cx * t.tz;
  t.ty = t.cy * t.tz;
  t.inv_z = 1.0f / t.safe_z;
  t.inv_z2 = t.inv_z * t.inv_z;

  // M = J W's two rows
  t.a0 = c.fx * t.inv_z;
  t.a2 = (-c.fx * t.tx) * t.inv_z2;
  t.b1 = c.fy * t.inv_z;
  t.b2 = (-c.fy * t.ty) * t.inv_z2;
  for (int k = 0; k < 3; ++k) {
    t.m0[k] = t.a0 * vm[4 * k] + t.a2 * vm[4 * k + 2];
    t.m1[k] = t.b1 * vm[4 * k + 1] + t.b2 * vm[4 * k + 2];
  }

  // cov2D = M Sigma M^T + 0.3 I, its determinant
  t.cov00 = quad(t, t.m0, t.m0) + k_lowpass();
  t.cov01 = quad(t, t.m0, t.m1);
  t.cov11 = quad(t, t.m1, t.m1) + k_lowpass();
  t.det = t.cov00 * t.cov11 - t.cov01 * t.cov01;
  t.det_ok = t.det != 0.0f;
  t.inv_det = t.det_ok ? 1.0f / t.det : 0.0f;
  return t;
}

// ndc2Pix of the clip-space x (or y): ((hx p_w + 1) W - 1) / 2
__device__ __forceinline__ float pixel(float h, float p_w, float size) {
  return ((h * p_w + 1.0f) * size - 1.0f) * 0.5f;
}

// the radius: ceil(3 sqrt(lambda_max)) where the gaussian is in front of
// the near plane, its determinant nonzero and its square on screen, else 0
__device__ __forceinline__ float radius(const Terms& t, float mx, float my,
                                        const Camera& c) {
  const float mid = 0.5f * (t.cov00 + t.cov11);
  const float lambda1 =
      mid + sqrtf(clamp_min(mid * mid - t.det, k_lambda_min()));
  const float radius_f = ceilf(3.0f * sqrtf(lambda1));
  const bool on_screen = (mx + radius_f > 0.0f) && (mx - radius_f < c.width) &&
                         (my + radius_f > 0.0f) && (my - radius_f < c.height);
  const bool visible = t.tz > k_near() && t.det_ok && on_screen;
  return visible ? radius_f : 0.0f;
}

// `_project_bwd_plain` for one gaussian, in two parts.  Zero through a
// `where` branch not taken, `clamp`'s gradient inside the closed
// interval, `clamp_min`'s where x >= min, nothing through `ceil` (the
// radius).

// the cotangents of Sigma's six columns (xx, xy, xz, yy, yz, zz)
struct Cov3 {
  float xx, xy, xz, yy, yz, zz;
};

// The first part's outputs: the mean's gradient and the cotangents of
// Sigma's six columns
struct ViewGrads {
  float p[3];
  Cov3 g;
};

// The cotangents of mx, my, depth and the conic (a, b, c) to the mean's
// gradient and Sigma's, through `project_cols` (the forward's values t)
__device__ __forceinline__ ViewGrads vjp_view(const Terms& t,
                                              const Camera& c, float g_mx,
                                              float g_my, float g_depth,
                                              float g_ca, float g_cb,
                                              float g_cc) {
  const float* vm = c.vm;
  const float* pm = c.pm;
  // the pixel means -> hx, hy, p_w -> hw
  const float gu = (g_mx * 0.5f) * c.width;
  const float gv = (g_my * 0.5f) * c.height;
  const float g_hx = gu * t.p_w;
  const float g_hy = gv * t.p_w;
  const float g_pw = gu * t.hx + gv * t.hy;
  const float g_hw = -g_pw * (t.p_w * t.p_w);

  // the conic -> cov2D
  const float g_inv_det = (g_ca * t.cov11 + g_cb * -t.cov01) + g_cc * t.cov00;
  const float g_det =
      t.det_ok ? -g_inv_det * (t.inv_det * t.inv_det) : 0.0f;
  const float gd01 = g_det * t.cov01;
  const float g00 = g_cc * t.inv_det + g_det * t.cov11;
  const float g11 = g_ca * t.inv_det + g_det * t.cov00;
  const float g01 = -(g_cb * t.inv_det) - (gd01 + gd01);

  // cov2D = M Sigma M^T -> M's rows and Sigma's six columns
  float sa[3], sb[3];  // Sigma m0, Sigma m1
  sa[0] = (t.xx * t.m0[0] + t.xy * t.m0[1]) + t.xz * t.m0[2];
  sa[1] = (t.xy * t.m0[0] + t.yy * t.m0[1]) + t.yz * t.m0[2];
  sa[2] = (t.xz * t.m0[0] + t.yz * t.m0[1]) + t.zz * t.m0[2];
  sb[0] = (t.xx * t.m1[0] + t.xy * t.m1[1]) + t.xz * t.m1[2];
  sb[1] = (t.xy * t.m1[0] + t.yy * t.m1[1]) + t.yz * t.m1[2];
  sb[2] = (t.xz * t.m1[0] + t.yz * t.m1[1]) + t.zz * t.m1[2];
  const float t00 = g00 + g00, t11 = g11 + g11;
  float g_m0[3], g_m1[3], e[3], f[3];
  for (int k = 0; k < 3; ++k) {
    g_m0[k] = t00 * sa[k] + g01 * sb[k];
    g_m1[k] = g01 * sa[k] + t11 * sb[k];
    e[k] = g00 * t.m0[k] + g01 * t.m1[k];
    f[k] = g11 * t.m1[k];
  }
  float tt[3][3];  // T_ij = m0_i e_j + m1_i f_j
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) tt[i][j] = t.m0[i] * e[j] + t.m1[i] * f[j];
  ViewGrads out;
  out.g = Cov3{tt[0][0], tt[0][1] + tt[1][0], tt[0][2] + tt[2][0],
               tt[1][1], tt[1][2] + tt[2][1], tt[2][2]};

  // M's rows -> a0, a2, b1, b2 -> tx, ty, inv_z
  const float g_a0 = (g_m0[0] * vm[0] + g_m0[1] * vm[4]) + g_m0[2] * vm[8];
  const float g_a2 = (g_m0[0] * vm[2] + g_m0[1] * vm[6]) + g_m0[2] * vm[10];
  const float g_b1 = (g_m1[0] * vm[1] + g_m1[1] * vm[5]) + g_m1[2] * vm[9];
  const float g_b2 = (g_m1[0] * vm[2] + g_m1[1] * vm[6]) + g_m1[2] * vm[10];
  const float g_tx = (g_a2 * t.inv_z2) * -c.fx;
  const float g_ty = (g_b2 * t.inv_z2) * -c.fy;
  const float g_inv_z2 =
      g_a2 * (-c.fx * t.tx) + g_b2 * (-c.fy * t.ty);
  const float g_inv_z = (g_a0 * c.fx + g_b1 * c.fy) +
                        (g_inv_z2 * t.inv_z + g_inv_z2 * t.inv_z);

  // the clamp -> the view coordinates and safe_z
  const float g_qx = (t.qx >= -c.limx && t.qx <= c.limx) ? g_tx * t.tz : 0.0f;
  const float g_qy = (t.qy >= -c.limy && t.qy <= c.limy) ? g_ty * t.tz : 0.0f;
  const float g_txv = div_cot(g_qx, t.safe_z);
  const float g_tyv = div_cot(g_qy, t.safe_z);
  const float g_safe_z = (-g_inv_z * (t.inv_z * t.inv_z) +
                          -g_qx * (t.qx / t.safe_z)) +
                         -g_qy * (t.qy / t.safe_z);
  const float g_tz = ((g_depth + g_tx * t.cx) + g_ty * t.cy) +
                     (fabsf(t.tz) < k_z_eps() ? 0.0f : g_safe_z);

  // the view and clip coordinates -> the mean
  for (int k = 0; k < 3; ++k)
    out.p[k] = ((((g_txv * vm[4 * k] + g_tyv * vm[4 * k + 1]) +
                  g_tz * vm[4 * k + 2]) +
                 g_hx * pm[4 * k]) +
                g_hy * pm[4 * k + 1]) +
               g_hw * pm[4 * k + 3];
  return out;
}

// Sigma's cotangents g to the gradients of the scale s (ds) and of the
// quaternion q (dq), through `covariance_cols` (u, m: its normalised q
// and R)
__device__ __forceinline__ void vjp_rotation(const Quat& u, const Rot& m,
                                             const float* s, const float* q,
                                             const Cov3& g, float* ds,
                                             float* dq) {
  // Sigma's columns -> v = s^2 and R
  const float dxx = g.xx + g.xx, dyy = g.yy + g.yy, dzz = g.zz + g.zz;
  float g_r[3][3];
  for (int k = 0; k < 3; ++k) {
    const float c0 = m.r[0][k], c1 = m.r[1][k], c2 = m.r[2][k];
    const float g_v =
        ((((g.xx * (c0 * c0) + g.xy * (c0 * c1)) + g.xz * (c0 * c2)) +
          g.yy * (c1 * c1)) +
         g.yz * (c1 * c2)) +
        g.zz * (c2 * c2);
    const float v = s[k] * s[k];
    ds[k] = g_v * s[k] + g_v * s[k];
    g_r[0][k] = v * ((dxx * c0 + g.xy * c1) + g.xz * c2);
    g_r[1][k] = v * ((g.xy * c0 + dyy * c1) + g.yz * c2);
    g_r[2][k] = v * ((g.xz * c0 + g.yz * c1) + dzz * c2);
  }

  // R -> the normalised quaternion (w, x, y, z)
  const float w = u.w, x = u.x, y = u.y, z = u.z;
  const float s01 = g_r[0][1] + g_r[1][0], s02 = g_r[0][2] + g_r[2][0];
  const float s12 = g_r[1][2] + g_r[2][1];
  const float d01 = g_r[1][0] - g_r[0][1], d02 = g_r[0][2] - g_r[2][0];
  const float d12 = g_r[2][1] - g_r[1][2];
  const float g_w = 2.0f * ((x * d12 + y * d02) + z * d01);
  const float g_x = 2.0f * ((y * s01 + z * s02) + w * d12) -
                    4.0f * (x * (g_r[1][1] + g_r[2][2]));
  const float g_y = 2.0f * ((x * s01 + z * s12) + w * d02) -
                    4.0f * (y * (g_r[0][0] + g_r[2][2]));
  const float g_z = 2.0f * ((x * s02 + y * s12) + w * d01) -
                    4.0f * (z * (g_r[0][0] + g_r[1][1]));

  // the normalisation q / clamp_min(|q|, 1e-12) -> q
  const float g_n =
      div_cot(-(((g_w * w + g_x * x) + g_y * y) + g_z * z), u.n);
  const float g_n_raw = u.n_raw >= k_norm_min() ? g_n : 0.0f;
  const float g_sq = div_cot(g_n_raw, 2.0f * u.n_raw);
  dq[0] = div_cot(g_w, u.n) + g_sq * (2.0f * q[0]);
  dq[1] = div_cot(g_x, u.n) + g_sq * (2.0f * q[1]);
  dq[2] = div_cot(g_y, u.n) + g_sq * (2.0f * q[2]);
  dq[3] = div_cot(g_z, u.n) + g_sq * (2.0f * q[3]);
}

}  // namespace project
