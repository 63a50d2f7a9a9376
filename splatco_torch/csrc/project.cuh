// The EWA projection's arithmetic, shared by csrc/project_fwd.cu and
// csrc/project_bwd.cu.  `forward` repeats, operation for operation, the
// torch ops of `covariance_cols` and `project_cols`
// (splatco_torch/ops/projection.py), and `vjp` those of
// `_project_bwd_plain`, the hand-written VJP beside them.  The sources are
// built with --fmad=false, so no multiply and add contract into one
// rounding; `/` is IEEE round-to-nearest division and `sqrtf` IEEE square
// root (no fast math), as torch's eager kernels compute them.
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

// the forward's values the outputs and the VJP read
struct Terms {
  // covariance_cols
  float n_raw, n, w, x, y, z;
  float r[3][3];
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
  return ((t.v0 * t.r[a][0]) * t.r[b][0] + (t.v1 * t.r[a][1]) * t.r[b][1]) +
         (t.v2 * t.r[a][2]) * t.r[b][2];
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
  t.n_raw = sqrtf(((in.q0 * in.q0 + in.q1 * in.q1) + in.q2 * in.q2) +
                  in.q3 * in.q3);
  t.n = clamp_min(t.n_raw, k_norm_min());
  t.w = in.q0 / t.n;
  t.x = in.q1 / t.n;
  t.y = in.q2 / t.n;
  t.z = in.q3 / t.n;
  const float w = t.w, x = t.x, y = t.y, z = t.z;
  t.r[0][0] = 1.0f - 2.0f * (y * y + z * z);
  t.r[0][1] = 2.0f * (x * y - w * z);
  t.r[0][2] = 2.0f * (x * z + w * y);
  t.r[1][0] = 2.0f * (x * y + w * z);
  t.r[1][1] = 1.0f - 2.0f * (x * x + z * z);
  t.r[1][2] = 2.0f * (y * z - w * x);
  t.r[2][0] = 2.0f * (x * z - w * y);
  t.r[2][1] = 2.0f * (y * z + w * x);
  t.r[2][2] = 1.0f - 2.0f * (x * x + y * y);
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

// The VJP's outputs for one gaussian
struct Grads {
  float p[3], s[3], q[4];
};

// `_project_bwd_plain` for one gaussian: the cotangents of mx, my, depth
// and the conic (a, b, c) to the gradients of its mean, scale and
// quaternion.  Zero through a `where` branch not taken, `clamp`'s
// gradient inside the closed interval, `clamp_min`'s where x >= min,
// nothing through `ceil` (the radius).
__device__ __forceinline__ Grads vjp(const Row& in, const Terms& t,
                                     const Camera& c, float g_mx, float g_my,
                                     float g_depth, float g_ca, float g_cb,
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
  const float g_xx = tt[0][0], g_yy = tt[1][1], g_zz = tt[2][2];
  const float g_xy = tt[0][1] + tt[1][0];
  const float g_xz = tt[0][2] + tt[2][0];
  const float g_yz = tt[1][2] + tt[2][1];

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
  const float g_txv = g_qx / t.safe_z;
  const float g_tyv = g_qy / t.safe_z;
  const float g_safe_z = (-g_inv_z * (t.inv_z * t.inv_z) +
                          -g_qx * (t.qx / t.safe_z)) +
                         -g_qy * (t.qy / t.safe_z);
  const float g_tz = ((g_depth + g_tx * t.cx) + g_ty * t.cy) +
                     (fabsf(t.tz) < k_z_eps() ? 0.0f : g_safe_z);

  // the view and clip coordinates -> the mean
  Grads out;
  for (int k = 0; k < 3; ++k)
    out.p[k] = ((((g_txv * vm[4 * k] + g_tyv * vm[4 * k + 1]) +
                  g_tz * vm[4 * k + 2]) +
                 g_hx * pm[4 * k]) +
                g_hy * pm[4 * k + 1]) +
               g_hw * pm[4 * k + 3];

  // Sigma's columns -> v = s^2 and R
  const float dxx = g_xx + g_xx, dyy = g_yy + g_yy, dzz = g_zz + g_zz;
  const float v[3] = {t.v0, t.v1, t.v2};
  const float s[3] = {in.s0, in.s1, in.s2};
  float g_r[3][3];
  for (int k = 0; k < 3; ++k) {
    const float c0 = t.r[0][k], c1 = t.r[1][k], c2 = t.r[2][k];
    const float g_v =
        ((((g_xx * (c0 * c0) + g_xy * (c0 * c1)) + g_xz * (c0 * c2)) +
          g_yy * (c1 * c1)) +
         g_yz * (c1 * c2)) +
        g_zz * (c2 * c2);
    out.s[k] = g_v * s[k] + g_v * s[k];
    g_r[0][k] = v[k] * ((dxx * c0 + g_xy * c1) + g_xz * c2);
    g_r[1][k] = v[k] * ((g_xy * c0 + dyy * c1) + g_yz * c2);
    g_r[2][k] = v[k] * ((g_xz * c0 + g_yz * c1) + dzz * c2);
  }

  // R -> the normalised quaternion (w, x, y, z)
  const float w = t.w, x = t.x, y = t.y, z = t.z;
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
      -(((g_w * w + g_x * x) + g_y * y) + g_z * z) / t.n;
  const float g_n_raw = t.n_raw >= k_norm_min() ? g_n : 0.0f;
  const float g_sq = g_n_raw / (2.0f * t.n_raw);
  out.q[0] = g_w / t.n + g_sq * (2.0f * in.q0);
  out.q[1] = g_x / t.n + g_sq * (2.0f * in.q1);
  out.q[2] = g_y / t.n + g_sq * (2.0f * in.q2);
  out.q[3] = g_z / t.n + g_sq * (2.0f * in.q3);
  return out;
}

}  // namespace project
