// The bilinear taps of ROI pooling, shared by the forward kernels
// (roi_align.cu) and the backward kernels (roi_align_bwd.cu), so that the
// gradients sample exactly where the forward did.
//
// Along one axis, output index j of a box with center c and size s samples
// feature pixel p_j with `_interp_weights`' arithmetic
// (imagecaptioning_tpu/ops/roi_align.py:40-61) in the same order and
// rounding (no FMA contraction):
//   theta_t = (2c - 1 - S) / (S - 1),  theta_s = s / S,
//   g = (2j + 1) / out - 1,  u = theta_s * g + theta_t,
//   p = ((u + 1) * in - 1) / 2,  p0 = floor(p),  frac = p - p0,
// and weighs pixel p0 by 1 - frac and pixel p0 + 1 by frac, each only where
// it lies in [0, in).

#pragma once

#include <cuda_runtime.h>

struct AxisSample {
  float g;            // the normalized grid coordinate g_j
  float p0, frac;     // floor(p_j) and p_j - floor(p_j)
  bool lo_ok, hi_ok;  // pixels p0 and p0 + 1 lie in [0, in)
};

// A box's theta_t and theta_s along one axis.
__device__ __forceinline__ void axis_theta(float center, float size,
                                           float image, float& theta_t,
                                           float& theta_s) {
  theta_t =
      __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(2.0f, center), 1.0f), image),
                __fsub_rn(image, 1.0f));
  theta_s = __fdiv_rn(size, image);
}

// The normalized grid coordinate g_j of output index j of `out`.
__device__ __forceinline__ float axis_grid(int j, int out) {
  return __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, static_cast<float>(j)), 1.0f),
                static_cast<float>(out)),
      1.0f);
}

// The sample at grid coordinate g of a box with (theta_t, theta_s), over
// `in` pixels.
__device__ __forceinline__ AxisSample axis_sample_at(float theta_t,
                                                     float theta_s, float g,
                                                     int in) {
  AxisSample s;
  s.g = g;
  const float u = __fadd_rn(__fmul_rn(theta_s, g), theta_t);
  // halving is exact, so x * 0.5 is the correctly rounded x / 2, and the
  // chain waits on one division less
  const float p = __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), static_cast<float>(in)), 1.0f),
      0.5f);
  s.p0 = floorf(p);
  s.frac = __fsub_rn(p, s.p0);
  const float last = static_cast<float>(in - 1);
  s.lo_ok = s.p0 >= 0.0f && s.p0 <= last;
  s.hi_ok = s.p0 >= -1.0f && s.p0 <= last - 1.0f;
  return s;
}

__device__ __forceinline__ AxisSample axis_sample(float center, float size,
                                                  int j, int out, int in,
                                                  float image) {
  float theta_t, theta_s;
  axis_theta(center, size, image, theta_t, theta_s);
  return axis_sample_at(theta_t, theta_s, axis_grid(j, out), in);
}

struct Tap {
  int lo, hi;        // the two pixels' indices times a stride (0 outside)
  float w_lo, w_hi;  // their weights (0 outside)
};

// The two taps of output index j along one axis. A tap outside [0, in) gets
// weight 0 and offset 0 (a valid address whose value is never used).
// Offsets are the pixel index times `stride`: the axis' stride in elements
// for the forward's loads, 1 for a pixel index.
__device__ __forceinline__ Tap axis_taps(float center, float size, int j,
                                         int out, int in, float image,
                                         int stride) {
  const AxisSample s = axis_sample(center, size, j, out, in, image);
  Tap t;
  t.lo = s.lo_ok ? static_cast<int>(s.p0) * stride : 0;
  t.hi = s.hi_ok ? (static_cast<int>(s.p0) + 1) * stride : 0;
  t.w_lo = s.lo_ok ? __fsub_rn(1.0f, s.frac) : 0.0f;
  t.w_hi = s.hi_ok ? s.frac : 0.0f;
  return t;
}
