// Bilinear ROI pooling, forward, written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of imagecaptioning_tpu/ops/roi_align.py:
//   K1 roi_align_batch_pallas_fwd (pallas_call at :204): N images x R boxes;
//   K2 roi_align_pallas_fwd      (pallas_call at :127): the N = 1 case.
//
// What it computes: for image n, box r = (xc, yc, w, h) in 1-indexed image
// coordinates, channel c and output cell (y, x):
//   out[n, r, y, x, c] = sum_h sum_w Ry[y, h] * F[n, h, w, c] * Cx[x, w]
// where each row of Ry / Cx holds the two bilinear taps of `_interp_weights`
// (roi_align.py:40-61) and is zero outside the map. This is
// affine_grid + grid_sample(align_corners=False, padding_mode='zeros') under
// the reference's BoxToAffine theta.
//
// Design. The TPU kernel builds dense (oh x Hf) / (ow x Wf) weight matrices
// outside the kernel and runs two MXU products per box. Every output element
// is only the sum of at most four taps, so here one thread computes one
// (n, r, y, x, c) from its box's taps, computed in-kernel with the same float
// arithmetic as `_interp_weights`. `c` is the fastest index, so a warp reads
// 32 neighbouring floats of the NHWC feature map and writes 32 neighbouring
// floats of the output.
//
// Bound on the H100: bytes. Per output element it does 6 flops (3 FMAs) and
// writes 4 bytes, so the least time is the feature map read once plus the
// output written once over 3.35 TB/s. At the serving slice's shapes (N=8,
// R=32, 16x16x512 -> 7x7) that is 4.19 MB + 25.7 MB = 29.9 MB, about 8.9 us.
// Staging each image's map in shared memory and pooling several boxes per
// block would cut the repeated tap arithmetic and the L2 traffic of the
// feature reads; the compulsory output write keeps the bound where it is.
//
// Interface: a plain C entry point (bound with ctypes). It launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The two taps of output index j along one axis, with `_interp_weights`'
// arithmetic in the same order and rounding (no FMA contraction):
//   theta_t = (2c - 1 - S) / (S - 1),  theta_s = s / S,
//   g = (2j + 1) / out - 1,  u = theta_s * g + theta_t,
//   p = ((u + 1) * in - 1) / 2,  p0 = floor(p),  frac = p - p0.
// A tap outside [0, in) gets weight 0 and index 0 (never read).
struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Taps axis_taps(float center, float size, int j,
                                          int out, int in, float image) {
  const float theta_t =
      __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(2.0f, center), 1.0f), image),
                __fsub_rn(image, 1.0f));
  const float theta_s = __fdiv_rn(size, image);
  const float g = __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, static_cast<float>(j)), 1.0f),
                static_cast<float>(out)),
      1.0f);
  const float u = __fadd_rn(__fmul_rn(theta_s, g), theta_t);
  const float p = __fdiv_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), static_cast<float>(in)), 1.0f),
      2.0f);
  const float p0 = floorf(p);
  const float frac = __fsub_rn(p, p0);
  const float last = static_cast<float>(in - 1);
  Taps t;
  const bool lo_ok = p0 >= 0.0f && p0 <= last;
  const bool hi_ok = p0 >= -1.0f && p0 <= last - 1.0f;
  t.lo = lo_ok ? static_cast<int>(p0) : 0;
  t.hi = hi_ok ? static_cast<int>(p0) + 1 : 0;
  t.w_lo = lo_ok ? __fsub_rn(1.0f, frac) : 0.0f;
  t.w_hi = hi_ok ? frac : 0.0f;
  return t;
}

__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const float* __restrict__ feat,
                     const float* __restrict__ boxes,
                     float* __restrict__ out, int R, int Hf, int Wf, int C,
                     int oh, int ow, float ih, float iw, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int c = static_cast<int>(i % C);
    long long rest = i / C;
    const int x = static_cast<int>(rest % ow);
    rest /= ow;
    const int y = static_cast<int>(rest % oh);
    const long long box = rest / oh;  // n * R + r
    const long long n = box / R;

    const float* b = boxes + box * 4;
    const Taps ty = axis_taps(b[1], b[3], y, oh, Hf, ih);
    const Taps tx = axis_taps(b[0], b[2], x, ow, Wf, iw);

    const float* f = feat + n * Hf * Wf * C + c;
    const long long row_lo = static_cast<long long>(ty.lo) * Wf * C;
    const long long row_hi = static_cast<long long>(ty.hi) * Wf * C;
    const long long col_lo = static_cast<long long>(tx.lo) * C;
    const long long col_hi = static_cast<long long>(tx.hi) * C;

    // Rows first (Ry . F), then columns (. Cx^T), as the TPU kernel does.
    // A zero-weight tap is skipped, never multiplied.
    float at_lo = 0.0f, at_hi = 0.0f;
    if (tx.w_lo != 0.0f) {
      if (ty.w_lo != 0.0f) at_lo = ty.w_lo * f[row_lo + col_lo];
      if (ty.w_hi != 0.0f) at_lo = fmaf(ty.w_hi, f[row_hi + col_lo], at_lo);
    }
    if (tx.w_hi != 0.0f) {
      if (ty.w_lo != 0.0f) at_hi = ty.w_lo * f[row_lo + col_hi];
      if (ty.w_hi != 0.0f) at_hi = fmaf(ty.w_hi, f[row_hi + col_hi], at_hi);
    }
    out[i] = fmaf(tx.w_hi, at_hi, tx.w_lo * at_lo);
  }
}

}  // namespace

extern "C" int roi_align_fwd(const void* features, const void* boxes,
                             void* out, int n, int r, int hf, int wf, int c,
                             int oh, int ow, float ih, float iw,
                             void* stream) {
  const long long total = static_cast<long long>(n) * r * oh * ow * c;
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // grid-stride covers the rest
  roi_align_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(features), static_cast<const float*>(boxes),
      static_cast<float*>(out), r, hf, wf, c, oh, ow, ih, iw, total);
  return static_cast<int>(cudaGetLastError());
}
