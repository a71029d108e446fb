// Bilinear ROI pooling, backward, written for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernel K1 (roi_align_batch_pallas_fwd):
// the custom_vjp `_bbwd` of imagecaptioning_tpu/ops/roi_align.py:234-242,
// which takes jax.vjp of the einsum form
//   out[n, r, y, x, c] = sum_h sum_w Ry[r, y, h] * F[n, h, w, c] * Cx[r, x, w]
// with respect to the features AND the boxes. Ry / Cx hold each output
// row's / column's two bilinear taps (roi_taps.cuh, shared with the
// forward, so both sample the same pixels with the same weights).
//
// Two entries, each one launch:
//   roi_align_bwd_features  d_F[n, h, w, c] =
//       sum_r sum_y Ry[r, y, h] * sum_x Cx[r, x, w] * g[n, r, y, x, c],
//       summed in fp32 and written once in the features' dtype (fp32, or
//       bf16 rounded to nearest even: JAX's fp32 VJP, then its cast's VJP);
//   roi_align_bwd_boxes     d_boxes[n, r, :] (fp32), the chain rule read off
//       `_interp_weights` (roi_align.py:40-61): d w_lo / d frac = -1 at p0
//       and d w_hi / d frac = +1 at p0 + 1, each only where that pixel lies
//       in the map (floor has no gradient); dp/du = in / 2; du/d theta_t = 1,
//       du/d theta_s = g_j; d theta_t / dc = 2 / (S - 1), d theta_s / ds = 1/S.
//       Rows give (yc, h), columns (xc, w).
// The upstream gradient g is fp32 or bf16, either NHWC (N, R, oh, ow, C), the
// TPU kernel's output layout, or CHW-flattened (N, R, C*oh*ow), fc6's input
// as the fused forward entry writes it.
//
// Bound on the H100: bytes. Kernel A reads g once and writes d_F once (at the
// training shape, 4 images x 32 boxes of a 22x22x512 bf16 map: 6.4 MB + 2.0
// MB over 3.35 TB/s, about 2.5 us); kernel B reads g and, at four taps per
// output cell, about as much of the map.
//
// Design (simple and right first; making them fast is later work):
// - Kernel A is a gather: each thread owns feature elements (n, h, w, c) and
//   sums what reaches them, so no float atomics are needed and two launches
//   give the same bits. Block (32 channels, 8 column lanes) per (channel
//   chunk, row h, 32-column tile, image): the box taps are computed once per
//   block into shared memory, in groups of boxes that fit; warp 0 then lists
//   the (box, output row) pairs whose row taps hit h, in (box, row) order
//   with a ballot; each thread walks that list and, for each pair, the
//   box's column taps. A warp's 32 lanes are 32 channels of one column, so
//   every branch is taken by the whole warp and NHWC loads coalesce (CHW
//   loads stride by oh*ow and lean on L1).
// - Kernel B: one block per box. Each thread takes channels and, per output
//   cell, forms d out / d frac_y and d out / d frac_x from the cell's four
//   taps, weighted by g; per-thread partial sums per output row and column
//   sit in shared memory and are reduced in a fixed order (lane-strided
//   sums, then a shuffle tree), so the result is the same on every launch.
//
// Interface: plain C entry points (bound with ctypes). They launch on the
// caller's stream, allocate nothing, do not synchronise, and return
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_taps.cuh"

namespace {

constexpr int kMaxGrid = 65535;      // gridDim.y and gridDim.z
// dynamic shared memory without opt-in, less the kernels' static arrays
constexpr int kSmemMax = 48 * 1024 - 256;
constexpr int kLanes = 32;           // kernel A: channels per block
constexpr int kRows = 8;             // kernel A: column lanes per block
constexpr int kTile = 32;            // kernel A: columns per block
constexpr int kSlots = kTile / kRows;
constexpr int kBoxThreads = 256;     // kernel B

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element offset of g[n, r, y, x, c] in either layout (n and r folded into
// `box` = n * R + r).
template <bool kChw>
__device__ __forceinline__ int grad_offset(int box, int y, int x, int c,
                                           int oh, int ow, int C) {
  return kChw ? (box * C + c) * (oh * ow) + y * ow + x
              : ((box * oh + y) * ow + x) * C + c;
}

struct RowHit {
  int box, y;  // box within the group, output row
  float w;     // the row tap's weight at this block's feature row
};

// Kernel A. Block (i, t, n): channels [32 i, 32 i + 32), feature row
// h = t / tiles, columns [32 (t % tiles), +32), image n.
template <typename GT, typename FT, bool kChw>
__global__ void __launch_bounds__(kLanes * kRows)
roi_bwd_features_kernel(const GT* __restrict__ grad,
                        const float* __restrict__ boxes, FT* __restrict__ dF,
                        int R, int Hf, int Wf, int C, int oh, int ow,
                        float ih, float iw, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* cols = reinterpret_cast<Tap*>(smem);         // group * ow
  Tap* rows = cols + group * ow;                     // group * oh
  RowHit* hits = reinterpret_cast<RowHit*>(rows + group * oh);
  __shared__ int n_hits;

  const int tiles = (Wf + kTile - 1) / kTile;
  const int h = blockIdx.y / tiles;
  const int wbase = (blockIdx.y - h * tiles) * kTile + threadIdx.y;
  const int c = blockIdx.x * kLanes + threadIdx.x;
  const int n = blockIdx.z;
  const int tid = threadIdx.y * kLanes + threadIdx.x;

  float acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;

  for (int r0 = 0; r0 < R; r0 += group) {
    const int nb = min(group, R - r0);
    // taps as pixel indices (stride 1): columns, then rows
    for (int i = tid; i < nb * (ow + oh); i += kLanes * kRows) {
      const bool col = i < nb * ow;
      const int k = col ? i : i - nb * ow;
      const int out = col ? ow : oh;
      const int b = k / out;
      const float* box = boxes + (n * R + r0 + b) * 4;
      (col ? cols : rows)[k] =
          axis_taps(col ? box[0] : box[1], col ? box[2] : box[3],
                    k - b * out, out, col ? Wf : Hf, col ? iw : ih, 1);
    }
    __syncthreads();
    // warp 0 lists the (box, row) pairs whose row taps hit h, in order
    if (tid < 32) {
      int count = 0;
      for (int base = 0; base < nb * oh; base += 32) {
        const int i = base + tid;
        float w = 0.0f;
        if (i < nb * oh) {
          const Tap t = rows[i];
          w = t.w_lo != 0.0f && t.lo == h ? t.w_lo
              : t.w_hi != 0.0f && t.hi == h ? t.w_hi : 0.0f;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, w != 0.0f);
        if (w != 0.0f) {
          const int b = i / oh;
          hits[count + __popc(hit & ((1u << tid) - 1u))] = {b, i - b * oh, w};
        }
        count += __popc(hit);
      }
      if (tid == 0) n_hits = count;
    }
    __syncthreads();

    if (c < C) {
      for (int e = 0; e < n_hits; ++e) {
        const RowHit hit = hits[e];
        const int box = n * R + r0 + hit.box;
        float inner[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) inner[k] = 0.0f;
        for (int x = 0; x < ow; ++x) {
          const Tap t = cols[hit.box * ow + x];
          // at most one of the two taps falls on this thread's columns
          // wbase, wbase + 8, ... (they are 8 apart, the taps 1)
          const int dlo = t.lo - wbase, dhi = t.hi - wbase;
          int slot = -1;
          float wx = 0.0f;
          if (t.w_lo != 0.0f && dlo >= 0 && dlo < kTile && dlo % kRows == 0) {
            slot = dlo / kRows;
            wx = t.w_lo;
          } else if (t.w_hi != 0.0f && dhi >= 0 && dhi < kTile &&
                     dhi % kRows == 0) {
            slot = dhi / kRows;
            wx = t.w_hi;
          }
          if (slot >= 0) {
            const float gv =
                widen(grad[grad_offset<kChw>(box, hit.y, x, c, oh, ow, C)]);
#pragma unroll
            for (int k = 0; k < kSlots; ++k)
              if (k == slot) inner[k] = fmaf(wx, gv, inner[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) acc[k] = fmaf(hit.w, inner[k], acc[k]);
      }
    }
    __syncthreads();  // the next group overwrites the taps and the list
  }

  if (c < C) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int w = wbase + k * kRows;
      if (w < Wf) dF[((n * Hf + h) * Wf + w) * C + c] = narrow<FT>(acc[k]);
    }
  }
}

// Kernel B. Block (r, n): box r of image n.
template <typename GT, typename T, bool kChw>
__global__ void __launch_bounds__(kBoxThreads)
roi_bwd_boxes_kernel(const T* __restrict__ feat,
                     const float* __restrict__ boxes,
                     const GT* __restrict__ grad, float* __restrict__ d_boxes,
                     int R, int Hf, int Wf, int C, int oh, int ow, float ih,
                     float iw) {
  extern __shared__ __align__(16) unsigned char smem[];
  AxisSample* samples = reinterpret_cast<AxisSample*>(smem);  // oh, then ow
  float* part = reinterpret_cast<float*>(samples + oh + ow);  // (oh+ow) x 256
  __shared__ float total[64];

  const int box = blockIdx.y * R + blockIdx.x;
  const int tid = threadIdx.x;
  const float* b = boxes + box * 4;
  for (int i = tid; i < oh + ow; i += kBoxThreads) {
    const bool row = i < oh;
    samples[i] = axis_sample(row ? b[1] : b[0], row ? b[3] : b[2],
                             row ? i : i - oh, row ? oh : ow, row ? Hf : Wf,
                             row ? ih : iw);
  }
  for (int i = tid; i < (oh + ow) * kBoxThreads; i += kBoxThreads)
    part[i] = 0.0f;
  __syncthreads();

  const T* f = feat + blockIdx.y * Hf * Wf * C;
  for (int y = 0; y < oh; ++y) {
    const AxisSample sy = samples[y];
    const int y0 = static_cast<int>(sy.p0);
    const float wy_lo = sy.lo_ok ? 1.0f - sy.frac : 0.0f;
    const float wy_hi = sy.hi_ok ? sy.frac : 0.0f;
    for (int x = 0; x < ow; ++x) {
      const AxisSample sx = samples[oh + x];
      const int x0 = static_cast<int>(sx.p0);
      const float wx_lo = sx.lo_ok ? 1.0f - sx.frac : 0.0f;
      const float wx_hi = sx.hi_ok ? sx.frac : 0.0f;
      float dy = 0.0f, dx = 0.0f;
      for (int c = tid; c < C; c += kBoxThreads) {
        // the cell's four taps, zero where a pixel lies outside the map
        const float f00 = sy.lo_ok && sx.lo_ok
                              ? widen(f[(y0 * Wf + x0) * C + c]) : 0.0f;
        const float f01 = sy.lo_ok && sx.hi_ok
                              ? widen(f[(y0 * Wf + x0 + 1) * C + c]) : 0.0f;
        const float f10 = sy.hi_ok && sx.lo_ok
                              ? widen(f[((y0 + 1) * Wf + x0) * C + c]) : 0.0f;
        const float f11 = sy.hi_ok && sx.hi_ok
                              ? widen(f[((y0 + 1) * Wf + x0 + 1) * C + c])
                              : 0.0f;
        const float gv =
            widen(grad[grad_offset<kChw>(box, y, x, c, oh, ow, C)]);
        // d out / d frac_y = sum_w Cx[x, w] (F[y0 + 1, w] - F[y0, w]), and
        // the same across for frac_x
        dy = fmaf(gv, wx_lo * (f10 - f00) + wx_hi * (f11 - f01), dy);
        dx = fmaf(gv, wy_lo * (f01 - f00) + wy_hi * (f11 - f10), dx);
      }
      part[y * kBoxThreads + tid] += dy;
      part[(oh + x) * kBoxThreads + tid] += dx;
    }
  }
  __syncthreads();

  // total[k] = sum over threads of part[k], in a fixed order
  const int warp = tid / 32, lane = tid % 32;
  for (int k = warp; k < oh + ow; k += kBoxThreads / 32) {
    float s = 0.0f;
    for (int i = lane; i < kBoxThreads; i += 32) s += part[k * kBoxThreads + i];
#pragma unroll
    for (int d = 16; d > 0; d /= 2) s += __shfl_down_sync(0xffffffffu, s, d);
    if (lane == 0) total[k] = s;
  }
  __syncthreads();

  if (tid < 2) {
    // tid 0: rows -> (yc, h); tid 1: columns -> (xc, w)
    const bool row = tid == 0;
    const int first = row ? 0 : oh, out = row ? oh : ow;
    const float in = static_cast<float>(row ? Hf : Wf);
    const float image = row ? ih : iw;
    float d_t = 0.0f, d_s = 0.0f;
    for (int j = 0; j < out; ++j) {
      // p = ((u + 1) * in - 1) / 2
      const float du = total[first + j] * 0.5f * in;
      d_t += du;
      d_s = fmaf(du, samples[first + j].g, d_s);
    }
    // theta_t = (2c - 1 - S) / (S - 1), theta_s = s / S
    d_boxes[box * 4 + (row ? 1 : 0)] = __fdiv_rn(d_t, image - 1.0f) * 2.0f;
    d_boxes[box * 4 + (row ? 3 : 2)] = __fdiv_rn(d_s, image);
  }
}

template <typename GT, typename FT, bool kChw>
int launch_features(const void* grad, const void* boxes, void* dF, int n,
                    int r, int hf, int wf, int c, int oh, int ow, float ih,
                    float iw, cudaStream_t stream) {
  const int per_box = static_cast<int>((oh + ow) * sizeof(Tap) +
                                       oh * sizeof(RowHit));
  const int group = r > 0 ? min(r, kSmemMax / per_box) : 1;
  const long long rows = static_cast<long long>(hf) * ((wf + kTile - 1) / kTile);
  if (group < 1 || rows > kMaxGrid || n > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kLanes - 1) / kLanes, static_cast<unsigned>(rows), n);
  roi_bwd_features_kernel<GT, FT, kChw>
      <<<grid, dim3(kLanes, kRows), group * per_box, stream>>>(
          static_cast<const GT*>(grad), static_cast<const float*>(boxes),
          static_cast<FT*>(dF), r, hf, wf, c, oh, ow, ih, iw, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename GT, typename T, bool kChw>
int launch_boxes(const void* feat, const void* boxes, const void* grad,
                 void* d_boxes, int n, int r, int hf, int wf, int c, int oh,
                 int ow, float ih, float iw, cudaStream_t stream) {
  const int smem = static_cast<int>((oh + ow) * (sizeof(AxisSample) +
                                                 kBoxThreads * sizeof(float)));
  if (oh + ow > 64 || smem > kSmemMax || n > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  roi_bwd_boxes_kernel<GT, T, kChw><<<dim3(r, n), kBoxThreads, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(boxes),
      static_cast<const GT*>(grad), static_cast<float*>(d_boxes), r, hf, wf,
      c, oh, ow, ih, iw);
  return static_cast<int>(cudaGetLastError());
}

// The gradient's type and layout pick the instance: GT in {fp32, bf16},
// kChw in {NHWC, CHW}.
template <template <typename, typename, bool> class Launch, typename Other,
          typename... Args>
int by_grad(int grad_bf16, int grad_chw, Args... args) {
  if (grad_bf16)
    return grad_chw ? Launch<__nv_bfloat16, Other, true>::run(args...)
                    : Launch<__nv_bfloat16, Other, false>::run(args...);
  return grad_chw ? Launch<float, Other, true>::run(args...)
                  : Launch<float, Other, false>::run(args...);
}

template <typename GT, typename FT, bool kChw>
struct Features {
  template <typename... Args>
  static int run(Args... args) {
    return launch_features<GT, FT, kChw>(args...);
  }
};

template <typename GT, typename T, bool kChw>
struct Boxes {
  template <typename... Args>
  static int run(Args... args) {
    return launch_boxes<GT, T, kChw>(args...);
  }
};

}  // namespace

// grad (n, r, oh, ow, c) NHWC or (n, r, c * oh * ow) CHW (grad_chw), fp32 or
// bf16 (grad_bf16); boxes (n, r, 4) fp32 -> d_features (n, hf, wf, c), fp32
// or bf16 (out_bf16).
extern "C" int roi_align_bwd_features(const void* grad, const void* boxes,
                                      void* d_features, int n, int r, int hf,
                                      int wf, int c, int oh, int ow, float ih,
                                      float iw, int grad_bf16, int grad_chw,
                                      int out_bf16, void* stream) {
  if (static_cast<long long>(n) * hf * wf * c == 0)
    return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  return out_bf16
             ? by_grad<Features, __nv_bfloat16>(grad_bf16, grad_chw, grad,
                                                boxes, d_features, n, r, hf,
                                                wf, c, oh, ow, ih, iw, s)
             : by_grad<Features, float>(grad_bf16, grad_chw, grad, boxes,
                                        d_features, n, r, hf, wf, c, oh, ow,
                                        ih, iw, s);
}

// features (n, hf, wf, c) fp32 or bf16 (feat_bf16), boxes (n, r, 4) fp32,
// grad as above -> d_boxes (n, r, 4) fp32.
extern "C" int roi_align_bwd_boxes(const void* features, const void* boxes,
                                   const void* grad, void* d_boxes, int n,
                                   int r, int hf, int wf, int c, int oh,
                                   int ow, float ih, float iw, int feat_bf16,
                                   int grad_bf16, int grad_chw, void* stream) {
  if (static_cast<long long>(n) * r == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  return feat_bf16
             ? by_grad<Boxes, __nv_bfloat16>(grad_bf16, grad_chw, features,
                                             boxes, grad, d_boxes, n, r, hf,
                                             wf, c, oh, ow, ih, iw, s)
             : by_grad<Boxes, float>(grad_bf16, grad_chw, features, boxes,
                                     grad, d_boxes, n, r, hf, wf, c, oh, ow,
                                     ih, iw, s);
}
