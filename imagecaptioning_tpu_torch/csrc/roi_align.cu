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
// the reference's BoxToAffine theta. Features are fp32 or bf16 (bf16 is
// widened in registers, exactly, as JAX's astype(float32) is); boxes fp32.
//
// Two epilogues of the same sum:
//   roi_align_fwd      (N, R, oh, ow, C) fp32, NHWC: the TPU kernels' output;
//   roi_align_chw_fwd  (N, R, C*oh*ow) fp32 or bf16: each box's code
//                      flattened in the reference's CHW order, i.e. the VGG
//                      classifier's fc6 input. The serving path needs no
//                      widening, transpose or narrowing pass around it.
//
// Bound on the H100: bytes. Per output element it does 6 flops (3 FMAs) and
// writes 2 or 4 bytes, so the least time is the feature map read once plus
// the output written once over 3.35 TB/s. At the serving shape (N=8, R=32,
// 16x16x512 -> 7x7): bf16 map in, bf16 CHW codes out is 2.1 MB + 12.8 MB,
// about 4.5 us; fp32 in, fp32 NHWC out 4.2 MB + 25.7 MB, about 8.9 us.
//
// Design, against that bound:
// - One block per (box, chunk of channels), on a (chunks, R, N) grid, so no
//   block divides to find its box. A chunk is 128 channels where that still
//   gives every SM four blocks (1,024 blocks at the serving shape), else 64
//   (256 blocks for one 720^2 canvas, so even N=1 puts work on every SM).
// - The box's oh + ow tap records (the two taps as element offsets into the
//   map, and their weights) are computed once per block into shared memory,
//   with `_interp_weights`' arithmetic and rounding. No output element does
//   a division; indexing is 32-bit (the wrapper refuses larger shapes).
// - threadIdx.x walks the chunk's channels 16 bytes at a time (4 fp32 or 8
//   bf16; one at a time where C or the map's address does not allow it),
//   threadIdx.y walks the output cells. A warp reads whole 128-512 byte runs
//   of a feature pixel; the taps that neighbouring cells share hit L1, so
//   device memory sees the map about once. A cell's four loads come before
//   its arithmetic, and its zero-weight branches are taken by the
//   whole vector.
// - The CHW epilogue stages the block's (chunk, oh, ow) slab in shared
//   memory. It is one contiguous run of the CHW row, written back with
//   16-byte stores (scalar only at a misaligned head or tail).
//
// What holds it back on the card, measured, is in PERF.md (Findings): the
// block's instruction stream and its staged write-out, not device memory.
//
// Interface: plain C entry points (bound with ctypes). They launch on the
// caller's stream, allocate nothing, do not synchronise, and return
// cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 65535;         // gridDim.y and gridDim.z
constexpr int kSmemMax = 48 * 1024;     // dynamic shared memory without opt-in

struct Tap {
  int lo, hi;        // element offsets of the two taps (0 where outside)
  float w_lo, w_hi;  // their weights (0 where outside)
};

// The two taps of output index j along one axis, with `_interp_weights`'
// arithmetic in the same order and rounding (no FMA contraction):
//   theta_t = (2c - 1 - S) / (S - 1),  theta_s = s / S,
//   g = (2j + 1) / out - 1,  u = theta_s * g + theta_t,
//   p = ((u + 1) * in - 1) / 2,  p0 = floor(p),  frac = p - p0.
// A tap outside [0, in) gets weight 0 and offset 0 (a valid address whose
// value is never used). Offsets are
// the pixel index times `stride`, the axis' stride in elements.
__device__ __forceinline__ Tap axis_taps(float center, float size, int j,
                                         int out, int in, float image,
                                         int stride) {
  const float theta_t =
      __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(2.0f, center), 1.0f), image),
                __fsub_rn(image, 1.0f));
  const float theta_s = __fdiv_rn(size, image);
  const float g = __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, static_cast<float>(j)), 1.0f),
                static_cast<float>(out)),
      1.0f);
  const float u = __fadd_rn(__fmul_rn(theta_s, g), theta_t);
  // halving is exact, so x * 0.5 is the correctly rounded x / 2, and the
  // chain waits on one division less
  const float p = __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(u, 1.0f), static_cast<float>(in)), 1.0f),
      0.5f);
  const float p0 = floorf(p);
  const float frac = __fsub_rn(p, p0);
  const float last = static_cast<float>(in - 1);
  Tap t;
  const bool lo_ok = p0 >= 0.0f && p0 <= last;
  const bool hi_ok = p0 >= -1.0f && p0 <= last - 1.0f;
  t.lo = lo_ok ? static_cast<int>(p0) * stride : 0;
  t.hi = hi_ok ? (static_cast<int>(p0) + 1) * stride : 0;
  t.w_lo = lo_ok ? __fsub_rn(1.0f, frac) : 0.0f;
  t.w_hi = hi_ok ? frac : 0.0f;
  return t;
}

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
  return __float2bfloat16_rn(v);  // round to nearest even, as .to(bfloat16)
}

// VEC consecutive elements at p, widened to fp32: one 16-byte load where VEC
// elements fill 16 bytes (p is then 16-byte aligned), else VEC scalar loads.
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 raw = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // little-endian: the low half comes first
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ void load(const T* p, float (&v)[1]) {
  v[0] = widen(__ldg(p));
}

// Copy the staged run src[0, n) to dst[0, n): scalar up to dst's first
// 16-byte boundary (`head` elements), 16-byte stores, then a scalar tail.
// src + head is 16-byte aligned (the kernel stages the run that way), so the
// body reads shared memory 16 bytes at a time too.
template <typename OutT>
__device__ __forceinline__ void write_run(OutT* __restrict__ dst,
                                          const OutT* __restrict__ src, int n,
                                          int head, int tid, int nthreads) {
  constexpr int kV = 16 / sizeof(OutT);
  head = min(head, n);
  const int body = (n - head) / kV;
  for (int i = tid; i < head; i += nthreads) dst[i] = src[i];
  const uint4* s = reinterpret_cast<const uint4*>(src + head);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int i = tid; i < body; i += nthreads) d[i] = s[i];
  for (int i = head + body * kV + tid; i < n; i += nthreads) dst[i] = src[i];
}

// Block (i, r, n) pools box r of image n, channels [c0, c0 + chunk) with
// c0 = i * chunk, chunk = blockDim.x * VEC and blockDim.x * blockDim.y =
// kThreads.
// kChw: stage the (chunk, oh, ow) slab and write it as one CHW run; else
// write (oh, ow, chunk) straight into the NHWC output (OutT = float).
template <typename T, int VEC, typename OutT, bool kChw>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ boxes,
                 OutT* __restrict__ out, int Hf, int Wf, int C, int oh, int ow,
                 float ih, float iw) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* taps = reinterpret_cast<Tap*>(smem);  // oh rows, then ow columns
  const int chunk = blockDim.x * VEC;
  const int box = blockIdx.z * gridDim.y + blockIdx.y;
  const int c0 = blockIdx.x * chunk;
  const int cb = min(chunk, C - c0);
  const int ohw = oh * ow;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  // rows (y: yc, h) then columns (x: xc, w); the axis is picked by
  // selecting the arguments, so the two axes do not diverge
  const float* b = boxes + box * 4;
  for (int i = tid; i < oh + ow; i += kThreads) {
    const bool row = i < oh;
    taps[i] = axis_taps(row ? b[1] : b[0], row ? b[3] : b[2],
                        row ? i : i - oh, row ? oh : ow, row ? Hf : Wf,
                        row ? ih : iw, row ? Wf * C : C);
  }

  // CHW: this block's run of the output row, and where it is staged so that
  // the run's first 16-byte boundary in device memory falls on one in
  // shared memory too.
  OutT* run = out + (box * C + c0) * ohw;
  constexpr int kV = 16 / sizeof(OutT);
  const int head = static_cast<int>(
      (16 - reinterpret_cast<uintptr_t>(run) % 16) % 16 / sizeof(OutT));
  OutT* stage = reinterpret_cast<OutT*>(taps + oh + ow) + (kV - head) % kV;
  __syncthreads();

  const int cl = threadIdx.x * VEC;  // this thread's channels: c0 + cl + k
  if (cl < cb) {
    const T* f = feat + blockIdx.z * Hf * Wf * C + c0 + cl;
    // cell = y * ow + x, advanced by blockDim.y without dividing per cell
    const int dy = blockDim.y / ow, dx = blockDim.y - dy * ow;
    int y = threadIdx.y / ow, x = threadIdx.y - (threadIdx.y / ow) * ow;
    for (int cell = threadIdx.y; cell < ohw; cell += blockDim.y) {
      const Tap ty = taps[y], tx = taps[oh + x];
      // All four taps are loaded before any arithmetic; a tap outside the
      // map has offset 0, a valid address, and its value is never used.
      float v00[VEC], v10[VEC], v01[VEC], v11[VEC];
      load(f + ty.lo + tx.lo, v00);
      load(f + ty.hi + tx.lo, v10);
      load(f + ty.lo + tx.hi, v01);
      load(f + ty.hi + tx.hi, v11);
      // Rows first (Ry . F), then columns (. Cx^T), as the TPU kernel does.
      // A zero-weight tap is skipped, never multiplied; the weights are the
      // cell's, so each branch is taken by the whole vector.
      float at_lo[VEC], at_hi[VEC], v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) at_lo[k] = at_hi[k] = 0.0f;
      if (tx.w_lo != 0.0f) {
        if (ty.w_lo != 0.0f) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) at_lo[k] = ty.w_lo * v00[k];
        }
        if (ty.w_hi != 0.0f) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) at_lo[k] = fmaf(ty.w_hi, v10[k], at_lo[k]);
        }
      }
      if (tx.w_hi != 0.0f) {
        if (ty.w_lo != 0.0f) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) at_hi[k] = ty.w_lo * v01[k];
        }
        if (ty.w_hi != 0.0f) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) at_hi[k] = fmaf(ty.w_hi, v11[k], at_hi[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float res = fmaf(tx.w_hi, at_hi[k], tx.w_lo * at_lo[k]);
        if constexpr (kChw) {
          stage[(cl + k) * ohw + cell] = narrow<OutT>(res);
        } else {
          v[k] = res;
        }
      }
      if constexpr (!kChw) {
        float* o = out + ((box * oh + y) * ow + x) * C + c0 + cl;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
          for (int q = 0; q < VEC; q += 4)
            *reinterpret_cast<float4*>(o + q) =
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) o[k] = v[k];
        }
      }
      x += dx;
      y += dy;
      if (x >= ow) {
        x -= ow;
        ++y;
      }
    }
  }
  if constexpr (kChw) {
    __syncthreads();
    write_run(run, stage, cb * ohw, head, tid, kThreads);
  }
}

template <typename T, int VEC, typename OutT, bool kChw>
int launch(const void* feat, const void* boxes, void* out, int n, int r,
           int hf, int wf, int c, int oh, int ow, float ih, float iw,
           cudaStream_t stream) {
  // CHW stages chunk * oh * ow outputs (plus 16 bytes of alignment slack);
  // halve the chunk until the block's shared memory fits.
  auto smem = [&](int chunk) {
    return static_cast<int>(
        (oh + ow) * sizeof(Tap) +
        (kChw ? (chunk * oh * ow + 16 / sizeof(OutT)) * sizeof(OutT) : 0));
  };
  // 128 channels a block where that still gives every SM four blocks (each
  // block then computes its taps for twice the work), else 64.
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int chunk = static_cast<long long>(n) * r * ((c + 127) / 128) >= 4 * sms
                  ? 128 : 64;
  while (chunk > VEC && smem(chunk) > kSmemMax) chunk /= 2;
  if (smem(chunk) > kSmemMax || r > kMaxGrid || n > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + chunk - 1) / chunk, r, n);
  const dim3 block(chunk / VEC, kThreads * VEC / chunk);
  roi_align_kernel<T, VEC, OutT, kChw><<<grid, block, smem(chunk), stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(boxes),
      static_cast<OutT*>(out), hf, wf, c, oh, ow, ih, iw);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads (and NHWC stores) where C and the addresses allow them.
template <typename OutT, bool kChw>
int dispatch(const void* feat, const void* boxes, void* out, int n, int r,
             int hf, int wf, int c, int oh, int ow, float ih, float iw,
             int feat_bf16, void* stream) {
  if (static_cast<long long>(n) * r * c * oh * ow == 0)
    return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                       (kChw || reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (feat_bf16) {
    using T = __nv_bfloat16;
    return aligned && c % 8 == 0
               ? launch<T, 8, OutT, kChw>(feat, boxes, out, n, r, hf, wf, c,
                                          oh, ow, ih, iw, s)
               : launch<T, 1, OutT, kChw>(feat, boxes, out, n, r, hf, wf, c,
                                          oh, ow, ih, iw, s);
  }
  return aligned && c % 4 == 0
             ? launch<float, 4, OutT, kChw>(feat, boxes, out, n, r, hf, wf, c,
                                            oh, ow, ih, iw, s)
             : launch<float, 1, OutT, kChw>(feat, boxes, out, n, r, hf, wf, c,
                                            oh, ow, ih, iw, s);
}

}  // namespace

// features (n, hf, wf, c) fp32 or bf16 (feat_bf16), boxes (n, r, 4) fp32
// -> out (n, r, oh, ow, c) fp32.
extern "C" int roi_align_fwd(const void* features, const void* boxes,
                             void* out, int n, int r, int hf, int wf, int c,
                             int oh, int ow, float ih, float iw, int feat_bf16,
                             void* stream) {
  return dispatch<float, false>(features, boxes, out, n, r, hf, wf, c, oh, ow,
                                ih, iw, feat_bf16, stream);
}

// The same sum -> out (n, r, c * oh * ow), CHW-flattened, fp32 or bf16
// (out_bf16, rounded to nearest even).
extern "C" int roi_align_chw_fwd(const void* features, const void* boxes,
                                 void* out, int n, int r, int hf, int wf,
                                 int c, int oh, int ow, float ih, float iw,
                                 int feat_bf16, int out_bf16, void* stream) {
  return out_bf16
             ? dispatch<__nv_bfloat16, true>(features, boxes, out, n, r, hf,
                                             wf, c, oh, ow, ih, iw, feat_bf16,
                                             stream)
             : dispatch<float, true>(features, boxes, out, n, r, hf, wf, c, oh,
                                     ow, ih, iw, feat_bf16, stream);
}
