// Bilinear ROI pooling, backward, written for Hopper (sm_90a).
//
// Replaces the backward of the TPU kernels K1 (roi_align_batch_pallas_fwd)
// and K2 (roi_align_pallas_fwd): the custom_vjp `_bbwd` and `_bwd` of
// imagecaptioning_tpu/ops/roi_align.py:234-242 and :155-165, which take
// jax.vjp of the einsum form
//   out[n, r, y, x, c] = sum_h sum_w Ry[r, y, h] * F[n, h, w, c] * Cx[r, x, w]
// with respect to the features AND the boxes. Ry / Cx hold each output
// row's / column's two bilinear taps (roi_taps.cuh, shared with the
// forward, so both sample the same pixels with the same weights).
//
// Two entries:
//   roi_align_bwd_features (kernel A, one launch)  d_F[n, h, w, c] =
//       sum_r sum_y Ry[r, y, h] * sum_x Cx[r, x, w] * g[n, r, y, x, c],
//       summed in fp32 and written once in the features' dtype (fp32, or
//       bf16 rounded to nearest even: JAX's fp32 VJP, then its cast's VJP);
//   roi_align_bwd_boxes (kernel B, two launches: partial sums per channel
//       chunk, then their fixed-order sum)  d_boxes[n, r, :] (fp32), the
//       chain rule read off `_interp_weights` (roi_align.py:40-61):
//       d w_lo / d frac = -1 at p0 and d w_hi / d frac = +1 at p0 + 1, each
//       only where that pixel lies in the map (floor has no gradient);
//       dp/du = in / 2; du/d theta_t = 1, du/d theta_s = g_j;
//       d theta_t / dc = 2 / (S - 1), d theta_s / ds = 1/S. Rows give
//       (yc, h), columns (xc, w).
// The upstream gradient g is fp32 or bf16, either NHWC (N, R, oh, ow, C), the
// TPU kernel's output layout, or CHW-flattened (N, R, C*oh*ow), fc6's input
// as the fused forward entry writes it.
//
// Bound on the H100: bytes. Kernel A reads g once and writes d_F once (at the
// training shape, 4 images x 32 boxes of a 22x22x512 bf16 map: 6.4 MB + 2.0
// MB over 3.35 TB/s, about 2.5 us; its ~26 M flops are far below that);
// kernel B reads g and the map once each.
//
// Design. Neither kernel uses float atomics: every output element is summed
// by one thread in a fixed order, so two launches give the same bits.
// - Kernel A, a gather. Block (chunk of 32 channels, band of 4 feature
//   rows x a pass of 32 columns, image): lane = channel, warp w = columns
//   4w .. 4w + 3 of the pass, each thread holding its 4 x 4 sums in
//   registers. Per group of 32 boxes the block computes its image's taps
//   once (a row's as its weights on the band's 4 rows) and keeps, in box
//   order, the boxes with a tap in its band and one in its pass, with the
//   output rows that reach the band and the warps whose columns they hit.
//   It stages the kept boxes' gradient slabs (32 channels x oh x ow: one
//   contiguous run in CHW, oh*ow runs of 32 channels in NHWC) into shared
//   memory with 16-byte cp.async copies, as many at a time as fit in 40
//   KB, behind one barrier, and each warp then walks the boxes that hit
//   its columns at its own pace. Per box it ballots, for each of its
//   columns, the output columns x whose taps hit it; per four kept rows y
//   and per column it sums those x in order (inner = sum_x Cx * g, four
//   independent loads per x) and adds Ry * inner to the band's rows:
//   separable, in the (box, y, x) order of the plain gather, so the sums
//   are the per-element gather's exactly (an fma by a 0 weight adds 0).
//   d_F goes out as 32 channels in a row per warp store. Where C *
//   sizeof(g) is not a multiple of 16 bytes (or g is not 16-byte
//   aligned), the slab is copied element by element instead.
// - Kernel B. Block (chunk of 64 channels, box, image): the box's slab is
//   staged as in A; warp w takes output rows w, w + 8, ...; per cell each
//   lane forms d out / d frac_y and d out / d frac_x over its two channels
//   from the cell's four taps (read along C, coalesced), weighted by g. A
//   lane keeps its frac_y sum per row in a register and its frac_x sums
//   per column in its own shared slots; then the rows' and the columns'
//   sums are reduced over lanes by shuffle trees, over warps in warp order.
//   The block writes its oh + ow partial sums to a scratch buffer (the
//   caller's), and a second launch, one block of 64 threads a box, sums
//   each box's chunks in chunk order and applies the chain rule.
//
// Outputs larger than the staged kernels take (more than 32 rows or columns,
// or more than 256 cells: a slab would not fit in shared memory) go, by
// shape, to two simple general kernels, never on failure:
// - kernel A, general: one thread per d_F element, looping over the boxes,
//   their output rows and columns in the plain gather's order (per box and
//   row, the sum over columns first, then Ry times it), reading g from
//   device memory;
// - kernel B, general: a block per (64-channel chunk, box), warp w taking
//   the box's output rows and then its columns w, w + 8, ..., each lane its
//   two channels, reduced over lanes by a shuffle tree, into the same
//   scratch buffer; its finish pass loops over oh + ow in one thread per
//   axis.
// Every path at 7x7 (the models' only output size) takes the staged
// kernels.
//
// Interface: plain C entry points (bound with ctypes). They launch on the
// caller's stream, allocate nothing, do not synchronise, and return
// cudaGetLastError() (or the shared-memory opt-in's error) so a refused
// launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "roi_taps.cuh"

namespace {

constexpr int kMaxGrid = 65535;       // gridDim.y and gridDim.z
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemOptIn = 227 * 1024;
constexpr int kThreads = 256;         // kernel A
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// kernel A
constexpr int kChan = 32;             // channels per block
constexpr int kLaneChan = kChan / 32;  // channels per lane
constexpr int kSlots = 4;             // columns per warp in a pass
constexpr int kCols = kWarps * kSlots;  // columns per pass
constexpr int kBand = 4;              // feature rows per block
static_assert(kBand == 4, "a row's weights on the band are one float4");
constexpr int kGroup = 32;            // boxes whose taps are computed together
constexpr int kSlabBudget = 40 * 1024;  // shared memory for the slabs
// kernel B
constexpr int kBoxChan = 64;          // channels per block
constexpr int kBoxThreads = 256;
constexpr int kBoxWarps = kBoxThreads / 32;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Stage channels [c0, c0 + kc) of box `box`'s gradient into `dst`, laid out
// (channel, cell) for CHW and (cell, kCh channels) for NHWC, and commit one
// cp.async group (empty when `vec` is false: then the copy is made element
// by element and is done when this returns). `vec`: C * sizeof(GT) is a
// multiple of 16 bytes and `grad` is 16-byte aligned, so every 16-byte
// piece is aligned at both ends.
template <typename GT, bool kChw, int kCh>
__device__ __forceinline__ void stage_slab(GT* dst, const GT* __restrict__ grad,
                                           int box, int c0, int kc, int C,
                                           int ohw, bool vec) {
  constexpr int kPer = 16 / sizeof(GT);
  const int tid = threadIdx.x;
  if (kChw) {
    const GT* src = grad + (box * C + c0) * ohw;   // kc * ohw in a row
    if (vec) {
      for (int i = tid; i < kc * ohw / kPer; i += blockDim.x)
        cp_async16(dst + i * kPer, src + i * kPer);
    } else {
      for (int i = tid; i < kc * ohw; i += blockDim.x) dst[i] = src[i];
    }
  } else {
    const GT* src = grad + box * ohw * C + c0;     // ohw runs of kc
    if (vec) {
      const int per = kc / kPer;
      for (int i = tid; i < ohw * per; i += blockDim.x) {
        const int q = i / per, p = i - q * per;
        cp_async16(dst + q * kCh + p * kPer, src + q * C + p * kPer);
      }
    } else {
      for (int i = tid; i < ohw * kc; i += blockDim.x) {
        const int q = i / kc, k = i - q * kc;
        dst[q * kCh + k] = src[q * C + k];
      }
    }
  }
  cp_async_commit();
}

// Element of the staged slab at channel k, output cell (y, x).
template <bool kChw, int kCh>
__device__ __forceinline__ int slab_index(int k, int y, int x, int ow,
                                          int ohw) {
  return kChw ? k * ohw + y * ow + x : (y * ow + x) * kCh + k;
}

// Kernel A's dynamic shared memory: as many slab buffers as fit in
// kSlabBudget (1 to kGroup), then a group's row and column taps.
template <typename GT>
__host__ __device__ constexpr int features_buffer_bytes(int ohw) {
  return round16(kChan * ohw * static_cast<int>(sizeof(GT)));
}
__host__ __device__ constexpr int features_stages(int buffer_bytes) {
  return kSlabBudget / buffer_bytes < 1        ? 1
         : kSlabBudget / buffer_bytes > kGroup ? kGroup
                                               : kSlabBudget / buffer_bytes;
}
template <typename GT>
__host__ __device__ constexpr int features_smem(int oh, int ow) {
  return features_stages(features_buffer_bytes<GT>(oh * ow)) *
             features_buffer_bytes<GT>(oh * ow) +
         kGroup * (oh * static_cast<int>(sizeof(float4)) +
                   ow * static_cast<int>(sizeof(Tap)));
}

// Kernel A. Block (i, t, n): channels [kChan i, kChan i + kChan), feature
// rows [4 (t / passes), +4), columns [32 (t % passes), +32), image n.
// Thread (lane, warp): channels lane + 32 q of the chunk, columns
// 4 warp .. 4 warp + 3 of the pass.
template <typename GT, typename FT, bool kChw>
__global__ void __launch_bounds__(kThreads)
roi_bwd_features_kernel(const GT* __restrict__ grad,
                        const float* __restrict__ boxes, FT* __restrict__ dF,
                        int R, int Hf, int Wf, int C, int oh, int ow,
                        float ih, float iw, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ohw = oh * ow;
  const int buf_bytes = features_buffer_bytes<GT>(ohw);
  const auto buffer = [&](int k) {
    return reinterpret_cast<GT*>(smem + k * buf_bytes);
  };
  const int stages = features_stages(buf_bytes);
  // per output row of a group's boxes, its weights on the band's 4 rows;
  // per output column, its taps
  float4* rows = reinterpret_cast<float4*>(smem + stages * buf_bytes);
  Tap* cols = reinterpret_cast<Tap*>(rows + kGroup * oh);
  __shared__ int kept[kGroup];            // kept boxes, in order
  __shared__ unsigned kept_rows[kGroup];  // their rows that reach the band
  __shared__ unsigned kept_warps[kGroup];  // the warps whose columns they hit
  __shared__ int n_kept;
  __shared__ unsigned hit_rows[kGroup], hit_warps[kGroup];  // this group's

  const int passes = (Wf + kCols - 1) / kCols;
  const int band = blockIdx.y / passes;
  const int h0 = band * kBand;
  const int w0 = (blockIdx.y - band * passes) * kCols;
  const int c0 = blockIdx.x * kChan;
  const int kc = min(kChan, C - c0);
  const int n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int my_w = w0 + warp * kSlots;    // this warp's first column

  float acc[kBand][kSlots][kLaneChan];
#pragma unroll
  for (int j = 0; j < kBand; ++j)
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int q = 0; q < kLaneChan; ++q) acc[j][s][q] = 0.0f;

  if (tid < kGroup) hit_rows[tid] = hit_warps[tid] = 0;
  __syncthreads();
  for (int r0 = 0; r0 < R; r0 += kGroup) {
    const int nb = min(kGroup, R - r0);
    // taps as pixel indices (stride 1), rows then columns; which output rows
    // of each box reach the band, and which warps' columns its taps hit
    for (int i = tid; i < nb * (oh + ow); i += kThreads) {
      const bool row = i < nb * oh;
      const int k = row ? i : i - nb * oh;
      const int out = row ? oh : ow;
      const int b = k / out;
      const float* box = boxes + (n * R + r0 + b) * 4;
      const Tap t = axis_taps(row ? box[1] : box[0], row ? box[3] : box[2],
                              k - b * out, out, row ? Hf : Wf,
                              row ? ih : iw, 1);
      if (row) {
        float w[kBand];
#pragma unroll
        for (int j = 0; j < kBand; ++j)
          w[j] = t.w_lo != 0.0f && t.lo == h0 + j   ? t.w_lo
                 : t.w_hi != 0.0f && t.hi == h0 + j ? t.w_hi
                                                    : 0.0f;
        rows[k] = make_float4(w[0], w[1], w[2], w[3]);
        if (w[0] != 0.0f || w[1] != 0.0f || w[2] != 0.0f || w[3] != 0.0f)
          atomicOr(&hit_rows[b], 1u << (k - b * oh));
      } else {
        cols[k] = t;
        unsigned warps = 0;
        if (t.w_lo != 0.0f && t.lo >= w0 && t.lo < w0 + kCols)
          warps |= 1u << ((t.lo - w0) / kSlots);
        if (t.w_hi != 0.0f && t.hi >= w0 && t.hi < w0 + kCols)
          warps |= 1u << ((t.hi - w0) / kSlots);
        if (warps != 0) atomicOr(&hit_warps[b], warps);
      }
    }
    __syncthreads();
    // warp 0 keeps, in order, the boxes with a tap in the band and one in
    // the pass
    if (warp == 0) {
      const unsigned rows_hit = hit_rows[lane], warps_hit = hit_warps[lane];
      const bool keep = lane < nb && rows_hit != 0 && warps_hit != 0;
      hit_rows[lane] = hit_warps[lane] = 0;    // cleared for the next group
      const unsigned ballot = __ballot_sync(kFull, keep);
      if (keep) {
        const int at = __popc(ballot & ((1u << lane) - 1u));
        kept[at] = lane;
        kept_rows[at] = rows_hit;
        kept_warps[at] = warps_hit;
      }
      if (lane == 0) n_kept = __popc(ballot);
    }
    __syncthreads();

    // the kept boxes' slabs, `stages` at a time: one barrier a batch, and
    // within a batch each warp walks the boxes that hit its columns
    const int nk = n_kept;
    for (int i0 = 0; i0 < nk; i0 += stages) {
      const int batch = min(stages, nk - i0);
      for (int i = 0; i < batch; ++i)
        stage_slab<GT, kChw, kChan>(buffer(i), grad, n * R + r0 + kept[i0 + i],
                                    c0, kc, C, ohw, vec);
      cp_async_wait<0>();
      __syncthreads();
      for (int i = 0; i < batch; ++i) {
        if (!(kept_warps[i0 + i] >> warp & 1u)) continue;
        const int b = kept[i0 + i];
        const GT* g = buffer(i);
        // per column slot: lane x holds output column x's weight on the
        // slot's column, and xs[s] has bit x set where that weight is not 0
        const Tap ct = cols[b * ow + min(lane, ow - 1)];
        float wt[kSlots];
        unsigned xs[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          float v = 0.0f;
          if (lane < ow)
            v = ct.w_lo != 0.0f && ct.lo == my_w + s   ? ct.w_lo
                : ct.w_hi != 0.0f && ct.hi == my_w + s ? ct.w_hi
                                                       : 0.0f;
          wt[s] = v;
          xs[s] = __ballot_sync(kFull, v != 0.0f);
        }
        // the box's rows that reach the band, four at a time (a missing
        // one repeats the last with weight 0: an fma by 0 leaves a sum's
        // bits as they are), so that a column's x walk serves four rows
        for (unsigned ys = kept_rows[i0 + i]; ys != 0;) {
          int gy[4];     // the rows' offsets in the slab
          float4 wq[4];
          int y = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wq[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (ys != 0) {
              y = __ffs(ys) - 1;
              ys &= ys - 1;
              wq[q] = rows[b * oh + y];
            }
            gy[q] = slab_index<kChw, kChan>(lane, y, 0, ow, ohw);
          }
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            if (xs[s] == 0) continue;
            // inner = sum over x, in order, of Cx[x, w_s] * g[y_q, x, c]
            float inner[4][kLaneChan] = {};
            for (unsigned m = xs[s]; m != 0; m &= m - 1) {
              const int x = __ffs(m) - 1;
              const float wx = __shfl_sync(kFull, wt[s], x);
              const int dx = slab_index<kChw, kChan>(0, 0, x, ow, ohw);
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int p = 0; p < kLaneChan; ++p)
                  inner[q][p] = fmaf(
                      wx, widen(g[gy[q] + dx + 32 * p * (kChw ? ohw : 1)]),
                      inner[q][p]);
            }
            // then Ry: the rows in order
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int p = 0; p < kLaneChan; ++p) {
                acc[0][s][p] = fmaf(wq[q].x, inner[q][p], acc[0][s][p]);
                acc[1][s][p] = fmaf(wq[q].y, inner[q][p], acc[1][s][p]);
                acc[2][s][p] = fmaf(wq[q].z, inner[q][p], acc[2][s][p]);
                acc[3][s][p] = fmaf(wq[q].w, inner[q][p], acc[3][s][p]);
              }
          }
        }
      }
      __syncthreads();  // the next batch overwrites the buffers
    }
    __syncthreads();  // the next group overwrites the taps and the list
  }

#pragma unroll
  for (int p = 0; p < kLaneChan; ++p) {
    const int k = lane + 32 * p;
    if (k >= kc) break;
#pragma unroll
    for (int j = 0; j < kBand; ++j) {
      const int h = h0 + j;
      if (h >= Hf) break;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int w = my_w + s;
        if (w < Wf)
          dF[((n * Hf + h) * Wf + w) * C + c0 + k] = narrow<FT>(acc[j][s][p]);
      }
    }
  }
}

// Kernel B's dynamic shared memory: the slab, the box's oh + ow samples,
// each warp's per-lane d/d frac_x sums per output column, and the rows'
// d/d frac_y sums.
template <typename GT>
__host__ __device__ constexpr int boxes_buffer_bytes(int ohw) {
  return round16(kBoxChan * ohw * static_cast<int>(sizeof(GT)));
}
template <typename GT>
__host__ __device__ constexpr int boxes_smem(int oh, int ow) {
  return boxes_buffer_bytes<GT>(oh * ow) +
         (oh + ow) * static_cast<int>(sizeof(AxisSample)) +
         (kBoxWarps * ow * 32 + oh) * static_cast<int>(sizeof(float));
}

// Kernel B, first pass. Block (i, r, n): channels [64 i, 64 i + 64) of box
// r of image n → partial[(n R + r) chunks + i][0, oh + ow): its rows' sums
// of d out / d frac_y, then its columns' of d out / d frac_x.
template <typename GT, typename T, bool kChw>
__global__ void __launch_bounds__(kBoxThreads)
roi_bwd_boxes_kernel(const T* __restrict__ feat,
                     const float* __restrict__ boxes,
                     const GT* __restrict__ grad, float* __restrict__ partial,
                     int R, int Hf, int Wf, int C, int oh, int ow, float ih,
                     float iw, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ohw = oh * ow;
  GT* g = reinterpret_cast<GT*>(smem);
  AxisSample* samples = reinterpret_cast<AxisSample*>(
      smem + boxes_buffer_bytes<GT>(ohw));                  // oh, then ow
  float* dxs = reinterpret_cast<float*>(samples + oh + ow);  // warp, x, lane
  float* dys = dxs + kBoxWarps * ow * 32;                    // oh

  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int box = blockIdx.z * R + blockIdx.y;
  const int c0 = chunk * kBoxChan;
  const int kc = min(kBoxChan, C - c0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  stage_slab<GT, kChw, kBoxChan>(g, grad, box, c0, kc, C, ohw, vec);
  const float* b = boxes + box * 4;
  for (int i = tid; i < oh + ow; i += kBoxThreads) {
    const bool row = i < oh;
    samples[i] = axis_sample(row ? b[1] : b[0], row ? b[3] : b[2],
                             row ? i : i - oh, row ? oh : ow, row ? Hf : Wf,
                             row ? ih : iw);
  }
  for (int i = tid; i < kBoxWarps * ow * 32; i += kBoxThreads) dxs[i] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  // warp w takes output rows w, w + 8, ...; lane l channels l and l + 32
  const T* f = feat + blockIdx.z * Hf * Wf * C + c0;
  float* my_dx = dxs + warp * ow * 32 + lane;   // this lane's own slots
  for (int y = warp; y < oh; y += kBoxWarps) {
    const AxisSample sy = samples[y];
    const int y0 = static_cast<int>(sy.p0);
    const float wy_lo = sy.lo_ok ? 1.0f - sy.frac : 0.0f;
    const float wy_hi = sy.hi_ok ? sy.frac : 0.0f;
    float dy = 0.0f;
#pragma unroll 2
    for (int x = 0; x < ow; ++x) {
      const AxisSample sx = samples[oh + x];
      const int x0 = static_cast<int>(sx.p0);
      const float wx_lo = sx.lo_ok ? 1.0f - sx.frac : 0.0f;
      const float wx_hi = sx.hi_ok ? sx.frac : 0.0f;
      float dyc = 0.0f, dxc = 0.0f;
#pragma unroll
      for (int q = 0; q < kBoxChan / 32; ++q) {
        const int k = lane + 32 * q;
        if (k >= kc) break;
        // the cell's four taps, zero where a pixel lies outside the map
        const float f00 = sy.lo_ok && sx.lo_ok
                              ? widen(f[(y0 * Wf + x0) * C + k]) : 0.0f;
        const float f01 = sy.lo_ok && sx.hi_ok
                              ? widen(f[(y0 * Wf + x0 + 1) * C + k]) : 0.0f;
        const float f10 = sy.hi_ok && sx.lo_ok
                              ? widen(f[((y0 + 1) * Wf + x0) * C + k]) : 0.0f;
        const float f11 = sy.hi_ok && sx.hi_ok
                              ? widen(f[((y0 + 1) * Wf + x0 + 1) * C + k])
                              : 0.0f;
        const float gv =
            widen(g[slab_index<kChw, kBoxChan>(k, y, x, ow, ohw)]);
        // d out / d frac_y = sum_w Cx[x, w] (F[y0 + 1, w] - F[y0, w]), and
        // the same across for frac_x
        dyc = fmaf(gv, wx_lo * (f10 - f00) + wx_hi * (f11 - f01), dyc);
        dxc = fmaf(gv, wy_lo * (f01 - f00) + wy_hi * (f11 - f10), dxc);
      }
      dy += dyc;
      my_dx[x * 32] += dxc;
    }
    dy = warp_sum(dy);
    if (lane == 0) dys[y] = dy;
  }
  __syncthreads();

  // column x: the warps' sums in warp order, then a shuffle tree over lanes
  float* out = partial + (box * chunks + chunk) * (oh + ow);
  for (int x = warp; x < ow; x += kBoxWarps) {
    float sum = 0.0f;
    for (int w = 0; w < kBoxWarps; ++w) sum += dxs[(w * ow + x) * 32 + lane];
    sum = warp_sum(sum);
    if (lane == 0) out[oh + x] = sum;
  }
  for (int y = tid; y < oh; y += kBoxThreads) out[y] = dys[y];
}

// Kernel B, second pass. Block `box` (64 threads): thread j < oh + ow sums
// its output row's (then column's) partial sums over the chunks in chunk
// order; threads 0 and 1 then apply the chain rule along the rows and the
// columns → d_boxes (fp32).
constexpr int kFinishThreads = 64;

__global__ void __launch_bounds__(kFinishThreads)
roi_bwd_boxes_finish(const float* __restrict__ partial,
                     const float* __restrict__ boxes,
                     float* __restrict__ d_boxes, int chunks, int Hf, int Wf,
                     int oh, int ow, float ih, float iw) {
  __shared__ float du[kFinishThreads], gj[kFinishThreads];
  const int box = blockIdx.x, t = threadIdx.x;
  const float* b = boxes + box * 4;
  if (t < oh + ow) {
    const bool row = t < oh;
    const int in = row ? Hf : Wf;
    const float* p = partial + box * chunks * (oh + ow) + t;
    float total = 0.0f;
#pragma unroll 8
    for (int k = 0; k < chunks; ++k) total += p[k * (oh + ow)];
    // p = ((u + 1) * in - 1) / 2
    du[t] = total * 0.5f * static_cast<float>(in);
    gj[t] = axis_sample(row ? b[1] : b[0], row ? b[3] : b[2],
                        row ? t : t - oh, row ? oh : ow, in,
                        row ? ih : iw).g;
  }
  __syncthreads();
  if (t < 2) {
    // t 0: rows -> (yc, h); t 1: columns -> (xc, w)
    const bool row = t == 0;
    const int first = row ? 0 : oh, out = row ? oh : ow;
    const float image = row ? ih : iw;
    float d_t = 0.0f, d_s = 0.0f;
    for (int j = first; j < first + out; ++j) {
      d_t += du[j];
      d_s = fmaf(du[j], gj[j], d_s);
    }
    // theta_t = (2c - 1 - S) / (S - 1), theta_s = s / S
    d_boxes[box * 4 + (row ? 1 : 0)] = __fdiv_rn(d_t, image - 1.0f) * 2.0f;
    d_boxes[box * 4 + (row ? 3 : 2)] = __fdiv_rn(d_s, image);
  }
}

// The staged kernels' limits: a slab of at most 256 cells, and at most 32
// output rows and columns (one bit each in a 32-bit mask).
__host__ __device__ constexpr bool staged_shape(int oh, int ow) {
  return oh <= 32 && ow <= 32 && oh * ow <= 256;
}

// The weight of output index j's taps on pixel `p` along one axis (0 when
// neither tap is p).
__device__ __forceinline__ float tap_weight(const Tap& t, int p) {
  return t.w_lo != 0.0f && t.lo == p   ? t.w_lo
         : t.w_hi != 0.0f && t.hi == p ? t.w_hi
                                       : 0.0f;
}

// Kernel A, general. Thread i (grid-stride): d_F element (n, h, w, c) =
// sum over boxes r, in order, of sum over rows y, in order, of
// Ry[y, h] * (sum over columns x, in order, of Cx[x, w] * g[r, y, x, c]).
template <typename GT, typename FT, bool kChw>
__global__ void __launch_bounds__(kThreads)
roi_bwd_features_general(const GT* __restrict__ grad,
                         const float* __restrict__ boxes,
                         FT* __restrict__ dF, int N, int R, int Hf, int Wf,
                         int C, int oh, int ow, float ih, float iw) {
  const long long total = static_cast<long long>(N) * Hf * Wf * C;
  const long long ohw = static_cast<long long>(oh) * ow;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    const int w = static_cast<int>(i / C % Wf);
    const int h = static_cast<int>(i / C / Wf % Hf);
    const int n = static_cast<int>(i / C / Wf / Hf);
    float acc = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float* box = boxes + (static_cast<long long>(n) * R + r) * 4;
      const GT* g = grad + (static_cast<long long>(n) * R + r) * ohw * C;
      for (int y = 0; y < oh; ++y) {
        const float wy =
            tap_weight(axis_taps(box[1], box[3], y, oh, Hf, ih, 1), h);
        if (wy == 0.0f) continue;
        float inner = 0.0f;
        for (int x = 0; x < ow; ++x) {
          const float wx =
              tap_weight(axis_taps(box[0], box[2], x, ow, Wf, iw, 1), w);
          if (wx == 0.0f) continue;
          const long long at = kChw ? c * ohw + y * ow + x
                                    : (y * static_cast<long long>(ow) + x) * C + c;
          inner = fmaf(wx, widen(g[at]), inner);
        }
        acc = fmaf(wy, inner, acc);
      }
    }
    dF[i] = narrow<FT>(acc);
  }
}

// Kernel B, general, first pass. Block (i, r, n): channels [64 i, 64 i + 64)
// of box r of image n → partial[(n R + r) chunks + i][0, oh + ow), as the
// staged kernel writes it. Warp w takes the box's axis indices j = w, w + 8,
// ... of the oh rows, then the ow columns; lane l channels l and l + 32.
template <typename GT, typename T, bool kChw>
__global__ void __launch_bounds__(kBoxThreads)
roi_bwd_boxes_general(const T* __restrict__ feat,
                      const float* __restrict__ boxes,
                      const GT* __restrict__ grad, float* __restrict__ partial,
                      int R, int Hf, int Wf, int C, int oh, int ow, float ih,
                      float iw) {
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const long long box = static_cast<long long>(blockIdx.z) * R + blockIdx.y;
  const int c0 = chunk * kBoxChan;
  const int kc = min(kBoxChan, C - c0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long ohw = static_cast<long long>(oh) * ow;
  const float* b = boxes + box * 4;
  const T* f = feat + static_cast<long long>(blockIdx.z) * Hf * Wf * C + c0;
  const GT* g = grad + box * ohw * C;
  float* out = partial + (box * chunks + chunk) * (oh + ow);
  for (int j = warp; j < oh + ow; j += kBoxWarps) {
    const bool row = j < oh;
    // the fixed axis index, and the other axis walked over in order
    const int fixed = row ? j : j - oh;
    const int walk = row ? ow : oh;
    float sum = 0.0f;
    for (int v = 0; v < walk; ++v) {
      const int y = row ? fixed : v, x = row ? v : fixed;
      const AxisSample sy = axis_sample(b[1], b[3], y, oh, Hf, ih);
      const AxisSample sx = axis_sample(b[0], b[2], x, ow, Wf, iw);
      const int y0 = static_cast<int>(sy.p0), x0 = static_cast<int>(sx.p0);
      const float wy_lo = sy.lo_ok ? 1.0f - sy.frac : 0.0f;
      const float wy_hi = sy.hi_ok ? sy.frac : 0.0f;
      const float wx_lo = sx.lo_ok ? 1.0f - sx.frac : 0.0f;
      const float wx_hi = sx.hi_ok ? sx.frac : 0.0f;
#pragma unroll
      for (int q = 0; q < kBoxChan / 32; ++q) {
        const int k = lane + 32 * q;
        if (k >= kc) break;
        const float f00 = sy.lo_ok && sx.lo_ok
                              ? widen(f[(y0 * Wf + x0) * C + k]) : 0.0f;
        const float f01 = sy.lo_ok && sx.hi_ok
                              ? widen(f[(y0 * Wf + x0 + 1) * C + k]) : 0.0f;
        const float f10 = sy.hi_ok && sx.lo_ok
                              ? widen(f[((y0 + 1) * Wf + x0) * C + k]) : 0.0f;
        const float f11 = sy.hi_ok && sx.hi_ok
                              ? widen(f[((y0 + 1) * Wf + x0 + 1) * C + k])
                              : 0.0f;
        const long long at = kChw ? (c0 + k) * ohw + y * ow + x
                                  : (y * static_cast<long long>(ow) + x) * C +
                                        c0 + k;
        const float gv = widen(g[at]);
        // rows: d out / d frac_y; columns: d out / d frac_x
        sum = fmaf(gv,
                   row ? wx_lo * (f10 - f00) + wx_hi * (f11 - f01)
                       : wy_lo * (f01 - f00) + wy_hi * (f11 - f10),
                   sum);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) out[j] = sum;
  }
}

// Kernel B, general, second pass. Block `box` (32 threads): thread 0 takes
// the rows → (yc, h), thread 1 the columns → (xc, w); each sums its axis
// indices' partial sums over the chunks in chunk order and applies the
// chain rule as `roi_bwd_boxes_finish` does.
__global__ void roi_bwd_boxes_finish_general(
    const float* __restrict__ partial, const float* __restrict__ boxes,
    float* __restrict__ d_boxes, int chunks, int Hf, int Wf, int oh, int ow,
    float ih, float iw) {
  const long long box = blockIdx.x;
  const int t = threadIdx.x;
  if (t >= 2) return;
  const bool row = t == 0;
  const float* b = boxes + box * 4;
  const int in = row ? Hf : Wf, first = row ? 0 : oh, out = row ? oh : ow;
  const float image = row ? ih : iw;
  const float* p = partial + box * chunks * (oh + ow);
  float d_t = 0.0f, d_s = 0.0f;
  for (int j = first; j < first + out; ++j) {
    float total = 0.0f;
    for (int k = 0; k < chunks; ++k) total += p[k * (oh + ow) + j];
    const float du = total * 0.5f * static_cast<float>(in);
    const float gj = axis_sample(row ? b[1] : b[0], row ? b[3] : b[2],
                                 j - first, out, in, image).g;
    d_t += du;
    d_s = fmaf(du, gj, d_s);
  }
  d_boxes[box * 4 + (row ? 1 : 0)] = __fdiv_rn(d_t, image - 1.0f) * 2.0f;
  d_boxes[box * 4 + (row ? 3 : 2)] = __fdiv_rn(d_s, image);
}

// Allow `kernel` `bytes` of dynamic shared memory beside its static arrays
// (above 48 KB in all only after an opt-in) → a CUDA error code.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  cudaFuncAttributes attr;
  if (const cudaError_t err = cudaFuncGetAttributes(&attr, kernel))
    return static_cast<int>(err);
  const int total = bytes + static_cast<int>(attr.sharedSizeBytes);
  if (total > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  if (total <= kSmemDefault) return static_cast<int>(cudaSuccess);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The 16-byte copies need C * sizeof(GT) to be a multiple of 16 and an
// aligned gradient.
template <typename GT>
bool can_vectorize(const void* grad, int c) {
  return (c * sizeof(GT)) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(grad) % 16 == 0;
}

template <typename GT, typename FT, bool kChw>
int launch_features(const void* grad, const void* boxes, void* dF, int n,
                    int r, int hf, int wf, int c, int oh, int ow, float ih,
                    float iw, cudaStream_t stream) {
  if (!staged_shape(oh, ow)) {
    const long long total = static_cast<long long>(n) * hf * wf * c;
    const long long blocks = (total + kThreads - 1) / kThreads;
    roi_bwd_features_general<GT, FT, kChw>
        <<<static_cast<unsigned>(blocks < 1 << 20 ? blocks : 1 << 20),
           kThreads, 0, stream>>>(static_cast<const GT*>(grad),
                                  static_cast<const float*>(boxes),
                                  static_cast<FT*>(dF), n, r, hf, wf, c, oh,
                                  ow, ih, iw);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = static_cast<long long>((hf + kBand - 1) / kBand) *
                          ((wf + kCols - 1) / kCols);
  if (tiles > kMaxGrid || n > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = roi_bwd_features_kernel<GT, FT, kChw>;
  const int smem = features_smem<GT>(oh, ow);
  if (const int err = allow_smem(kernel, smem)) return err;
  const dim3 grid((c + kChan - 1) / kChan, static_cast<unsigned>(tiles), n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const GT*>(grad), static_cast<const float*>(boxes),
      static_cast<FT*>(dF), r, hf, wf, c, oh, ow, ih, iw,
      can_vectorize<GT>(grad, c));
  return static_cast<int>(cudaGetLastError());
}

template <typename GT, typename T, bool kChw>
int launch_boxes(const void* feat, const void* boxes, const void* grad,
                 void* d_boxes, void* scratch, int n, int r, int hf, int wf,
                 int c, int oh, int ow, float ih, float iw,
                 cudaStream_t stream) {
  if (r > kMaxGrid || n > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (c + kBoxChan - 1) / kBoxChan;
  if (!staged_shape(oh, ow)) {
    if (chunks > 0) {
      roi_bwd_boxes_general<GT, T, kChw>
          <<<dim3(chunks, r, n), kBoxThreads, 0, stream>>>(
              static_cast<const T*>(feat), static_cast<const float*>(boxes),
              static_cast<const GT*>(grad), static_cast<float*>(scratch), r,
              hf, wf, c, oh, ow, ih, iw);
      if (const cudaError_t err = cudaGetLastError())
        return static_cast<int>(err);
    }
    roi_bwd_boxes_finish_general<<<n * r, 32, 0, stream>>>(
        static_cast<const float*>(scratch), static_cast<const float*>(boxes),
        static_cast<float*>(d_boxes), chunks, hf, wf, oh, ow, ih, iw);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = roi_bwd_boxes_kernel<GT, T, kChw>;
  const int smem = boxes_smem<GT>(oh, ow);
  if (const int err = allow_smem(kernel, smem)) return err;
  // no channels: no partial sums, and the second pass writes zeros
  if (chunks > 0) {
    kernel<<<dim3(chunks, r, n), kBoxThreads, smem, stream>>>(
        static_cast<const T*>(feat), static_cast<const float*>(boxes),
        static_cast<const GT*>(grad), static_cast<float*>(scratch), r, hf,
        wf, c, oh, ow, ih, iw, can_vectorize<GT>(grad, c));
    if (const cudaError_t err = cudaGetLastError())
      return static_cast<int>(err);
  }
  roi_bwd_boxes_finish<<<n * r, kFinishThreads, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const float*>(boxes),
      static_cast<float*>(d_boxes), chunks, hf, wf, oh, ow, ih, iw);
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
// or bf16 (out_bf16). Any oh and ow: beyond the staged kernel's limits the
// general kernel runs.
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
// grad as above -> d_boxes (n, r, 4) fp32. scratch: n * r * ceil(c / 64) *
// (oh + ow) fp32, the first pass's partial sums.
extern "C" int roi_align_bwd_boxes(const void* features, const void* boxes,
                                   const void* grad, void* d_boxes,
                                   void* scratch, int n, int r, int hf,
                                   int wf, int c, int oh, int ow, float ih,
                                   float iw, int feat_bf16, int grad_bf16,
                                   int grad_chw, void* stream) {
  if (static_cast<long long>(n) * r == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  return feat_bf16
             ? by_grad<Boxes, __nv_bfloat16>(grad_bf16, grad_chw, features,
                                             boxes, grad, d_boxes, scratch, n,
                                             r, hf, wf, c, oh, ow, ih, iw, s)
             : by_grad<Boxes, float>(grad_bf16, grad_chw, features, boxes,
                                     grad, d_boxes, scratch, n, r, hf, wf, c,
                                     oh, ow, ih, iw, s);
}
