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
// Two entries, one launch each:
//   roi_align_bwd_features (kernel A)  d_F[n, h, w, c] =
//       sum_r sum_y Ry[r, y, h] * sum_x Cx[r, x, w] * g[n, r, y, x, c],
//       summed in fp32 and written once in the features' dtype (fp32, or
//       bf16 rounded to nearest even: JAX's fp32 VJP, then its cast's VJP);
//   roi_align_bwd_boxes (kernel B)  d_boxes[n, r, :] (fp32), the chain rule
//       read off `_interp_weights` (roi_align.py:40-61):
//       d w_lo / d frac = -1 at p0 and d w_hi / d frac = +1 at p0 + 1, each
//       only where that pixel lies in the map (floor has no gradient);
//       dp/du = in / 2; du/d theta_t = 1, du/d theta_s = g_j;
//       d theta_t / dc = 2 / (S - 1), d theta_s / ds = 1/S. Rows give
//       (yc, h), columns (xc, w).
// The upstream gradient g is fp32 or bf16, either NHWC (N, R, oh, ow, C), the
// TPU kernel's output layout, or CHW-flattened (N, R, C*oh*ow), fc6's input
// as the fused forward entry writes it.
//
// Bound on the H100: bytes. Kernel A reads g once and writes d_F once;
// kernel B reads g and the map once each and writes 16 bytes a box; their
// flops (8 and 14 per gradient element) are far below it. At the RPN
// training shape (4 images x 256 sampled boxes of a 45x45x512 bf16 map at
// 720^2, bf16 CHW gradient) that is 51.4 MB of g + 8.3 MB of d_F (or map):
// 59.7 MB over 3.35 TB/s, 17.8 us. At the GT training shape (4 x 32 boxes of
// a 22x22x512 map) 6.4 MB + 2.0 MB: 2.5 us. Kernel B also reads each cell's
// four taps, 4 x 49 x C values a box, from L2 (about 200 MB at the RPN
// shape, where the taps of large boxes do not repeat).
//
// Design. Neither kernel uses float atomics: every output element is summed
// by one thread in a fixed order, so two launches give the same bits. Both
// are warp-specialised: one producer warp stages the boxes' gradients, in
// order, into a ring of slots in shared memory while the consumer warps
// reduce the boxes already there. Each slot has a "full" mbarrier (the
// producer's arrival plus the copy's bytes) and an "empty" one (the
// consumers' release), so the copies of the next boxes run while this one
// is reduced, and no block-wide barrier stands between two boxes.
// - Copies. In CHW a box's 64-channel chunk (kernel A) or whole gradient
//   (kernel B, in either layout) is one contiguous run: one cp.async.bulk (a
//   1-D TMA copy) issued by one thread, completing on the slot's full
//   barrier. Kernel A's NHWC chunk (oh*ow runs of 64 channels) is copied by
//   the producer's lanes with 16-byte cp.async, whose completion arrives on
//   the same barrier (cp.async.mbarrier.arrive.noinc). Where those copies'
//   16-byte rules do not hold (C * sizeof(g) not a multiple of 16, an
//   unaligned gradient) or two slots would not fit beside the region's sums
//   and one box's taps (fp32 16x16 cells beside 23x23 sums, say), nothing is staged and
//   the consumers read g from device memory: chosen by shape, never on
//   failure.
// - Kernel A. Block (64-channel chunk, a region of the map: a group of at
//   most 24 rows x a pass of at most 23 columns, image); the launcher
//   chooses the split by shape and SM count (`features_tile`): 45x45 at N=4
//   → 2 x 2 regions of 23x23 (128 blocks), 22x22 at N=4 → 2 x 2 regions of
//   11x11, cut while more than half the SMs would idle. Consumer warp w owns
//   column w of the region, lane l its channels 2l and 2l + 1; the region's
//   fp32 sums sit in shared memory (135 KB at 23x23) and only their column's
//   warp reads and writes them, so no two threads share a sum. The block
//   first computes every box's taps once (theta a box, then each output
//   index) into a table, with the box's output rows that reach the region
//   and the region's columns its taps hit, and numbers the boxes that reach
//   the region: only those are staged, once per region (about 1.3 times a
//   box at the RPN shape). A
//   consumer waits only for the boxes that hit its column; for the other
//   warps the producer arrives on the slot's empty barrier itself, and it
//   marks each slot with its use first, so that a warp that passed the
//   slot's last uses waits for its own use before the barrier's parity.
//   Per box a consumer ballots the output columns x whose taps hit its
//   column and, for each output row y that reaches the region, forms
//   inner = sum over x, in order, of Cx * g, then adds Ry * inner onto the
//   row's two taps' sums. That is the (box, y, x) order of the plain
//   gather, with the sum over columns first, so d_F is the per-element
//   gather's bit for bit.
// - Kernel B. Persistent blocks, box b on block b mod grid, two an SM; a
//   box's whole gradient per slot (50,176 bytes in bf16 at C = 512), as
//   many slots as fit in 110 KB a block (two in bf16, one in fp32).
//   Warp w takes the channel groups (of 64) w, w + 8, ..., lane l two
//   channels of each, and walks the box's cells row by row, the four taps of
//   several cells in flight at once (4- or 8-byte loads along C, from the
//   map in L2). Per lane, in a fixed order, each row's d out / d frac_y is
//   summed in a register and each column's d out / d frac_x in the lane's
//   own shared slot; shuffle trees sum the lanes, and after a barrier of
//   the consumers warp 0 sums the warps in warp order and applies the chain
//   rule. One launch, no scratch.
//
// Outputs larger than the staged kernels take (more than 32 rows or columns,
// or more than 256 cells) go, by shape, to two simple general kernels:
// - kernel A, general: one thread per d_F element, looping over the boxes,
//   their output rows and columns in the plain gather's order (per box and
//   row, the sum over columns first, then Ry times it), reading g from
//   device memory;
// - kernel B, general: a block per box, warp w taking the box's output rows
//   and then its columns w, w + 8, ..., lane l channels l, l + 32, ...,
//   reduced over lanes by a shuffle tree; then the chain rule in the block.
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
constexpr int kThreads = 256;         // the general kernels
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoPixel = -1024;       // an AxisTap with neither tap in the map
// kernel A
constexpr int kChan = 64;             // channels per block, 2 a lane
constexpr int kMaxColumns = 23;       // consumer warps a block, a column each
constexpr int kRegionRows = 24;       // a region's rows at most
constexpr int kRingBytes = 64 * 1024;  // the ring's slots
constexpr int kMaxStages = 32;
constexpr int kTableBytes = 64 * 1024;  // a group of boxes' taps
// kernel B
constexpr int kBoxWarps = 8;          // consumer warps a block
constexpr int kBoxThreads = kBoxWarps * 32;
constexpr int kBoxRingBytes = 110 * 1024;
constexpr int kBoxMaxStages = 4;
// the staging of a box's gradient
constexpr int kBulk = 0;              // one cp.async.bulk
constexpr int kAsync = 1;             // 16-byte cp.async by the producer
constexpr int kDirect = 2;            // none: read from device memory

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// expect `bytes` more of asynchronous copies in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// wait for the phase of parity `parity` to complete (acquire)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
// one 1-D TMA copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the consumer warps' own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// ---------------------------------------------------------------- kernel A

// One output index's two taps along an axis: pixels p0 and p0 + 1 with their
// weights, 0 for a pixel outside the map (p0 = kNoPixel when both are).
struct AxisTap {
  int p0;
  float w_lo, w_hi;
};

__device__ __forceinline__ AxisTap axis_tap(const AxisSample& s) {
  AxisTap t;
  t.w_lo = s.lo_ok ? __fsub_rn(1.0f, s.frac) : 0.0f;
  t.w_hi = s.hi_ok ? s.frac : 0.0f;
  t.p0 = t.w_lo != 0.0f || t.w_hi != 0.0f ? static_cast<int>(s.p0) : kNoPixel;
  return t;
}

// The weight of a tap pair on pixel `p` (0 when neither tap is p).
__device__ __forceinline__ float tap_weight(const AxisTap& t, int p) {
  return t.w_lo != 0.0f && t.p0 == p       ? t.w_lo
         : t.w_hi != 0.0f && t.p0 + 1 == p ? t.w_hi
                                           : 0.0f;
}

// An output row's taps on a region's rows: each the byte offset of its row
// in a column's sums (-1 for a zero weight or a row outside the region), and
// its weight.
struct __align__(16) RowTap {
  int lo, hi;
  float w_lo, w_hi;
};

// arrive on `bar` `count` times at once
__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Kernel A's shared memory: its barriers (a slot's full and empty), each
// slot's latest use (the number of the box staged in it) and the count of
// boxes staged before the current group of taps, the ring, the
// region's sums (row, column, 64 channels: fp32), then the taps of a group of
// boxes (at most `table_boxes`): each output index's grid coordinate, each
// box's oh row taps and ow column taps, the output rows reaching the region
// and the region's columns its taps hit (a bit each) and its number among the
// staged boxes (-1: not staged). A slot holds a box's 64-channel gradient
// chunk: (channel, cell) in CHW, (cell, 64 channels) in NHWC (nothing when the
// gradient is not staged: the slot's barriers still order the walk).
constexpr int kTotalAt = 2 * kMaxStages * 8 + kMaxStages * 4;
constexpr int kRingAt = round16(kTotalAt + 4);

template <typename GT>
__host__ __device__ constexpr int features_slot_bytes(int oh, int ow,
                                                      int staging) {
  return staging == kDirect
             ? 0
             : round16(kChan * oh * ow * static_cast<int>(sizeof(GT)));
}
__host__ __device__ constexpr int features_table_box_bytes(int oh, int ow) {
  return oh * static_cast<int>(sizeof(RowTap)) +
         ow * static_cast<int>(sizeof(AxisTap)) + 12;
}
__host__ __device__ constexpr int features_sums_bytes(int rows, int cols) {
  return rows * cols * kChan * 4;
}
__host__ __device__ constexpr int features_smem(int slot_bytes, int stages,
                                                int rows, int cols, int oh,
                                                int ow, int table_boxes) {
  return kRingAt + stages * slot_bytes + features_sums_bytes(rows, cols) +
         round16((oh + ow) * 4) +
         table_boxes * features_table_box_bytes(oh, ow);
}

// Kernel A. Block (i, g * passes + p, n): channels [64 i, 64 i + 64), row
// group g and column pass p of image n (rows [g rpg, (g + 1) rpg), columns
// [p cpp, (p + 1) cpp), rpg = ceil(Hf / groups) <= 24, cpp = ceil(Wf /
// passes) <= 23). Warp w < cpp owns column w of the pass, lane l channels
// 2l and 2l + 1: it alone reads and writes that column's sums, in shared
// memory, box by box and row by row, and waits only for the boxes whose taps
// hit its column; the last warp is the producer.
template <typename GT, typename FT, bool kChw>
__global__ void __launch_bounds__((kMaxColumns + 1) * 32, 1)
roi_bwd_features_kernel(const GT* __restrict__ grad,
                        const float* __restrict__ boxes, FT* __restrict__ dF,
                        int R, int Hf, int Wf, int C, int oh, int ow,
                        float ih, float iw, int groups, int passes,
                        int staging, int stages, int table_boxes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  volatile int* slot_use =
      reinterpret_cast<volatile int*>(empty + kMaxStages);
  int* staged_total = reinterpret_cast<int*>(smem + kTotalAt);
  const int ohw = oh * ow;
  const int slot_bytes = features_slot_bytes<GT>(oh, ow, staging);
  unsigned char* ring = smem + kRingAt;
  const int consumers = blockDim.x / 32 - 1;
  const int rpg = (Hf + groups - 1) / groups;
  float* sums = reinterpret_cast<float*>(ring + stages * slot_bytes);
  float* grid_g = sums + rpg * consumers * kChan;
  RowTap* row_tab = reinterpret_cast<RowTap*>(
      reinterpret_cast<unsigned char*>(grid_g) + round16((oh + ow) * 4));
  AxisTap* col_tab = reinterpret_cast<AxisTap*>(row_tab + table_boxes * oh);
  unsigned* tab_rows = reinterpret_cast<unsigned*>(col_tab + table_boxes * ow);
  unsigned* tab_cols = tab_rows + table_boxes;
  int* tab_slot = reinterpret_cast<int*>(tab_cols + table_boxes);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  const int c0 = blockIdx.x * kChan;
  const int kc = min(kChan, C - c0);
  const int group = blockIdx.y / passes;
  const int pass = blockIdx.y - group * passes;
  const int cpp = (Wf + passes - 1) / passes;
  const int row0 = group * rpg, row1 = min(Hf, row0 + rpg);
  const int col0 = pass * cpp, col1 = min(Wf, col0 + cpp);
  const int n = blockIdx.z;
  // a column's sums: row h of the region at byte h * row_bytes
  const int row_bytes = consumers * kChan * 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // cp.async staging: the producer's 32 lanes' copies, then its arrival
      mbar_init(&full[s], staging == kAsync ? 33 : 1);
      mbar_init(&empty[s], consumers);
    }
    mbar_fence_init();
  }
  if (threadIdx.x < stages) slot_use[threadIdx.x] = -1;
  for (int k = threadIdx.x; k < oh + ow; k += blockDim.x)
    grid_g[k] = k < oh ? axis_grid(k, oh) : axis_grid(k - oh, ow);
  for (int i = threadIdx.x; i < (row1 - row0) * consumers * kChan;
       i += blockDim.x)
    sums[i] = 0.0f;

  if (threadIdx.x == 0) *staged_total = 0;

  for (int r0 = 0; r0 < R; r0 += table_boxes) {
    const int nb = min(table_boxes, R - r0);
    __syncthreads();        // the set-up; the last group is done
    // the group's taps, a thread a (box, axis): theta once, then each
    // output index; and the output rows that reach the region, or the
    // columns of the region the taps hit
    for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {
      const int b = i >> 1;
      const bool row = i & 1;
      const float* bx = boxes + (static_cast<long long>(n) * R + r0 + b) * 4;
      float theta_t, theta_s;
      axis_theta(row ? bx[1] : bx[0], row ? bx[3] : bx[2], row ? ih : iw,
                 theta_t, theta_s);
      unsigned m = 0;
      if (row) {
        for (int j = 0; j < oh; ++j) {
          const AxisTap t =
              axis_tap(axis_sample_at(theta_t, theta_s, grid_g[j], Hf));
          RowTap rt;
          rt.w_lo = t.w_lo;
          rt.w_hi = t.w_hi;
          rt.lo = t.w_lo != 0.0f && t.p0 >= row0 && t.p0 < row1
                      ? (t.p0 - row0) * row_bytes : -1;
          rt.hi = t.w_hi != 0.0f && t.p0 + 1 >= row0 && t.p0 + 1 < row1
                      ? (t.p0 + 1 - row0) * row_bytes : -1;
          row_tab[b * oh + j] = rt;
          if (rt.lo >= 0 || rt.hi >= 0) m |= 1u << j;
        }
        tab_rows[b] = m;
      } else {
        for (int j = 0; j < ow; ++j) {
          const AxisTap t =
              axis_tap(axis_sample_at(theta_t, theta_s, grid_g[oh + j], Wf));
          col_tab[b * ow + j] = t;
          if (t.w_lo != 0.0f && t.p0 >= col0 && t.p0 < col1)
            m |= 1u << (t.p0 - col0);
          if (t.w_hi != 0.0f && t.p0 + 1 >= col0 && t.p0 + 1 < col1)
            m |= 1u << (t.p0 + 1 - col0);
        }
        tab_cols[b] = m;
      }
    }
    __syncthreads();
    // the boxes reaching the region are staged in order: their slot uses,
    // counted from the first group's first box (-1: not staged)
    if (warp == 0) {
      int used = *staged_total;
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int b = b0 + lane;
        const bool in = b < nb && tab_rows[b] != 0u && tab_cols[b] != 0u;
        const unsigned ins = __ballot_sync(kFull, in);
        if (b < nb)
          tab_slot[b] = in ? used + __popc(ins & ((1u << lane) - 1u)) : -1;
        used += __popc(ins);
      }
      __syncwarp();
      if (lane == 0) *staged_total = used;
    }
    __syncthreads();

    if (warp == consumers) {
      // the producer: the staged boxes in order, each as soon as its slot
      // is free (the warps that use it are done with it; for the others
      // the producer arrives itself). It marks each slot with its use
      // first: a consumer that passed the slot's last uses waits for its own
      // mark before the slot's barrier, whose phases it has not all seen.
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int bl = b0 + lane;
        for (unsigned todo = __ballot_sync(kFull, bl < nb && tab_slot[bl] >= 0);
             todo != 0; todo &= todo - 1) {
          const int b = b0 + __ffs(todo) - 1;
          const int q = tab_slot[b];
          const int s = q % stages;
          if (q >= stages) mbar_wait(&empty[s], (q / stages - 1) & 1);
          if (lane == 0) slot_use[s] = q;
          GT* slab = reinterpret_cast<GT*>(ring + s * slot_bytes);
          const long long box = static_cast<long long>(n) * R + r0 + b;
          if (staging == kBulk) {
            if (lane == 0) {
              const unsigned bytes = kc * ohw * sizeof(GT);
              mbar_expect_tx(&full[s], bytes);
              bulk_copy(slab, grad + (box * C + c0) * ohw, bytes, &full[s]);
            }
          } else if (staging == kAsync) {
            // NHWC: oh*ow runs of kc channels, 16 bytes a copy
            constexpr int kPer = 16 / sizeof(GT);
            const GT* src = grad + box * ohw * C + c0;
            const int per = kc / kPer;
            for (int i = lane; i < ohw * per; i += 32) {
              const int cell = i / per, p = i - cell * per;
              cp_async16(slab + cell * kChan + p * kPer,
                         src + cell * C + p * kPer);
            }
            cp_async_arrive(&full[s]);
          }
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(&full[s]);
            const int hits = __popc(tab_cols[b]);
            if (hits < consumers) mbar_arrive_n(&empty[s], consumers - hits);
          }
        }
      }
    } else {
      // a consumer: column w of the region, this lane's channels (in range)
      const int w = col0 + warp;
      const unsigned col_bit = 1u << warp;
      const int k0 = min(2 * lane, kc - 1), k1 = min(2 * lane + 1, kc - 1);
      // the gradient's strides: channel, cell
      const int kstride = kChw ? ohw : 1;
      const int cstride = kChw ? 1 : (staging == kDirect ? C : kChan);
      unsigned char* col_sums = reinterpret_cast<unsigned char*>(
          sums + warp * kChan + 2 * lane);
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int bl = b0 + lane;
        const bool hit =
            bl < nb && tab_slot[bl] >= 0 && (tab_cols[bl] & col_bit);
        for (unsigned mine = __ballot_sync(kFull, hit); mine != 0;
             mine &= mine - 1) {
          const int b = b0 + __ffs(mine) - 1;
          const int q = tab_slot[b];
          const int s = q % stages;
          // once the slot holds this use or waits for it, the barrier's last
          // completed phase is this use's or the one before
          while (slot_use[s] != q) __nanosleep(32);
          mbar_wait(&full[s], (q / stages) & 1);
          const long long box = static_cast<long long>(n) * R + r0 + b;
          // lane x: output column x's weight on this column; the x where it
          // is not 0, the first two kept in registers
          const float v =
              lane < ow ? tap_weight(col_tab[b * ow + lane], w) : 0.0f;
          unsigned xs = __ballot_sync(kFull, v != 0.0f);
          const int xa = __ffs(xs) - 1;
          xs &= xs - 1;
          const int xb = xs != 0 ? __ffs(xs) - 1 : -1;
          xs &= xs - 1;
          const float wa = __shfl_sync(kFull, v, xa);
          const float wb = __shfl_sync(kFull, v, xb < 0 ? 0 : xb);
          const RowTap* rows = row_tab + b * oh;
          const unsigned ys = tab_rows[b];
          // the box's rows, from the staged slab (shared memory) or from
          // device memory: the two calls are compiled apart, so each
          // addresses its own space
          const auto visit = [&](const GT* g) {
            const GT* ga0 = g + k0 * kstride + xa * cstride;
            const GT* ga1 = g + k1 * kstride + xa * cstride;
            const int db = (xb - xa) * cstride;
            const int dy = ow * cstride;
            // inner = sum over x, in order, of Cx[x, w] * g[y, x, c]
            const auto inner = [&](int y, float& in0, float& in1) {
              const int gy = y * dy;
              in0 = fmaf(wa, widen(ga0[gy]), 0.0f);
              in1 = fmaf(wa, widen(ga1[gy]), 0.0f);
              if (xb >= 0) {
                in0 = fmaf(wb, widen(ga0[gy + db]), in0);
                in1 = fmaf(wb, widen(ga1[gy + db]), in1);
              }
              for (unsigned r = xs; r != 0; r &= r - 1) {
                const int x = __ffs(r) - 1;
                const float wx = __shfl_sync(kFull, v, x);
                const int dx = gy + (x - xa) * cstride;
                in0 = fmaf(wx, widen(ga0[dx]), in0);
                in1 = fmaf(wx, widen(ga1[dx]), in1);
              }
            };
            // then Ry: onto each row's two taps, in row order
            const auto add = [&](int off, float w, float in0, float in1) {
              float2* a = reinterpret_cast<float2*>(col_sums + off);
              float2 sum = *a;
              sum.x = fmaf(w, in0, sum.x);
              sum.y = fmaf(w, in1, sum.y);
              *a = sum;
            };
            unsigned m = ys;
            for (; m != 0; m &= m - 1) {
              const int y = __ffs(m) - 1;
              const RowTap t = rows[y];
              float in0, in1;
              inner(y, in0, in1);
              if (t.lo >= 0) add(t.lo, t.w_lo, in0, in1);
              if (t.hi >= 0) add(t.hi, t.w_hi, in0, in1);
            }
          };
          if (staging == kDirect)
            visit(grad + (kChw ? (box * C + c0) * ohw : box * ohw * C + c0));
          else
            visit(reinterpret_cast<const GT*>(ring + s * slot_bytes));
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
      }
    }
  }
  if (R == 0) __syncthreads();   // the sums' zeros
  if (warp == consumers) {
    if (staging == kAsync) cp_async_wait_all();
    return;
  }
  const int w = col0 + warp;
  if (w >= col1) return;
  for (int h = row0; h < row1; ++h) {
    const float* s = sums + ((h - row0) * consumers + warp) * kChan;
    FT* out = dF + ((static_cast<long long>(n) * Hf + h) * Wf + w) * C + c0;
    for (int k = lane; k < kc; k += 32) out[k] = narrow<FT>(s[k]);
  }
}

// ---------------------------------------------------------------- kernel B

// A slot of kernel B's ring: the box (-1 ends the walk), its oh + ow
// samples, each consumer warp's sums per output row and column, each axis
// index's du and g_j, then its whole gradient (none when not staged). After
// the ring, each consumer warp's per-lane sums per output column.
struct BoxSlot {
  int samples, row_sums, col_sums, du, gj, slab, bytes;
};
constexpr int kSlotHead = 16;

template <typename GT>
__host__ __device__ constexpr BoxSlot box_slot(int oh, int ow, int C,
                                              bool staged) {
  BoxSlot s{};
  s.samples = kSlotHead;
  s.row_sums = s.samples + (oh + ow) * static_cast<int>(sizeof(AxisSample));
  s.col_sums = s.row_sums + kBoxWarps * oh * 4;
  s.du = s.col_sums + kBoxWarps * ow * 4;
  s.gj = s.du + (oh + ow) * 4;
  s.slab = round16(s.gj + (oh + ow) * 4);
  s.bytes = round16(s.slab + (staged ? C * oh * ow *
                                           static_cast<int>(sizeof(GT))
                                     : 0));
  return s;
}
__host__ __device__ constexpr int boxes_smem(int slot_bytes, int stages,
                                             int ow) {
  return 2 * kBoxMaxStages * 8 + stages * slot_bytes + kBoxWarps * ow * 32 * 4;
}

// kV channels of the map in one load, and each widened
template <typename T, int kV>
struct Pack {
  using type = T;
};
template <>
struct Pack<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
};
template <>
struct Pack<float, 2> {
  using type = float2;
};
__device__ __forceinline__ float lane_of(float v, int) { return v; }
__device__ __forceinline__ float lane_of(__nv_bfloat16 v, int) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float lane_of(float2 v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ float lane_of(__nv_bfloat162 v, int i) {
  return i == 0 ? __low2float(v) : __high2float(v);
}
template <typename P>
__device__ __forceinline__ P load_or_zero(const P* p, bool ok) {
  if (ok) return *p;
  P z;
  memset(&z, 0, sizeof(P));
  return z;
}

// Kernel B. Persistent: block b takes boxes b, b + grid, ... of the N * R;
// warps 0 .. 7 consume, warp 8 produces. Consumer warp w takes the channel
// groups (of 32 kV) w, w + 8, ...; lane l channels kV l .. kV l + kV - 1 of
// each. It walks the box's cells row by row, kCells of a row at a time (the
// four taps of each in flight together, along C, from the map in L2; where
// cells share taps, as a small box's do, the loads meet in L1), and sums
// per lane, in a fixed order, each row's d out / d frac_y in a register and
// each column's d out / d frac_x in its own shared slot. Then shuffle trees
// over the lanes, and warp 0 sums the warps in order and applies the chain
// rule.
template <typename GT, typename T, bool kChw, int kV>
__global__ void __launch_bounds__(kBoxThreads + 32, 2)
roi_bwd_boxes_kernel(const T* __restrict__ feat,
                     const float* __restrict__ boxes,
                     const GT* __restrict__ grad, float* __restrict__ d_boxes,
                     int total, int R, int Hf, int Wf, int C, int oh, int ow,
                     float ih, float iw, int staged, int stages) {
  using P = typename Pack<T, kV>::type;
  constexpr int kCells = sizeof(P) <= 4 ? 8 : 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kBoxMaxStages;
  unsigned char* ring = smem + 2 * kBoxMaxStages * 8;
  const BoxSlot at = box_slot<GT>(oh, ow, C, staged);
  float* col_slots = reinterpret_cast<float*>(ring + stages * at.bytes);
  const int ohw = oh * ow;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);     // warp 0, once the box is finished
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kBoxWarps) {
    // the producer: this block's boxes in order; the copy first, then the
    // samples
    int stage = 0;
    unsigned phase = 0;
    for (int box = blockIdx.x; box < total; box += gridDim.x) {
      mbar_wait(&empty[stage], phase ^ 1u);
      unsigned char* slot = ring + stage * at.bytes;
      if (staged && lane == 0) {
        const unsigned bytes = static_cast<unsigned>(C) * ohw * sizeof(GT);
        mbar_expect_tx(&full[stage], bytes);
        bulk_copy(slot + at.slab,
                  grad + static_cast<long long>(box) * C * ohw, bytes,
                  &full[stage]);
      }
      AxisSample* samples = reinterpret_cast<AxisSample*>(slot + at.samples);
      const float* b = boxes + static_cast<long long>(box) * 4;
      for (int k = lane; k < oh + ow; k += 32) {
        const bool row = k < oh;
        samples[k] = axis_sample(row ? b[1] : b[0], row ? b[3] : b[2],
                                 row ? k : k - oh, row ? oh : ow,
                                 row ? Hf : Wf, row ? ih : iw);
      }
      if (lane == 0) *reinterpret_cast<int*>(slot) = box;
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    mbar_wait(&empty[stage], phase ^ 1u);
    if (lane == 0) {
      *reinterpret_cast<int*>(ring + stage * at.bytes) = -1;
      mbar_arrive(&full[stage]);
    }
    return;
  }

  // the gradient's strides: channel, cell
  const int kstride = kChw ? ohw : 1;
  const int cstride = kChw ? 1 : C;
  const int groups = (C + 32 * kV - 1) / (32 * kV);
  float* my_cols = col_slots + warp * ow * 32 + lane;   // this lane's own
  int stage = 0;
  unsigned phase = 0;
  for (;;) {
    mbar_wait(&full[stage], phase);
    unsigned char* slot = ring + stage * at.bytes;
    const int box = *reinterpret_cast<const int*>(slot);
    if (box < 0) break;
    const AxisSample* samples =
        reinterpret_cast<const AxisSample*>(slot + at.samples);
    float* row_sums = reinterpret_cast<float*>(slot + at.row_sums);
    float* col_sums = reinterpret_cast<float*>(slot + at.col_sums);
    const T* f = feat + static_cast<long long>(box / R) * Hf * Wf * C;
    for (int x = 0; x < ow; ++x) my_cols[x * 32] = 0.0f;

    const GT* g = staged ? reinterpret_cast<const GT*>(slot + at.slab)
                         : grad + static_cast<long long>(box) * C * ohw;
    for (int y = 0; y < oh; ++y) {
      const AxisSample sy = samples[y];
      const float wy_lo = sy.lo_ok ? 1.0f - sy.frac : 0.0f;
      const float wy_hi = sy.hi_ok ? sy.frac : 0.0f;
      // the taps' rows (read only where the pixel lies in the map)
      const T* f0 = f + static_cast<long long>(sy.p0) * Wf * C;
      const T* f1 = f0 + static_cast<long long>(Wf) * C;
      float dy = 0.0f;
      for (int x0 = 0; x0 < ow; x0 += kCells) {
        float dxc[kCells];
#pragma unroll
        for (int u = 0; u < kCells; ++u) dxc[u] = 0.0f;
        for (int grp = warp; grp < groups; grp += kBoxWarps) {
          const int c = (grp * 32 + lane) * kV;
          P t00[kCells], t01[kCells], t10[kCells], t11[kCells];
#pragma unroll
          for (int u = 0; u < kCells; ++u) {
            const bool in = x0 + u < ow && c < C;
            const AxisSample sx = samples[oh + min(x0 + u, ow - 1)];
            const long long px = static_cast<long long>(sx.p0) * C + c;
            t00[u] = load_or_zero(reinterpret_cast<const P*>(f0 + px),
                                  in && sy.lo_ok && sx.lo_ok);
            t01[u] = load_or_zero(reinterpret_cast<const P*>(f0 + px + C),
                                  in && sy.lo_ok && sx.hi_ok);
            t10[u] = load_or_zero(reinterpret_cast<const P*>(f1 + px),
                                  in && sy.hi_ok && sx.lo_ok);
            t11[u] = load_or_zero(reinterpret_cast<const P*>(f1 + px + C),
                                  in && sy.hi_ok && sx.hi_ok);
          }
          if (c >= C) continue;
#pragma unroll
          for (int u = 0; u < kCells; ++u) {
            if (x0 + u >= ow) break;
            const AxisSample sx = samples[oh + x0 + u];
            const float wx_lo = sx.lo_ok ? 1.0f - sx.frac : 0.0f;
            const float wx_hi = sx.hi_ok ? sx.frac : 0.0f;
            const GT* gc = g + (y * ow + x0 + u) * cstride;
#pragma unroll
            for (int v = 0; v < kV; ++v) {
              const float gv = widen(gc[(c + v) * kstride]);
              const float f00 = lane_of(t00[u], v), f01 = lane_of(t01[u], v);
              const float f10 = lane_of(t10[u], v), f11 = lane_of(t11[u], v);
              // d out / d frac_y = sum_w Cx[x, w] (F[y0 + 1, w] - F[y0, w]),
              // and the same across for frac_x
              dy = fmaf(gv, wx_lo * (f10 - f00) + wx_hi * (f11 - f01), dy);
              dxc[u] = fmaf(gv, wy_lo * (f01 - f00) + wy_hi * (f11 - f10),
                            dxc[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kCells; ++u)
          if (x0 + u < ow) my_cols[(x0 + u) * 32] += dxc[u];
      }
      dy = warp_sum(dy);
      if (lane == 0) row_sums[warp * oh + y] = dy;
    }
    for (int x = 0; x < ow; ++x) {
      const float dx = warp_sum(my_cols[x * 32]);
      if (lane == 0) col_sums[warp * ow + x] = dx;
    }
    consumers_sync(kBoxThreads);

    if (warp == 0) {
      // each axis index: the warps' sums in warp order
      float* du = reinterpret_cast<float*>(slot + at.du);
      float* gj = reinterpret_cast<float*>(slot + at.gj);
      for (int k = lane; k < oh + ow; k += 32) {
        const bool row = k < oh;
        const float* sums = row ? row_sums + k : col_sums + k - oh;
        const int stride = row ? oh : ow;
        float sum = 0.0f;
        for (int w = 0; w < kBoxWarps; ++w) sum += sums[w * stride];
        // p = ((u + 1) * in - 1) / 2
        du[k] = sum * 0.5f * static_cast<float>(row ? Hf : Wf);
        gj[k] = samples[k].g;
      }
      __syncwarp();
      if (lane < 2) {
        // lane 0: rows -> (yc, h); lane 1: columns -> (xc, w)
        const bool row = lane == 0;
        const int first = row ? 0 : oh, out = row ? oh : ow;
        const float image = row ? ih : iw;
        float d_t = 0.0f, d_s = 0.0f;
        for (int j = first; j < first + out; ++j) {
          d_t += du[j];
          d_s = fmaf(du[j], gj[j], d_s);
        }
        // theta_t = (2c - 1 - S) / (S - 1), theta_s = s / S
        float* d = d_boxes + static_cast<long long>(box) * 4;
        d[row ? 1 : 0] = __fdiv_rn(d_t, image - 1.0f) * 2.0f;
        d[row ? 3 : 2] = __fdiv_rn(d_s, image);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
}

// ---------------------------------------------------------------- general

// The staged kernels' limits: a slab of at most 256 cells, and at most 32
// output rows and columns (one bit each in a 32-bit mask, one lane each).
__host__ __device__ constexpr bool staged_shape(int oh, int ow) {
  return oh <= 32 && ow <= 32 && oh * ow <= 256;
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
            tap_weight(axis_tap(axis_sample(box[1], box[3], y, oh, Hf, ih)), h);
        if (wy == 0.0f) continue;
        float inner = 0.0f;
        for (int x = 0; x < ow; ++x) {
          const float wx =
              tap_weight(axis_tap(axis_sample(box[0], box[2], x, ow, Wf, iw)), w);
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

// Kernel B, general. Block `box` (256 threads): warp w takes the box's axis
// indices j = w, w + 8, ... of the oh rows, then the ow columns; lane l its
// channels l, l + 32, ..., each walking the other axis in order; a shuffle
// tree sums the lanes into du_j. Then threads 0 and 1 apply the chain rule
// along the rows and the columns. Dynamic shared memory: 2 (oh + ow) floats.
template <typename GT, typename T, bool kChw>
__global__ void __launch_bounds__(kThreads)
roi_bwd_boxes_general(const T* __restrict__ feat,
                      const float* __restrict__ boxes,
                      const GT* __restrict__ grad, float* __restrict__ d_boxes,
                      int R, int Hf, int Wf, int C, int oh, int ow, float ih,
                      float iw) {
  extern __shared__ float du[];           // oh + ow, then their g_j
  float* gj = du + oh + ow;
  const long long box = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long ohw = static_cast<long long>(oh) * ow;
  const float* b = boxes + box * 4;
  const T* f = feat + (box / R) * Hf * Wf * C;
  const GT* g = grad + box * ohw * C;
  for (int j = warp; j < oh + ow; j += kThreads / 32) {
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
      for (int k = lane; k < C; k += 32) {
        const float f00 = sy.lo_ok && sx.lo_ok
                              ? widen(f[(y0 * Wf + x0) * C + k]) : 0.0f;
        const float f01 = sy.lo_ok && sx.hi_ok
                              ? widen(f[(y0 * Wf + x0 + 1) * C + k]) : 0.0f;
        const float f10 = sy.hi_ok && sx.lo_ok
                              ? widen(f[((y0 + 1) * Wf + x0) * C + k]) : 0.0f;
        const float f11 = sy.hi_ok && sx.hi_ok
                              ? widen(f[((y0 + 1) * Wf + x0 + 1) * C + k])
                              : 0.0f;
        const long long at = kChw ? k * ohw + y * ow + x
                                  : (y * static_cast<long long>(ow) + x) * C + k;
        const float gv = widen(g[at]);
        // rows: d out / d frac_y; columns: d out / d frac_x
        sum = fmaf(gv,
                   row ? wx_lo * (f10 - f00) + wx_hi * (f11 - f01)
                       : wy_lo * (f01 - f00) + wy_hi * (f11 - f10),
                   sum);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      du[j] = sum * 0.5f * static_cast<float>(row ? Hf : Wf);
      gj[j] = axis_sample(row ? b[1] : b[0], row ? b[3] : b[2], fixed,
                          row ? oh : ow, row ? Hf : Wf, row ? ih : iw).g;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const bool row = threadIdx.x == 0;
    const int first = row ? 0 : oh, out = row ? oh : ow;
    const float image = row ? ih : iw;
    float d_t = 0.0f, d_s = 0.0f;
    for (int j = first; j < first + out; ++j) {
      d_t += du[j];
      d_s = fmaf(du[j], gj[j], d_s);
    }
    d_boxes[box * 4 + (row ? 1 : 0)] = __fdiv_rn(d_t, image - 1.0f) * 2.0f;
    d_boxes[box * 4 + (row ? 3 : 2)] = __fdiv_rn(d_s, image);
  }
}

// ---------------------------------------------------------------- launches

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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Kernel A's split of an (n, hf, wf, c) map into regions, a block each per
// 64-channel chunk: rows into `groups`, columns into `passes`, as equal as
// they go, a region at most kRegionRows x kMaxColumns (a warp a column, its
// sums in shared memory), so that a box's gradient is staged once for each
// region it reaches. While that leaves more than half of the `sms` SMs idle,
// the region is cut again along its longer side, so that small maps still
// fill the card: 45x45 at N=4 -> 2 x 2 regions of 23x23; 22x22 at N=4 ->
// 2 x 2 regions of 11x11.
void features_tile(int n, int hf, int wf, int c, int sms, int& groups,
                   int& passes) {
  groups = ceil_div(hf, kRegionRows);
  passes = ceil_div(wf, kMaxColumns);
  int rows = ceil_div(hf, groups), cols = ceil_div(wf, passes);
  const long long chunks = ceil_div(c, kChan);
  while (2 * n * chunks * groups * passes <= sms && (rows > 1 || cols > 1)) {
    if (rows >= cols) {
      groups = ceil_div(hf, rows - 1);
      rows = ceil_div(hf, groups);
    } else {
      passes = ceil_div(wf, cols - 1);
      cols = ceil_div(wf, passes);
    }
  }
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
  int device = 0, sms = 0, groups = 0, passes = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  features_tile(n, hf, wf, c, sms, groups, passes);
  if (static_cast<long long>(groups) * passes > kMaxGrid || n > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = ceil_div(hf, groups);
  const int consumers = ceil_div(wf, passes);
  const int ohw = oh * ow;
  const int s = static_cast<int>(sizeof(GT));
  int staging = kDirect;
  if (kChw && aligned(grad, 16) && (c * ohw * s) % 16 == 0 &&
      (c % kChan * ohw * s) % 16 == 0)
    staging = kBulk;      // every chunk one aligned run of whole 16 bytes
  else if (!kChw && aligned(grad, 16) && (c * s) % 16 == 0)
    staging = kAsync;     // every run of channels whole 16-byte pieces
  // the region's sums and one box's taps always fit (143 KB at most); the
  // gradient is staged only where two slots fit beside them
  const int fixed = features_smem(0, 0, rows, consumers, oh, ow, 0);
  const int per_box = features_table_box_bytes(oh, ow);
  if (fixed + 2 * features_slot_bytes<GT>(oh, ow, staging) + per_box >
      kSmemOptIn)
    staging = kDirect;
  const int slot_bytes = features_slot_bytes<GT>(oh, ow, staging);
  // the taps of all boxes, or of as many as kTableBytes holds a group (one
  // group, of no box, when there are none: it still writes d_F's zeros); as
  // many slots as fit in kRingBytes and what is left (one per box at most,
  // 2 at least); then the table grown into the rest
  const int most = r > 1 ? r : 1;
  int table_boxes = kTableBytes / per_box;
  table_boxes = table_boxes > most ? most : table_boxes;
  int ring = kSmemOptIn - fixed - table_boxes * per_box;
  ring = ring > kRingBytes ? kRingBytes : ring;
  int stages = slot_bytes > 0 ? ring / slot_bytes : kMaxStages;
  stages = stages > most ? most : stages;
  stages = stages < 2 ? 2 : stages > kMaxStages ? kMaxStages : stages;
  table_boxes = (kSmemOptIn - fixed - stages * slot_bytes) / per_box;
  table_boxes = table_boxes > most ? most : table_boxes;
  const int smem =
      features_smem(slot_bytes, stages, rows, consumers, oh, ow, table_boxes);
  const auto kernel = roi_bwd_features_kernel<GT, FT, kChw>;
  if (const int err = allow_smem(kernel, smem)) return err;
  const dim3 grid(ceil_div(c, kChan), groups * passes, n);
  kernel<<<grid, (consumers + 1) * 32, smem, stream>>>(
      static_cast<const GT*>(grad), static_cast<const float*>(boxes),
      static_cast<FT*>(dF), r, hf, wf, c, oh, ow, ih, iw, groups, passes,
      staging, stages, table_boxes);
  return static_cast<int>(cudaGetLastError());
}

template <typename GT, typename T, bool kChw>
int launch_boxes(const void* feat, const void* boxes, const void* grad,
                 void* d_boxes, int n, int r, int hf, int wf, int c, int oh,
                 int ow, float ih, float iw, cudaStream_t stream) {
  const int total = n * r;
  if (!staged_shape(oh, ow)) {
    roi_bwd_boxes_general<GT, T, kChw>
        <<<total, kThreads, 2 * (oh + ow) * sizeof(float), stream>>>(
            static_cast<const T*>(feat), static_cast<const float*>(boxes),
            static_cast<const GT*>(grad), static_cast<float*>(d_boxes), r, hf,
            wf, c, oh, ow, ih, iw);
    return static_cast<int>(cudaGetLastError());
  }
  const int ohw = oh * ow;
  const long long slab = static_cast<long long>(c) * ohw * sizeof(GT);
  // the whole box in one bulk copy where one slot of it fits in a block's
  // ring of kBoxRingBytes, so that two blocks share an SM: where only one
  // slot fits (fp32 at C = 512), the other block's reduction hides the copy
  const bool staged =
      aligned(grad, 16) && slab % 16 == 0 && slab <= kBoxRingBytes &&
      box_slot<GT>(oh, ow, c, true).bytes <= kBoxRingBytes;
  const BoxSlot at = box_slot<GT>(oh, ow, staged ? c : 0, staged);
  int stages = kBoxRingBytes / at.bytes;
  stages = stages > kBoxMaxStages ? kBoxMaxStages : stages;
  const int smem = boxes_smem(at.bytes, stages, ow);
  // two channels a load where they are whole, aligned pairs
  const bool pairs = c % 2 == 0 && aligned(feat, 2 * sizeof(T));
  const auto kernel = pairs ? &roi_bwd_boxes_kernel<GT, T, kChw, 2>
                            : &roi_bwd_boxes_kernel<GT, T, kChw, 1>;
  if (const int err = allow_smem(kernel, smem)) return err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kBoxThreads + 32, smem))
    return static_cast<int>(err);
  const int blocks = total < sms * per_sm ? total : sms * per_sm;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kBoxThreads + 32, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(boxes),
      static_cast<const GT*>(grad), static_cast<float*>(d_boxes), total, r,
      hf, wf, c, oh, ow, ih, iw, staged, stages);
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
// or bf16 (out_bf16); zeros where r is 0. Any oh and ow: beyond the staged
// kernel's limits the general kernel runs.
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
