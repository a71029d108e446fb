"""Where kernels A and B spend their time, block by block and warp by warp,
on one CUDA card.

    python -m imagecaptioning_tpu_torch.tools.bwd_timeline

Builds a copy of `csrc/roi_align_bwd.cu` (into `build/kernels/timeline/`)
whose kernels A and B record, per block, the card's global timer at its
start, once its first table of taps is built (kernel A) and at each warp's
end, with its SM clock cycles; and, per warp, the clock cycles it spent
waiting on the ring's barriers (a consumer for a full slot, the producer
for an empty one), the cycles a consumer spent on the boxes it worked on
(kernel A: the boxes reaching its tile; kernel B: its cells of each box),
and how many boxes that was. The copy computes what the kernels do (only
the records are added). It runs the copy at the RPN training shape (4
images × 256 boxes placed as the RPN samples them: the reference anchors,
some partly outside the 720² image, the second half repeated; a 45×45×512
map) and at the GT training shape (4 × 32 edge boxes, 22×22×512, 720²),
bf16 map with bf16 CHW gradient, after 5 warm-up launches, and prints per
kernel and shape: the blocks, the span of the launch, the SM clock, the
latest block start (a second wave shows there), the median block's time
before its first box and in all, and per consumer warp the median share
of its time waiting for a full slot and working, the busiest warp's work,
and the producer's share waiting for an empty slot (a full ring: the
consumers are behind). Run from the repository root.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from imagecaptioning_tpu_torch.ops import _kernels
from imagecaptioning_tpu_torch.ops import roi_align as roi

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "kernels" / "timeline"
SEED = 0
MAX_BLOCKS = 8192            # records a kernel keeps
MAX_WARPS = 32

# (text in the source, its replacement): the records
EDITS = [
    ("constexpr int kMaxGrid = 65535;",
     '__device__ __forceinline__ unsigned long long gtimer() {\n'
     '  unsigned long long t;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     '  return t;\n}\n'
     f"__device__ unsigned long long g_blk[2][{MAX_BLOCKS} * 4];\n"
     f"__device__ long long g_warp[2][{MAX_BLOCKS} * {MAX_WARPS} * 4];\n"
     # kernel 0 (A) or 1 (B): the warp's waits, work, boxes and end
     "__device__ __forceinline__ void record(int kernel, long long wait,\n"
     "    long long busy, long long boxes, unsigned long long t_start,\n"
     "    unsigned long long t_first, long long c_start) {\n"
     "  const int blk = blockIdx.x + gridDim.x * (blockIdx.y +\n"
     "                                            gridDim.y * blockIdx.z);\n"
     f"  if (blk >= {MAX_BLOCKS} || threadIdx.x % 32 != 0) return;\n"
     f"  long long* w = g_warp[kernel] + (blk * {MAX_WARPS} + "
     "threadIdx.x / 32) * 4;\n"
     "  w[0] = wait; w[1] = busy; w[2] = boxes;\n"
     "  w[3] = static_cast<long long>(gtimer());\n"
     "  if (threadIdx.x == 0) {\n"
     "    g_blk[kernel][blk * 4 + 0] = t_start;\n"
     "    g_blk[kernel][blk * 4 + 1] = t_first;\n"
     "    g_blk[kernel][blk * 4 + 2] = clock64() - c_start;\n"
     "  }\n}\n"
     "constexpr int kMaxGrid = 65535;"),
    # kernel A
    ("  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;\n\n"
     "  const int c0 = blockIdx.x * kChan;",
     "  const unsigned long long t_start = gtimer();\n"
     "  const long long c_start = clock64();\n"
     "  unsigned long long t_first = 0;\n"
     "  long long wait = 0, busy = 0, worked = 0;\n"
     "  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;\n\n"
     "  const int c0 = blockIdx.x * kChan;"),
    ("        tab_cols[b] = m;\n"
     "      }\n"
     "    }\n"
     "    __syncthreads();\n",
     "        tab_cols[b] = m;\n"
     "      }\n"
     "    }\n"
     "    __syncthreads();\n"
     "    if (t_first == 0) t_first = gtimer();\n"),
    ("          if (q >= stages) mbar_wait(&empty[s], (q / stages - 1) & 1);",
     "          const long long tw = clock64();\n"
     "          if (q >= stages) mbar_wait(&empty[s], (q / stages - 1) & 1);\n"
     "          wait += clock64() - tw;"),
    ("          while (slot_use[s] != q) __nanosleep(32);\n"
     "          mbar_wait(&full[s], (q / stages) & 1);",
     "          const long long tw = clock64();\n"
     "          while (slot_use[s] != q) __nanosleep(32);\n"
     "          mbar_wait(&full[s], (q / stages) & 1);\n"
     "          const long long tb = clock64();\n"
     "          wait += tb - tw;"),
    ("          __syncwarp();\n"
     "          if (lane == 0) mbar_arrive(&empty[s]);",
     "          busy += clock64() - tb;\n"
     "          ++worked;\n"
     "          __syncwarp();\n"
     "          if (lane == 0) mbar_arrive(&empty[s]);"),
    ("  if (R == 0) __syncthreads();   // the sums' zeros\n",
     "  record(0, wait, busy, worked, t_start, t_first, c_start);\n"
     "  if (R == 0) __syncthreads();   // the sums' zeros\n"),
    # kernel B
    ("  const BoxSlot at = box_slot<GT>(oh, ow, C, staged);",
     "  const unsigned long long t_start = gtimer();\n"
     "  const long long c_start = clock64();\n"
     "  long long wait = 0, busy = 0, worked = 0;\n"
     "  const BoxSlot at = box_slot<GT>(oh, ow, C, staged);"),
    ("      mbar_wait(&empty[stage], phase ^ 1u);\n"
     "      unsigned char* slot = ring + stage * at.bytes;",
     "      const long long tw = clock64();\n"
     "      mbar_wait(&empty[stage], phase ^ 1u);\n"
     "      wait += clock64() - tw;\n"
     "      unsigned char* slot = ring + stage * at.bytes;"),
    ("    mbar_wait(&empty[stage], phase ^ 1u);\n"
     "    if (lane == 0) {\n"
     "      *reinterpret_cast<int*>(ring + stage * at.bytes) = -1;\n"
     "      mbar_arrive(&full[stage]);\n"
     "    }\n"
     "    return;",
     "    mbar_wait(&empty[stage], phase ^ 1u);\n"
     "    if (lane == 0) {\n"
     "      *reinterpret_cast<int*>(ring + stage * at.bytes) = -1;\n"
     "      mbar_arrive(&full[stage]);\n"
     "    }\n"
     "    record(1, wait, busy, worked, t_start, t_start, c_start);\n"
     "    return;"),
    ("    mbar_wait(&full[stage], phase);\n"
     "    unsigned char* slot = ring + stage * at.bytes;\n"
     "    const int box = *reinterpret_cast<const int*>(slot);\n"
     "    if (box < 0) break;",
     "    const long long tw = clock64();\n"
     "    mbar_wait(&full[stage], phase);\n"
     "    wait += clock64() - tw;\n"
     "    unsigned char* slot = ring + stage * at.bytes;\n"
     "    const int box = *reinterpret_cast<const int*>(slot);\n"
     "    if (box < 0) {\n"
     "      record(1, wait, busy, worked, t_start, t_start, c_start);\n"
     "      break;\n"
     "    }\n"
     "    const long long tb = clock64();\n"
     "    ++worked;"),
    ("    consumers_sync(kBoxThreads);\n",
     "    busy += clock64() - tb;\n"
     "    const long long ts = clock64();\n"
     "    consumers_sync(kBoxThreads);\n"
     "    wait += clock64() - ts;\n"),
]
READERS = """
extern "C" int read_records(int kernel, unsigned long long* blocks,
                            long long* warps) {
  int err = (int)cudaMemcpyFromSymbol(blocks, g_blk, sizeof(g_blk[0]),
                                      kernel * sizeof(g_blk[0]));
  if (err) return err;
  return (int)cudaMemcpyFromSymbol(warps, g_warp, sizeof(g_warp[0]),
                                   kernel * sizeof(g_warp[0]));
}
extern "C" int clear_records() {
  static unsigned long long zb[sizeof(g_blk) / 8];
  static long long zw[sizeof(g_warp) / 8];
  int err = (int)cudaMemcpyToSymbol(g_blk, zb, sizeof(g_blk));
  return err ? err : (int)cudaMemcpyToSymbol(g_warp, zw, sizeof(g_warp));
}
"""


def instrumented_source() -> str:
    src = (_kernels.CSRC / "roi_align_bwd.cu").read_text()
    for old, new in EDITS:
        if old not in src:
            raise RuntimeError(f"the source no longer has:\n{old}")
        src = src.replace(old, new)
    return src + READERS


def edge_boxes(rng, n, r, image):
    """(n, r, 4) xcycwh boxes as `chip_smoke.py` makes them."""
    boxes = np.stack([rng.uniform(1, image, (n, r)),
                      rng.uniform(1, image, (n, r)),
                      rng.uniform(16, image / 2, (n, r)),
                      rng.uniform(16, image / 2, (n, r))], axis=-1)
    edge = [[(image + 1) / 2, (image + 1) / 2, image, image],
            [1.0, image / 2, image / 3, image / 3],
            [image, image / 2, image / 3, image / 3],
            [image / 2, 1.0, image / 3, image / 3],
            [image / 2, image, image / 3, image / 3],
            [image / 2, image / 2, 2 * image, 2 * image], [1.0, 1.0, 1.0, 1.0]]
    boxes[:, :len(edge)] = edge
    return boxes.astype(np.float32)


def anchor_boxes(rng, n, r, image):
    """(n, r, 4) boxes as the RPN samples them: the reference anchors at
    random centres, some partly outside the image, the second half the
    repeats of a few (the sampler's cycling of short negatives)."""
    from imagecaptioning_tpu_torch.models.densecap import REFERENCE_ANCHORS

    wh = np.asarray(REFERENCE_ANCHORS, np.float32)[rng.randint(0, 12, (n, r))]
    xy = rng.uniform(-40, image + 40, (n, r, 2)).astype(np.float32)
    boxes = np.concatenate([xy, wh], -1)
    boxes[:, r // 2:] = boxes[:, r // 2:r // 2 + 16].repeat(
        (r - r // 2) // 16, axis=1)
    return boxes


def summary(lib, kernel: int) -> tuple:
    """Print one kernel's records (the blocks that ran, each warp that
    recorded, the producer last) → (blocks, warps a block)."""
    b = np.zeros(MAX_BLOCKS * 4, np.uint64)
    w = np.zeros(MAX_BLOCKS * MAX_WARPS * 4, np.int64)
    if lib.read_records(kernel, b.ctypes.data, w.ctypes.data):
        raise RuntimeError("could not read the records")
    b = b.reshape(MAX_BLOCKS, 4).astype(np.int64)
    w = w.reshape(MAX_BLOCKS, MAX_WARPS, 4)
    ran = b[:, 0] > 0                 # a persistent grid runs fewer
    b, w = b[ran], w[ran]
    blocks = int(ran.sum())
    warps = int((w[:, :, 3] > 0).sum(1).max())
    w = w[:, :warps]
    t0 = b[:, 0].min()
    ends = w[:, :, 3].max(1)
    ghz = float(np.median(b[:, 2] / np.maximum(ends - b[:, 0], 1)))
    cycles = (ends - b[:, 0])[:, None] * ghz            # per block
    cons, prod = w[:, :-1], w[:, -1]
    share = lambda a: float(np.median(a / cycles))      # noqa: E731
    print(f"  {blocks} blocks of {warps} warps: span "
          f"{(ends.max() - t0) / 1e3:.2f} us, SM clock {ghz:.3f} GHz, "
          f"latest start {(b[:, 0].max() - t0) / 1e3:.2f} us")
    print(f"  median block: taps built after "
          f"{np.median(b[:, 1] - b[:, 0]) / 1e3:.2f} us, all "
          f"{np.median(ends - b[:, 0]) / 1e3:.2f} us")
    print(f"  consumer warps, median share of the block's time: waiting "
          f"{share(cons[:, :, 0]):.3f}, working {share(cons[:, :, 1]):.3f}; "
          f"boxes a warp: median {np.median(cons[:, :, 2]):.0f}, max "
          f"{cons[:, :, 2].max()}; the busiest warp's work, median over "
          f"blocks {np.median(cons[:, :, 1].max(1) / ghz) / 1e3:.2f} us")
    print(f"  producer: median share waiting for an empty slot "
          f"{float(np.median(prod[:, 0] / cycles[:, 0])):.3f}")
    return blocks, warps


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_timeline: no CUDA card", file=sys.stderr)
        return 1
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / "roi_align_bwd_timeline.cu"
    path.write_text(instrumented_source())
    lib = _kernels.bind_roi_align_bwd(
        ctypes.CDLL(str(_kernels.build("roi_align_bwd_timeline", path))))
    lib.read_records.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    _kernels.roi_align_bwd_lib = lambda: lib
    dev = torch.device("cuda:0")
    for name, n, r, hf, make in (("RPN training", 4, 256, 45, anchor_boxes),
                                 ("GT training", 4, 32, 22, edge_boxes)):
        rng = np.random.RandomState(SEED + 100 + n)
        feats = torch.from_numpy(rng.randn(n, hf, hf, 512).astype(
            np.float32)).to(dev).bfloat16()
        boxes = torch.from_numpy(make(rng, n, r, 720.0)).to(dev)
        grad = torch.from_numpy(rng.randn(n, r, 512 * 49).astype(
            np.float32)).to(dev).bfloat16()
        hw = (720.0, 720.0)
        for kernel, fn in ((0, roi.roi_align_bwd_features),
                           (1, roi.roi_align_bwd_boxes)):
            for _ in range(5):
                lib.clear_records()
                fn(feats, boxes, grad, hw)
            torch.cuda.synchronize()
            print(f"{name}, kernel {'AB'[kernel]}")
            blocks, warps = summary(lib, kernel)
            if kernel == 0:
                # a consumer warp a column of the region, 8 chunks of 64
                # channels of each image
                cols = warps - 1
                passes = -(-hf // cols)
                groups = blocks // (8 * n * passes)
                print(f"  regions {groups} x {passes} of "
                      f"{-(-hf // groups)}x{cols}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
