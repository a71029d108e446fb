"""Where kernel A's time goes, block by block, on one CUDA card.

    python -m imagecaptioning_tpu_torch.tools.bwd_timeline

Builds a copy of `csrc/roi_align_bwd.cu` (into `build/kernels/timeline/`)
whose kernel A records, per block, the card's global timer at its start,
after its taps and kept-box list, after its first batch of slabs has
landed, and at its end, with its SM clock cycles and kept boxes; and, per
warp, the clock cycles it spent walking its boxes. The copy computes
what the kernel does (only the records are added). It runs the copy at
the training shape (4 images × 32 boxes, 22×22×512, 720²) and the serving
shape (8 × 32, 16×16×512, 512²), bf16 map with bf16 CHW gradient, after
5 warm-up launches, and prints per shape: the span of the launch, the
SM clock, the latest block start (a second wave shows there), the median
block's prologue / staging wait / rest, and the slowest and the mean
warp's walk per block. Run from the repository root.
"""

from __future__ import annotations

import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import torch

from imagecaptioning_tpu_torch.ops import _kernels
from imagecaptioning_tpu_torch.ops import roi_align as roi

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "kernels" / "timeline"
SEED = 0

# (text in the source, its replacement): the records
EDITS = [
    ("constexpr int kMaxGrid = 65535;",
     '__device__ __forceinline__ unsigned long long gtimer() {\n'
     '  unsigned long long t;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     '  return t;\n}\n'
     "__device__ unsigned long long g_dbg[16384 * 8];\n"
     "__device__ long long g_warp[16384 * 8];\n"
     "constexpr int kMaxGrid = 65535;"),
    ("  const int ohw = oh * ow;\n"
     "  const int buf_bytes = features_buffer_bytes<GT>(ohw);",
     "  const unsigned long long t_start = gtimer();\n"
     "  const long long c_start = clock64();\n"
     "  unsigned long long t_pro = 0, t_staged = 0;\n"
     "  int total_kept = 0;\n"
     "  long long busy = 0;\n"
     "  const int ohw = oh * ow;\n"
     "  const int buf_bytes = features_buffer_bytes<GT>(ohw);"),
    ("    const int nk = n_kept;",
     "    const int nk = n_kept;\n"
     "    if (t_pro == 0) t_pro = gtimer();\n"
     "    total_kept += nk;"),
    ("      cp_async_wait<0>();\n"
     "      __syncthreads();\n"
     "      for (int i = 0; i < batch; ++i) {",
     "      cp_async_wait<0>();\n"
     "      __syncthreads();\n"
     "      if (t_staged == 0) t_staged = gtimer();\n"
     "      for (int i = 0; i < batch; ++i) {"),
    ("        const int b = kept[i0 + i];\n"
     "        const GT* g = buffer(i);",
     "        const long long tb = clock64();\n"
     "        const int b = kept[i0 + i];\n"
     "        const GT* g = buffer(i);"),
    ("      }\n"
     "      __syncthreads();  // the next batch overwrites the buffers",
     "        busy += clock64() - tb;\n"
     "      }\n"
     "      __syncthreads();  // the next batch overwrites the buffers"),
    ("#pragma unroll\n"
     "  for (int p = 0; p < kLaneChan; ++p) {\n"
     "    const int k = lane + 32 * p;",
     "  {\n"
     "    const int blk = blockIdx.x + gridDim.x * (blockIdx.y +\n"
     "                                              gridDim.y * blockIdx.z);\n"
     "    if (lane == 0) g_warp[blk * 8 + warp] = busy;\n"
     "    if (tid == 0) {\n"
     "      g_dbg[blk * 8 + 0] = t_start;\n"
     "      g_dbg[blk * 8 + 1] = t_pro;\n"
     "      g_dbg[blk * 8 + 2] = t_staged;\n"
     "      g_dbg[blk * 8 + 3] = gtimer();\n"
     "      g_dbg[blk * 8 + 4] = clock64() - c_start;\n"
     "      g_dbg[blk * 8 + 5] = total_kept;\n"
     "    }\n"
     "  }\n"
     "#pragma unroll\n"
     "  for (int p = 0; p < kLaneChan; ++p) {\n"
     "    const int k = lane + 32 * p;"),
]
READERS = """
extern "C" int read_blocks(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_dbg, n * 8 * 8);
}
extern "C" int read_warps(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_warp, n * 8 * 8);
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


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_timeline: no CUDA card", file=sys.stderr)
        return 1
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / "roi_align_bwd_timeline.cu"
    path.write_text(instrumented_source())
    lib = _kernels.bind_roi_align_bwd(
        ctypes.CDLL(str(_kernels.build("roi_align_bwd_timeline", path))))
    lib.read_blocks.argtypes = lib.read_warps.argtypes = [ctypes.c_void_p,
                                                          ctypes.c_int]
    _kernels.roi_align_bwd_lib = lambda: lib
    chan = int(re.search(r"constexpr int kChan = (\d+);",
                         path.read_text()).group(1))
    dev = torch.device("cuda:0")
    for n, hf, image in ((4, 22, 720), (8, 16, 512)):
        rng = np.random.RandomState(SEED + 100 + n)
        feats = torch.from_numpy(rng.randn(n, hf, hf, 512).astype(
            np.float32)).to(dev).bfloat16()
        boxes = torch.from_numpy(edge_boxes(rng, n, 32, image)).to(dev)
        grad = torch.from_numpy(rng.randn(n, 32, 512 * 49).astype(
            np.float32)).to(dev).bfloat16()
        hw = (float(image), float(image))
        for _ in range(5):
            roi.roi_align_bwd_features(feats, boxes, grad, hw)
        torch.cuda.synchronize()
        blocks = (512 // chan) * ((hf + 3) // 4) * n
        d = np.zeros((blocks, 8), np.uint64)
        w = np.zeros((blocks, 8), np.int64)
        if lib.read_blocks(d.ctypes.data, blocks) or lib.read_warps(
                w.ctypes.data, blocks):
            raise RuntimeError("could not read the records")
        t0 = d[:, 0].min()
        ghz = float(np.median(d[:, 4] / (d[:, 3] - d[:, 0])))

        def us(a):
            return np.asarray(a, float) / 1e3
        print(f"N={n}: {blocks} blocks, span {us(d[:, 3].max() - t0):.2f} "
              f"us, SM clock {ghz:.3f} GHz, latest start "
              f"{us(d[:, 0].max() - t0):.2f} us")
        print("  median block, us: prologue %.2f, staging wait %.2f, rest "
              "%.2f, all %.2f" % (np.median(us(d[:, 1] - d[:, 0])),
                                  np.median(us(d[:, 2] - d[:, 1])),
                                  np.median(us(d[:, 3] - d[:, 2])),
                                  np.median(us(d[:, 3] - d[:, 0]))))
        slowest, mean = w.max(1) / ghz / 1e3, w.mean(1) / ghz / 1e3
        print("  a warp's walk over its boxes, us: slowest warp of a block "
              "median %.2f, max %.2f; mean warp median %.2f" % (
                  np.median(slowest), slowest.max(), np.median(mean)))
        print(f"  kept boxes a block: median {np.median(d[:, 5])}, max "
              f"{d[:, 5].max()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
