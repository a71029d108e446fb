"""Ablations of the ROI-pooling kernel on one CUDA card: where its time goes.

    python -m imagecaptioning_tpu_torch.tools.roi_ablation

Builds `csrc/roi_align.cu` as it is and in variants that each take one
part out or change one choice (written to `build/kernels/ablation/`,
all compiled at once), and times the serving path's entry (bf16 map
→ bf16 CHW codes) and the fp32 NHWC entry at the serving shape (8 images
× 32 boxes, 16×16×512 → 7×7). Beside them, PyTorch's own write of a
tensor the size of the bf16 codes and its copy of one: what moving those
bytes alone takes. Times are the kernels' own device time from the
profiler (CUPTI), L2-cold and hot, as `chip_smoke.py` takes them. The
variants compute wrong values by design and nothing is checked here
(`chip_smoke.py` holds the kernel to its plain version). One JSON line
per variant; run from the repository root.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from imagecaptioning_tpu_torch.ops import _kernels

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "kernels" / "ablation"
N, R, HF, C, IMAGE, OUT = 8, 32, 16, 512, 512, 7

# name -> (what it shows, [(text in the source, its replacement)])
VARIANTS = {
    "as_is": ("the kernel", []),
    "no_main_loop": (
        "taps, barriers and the staged write-out only",
        [("    for (int cell = threadIdx.y; cell < ohw; cell += blockDim.y) {",
          "    for (int cell = threadIdx.y; cell < ohw && cb < 0;"
          " cell += blockDim.y) {")]),
    "no_feature_loads": (
        "everything but the feature loads (arithmetic on the weights)",
        [("      load(f + ty.lo + tx.lo, v00);\n"
          "      load(f + ty.hi + tx.lo, v10);\n"
          "      load(f + ty.lo + tx.hi, v01);\n"
          "      load(f + ty.hi + tx.hi, v11);",
          "#pragma unroll\n      for (int k = 0; k < VEC; ++k) {\n"
          "        v00[k] = ty.w_lo + k; v10[k] = ty.w_hi + k;\n"
          "        v01[k] = tx.w_lo + k; v11[k] = tx.w_hi + k;\n      }")]),
    "no_write_out": (
        "the CHW entry without its staged write-out",
        [("    write_run(run, stage, cb * ohw, head, tid, kThreads);",
          "    if (cb < 0) write_run(run, stage, cb * ohw, head, tid, "
          "kThreads);")]),
    "chunk_64": (
        "always 64 channels a block (2,048 blocks at this shape)",
        [("                  ? 128 : 64;", "                  ? 64 : 64;")]),
    "threads_128": (
        "128 threads a block instead of 256",
        [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")]),
}


def build_all() -> dict:
    """Write every variant and compile them all at once → {name: ctypes
    library}."""
    src = (_kernels.CSRC / "roi_align.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, (_, edits) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old!r}; update this ablation")
            text = text.replace(old, new)
        sources[name] = OUT_DIR / f"{name}.cu"
        sources[name].write_text(text)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = {name: pool.submit(_kernels.build, f"roi_ablation_{name}", cu)
                 for name, cu in sources.items()}
        return {name: _kernels.bind_roi_align(ctypes.CDLL(str(f.result())))
                for name, f in built.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("roi_ablation: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs            # its timers and edge boxes

    libs = build_all()
    dev = torch.device("cuda:0")
    rng = np.random.RandomState(cs.SEED)
    f32 = torch.from_numpy(rng.randn(N, HF, HF, C).astype(np.float32)).to(dev)
    b16 = f32.to(torch.bfloat16)
    boxes = torch.from_numpy(cs.edge_boxes(rng, N, R, IMAGE, IMAGE)).to(dev)
    codes = torch.empty(N, R, C * OUT * OUT, dtype=torch.bfloat16, device=dev)
    nhwc = torch.empty(N, R, OUT, OUT, C, device=dev)
    flush = torch.zeros(2, cs.FLUSH_BYTES // 4, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(lib, chw):
        feats, out = (b16, codes) if chw else (f32, nhwc)
        args = [feats.data_ptr(), boxes.data_ptr(), out.data_ptr(), N, R, HF,
                HF, C, OUT, OUT, float(IMAGE), float(IMAGE),
                int(feats.dtype == torch.bfloat16)]
        if chw:
            return lambda: lib.roi_align_chw_fwd(*args, 1, stream)
        return lambda: lib.roi_align_fwd(*args, stream)

    def us(ms):
        return ms * 1e3 if isinstance(ms, float) else ms

    def times(fn):
        return {"kernel_us_cold": us(cs.cupti_ms(fn, 100, flush)),
                "kernel_us_hot": us(cs.cupti_ms(fn, 100))}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for name, lib in libs.items():
        row = {"variant": name, "shows": VARIANTS[name][0]}
        for label, chw in (("bf16_chw", True), ("fp32_nhwc", False)):
            fn = entry(lib, chw)
            if fn() != 0:
                raise RuntimeError(f"{name} {label}: launch failed")
            row[label] = times(fn)
        print(json.dumps(row), flush=True)
    zero = torch.zeros((), dtype=torch.bfloat16, device=dev)
    src = torch.empty_like(codes)
    for name, fn in (("pytorch_write",
                      lambda: codes.copy_(zero.expand_as(codes))),
                     ("pytorch_copy", lambda: codes.copy_(src))):
        print(json.dumps({"variant": name, "bytes_written": codes.numel() * 2,
                          "bf16_chw": times(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
