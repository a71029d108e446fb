#!/usr/bin/env python3
"""Card smoke run of the PyTorch port (imagecaptioning_tpu_torch): GT-box
dense-caption serving on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. card name and power limit; TF32 off for cuDNN and cuBLAS;
2. build the ROI-pooling kernel from csrc/roi_align.cu (timed, set-up);
3. the kernel against its plain PyTorch version at the serving shapes
   (8 images × 32 boxes, 16×16×512 map, the 512² images' VGG16 output)
   and the infer CLI's canvas shape (1 × 32 boxes, 22×22×512, 720²),
   edge boxes included, and on phase 4's own trunk output; max-abs
   error ≤ 1e-5 (fp32, the same taps);
   times of the kernel, the plain version and affine_grid+grid_sample,
   and the bound (bytes over 3.35 TB/s vs 6 flops per output over
   67 TFLOP/s fp32, the H100 SXM's published peaks);
4. full-width serving from a seed: VGG16 (5 stages, bf16) → ROI kernel →
   fc6/fc7 4096 (bf16) → LSTM head 512 (fp32), vocab 10,000, seq 16, on
   8 uint8 512² images × 32 regions: greedy and beam-3 (log-prob) region
   decode of 17 steps, regions/s from CUDA events after warm-up, the
   kernel's launch count over that run, and a profile of one decode;
5. the same full-width weights in fp32 on the card against the CPU on a
   small input: teacher-forced logits within 1e-4.
The last three lines: the card as nvidia-smi reports it, one JSON line of
per-kernel numbers, and {"ok": true, "device": ...}. The profiler's full
tables go to <out-dir>/chip_smoke_profile.txt (`--out-dir`, default
build/chip_smoke).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
N_IMAGES, N_REGIONS, IMAGE = 8, 32, 512
VOCAB, SEQ, BEAM = 10000, 16, 3
ROI_TOL = 1e-5
LOGIT_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOPS = 67e12            # H100 SXM, fp32 outside the tensor cores


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def edge_boxes(rng, n, r, ih, iw):
    """(n, r, 4) xcycwh boxes: random boxes inside the image, with a
    full-image box, boxes hanging off each border, one larger than the
    image and the degenerate (1, 1, 1, 1) pad box in front."""
    boxes = np.stack([rng.uniform(1, iw, (n, r)), rng.uniform(1, ih, (n, r)),
                      rng.uniform(16, iw / 2, (n, r)),
                      rng.uniform(16, ih / 2, (n, r))], axis=-1)
    edge = [[(iw + 1) / 2, (ih + 1) / 2, iw, ih],
            [1.0, ih / 2, iw / 3, ih / 3], [iw, ih / 2, iw / 3, ih / 3],
            [iw / 2, 1.0, iw / 3, ih / 3], [iw / 2, ih, iw / 3, ih / 3],
            [iw / 2, ih / 2, 2 * iw, 2 * ih], [1.0, 1.0, 1.0, 1.0]]
    k = min(r, len(edge))
    boxes[:, :k] = edge[:k]
    return boxes.astype(np.float32)


def grid_sample_roi(features, boxes, image_hw, out_hw):
    """The reference's formulation (BoxToAffine → affine_grid →
    grid_sample) as library calls, for timing beside the kernel only;
    returns (N, R, oh, ow, C)."""
    import torch.nn.functional as F
    n, hf, wf, c = features.shape
    r = boxes.shape[1]
    (ih, iw), (oh, ow) = image_hw, out_hw
    xc, yc, w, h = boxes.reshape(-1, 4).unbind(-1)
    theta = torch.zeros(n * r, 2, 3, device=features.device)
    theta[:, 0, 0] = w / iw
    theta[:, 0, 2] = (2 * xc - 1 - iw) / (iw - 1)
    theta[:, 1, 1] = h / ih
    theta[:, 1, 2] = (2 * yc - 1 - ih) / (ih - 1)
    nchw = features.permute(0, 3, 1, 2)

    def call():
        grid = F.affine_grid(theta, [n * r, 1, oh, ow], align_corners=False)
        return F.grid_sample(nchw, grid.reshape(n, r * oh, ow, 2),
                             align_corners=False)
    return call, lambda out: out.reshape(n, c, r, oh, ow).permute(0, 2, 3, 4, 1)


def check_roi_kernel(dev, roi, n, r, hf, c, image, iters):
    """Kernel vs plain version vs grid_sample at one shape → a dict of
    the numbers (raises if the kernel disagrees with the plain version)."""
    rng = np.random.RandomState(SEED + n)
    feats = torch.from_numpy(rng.randn(n, hf, hf, c).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(edge_boxes(rng, n, r, image, image)).to(dev)
    hw = (float(image), float(image))
    if n == 1:      # the N=1 call (replaces roi_align_pallas_fwd)
        kernel = lambda: roi.roi_align(feats[0], boxes[0], hw)[None]
    else:
        kernel = lambda: roi.roi_align_batch(feats, boxes, hw)
    got = kernel()
    torch.cuda.synchronize()
    want = roi.roi_align_batch_reference(feats, boxes, hw)
    err = float((got - want).abs().max())
    if not err <= ROI_TOL:
        raise AssertionError(f"ROI kernel vs plain at N={n}: max abs err "
                             f"{err} > {ROI_TOL}")
    lib_call, lib_layout = grid_sample_roi(feats, boxes, hw, (7, 7))
    lib_err = float((lib_layout(lib_call()) - got).abs().max())
    nbytes = (feats.numel() + boxes.numel() + got.numel()) * 4
    flops = 6 * got.numel()
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOPS * 1e3
    res = {
        "shape": f"N={n} R={r} {hf}x{hf}x{c} image {image} -> 7x7",
        "max_abs_err": err,
        "ms": cuda_ms(kernel, iters),
        "plain_ms": cuda_ms(
            lambda: roi.roi_align_batch_reference(feats, boxes, hw), iters // 4),
        "library_ms": cuda_ms(lib_call, iters // 4),
        "library_max_abs_diff": lib_err,
        "bytes": nbytes,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
    }
    print(f"roi kernel {res['shape']}: {json.dumps(res)}", flush=True)
    return res


def serve(dev, model, api, normalize_images, roi):
    """The main path at full width: greedy and beam-3 region decode of
    8 images × 32 regions, timed after warm-up, with the kernel's launch
    count over the timed run. Returns a dict of the numbers."""
    rng = np.random.RandomState(SEED)
    images_u8 = torch.from_numpy(rng.randint(
        0, 256, (N_IMAGES, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(edge_boxes(rng, N_IMAGES, N_REGIONS,
                                        IMAGE, IMAGE)).to(dev)
    greedy = api.make_region_greedy_fn(model, SEQ + 1)
    beam = api.make_region_beam_fn(model, SEQ + 1, BEAM)
    regions = N_IMAGES * N_REGIONS
    outs = {}

    def run_greedy():
        outs["greedy"] = greedy(normalize_images(images_u8), boxes)

    def run_beam():
        outs["beam"] = beam(normalize_images(images_u8), boxes)
    for fn in (run_greedy, run_beam):          # warm-up (cuDNN, cuBLAS)
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    roi.roi_align_batch.launches = 0
    roi.roi_align.launches = 0
    t0 = time.perf_counter()
    greedy_ms = cuda_ms(run_greedy, iters=5, warmup=0)
    beam_ms = cuda_ms(run_beam, iters=5, warmup=0)
    wall_s = time.perf_counter() - t0
    launches = {"roi_align_batch": roi.roi_align_batch.launches,
                "roi_align": roi.roi_align.launches}
    if launches["roi_align_batch"] < 1:
        raise AssertionError("the serving path never launched the ROI kernel")

    toks, res = outs["greedy"], outs["beam"]
    v3 = VOCAB + 3
    if toks.shape != (regions, SEQ + 1) or res.tokens.shape != (
            regions, BEAM, SEQ + 1):
        raise AssertionError(f"token shapes {tuple(toks.shape)}, "
                             f"{tuple(res.tokens.shape)}")
    for t in (toks, res.tokens):
        if int(t.min()) < 0 or int(t.max()) >= v3:
            raise AssertionError("token ids out of range")
    if not bool(torch.isfinite(res.scores[:, 0]).all()):
        raise AssertionError("non-finite best-beam scores")

    x = normalize_images(images_u8)
    with torch.inference_mode():
        vgg_ms = cuda_ms(lambda: model.features(x), iters=5)
        feats = model.features(x).float().contiguous()
        hw = (float(IMAGE), float(IMAGE))
        # the kernel against its plain version on the main path's own
        # trunk output and boxes
        err = float((roi.roi_align_batch(feats, boxes, hw)
                     - roi.roi_align_batch_reference(feats, boxes, hw))
                    .abs().max())
        if not err <= ROI_TOL:
            raise AssertionError(f"ROI kernel vs plain on the trunk's "
                                 f"output: max abs err {err} > {ROI_TOL}")
        roi_ms = cuda_ms(lambda: roi.roi_align_batch(feats, boxes, hw),
                         iters=20)
        encode_ms = cuda_ms(lambda: model.encode_flat(x, boxes), iters=5)

    res_d = {
        "regions": regions, "steps": SEQ + 1, "beam": BEAM,
        "greedy_ms": greedy_ms, "beam_ms": beam_ms,
        "greedy_regions_per_s": regions / greedy_ms * 1e3,
        "beam3_regions_per_s": regions / beam_ms * 1e3,
        "encode_ms": encode_ms, "vgg_ms": vgg_ms, "roi_ms": roi_ms,
        "roi_max_abs_err_on_trunk_output": err,
        "timed_wall_s": wall_s, "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "beam_finished_share": float(res.finished[:, 0].float().mean()),
        "greedy_tokens_head": toks[0].tolist(),
    }
    print(f"serving: {json.dumps(res_d)}", flush=True)
    return res_d, run_beam, run_greedy


def profile(run_beam, run_greedy, out_dir: Path):
    """Device busy share and time by kernel for one beam and one greedy
    decode (torch.profiler); the full tables go to `out_dir`."""
    from torch.profiler import ProfilerActivity, profile as prof
    out = {}
    tables = []
    for name, fn in (("beam", run_beam), ("greedy", run_greedy)):
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = p.key_averages()
        kernels = sorted((e for e in events
                          if str(e.device_type).endswith("CUDA")),
                         key=lambda e: -e.self_device_time_total)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        out[name] = {
            "wall_ms": wall_ms,
            "device_busy_ms": dev_ms,
            "device_idle_share": (1 - dev_ms / wall_ms) if dev_ms
            else "not measured",
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               for e in kernels[:8]},
        }
        tables.append(f"== {name} ==\n" + events.table(
            sort_by="self_device_time_total", row_limit=30))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke_profile.txt").write_text("\n".join(tables))
    print(f"profile: {json.dumps(out)}", flush=True)
    return out


def reference_check(dev, model, build, api):
    """Full-width weights in fp32 on the card vs on the CPU, small input."""
    sd = {k: v.float().cpu() for k, v in model.state_dict().items()}
    twins = []
    for d in (torch.device("cpu"), dev):
        twin = build(d, torch.float32)
        twin.load_state_dict(sd)
        twins.append(twin)
    rng = np.random.RandomState(SEED + 1)
    x = torch.from_numpy(rng.randn(2, 96, 96, 3).astype(np.float32))
    boxes = torch.from_numpy(edge_boxes(rng, 2, 8, 96, 96))
    labels = torch.from_numpy(rng.randint(1, VOCAB + 1, (2, 8, SEQ)))
    with torch.inference_mode():
        want = twins[0](x, boxes, labels).logits
        got = twins[1](x.to(dev), boxes.to(dev), labels.to(dev)).logits.cpu()
    err = float((got - want).abs().max())
    tok_cpu = api.make_region_greedy_fn(twins[0], SEQ + 1)(x, boxes)
    tok_dev = api.make_region_greedy_fn(twins[1], SEQ + 1)(
        x.to(dev), boxes.to(dev)).cpu()
    res = {"logits_max_abs_err": err,
           "logits_max_abs": float(want.abs().max()),
           "greedy_token_agreement": float((tok_cpu == tok_dev).float().mean())}
    print(f"reference check (fp32 card vs CPU, full width): {json.dumps(res)}",
          flush=True)
    if not (np.isfinite(err) and err <= LOGIT_TOL):
        raise AssertionError(f"card logits differ from the CPU's by {err}")
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", type=Path, default=Path("build/chip_smoke"),
                   help="where the profiler tables are written")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available; nothing was run",
              file=sys.stderr)
        return 1
    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
    from imagecaptioning_tpu_torch.models import api
    from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
    from imagecaptioning_tpu_torch.ops import _kernels
    from imagecaptioning_tpu_torch.ops import roi_align as roi
    from imagecaptioning_tpu_torch.utils import weights

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    lib = _kernels.build("roi_align")
    _kernels.roi_align_lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    print("".join(line for line in Path(f"{lib}.log").read_text()
                  .splitlines(keepends=True) if "Used" in line or "spill" in line))

    slice_roi = check_roi_kernel(dev, roi, N_IMAGES, N_REGIONS, IMAGE // 32,
                                 512, IMAGE, iters=200)
    canvas_roi = check_roi_kernel(dev, roi, 1, N_REGIONS, 720 // 32, 512, 720,
                                  iters=200)

    def build(d, dtype):
        with torch.device(d):
            m = GTDenseCaptioner(vocab_size=VOCAB, seq_length=SEQ,
                                 embedding_size=512, rnn_size=512,
                                 num_lstm_layers=1, vgg_stages=5,
                                 compute_dtype=dtype)
        return m.eval()

    t0 = time.perf_counter()
    model = weights.seeded_init_(build(dev, torch.bfloat16), SEED)
    print(f"model init (seed {SEED}): {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params")
    served, run_beam, run_greedy = serve(dev, model, api, normalize_images,
                                         roi)
    prof = profile(run_beam, run_greedy, args.out_dir)
    ref = reference_check(dev, model, build, api)

    kernel = {
        "name": "roi_align_batch", "route": "cuda",
        "source": "imagecaptioning_tpu_torch/csrc/roi_align.cu",
        "replaces": "imagecaptioning_tpu/ops/roi_align.py:204",
        "launches": served["launches"]["roi_align_batch"],
        "max_abs_err": max(slice_roi["max_abs_err"],
                           served["roi_max_abs_err_on_trunk_output"]),
        **{k: slice_roi[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "shape": slice_roi["shape"],
        "also_replaces": "imagecaptioning_tpu/ops/roi_align.py:127 "
                         "(roi_align_pallas_fwd) as its N=1 call, roi_align",
        "launches_by_wrapper": served["launches"],
        "n1_canvas": canvas_roi,
    }
    summary = {"serving": served, "profile": prof, "reference_check": ref,
               "seconds": time.perf_counter() - t_start}
    print(f"summary: {json.dumps(summary)}")
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
