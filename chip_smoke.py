#!/usr/bin/env python3
"""Card smoke run of the PyTorch port (imagecaptioning_tpu_torch): GT-box
dense-caption serving on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. card name and power limit; TF32 off for cuDNN and cuBLAS;
2. build the ROI-pooling kernel from csrc/roi_align.cu (timed, set-up),
   with nvcc's register and spill report;
3. each entry of the kernel against its plain PyTorch version at the
   serving shape (8 images × 32 boxes, 16×16×512 map, the 512² images'
   VGG16 output) and the infer CLI's canvas shape (1 × 32 boxes,
   22×22×512, 720²), edge boxes included: the NHWC entry (fp32 map →
   fp32, `roi_align_batch`, or `roi_align` at N=1) and the fused CHW
   entry (`roi_align_batch_chw`: fp32 → fp32, and bf16 → bf16 as the
   serving path calls it). fp32 max-abs error ≤ 1e-5; bf16 within one
   bf16 ulp everywhere, with the bitwise-equal share. Times: the
   median of CUDA events around each launch alone, the card spinning
   before it so that the host's enqueue time stays out, L2-hot and cold
   (128 MB written, then 128 MB read, before each launch; "cold_dirty"
   skips the read, so the launch also writes back dirty lines); the
   host's enqueue time per call; the plain version's and
   affine_grid+grid_sample's, and the bound: the larger of the bytes
   (each tensor's own element size) over 3.35 TB/s and 6 flops per
   output over 67 TFLOP/s fp32, the H100 SXM's published peaks;
4. full-width serving from a seed: VGG16 (5 stages, bf16) → fused ROI
   kernel (bf16 CHW codes) → fc6/fc7 4096 (bf16) → LSTM head 512 (fp32),
   vocab 10,000, seq 16, on 8 uint8 512² images × 32 regions: greedy and
   beam-3 (log-prob) region decode of 17 steps, regions/s from CUDA
   events after warm-up and before the profiler is first used, each ROI
   wrapper's launch count over that run (the fused entry: one per
   forward); then the kernel's entries against their plain versions on
   the trunk's own output, and the ROI stage (trunk output → fc6 input)
   as four launches (widen, NHWC entry, CHW copy, narrow) beside the
   fused entry, timed as in 3 and by the profiler (CUPTI);
5. the kernels' own device time (CUPTI), hot and cold, of phase 3's
   entries, and a profile of one greedy and one beam decode;
6. the same full-width weights in fp32 on the card against the CPU on a
   small input: teacher-forced logits within 1e-4 (the fused entry
   writes fp32 codes there).
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
FLUSH_BYTES = 128 << 20       # > the H100's 50 MB L2
HEAD_START_CYCLES = 400_000   # ~0.2 ms at the H100's 1.98 GHz boost clock
ROI_WRAPPERS = ("roi_align_batch_chw", "roi_align_batch", "roi_align")


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


def device_ms(fn, iters: int, flush: torch.Tensor | None = None,
              dirty: bool = False) -> float:
    """Median device milliseconds of one call of `fn`, with the events
    around the call alone. Before each call the card spins for
    HEAD_START_CYCLES without touching memory, so the host's enqueue of
    the call never shows in its time. Without `flush` the call finds L2
    as its previous call left it (hot). With it, before the spin, the
    FLUSH_BYTES of `flush[0]` are written, so none of the call's data
    stays in the 50 MB L2 (cold), and unless `dirty` those of `flush[1]`
    are then read, so no dirty line is left for the call to write back
    either."""
    fn()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush[0].zero_()
            if not dirty:
                flush[1].sum()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def host_us(fn, iters: int = 50) -> float:
    """Mean host microseconds to enqueue one call of `fn` (the card is kept
    busy meanwhile, so the host never waits for it)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HEAD_START_CYCLES * 20)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def cupti_ms(fn, iters: int, flush: torch.Tensor | None = None):
    """Mean device time of the kernels that one call of `fn` launches, as
    the profiler (CUPTI) records them: no event or launch gap in it. With
    `flush`, L2 is flushed clean before each call as in `device_ms`, and
    the flush's own kernels are left out. The profiler now and then
    returns no kernel at all: then it is asked again, twice at most, and
    the result is "not measured"."""
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    flushing = ("FillFunctor", "reduce_kernel")
    for _ in range(3):
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            for _ in range(iters):
                if flush is not None:
                    flush[0].zero_()
                    flush[1].sum()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in p.key_averages()
                 if str(e.device_type).endswith("CUDA")
                 and not any(w in e.key for w in flushing))
        if us > 0:
            return us / iters / 1e3
    return "not measured"


def timings(fn, iters: int, flush: torch.Tensor) -> dict:
    """Event times (cold, cold with dirty lines, hot) and the host's
    enqueue time."""
    return {"ms_cold": device_ms(fn, iters, flush),
            "ms_cold_dirty": device_ms(fn, iters, flush, dirty=True),
            "ms_hot": device_ms(fn, iters), "host_us": host_us(fn)}


def cupti_times(fn, iters: int, flush: torch.Tensor) -> dict:
    """The kernels' own device time (CUPTI), cold and hot."""
    return {"kernel_ms_cold": cupti_ms(fn, iters, flush),
            "kernel_ms_hot": cupti_ms(fn, iters)}


def within_one_bf16_ulp(got, want):
    """Elementwise |got - want| <= one bf16 ulp at the larger magnitude."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    return (g - w).abs() <= torch.ldexp(torch.ones_like(g), e - 8)


def compare(got, want) -> dict:
    """The kernel's output against its plain version's: fp32 within
    ROI_TOL, bf16 within one bf16 ulp everywhere (raises otherwise)."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        if not err <= ROI_TOL:
            raise AssertionError(f"ROI kernel vs plain: max abs err {err} > "
                                 f"{ROI_TOL}")
        return {"max_abs_err": err, "tolerance": ROI_TOL}
    if not bool(within_one_bf16_ulp(got, want).all()):
        raise AssertionError(f"ROI kernel vs plain: bf16 codes more than one "
                             f"ulp apart (max abs err {err})")
    same = got.view(torch.int16) == want.view(torch.int16)
    return {"max_abs_err": err, "tolerance": "one bf16 ulp",
            "bitwise_equal_share": float(same.float().mean())}


def roofline(inputs, out) -> dict:
    """The least time for the call: each input read once and the output
    written once at their own element sizes, against 6 flops per output."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 6 * out.numel() / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


def check_roi_kernel(dev, roi, n, r, hf, c, image, iters, flush):
    """Each entry of the kernel vs its plain version at one shape, with
    its event times, bound and grid_sample's time → ({case: numbers},
    {case: the call}) (raises if an entry disagrees with its plain
    version)."""
    rng = np.random.RandomState(SEED + n)
    f32 = torch.from_numpy(rng.randn(n, hf, hf, c).astype(np.float32)).to(dev)
    b16 = f32.to(torch.bfloat16)
    boxes = torch.from_numpy(edge_boxes(rng, n, r, image, image)).to(dev)
    hw = (float(image), float(image))
    bf16 = torch.bfloat16
    if n == 1:      # the N=1 call (replaces roi_align_pallas_fwd)
        nhwc = ("roi_align", lambda: roi.roi_align(f32[0], boxes[0], hw)[None])
    else:
        nhwc = ("roi_align_batch", lambda: roi.roi_align_batch(f32, boxes, hw))
    cases = {
        f"{nhwc[0]} fp32->fp32 NHWC": (
            f32, nhwc[1],
            lambda: roi.roi_align_batch_reference(f32, boxes, hw)),
        "roi_align_batch_chw fp32->fp32 CHW": (
            f32, lambda: roi.roi_align_batch_chw(f32, boxes, hw),
            lambda: roi.roi_align_batch_chw_reference(f32, boxes, hw)),
        "roi_align_batch_chw bf16->bf16 CHW": (
            b16, lambda: roi.roi_align_batch_chw(b16, boxes, hw,
                                                 out_dtype=bf16),
            lambda: roi.roi_align_batch_chw_reference(b16, boxes, hw,
                                                      out_dtype=bf16)),
    }
    # the library yardstick computes the same pooling on the fp32 map
    lib_call, lib_layout = grid_sample_roi(f32, boxes, hw, (7, 7))
    lib = {"library_ms": device_ms(lib_call, iters // 4, flush),
           "library_ms_hot": device_ms(lib_call, iters // 4)}
    shape = f"N={n} R={r} {hf}x{hf}x{c} image {image} -> 7x7"
    out = {}
    for case, (feats, kernel, plain) in cases.items():
        got = kernel()
        res = {"shape": shape, **compare(got, plain()),
               **roofline((feats, boxes), got),
               **timings(kernel, iters, flush),
               "plain_ms": cuda_ms(plain, iters // 4), **lib}
        res["cold_share_of_bound"] = res["bound_ms"] / res["ms_cold"]
        if "NHWC" in case:
            res["library_max_abs_diff"] = float(
                (lib_layout(lib_call()) - got).abs().max())
        print(f"roi kernel {case}, {shape}: {json.dumps(res)}", flush=True)
        out[case] = res
    return out, {case: kernel for case, (_, kernel, _) in cases.items()}


def add_cupti(results: dict, calls: dict, iters: int, flush) -> None:
    """Add each case's CUPTI times (and their share of its bound) to
    check_roi_kernel's numbers."""
    for case, fn in calls.items():
        res = results[case]
        res.update(cupti_times(fn, iters, flush))
        if isinstance(res["kernel_ms_cold"], float):
            res["kernel_cold_share_of_bound"] = (res["bound_ms"]
                                                 / res["kernel_ms_cold"])
        print(f"roi kernel {case}, {res['shape']}, CUPTI: "
              f"{res['kernel_ms_cold']} ms cold, {res['kernel_ms_hot']} ms "
              f"hot", flush=True)


def roi_stage(roi, feats, boxes, hw, flush):
    """The serving path's ROI stage, trunk output (bf16 NHWC) → fc6 input
    (bf16 CHW codes): composed of public calls (widen, NHWC entry, CHW
    copy, narrow; four launches) beside the fused entry (one), which must
    give the same bits. Hot and cold times, in the order A B B A."""
    n, r = boxes.shape[:2]
    bf16 = torch.bfloat16

    def composed():
        pooled = roi.roi_align_batch(feats.float().contiguous(), boxes, hw)
        return pooled.permute(0, 1, 4, 2, 3).reshape(n, r, -1).to(bf16)

    def fused():
        return roi.roi_align_batch_chw(feats, boxes, hw, out_dtype=bf16)
    if not torch.equal(composed(), fused()):
        raise AssertionError("fused ROI stage differs from the four launches")
    order = (("four_launches", composed), ("fused", fused))
    res = {name: {} for name, _ in order}
    for name, fn in order + order[::-1]:
        for k, t in {**timings(fn, 50, flush),
                     **cupti_times(fn, 50, flush)}.items():
            res[name].setdefault(k, []).append(t)
    for v in res.values():
        for k in list(v):
            v[f"{k}_mean"] = float(np.mean(v[k]))
    res["fused_faster_cold"] = (res["fused"]["ms_cold_mean"]
                                < res["four_launches"]["ms_cold_mean"])
    res["fused_faster_hot"] = (res["fused"]["ms_hot_mean"]
                               < res["four_launches"]["ms_hot_mean"])
    return res


def serve(dev, model, api, normalize_images, roi, flush):
    """The main path at full width: greedy and beam-3 region decode of
    8 images × 32 regions, timed after warm-up, with each ROI wrapper's
    launch count over the timed run. Returns a dict of the numbers."""
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

    for name in ROI_WRAPPERS:
        getattr(roi, name).launches = 0
    t0 = time.perf_counter()
    greedy_ms = cuda_ms(run_greedy, iters=5, warmup=0)
    beam_ms = cuda_ms(run_beam, iters=5, warmup=0)
    wall_s = time.perf_counter() - t0
    launches = {name: getattr(roi, name).launches for name in ROI_WRAPPERS}
    if launches["roi_align_batch_chw"] != 10:     # one per forward
        raise AssertionError(f"the fused ROI entry was launched "
                             f"{launches['roi_align_batch_chw']} times in "
                             f"10 forwards")

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
        feats = model.features(x)    # bf16 NHWC view, as encode_regions sees
        hw = (float(IMAGE), float(IMAGE))
        bf16 = torch.bfloat16
        # each entry against its plain version on the main path's own
        # trunk output and boxes
        trunk_checks = {
            "roi_align_batch bf16->fp32 NHWC": compare(
                roi.roi_align_batch(feats, boxes, hw),
                roi.roi_align_batch_reference(feats, boxes, hw)),
            "roi_align_batch_chw bf16->fp32 CHW": compare(
                roi.roi_align_batch_chw(feats, boxes, hw),
                roi.roi_align_batch_chw_reference(feats, boxes, hw)),
            "roi_align_batch_chw bf16->bf16 CHW": compare(
                roi.roi_align_batch_chw(feats, boxes, hw, out_dtype=bf16),
                roi.roi_align_batch_chw_reference(feats, boxes, hw,
                                                  out_dtype=bf16)),
        }
        stage = roi_stage(roi, feats, boxes, hw, flush)
        encode_ms = cuda_ms(lambda: model.encode_flat(x, boxes), iters=5)

    res_d = {
        "regions": regions, "steps": SEQ + 1, "beam": BEAM,
        "greedy_ms": greedy_ms, "beam_ms": beam_ms,
        "greedy_regions_per_s": regions / greedy_ms * 1e3,
        "beam3_regions_per_s": regions / beam_ms * 1e3,
        "encode_ms": encode_ms, "vgg_ms": vgg_ms, "roi_stage": stage,
        "roi_checks_on_trunk_output": trunk_checks,
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
                  .splitlines(keepends=True)
                  if any(w in line for w in ("Used", "spill", "properties"))))

    flush = torch.zeros(2, FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    print(f"events around no work: {device_ms(lambda: None, 50)} ms")
    slice_roi, slice_calls = check_roi_kernel(
        dev, roi, N_IMAGES, N_REGIONS, IMAGE // 32, 512, IMAGE, 200, flush)
    canvas_roi, canvas_calls = check_roi_kernel(
        dev, roi, 1, N_REGIONS, 720 // 32, 512, 720, 200, flush)

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
                                         roi, flush)
    add_cupti(slice_roi, slice_calls, 200, flush)
    add_cupti(canvas_roi, canvas_calls, 200, flush)
    prof = profile(run_beam, run_greedy, args.out_dir)
    ref = reference_check(dev, model, build, api)

    # the serving path's kernel: the fused entry, bf16 map → bf16 codes
    main_case = slice_roi["roi_align_batch_chw bf16->bf16 CHW"]
    kernel = {
        "name": "roi_align_batch_chw", "route": "cuda",
        "source": "imagecaptioning_tpu_torch/csrc/roi_align.cu",
        "replaces": "imagecaptioning_tpu/ops/roi_align.py:204",
        "launches": served["launches"]["roi_align_batch_chw"],
        "max_abs_err": max(main_case["max_abs_err"], served[
            "roi_checks_on_trunk_output"][
            "roi_align_batch_chw bf16->bf16 CHW"]["max_abs_err"]),
        "tolerance": "one bf16 ulp per element",
        "ms": main_case["ms_cold"],
        **{k: main_case[k] for k in ("ms_hot", "kernel_ms_cold",
                                     "kernel_ms_hot", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "library_ms_hot", "bytes")},
        "shape": main_case["shape"],
        "also_replaces": "imagecaptioning_tpu/ops/roi_align.py:127 "
                         "(roi_align_pallas_fwd): the same kernel's NHWC "
                         "entry roi_align_batch, and roi_align at N=1",
        "launches_by_wrapper": served["launches"],
        "entries": {"serving_shape": slice_roi, "n1_canvas": canvas_roi},
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
