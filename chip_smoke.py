#!/usr/bin/env python3
"""Card smoke run of the PyTorch port (imagecaptioning_tpu_torch): GT-box
dense-caption serving and training on one CUDA card, with the LSTM head
(phases 4–9) and the transformer head (phases 10–11).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. card name and power limit; TF32 off for cuDNN and cuBLAS;
2. build the ROI-pooling kernels from csrc/roi_align.cu (forward) and
   csrc/roi_align_bwd.cu (backward), one nvcc each, started together
   (timed, set-up), with nvcc's register and spill reports;
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
   writes fp32 codes there);
7. the backward kernels (`roi_align_bwd_features`, kernel A, and
   `roi_align_bwd_boxes`, kernel B) against the plain backward (autograd
   through the plain forward) at the training shape (4 × 32 boxes,
   22×22×512, 720² images) and the serving shape, edge boxes included:
   bf16 map with bf16 CHW gradient (as training calls it), fp32 with fp32
   CHW, fp32 with fp32 NHWC. d_features: fp32 max-abs ≤ 1e-5, bf16
   within one bf16 ulp; d_boxes within 1e-4 relative to the largest
   component; both bitwise equal on a second launch (kernel B is two
   launches, partial sums per channel chunk and their fixed-order sum,
   counted and timed as one call). Timed as in 3 and 5
   (events hot and cold, CUPTI, host enqueue), beside the plain version,
   autograd's backward through affine_grid+grid_sample (both gradients)
   and the bound (bytes over 3.35 TB/s against the flops over 67 TFLOP/s);
8. full-width training: the same model with fp32 master weights and bf16
   compute, Adam in the default `DenseConfig`'s three groups, over a
   `VGDataLoader` of 10 in-memory 720² uint8 images (8 in the train split,
   so the encoder's lr turns on at update 8, inside the run) × 32 regions
   with captions over a 10,000-word vocabulary, batch 4: 2 warm-up steps,
   then 3 windows of 12 steps, each timed by CUDA events (loss per step;
   steps/s, images/s and regions/s at the median window; peak memory;
   each ROI wrapper's launches: kernel A once per step, kernel B never),
   one profiled step (the card's busy time: its kernels and copies), and
   a full checkpoint saved and restored bitwise;
9. one fp32 train step at full width on the card against the CPU from
   the same weights on a small input (dropout off on both): the loss
   within 1e-4 relative and every parameter after the update within
   2·lr of the CPU's (a first Adam update moves a weight by at most lr;
   the sign of a gradient inside rounding noise may differ), with at
   most 1e-5 of all weights more than 1e-7 apart;
10. the transformer head (the reference's default GT
   model: fc 4096→256,
   3 encoder and 3 decoder layers, 4 heads, FFN 1024, fp32 over the bf16
   trunk) from seed 0: serving as in 4 and 5 (regions/s; the profiler's
   card busy time, idle share of the profiled and of the event-timed
   call, kernels launched per call and top
   kernels; the fused ROI entry once per forward; run after phase 6, so
   its serving is timed after the profiler's first use), then its fp32
   logits on the card against the CPU's as in 6, within 1e-4, with
   greedy and beam-3 tokens identical;
11. (run after 9) the transformer head's training as in 8 (kernel A once
   per step) and its fp32 train step on the card against the CPU as in 9.
Every line of phases 4–11 carries the card's name and power limit. The
kernels line counts each kernel's launches over every path that runs it
(`launches`, split in `launches_by_path`): the fused forward in both
heads' serving and training, kernel A in both heads' training.
The last three lines: the card as nvidia-smi reports it, one JSON line of
per-kernel numbers, and {"ok": true, "device": ...}. The profiler's full
tables go to <out-dir>/chip_smoke_profile.txt and
<out-dir>/chip_smoke_train_profile.txt, and the transformer's to
<out-dir>/chip_smoke_transformer_profile.txt and
<out-dir>/chip_smoke_transformer_train_profile.txt (`--out-dir`, default
build/chip_smoke), where the checkpoints of phases 8 and 11 are written
and removed.
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
ROI_WRAPPERS = ("roi_align_batch_chw", "roi_align_batch", "roi_align",
                "roi_align_bwd_features", "roi_align_bwd_boxes")
GRAD_REL_TOL = 1e-4           # d_boxes, relative to the largest component
TRAIN_IMAGES, TRAIN_SPLIT, TRAIN_IMAGE = 10, 8, 720
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_WINDOWS = 4, 2, 12, 3
LOSS_REL_TOL = 1e-4
# kinds of the card's work in a profiled training step, by kernel name
# (the first match wins; the rest is elementwise work and reductions)
KERNEL_KINDS = (("convolution (cuDNN)", ("fprop", "dgrad", "wgrad")),
                ("matrix product (cuBLAS)", ("gemm",)),
                ("optimizer (foreach)", ("multi_tensor_apply",)),
                ("ROI kernels", ("roi_",)),
                ("max-pool", ("max_pool",)),
                ("host-to-card copy", ("Memcpy HtoD",)))


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


def roofline(inputs, out, flops=None) -> dict:
    """The least time for the call: each input read once and the output
    written once at their own element sizes, against its fp32 flops (by
    default the forward's 6 per output)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, out))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (6 * out.numel() if flops is None else flops) / FP32_FLOPS * 1e3
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


def serve(dev, model, api, normalize_images, roi, flush, label="serving",
          card=""):
    """The main path at full width: greedy and beam-3 region decode of
    8 images × 32 regions, timed after warm-up, with each ROI wrapper's
    launch count over the timed run. Returns a dict of the numbers,
    printed after `label` with the `card`."""
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
        "card": card, "regions": regions, "steps": SEQ + 1, "beam": BEAM,
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
    print(f"{label}: {json.dumps(res_d)}", flush=True)
    return res_d, run_beam, run_greedy


def profile(run_beam, run_greedy, out_dir: Path, label="profile", card="",
            table="chip_smoke_profile.txt", served=None):
    """Device busy share, kernels and copies launched, and time by kernel
    for one beam and one greedy decode (torch.profiler); the full tables
    go to `out_dir`/`table`. The idle share is read against the profiled
    call, whose host time the profiler's CPU tracing inflates, and, given
    `served` (`serve`'s result), against its event-timed ms per call."""
    from torch.profiler import ProfilerActivity, profile as prof
    out = {"card": card}
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
            "device_idle_share_of_timed_call":
                (1 - dev_ms / served[f"{name}_ms"]) if dev_ms and served
                else "not measured",
            "kernels_and_copies": sum(e.count for e in kernels),
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               for e in kernels[:8]},
        }
        tables.append(f"== {name} ==\n" + events.table(
            sort_by="self_device_time_total", row_limit=30))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / table).write_text("\n".join(tables))
    print(f"{label}: {json.dumps(out)}", flush=True)
    return out


def reference_check(dev, model, build, api, label="reference check (fp32 "
                    "card vs CPU, full width)", card="", same_tokens=False):
    """Full-width weights in fp32 on the card vs on the CPU, small input;
    with `same_tokens`, greedy and beam-3 tokens must be identical too."""
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
    res = {"card": card, "logits_max_abs_err": err,
           "logits_max_abs": float(want.abs().max()),
           "greedy_token_agreement": float((tok_cpu == tok_dev).float().mean())}
    if same_tokens:
        beam_cpu = api.make_region_beam_fn(twins[0], SEQ + 1, BEAM)(x, boxes)
        beam_dev = api.make_region_beam_fn(twins[1], SEQ + 1, BEAM)(
            x.to(dev), boxes.to(dev))
        res["beam_token_agreement"] = float(
            (beam_cpu.tokens == beam_dev.tokens.cpu()).float().mean())
        res["beam_score_max_abs_err"] = float(
            (beam_cpu.scores - beam_dev.scores.cpu()).abs().max())
    print(f"{label}: {json.dumps(res)}", flush=True)
    if not (np.isfinite(err) and err <= LOGIT_TOL):
        raise AssertionError(f"card logits differ from the CPU's by {err}")
    if same_tokens and not (res["greedy_token_agreement"] == 1.0
                            and res["beam_token_agreement"] == 1.0):
        raise AssertionError(f"card tokens differ from the CPU's: {res}")
    return res


def grid_sample_roi_backward(features, boxes, image_hw, out_hw, grad):
    """autograd's backward through the reference's formulation
    (BoxToAffine → affine_grid → grid_sample) with respect to the map and
    the boxes, for timing beside the backward kernels only: a graph kept
    for reuse, and a call that runs its backward at `grad` (N, R, oh, ow,
    C)."""
    import torch.nn.functional as F
    n, _, _, c = features.shape
    r = boxes.shape[1]
    (ih, iw), (oh, ow) = image_hw, out_hw
    nchw = features.float().permute(0, 3, 1, 2).detach().requires_grad_()
    b = boxes.detach().clone().requires_grad_()
    xc, yc, w, h = b.reshape(-1, 4).unbind(-1)
    zero = torch.zeros_like(xc)
    theta = torch.stack([
        torch.stack([w / iw, zero, (2 * xc - 1 - iw) / (iw - 1)], -1),
        torch.stack([zero, h / ih, (2 * yc - 1 - ih) / (ih - 1)], -1)], 1)
    grid = F.affine_grid(theta, [n * r, 1, oh, ow], align_corners=False)
    out = F.grid_sample(nchw, grid.reshape(n, r * oh, ow, 2),
                        align_corners=False)
    g = grad.permute(0, 4, 1, 2, 3).reshape(n, c, r * oh, ow).contiguous()
    return lambda: torch.autograd.grad(out, (nchw, b), g, retain_graph=True)


def compare_boxes(got, want) -> dict:
    """d_boxes against the plain version's: max |got − want| within
    GRAD_REL_TOL of the largest |want| (raises otherwise)."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not rel <= GRAD_REL_TOL:
        raise AssertionError(f"d_boxes vs plain: relative err {rel} > "
                             f"{GRAD_REL_TOL}")
    return {"max_abs_err": err, "max_rel_err": rel,
            "tolerance": f"{GRAD_REL_TOL} relative to max |d_boxes|"}


def check_roi_backward(dev, roi, n, r, hf, c, image, iters, flush):
    """Both backward kernels vs the plain backward at one shape, with their
    event times, bounds, the plain version's and the library's times →
    ({case: numbers}, {case: the call}), cases named "<entry> <maps and
    gradient>" (raises if a kernel disagrees or is not deterministic)."""
    rng = np.random.RandomState(SEED + 100 + n)
    f32 = torch.from_numpy(rng.randn(n, hf, hf, c).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(edge_boxes(rng, n, r, image, image)).to(dev)
    g = torch.from_numpy(rng.randn(n, r, 7, 7, c).astype(np.float32)).to(dev)
    g_chw = g.permute(0, 1, 4, 2, 3).reshape(n, r, -1).contiguous()
    hw = (float(image), float(image))
    bf16 = torch.bfloat16
    inputs = {"bf16 map, bf16 CHW grad": (f32.to(bf16), g_chw.to(bf16)),
              "fp32 map, fp32 CHW grad": (f32, g_chw),
              "fp32 map, fp32 NHWC grad": (f32, g)}
    lib_call = grid_sample_roi_backward(f32, boxes, hw, (7, 7), g)
    lib = {"library_ms": device_ms(lib_call, iters // 4, flush),
           "library_ms_hot": device_ms(lib_call, iters // 4)}
    shape = f"N={n} R={r} {hf}x{hf}x{c} image {image} -> 7x7"
    def entries(feats, grad):
        """entry → (kernel call, plain call, its check, what the kernel
        reads, its fp32 flops: 4 FMAs per gradient element for A; for B
        two tap differences, two weighted sums and two FMAs)."""
        return {
            "roi_align_bwd_features": (
                lambda: roi.roi_align_bwd_features(feats, boxes, grad, hw),
                lambda: roi.roi_align_backward_reference(
                    feats, boxes, grad, hw, need_boxes=False)[0],
                compare, (grad, boxes), 8 * grad.numel()),
            "roi_align_bwd_boxes": (
                lambda: roi.roi_align_bwd_boxes(feats, boxes, grad, hw),
                lambda: roi.roi_align_backward_reference(
                    feats, boxes, grad, hw, need_features=False)[1],
                compare_boxes, (feats, boxes, grad), 14 * grad.numel()),
        }
    out, calls = {}, {}
    for name, (feats, grad) in inputs.items():
        for entry, (kernel, plain, check, reads, flops) in entries(
                feats, grad).items():
            got = kernel()
            again = kernel()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{entry} {name}: two launches differ")
            res = {"shape": shape, **check(got, plain()),
                   "deterministic": True,
                   **roofline(reads, got, flops),
                   **timings(kernel, iters, flush),
                   "plain_ms": cuda_ms(plain, iters // 4), **lib}
            res["cold_share_of_bound"] = res["bound_ms"] / res["ms_cold"]
            case = f"{entry} {name}"
            print(f"roi backward {case}, {shape}: {json.dumps(res)}",
                  flush=True)
            out[case], calls[case] = res, kernel
    return out, calls


def make_train_data(rng):
    """VG arrays held in memory → (arrays, dicts): TRAIN_IMAGES uint8
    images of TRAIN_IMAGE², N_REGIONS regions each (edge boxes included),
    captions of 2..SEQ words over a VOCAB-word vocabulary; the first
    TRAIN_SPLIT images are the train split."""
    n, r, s = TRAIN_IMAGES, N_REGIONS, TRAIN_IMAGE
    m = n * r
    lengths = rng.randint(2, SEQ + 1, m)
    labels = rng.randint(1, VOCAB + 1, (m, SEQ)).astype(np.int32)
    labels[np.arange(SEQ)[None] >= lengths[:, None]] = 0
    split = np.full(n, 1, np.int32)
    split[:TRAIN_SPLIT] = 0
    split[-1] = 2
    first = np.arange(n, dtype=np.int32) * r + 1
    arrays = {
        "images": rng.randint(0, 256, (n, s, s, 3), dtype=np.uint8),
        "image_heights": np.full(n, s, np.int32),
        "image_widths": np.full(n, s, np.int32),
        "labels": labels, "lengths": lengths.astype(np.int32),
        "boxes": edge_boxes(rng, n, r, s, s).reshape(m, 4),
        "img_to_first_box": first, "img_to_last_box": first + r - 1,
        "box_to_img": np.repeat(np.arange(1, n + 1, dtype=np.int32), r),
        "split": split,
        "original_heights": np.full(n, s, np.int32),
        "original_widths": np.full(n, s, np.int32),
    }
    words = [f"w{i}" for i in range(VOCAB)]
    info = {"token_to_idx": {w: i + 1 for i, w in enumerate(words)},
            "idx_to_token": {str(i + 1): w for i, w in enumerate(words)}}
    return arrays, info


def same_state(a, b) -> bool:
    """Two (optimizer or model) state dicts equal, tensors bitwise."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_state, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def train(dev, roi, out_dir: Path, use_lstm=True, label="training", card="",
          table="chip_smoke_train_profile.txt"):
    """Full-width training (phase 8; phase 11 with `use_lstm` False) → its
    numbers (raises on a failed check)."""
    from torch.profiler import ProfilerActivity, profile as prof

    from imagecaptioning_tpu_torch.config.dense_configs import DenseConfig
    from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    arrays, info = make_train_data(np.random.RandomState(SEED + 2))
    loader = VGDataLoader(arrays=arrays, info=info)
    cfg = DenseConfig(use_lstm=use_lstm, batch_size=TRAIN_BATCH,
                      max_regions=N_REGIONS)
    # as train_gt: the train split's image count, read as an update count
    finetune_start = len(loader.train_ix)

    def build():
        model = dd.build_gt_model(cfg, VOCAB, SEQ, dev)
        return model, dd.make_dense_optimizer(cfg, model, finetune_start)
    model, opt = build()
    seeded_init_(model, SEED)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 1)
    step = dd.make_gt_train_step(model, opt, cfg.use_curriculum_learning,
                                 gen)

    def batches():
        while True:
            yield from loader.padded_batches(0, TRAIN_BATCH, N_REGIONS)
    feed = batches()
    losses = []

    def run(k):
        for _ in range(k):
            losses.append(step(*dd.to_device(next(feed), dev), 1.0))
    encoder = model.features[dd.FROZEN_FEATURES].weight   # conv3_1
    encoder0 = encoder.detach().clone()
    run(TRAIN_WARMUP)
    torch.cuda.synchronize()
    encoder_still_before = torch.equal(encoder, encoder0)
    for name in ROI_WRAPPERS:
        getattr(roi, name).launches = 0
    torch.cuda.reset_peak_memory_stats()
    # the step's host side (a Python LSTM loop and autograd) varies run to
    # run: several windows, each timed by events
    window_ms = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(TRAIN_STEPS)
        end.record()
        torch.cuda.synchronize()
        window_ms.append(start.elapsed_time(end) / TRAIN_STEPS)
    wall_s = time.perf_counter() - t0
    launches = {name: getattr(roi, name).launches for name in ROI_WRAPPERS}
    step_ms = float(np.median(window_ms))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    encoder_moved_after = not torch.equal(encoder, encoder0)
    loss_values = [float(v) for v in losses]
    if not all(np.isfinite(loss_values)):
        raise AssertionError(f"non-finite training loss: {loss_values}")
    steps = TRAIN_WINDOWS * TRAIN_STEPS
    if launches["roi_align_bwd_features"] != steps or launches[
            "roi_align_batch_chw"] != steps or launches[
            "roi_align_bwd_boxes"] != 0:
        raise AssertionError(f"ROI launches in {steps} steps: {launches}")
    if not (encoder_still_before and encoder_moved_after):
        raise AssertionError(
            f"encoder lr boundary at update {finetune_start}: unchanged "
            f"after {TRAIN_WARMUP} updates {encoder_still_before}, moved "
            f"after {TRAIN_WARMUP + steps} {encoder_moved_after}")

    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t1 = time.perf_counter()
        run(1)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    events = p.key_averages()
    # the card's own work: kernels and copies, not the ranges the
    # optimizer annotates around its kernels, nor the profiler's buffers
    kernels = sorted((e for e in events
                      if str(e.device_type).endswith("CUDA")
                      and not e.is_user_annotation
                      and e.key != "Activity Buffer Request"),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kind = {}
    for e in kernels:
        kind = next((k for k, words in KERNEL_KINDS
                     if any(w in e.key for w in words)),
                    "elementwise, reductions, other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / table).write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))

    # a full checkpoint, saved and restored into a fresh model and
    # optimizer, must give back the same bits
    done = TRAIN_WARMUP + steps + 1
    cursor = done % (TRAIN_SPLIT // TRAIN_BATCH) * TRAIN_BATCH
    path = out_dir / "chip_smoke_train.ckpt"
    t1 = time.perf_counter()
    ckptlib.save_checkpoint(str(path), dd.gt_train_state(
        model, opt, done, gen, cursor))
    save_s = time.perf_counter() - t1
    ckpt_gb = path.stat().st_size / 1e9
    model2, opt2 = build()
    gen2 = torch.Generator(dev)
    restored = dd.load_gt_train_state(
        ckptlib.restore_checkpoint(str(path), torch.device("cpu")),
        model2, opt2, gen2)
    path.unlink()
    round_trip = (restored == (done, cursor)
                  and same_state(model.state_dict(), model2.state_dict())
                  and same_state(opt.state_dict(), opt2.state_dict())
                  and torch.equal(gen.get_state(), gen2.get_state()))
    if not round_trip:
        raise AssertionError("the restored checkpoint differs from the "
                             "saved state")
    del model2, opt2

    res = {
        "card": card,
        "images": f"{TRAIN_BATCH} x {TRAIN_IMAGE}^2 uint8, {N_REGIONS} "
                  f"regions each, vocab {VOCAB}, seq {SEQ}",
        "steps_timed": steps, "window_step_ms": window_ms,
        "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "images_per_s": TRAIN_BATCH / step_ms * 1e3,
        "regions_per_s": TRAIN_BATCH * N_REGIONS / step_ms * 1e3,
        "timed_wall_s": wall_s, "peak_mem_gb": peak_gb,
        "loss_per_step": loss_values, "launches": launches,
        "encoder_lr_boundary_update": finetune_start,
        "encoder_unchanged_before_boundary": encoder_still_before,
        "encoder_moved_after_boundary": encoder_moved_after,
        "profiled_step": {
            "wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
            # the profiler slows the host, so the idle share is read
            # against an unprofiled step's time
            "device_idle_share_of_timed_step": 1 - busy_ms / step_ms,
            "device_ms_by_kind": by_kind,
            "kernels_and_copies": sum(e.count for e in kernels),
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               for e in kernels[:10]}},
        "checkpoint": {"gb": ckpt_gb, "save_s": save_s,
                       "round_trip_bitwise": round_trip},
    }
    print(f"{label}: {json.dumps(res)}", flush=True)
    return res


def train_step_check(dev, use_lstm=True, label="train step (fp32 card vs "
                     "CPU, full width)", card=""):
    """One fp32 train step at full width on the card vs the CPU from the
    same weights, small input, dropout off on both (phase 9; phase 11 with
    `use_lstm` False)."""
    from imagecaptioning_tpu_torch.config.dense_configs import DenseConfig
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    cfg = DenseConfig(use_lstm=use_lstm, compute_dtype="float32")
    rng = np.random.RandomState(SEED + 3)
    images = torch.from_numpy(rng.randint(0, 256, (2, 96, 96, 3),
                                          dtype=np.uint8))
    boxes = torch.from_numpy(edge_boxes(rng, 2, 8, 96, 96))
    labels = torch.from_numpy(rng.randint(1, VOCAB + 1, (2, 8, SEQ)))
    labels[:, :, 9:] = 0
    mask = torch.ones(2, 8)
    mask[1, 7] = 0.0
    twins = [dd.build_gt_model(cfg, VOCAB, SEQ, d)
             for d in (torch.device("cpu"), dev)]
    twins[1].load_state_dict(seeded_init_(twins[0], SEED).state_dict())
    losses = []
    for model in twins:
        d = next(model.parameters()).device
        model.classifier[2].p = 0.0     # the two generators draw apart
        # the encoder trains from the first update, so every group moves
        opt = dd.make_dense_optimizer(cfg, model, 0)
        step = dd.make_gt_train_step(model, opt, False,
                                     torch.Generator(d).manual_seed(SEED))
        losses.append(float(step(images.to(d), boxes.to(d), labels.to(d),
                                 mask.to(d), 1.0)))
    loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    worst, worst_name, off, total = 0.0, "", 0, 0
    cpu_params = dict(twins[0].named_parameters())
    for name, p in twins[1].named_parameters():
        d = (p.detach().cpu() - cpu_params[name].detach()).abs()
        if float(d.max()) > worst:
            worst, worst_name = float(d.max()), name
        off += int((d > 1e-7).sum())
        total += d.numel()
    res = {"card": card, "loss_cpu": losses[0], "loss_card": losses[1],
           "loss_rel_err": loss_rel, "param_max_abs_diff": worst,
           "param_max_abs_diff_at": worst_name,
           "params_over_1e-7_share": off / total,
           "tolerance": f"loss {LOSS_REL_TOL} relative; params within "
                        f"2 lr = {2 * cfg.learning_rate}, at most 1e-5 of "
                        f"them more than 1e-7 apart"}
    print(f"{label}: {json.dumps(res)}", flush=True)
    if not (loss_rel <= LOSS_REL_TOL and worst <= 2 * cfg.learning_rate
            + 1e-7 and off / total <= 1e-5):
        raise AssertionError(f"card train step differs from the CPU's: "
                             f"{res}")
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
    libs = _kernels.build_all(["roi_align", "roi_align_bwd"])
    _kernels.roi_align_lib()
    _kernels.roi_align_bwd_lib()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(lib.name for lib in libs.values())}")
    for lib in libs.values():
        print("".join(line for line in Path(f"{lib}.log").read_text()
                      .splitlines(keepends=True)
                      if any(w in line for w in ("Used", "spill",
                                                 "properties"))))

    flush = torch.zeros(2, FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    print(f"events around no work: {device_ms(lambda: None, 50)} ms")
    slice_roi, slice_calls = check_roi_kernel(
        dev, roi, N_IMAGES, N_REGIONS, IMAGE // 32, 512, IMAGE, 200, flush)
    canvas_roi, canvas_calls = check_roi_kernel(
        dev, roi, 1, N_REGIONS, 720 // 32, 512, 720, 200, flush)

    def build(d, dtype, use_lstm=True):
        with torch.device(d):
            m = GTDenseCaptioner(vocab_size=VOCAB, seq_length=SEQ,
                                 use_lstm=use_lstm, embedding_size=512,
                                 rnn_size=512, num_lstm_layers=1,
                                 vgg_stages=5, compute_dtype=dtype)
        return m.eval()

    def seeded(use_lstm):
        t0 = time.perf_counter()
        model = weights.seeded_init_(build(dev, torch.bfloat16, use_lstm),
                                     SEED)
        print(f"model init ({'LSTM' if use_lstm else 'transformer'} head, "
              f"seed {SEED}): {time.perf_counter() - t0:.2f} s, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
              f"params")
        return model

    model = seeded(True)
    served, run_beam, run_greedy = serve(dev, model, api, normalize_images,
                                         roi, flush, card=smi)
    add_cupti(slice_roi, slice_calls, 200, flush)
    add_cupti(canvas_roi, canvas_calls, 200, flush)
    prof = profile(run_beam, run_greedy, args.out_dir, card=smi,
                   served=served)
    ref = reference_check(dev, model, build, api, card=smi)
    del model, run_beam, run_greedy

    # phase 10: the transformer head, the reference's default GT model
    model = seeded(False)
    t_served, run_beam, run_greedy = serve(
        dev, model, api, normalize_images, roi, flush,
        label="transformer serving", card=smi)
    t_prof = profile(run_beam, run_greedy, args.out_dir,
                     label="transformer profile", card=smi,
                     table="chip_smoke_transformer_profile.txt",
                     served=t_served)
    t_ref = reference_check(
        dev, model, lambda d, dtype: build(d, dtype, use_lstm=False), api,
        label="transformer reference check (fp32 card vs CPU, full width)",
        card=smi, same_tokens=True)
    del model, run_beam, run_greedy

    train_bwd, train_bwd_calls = check_roi_backward(
        dev, roi, TRAIN_BATCH, N_REGIONS, TRAIN_IMAGE // 32, 512,
        TRAIN_IMAGE, 200, flush)
    serve_bwd, serve_bwd_calls = check_roi_backward(
        dev, roi, N_IMAGES, N_REGIONS, IMAGE // 32, 512, IMAGE, 200, flush)
    add_cupti(train_bwd, train_bwd_calls, 200, flush)
    add_cupti(serve_bwd, serve_bwd_calls, 200, flush)
    trained = train(dev, roi, args.out_dir, card=smi)
    step_check = train_step_check(dev, card=smi)
    # phase 11: the transformer head's training
    t_trained = train(dev, roi, args.out_dir, use_lstm=False,
                      label="transformer training", card=smi,
                      table="chip_smoke_transformer_train_profile.txt")
    t_step_check = train_step_check(
        dev, use_lstm=False, card=smi,
        label="transformer train step (fp32 card vs CPU, full width)")

    # the serving path's kernel: the fused entry, bf16 map → bf16 codes
    main_case = slice_roi["roi_align_batch_chw bf16->bf16 CHW"]
    # launches over every path that runs the kernel: both heads' serving
    # and training
    serving = {"lstm": served["launches"], "transformer": t_served["launches"]}
    training = {"lstm": trained["launches"],
                "transformer": t_trained["launches"]}
    kernel = {
        "name": "roi_align_batch_chw", "route": "cuda",
        "source": "imagecaptioning_tpu_torch/csrc/roi_align.cu",
        "replaces": "imagecaptioning_tpu/ops/roi_align.py:204",
        "launches": sum(v["roi_align_batch_chw"]
                        for path in (serving, training)
                        for v in path.values()),
        # the entry's checks here and on both heads' served trunk output
        "max_abs_err": max(
            main_case["max_abs_err"],
            *(run["roi_checks_on_trunk_output"][
                "roi_align_batch_chw bf16->bf16 CHW"]["max_abs_err"]
              for run in (served, t_served))),
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
        "launches_by_path": {"serving": serving, "training": training},
        "entries": {"serving_shape": slice_roi, "n1_canvas": canvas_roi},
    }
    backward = []
    for name in ("roi_align_bwd_features", "roi_align_bwd_boxes"):
        # the training path's case: bf16 map, bf16 CHW gradient from fc6
        main_bwd = train_bwd[f"{name} bf16 map, bf16 CHW grad"]
        backward.append({
            "name": name, "route": "cuda",
            "source": "imagecaptioning_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "imagecaptioning_tpu/ops/roi_align.py:234-242",
            "launches": sum(v[name] for v in training.values()),
            "main_path": ("GT training with either head, once a step"
                          if name == "roi_align_bwd_features" else
                          "none yet: GT boxes are data, so GT training "
                          "never asks for d_boxes; the RPN slice will"),
            "max_abs_err": max(v["max_abs_err"] for k, v in
                               {**train_bwd, **serve_bwd}.items()
                               if k.startswith(name + " ")),
            "tolerance": main_bwd["tolerance"],
            "deterministic": True,
            "ms": main_bwd["ms_cold"],
            **{k: main_bwd[k] for k in (
                "ms_hot", "kernel_ms_cold", "kernel_ms_hot", "plain_ms",
                "bound_ms", "bound_by", "cold_share_of_bound", "library_ms",
                "library_ms_hot", "bytes", "shape")},
            "library": "autograd backward of affine_grid+grid_sample "
                       "(both gradients, fp32 map)",
            "entries": {
                "training_shape": {k: v for k, v in train_bwd.items()
                                   if k.startswith(name + " ")},
                "serving_shape": {k: v for k, v in serve_bwd.items()
                                  if k.startswith(name + " ")}},
        })
    summary = {"card": smi, "serving": served, "profile": prof,
               "reference_check": ref, "training": trained,
               "train_step_check": step_check,
               "transformer": {"serving": t_served, "profile": t_prof,
                               "reference_check": t_ref,
                               "training": t_trained,
                               "train_step_check": t_step_check},
               "seconds": time.perf_counter() - t_start}
    print(f"summary: {json.dumps(summary)}")
    print(smi)
    print(json.dumps({"kernels": [kernel, *backward]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
