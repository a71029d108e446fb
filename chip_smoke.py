#!/usr/bin/env python3
"""Card smoke run of the PyTorch port (imagecaptioning_tpu_torch): GT-box
dense-caption serving and training on one CUDA card, with the LSTM head
(phases 4–9) and the transformer head (phases 10–11), the full RPN
DenseCap model's training and serving (phases 12–15), the four
AlexCap families: the LSTM captioner on ResNet-101 (phases 16–18), the
attention-LSTM (19), the Transformer (20) and ViT-B (21), gradient
accumulation in the RPN (22) and AlexCap LSTM (23) trainers, the
trainers' own periodic evals (24), `evidence_run` (25), checkpoint
interchange (26: `convert_checkpoint`, `encoder_init`, `infer`) and
data-parallel training across processes (27).

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
5. the kernels' own device time (CUPTI, the mean of 50 launches), hot
   and cold, of phase 3's entries (and of 7's and 12's), and a profile
   of one greedy and one beam decode;
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
   component; both bitwise equal on a second launch (neither uses
   float atomics; each is one launch). Timed as in 3 and 5
   (events hot and cold, CUPTI, host enqueue), beside the plain version,
   autograd's backward through affine_grid+grid_sample (both gradients)
   and the bound (bytes over 3.35 TB/s against the flops over 67 TFLOP/s);
   then the same checks at the training shape for outputs of (33, 2),
   (17, 16) and (9, 40), beyond the staged kernels' 32 a side and 256
   cells, which the C entries send to their general kernels;
8. full-width training: the same model with fp32 master weights and bf16
   compute, Adam in the default `DenseConfig`'s three groups, over a
   `VGDataLoader` of 10 in-memory 720² uint8 images (8 in the train split,
   so the encoder's lr turns on at update 8, inside the run) × 32 regions
   with captions over a 10,000-word vocabulary, batch 4: 2 warm-up steps,
   then 2 windows of 12 steps, each timed by CUDA events (loss per step;
   steps/s, images/s and regions/s at the windows' median; peak memory;
   each ROI wrapper's launches: kernel A once per step, kernel B never),
   one profiled step (the card's busy time: its kernels and copies), and
   a full checkpoint saved and restored bitwise;
9. one fp32 train step at full width on the card against the CPU from
   the same weights on a small input (dropout off on both): the loss
   within 1e-4 relative; each parameter's gradient before the update
   within 1e-4 relative (|card - cpu| ≤ 1e-4 · (|cpu| + the tensor's
   max |cpu|)) in all but 1 % of its elements (a ReLU input within
   rounding of zero flips one unit's gradient); every parameter after
   the update within 2·lr of the CPU's, with at most 1e-5 of all weights
   more than 1e-7 apart (a first Adam update moves a weight by less than
   lr whatever its gradient, so only the gradients can show a wrong
   backward);
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
   per step) and its fp32 train step on the card against the CPU as in 9;
12. the RPN model (`get_densecap_config()`: VGG16 without its last pool,
   a 45×45×512 map at 720², the reference's 12 anchors, 128 + 128 sampled
   boxes) from seed 0: phase 7's checks and times at its training shape,
   the fused forward (bf16 map → bf16 CHW codes), kernel A and kernel B
   (bf16 CHW gradient (4, 256, 25,088)) on the trunk's own map of a
   training batch and one draw of the sampler at init (repeated
   negatives, forced positives partly outside the image, anchors up to
   724 px), each against its plain version, with events hot and cold,
   CUPTI, the plain version and the library (affine_grid+grid_sample, or
   autograd's backward through it), and the byte bound;
13. RPN training as in 8 (bf16 over fp32 masters, 4 × 720² images × 32
   GT regions, 256 sampled regions each): ms a step, images/s and sampled
   regions/s, the last step's loss dict with `pos_occupancy`, one
   profiled step (busy, idle share, kernels and copies by kind), peak
   memory, the checkpoint round trip; the fused forward, kernel A and
   kernel B each launched once a step;
14. one fp32 RPN train step on the card against the CPU as in 9, its
   `rpn_trans` and `box_reg` moved off their zero init and the sampler
   given the same keys on both, held as in 9 (`rpn_trans`'s gradient,
   which kernel B's d_boxes reaches through the sampled boxes, reported
   by name);
15. RPN serving at full width: `forward_test` (clip, NMS 0.7 to 300
   proposals, ROI, objectness and refined boxes, NMS 0.3) and greedy
   captions of 17 steps for every slot, on 4 × 720² uint8 images:
   images/s and regions/s from events, the NMS loops' share of a call,
   the card's NMS against the CPU's on the same boxes and scores
   (identical indices and keep), one profiled call (busy, idle share,
   kernels); then the fp32 model on the card against the CPU on a small
   input, its box heads moved off zero as in 14 (so the boxes are not the
   anchors): keep identical, boxes and scores within 1e-4 relative,
   tokens identical where both keep;
16. AlexCap serving at full width from seed 0 (`get_lstm_config`:
   ResNet-101 in bf16 over bf16 weights, LSTM 768, embedding 1024, the
   head fp32, vocab 2,048 + 3, 17 steps): 64 uint8 218×178 images on the
   card → `resnet_v2_preprocess` → greedy and beam-3 (raw-logit) decode;
   captions/s from CUDA events over 3 calls after a warm-up, before this
   phase's profiler; the card busy time of 2 profiled calls each (the
   larger),
   its idle share against the event-timed call, kernels a call and by
   kind; no ROI kernel launched; then the weights in fp32 on the card
   against the CPU on 2 images: teacher-forced logits within 1e-4, greedy
   and beam-3 tokens identical;
17. AlexCap training (batch 12, bf16 over fp32 masters, Adam in the
   encoder and head groups, clip 1.0) over 100 synthetic CelebA-size
   images (96 train) with 16-token captions over 2,048 words, the train
   split staged on the card and fed index batches (which must equal the
   streaming path's): 2 warm-up and 6 event-timed steps in the frozen
   phase (trunk in eval mode, no gradient, no Adam state), then the same
   in the finetune phase (BatchNorm on batch statistics, the trunk
   trained): images/s, busy (of PROFILED_CALLS profiled steps), idle share,
   kernels a step and peak memory each; a checkpoint (model with its
   BatchNorm buffers, optimizer, generator, step, iterators) restored
   bitwise;
18. one fp32 finetune step at full width on the card against the CPU from
   the same weights and batch (2 × 218×178 → 224²): the loss within 1e-5
   relative, each gradient before the update as in 9, BatchNorm's running
   statistics within 1e-5, every weight within 2·lr;
19-21. the attention-LSTM (`get_lstm_attention_config`: ResNet-101,
   embedding 1024, LSTM and attention 768), the Transformer
   (`get_transformer_config`: ResNet-101, fc 2048→512 + ReLU, 6 + 6
   layers over 49 positions, 8 heads, FFN 2048, dropout 0.1; its encoder
   group a hard zero) and ViT-B (`get_vitb_config`: ViT-B/16 at 224², 197
   tokens, a 6-layer decoder at 768, 8 heads, FFN 3072; its encoder
   frozen), vocab 2,048 + 3, 17 steps, each as 16-17 do the LSTM: serving
   64 images a call greedy and beam-3 with each step's attention map
   (sums to 1 within 1e-4), then fp32 on the card against the CPU on 2
   images (teacher-forced logits and alphas and the decodes' alphas and
   beam scores within 1e-4, greedy and beam-3 tokens identical);
   training at batch 12, bf16 over fp32 masters, Adam or AdamW, frozen
   then finetune phase as the driver runs them (the Transformer's trunk
   after the boundary: batch statistics and gradients in the clip,
   weights unchanged; the ViT's encoder frozen in both), a checkpoint
   restored bitwise; one train step after the boundary, dropout off, on
   the card against the CPU, each gradient as in 9: the ResNet families
   in fp64 (their trunk in training mode, as phase 18 finds), ViT-B in
   fp32;
22. RPN training at grad_accum_steps 2 (`get_densecap_config()` as in
   13, bf16 over fp32 masters) on `make_learnable_vg_arrays(16, 720²)`,
   4 images a micro-step: 2 warm-up updates, then 2 windows of 6 applied
   updates timed by events (ms an update, images/s, peak GB); K1, A and B
   launched twice an applied update (their counts over the windows); the
   busy ms of a profiled update; the first and last window's mean loss;
   then one update from two micro-steps in fp32 on the card against the
   CPU, held as in 14 (the averaged gradient before the update);
23. the AlexCap LSTM captioner at grad_accum_steps 2 (`get_lstm_config()`,
   batch 12 a micro-step) on `make_learnable_face2text_arrays(120)` staged
   on the card, with the driver's rules: the finetune boundary at
   micro-step 5 rounds up to 6, so the trunk is bitwise unchanged through
   applied update 3 and moves at each from 4 on, never mid-window, and
   BatchNorm's statistics move at every micro-step after the boundary; ms
   and images/s an update, frozen and finetuned; the mean loss of the last
   5 of 12 updates below the first 5's; a checkpoint saved one micro-step
   into a window, restored, and the window finished bitwise as without
   the stop; one update from two micro-steps in fp64 on the card against
   the CPU, held as in 18; and, as information, whether
   `torch.utils.tensorboard` and `h5py` import;
24. the trainers with their own evals, at full width: `train_gt` on the
   default GT config (transformer head, VGG16, bf16 over fp32 masters)
   and `train_rpn` on the default DenseCap config, on
   `make_learnable_vg_arrays(16, 720²)` at batch 4, and the AlexCap LSTM
   `train` (ResNet-101) on `make_learnable_face2text_arrays(40)` at batch
   12: 4 steps, a val eval after 2 and 4 (mAP and METEOR from the port's
   scorer; BLEU, BLEU-4 and CIDEr-D for AlexCap), the best checkpoint
   kept; each eval's seconds and ROI launches, the best checkpoint's path
   and iteration; then one test-split eval each with records (GT beam-3,
   `eval_split_rpn(max_images=2)`, AlexCap beam-3), whose records, scored
   again on the host, must give the eval's numbers;
25. `python -m imagecaptioning_tpu_torch.evidence_run` for `gt` and `rpn`
   (`--epochs 2 --images 24`, its CPU-sized trunks, fp32) on the card:
   the JAX script's artifact names, `summary_*.json` with
   `final_test.ap_results.map`, `history`, `truncated` and the scorer's
   provenance, `densecap_draw` of the RPN's test detections (PIL); then
   `--model lstm_attention` (batch 3): its summary (greedy and beam 1-5
   test evals), no ROI launch, and its curves and attention overlay where
   matplotlib imports (the card's machine has none: the run prints
   "curves skipped" and writes its summary);
26. checkpoint interchange at full width, weights from seeds: a reference
   AlexGTModel `.pth` of the default GT config (with its duplicate
   `net.*` registrations, dead encoder word embedding and full position
   table) through `convert_checkpoint import-model` (port checkpoint and
   `.npz`) and `export-model` from the `.npz`, each bitwise what
   `load_gt_checkpoint` keeps of the source; `infer --model-type gt` from
   the imported checkpoint on 2 images, tokens identical to the seeded
   model's decode, K1 once an image; torchvision `vgg16`, `resnet101` and
   `vit_b_16` files through `import --arch`, `encoder_init` into a GT
   model, an AlexCap LSTM and a ViT-B captioner (every tensor the
   source's) and `export --arch` (bitwise the source's covered keys);
   one GT training step after `encoder_init` (K1 and kernel A once); a
   reference LSTMModel `.pth` (ResNet-101) through `import-model` and
   `infer --model-type lstm`, tokens identical; `dense_driver.setup`
   restoring a port checkpoint of the default GT config that the phase
   writes (its forward on a training batch bitwise the source model's,
   K1 once) and building the RPN and `roi_only` models of the default
   DenseCap config; the METEOR bridge's CLI (`meteor_bridge.main --jar`)
   over a stand-in for the jar and `java` (this Python speaking the
   METEOR-1.5 stdio protocol; no jar or JVM is on the machine), its JSON
   the stand-in's scores, with `available()` for $METEOR_JAR.
   Preprocessing needs h5py and does not run on the card: the line says
   whether h5py imports.
27. data-parallel training across processes (`parallel/mesh.py`): (a)
   the RPN trainer's entry point under `python -m torch.distributed.run
   --standalone --nproc_per_node=1` on NCCL at full width (2 steps and
   its eval, its ROI launches); (b) a world of 2 processes under gloo on
   this one card (gradients staged through the host), each on its rows
   of the RPN step at full width (4 × 720² images × 32 regions, 2 a rank,
   128 + 128 sampled, dropout and the sampler on, fp32), held against the
   one-process step on this card by phase 14's gate, with K1, A and B
   once a rank; (c) the AlexCap LSTM step after the finetune boundary at
   batch 12 (6 a rank), BatchNorm over the global batch, fp64, held alike
   and on its running statistics; (d) in the same world as ('data',
   'model') = (1, 2), the ViT-B/16 captioner of `get_vitb_config()` and
   the AlexCap Transformer on ResNet-101, each at its config's full width
   (fp32, batch 12, dropout on) with its parameters split over 'model'
   by `shard_params`, held against the same step unsplit in one process
   on this card by phase 14's gate, with the collectives each axis ran
   (all staged through the host under gloo); (e) `dryrun_multichip(2)`'s
   steps (`dryrun.rank_steps`) in the same world, split as (1, 2), the
   GT and RPN steps launching K1 and B (their trunks frozen, as in JAX's
   dry run: no kernel A); (f) the dry run's default route at n = 2
   (`dryrun.route`: gloo with both ranks on the one card here, NCCL with
   a card a rank where there are 2), printed and asserted, no process
   started; (g) in the world of (b), the AlexCap LSTM of (c) at
   grad_accum_steps 2 (fp64, batch 12 a micro-step): each micro-step's
   gradient norm within 1e-5 relative of the one-process run's and the
   update by phase 14's gate; a checkpoint rank 0 writes after the first
   micro-step, resumed on both ranks into a model and optimizer built
   anew, the window finished bitwise as without it; its line gives the
   data axis's collectives per applied update (`Axis.calls`), 2 of them
   gradient all-reduces (`dp_training`).
Every line of phases 4–27 carries the card's name and power limit. The
kernels line counts each kernel's launches over every path that runs it
(`launches`, split in `launches_by_path`): the fused forward in both GT
heads' serving and training and in RPN training (`rpn_training`, one a
step) and serving (`rpn_serving`, one a call); kernel A in both GT heads'
training and in RPN training; kernel B in RPN training, its only main
path (its numbers there are the RPN shape's; K1's and A's `rpn_shape`);
all three in phase 22, twice an applied update (`rpn_training_k2`,
`launches_per_applied_update_k2`);
the AlexCap paths launch none of them (`alexcap_serving`,
`alexcap_training`, and `alexcap_<family>_serving` and `_training` for
the other three: 0); phase 24's trainers (`gt_trainer_with_evals`: K1 and
A; `rpn_trainer_with_evals`: all three; `alexcap_trainer_with_evals`: 0)
with their evals' share (`gt_trainer_evals`, `rpn_trainer_evals`: K1
only), phase 25's runs (`evidence_gt`, `evidence_rpn`;
`evidence_lstm_attention`: 0) and phase 26's (`interchange_gt_infer`:
K1; `interchange_setup_restore`: K1 once, the restored model's forward;
`interchange_gt_step_after_encoder_init`: K1 and A;
`interchange_lstm_infer`: 0), and phase 27's (`dp`: both ranks' steps,
K1, A and B once each a rank; `dp_torchrun_train_DenseCap`: the
torchrun trainer's steps and eval; `dp_dryrun_multichip`: both ranks'
GT and RPN dry-run steps).
The last three lines: the card as nvidia-smi reports it, one JSON line of
per-kernel numbers, and {"ok": true, "device": ...}. The profiler's full
tables go to <out-dir>/chip_smoke_*_profile.txt, one for each profiled
decode or step (`--out-dir`, default
build/chip_smoke), where the checkpoints of phases 8, 11, 13, 17,
19-21 and 24-26 are written and removed (phase 25's artifacts stay under
`evidence/`).
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
# d_boxes, relative to the largest component; a train step's gradients
# (`train_step_check`), in all but GRAD_SHARE_TOL of each tensor's elements
GRAD_REL_TOL = 1e-4
GRAD_SHARE_TOL = 0.01
# the backward's outputs beyond 32 a side or 256 cells (general kernels)
GENERAL_BWD_SHAPES = ((33, 2), (17, 16), (9, 40))
TRAIN_IMAGES, TRAIN_SPLIT, TRAIN_IMAGE = 10, 8, 720
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_WINDOWS = 4, 2, 12, 2
LOSS_REL_TOL = 1e-4
# RPN serving: images a call, proposals kept an image (the DenseCap
# config's 1000 capped at 300, as build_rpn_model does), timed calls
RPN_IMAGES, RPN_PROPOSALS, RPN_SERVE_CALLS = 4, 300, 2
# kinds of the card's work in a profiled training step, by kernel name
# (the first match wins; the rest is elementwise work and reductions)
# profiled calls of each decode or step (PR 12: 1, from 2, for phase
# 27's seconds; with more, the busy time read is the median, the larger
# of two: the profiler sometimes drops a call's events, which only lowers
# a call's busy time; the card's own spread is ±1 %)
PROFILED_CALLS = 1
# launches a CUPTI mean is taken over (the kernels' device times are
# steady; the profiler's cost grows with the events it records; 50 before
# PR 12)
CUPTI_CALLS = 25
KERNEL_KINDS = (("convolution (cuDNN)", ("fprop", "dgrad", "wgrad")),
                ("matrix product (cuBLAS)", ("gemm",)),
                ("optimizer (foreach)", ("multi_tensor_apply",)),
                ("ROI kernels", ("roi_",)),
                ("sort (RPN sampler)", ("Sort", "sort")),
                ("max-pool", ("max_pool",)),
                ("host-to-card copy", ("Memcpy HtoD",)))


def roi_counts(roi) -> dict:
    """Each ROI wrapper's launch count."""
    return {name: getattr(roi, name).launches for name in ROI_WRAPPERS}


def zero_roi_counts(roi) -> None:
    for name in ROI_WRAPPERS:
        getattr(roi, name).launches = 0


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
                     **cupti_times(fn, CUPTI_CALLS, flush)}.items():
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

    zero_roi_counts(roi)
    t0 = time.perf_counter()
    greedy_ms = cuda_ms(run_greedy, iters=5, warmup=0)
    beam_ms = cuda_ms(run_beam, iters=5, warmup=0)
    wall_s = time.perf_counter() - t0
    launches = roi_counts(roi)
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


def profiled(fn, out_dir: Path, table: str, calls: int = PROFILED_CALLS):
    """`calls` profiled calls of `fn` (each synchronised) → the median call
    by the card's busy ms (of 2, the larger): its wall ms, busy ms
    (kernels and copies, not
    the optimizer's annotated ranges nor the profiler's buffers), the busy
    ms of every call, kernels and copies, busy ms and counts by kind
    (KERNEL_KINDS) and the top kernels; its table goes to `out_dir`/`table`.
    The profiler sometimes drops a call's events, which only lowers a
    call's busy time, hence the median."""
    from torch.profiler import ProfilerActivity, profile as prof
    runs = []
    for _ in range(calls):
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = p.key_averages()
        kernels = sorted((e for e in events
                          if str(e.device_type).endswith("CUDA")
                          and not e.is_user_annotation
                          and e.key != "Activity Buffer Request"),
                         key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        runs.append((busy, wall_ms, kernels, events))
    busy, wall_ms, kernels, events = sorted(
        runs, key=lambda r: r[0])[calls // 2]
    by_kind, count_by_kind = {}, {}
    for e in kernels:
        kind = next((k for k, words in KERNEL_KINDS
                     if any(w in e.key for w in words)),
                    "elementwise, reductions, other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
        count_by_kind[kind] = count_by_kind.get(kind, 0) + e.count
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / table).write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_ms_each": [r[0] for r in runs],
            "kernels_and_copies": sum(e.count for e in kernels),
            "device_ms_by_kind": by_kind,
            "kernels_and_copies_by_kind": count_by_kind,
            "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                               for e in kernels[:10]}}


def profile(run_beam, run_greedy, out_dir: Path, label="profile", card="",
            table="chip_smoke_profile.txt", served=None):
    """`profiled` for one beam and one greedy decode, the tables to
    `out_dir`/`table` with `_profile` made `_beam_profile` and
    `_greedy_profile`. The idle share is read against the profiled call,
    whose host time the profiler's CPU tracing inflates, and, given
    `served` (`serve`'s result), against its event-timed ms per call."""
    out = {"card": card}
    for name, fn in (("beam", run_beam), ("greedy", run_greedy)):
        r = profiled(fn, out_dir, table.replace("_profile",
                                                f"_{name}_profile"))
        dev_ms = r["device_busy_ms"]
        r["device_idle_share"] = ((1 - dev_ms / r["wall_ms"]) if dev_ms
                                  else "not measured")
        r["device_idle_share_of_timed_call"] = (
            (1 - dev_ms / served[f"{name}_ms"]) if dev_ms and served
            else "not measured")
        out[name] = r
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


def check_roi_backward(dev, roi, n, r, hf, c, image, iters, flush,
                       out_hw=(7, 7)):
    """Both backward kernels vs the plain backward at one shape, with their
    event times, bounds, the plain version's and the library's times →
    ({case: numbers}, {case: the call}), cases named "<entry> <maps and
    gradient>" (raises if a kernel disagrees or is not deterministic).
    Outputs beyond 32 a side or 256 cells take the general kernels."""
    rng = np.random.RandomState(SEED + 100 + n)
    f32 = torch.from_numpy(rng.randn(n, hf, hf, c).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(edge_boxes(rng, n, r, image, image)).to(dev)
    g = torch.from_numpy(rng.randn(n, r, *out_hw, c).astype(np.float32)
                         ).to(dev)
    g_chw = g.permute(0, 1, 4, 2, 3).reshape(n, r, -1).contiguous()
    hw = (float(image), float(image))
    bf16 = torch.bfloat16
    inputs = {"bf16 map, bf16 CHW grad": (f32.to(bf16), g_chw.to(bf16)),
              "fp32 map, fp32 CHW grad": (f32, g_chw),
              "fp32 map, fp32 NHWC grad": (f32, g)}
    lib_call = grid_sample_roi_backward(f32, boxes, hw, out_hw, g)
    lib = {"library_ms": device_ms(lib_call, iters // 4, flush),
           "library_ms_hot": device_ms(lib_call, iters // 4)}
    shape = f"N={n} R={r} {hf}x{hf}x{c} image {image} -> {out_hw[0]}x{out_hw[1]}"
    def entries(feats, grad):
        """entry → (kernel call, plain call, its check, what the kernel
        reads, its fp32 flops: 4 FMAs per gradient element for A; for B
        two tap differences, two weighted sums and two FMAs)."""
        return {
            "roi_align_bwd_features": (
                lambda: roi.roi_align_bwd_features(feats, boxes, grad, hw,
                                                   out_hw),
                lambda: roi.roi_align_backward_reference(
                    feats, boxes, grad, hw, out_hw, need_boxes=False)[0],
                compare, (grad, boxes), 8 * grad.numel()),
            "roi_align_bwd_boxes": (
                lambda: roi.roi_align_bwd_boxes(feats, boxes, grad, hw,
                                                out_hw),
                lambda: roi.roi_align_backward_reference(
                    feats, boxes, grad, hw, out_hw, need_features=False)[1],
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
    """Two (optimizer or model) state dicts equal, tensors bitwise (on
    the first one's device, so that a card's state is not copied off
    it)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_state, a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b.to(a.device)))
    return a == b


def train_setup(dev, kind):
    """(config, build(device) → model, step(model, optimizer, generator)
    → a call of (batch on the device, keys) returning the loss dict, the
    trunk's name) for the GT heads (`kind` "lstm" or "transformer") or the
    RPN model ("rpn")."""
    from imagecaptioning_tpu_torch.config.dense_configs import (
        DenseConfig, get_densecap_config)
    from imagecaptioning_tpu_torch.train import dense_driver as dd

    if kind == "rpn":
        cfg = get_densecap_config().replace(batch_size=TRAIN_BATCH,
                                            max_regions=N_REGIONS)

        def make_step(model, opt, gen):
            step = dd.make_rpn_train_step(model, opt, gen)
            return lambda images, boxes, labels, mask, keys=None: step(
                images, boxes, mask, labels, keys)
        return cfg, dd.build_rpn_model, make_step, "conv_trunk"
    cfg = DenseConfig(use_lstm=kind == "lstm", batch_size=TRAIN_BATCH,
                      max_regions=N_REGIONS)

    def make_step(model, opt, gen):
        step = dd.make_gt_train_step(model, opt, cfg.use_curriculum_learning,
                                     gen)
        return lambda images, boxes, labels, mask, keys=None: {
            "total": step(images, boxes, labels, mask, 1.0)}
    return cfg, dd.build_gt_model, make_step, "features"


def train(dev, roi, out_dir: Path, kind="lstm", label="training", card="",
          table="chip_smoke_train_profile.txt"):
    """Full-width training (phase 8; 11 with the transformer head, 13 with
    the RPN model) → its numbers (raises on a failed check)."""
    from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    arrays, info = make_train_data(np.random.RandomState(SEED + 2))
    loader = VGDataLoader(arrays=arrays, info=info)
    cfg, build_model, make_step, trunk = train_setup(dev, kind)
    # as the drivers: the train split's image count, read as an update count
    finetune_start = len(loader.train_ix)

    def build():
        model = build_model(cfg, VOCAB, SEQ, dev)
        return model, dd.make_dense_optimizer(cfg, model, finetune_start)
    model, opt = build()
    seeded_init_(model, SEED)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 1)
    step = make_step(model, opt, gen)

    def batches():
        while True:
            yield from loader.padded_batches(0, TRAIN_BATCH, N_REGIONS)
    feed = batches()
    losses = []

    def run(k):
        for _ in range(k):
            losses.append(step(*dd.to_device(next(feed), dev)))
    encoder = getattr(model, trunk)[dd.FROZEN_FEATURES].weight   # conv3_1
    encoder0 = encoder.detach().clone()
    run(TRAIN_WARMUP)
    torch.cuda.synchronize()
    encoder_still_before = torch.equal(encoder, encoder0)
    zero_roi_counts(roi)
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
    launches = roi_counts(roi)
    step_ms = float(np.median(window_ms))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    encoder_moved_after = not torch.equal(encoder, encoder0)
    loss_values = [float(d["total"]) for d in losses]
    if not all(np.isfinite(loss_values)):
        raise AssertionError(f"non-finite training loss: {loss_values}")
    steps = TRAIN_WINDOWS * TRAIN_STEPS
    # one fused forward and one kernel A a step; kernel B only where the
    # boxes are differentiated, the RPN's sampled proposals
    want = {"roi_align_batch_chw": steps, "roi_align_bwd_features": steps,
            "roi_align_bwd_boxes": steps if kind == "rpn" else 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"ROI launches in {steps} steps: {launches}")
    if not (encoder_still_before and encoder_moved_after):
        raise AssertionError(
            f"encoder lr boundary at update {finetune_start}: unchanged "
            f"after {TRAIN_WARMUP} updates {encoder_still_before}, moved "
            f"after {TRAIN_WARMUP + steps} {encoder_moved_after}")

    profiled_step = profiled(lambda: run(1), out_dir, table)
    # the profiler slows the host, so the idle share is read against an
    # unprofiled step's time
    profiled_step["device_idle_share_of_timed_step"] = (
        1 - profiled_step["device_busy_ms"] / step_ms)

    # a full checkpoint, saved and restored into a fresh model and
    # optimizer, must give back the same bits
    done = TRAIN_WARMUP + steps + 1
    cursor = done % (TRAIN_SPLIT // TRAIN_BATCH) * TRAIN_BATCH
    path = out_dir / "chip_smoke_train.ckpt"
    t1 = time.perf_counter()
    ckptlib.save_checkpoint(str(path), ckptlib.train_state(
        model, opt, done, gen, cursor))
    save_s = time.perf_counter() - t1
    ckpt_gb = path.stat().st_size / 1e9
    model2, opt2 = build()
    gen2 = torch.Generator(dev)
    restored = ckptlib.load_train_state(
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

    regions = TRAIN_BATCH * (cfg.sampler_batch_size if kind == "rpn"
                             else N_REGIONS)
    res = {
        "card": card,
        "images": f"{TRAIN_BATCH} x {TRAIN_IMAGE}^2 uint8, {N_REGIONS} "
                  f"{'GT ' if kind == 'rpn' else ''}regions each, vocab "
                  f"{VOCAB}, seq {SEQ}",
        "regions_per_step": regions,
        "steps_timed": steps, "window_step_ms": window_ms,
        "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "images_per_s": TRAIN_BATCH / step_ms * 1e3,
        "regions_per_s": regions / step_ms * 1e3,
        "timed_wall_s": wall_s, "peak_mem_gb": peak_gb,
        "loss_per_step": loss_values, "launches": launches,
        "encoder_lr_boundary_update": finetune_start,
        "encoder_unchanged_before_boundary": encoder_still_before,
        "encoder_moved_after_boundary": encoder_moved_after,
        "profiled_step": profiled_step,
        "checkpoint": {"gb": ckpt_gb, "save_s": save_s,
                       "round_trip_bitwise": round_trip},
    }
    if kind == "rpn":
        res["last_step_losses"] = {k: float(v)
                                   for k, v in losses[-1].items()}
    print(f"{label}: {json.dumps(res)}", flush=True)
    return res


def move_box_heads_(model, seed):
    """Move the RPN's zero-initialised `rpn_trans` and `box_reg` weights
    off zero (normal, std 0.05 and 0.01, as the CPU parity tests do), so
    that the proposals and the refined boxes differ from the anchors and
    the card runs `apply_box_transform` on non-zero deltas. Returns
    `model`."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for layer, scale in ((model.rpn_trans, 0.05), (model.box_reg, 0.01)):
            layer.weight.copy_(torch.from_numpy(
                (rng.randn(*layer.weight.shape) * scale).astype(np.float32)))
    return model


def step_grads(dev, kind, dtype="float32", state=None, accum=1):
    """One train update of `kind` (`train_setup`) at full width on `dev` in
    `dtype`, from `accum` micro-steps (phase 22: 2; else 1) on phase 9's
    small input and, after it, inputs drawn alike, dropout off; the RPN's
    sampler takes fixed keys. The weights are seed 0's, the RPN's box heads
    moved off zero, or `state`. → (the weights before the update as a CPU
    state dict, the model after it, the last micro-step's loss dict,
    {name: the gradient the update took, the micro-steps' mean, on the
    CPU})."""
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    cfg, build_model, make_step, _ = train_setup(dev, kind)
    cfg = cfg.replace(compute_dtype=dtype, param_dtype=dtype,
                      grad_accum_steps=accum)
    rng = np.random.RandomState(SEED + 3)

    def draw():
        images = torch.from_numpy(rng.randint(0, 256, (2, 96, 96, 3),
                                              dtype=np.uint8))
        boxes = torch.from_numpy(edge_boxes(rng, 2, 8, 96, 96))
        labels = torch.from_numpy(rng.randint(1, VOCAB + 1, (2, 8, SEQ)))
        labels[:, :, 9:] = 0
        mask = torch.ones(2, 8)
        mask[1, 7] = 0.0
        # 96² at stride 16 (the RPN's trunk): 6 × 6 positions, 12 anchors
        keys = torch.from_numpy(rng.rand(2, 2, 6 * 6 * 12).astype(np.float32))
        return images, boxes, labels, mask, keys
    inputs = [draw() for _ in range(accum)]
    model = build_model(cfg, VOCAB, SEQ, dev)
    if state is None:
        seeded_init_(model, SEED)
        if kind == "rpn":
            move_box_heads_(model, SEED + 9)
        state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
    else:
        model.load_state_dict(state)
    # two devices' generators draw apart: no dropout
    (model.recog_base if kind == "rpn" else model.classifier)[2].p = 0.0
    # the encoder trains from the first update, so every group moves
    opt = dd.make_dense_optimizer(cfg, model, 0)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().cpu().clone()
         for n, p in model.named_parameters() if p.grad is not None}))
    step = make_step(model, opt, torch.Generator(dev).manual_seed(SEED))
    for images, boxes, labels, mask, keys in inputs:
        out = step(images.to(dev), boxes.to(dev), labels.to(dev),
                   mask.to(dev),
                   tuple(keys.to(dev)) if kind == "rpn" else None)
    if not grads:
        raise AssertionError(f"{accum} micro-steps applied no update")
    return state, model, {k: float(v) for k, v in out.items()}, grads


def grad_agreement(got, want):
    """{name: [max relative error, share of elements over GRAD_REL_TOL]}
    of the gradients `got` against `want`, relative as the CPU parity
    tests hold them: |got - want| / (|want| + max |want| of the tensor)."""
    out = {}
    for name, w in want.items():
        w = w.double()
        rel = ((got[name].double() - w).abs()
               / (w.abs() + w.abs().max()).clamp_min(1e-30))
        out[name] = [float(rel.max()),
                     float((rel > GRAD_REL_TOL).double().mean())]
    return out


def train_step_check(dev, kind="lstm", label="train step (fp32 card vs "
                     "CPU, full width)", card="", accum=1):
    """One fp32 train step at full width on the card vs the CPU from the
    same weights, small input, dropout off on both (phase 9; 11 with the
    transformer head; 14 with the RPN model, its box heads moved off zero
    and its sampler given the same keys on both): each loss within
    LOSS_REL_TOL relative; each parameter's gradient, taken before the
    update, within GRAD_REL_TOL of the CPU's (as the CPU parity tests hold
    it against JAX: |card - cpu| ≤ tol · (|cpu| + max |cpu| of the
    tensor)) in all but GRAD_SHARE_TOL of each tensor's elements; every
    weight after the update within 2·lr, at most 1e-5 of them more than
    1e-7 apart. A first Adam update moves a weight by lr·g/(|g| + eps),
    less than lr whatever g is, so the weights alone cannot show a wrong
    gradient. The share allows for ReLUs whose input lies within rounding
    of zero: where the card and the CPU disagree on its sign, one unit's
    gradient (a channel's bias and weights) differs by up to ~1e-2. With
    `accum` micro-steps an update (phase 22), the gradient held is their
    mean, and the loss the last micro-step's."""
    cfg = train_setup(dev, kind)[0]
    state, cpu_model, cpu_losses, cpu_grads = step_grads(
        torch.device("cpu"), kind, accum=accum)
    _, card_model, card_losses, card_grads = step_grads(
        dev, kind, state=state, accum=accum)
    loss_rel = max(abs(card_losses[k] - v) / max(abs(v), 1e-30)
                   for k, v in cpu_losses.items() if v != 0.0)
    zero_ok = all(card_losses[k] == 0.0 for k, v in cpu_losses.items()
                  if v == 0.0)
    agree = grad_agreement(card_grads, cpu_grads)
    grad_err = {n: e for n, (e, _) in agree.items()}
    grad_off = {n: o for n, (_, o) in agree.items()}
    grads_ok = (bool(agree) and sorted(card_grads) == sorted(agree)
                and max(grad_off.values()) <= GRAD_SHARE_TOL)
    worst, worst_name, off, total = 0.0, "", 0, 0
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in card_model.named_parameters():
        d = (p.detach().cpu() - cpu_params[name].detach()).abs()
        if float(d.max()) > worst:
            worst, worst_name = float(d.max()), name
        off += int((d > 1e-7).sum())
        total += d.numel()
    top = sorted(grad_err, key=lambda n: -grad_off[n] - grad_err[n])[:6]
    res = {"card": card, "micro_steps": accum,
           "loss_cpu": cpu_losses["total"],
           "loss_card": card_losses["total"], "loss_rel_err": loss_rel,
           "grads_compared": len(grad_err),
           "grad_share_over_tol_max": max(grad_off.values(), default=None),
           "grad_rel_err_max": max(grad_err.values(), default=None),
           "grad_worst_by_tensor": {n: agree[n] for n in top},
           "param_max_abs_diff": worst, "param_max_abs_diff_at": worst_name,
           "params_over_1e-7_share": off / total,
           "tolerance": f"each loss {LOSS_REL_TOL} relative; each gradient "
                        f"{GRAD_REL_TOL} relative in all but {GRAD_SHARE_TOL}"
                        f" of each tensor's elements; params within 2 lr = "
                        f"{2 * cfg.learning_rate}, at most 1e-5 of them more "
                        f"than 1e-7 apart"}
    if kind == "rpn":
        # [max relative error, share over GRAD_REL_TOL]
        res["grad_rpn_trans"] = {n: e for n, e in agree.items()
                                 if n.startswith("rpn_trans.")}
        res["losses_cpu"], res["losses_card"] = cpu_losses, card_losses
    print(f"{label}: {json.dumps(res)}", flush=True)
    if not (loss_rel <= LOSS_REL_TOL and zero_ok and grads_ok
            and worst <= 2 * cfg.learning_rate + 1e-7 and off / total <= 1e-5):
        raise AssertionError(f"card train step differs from the CPU's: "
                             f"{res}")
    return res


def sampled_rpn_boxes(dev, model, normalize_images):
    """The RPN's own regions at init: one training batch of make_train_data
    (4 × 720², 32 GT regions each) through the trunk and the RPN head, then
    one draw of the sampler (128 positives, forced ones partly outside the
    image, then 128 negatives, repeated where short) → (the trunk's bf16
    map (4, 45, 45, 512), the sampled boxes (4, 256, 4), the sample)."""
    from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader

    arrays, info = make_train_data(np.random.RandomState(SEED + 2))
    batch = next(VGDataLoader(arrays=arrays, info=info).padded_batches(
        0, TRAIN_BATCH, N_REGIONS))
    images = torch.from_numpy(batch["image"]).to(dev)
    gt = torch.from_numpy(batch["boxes"]).to(dev)
    gt_mask = torch.from_numpy(batch["box_mask"]).to(dev)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 5)
    hw = (float(TRAIN_IMAGE), float(TRAIN_IMAGE))
    with torch.no_grad():
        feats = model.conv_trunk(normalize_images(images,
                                                  model.compute_dtype))
        rpn = model.rpn_forward(feats)
        keys = model.draw_keys(TRAIN_BATCH, rpn.scores.shape[1], gen, dev)
        s = model.sample_regions(rpn, gt, gt_mask, keys, hw)
        idx = torch.cat([s.pos_idx, s.neg_idx], 1)
        boxes = rpn.proposals.gather(1, idx[..., None].expand(-1, -1, 4))
    return feats.contiguous(), boxes.contiguous(), s


def check_rpn_roi(dev, roi, feats, boxes, sample, iters, flush, card=""):
    """Phase 7's checks and times at the RPN training shape: the fused
    forward (bf16 map → bf16 CHW codes), kernel A and kernel B (bf16 CHW
    gradient) on the RPN's own map and sampled boxes, each against its
    plain version, with event times hot and cold, CUPTI times, the plain
    version's and the library's → {entry: numbers} (raises if one
    disagrees or two launches differ)."""
    n, r = boxes.shape[:2]
    hw = (float(TRAIN_IMAGE), float(TRAIN_IMAGE))
    bf16 = torch.bfloat16
    rng = np.random.RandomState(SEED + 6)
    g = torch.from_numpy(rng.randn(n, r, 7, 7, feats.shape[-1])
                         .astype(np.float32)).to(dev)
    grad = g.permute(0, 1, 4, 2, 3).reshape(n, r, -1).contiguous().to(bf16)
    fwd_lib, _ = grid_sample_roi(feats.float(), boxes, hw, (7, 7))
    bwd_lib = grid_sample_roi_backward(feats, boxes, hw, (7, 7), g)
    corners = torch.cat([boxes[..., :2] - (boxes[..., 2:] - 1) / 2,
                         boxes[..., :2] + (boxes[..., 2:] - 1) / 2], -1)
    outside = ((corners[..., :2] < 1)
               | (corners[..., 2:] > TRAIN_IMAGE)).any(-1)
    distinct = [len(set(map(tuple, b.tolist()))) for b in boxes.cpu()]
    boxes_desc = {
        "positives_valid": int(sample.pos_mask.sum()),
        "negatives_valid": int(sample.neg_mask.sum()),
        "distinct_boxes_per_image": distinct,
        "partly_outside_image": int(outside.sum()),
        "max_side_px": float(boxes[..., 2:].max()),
    }
    cases = {
        "roi_align_batch_chw": (
            lambda: roi.roi_align_batch_chw(feats, boxes, hw, out_dtype=bf16),
            lambda: roi.roi_align_batch_chw_reference(feats, boxes, hw,
                                                      out_dtype=bf16),
            compare, (feats, boxes), None, fwd_lib),
        "roi_align_bwd_features": (
            lambda: roi.roi_align_bwd_features(feats, boxes, grad, hw),
            lambda: roi.roi_align_backward_reference(
                feats, boxes, grad, hw, need_boxes=False)[0],
            compare, (grad, boxes), 8 * grad.numel(), bwd_lib),
        "roi_align_bwd_boxes": (
            lambda: roi.roi_align_bwd_boxes(feats, boxes, grad, hw),
            lambda: roi.roi_align_backward_reference(
                feats, boxes, grad, hw, need_features=False)[1],
            compare_boxes, (feats, boxes, grad), 14 * grad.numel(), bwd_lib),
    }
    shape = (f"N={n} R={r} (RPN sample) {feats.shape[1]}x{feats.shape[2]}x"
             f"{feats.shape[3]} bf16 image {TRAIN_IMAGE} -> 7x7, bf16 CHW")
    out = {}
    for name, (kernel, plain, check, reads, flops, lib) in cases.items():
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} at the RPN shape: two launches "
                                 f"differ")
        res = {"card": card, "shape": shape, "boxes": boxes_desc,
               **check(got, plain()), "deterministic": True,
               **roofline(reads, got, flops), **timings(kernel, iters, flush),
               **cupti_times(kernel, CUPTI_CALLS, flush),
               "plain_ms": cuda_ms(plain, iters // 4),
               "library_ms": device_ms(lib, iters // 4, flush),
               "library_ms_hot": device_ms(lib, iters // 4),
               "library": ("affine_grid+grid_sample (fp32 map)"
                           if name == "roi_align_batch_chw" else
                           "autograd backward of affine_grid+grid_sample "
                           "(both gradients, fp32 map)")}
        res["cold_share_of_bound"] = res["bound_ms"] / res["ms_cold"]
        print(f"roi at the RPN shape, {name}: {json.dumps(res)}", flush=True)
        out[name] = res
    return out


def nms_parity(nms, boxes, scores, thresh, valid):
    """The card's NMS and the CPU's on the same boxes and scores → whether
    their indices and keep masks are identical."""
    on_card = nms(boxes, scores, thresh, RPN_PROPOSALS, valid=valid)
    on_cpu = nms(boxes.cpu(), scores.cpu(), thresh, RPN_PROPOSALS,
                 valid=valid.cpu())
    return all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))


def serve_rpn(dev, build, normalize_images, roi, out_dir, card=""):
    """RPN serving at full width (phase 15): `forward_test` (clip, NMS 0.7
    to RPN_PROPOSALS, ROI, objectness and refinement, NMS 0.3) and greedy
    captions of SEQ + 1 steps for every proposal slot, on RPN_IMAGES
    uint8 720² images, bf16 trunk and classifier, fp32 heads: images/s and
    regions/s from events over RPN_SERVE_CALLS calls after a warm-up, the
    fused ROI entry's launches (one a call), the NMS loops' share of a
    call (both loops timed alone on the call's own inputs), the card's
    NMS against the CPU's on those inputs (identical indices and keep),
    and one profiled call (busy time, idle share, kernels)."""
    from imagecaptioning_tpu_torch.ops import boxes as boxlib
    from imagecaptioning_tpu_torch.ops.nms import nms
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    model = seeded_init_(build(dev, torch.bfloat16), SEED)
    rng = np.random.RandomState(SEED + 7)
    images_u8 = torch.from_numpy(rng.randint(
        0, 256, (RPN_IMAGES, TRAIN_IMAGE, TRAIN_IMAGE, 3),
        dtype=np.uint8)).to(dev)
    outs = {}

    @torch.inference_mode()
    def run():
        x = normalize_images(images_u8, torch.bfloat16)
        boxes, scores, codes, keep = model.forward_test(x)
        outs["call"] = (boxes, scores, keep,
                        model.generate_captions(codes, SEQ + 1))
    run()                                       # warm-up
    torch.cuda.synchronize()
    zero_roi_counts(roi)
    call_ms = cuda_ms(run, iters=RPN_SERVE_CALLS, warmup=0)
    launches = roi_counts(roi)
    if launches["roi_align_batch_chw"] != RPN_SERVE_CALLS:
        raise AssertionError(f"RPN serving ROI launches in "
                             f"{RPN_SERVE_CALLS} calls: {launches}")
    boxes, scores, keep, toks = outs["call"]
    slots = RPN_IMAGES * RPN_PROPOSALS
    if (boxes.shape != (RPN_IMAGES, RPN_PROPOSALS, 4)
            or toks.shape != (slots, SEQ + 1)):
        raise AssertionError(f"RPN serving shapes {tuple(boxes.shape)}, "
                             f"{tuple(toks.shape)}")
    if not (torch.isfinite(boxes[keep]).all()
            and torch.isfinite(scores[keep]).all() and keep.any()):
        raise AssertionError("RPN serving: non-finite kept boxes or scores, "
                             "or nothing kept")
    if int(toks.min()) < 0 or int(toks.max()) >= VOCAB + 3:
        raise AssertionError("RPN serving: token ids out of range")

    # the two NMS loops alone, on one call's own inputs
    hw = (float(TRAIN_IMAGE), float(TRAIN_IMAGE))
    with torch.inference_mode():
        feats = model.conv_trunk(normalize_images(images_u8, torch.bfloat16))
        rpn = model.rpn_forward(feats)
        clipped, valid = boxlib.clip_boxes(rpn.proposals, *hw)
        idx, first_keep = nms(clipped, rpn.scores, 0.7, RPN_PROPOSALS,
                              valid=valid)
        kept = clipped.gather(1, idx[..., None].expand(-1, -1, 4))
        codes = model.region_codes(feats, kept, hw)
        obj = model.objectness(codes.float())[..., 0]
        refined = boxlib.apply_box_transform(
            kept, model.box_reg(codes.float()),
            max_log_scale=model.box_transform_clamp)
        first_ms = cuda_ms(lambda: nms(clipped, rpn.scores, 0.7,
                                       RPN_PROPOSALS, valid=valid), 3, 1)
        final_ms = cuda_ms(lambda: nms(refined, obj, 0.3, RPN_PROPOSALS,
                                       valid=first_keep), 3, 1)
        same_nms = (nms_parity(nms, clipped, rpn.scores, 0.7, valid)
                    and nms_parity(nms, refined, obj, 0.3, first_keep))
    if not same_nms:
        raise AssertionError("the card's NMS and the CPU's differ on the "
                             "same boxes and scores")

    profiled_call = profiled(run, out_dir,
                             "chip_smoke_rpn_serving_profile.txt")
    profiled_call["device_idle_share_of_timed_call"] = (
        1 - profiled_call["device_busy_ms"] / call_ms)
    res = {
        "card": card,
        "images": f"{RPN_IMAGES} x {TRAIN_IMAGE}^2 uint8, "
                  f"{rpn.scores.shape[1]} anchors each, {RPN_PROPOSALS} "
                  f"proposals, greedy {SEQ + 1} steps, vocab {VOCAB}",
        "call_ms": call_ms, "images_per_s": RPN_IMAGES / call_ms * 1e3,
        "captioned_regions_per_s": slots / call_ms * 1e3,
        "kept_regions_per_call": int(keep.sum()),
        "kept_regions_per_s": int(keep.sum()) / call_ms * 1e3,
        "nms_ms": {"first_0.7": first_ms, "final_0.3": final_ms},
        "nms_share_of_call": (first_ms + final_ms) / call_ms,
        "nms_card_equals_cpu": same_nms, "launches": launches,
        "profiled_call": profiled_call,
    }
    print(f"RPN serving: {json.dumps(res)}", flush=True)
    return res


def rpn_reference_check(dev, build, card=""):
    """The full-width RPN model in fp32 on the card against the CPU on a
    small input (phase 15), its box heads moved off zero so that the
    proposals and refined boxes are not the anchors: `forward_test` keep
    masks identical, boxes and scores within LOGIT_TOL relative to their
    largest magnitude, and the greedy tokens identical for every region
    kept on both."""
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    twins = [build(d, torch.float32) for d in (torch.device("cpu"), dev)]
    seeded_init_(twins[0], SEED)
    twins[1].load_state_dict(move_box_heads_(twins[0], SEED + 9).state_dict())
    rng = np.random.RandomState(SEED + 8)
    x = torch.from_numpy(rng.randn(2, 128, 128, 3).astype(np.float32))
    outs = []
    with torch.inference_mode():
        rpn = twins[0].proposals_only(x)
        shift = float((rpn.proposals - rpn.anchors).abs().mean())
        for model in twins:
            d = next(model.parameters()).device
            boxes, scores, codes, keep = model.forward_test(x.to(d))
            toks = model.generate_captions(codes, SEQ + 1)
            outs.append([t.cpu() for t in (boxes, scores, keep, toks)])
    (bc, sc, kc, tc), (bg, sg, kg, tg) = outs
    both = (kc & kg).reshape(-1)
    box_err = float((bg - bc)[kc & kg].abs().max()) / float(bc.abs().max())
    score_err = float((sg - sc)[kc & kg].abs().max()) / float(sc.abs().max())
    res = {"card": card, "keep_identical": bool(torch.equal(kc, kg)),
           "kept": int(kc.sum()), "box_rel_err": box_err,
           "proposal_mean_abs_shift_from_anchors_px": shift,
           "score_rel_err": score_err,
           "kept_token_agreement": float((tc[both] == tg[both]).float()
                                         .mean()),
           "tolerance": f"{LOGIT_TOL} relative to the largest magnitude"}
    print(f"RPN reference check (fp32 card vs CPU, full width): "
          f"{json.dumps(res)}", flush=True)
    if not (res["keep_identical"] and box_err <= LOGIT_TOL
            and score_err <= LOGIT_TOL
            and res["kept_token_agreement"] == 1.0):
        raise AssertionError(f"RPN card outputs differ from the CPU's: {res}")
    return res


# --------------------------------- phases 16-21: the AlexCap families

ALEX_IMAGES, ALEX_HW, ALEX_VOCAB, ALEX_SEQ = 64, (218, 178), 2048, 16
ALEX_CALLS = 3
ALEX_TRAIN_IMAGES, ALEX_WARMUP, ALEX_STEPS = 100, 2, 6
BN_TOL = 1e-5
ALEX_LOSS_TOL = 1e-5
# phase 18's fp32 gate: the card's fp32 step may be no further from the
# CPU's fp64 step than FP32_K times the CPU's own fp32 step is, plus
# FP32_FLOOR (relative, per tensor)
FP32_K, FP32_FLOOR = 2.0, 1e-5
# each family's name in the output lines and infix of its profiler tables
ALEX_NAMES = {"lstm": ("AlexCap", ""),
              "lstm_attention": ("AlexCap attention-LSTM", "attention_"),
              "transformer": ("AlexCap Transformer", "transformer_"),
              "vitb": ("AlexCap ViT-B", "vitb_")}
# an attention map sums to 1 over the positions at every step
ALPHA_SUM_TOL = 1e-4


def alexcap_cfg(model_type="lstm", **kw):
    from imagecaptioning_tpu_torch.config.configs import get_config
    return get_config(model_type).replace(**kw)


def describe(cfg, model) -> str:
    """The served model in the widths its config gives."""
    trunk = f"ResNet {cfg.backbone_stages or (3, 4, 23, 3)} (bf16)"
    if cfg.model_type == "lstm":
        head = f"LSTM {cfg.lstm_size}, embedding {cfg.embedding_size}"
    elif cfg.model_type == "lstm_attention":
        head = (f"attention-LSTM {cfg.lstm_size} (attention "
                f"{cfg.lstm_size}), embedding {cfg.embedding_size}")
    elif cfg.model_type == "transformer":
        e = cfg.transformer_size
        head = (f"fc 2048->{e} + ReLU, {cfg.num_layers}-layer encoder over "
                f"49 positions, {cfg.num_layers}-layer decoder, "
                f"{cfg.num_heads} heads, FFN {4 * e}")
    else:
        vit = model.encoder
        trunk = (f"ViT-B/{vit.patch_size} ({len(vit.encoder.layers)} "
                 f"layers, {vit.hidden_dim} wide, "
                 f"{vit.encoder.layers[0].self_attention.heads} heads, "
                 f"{vit.encoder.pos_embedding.shape[1]} tokens; bf16)")
        head = (f"{cfg.num_layers}-layer decoder at {cfg.embedding_size}, "
                f"{cfg.num_heads} heads, FFN {4 * cfg.embedding_size}")
    return (f"{trunk} + {head}, vocab {model.spec.vocab_size}+3; "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
            f"params")


def alpha_sum_err(alphas) -> float:
    """The largest distance of an attention map's sum from 1 (raises on a
    non-finite map)."""
    if not bool(torch.isfinite(alphas).all()):
        raise AssertionError("non-finite attention maps")
    return float((alphas.double().sum(-1) - 1).abs().max())


def alexcap_serve(dev, roi, out_dir: Path, card="", model_type="lstm"):
    """Phases 16, 19-21: an AlexCap family served at full width from seed
    0 (its config: ResNet-101 or ViT-B/16 in bf16 over bf16 weights, the
    head fp32, vocab 2048 + 3, 17 steps) on ALEX_IMAGES uint8 CelebA-size
    images on the card: preprocess → encoder → greedy and beam-3
    (raw-logit) decode through `models.api`, with the attention maps of
    every step (not the LSTM's, which has none). captions/s from CUDA
    events over ALEX_CALLS calls after a warm-up and before this phase's
    profiler; then the median (of 2, the larger) card busy time of
    PROFILED_CALLS profiled calls each (1 since PR 12), its idle share
    against the
    event-timed call, and the kernels a call. No ROI kernel runs on this path: every ROI wrapper's
    count stays 0."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models import api
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    label, infix = ALEX_NAMES[model_type]
    t0 = time.perf_counter()
    cfg = alexcap_cfg(model_type, param_dtype="bfloat16")
    model = seeded_init_(build_model(cfg, ALEX_VOCAB, ALEX_SEQ, device=dev),
                         SEED).eval()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 16)
    images_u8 = torch.from_numpy(rng.randint(
        0, 256, (ALEX_IMAGES, *ALEX_HW, 3), dtype=np.uint8)).to(dev)
    alphas = model_type != "lstm"
    greedy = api.make_greedy_fn(model, ALEX_SEQ + 1, collect_alphas=alphas)
    beam = api.make_beam_fn(model, ALEX_SEQ + 1, BEAM, collect_alphas=alphas)
    outs = {}

    def run_greedy():
        outs["greedy"] = greedy(resnet_v2_preprocess(images_u8))

    def run_beam():
        outs["beam"] = beam(resnet_v2_preprocess(images_u8))
    for fn in (run_greedy, run_beam):          # warm-up (cuDNN, cuBLAS)
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_roi_counts(roi)
    greedy_ms = cuda_ms(run_greedy, iters=ALEX_CALLS, warmup=0)
    beam_ms = cuda_ms(run_beam, iters=ALEX_CALLS, warmup=0)
    launches = roi_counts(roi)
    if any(launches.values()):
        raise AssertionError(f"ROI kernels launched on the AlexCap path: "
                             f"{launches}")
    with torch.inference_mode():
        x = resnet_v2_preprocess(images_u8)
        pre_ms = cuda_ms(lambda: resnet_v2_preprocess(images_u8), iters=5)
        trunk_ms = cuda_ms(lambda: model.encode(x), iters=5)
    toks, res = outs["greedy"], outs["beam"]
    maps = {}
    if alphas:
        toks, greedy_alphas = toks
        if greedy_alphas.shape[:2] != (ALEX_IMAGES, ALEX_SEQ + 1) or (
                res.alphas.shape != (ALEX_IMAGES, BEAM, ALEX_SEQ + 1,
                                     greedy_alphas.shape[-1])):
            raise AssertionError(f"alpha shapes {tuple(greedy_alphas.shape)}"
                                 f", {tuple(res.alphas.shape)}")
        maps = {"positions": greedy_alphas.shape[-1],
                "greedy_sum_max_err": alpha_sum_err(greedy_alphas),
                "beam_sum_max_err": alpha_sum_err(res.alphas)}
        if max(maps["greedy_sum_max_err"],
               maps["beam_sum_max_err"]) > ALPHA_SUM_TOL:
            raise AssertionError(f"attention maps do not sum to 1: {maps}")
    v3 = ALEX_VOCAB + 3
    if toks.shape != (ALEX_IMAGES, ALEX_SEQ + 1) or res.tokens.shape != (
            ALEX_IMAGES, BEAM, ALEX_SEQ + 1):
        raise AssertionError(f"token shapes {tuple(toks.shape)}, "
                             f"{tuple(res.tokens.shape)}")
    for t in (toks, res.tokens):
        if int(t.min()) < 0 or int(t.max()) >= v3:
            raise AssertionError("token ids out of range")
    if not bool(torch.isfinite(res.scores[:, 0]).all()):
        raise AssertionError("non-finite best-beam scores")
    out = {"card": card, "model": describe(cfg, model),
           "images": f"{ALEX_IMAGES} x {ALEX_HW[0]}x{ALEX_HW[1]} uint8",
           "steps": ALEX_SEQ + 1, "beam": BEAM, "init_s": init_s,
           "greedy_ms": greedy_ms, "beam_ms": beam_ms,
           "greedy_captions_per_s": ALEX_IMAGES / greedy_ms * 1e3,
           "beam3_captions_per_s": ALEX_IMAGES / beam_ms * 1e3,
           "preprocess_ms": pre_ms, "trunk_ms": trunk_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "roi_launches": launches,
           "beam_finished_share": float(res.finished[:, 0].float().mean()),
           "greedy_tokens_head": toks[0].tolist()}
    if maps:
        out["attention_maps"] = maps
    for kind, fn, ms in (("greedy", run_greedy, greedy_ms),
                         ("beam", run_beam, beam_ms)):
        p = profiled(fn, out_dir,
                     f"chip_smoke_alexcap_{infix}{kind}_profile.txt")
        p["device_idle_share_of_timed_call"] = 1 - p["device_busy_ms"] / ms
        out[f"{kind}_profile"] = p
    print(f"{label} serving: {json.dumps(out)}", flush=True)
    return out, model


def alexcap_reference_check(dev, model, card="", model_type="lstm"):
    """The check of phases 16 and 19-21: the served weights in fp32 on the
    card against the CPU on 2 uint8 images (preprocess included):
    teacher-forced logits and alphas, and the greedy and beam-3 decodes'
    alphas and beam scores, within LOGIT_TOL; greedy and beam-3 tokens
    identical. `beam_score_gap_min` is the CPU's smallest distance
    between two of an image's final beams: how close a tie came."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models import api
    from imagecaptioning_tpu_torch.models.captioners import build_model

    cfg = alexcap_cfg(model_type, compute_dtype="float32")
    alphas = model_type != "lstm"
    sd = {k: (v.float() if v.is_floating_point() else v).cpu()
          for k, v in model.state_dict().items()}
    rng = np.random.RandomState(SEED + 17)
    images = torch.from_numpy(rng.randint(0, 256, (2, *ALEX_HW, 3),
                                          dtype=np.uint8))
    labels = torch.from_numpy(rng.randint(1, ALEX_VOCAB + 1, (2, ALEX_SEQ)))
    got = []
    for d in (torch.device("cpu"), dev):
        twin = build_model(cfg, ALEX_VOCAB, ALEX_SEQ, device=d).eval()
        twin.load_state_dict(sd)
        x = resnet_v2_preprocess(images.to(d))
        with torch.inference_mode():
            out = twin(x, labels.to(d))
            greedy = api.make_greedy_fn(twin, ALEX_SEQ + 1,
                                        collect_alphas=alphas)(x)
            beam = api.make_beam_fn(twin, ALEX_SEQ + 1, BEAM,
                                    collect_alphas=alphas)(x)
        toks, greedy_alphas = greedy if alphas else (greedy, None)
        got.append({"logits": out.logits.cpu(), "tokens": toks.cpu(),
                    "beam_tokens": beam.tokens.cpu(),
                    "beam_scores": beam.scores.cpu(),
                    "maps": [] if not alphas else [
                        out.alphas.cpu(), greedy_alphas.cpu(),
                        beam.alphas.cpu()]})
        del twin
    c, d = got
    err = float((d["logits"] - c["logits"]).abs().max())
    scores = c["beam_scores"].double().sort(dim=-1).values
    res = {"card": card, "logits_max_abs_err": err,
           "logits_max_abs": float(c["logits"].abs().max()),
           "greedy_token_agreement": float(
               (c["tokens"] == d["tokens"]).float().mean()),
           "beam_token_agreement": float(
               (c["beam_tokens"] == d["beam_tokens"]).float().mean()),
           "beam_score_max_abs_err": float(
               (c["beam_scores"] - d["beam_scores"]).abs().max()),
           "beam_score_gap_min": float((scores[:, 1:] - scores[:, :-1])
                                       .min()),
           "tolerance": f"logits, alphas and beam scores {LOGIT_TOL} "
                        f"absolute; greedy and beam tokens identical"}
    alpha_err = max((float((b - a).abs().max())
                     for a, b in zip(c["maps"], d["maps"])), default=0.0)
    if alphas:
        res["alphas_max_abs_err"] = alpha_err
    name = ALEX_NAMES[model_type][0]
    print(f"{name} reference check (fp32 card vs CPU, full width): "
          f"{json.dumps(res)}", flush=True)
    if not (np.isfinite(err) and err <= LOGIT_TOL and alpha_err <= LOGIT_TOL
            and res["beam_score_max_abs_err"] <= LOGIT_TOL
            and res["greedy_token_agreement"] == 1.0
            and res["beam_token_agreement"] == 1.0):
        raise AssertionError(f"{name} card differs from the CPU: {res}")
    return res


def alexcap_data(seed=SEED + 18):
    """A Face2Text-style split held in memory: ALEX_TRAIN_IMAGES uint8
    CelebA-size images (all but 4 in the train split), captions of 2..16
    words over ALEX_VOCAB words → (arrays, dicts)."""
    rng = np.random.RandomState(seed)
    n = ALEX_TRAIN_IMAGES
    lengths = rng.randint(2, ALEX_SEQ + 1, n)
    labels = rng.randint(1, ALEX_VOCAB + 1, (n, ALEX_SEQ)).astype(np.int32)
    labels[np.arange(ALEX_SEQ)[None] >= lengths[:, None]] = 0
    split = np.zeros(n, np.int32)
    split[-4:-2], split[-2:] = 1, 2
    arrays = {"images": rng.randint(0, 256, (n, *ALEX_HW, 3), dtype=np.uint8),
              "labels": labels, "lengths": lengths.astype(np.int32),
              "split": split,
              "attributes": np.zeros((n, 40), np.int32),
              "img_to_first_phr": np.arange(n, dtype=np.int32),
              "img_to_last_phr": np.arange(n, dtype=np.int32)}
    words = [f"w{i}" for i in range(ALEX_VOCAB)]
    info = {"token_to_idx": {w: i + 1 for i, w in enumerate(words)},
            "idx_to_token": {str(i + 1): w for i, w in enumerate(words)}}
    return arrays, info


def alexcap_train(dev, roi, out_dir: Path, card="", model_type="lstm"):
    """Phases 17 and 19-21: a family's train step at full width (its
    config: batch 12, bf16 encoder over fp32 masters, Adam (LSTM
    families) or AdamW (Transformer, ViT) in its groups, clip 1.0) over
    the synthetic split staged on the card, fed index batches (the
    resident store, whose batches must equal the streaming path's);
    ALEX_WARMUP + ALEX_STEPS event-timed steps in the frozen phase (the
    trunk in eval mode, no gradient), then as many in the finetune phase
    as the driver runs it after the boundary (BatchNorm on batch
    statistics and trunk gradients; the Transformer's trunk weights never
    move, its statistics do; a `trained_encoder` ViT stays frozen):
    images/s, the median busy ms of PROFILED_CALLS profiled steps, idle
    share, kernels a step and peak memory each; then a checkpoint (model
    with BatchNorm's buffers, optimizer, generator, step, iterators)
    restored bitwise."""
    from functools import partial

    from imagecaptioning_tpu_torch.data import device_store
    from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.driver import encoder_frozen
    from imagecaptioning_tpu_torch.train.step import make_train_step
    from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    label, infix = ALEX_NAMES[model_type]
    cfg = alexcap_cfg(model_type)
    bs = cfg.batch_size
    arrays, info = alexcap_data()
    loader = AlexDataLoader(arrays=arrays, info=info, seed=cfg.seed)
    twin = AlexDataLoader(arrays=arrays, info=info, seed=cfg.seed)
    store = device_store.stage_split(loader, 0, dev)
    feed = device_store.index_stream(loader, 0, bs, iterate=cfg.iterate)
    stream = (b for _ in iter(int, 1)
              for b in twin.epoch_batches(0, bs, shuffle=not cfg.iterate))
    same_batches = True
    for _ in range(2 * (len(loader.split_ix[0]) // bs) + 1):   # > 2 epochs
        images, labels = device_store.gather_batch(
            store, torch.from_numpy(next(feed)).to(dev))
        want_images, want_labels = next(stream)
        same_batches &= (np.array_equal(images.cpu().numpy(), want_images)
                         and np.array_equal(labels.cpu().numpy(),
                                            want_labels))
    if not same_batches:
        raise AssertionError("the resident store's batches differ from the "
                             "streaming path's")

    def build():
        m = build_model(cfg, ALEX_VOCAB, ALEX_SEQ, device=dev)
        return m, optim.make_optimizer(cfg, m, 1000)
    model, opt = build()
    seeded_init_(model, SEED)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 1)
    step = make_train_step(model, opt, gen,
                           partial(resnet_v2_preprocess, dtype=torch.bfloat16),
                           clip_norm=cfg.grad_clip_norm)
    losses = []

    def run(k):
        for _ in range(k):
            idx = torch.from_numpy(next(feed)).to(dev)
            losses.append(step(*device_store.gather_batch(store, idx))["loss"])
    vit = model_type == "vitb"
    encoder = model.encoder
    trunk_w = (encoder.conv_proj.weight if vit
               else encoder[4][0].conv1.weight)
    w0 = trunk_w.detach().clone()
    stat = None if vit else encoder[1].running_mean
    phases = {}
    for it, name in ((0, "frozen"), (1, "finetune")):
        # the driver's rule with the boundary at iteration 1
        frozen = model.freeze_encoder = encoder_frozen(cfg, it, 1)
        s0 = None if stat is None else stat.clone()
        run(ALEX_WARMUP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_roi_counts(roi)
        ms = cuda_ms(lambda: run(1), iters=ALEX_STEPS, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = roi_counts(roi)
        if any(launches.values()):
            raise AssertionError(f"ROI kernels launched on the AlexCap "
                                 f"path: {launches}")
        p = profiled(lambda: run(1), out_dir,
                     f"chip_smoke_alexcap_{infix}{name}_train_profile.txt")
        p["device_idle_share_of_timed_step"] = 1 - p["device_busy_ms"] / ms
        trains = optim.trains_encoder(cfg) and not frozen
        moved = not torch.equal(trunk_w, w0)
        enc_state = any(q in opt.state for q in encoder.parameters())
        stats_moved = None if stat is None else not torch.equal(stat, s0)
        if (moved != trains or enc_state != trains
                or stats_moved not in (None, not frozen)):
            raise AssertionError(f"{name} phase: trunk moved {moved}, its "
                                 f"Adam state {enc_state}, its BatchNorm "
                                 f"statistics moved {stats_moved}")
        phases[name] = {"encoder_frozen": frozen, "step_ms": ms,
                        "images_per_s": bs / ms * 1e3,
                        "peak_mem_gb": peak, "profiled_step": p,
                        "trunk_moved": moved, "roi_launches": launches}
        if stat is not None:
            phases[name]["bn_stats_moved"] = stats_moved
    loss_values = [float(v) for v in losses]
    if not all(np.isfinite(loss_values)):
        raise AssertionError(f"non-finite {label} loss: {loss_values}")

    path = out_dir / f"chip_smoke_alexcap_{infix}.ckpt"
    done = len(losses)
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "step": done, "generator": gen.get_state(),
             "iterators": dict(loader.iterators)}
    t1 = time.perf_counter()
    ckptlib.save_checkpoint(str(path), state)
    save_s = time.perf_counter() - t1
    ckpt_gb = path.stat().st_size / 1e9
    restored = ckptlib.restore_checkpoint(str(path), torch.device("cpu"))
    path.unlink()
    model2, opt2 = build()
    model2.load_state_dict(restored["model"])
    opt2.load_state_dict(restored["optimizer"])
    gen2 = torch.Generator(dev)
    gen2.set_state(restored["generator"])
    round_trip = (restored["step"] == done
                  and restored["iterators"] == dict(loader.iterators)
                  and same_state(model.state_dict(), model2.state_dict())
                  and same_state(opt.state_dict(), opt2.state_dict())
                  and torch.equal(gen.get_state(), gen2.get_state()))
    if not round_trip:
        raise AssertionError(f"the restored {label} checkpoint differs")
    del model2, opt2
    res = {"card": card, "batch": bs, "model": describe(cfg, model),
           "optimizer": type(opt).__name__,
           "images": f"{bs} x {ALEX_HW[0]}x{ALEX_HW[1]} uint8 a step, "
                     f"{len(loader.split_ix[0])} staged on the card "
                     f"({store.nbytes / 2**20:.1f} MiB), vocab {ALEX_VOCAB}",
           "resident_batches_equal_streaming": same_batches,
           **phases, "loss_per_step": loss_values,
           "checkpoint": {"gb": ckpt_gb, "save_s": save_s,
                          "round_trip_bitwise": round_trip}}
    print(f"{label} training: {json.dumps(res)}", flush=True)
    return res


def alexcap_step_grads(dev, state=None, dtype=torch.float32, perturb=0.0,
                       model_type="lstm", accum=1):
    """One train step of an AlexCap family at full width in `dtype` (fp32
    or fp64: weights, statistics, preprocess, encoder, head and loss), after
    the finetune boundary (a `trained_encoder` ViT's encoder frozen), its
    dropout off, on `dev` from seed 0's weights (or `state`) on 2 uint8
    CelebA-size images, their preprocessed pixels moved by `perturb`
    relative noise; with `accum` = 2 (phase 23) the same images one a
    micro-step, one update → (weights before as a CPU state dict, the model
    after, the last micro-step's loss, {name: the gradient the update took,
    on the CPU})."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.step import make_train_step
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    cfg = alexcap_cfg(model_type, compute_dtype="float32", use_dropout=False,
                      grad_accum_steps=accum)
    rng = np.random.RandomState(SEED + 19)
    images = torch.from_numpy(rng.randint(0, 256, (2, *ALEX_HW, 3),
                                          dtype=np.uint8))
    labels = torch.from_numpy(rng.randint(1, ALEX_VOCAB + 1, (2, ALEX_SEQ)))
    labels[1, 9:] = 0
    noise = torch.from_numpy(rng.randn(2, 224, 224, 3)).to(dtype)
    model = build_model(cfg, ALEX_VOCAB, ALEX_SEQ, device=dev)
    if state is None:
        seeded_init_(model, SEED)
        state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
    else:
        model.load_state_dict(state)
    model.to(dtype)
    model.encoder.compute_dtype = dtype
    opt = optim.make_optimizer(cfg, model, 10)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().cpu().clone()
         for n, p in model.named_parameters() if p.grad is not None}))

    seen = [0]                  # images preprocessed so far

    def preprocess(u8):
        x = resnet_v2_preprocess(u8, dtype=dtype)
        rows = noise[seen[0]:seen[0] + u8.shape[0]]
        seen[0] += u8.shape[0]
        return x * (1 + perturb * rows.to(u8.device))
    step = make_train_step(model, opt, torch.Generator(dev).manual_seed(SEED),
                           preprocess, clip_norm=cfg.grad_clip_norm)
    for rows in torch.arange(2).chunk(accum):
        out = step(images[rows].to(dev), labels[rows].to(dev))
    if not grads:
        raise AssertionError(f"{accum} micro-steps applied no update")
    return state, model, float(out["loss"]), grads


# gradients that are zero but for rounding: the softmax over the
# attention's positions ignores a shift of every score, so the score
# bias's gradient is held against the step's largest gradient instead
ZERO_GRADS = ("llm.attention.v.bias",)


def step_agreement(got, want, lr) -> dict:
    """Two AlexCap steps' (`alexcap_step_grads`) loss, gradients,
    BatchNorm statistics and weights against each other; ZERO_GRADS by
    their largest element on either side, relative to the largest
    gradient of the step (`zero_grads_rel_max`)."""
    _, got_model, got_loss, got_grads = got
    _, want_model, want_loss, want_grads = want
    agree = grad_agreement(got_grads, {k: v for k, v in want_grads.items()
                                       if k not in ZERO_GRADS})
    largest = max(float(v.abs().max()) for v in want_grads.values())
    zero_rel = max((max(float(got_grads[k].abs().max()),
                        float(want_grads[k].abs().max())) / largest
                    for k in ZERO_GRADS if k in want_grads), default=0.0)
    got_sd, want_sd = got_model.state_dict(), want_model.state_dict()
    worst, worst_name = 0.0, ""
    want_params = dict(want_model.named_parameters())
    for name, p in got_model.named_parameters():
        d = float((p.detach().cpu() - want_params[name].detach()).abs().max())
        if d > worst:
            worst, worst_name = d, name
    top = sorted(agree, key=lambda n: -agree[n][1] - agree[n][0])[:4]
    # every parameter but a frozen encoder's
    frozen = ({id(p) for p in want_model.encoder.parameters()}
              if getattr(want_model, "freeze_encoder", False) else set())
    trained = sorted(n for n, p in want_model.named_parameters()
                     if id(p) not in frozen)
    return {"loss": [got_loss, want_loss],
            "loss_rel_err": abs(got_loss - want_loss) / abs(want_loss),
            "grads_compared": len(agree),
            "grads_all": sorted(got_grads) == sorted(want_grads) == trained,
            "grad_share_over_tol_max": max(o for _, o in agree.values()),
            "zero_grads_rel_max": zero_rel,
            "grad_rel_err_max": max(e for e, _ in agree.values()),
            "grad_worst_by_tensor": {n: agree[n] for n in top},
            "bn_running_stats_max_abs_err": max((
                float((got_sd[k].cpu() - v).abs().max())
                for k, v in want_sd.items()
                if k.endswith(("running_mean", "running_var"))), default=0.0),
            "param_max_abs_diff": worst, "param_max_abs_diff_at": worst_name,
            "params_within_2lr": worst <= 2 * lr + 1e-7}


def distance_to_fp64(run, f64) -> dict:
    """Per tensor, an AlexCap step's (`alexcap_step_grads`) distance from
    the fp64 step: ‖g − g64‖ / ‖g64‖ for each gradient and ‖s − s64‖∞ /
    max(‖s64‖∞, 1) for each BatchNorm running statistic after the step."""
    _, model, _, grads = run
    _, model64, _, grads64 = f64
    out = {}
    for name, want in grads64.items():
        out[name] = float((grads[name].double() - want).norm()
                          / want.norm().clamp_min(1e-30))
    sd = model.state_dict()
    for name, want in model64.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            want = want.cpu()
            out[name] = float((sd[name].cpu().double() - want).abs().max()
                              / max(float(want.abs().max()), 1.0))
    return out


def fp32_bound(card32, cpu32, moved32, f64) -> dict:
    """Phase 18's fp32 gate: every gradient and BatchNorm statistic of the
    card's fp32 step within FP32_K times the CPU fp32 step's distance from
    the CPU fp64 step, plus FP32_FLOOR. The CPU's fp32 step with its pixels
    moved (`moved32`) is held to the same bound, as a correct fp32 run the
    bound must admit."""
    d_card, d_cpu, d_moved = (distance_to_fp64(r, f64)
                              for r in (card32, cpu32, moved32))
    ratio = {n: (d_card[n] - FP32_FLOOR) / d_cpu[n] if d_cpu[n] else 0.0
             for n in d_cpu}
    ratio_moved = {n: (d_moved[n] - FP32_FLOOR) / d_cpu[n] if d_cpu[n]
                   else 0.0 for n in d_cpu}
    def over(d):
        return sorted(n for n in d_cpu
                      if not d[n] <= FP32_K * d_cpu[n] + FP32_FLOOR)
    top = sorted(ratio, key=lambda n: -ratio[n])[:4]
    return {"tensors": len(d_cpu), "over_bound": over(d_card),
            "over_bound_cpu_pixels_moved": over(d_moved),
            "ratio_max": max(ratio.values()),
            "ratio_max_cpu_pixels_moved": max(ratio_moved.values()),
            "worst": {n: {"card": d_card[n], "cpu_fp32": d_cpu[n]}
                      for n in top},
            "cpu_fp32_distance_max": max(d_cpu.values()),
            "cpu_fp32_distance_head_max": max(
                d for n, d in d_cpu.items() if n.startswith("llm.")),
            "cpu_fp32_distance_median": float(np.median(list(
                d_cpu.values())))}


def alexcap_step_check(dev, card=""):
    """Phase 18: one finetune step (BatchNorm on batch statistics) at full
    width on the card against the CPU, from the same weights and batch.
    - fp32: the loss within ALEX_LOSS_TOL relative, every weight within
      2·lr, and every gradient and BatchNorm statistic within `fp32_bound`
      of the CPU's fp64 step. A seeded ResNet-101 in training mode
      amplifies a change of 1e-7 (fp32 rounding, another summation order,
      or the pixels moved by that much, which is reported) into
      whole-percent gradient differences, so no two fp32 implementations
      meet a 1e-4 gradient bound against each other there; their
      distances from fp64 stay of one order, and a wrong backward's does
      not.
    - fp64, the same step: the loss within ALEX_LOSS_TOL relative; each
      gradient before the update within GRAD_REL_TOL relative in all but
      GRAD_SHARE_TOL of each tensor's elements (as phases 9, 11 and 14);
      BatchNorm's running statistics within BN_TOL; every weight within
      2·lr. At fp64 the amplified rounding stays far below these bounds,
      and a wrong backward does not."""
    lr = alexcap_cfg().learning_rate
    cpu = torch.device("cpu")
    res = {"card": card,
           "tolerance": f"fp32: loss {ALEX_LOSS_TOL} relative, params "
                        f"within 2 lr = {2 * lr}; fp64: the same, each "
                        f"gradient {GRAD_REL_TOL} relative in all but "
                        f"{GRAD_SHARE_TOL} of each tensor's elements, "
                        f"BatchNorm statistics {BN_TOL}; fp32 gradients "
                        f"and BatchNorm statistics against the CPU's fp64 "
                        f"within {FP32_K} x the CPU fp32's distance + "
                        f"{FP32_FLOOR} relative"}
    f32 = alexcap_step_grads(cpu)
    card32 = alexcap_step_grads(dev, f32[0])
    moved32 = alexcap_step_grads(cpu, f32[0], perturb=1e-7)
    res["fp32"] = step_agreement(card32, f32, lr)
    res["fp32_cpu_vs_cpu_pixels_moved_1e-7"] = step_agreement(moved32, f32,
                                                              lr)
    f64 = alexcap_step_grads(cpu, f32[0], dtype=torch.float64)
    res["fp32_vs_cpu_fp64"] = fp32_bound(card32, f32, moved32, f64)
    del card32, moved32
    res["fp64"] = step_agreement(
        alexcap_step_grads(dev, f32[0], dtype=torch.float64), f64, lr)
    print(f"AlexCap train step (card vs CPU, full width): "
          f"{json.dumps(res)}", flush=True)
    a, b = res["fp32"], res["fp64"]
    if not (a["loss_rel_err"] <= ALEX_LOSS_TOL and a["grads_all"]
            and a["params_within_2lr"]
            and not res["fp32_vs_cpu_fp64"]["over_bound"]
            and not res["fp32_vs_cpu_fp64"]["over_bound_cpu_pixels_moved"]
            and b["loss_rel_err"] <= ALEX_LOSS_TOL
            and b["grads_all"]
            and b["grad_share_over_tol_max"] <= GRAD_SHARE_TOL
            and b["bn_running_stats_max_abs_err"] <= BN_TOL
            and b["params_within_2lr"]):
        raise AssertionError(f"AlexCap card train step differs from the "
                             f"CPU's: {res}")
    return res


def family_step_check(dev, model_type, card=""):
    """Phases 19-21's step check: one train step after the finetune
    boundary at full width on the card against the CPU, from the same
    weights and batch, dropout off. The loss within ALEX_LOSS_TOL
    relative; each gradient before the update within GRAD_REL_TOL
    relative in all but GRAD_SHARE_TOL of its elements (ZERO_GRADS within
    GRAD_REL_TOL of the step's largest gradient); BatchNorm's running
    statistics within BN_TOL; every weight within 2·lr.
    - The ResNet families in fp64: a seeded ResNet-101 in training mode
      amplifies fp32 rounding into whole-percent gradient differences
      (phase 18). The Transformer's trunk gets gradients (they enter the
      clip) and moves its statistics, but no weight.
    - ViT-B (its encoder frozen: no BatchNorm, no trunk backward) in
      fp32."""
    label = ALEX_NAMES[model_type][0]
    lr = alexcap_cfg(model_type).learning_rate
    cpu = torch.device("cpu")
    dtype = torch.float32 if model_type == "vitb" else torch.float64
    res = {"card": card, "dtype": str(dtype).split(".")[-1],
           "tolerance": f"loss {ALEX_LOSS_TOL} relative, each gradient "
                        f"{GRAD_REL_TOL} relative in all but "
                        f"{GRAD_SHARE_TOL} of each tensor's elements, "
                        f"BatchNorm statistics {BN_TOL}, params within "
                        f"2 lr = {2 * lr}"}
    want = alexcap_step_grads(cpu, dtype=dtype, model_type=model_type)
    state = want[0]
    got = alexcap_step_grads(dev, state, dtype=dtype, model_type=model_type)
    res["step"] = a = step_agreement(got, want, lr)
    if model_type == "transformer":
        after = got[1].state_dict()
        res["trunk_weights_unchanged"] = all(
            torch.equal(after[k].cpu(), state[k].to(after[k].dtype))
            for k in state if k.startswith("features.")
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked")))
        res["trunk_grads"] = sum(k.startswith("features.") for k in got[3])
    print(f"{label} train step (card vs CPU, full width): "
          f"{json.dumps(res)}", flush=True)
    if not (a["loss_rel_err"] <= ALEX_LOSS_TOL and a["grads_all"]
            and a["grad_share_over_tol_max"] <= GRAD_SHARE_TOL
            and a["zero_grads_rel_max"] <= GRAD_REL_TOL
            and a["bn_running_stats_max_abs_err"] <= BN_TOL
            and a["params_within_2lr"]
            and res.get("trunk_weights_unchanged", True)
            and res.get("trunk_grads", 1) > 0):
        raise AssertionError(f"{label} card train step differs from the "
                             f"CPU's: {res}")
    return res


# --------------------------- phases 22-23: gradient accumulation (k = 2)

ACCUM = 2
# phase 22: learnable VG images at 720², their 4 regions each; warm-up
# updates, then windows of updates, each timed by events
RPN_ACCUM_IMAGES, RPN_ACCUM_REGIONS = 16, 4
RPN_ACCUM_WARMUP, RPN_ACCUM_UPDATES, RPN_ACCUM_WINDOWS = 2, 6, 2
ACCUM_KERNELS = ("roi_align_batch_chw", "roi_align_bwd_features",
                 "roi_align_bwd_boxes")
# phase 23: learnable Face2Text images; the finetune boundary at this
# micro-step rounds up to the next window's edge; applied updates in all,
# the first warm-up and timed ones frozen, then the finetune phase's
ALEX_ACCUM_IMAGES, ALEX_ACCUM_BOUNDARY = 120, 5
ALEX_ACCUM_UPDATES, ALEX_ACCUM_LOSS_UPDATES = 12, 5


def importable(name: str):
    """True, or why `name` does not import (phase 23 prints it)."""
    import importlib
    try:
        importlib.import_module(name)
        return True
    except Exception as e:          # any failure to import is the answer
        return f"{type(e).__name__}: {e}"[:160]


def rpn_accum_train(dev, roi, out_dir: Path, card=""):
    """Phase 22: RPN DenseCap training at grad_accum_steps = ACCUM, at full
    width (`get_densecap_config()`: VGG16 at 720², 12 anchors, 128 + 128
    sampled regions, LSTM 512), bf16 over fp32 masters, on
    `make_learnable_vg_arrays(16, 720²)` (12 train images: the encoder's
    lr from applied update 6 on), batch TRAIN_BATCH a micro-step:
    RPN_ACCUM_WARMUP warm-up updates, then RPN_ACCUM_WINDOWS windows of
    RPN_ACCUM_UPDATES applied updates timed by events (ms an update,
    images/s, peak GB); the ROI kernels' launches an applied update, read
    from the wrappers' counts over the windows (each must be ACCUM); the
    card's busy ms of a profiled update (median of PROFILED_CALLS); the
    first and last window's mean loss."""
    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.data import synthetic
    from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.train.optim import applied_updates
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    cfg = get_densecap_config().replace(grad_accum_steps=ACCUM,
                                        batch_size=TRAIN_BATCH,
                                        max_regions=RPN_ACCUM_REGIONS)
    arrays, info = synthetic.make_learnable_vg_arrays(
        num_images=RPN_ACCUM_IMAGES, image_size=TRAIN_IMAGE, seed=SEED)
    loader = VGDataLoader(arrays=arrays, info=info)
    model = seeded_init_(dd.build_rpn_model(cfg, loader.getVocabSize(),
                                            loader.getSeqLength(), dev), SEED)
    boundary = applied_updates(len(loader.train_ix), ACCUM)
    opt = dd.make_dense_optimizer(cfg, model, boundary)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 1)
    step = dd.make_rpn_train_step(model, opt, gen)

    def batches():
        while True:
            yield from loader.padded_batches(0, TRAIN_BATCH,
                                             RPN_ACCUM_REGIONS)
    feed = batches()
    losses = []

    def update():
        for _ in range(ACCUM):
            images, boxes, labels, mask = dd.to_device(next(feed), dev)
            losses.append(step(images, boxes, mask, labels)["total"])
    for _ in range(RPN_ACCUM_WARMUP):
        update()
    torch.cuda.synchronize()
    zero_roi_counts(roi)
    torch.cuda.reset_peak_memory_stats()
    window_ms = []
    for _ in range(RPN_ACCUM_WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RPN_ACCUM_UPDATES):
            update()
        end.record()
        torch.cuda.synchronize()
        window_ms.append(start.elapsed_time(end) / RPN_ACCUM_UPDATES)
    launches = roi_counts(roi)
    updates = RPN_ACCUM_WINDOWS * RPN_ACCUM_UPDATES
    per_update = {k: launches[k] / updates for k in ACCUM_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    applied = int(opt.state[opt.param_groups[0]["params"][0]]["step"])
    profiled_update = profiled(update, out_dir,
                               "chip_smoke_rpn_accum_profile.txt")
    loss_values = [float(v) for v in losses]
    per_window = RPN_ACCUM_UPDATES * ACCUM
    first = loss_values[RPN_ACCUM_WARMUP * ACCUM:][:per_window]
    last = loss_values[(RPN_ACCUM_WARMUP + updates) * ACCUM - per_window:
                       (RPN_ACCUM_WARMUP + updates) * ACCUM]
    ms = float(np.median(window_ms))
    res = {"card": card, "micro_steps_per_update": ACCUM,
           "images": f"{TRAIN_BATCH} x {TRAIN_IMAGE}^2 uint8 a micro-step, "
                     f"{RPN_ACCUM_REGIONS} GT regions each (learnable "
                     f"synthetic VG, {len(loader.train_ix)} train images), "
                     f"vocab {loader.getVocabSize()}",
           "updates_timed": updates, "window_update_ms": window_ms,
           "update_ms": ms, "images_per_s": ACCUM * TRAIN_BATCH / ms * 1e3,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_applied_update": per_update,
           "applied_updates": applied, "encoder_lr_from_update": boundary,
           "profiled_update": profiled_update,
           "device_idle_share_of_timed_update":
               1 - profiled_update["device_busy_ms"] / ms,
           "first_window_mean_loss": float(np.mean(first)),
           "last_window_mean_loss": float(np.mean(last))}
    print(f"RPN training, grad_accum_steps {ACCUM}: {json.dumps(res)}",
          flush=True)
    if not all(np.isfinite(loss_values)):
        raise AssertionError(f"non-finite RPN loss at k={ACCUM}: "
                             f"{loss_values}")
    if any(v != ACCUM for v in per_update.values()) or \
            applied != RPN_ACCUM_WARMUP + updates:
        raise AssertionError(f"{updates} applied updates of {ACCUM} "
                             f"micro-steps: {applied} optimizer steps, "
                             f"ROI launches {launches}")
    return res


def alexcap_accum_train(dev, roi, out_dir: Path, card=""):
    """Phase 23: the AlexCap LSTM captioner (`get_lstm_config()`:
    ResNet-101 at 224² from 218×178 uint8, LSTM 768, batch 12 a
    micro-step) at grad_accum_steps = ACCUM on
    `make_learnable_face2text_arrays(120)` staged on the card, the
    driver's rules: the finetune boundary at micro-step
    ALEX_ACCUM_BOUNDARY goes up to the window's edge, so
    the trunk stays bitwise unchanged through that applied update and
    moves at every later one, and BatchNorm's running statistics move at
    every micro-step after it. ALEX_ACCUM_UPDATES applied updates: one
    warm-up and the rest event-timed in each phase (ms and images/s an
    update); the mean loss of the last ALEX_ACCUM_LOSS_UPDATES updates must
    be below the first's; no ROI kernel runs. Then one micro-step into a
    window, a checkpoint saved and restored, and the window finished by
    both: model, optimizer (its accumulated means included) and generator
    bitwise equal."""
    from functools import partial

    from imagecaptioning_tpu_torch.data import device_store, synthetic
    from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.driver import encoder_frozen
    from imagecaptioning_tpu_torch.train.step import make_train_step
    from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    cfg = alexcap_cfg("lstm", grad_accum_steps=ACCUM)
    bs = cfg.batch_size
    arrays, info = synthetic.make_learnable_face2text_arrays(
        num_images=ALEX_ACCUM_IMAGES, seed=SEED)
    loader = AlexDataLoader(arrays=arrays, info=info, seed=cfg.seed)
    store = device_store.stage_split(loader, 0, dev)
    feed = device_store.index_stream(loader, 0, bs, iterate=cfg.iterate)
    # the driver's rounding: up to a window's edge
    boundary = optim.applied_updates(ALEX_ACCUM_BOUNDARY, ACCUM) * ACCUM
    frozen_updates = boundary // ACCUM
    preprocess = partial(resnet_v2_preprocess, dtype=torch.bfloat16)

    def build():
        m = build_model(cfg, loader.getVocabSize(), loader.getSeqLength(),
                        device=dev)
        return m, optim.make_optimizer(cfg, m, ALEX_ACCUM_UPDATES)
    model, opt = build()
    seeded_init_(model, SEED)
    gen = torch.Generator(dev)
    gen.manual_seed(SEED + 1)
    step = make_train_step(model, opt, gen, preprocess,
                           clip_norm=cfg.grad_clip_norm)
    trunk_w = model.encoder[4][0].conv1.weight
    stat = model.encoder[1].running_mean
    w0, s0 = trunk_w.detach().clone(), stat.clone()
    losses, trunk, stats = [], [], []

    def micro_step():
        model.freeze_encoder = encoder_frozen(cfg, len(losses), boundary)
        idx = torch.from_numpy(next(feed)).to(dev)
        losses.append(step(*device_store.gather_batch(store, idx))["loss"])
        trunk.append(trunk_w.detach().clone())
        stats.append(stat.clone())

    def update():
        for _ in range(ACCUM):
            micro_step()
    zero_roi_counts(roi)
    timed = {}
    for name, n in (("frozen", frozen_updates),
                    ("finetune", ALEX_ACCUM_UPDATES - frozen_updates)):
        update()                                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(update, iters=n - 1, warmup=0)
        timed[name] = {"updates_timed": n - 1, "update_ms": ms,
                       "images_per_s": ACCUM * bs / ms * 1e3,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    launches = roi_counts(roi)
    # micro-step i ends applied update i // ACCUM + 1 when i % ACCUM is last
    unchanged_through = [i for i in range(len(trunk))
                         if torch.equal(trunk[i], w0)]
    moved_each_update = all(
        not torch.equal(trunk[i], trunk[i - ACCUM])
        for i in range(boundary + 2 * ACCUM - 1, len(trunk), ACCUM))
    still_mid_window = all(torch.equal(trunk[i], trunk[i - 1])
                           for i in range(len(trunk)) if i % ACCUM != ACCUM - 1
                           and i > 0)
    stats_frozen = all(torch.equal(s, s0) for s in stats[:boundary])
    stats_each_micro = all(not torch.equal(stats[i], stats[i - 1])
                           for i in range(boundary, len(stats)))
    loss_values = [float(v) for v in losses]
    per_update = [float(np.mean(loss_values[i:i + ACCUM]))
                  for i in range(0, len(loss_values), ACCUM)]
    first = float(np.mean(per_update[:ALEX_ACCUM_LOSS_UPDATES]))
    last = float(np.mean(per_update[-ALEX_ACCUM_LOSS_UPDATES:]))

    # one micro-step into a window, then a checkpoint; both copies finish
    # the window on the same batch
    micro_step()
    path = out_dir / "chip_smoke_alexcap_accum.ckpt"
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "step": len(losses), "generator": gen.get_state(),
             "iterators": dict(loader.iterators)}
    mid_window = opt.mini_step
    ckptlib.save_checkpoint(str(path), state)
    ckpt_gb = path.stat().st_size / 1e9
    restored = ckptlib.restore_checkpoint(str(path), torch.device("cpu"))
    path.unlink()
    model2, opt2 = build()
    model2.load_state_dict(restored["model"])
    opt2.load_state_dict(restored["optimizer"])
    gen2 = torch.Generator(dev)
    gen2.set_state(restored["generator"])
    del restored
    step2 = make_train_step(model2, opt2, gen2, preprocess,
                            clip_norm=cfg.grad_clip_norm)
    model.freeze_encoder = model2.freeze_encoder = False
    batch = device_store.gather_batch(
        store, torch.from_numpy(next(feed)).to(dev))
    resumed_loss = step2(*batch)["loss"]
    straight_loss = step(*batch)["loss"]
    resume_bitwise = (mid_window == 1 and opt.mini_step == 0
                      and torch.equal(resumed_loss, straight_loss)
                      and same_state(model.state_dict(), model2.state_dict())
                      and same_state(opt.state_dict(), opt2.state_dict())
                      and torch.equal(gen.get_state(), gen2.get_state()))
    del model2, opt2
    res = {"card": card, "micro_steps_per_update": ACCUM, "batch": bs,
           "model": describe(cfg, model),
           "images": f"{bs} x {ALEX_HW[0]}x{ALEX_HW[1]} uint8 a micro-step, "
                     f"{len(loader.split_ix[0])} learnable synthetic images "
                     f"staged on the card, vocab {loader.getVocabSize()}",
           "finetune_boundary_micro_step": [ALEX_ACCUM_BOUNDARY, boundary],
           **timed, "roi_launches": launches,
           "trunk_unchanged_after_micro_steps": len(unchanged_through),
           "trunk_moved_at_each_update_after": moved_each_update,
           "trunk_unchanged_mid_window": still_mid_window,
           "bn_stats_unchanged_while_frozen": stats_frozen,
           "bn_stats_moved_each_micro_step_after": stats_each_micro,
           "loss_per_update": per_update,
           "loss_first_updates_mean": first, "loss_last_updates_mean": last,
           "checkpoint": {"gb": ckpt_gb, "saved_mid_window": mid_window,
                          "resumed_bitwise": resume_bitwise},
           "torch_utils_tensorboard_imports": importable(
               "torch.utils.tensorboard"),
           "h5py_imports": importable("h5py")}
    print(f"AlexCap training, grad_accum_steps {ACCUM}: {json.dumps(res)}",
          flush=True)
    if not (unchanged_through == list(range(boundary + ACCUM - 1))
            and moved_each_update and still_mid_window
            and stats_frozen and stats_each_micro
            and last < first and resume_bitwise
            and not any(launches.values())
            and all(np.isfinite(loss_values))):
        raise AssertionError(f"AlexCap accumulation at k={ACCUM}: {res}")
    return res


def alexcap_accum_step_check(dev, card=""):
    """Phase 23's check: one applied update from ACCUM micro-steps (phase
    18's two images, one a micro-step) in fp64 on the card against the
    CPU, phase 18's fp64 gate: the last micro-step's loss within
    ALEX_LOSS_TOL relative, each averaged gradient before the update
    within GRAD_REL_TOL relative in all but GRAD_SHARE_TOL of its
    elements, BatchNorm's statistics within BN_TOL, every weight within
    2·lr."""
    lr = alexcap_cfg().learning_rate
    want = alexcap_step_grads(torch.device("cpu"), dtype=torch.float64,
                              accum=ACCUM)
    got = alexcap_step_grads(dev, want[0], dtype=torch.float64, accum=ACCUM)
    a = step_agreement(got, want, lr)
    res = {"card": card, "dtype": "float64", "micro_steps": ACCUM,
           "step": a,
           "tolerance": f"loss {ALEX_LOSS_TOL} relative, each gradient "
                        f"{GRAD_REL_TOL} relative in all but "
                        f"{GRAD_SHARE_TOL} of each tensor's elements, "
                        f"BatchNorm statistics {BN_TOL}, params within "
                        f"2 lr = {2 * lr}"}
    print(f"AlexCap accumulated update (card vs CPU, full width): "
          f"{json.dumps(res)}", flush=True)
    if not (a["loss_rel_err"] <= ALEX_LOSS_TOL and a["grads_all"]
            and a["grad_share_over_tol_max"] <= GRAD_SHARE_TOL
            and a["bn_running_stats_max_abs_err"] <= BN_TOL
            and a["params_within_2lr"]):
        raise AssertionError(f"AlexCap card accumulated update differs from "
                             f"the CPU's: {res}")
    return res


# ------------------------------ phase 24: the trainers' evals on the card

# learnable VG images at 720² (12 train, 2 val, 2 test) and Face2Text
# images (28 train, 6 val, 6 test); 4 steps, an eval after 2 and 4
EVAL_VG_IMAGES, EVAL_FACE_IMAGES, EVAL_STEPS, EVAL_EVERY = 16, 40, 4, 2
EVAL_SPLIT_IMAGES = 2         # eval_split_rpn(max_images=...) on the card


class EvalLog:
    """Wraps an eval function of a module for a trainer's run: each call's
    seconds (synchronised), the ROI launches it made and its scores."""

    def __init__(self, module, name: str, roi):
        self.module, self.name, self.roi = module, name, roi
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def run(*a, **k):
            before = roi_counts(self.roi)
            t0 = time.perf_counter()
            out = self.orig(*a, **k)
            torch.cuda.synchronize()
            after = roi_counts(self.roi)
            ap = out["ap_results"]
            self.calls.append({
                "split": k.get("split", a[2] if len(a) > 2 else 1),
                "seconds": time.perf_counter() - t0,
                "num_images": out["num_images"],
                "scores": {k: ap[k] for k in ("map", "meteor", "bleu",
                                              "bleu4", "cider", "detmap")
                           if k in ap},
                "roi_launches": {n: after[n] - before[n] for n in after}})
            return out
        setattr(self.module, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def rescored(records, eval_out, dense: bool) -> dict:
    """The records of a card eval scored again on the host by the port's
    scorer: the same numbers, or an AssertionError."""
    from imagecaptioning_tpu_torch.eval import dense_eval, scorer
    ap = eval_out["ap_results"]
    if dense:
        got = {"meteor": dense_eval.score_records(records)["average_score"]}
    else:
        blob = scorer.score_captions(records)
        got = {k: blob[k] for k in ("meteor", "bleu", "bleu4", "cider")}
    want = {k: ap[k] for k in got}
    if got != want or not records:
        raise AssertionError(f"records rescored {got} != the eval's {want} "
                             f"({len(records)} records)")
    return {"records": len(records), "scores": got, "equal": True}


def trainer_evals(dev, roi, out_dir: Path, card=""):
    """Phase 24: three trainers at full width on the card, each with its
    own periodic eval and best-checkpoint selection: `train_gt` on the
    default GT config (transformer head, VGG16, bf16 over fp32 masters)
    and `train_rpn` on the default DenseCap config, both on
    `make_learnable_vg_arrays(16, 720²)` at batch 4, and the AlexCap
    LSTM's `train` (ResNet-101) on `make_learnable_face2text_arrays(40)`
    at batch 12; EVAL_STEPS steps with an eval every EVAL_EVERY (val mAP,
    METEOR; BLEU, BLEU-4 and CIDEr-D for AlexCap; the eval's seconds and
    ROI launches, the scorer's provenance, the best checkpoint's path and
    iteration). Then one more card eval each, with records:
    `eval_split_gt(use_beam=True)`, `eval_split_rpn(max_images=2)` and
    AlexCap `eval_split(use_beam=True)` on the test split; those records,
    scored again on the host, must give the eval's numbers. ROI launches
    over each trainer's run (counts zeroed before it): K1 and A for GT,
    K1, A and B for the RPN, none for AlexCap."""
    from functools import partial

    from imagecaptioning_tpu_torch.config.configs import get_lstm_config
    from imagecaptioning_tpu_torch.config.dense_configs import (
        get_densecap_config, get_gt_config)
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.eval import dense_eval, eval_split, scorer
    from imagecaptioning_tpu_torch.models.captioners import DTYPES
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.train import driver

    out_dir.mkdir(parents=True, exist_ok=True)

    def paths(cfg, name):
        return cfg.replace(
            data_h5="/nonexistent", from_checkpoint=False,
            loss_file=str(out_dir / f"loss_history_{name}.json"),
            result_file=str(out_dir / f"results_history_{name}.json"),
            save_path=str(out_dir / f"best_model_{name}.ckpt"))

    def summarise(summary, log, launches, seconds):
        with open(summary["result_file"]) as f:
            hist = json.load(f)
        ckpt = summary["save_path"]
        val = [c for c in log.calls if c["split"] == 1]
        res = {"card": card, "iters": summary["iters"],
               "evals": [{"iter": h["iter"], **c}
                         for h, c in zip(hist, val)],
               "test_evals_of_the_driver": [c for c in log.calls
                                            if c["split"] != 1],
               "best_val_score": summary["best_val_score"],
               "best_iter": summary["best_iter"],
               "best_checkpoint": ckpt,
               "best_checkpoint_gb": (Path(ckpt).stat().st_size / 1e9
                                      if Path(ckpt).is_file() else None),
               "scorer": hist[-1]["ap_results"]["scorer"],
               "launches": launches, "seconds": seconds}
        if len(val) < 2 or len(hist) != len(val):
            raise AssertionError(f"{len(val)} val evals ran, "
                                 f"{len(hist)} in the history")
        if not Path(ckpt).is_file() or summary["best_iter"] is None:
            raise AssertionError(f"no best checkpoint at {ckpt}")
        return res

    def run(train_fn, cfg, module, name, **kw):
        zero_roi_counts(roi)
        t0 = time.perf_counter()
        with EvalLog(module, name, roi) as log:
            summary = train_fn(cfg, device=dev, max_iter_override=EVAL_STEPS,
                               eval_every_override=EVAL_EVERY,
                               synthetic_learnable=True, verbose=False, **kw)
        torch.cuda.synchronize()
        return summary, summarise(summary, log, roi_counts(roi),
                                  time.perf_counter() - t0)

    out = {"card": card}
    # 1. the GT captioner
    cfg = paths(get_gt_config(), "transformer_gt").replace(
        eval_batch_size=2, max_regions=RPN_ACCUM_REGIONS)
    summary, res = run(dd.train_gt, cfg, dense_eval, "eval_split_gt",
                       synthetic_images=EVAL_VG_IMAGES,
                       synthetic_image_size=TRAIN_IMAGE)
    t0 = time.perf_counter()
    ev = dense_eval.eval_split_gt(summary["model"], summary["loader"],
                                  split=2, batch_size=2,
                                  max_regions=cfg.max_regions, use_beam=True,
                                  return_records=True)
    res["test_beam_eval"] = {"seconds": time.perf_counter() - t0,
                             "ap_results": ev["ap_results"],
                             "rescored_on_host": rescored(ev["records"], ev,
                                                          dense=True)}
    out["gt"] = res
    Path(summary["save_path"]).unlink()
    del summary
    torch.cuda.empty_cache()
    print(f"trainer eval, GT transformer head: {json.dumps(res)}",
          flush=True)

    # 2. the RPN model
    cfg = paths(get_densecap_config(), "rpn").replace(
        max_regions=RPN_ACCUM_REGIONS)
    summary, res = run(dd.train_rpn, cfg, dd, "eval_split_rpn",
                       synthetic_images=EVAL_VG_IMAGES,
                       synthetic_image_size=TRAIN_IMAGE)
    t0 = time.perf_counter()
    ev = dd.eval_split_rpn(summary["model"], summary["loader"], split=2,
                           max_regions=cfg.max_regions,
                           max_images=EVAL_SPLIT_IMAGES, return_records=True)
    res["test_eval"] = {"seconds": time.perf_counter() - t0,
                        "num_images": ev["num_images"],
                        "ap_results": {k: v for k, v in
                                       ev["ap_results"].items()
                                       if "breakdown" not in k},
                        "rescored_on_host": rescored(ev["records"], ev,
                                                     dense=True)}
    out["rpn"] = res
    Path(summary["save_path"]).unlink()
    del summary
    torch.cuda.empty_cache()
    print(f"trainer eval, RPN: {json.dumps(res)}", flush=True)

    # 3. the AlexCap LSTM captioner; an epoch is EVAL_EVERY steps
    cfg = paths(get_lstm_config(), "LSTM")
    cfg = cfg.replace(
        save_checkpoint_every=EVAL_EVERY * cfg.batch_size,
        num_epochs=EVAL_STEPS // EVAL_EVERY, eval_val_batch_size=6)
    summary, res = run(driver.train, cfg, driver, "eval_split",
                       synthetic_images=EVAL_FACE_IMAGES)
    t0 = time.perf_counter()
    ev = eval_split.eval_split(
        summary["model"], summary["loader"], split=2, batch_size=6,
        preprocess=partial(resnet_v2_preprocess,
                           dtype=DTYPES[cfg.compute_dtype]),
        use_beam=True, return_records=True)
    res["test_beam_eval"] = {"seconds": time.perf_counter() - t0,
                             "ap_results": ev["ap_results"],
                             "rescored_on_host": rescored(ev["records"], ev,
                                                          dense=False)}
    out["alexcap"] = res
    Path(summary["save_path"]).unlink()
    del summary
    torch.cuda.empty_cache()
    print(f"trainer eval, AlexCap LSTM: {json.dumps(res)}", flush=True)

    want = {"gt": ("roi_align_batch_chw", "roi_align_bwd_features"),
            "rpn": ("roi_align_batch_chw", "roi_align_bwd_features",
                    "roi_align_bwd_boxes"), "alexcap": ()}
    for kind, kernels in want.items():
        launches = out[kind]["launches"]
        if any(launches[k] == 0 for k in kernels) or \
                (not kernels and any(launches.values())):
            raise AssertionError(f"{kind} trainer: ROI launches {launches}")
    out["scorer_provenance"] = scorer.scorer_provenance()
    return out


# --------------------------------- phase 25: evidence_run on the card

EVIDENCE_ARGS = ("--epochs", "2", "--images", "24")


def evidence_runs(dev, roi, out_dir: Path, card=""):
    """Phase 25: `python -m imagecaptioning_tpu_torch.evidence_run` for
    `gt` and `rpn` on the card at its own settings (CPU-sized trunks,
    fp32) with EVIDENCE_ARGS, through its `main`: the artifacts and the
    summary's schema (`final_test.ap_results.map`, `history`,
    `truncated`, the scorer), the ROI launches of each run (counts zeroed
    before it: K1 and A for gt, K1, A and B for rpn), `densecap_draw` of
    the RPN's best model's test detections (PIL); whether matplotlib
    imports; `--model lstm_attention` (batch 3): its summary
    (`final_test` greedy and beam 1-5, `history`, `truncated`), no ROI
    launch, and its curves and attention overlay where matplotlib
    imports (without it the run prints "curves skipped" and "attention
    vis skipped" and writes its summary)."""
    from imagecaptioning_tpu_torch import evidence_run
    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
    from imagecaptioning_tpu_torch.utils.visualize import densecap_draw

    base = out_dir / "evidence"
    out = {"card": card, "args": " ".join(EVIDENCE_ARGS),
           "matplotlib": importable("matplotlib")}
    want = {"gt": ("roi_align_batch_chw", "roi_align_bwd_features"),
            "rpn": ("roi_align_batch_chw", "roi_align_bwd_features",
                    "roi_align_bwd_boxes")}
    for kind, bs in (("gt", 4), ("rpn", 2)):
        zero_roi_counts(roi)
        t0 = time.perf_counter()
        summary = evidence_run.main(["--model", kind, *EVIDENCE_ARGS,
                                     "--out", str(base),
                                     "--device", str(dev)])
        torch.cuda.synchronize()
        launches = roi_counts(roi)
        seconds = time.perf_counter() - t0
        tag = f"{kind}_learnable_bs{bs}"
        with open(base / f"summary_{tag}.json") as f:
            saved = json.load(f)
        final = saved["final_test"]
        ap = final["ap_results"]
        res = {"seconds": seconds, "launches": launches,
               "final_test_map": ap["map"], "final_test_meteor":
                   ap["meteor"], "scorer": ap["scorer"],
               "history": saved["history"], "truncated": saved["truncated"],
               "best_val_score": saved["best_val_score"],
               "best_iter": saved["best_iter"],
               "records": len(final["records"]),
               "artifacts": sorted(p.name for p in base.iterdir())}
        names = [f"summary_{tag}.json"] + [
            f"{h}_{tag.replace('gt_', 'gt_finetuned_')}.json"
            for h in ("loss_history", "results_history")]
        if out["matplotlib"] is True:
            names.append(f"{tag}.png" if kind == "gt"
                         else f"{tag}_breakdown.png")
        res["missing_artifacts"] = [n for n in names
                                    if not (base / n).is_file()]
        if (any(launches[k] == 0 for k in want[kind])
                or res["missing_artifacts"]
                or not np.isfinite(ap["map"]) or saved["truncated"]
                or saved["history"]["evals"] < 1 or not final["records"]
                or "wordnet_available" not in ap["scorer"]):
            raise AssertionError(f"evidence_run --model {kind}: {res}")
        if kind == "rpn":
            model, loader = summary["model"], summary["loader"]
            batch = next(loader.padded_batches(2, 1, 4))
            x = normalize_images(torch.from_numpy(batch["image"]).to(dev))
            with torch.inference_mode():
                boxes, scores, codes, keep = model.forward_test(x)
                toks = model.generate_captions(codes,
                                               loader.getSeqLength() + 1)
            k = keep[0].cpu().numpy()
            b = boxes[0].cpu().numpy()[k][:10]
            caps = loader.vocab.decode_sequence(toks.cpu().numpy()[k][:10])
            png = base / f"densecap_{tag}.png"
            drawn = densecap_draw(batch["image"][0], b, caps, str(png))
            changed = int((drawn != batch["image"][0]).any(-1).sum())
            res["densecap_draw"] = {"boxes": len(b), "png": str(png),
                                    "pixels_changed": changed}
            if drawn.shape != batch["image"][0].shape or not png.is_file() \
                    or (len(b) and not changed):
                raise AssertionError(f"densecap_draw: {res}")
        out[kind] = res
        del summary
        torch.cuda.empty_cache()
        print(f"evidence_run --model {kind}: {json.dumps(res)}", flush=True)
    # the AlexCap branch (batch 3): its curves and attention overlay need
    # matplotlib, so where it does not import they are skipped and only
    # the summary is held
    zero_roi_counts(roi)
    t0 = time.perf_counter()
    evidence_run.main(["--model", "lstm_attention", *EVIDENCE_ARGS,
                       "--batch-size", "3", "--out", str(base),
                       "--device", str(dev)])
    torch.cuda.synchronize()
    tag = "lstm_attention_learnable_bs3"
    with open(base / f"summary_{tag}.json") as f:
        saved = json.load(f)
    final = saved["final_test"]
    vis = sorted(p.name for p in base.glob(f"vis_{tag}*.jpg"))
    res = {"seconds": time.perf_counter() - t0,
           "launches": roi_counts(roi),
           "best_val_meteor": saved["best_val_score"],
           "best_iter": saved["best_iter"], "history": saved["history"],
           "truncated": saved["truncated"],
           "test_meteor": {k: v["ap_results"]["meteor"]
                           for k, v in final.items()},
           "test_images": final["greedy"]["num_images"],
           "curves": (base / f"{tag}.png").is_file(),
           "attention_overlays": vis}
    if (any(res["launches"].values()) or saved["truncated"]
            or saved["history"]["evals"] < 1 or not final["greedy"]["records"]
            or set(final) != {"greedy", *(f"beam_{k}" for k in range(1, 6))}
            or (out["matplotlib"] is True
                and not (vis and res["curves"]))):
        raise AssertionError(f"evidence_run --model lstm_attention: {res}")
    out["alexcap_evidence"] = res
    for p in base.glob("best_model_*"):
        p.unlink()
    print(f"evidence runs: matplotlib {out['matplotlib']}, AlexCap "
          f"evidence {json.dumps(out['alexcap_evidence'])}", flush=True)
    return out


# ---------------------------- phase 26: checkpoint interchange on the card

INTERCHANGE_IMAGES = 2        # images served from each imported checkpoint
TORCHVISION_CLASSES = 1000    # the ImageNet heads the converters leave out


# a stand-in for `java -jar meteor-1.5.jar - - -stdio -l en -norm`: it
# ignores its arguments and speaks the METEOR-1.5 stdio protocol (SCORE ->
# stats line, EVAL -> float), scoring the unigram-overlap F1 of the
# candidate against its best reference
FAKE_METEOR = r"""
import sys
for line in sys.stdin:
    parts = [p.strip() for p in line.split('|||')]
    if parts[0] == 'SCORE':
        refs, cand = parts[1:-1], parts[-1].split()
        best = 0.0
        for ref in refs:
            r = ref.split()
            ov = len(set(r) & set(cand))
            if r and cand:
                best = max(best, 2.0 * ov / (len(r) + len(cand)))
        print('%d %.6f' % (len(refs), best), flush=True)
    elif parts[0] == 'EVAL':
        print(parts[1].split()[1], flush=True)
"""
# (record, the stand-in's score): F1 2·3/10 against the first reference
METEOR_RECORDS = (
    ({"candidate": "a b", "references": ["a b"]}, 1.0),
    ({"candidate": "x", "references": ["y"]}, 0.0),
    ({"candidate": "a man riding a ||| horse",
      "references": ["a man rides a horse", "a horse"]}, 0.6))


def meteor_bridge_cli(work: Path, card="") -> dict:
    """Phase 26's METEOR bridge check: the CLI (`meteor_bridge.main`) with
    `--jar` naming an empty stand-in jar and a stand-in `java` (this
    Python running FAKE_METEOR) first on PATH, so the bridge starts and
    drives its subprocess as it would the jar's; its JSON must be the
    stand-in's scores and their mean. Also `available()` for
    $METEOR_JAR (no jar is in the repository)."""
    import os

    from imagecaptioning_tpu_torch.eval import meteor_bridge

    bin_dir = work / "meteor_bin"
    bin_dir.mkdir()
    java = bin_dir / "java"
    java.write_text(f"#!{sys.executable} -u\n{FAKE_METEOR}")
    java.chmod(0o755)
    jar, src, dst = (work / "meteor-1.5.jar", work / "meteor_in.json",
                     work / "meteor_out.json")
    jar.write_bytes(b"")
    src.write_text(json.dumps([rec for rec, _ in METEOR_RECORDS]))
    path = os.environ.get("PATH", "")
    os.environ["PATH"] = f"{bin_dir}{os.pathsep}{path}"
    try:
        stand_in = meteor_bridge.available(str(jar))
        meteor_bridge.main([str(src), str(dst), "--jar", str(jar)])
    finally:
        os.environ["PATH"] = path
    got = json.loads(dst.read_text())
    want = [score for _, score in METEOR_RECORDS]
    res = {"card": card, "available_for_METEOR_JAR": meteor_bridge.available(),
           "METEOR_JAR": os.environ.get("METEOR_JAR", ""),
           "available_with_stand_in": stand_in, "cli_json": got}
    print(f"METEOR bridge: {json.dumps(res)}", flush=True)
    if not stand_in or got != {"scores": want,
                               "average_score": sum(want) / len(want)}:
        raise AssertionError(f"METEOR bridge CLI: {res}")
    return res


def state_differs(got, want) -> list:
    """The keys where two flat state dicts differ: missing on one side,
    or another dtype, shape or bit (compared on `got`'s device). BatchNorm's
    0-d step counter comes back from a `.pth` export as one element, as
    both packages' `save_state_dict` write it, and is compared by value."""
    bad = sorted(set(got) ^ set(want))
    for k in sorted(set(got) & set(want)):
        g, w = got[k], want[k]
        if k.endswith("num_batches_tracked"):
            g = g.reshape(w.shape)
        if (g.dtype != w.dtype or g.shape != w.shape
                or not torch.equal(g, w.to(g.device))):
            bad.append(k)
    return bad


def randomize_batchnorm_(module, seed):
    """BatchNorm's scales, shifts and running statistics drawn from a seed
    (`seeded_init_` leaves them at 1, 0, 0 and 1), so that a converted
    trunk has to carry every one of them."""
    gen = torch.Generator(next(module.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                for t in (m.weight, m.bias, m.running_mean, m.running_var):
                    t.uniform_(0.5, 1.5, generator=gen)


def checkpoint_interchange(dev, roi, out_dir: Path, card=""):
    """Phase 26: `convert_checkpoint` and `infer` at full width, weights
    from seeds in the reference's and torchvision's key layouts:
    1. a reference AlexGTModel `.pth` of the default GT config (transformer
       head, VGG16) with the duplicate `net.*` registrations, the encoder's
       dead word embedding and full position table;
    2. `import-model` (port checkpoint and `.npz`), then `export-model`
       from the `.npz`: what `load_gt_checkpoint` keeps of the export and
       of the import equals what it keeps of the source, bitwise;
    3. `infer --model-type gt --ckpt <imported>` on INTERCHANGE_IMAGES
       images: the seeded model's own serving decode, token for token, K1
       once an image;
    3b. `dense_driver.setup` restoring a port checkpoint of that model
       written here: its forward on a training batch bitwise the source
       model's, K1 once; the RPN and `roi_only` models of the default
       DenseCap config built by it;
    4. torchvision `vgg16`, `resnet101` and `vit_b_16` `.pth` files (their
       ImageNet heads included), `import --arch` each, `encoder_init` into
       a GT model, an AlexCap LSTM and a ViT-B captioner seeded otherwise:
       every loaded tensor the source's; `export --arch` back, equal to
       the source's covered keys;
    5. one GT training step of the model after `encoder_init`: K1 and
       kernel A once each;
    6. a reference LSTMModel `.pth` (ResNet-101) → `import-model` → `infer
       --model-type lstm`: the seeded model's decode, token for token;
    7. the METEOR bridge's CLI over a stand-in (`meteor_bridge_cli`).
    Files go under `out_dir`/interchange and are deleted as the phase goes
    (the GT files are 0.6 GB each). Whether h5py imports is printed:
    preprocessing writes HDF5, so it does not run on a machine without
    it."""
    import contextlib
    import io
    import shutil

    from PIL import Image

    from imagecaptioning_tpu_torch import convert_checkpoint as cc
    from imagecaptioning_tpu_torch import infer
    from imagecaptioning_tpu_torch.config.dense_configs import (
        get_densecap_config, get_gt_config)
    from imagecaptioning_tpu_torch.data.tokenizer import Vocab
    from imagecaptioning_tpu_torch.data.vg_loader import (VGDataLoader,
                                                          normalize_images)
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
    from imagecaptioning_tpu_torch.utils import weights
    from imagecaptioning_tpu_torch.utils.pretrained import apply_encoder_init

    work = out_dir / "interchange"
    shutil.rmtree(work, ignore_errors=True)
    (work / "photos").mkdir(parents=True)
    f = {name: str(work / name) for name in (
        "gt_reference.pth", "gt.ckpt", "gt.npz", "gt_exported.pth",
        "vgg16.pth", "resnet101.pth", "vit_b_16.pth", "lstm_reference.pth",
        "lstm.ckpt", "vg_dicts.json", "face_dicts.json", "gt_setup.ckpt")}
    seconds, t_lap = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - t_lap[0]
        t_lap[0] = now

    def quiet(fn, *a, **k):                 # infer prints its whole result
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*a, **k)

    def dicts(n, path):
        words = [f"w{i}" for i in range(n)]
        info = {"token_to_idx": {w: i + 1 for i, w in enumerate(words)},
                "idx_to_token": {str(i + 1): w for i, w in enumerate(words)}}
        Path(path).write_text(json.dumps(info))
        return Vocab.from_dicts_json(info)

    def cpu(module, prefix=""):
        return {prefix + k: v.detach().cpu()
                for k, v in module.state_dict().items()}

    def check(name, bad):
        if bad:
            raise AssertionError(f"interchange {name}: {len(bad)} tensors "
                                 f"differ, e.g. {bad[:4]}")

    rng = np.random.RandomState(SEED + 26)
    for i in range(INTERCHANGE_IMAGES):
        Image.fromarray(rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)
                        ).save(work / "photos" / f"p{i}.png")
    photos = str(work / "photos")
    vg_vocab, face_vocab = (dicts(VOCAB, f["vg_dicts.json"]),
                            dicts(ALEX_VOCAB, f["face_dicts.json"]))
    out = {"card": card, "h5py": importable("h5py"),
           "preprocessing": "not run on the card: it writes HDF5 through "
                            "h5py (the CPU tests hold it to JAX's)"}
    print(f"interchange: h5py {out['h5py']}; preprocessing "
          f"{out['preprocessing']}", flush=True)
    lap("set-up")

    # 1-2. a reference GT checkpoint, imported and exported again
    gt_cfg = get_gt_config().replace(batch_size=TRAIN_BATCH,
                                     max_regions=N_REGIONS)
    gt_src = weights.seeded_init_(dd.build_gt_model(gt_cfg, VOCAB, SEQ, dev),
                                  SEED + 26).eval()
    sd = cpu(gt_src)
    gen = torch.Generator().manual_seed(SEED + 26)
    ref = dict(sd)
    pos = torch.randn(sd["llm.decoder.position_embedding.weight"].shape,
                      generator=gen)
    pos[:1] = sd["llm.encoder.position_embedding.weight"]
    ref["llm.encoder.position_embedding.weight"] = pos
    ref["llm.encoder.word_embedding.weight"] = torch.randn(
        sd["llm.decoder.word_embedding.weight"].shape, generator=gen)
    for k, v in sd.items():                  # the same tensors, twice
        if k.startswith("features."):
            ref["net.vgg16_backbone." + k[len("features."):]] = v
        elif k.startswith("classifier."):
            ref["net.full_conv." + k[len("classifier."):]] = v
    torch.save(ref, f["gt_reference.pth"])
    out["gt_reference_gb"] = Path(f["gt_reference.pth"]).stat().st_size / 1e9
    lap("1 reference GT .pth")
    meta = cc.main(["import-model", "--src", f["gt_reference.pth"],
                    "--dst", f["gt.ckpt"], "--npz", f["gt.npz"]])
    lap("2 import-model GT")
    cc.main(["export-model", "--src", f["gt.npz"],
             "--dst", f["gt_exported.pth"]])
    lap("2 export-model GT")
    kept = weights.load_gt_checkpoint(f["gt_reference.pth"])
    check("GT import-model", state_differs(
        weights.load_gt_checkpoint(f["gt.ckpt"]), kept))
    check("GT export-model", state_differs(
        weights.load_gt_checkpoint(f["gt_exported.pth"]), kept))
    out["gt_round_trip"] = {"meta": meta, "tensors": len(kept),
                            "bitwise": True}
    for name in ("gt_reference.pth", "gt.npz", "gt_exported.pth"):
        Path(f[name]).unlink()
    del kept, ref
    lap("2 GT checks")

    # 3. serving the imported checkpoint
    zero_roi_counts(roi)
    got = quiet(infer.main, ["--model-type", "gt", "--ckpt", f["gt.ckpt"],
                             "--dicts", f["vg_dicts.json"],
                             "--images", photos, "--device", str(dev)])
    launches = roi_counts(roi)
    served = infer.build_gt_model(gt_cfg, VOCAB, SEQ, dev)
    served.load_state_dict(gt_src.state_dict())
    want = infer.dense_captions(served, vg_vocab, photos, SEQ)
    regions = sum(len(v["regions"]) for v in want.values())
    out["gt_infer"] = {"images": len(got), "regions": regions,
                       "captions_identical": got == want,
                       "launches": launches}
    if got != want or launches["roi_align_batch_chw"] != INTERCHANGE_IMAGES:
        raise AssertionError(f"infer --model-type gt from the imported "
                             f"checkpoint: {out['gt_infer']}")
    Path(f["gt.ckpt"]).unlink()
    del served
    lap("3 infer GT")

    # 3b. dense_driver.setup: the GT model restored from a port checkpoint
    # written here, its forward on a training batch the source's bit for
    # bit (K1 once); the RPN and roi_only models of the default config
    arrays, info = make_train_data(np.random.RandomState(SEED + 2))
    loader = VGDataLoader(arrays=arrays, info=info)
    batch = dd.to_device(next(loader.padded_batches(0, TRAIN_BATCH,
                                                    N_REGIONS)), dev)
    ckptlib.save_checkpoint(f["gt_setup.ckpt"],
                            {"model": gt_src.state_dict()})
    restored, state = dd.setup(
        gt_cfg.replace(checkpoint_start_from=f["gt_setup.ckpt"]), VOCAB,
        SEQ, dev)
    restored.eval()

    @torch.no_grad()
    def forward(model):
        images, boxes, labels, _ = batch
        return model(normalize_images(images, dtype=model.compute_dtype),
                     boxes, labels)
    want_out = forward(gt_src)
    zero_roi_counts(roi)
    got_out = forward(restored)
    launches = roi_counts(roi)
    built = {}
    rpn_cfg = get_densecap_config()
    for name, cfg in (("rpn", rpn_cfg),
                      ("roi_only", rpn_cfg.replace(roi_only=True))):
        model, st = dd.setup(cfg, VOCAB, SEQ, dev)
        built[name] = {"family": type(model).__name__,
                       "with_captioning": model.with_captioning,
                       "state": st,
                       "params_m": sum(p.numel() for p in
                                       model.parameters()) / 1e6,
                       "device": str(next(model.parameters()).device)}
        del model
    out["setup"] = {
        "restored_family": type(restored).__name__,
        "restored_tensors": len(state["model"]),
        "forward_bitwise": bool(
            torch.equal(got_out.logits, want_out.logits)
            and torch.equal(got_out.region_codes, want_out.region_codes)),
        "logits_shape": list(got_out.logits.shape), "launches": launches,
        "built": built}
    if (not out["setup"]["forward_bitwise"]
            or launches["roi_align_batch_chw"] != 1
            or type(restored).__name__ != "GTDenseCaptioner"
            or built["rpn"] != {**built["rpn"], "family": "DenseCapRPN",
                                "with_captioning": True, "state": None}
            or built["roi_only"] != {**built["roi_only"],
                                     "family": "DenseCapRPN",
                                     "with_captioning": False,
                                     "state": None}):
        raise AssertionError(f"dense_driver.setup: {out['setup']}")
    Path(f["gt_setup.ckpt"]).unlink()
    del restored, state, want_out, got_out
    torch.cuda.empty_cache()
    lap("3b setup()")

    # 4. torchvision backbones: import, encoder_init, export
    lstm_cfg, vit_cfg = alexcap_cfg("lstm"), alexcap_cfg("vitb")
    lstm_src = weights.seeded_init_(build_model(lstm_cfg, ALEX_VOCAB,
                                                ALEX_SEQ, device=dev),
                                    SEED + 26)
    randomize_batchnorm_(lstm_src.features, SEED + 26)
    vit_src = weights.seeded_init_(build_model(vit_cfg, ALEX_VOCAB, ALEX_SEQ,
                                               device=dev), SEED + 26)
    resnet_names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                    "6": "layer3", "7": "layer4"}
    tv = {"vgg16": {**{k: v for k, v in sd.items()
                       if k.startswith(("features.", "classifier."))},
                    "classifier.6.weight": torch.randn(
                        TORCHVISION_CLASSES, 4096, generator=gen),
                    "classifier.6.bias": torch.zeros(TORCHVISION_CLASSES)},
          "resnet101": {"fc.weight": torch.randn(TORCHVISION_CLASSES, 2048,
                                                 generator=gen),
                        "fc.bias": torch.zeros(TORCHVISION_CLASSES)},
          "vit_b_16": {**cpu(vit_src.encoder_vit),
                       "heads.head.weight": torch.randn(
                           TORCHVISION_CLASSES, 768, generator=gen),
                       "heads.head.bias": torch.zeros(TORCHVISION_CLASSES)}}
    for k, v in cpu(lstm_src.features).items():
        head, _, tail = k.partition(".")
        tv["resnet101"][f"{resnet_names[head]}.{tail}"] = v
    for name, sd_ in tv.items():
        torch.save(sd_, f[f"{name}.pth"])
    lap("4 torchvision .pth files")
    archs = {"vgg16_features": "vgg16", "vgg16_classifier": "vgg16",
             "resnet101": "resnet101", "vit_b_16": "vit_b_16"}
    npz = {a: str(work / f"{a}.npz") for a in archs}
    for arch, src in archs.items():
        cc.main(["import", "--arch", arch, "--src", f[f"{src}.pth"],
                 "--dst", npz[arch]])
    lap("4 import --arch")
    gt_dst = weights.seeded_init_(dd.build_gt_model(gt_cfg, VOCAB, SEQ,
                                                    dev), SEED + 27)
    lstm_dst = weights.seeded_init_(build_model(lstm_cfg, ALEX_VOCAB,
                                                ALEX_SEQ, device=dev),
                                    SEED + 27)
    vit_dst = weights.seeded_init_(build_model(vit_cfg, ALEX_VOCAB, ALEX_SEQ,
                                               device=dev), SEED + 27)
    apply_encoder_init(gt_dst, f"features={npz['vgg16_features']},"
                               f"classifier={npz['vgg16_classifier']}",
                       "features")
    apply_encoder_init(lstm_dst, npz["resnet101"], "features")
    apply_encoder_init(vit_dst, npz["vit_b_16"], "encoder_vit")
    lap("4 encoder_init")
    check("encoder_init GT", state_differs(
        {**cpu(gt_dst.features, "features."),
         **cpu(gt_dst.classifier, "classifier.")},
        {k: v for k, v in tv["vgg16"].items()
         if not k.startswith("classifier.6.")}))
    check("encoder_init ResNet-101", state_differs(
        cpu(lstm_dst.features), cpu(lstm_src.features)))
    check("encoder_init ViT-B/16", state_differs(
        cpu(vit_dst.encoder_vit), cpu(vit_src.encoder_vit)))
    loaded = {"gt": len(gt_dst.features.state_dict())
              + len(gt_dst.classifier.state_dict()),
              "resnet101": len(lstm_dst.features.state_dict()),
              "vit_b_16": len(vit_dst.encoder_vit.state_dict())}
    del vit_dst, vit_src
    # what each architecture leaves out of its source file
    uncovered = {"vgg16_features": ("classifier.",),
                 "vgg16_classifier": ("features.", "classifier.6."),
                 "resnet101": ("fc.",), "vit_b_16": ("heads.",)}
    exported = {}
    for arch, src in archs.items():
        back = str(work / f"{arch}_exported.pth")
        cc.main(["export", "--arch", arch, "--src", npz[arch], "--dst", back])
        got_sd = torch.load(back, weights_only=True)
        check(f"export --arch {arch}", state_differs(
            got_sd, {k: v for k, v in tv[src].items()
                     if not k.startswith(uncovered[arch])}))
        exported[arch] = len(got_sd)
        Path(back).unlink()
        Path(npz[arch]).unlink()
    for name in tv:
        Path(f[f"{name}.pth"]).unlink()
    out["backbones"] = {"loaded_tensors": loaded, "exported_tensors":
                        exported, "bitwise": True}
    del tv, sd
    lap("4 checks and export --arch")

    # 5. a GT training step after encoder_init, on 3b's batch
    opt = dd.make_dense_optimizer(gt_cfg, gt_dst, len(loader.train_ix))
    gen_dev = torch.Generator(dev)
    gen_dev.manual_seed(SEED + 1)
    step = dd.make_gt_train_step(gt_dst, opt, gt_cfg.use_curriculum_learning,
                                 gen_dev)
    zero_roi_counts(roi)
    loss = float(step(*batch, 1.0))
    launches = roi_counts(roi)
    out["gt_train_step"] = {"loss": loss, "launches": launches}
    if (not np.isfinite(loss) or launches["roi_align_batch_chw"] != 1
            or launches["roi_align_bwd_features"] != 1):
        raise AssertionError(f"GT step after encoder_init: "
                             f"{out['gt_train_step']}")
    del gt_dst, opt, step, batch, gt_src
    lap("5 GT step")

    # 6. a reference LSTMModel checkpoint, imported and served
    torch.save(cpu(lstm_src), f["lstm_reference.pth"])
    lstm_meta = cc.main(["import-model", "--src", f["lstm_reference.pth"],
                         "--dst", f["lstm.ckpt"]])
    zero_roi_counts(roi)
    got = quiet(infer.main, ["--model-type", "lstm", "--ckpt", f["lstm.ckpt"],
                             "--dicts", f["face_dicts.json"],
                             "--images", photos, "--device", str(dev)])
    served = build_model(lstm_cfg.replace(param_dtype=lstm_cfg.compute_dtype),
                         ALEX_VOCAB, ALEX_SEQ, device=dev).eval()
    served.load_state_dict(lstm_src.state_dict())
    want = infer.alexcap_captions(served, face_vocab, photos, ALEX_SEQ)
    out["lstm_infer"] = {"meta": lstm_meta, "images": len(got),
                         "captions_identical": got == want,
                         "launches": roi_counts(roi)}
    if got != want or any(out["lstm_infer"]["launches"].values()):
        raise AssertionError(f"infer --model-type lstm from the imported "
                             f"checkpoint: {out['lstm_infer']}")
    del served, lstm_src, lstm_dst
    torch.cuda.empty_cache()
    lap("6 LSTM import-model and infer")

    # 7. the METEOR bridge's CLI
    out["meteor_bridge"] = meteor_bridge_cli(work, card)
    shutil.rmtree(work)
    lap("7 METEOR bridge")
    out["seconds"] = seconds
    print(f"checkpoint interchange: {json.dumps(out)}", flush=True)
    return out


# ------------- phase 27: data-parallel training across processes (ranks)

DP_WORLD = 2                  # ranks of the gloo world on the one card
DP_ALEX_BATCH = 12            # the AlexCap step's global batch (6 a rank)
DP_TIMEOUT = 900              # seconds for a child run
DP_KERNELS = ("roi_align_batch_chw", "roi_align_bwd_features",
              "roi_align_bwd_boxes")
DP_TRAINER_ARGS = ("max_iters=2", "save_checkpoint_every=2",
                   "losses_log_every=1")


def dp_rpn_inputs():
    """The RPN step's global batch: TRAIN_BATCH uint8 images of
    TRAIN_IMAGE², N_REGIONS GT boxes each (edge boxes included, one padded
    row), captions of 2..SEQ words."""
    rng = np.random.RandomState(SEED + 27)
    n, r, s = TRAIN_BATCH, N_REGIONS, TRAIN_IMAGE
    lengths = rng.randint(2, SEQ + 1, (n, r))
    labels = rng.randint(1, VOCAB + 1, (n, r, SEQ))
    labels[np.arange(SEQ)[None, None] >= lengths[..., None]] = 0
    mask = np.ones((n, r), np.float32)
    mask[1, -1] = 0.0
    return (torch.from_numpy(rng.randint(0, 256, (n, s, s, 3),
                                         dtype=np.uint8)),
            torch.from_numpy(edge_boxes(rng, n, r, s, s)),
            torch.from_numpy(labels), torch.from_numpy(mask))


def dp_step_result(model, state, grads, losses, launches) -> dict:
    """A step's outcome on the host: the weights before it (`state`) and
    after it, the gradient the update took, the losses and the ROI
    launches."""
    return {"state": state,
            "params": {n: p.detach().cpu() for n, p in
                       model.named_parameters()},
            "stats": {n: b.detach().cpu() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))},
            "grads": grads, "losses": losses, "launches": launches}


def dp_initial(model, state, init):
    """`model` with the weights `state` (a CPU state dict), or `init`
    applied when there are none → (model, its weights on the host)."""
    if state is None:
        init(model)
        state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
    else:
        model.load_state_dict(state)
    return model, state


def dp_rpn_step(dev, roi, dp, state=None) -> dict:
    """One RPN train step at full width in fp32 (phase 14's gate is an
    fp32 one) on `dp`'s rows of `dp_rpn_inputs`, dropout on and the
    sampler's keys from the trainer's generator (each rank draws the
    global batch's and keeps its rows), seed 0's weights with the box
    heads moved off zero (or `state`); every ROI launch of the step
    counted."""
    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    cfg = get_densecap_config().replace(
        batch_size=TRAIN_BATCH, max_regions=N_REGIONS,
        compute_dtype="float32", param_dtype="float32")
    model, state = dp_initial(
        dd.build_rpn_model(cfg, VOCAB, SEQ, dev), state,
        lambda m: move_box_heads_(seeded_init_(m, SEED), SEED + 9))
    opt = dd.make_dense_optimizer(cfg, model, 0)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().cpu().clone()
         for n, p in model.named_parameters() if p.grad is not None}))
    step = dd.make_rpn_train_step(model, opt, torch.Generator(
        dev).manual_seed(SEED), dp)
    images, boxes, labels, mask = (t[dp.rows(TRAIN_BATCH)].to(dev)
                                   for t in dp_rpn_inputs())
    zero_roi_counts(roi)
    losses = step(images, boxes, mask, labels)
    torch.cuda.synchronize()
    launches = roi_counts(roi)
    return dp_step_result(model, state, grads, {k: float(v) for k, v in
                                                losses.items()}, launches)


def dp_alexcap_trainer(dev, dp, state=None, accum: int = 1):
    """The AlexCap LSTM after the finetune boundary at full width
    (ResNet-101, BatchNorm on the global batch's statistics) in fp64, as
    phase 18 holds the ResNet families, dropout on, at grad_accum_steps
    `accum`, on `dp`'s rows of DP_ALEX_BATCH images a step → (config,
    model from seed 0's weights or `state`, those weights on the host,
    optimizer, the trainer's generator, the gradients each update took
    (filled by a hook), the train step)."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.step import make_train_step
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    dtype = torch.float64
    cfg = alexcap_cfg("lstm", compute_dtype="float32", use_dropout=True,
                      batch_size=DP_ALEX_BATCH, grad_accum_steps=accum)
    model, state = dp_initial(
        build_model(cfg, ALEX_VOCAB, ALEX_SEQ, device=dev), state,
        lambda m: seeded_init_(m, SEED))
    model.to(dtype)
    model.encoder.compute_dtype = dtype
    opt = optim.make_optimizer(cfg, model, 10)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().cpu().clone()
         for n, p in model.named_parameters() if p.grad is not None}))
    gen = torch.Generator(dev).manual_seed(SEED)
    step = make_train_step(
        model, opt, gen, lambda u8: resnet_v2_preprocess(u8, dtype=dtype),
        clip_norm=cfg.grad_clip_norm, dp=dp)
    return cfg, model, state, opt, gen, grads, step


def dp_alexcap_batch(seed: int):
    """DP_ALEX_BATCH uint8 CelebA-size images and their captions, from
    `seed`."""
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randint(0, 256, (DP_ALEX_BATCH, *ALEX_HW,
                                                   3), dtype=np.uint8))
    labels = torch.from_numpy(rng.randint(1, ALEX_VOCAB + 1,
                                          (DP_ALEX_BATCH, ALEX_SEQ)))
    labels[1::3, 9:] = 0
    return images, labels


def dp_alexcap_step(dev, roi, dp, state=None) -> dict:
    """One AlexCap LSTM step of `dp_alexcap_trainer` on `dp`'s rows of a
    batch from seed SEED + 28."""
    images, labels = dp_alexcap_batch(SEED + 28)
    _, model, state, _, _, grads, step = dp_alexcap_trainer(dev, dp, state)
    rows = dp.rows(DP_ALEX_BATCH)
    zero_roi_counts(roi)
    out = step(images[rows].to(dev), labels[rows].to(dev))
    torch.cuda.synchronize()
    return dp_step_result(model, state, grads,
                          {"total": float(out["loss"])}, roi_counts(roi))


# phase 27 (g): the AlexCap LSTM at grad_accum_steps DP_ACCUM in the gloo
# world; each micro-step's gradient norm within DP_NORM_REL of the one
# process's (the world-size gate of tests/test_torch_parallel.py)
DP_ACCUM = 2
DP_NORM_REL = 1e-5


def dp_alexcap_micro(step, dp, batch, dev) -> dict:
    """One micro-step of `dp_alexcap_trainer`'s step on `dp`'s rows of
    `batch` → its loss and gradient norm (the global batch's)."""
    images, labels = batch
    rows = dp.rows(DP_ALEX_BATCH)
    out = step(images[rows].to(dev), labels[rows].to(dev))
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"])}


def dp_alexcap_accum(dev, roi, mesh, out_dir: Path) -> dict:
    """Phase 27 (g), on every rank of the world: one window of DP_ACCUM
    micro-steps of `dp_alexcap_trainer` (batches from seeds SEED + 30 on),
    each micro-step's loss and gradient norm; after the first, rank 0
    writes the drivers' `train_state` with `save_checkpoint`, and the
    window goes on. Then every rank builds its model, optimizer and
    generator anew, loads that file and finishes the window: whether the
    losses, norms, weights, BatchNorm statistics, Adam's moments and the
    generator are bitwise the unbroken window's. The data axis's
    collectives in the window (`Axis.calls`), and those of the steps'
    gradient reductions; the ROI launches (none: no ROI kernel runs).
    Rank 0 then runs the window as one process from the same weights:
    each micro-step's norm against the world's, and the update by phase
    14's gate (`dp_agreement`). The caller sets cuDNN's deterministic
    algorithms: its default fp64 convolution backward is not bitwise
    repeatable."""
    import collections

    from imagecaptioning_tpu_torch.parallel import mesh as meshlib
    from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib

    batches = [dp_alexcap_batch(SEED + 30 + i) for i in range(DP_ACCUM)]
    # a reducer of its own, whose gradient reductions are counted
    dp = meshlib.DataParallel(mesh.data.index, mesh.data.size,
                              mesh.data.group, mesh.data.stage_on_host)
    grad_calls = collections.Counter()
    reduce_grads = dp.reduce_grads

    def counted(grads):
        before = collections.Counter(dp.calls)
        reduce_grads(grads)
        grad_calls.update(collections.Counter(dp.calls) - before)
    dp.reduce_grads = counted
    path = out_dir / "dp_accum.ckpt"
    zero_roi_counts(roi)
    cfg, model, state, opt, gen, grads, step = dp_alexcap_trainer(
        dev, dp, None, DP_ACCUM)
    micro = []
    for i, batch in enumerate(batches):
        if i == 1:                  # mid-window, as a driver's writes come
            ckptlib.save_checkpoint(str(path), ckptlib.train_state(
                model, opt, i, gen, 0))
            mesh.barrier()
        micro.append(dp_alexcap_micro(step, dp, batch, dev))
    torch.cuda.synchronize()
    res = {"micro_steps": micro, "calls_per_update": dict(dp.calls),
           "grad_calls_per_update": dict(grad_calls),
           "checkpoint_gb": path.stat().st_size / 1e9,
           "launches": roi_counts(roi)}
    world = dp_step_result(model, state, grads, {"total": micro[-1]["loss"]},
                           res["launches"])
    _, model2, _, opt2, gen2, _, step2 = dp_alexcap_trainer(
        dev, dp, state, DP_ACCUM)
    ckptlib.load_train_state(ckptlib.restore_checkpoint(
        str(path), torch.device("cpu")), model2, opt2, gen2)
    res["resumed"] = [dp_alexcap_micro(step2, dp, b, dev)
                      for b in batches[1:]]
    torch.cuda.synchronize()
    res["resumed_equal"] = {
        "micro_steps": res["resumed"] == micro[1:],
        "model": same_state(model.state_dict(), model2.state_dict()),
        "optimizer": same_state(opt.state_dict(), opt2.state_dict()),
        "generator": bool(torch.equal(gen.get_state(), gen2.get_state()))}
    res["resumed_bitwise"] = all(res["resumed_equal"].values())
    del model, opt, step, model2, opt2, step2
    mesh.barrier()
    if meshlib.is_writer():
        path.unlink()
    torch.cuda.empty_cache()
    if mesh.data.index == 0:
        _, model, _, _, _, grads, step = dp_alexcap_trainer(
            dev, meshlib.IDENTITY, state, DP_ACCUM)
        one_micro = [dp_alexcap_micro(step, meshlib.IDENTITY, b, dev)
                     for b in batches]
        torch.cuda.synchronize()
        one = dp_step_result(model, state, grads,
                             {"total": one_micro[-1]["loss"]}, {})
        res["one_process"] = one_micro
        res["grad_norm_rel_err"] = [
            abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
            for a, b in zip(micro, one_micro)]
        res["agreement"] = dp_agreement(world, one, cfg.learning_rate, True)
        del model, step
    return res


# the split steps (phase 27 (d)): the families `shard_params` splits, at
# the config's full width, fp32, the config's dropout on
DP_SPLIT_FAMILIES = ("vitb", "transformer")
# phase 14's gate, but for the share of weights more than 1e-7 apart: a
# first Adam step moves a weight whose gradient is within rounding of zero
# by up to lr either way, and a split sums its products in another order
# (a row split's halves, then their sum), so in fp32 more gradients round
# apart than under the data split. A weight's update can differ only where
# its gradient does, so the weights take the gradients' share, GRAD_SHARE_TOL
# (the first card run: 8.5e-5 of the ViT-B's weights, 6.0e-4 of the
# Transformer's, all within 2 lr)
SPLIT_PARAM_SHARE_TOL = GRAD_SHARE_TOL
# the dry run's dense steps keep the trunk frozen (the finetune boundary
# at 10 updates, as JAX's dry run sets it), so they launch K1 and B, not A
DRYRUN_KERNELS = ("roi_align_batch_chw", "roi_align_bwd_boxes")


def dp_split_step(dev, mesh, model_type: str, state=None) -> dict:
    """One train step of an AlexCap family at its config's full width
    (ViT-B: the ViT-B/16 encoder, frozen by `trained_encoder`, and the
    6-layer 768-wide decoder; Transformer: ResNet-101, frozen as before
    the finetune boundary, and the 6 + 6-layer head) in fp32 with its
    dropout on and a constant lr (the first step of the schedule's
    warm-up has lr 0), on DP_ALEX_BATCH uint8 CelebA-size images, from
    seed 0's weights or `state`; with `mesh`, its parameters split over
    the mesh's 'model' axis (`shard_params`) and the batch over 'data'.
    → the outcome on the host, the split parameters and gradients whole
    (`ModelAxis.full`, a collective on every rank)."""
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.parallel import mesh as meshlib
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.step import make_train_step
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    cfg = alexcap_cfg(model_type, compute_dtype="float32",
                      param_dtype="float32", use_scheduler=False,
                      batch_size=DP_ALEX_BATCH)
    rng = np.random.RandomState(SEED + 29)
    images = torch.from_numpy(rng.randint(0, 256, (DP_ALEX_BATCH, *ALEX_HW,
                                                   3), dtype=np.uint8))
    labels = torch.from_numpy(rng.randint(1, ALEX_VOCAB + 1,
                                          (DP_ALEX_BATCH, ALEX_SEQ)))
    labels[1::3, 9:] = 0
    model, state = dp_initial(
        build_model(cfg, ALEX_VOCAB, ALEX_SEQ, freeze_encoder=True,
                    device=dev), state, lambda m: seeded_init_(m, SEED))
    full, dp = (lambda t: t), meshlib.IDENTITY
    split = []
    if mesh is not None:
        meshlib.shard_params(model, mesh)
        split = [n for n, p in model.named_parameters()
                 if meshlib.is_split(p)]
        full, dp = mesh.model.full, mesh.data
    opt = optim.make_optimizer(cfg, model, 10)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: full(p.grad).detach().cpu().clone()
         for n, p in model.named_parameters() if p.grad is not None}))
    step = make_train_step(
        model, opt, torch.Generator(dev).manual_seed(SEED),
        lambda u8: resnet_v2_preprocess(u8, dtype=torch.float32),
        clip_norm=cfg.grad_clip_norm, dp=dp)
    rows = dp.rows(DP_ALEX_BATCH)
    out = step(images[rows].to(dev), labels[rows].to(dev))
    torch.cuda.synchronize()
    return {"state": state,
            "params": {n: full(p).detach().cpu() for n, p in
                       model.named_parameters()},
            "stats": {}, "grads": grads,
            "losses": {"total": float(out["loss"])}, "split": split,
            "devices": sorted({str(meshlib.local(p).device)
                               for p in model.parameters()}),
            "lr": cfg.learning_rate}


def dp_child(mode: str, argv) -> int:
    """A process that phase 27 starts: `--dp-rank OUT_DIR` is one rank of
    the gloo world on cuda:0 (torchrun's environment, set by
    `dp_training`): the RPN step, then the AlexCap step, each on its rows;
    rank 0 then runs each step again as one process (no collective) from
    the same weights and holds the world's outcome against it
    (`dp_agreement`); every rank writes its launches and losses.
    `--dp-trainer KEY=VALUE ...` runs the RPN trainer's entry point
    (`imagecaptioning_tpu_torch.train_DenseCap.main`) under torchrun and
    prints its ROI launches."""
    import os

    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.ops import roi_align as roi
    from imagecaptioning_tpu_torch.parallel import mesh as meshlib

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "--dp-trainer":
        from imagecaptioning_tpu_torch import train_DenseCap
        zero_roi_counts(roi)
        train_DenseCap.main(list(argv))
        print(f"DP_TRAINER_LAUNCHES {json.dumps(roi_counts(roi))}",
              flush=True)
        return 0
    out_dir = Path(argv[0])
    dev = meshlib.init_distributed(
        "cuda:0", backend="gloo",
        init_method=f"file://{out_dir.resolve() / 'dp_rendezvous'}")
    rank = int(os.environ["RANK"])
    steps = (("rpn", dp_rpn_step, get_densecap_config().learning_rate,
              False),
             ("alexcap", dp_alexcap_step, alexcap_cfg().learning_rate, True))
    try:
        mesh = meshlib.create_mesh((-1,), ("data",), dev)
        out = {"mesh": mesh.shape, "launches": {}, "losses": {},
               "seconds": {}}
        for name, fn, lr, bn in steps:
            t0 = time.perf_counter()
            world = fn(dev, roi, mesh.data)
            out["launches"][name] = world["launches"]
            out["losses"][name] = world["losses"]
            out["seconds"][name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            if rank == 0:
                t0 = time.perf_counter()
                one = fn(dev, roi, meshlib.IDENTITY, world["state"])
                out[name] = dp_agreement(world, one, lr, bn)
                out[name]["one_process_seconds"] = time.perf_counter() - t0
                del one
            del world
            torch.cuda.empty_cache()
        # (g) the AlexCap LSTM at grad_accum_steps DP_ACCUM; cuDNN's default
        # fp64 convolution backward does not repeat its last bits from one
        # run to the next, so the bitwise resume takes its deterministic
        # algorithms
        t0 = time.perf_counter()
        torch.backends.cudnn.deterministic = True
        try:
            out["alexcap_k2"] = dp_alexcap_accum(dev, roi, mesh, out_dir)
        finally:
            torch.backends.cudnn.deterministic = False
        out["seconds"]["alexcap_k2"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        # (d) the split: the same world as ('data', 'model') = (1, 2)
        split_mesh = meshlib.create_mesh((1, DP_WORLD), ("data", "model"),
                                         dev)
        out["split_mesh"] = split_mesh.shape
        for model_type in DP_SPLIT_FAMILIES:
            t0 = time.perf_counter()
            split_mesh.model.calls.clear()
            split_mesh.data.calls.clear()
            world = dp_split_step(dev, split_mesh, model_type)
            key = f"split_{model_type}"
            out["seconds"][key] = time.perf_counter() - t0
            out["losses"][key] = world["losses"]
            out[f"{key}_collectives"] = {
                "model": dict(split_mesh.model.calls),
                "data": dict(split_mesh.data.calls)}
            out[f"{key}_params"] = [len(world["split"]),
                                    len(world["params"])]
            out[f"{key}_devices"] = world["devices"]
            torch.cuda.empty_cache()
            if rank == 0:
                t0 = time.perf_counter()
                one = dp_split_step(dev, None, model_type, world["state"])
                out[key] = dp_agreement(world, one, world["lr"], False,
                                        SPLIT_PARAM_SHARE_TOL)
                out[key]["one_process_seconds"] = time.perf_counter() - t0
                del one
            del world
            torch.cuda.empty_cache()
        # (e) dryrun_multichip(2)'s steps in this world, split as (1, 2)
        from imagecaptioning_tpu_torch import dryrun
        t0 = time.perf_counter()
        zero_roi_counts(roi)
        out["dryrun"] = dryrun.rank_steps(DP_WORLD, dev)
        torch.cuda.synchronize()
        out["launches"]["dryrun"] = roi_counts(roi)
        out["seconds"]["dryrun"] = time.perf_counter() - t0
        (out_dir / f"dp_rank{rank}.json").write_text(json.dumps(out))
    finally:
        meshlib.shutdown()
    return 0


def dp_agreement(got: dict, want: dict, lr: float, bn: bool,
                 param_share: float = 1e-5) -> dict:
    """Phase 14's gate between two step outcomes (`dp_step_result`): each
    loss LOSS_REL_TOL relative; each gradient GRAD_REL_TOL relative in
    all but GRAD_SHARE_TOL of each tensor's elements (`grad_agreement`),
    the same tensors on both sides; every weight within 2·lr, at most
    `param_share` of them more than 1e-7 apart; with `bn`, the BatchNorm
    statistics within BN_TOL."""
    loss_rel = max(abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                   for k, v in want["losses"].items() if v != 0.0)
    agree = grad_agreement(got["grads"], want["grads"])
    worst, off, total = 0.0, 0, 0
    for name, w in want["params"].items():
        d = (got["params"][name].double() - w.double()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-7).sum())
        total += d.numel()
    stats = max((float((got["stats"][k].double() - v.double()).abs().max())
                 for k, v in want["stats"].items()), default=0.0)
    res = {"loss_rel_err": loss_rel,
           "losses": [got["losses"], want["losses"]],
           "grads_compared": len(agree),
           "grads_same_tensors": sorted(got["grads"]) == sorted(
               want["grads"]),
           "grad_rel_err_max": max(e for e, _ in agree.values()),
           "grad_share_over_tol_max": max(o for _, o in agree.values()),
           "param_max_abs_diff": worst, "params_over_1e-7_share":
           off / total, "bn_running_stats_max_abs_err": stats}
    res["ok"] = (loss_rel <= LOSS_REL_TOL and res["grads_same_tensors"]
                 and res["grad_share_over_tol_max"] <= GRAD_SHARE_TOL
                 and worst <= 2 * lr + 1e-7 and off / total <= param_share
                 and (not bn or stats <= BN_TOL))
    return res


def dp_training(dev, roi, out_dir: Path, card="") -> dict:
    """Phase 27: data-parallel training across processes.
    (a) the RPN trainer's entry point under `python -m
        torch.distributed.run --standalone --nproc_per_node=1` on NCCL at
        full width (the default DenseCap config, synthetic data), 2
        steps and its eval; its ROI launches;
    (b) a world of DP_WORLD processes under gloo on this one card: the
        RPN step at full width (TRAIN_BATCH × TRAIN_IMAGE² × N_REGIONS,
        TRAIN_BATCH / DP_WORLD images a rank, 128 + 128 sampled, dropout
        and the sampler on, fp32), held against the one-process step on
        this card by phase 14's gate (`dp_agreement`); K1, A and B once a
        rank;
    (c) in the same world, the AlexCap LSTM step after the finetune
        boundary at batch DP_ALEX_BATCH (6 a rank), BatchNorm over the
        global batch, fp64, held alike and on its statistics;
    (d) the same world as ('data', 'model') = (1, DP_WORLD): each of
        DP_SPLIT_FAMILIES at full width split over 'model'
        (`dp_split_step`), held alike against its unsplit step; each
        rank's collectives by axis, and whether they went through the
        host;
    (e) `dryrun.rank_steps(DP_WORLD)` in the same world: its two lines
        and both ranks' ROI launches;
    (f) the dry run's default route at n = DP_WORLD (`dryrun.route`):
        gloo with the ranks sharing this machine's cards where there are
        fewer than DP_WORLD, NCCL with a card a rank otherwise; printed
        and asserted, nothing started;
    (g) in the world of (b), after (c), the AlexCap LSTM of (c) at
        grad_accum_steps DP_ACCUM, one window (`dp_alexcap_accum`): each
        micro-step's gradient norm within DP_NORM_REL of the one
        process's and the update by phase 14's gate; a checkpoint that
        rank 0 writes after the first micro-step, resumed by every rank
        into a model and optimizer built anew, finishing the window
        bitwise as the unbroken world did; DP_ACCUM gradient all-reduces
        (`Axis.calls` of the steps' `reduce_grads`) an applied update,
        printed on a line of their own; no ROI launch.
    Rank 0 runs each one-process step after the world's, from the same
    weights; it draws the same dropout masks and sampler keys (the ranks
    draw the global batch's and keep their rows)."""
    import os
    import shutil

    from imagecaptioning_tpu_torch import dryrun

    res = {"card": card}
    devices, backend, line = dryrun.route(DP_WORLD)
    count = torch.cuda.device_count()
    res["dryrun_default_route"] = {"cards": count, "devices": devices,
                                   "backend": backend, "line": line}
    print(f"dryrun_multichip({DP_WORLD}) default {line} [{card}]",
          flush=True)
    route_ok = (devices == [f"cuda:{r % count}" for r in range(DP_WORLD)]
                and backend == ("nccl" if count >= DP_WORLD else "gloo"))
    t0 = time.perf_counter()
    run_dir = out_dir / "dp_torchrun"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    for f in ("dp_rendezvous", *(f"dp_rank{r}.json"
                                 for r in range(DP_WORLD))):
        (out_dir / f).unlink(missing_ok=True)
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")])}
    # (a) and the world of (b), (c) side by side: their seconds are mostly
    # the processes' start-up and model set-up, and neither is a speed
    # each child's output to a file: a pipe nobody reads yet could fill
    logs = [run_dir / f"{name}.log" for name in
            ("trainer", "trainer_err", *(f"rank{r}" for r in
                                         range(DP_WORLD)))]
    files = [open(f, "w") for f in logs]
    trainer = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", str(root / "chip_smoke.py"), "--dp-trainer",
         *DP_TRAINER_ARGS], cwd=run_dir, env=env, stdout=files[0],
        stderr=files[1])
    procs = [subprocess.Popen(
        [sys.executable, str(root / "chip_smoke.py"), "--dp-rank",
         str(out_dir)], env={**env, "RANK": str(r),
                             "WORLD_SIZE": str(DP_WORLD),
                             "LOCAL_RANK": str(r)},
        stdout=files[2 + r], stderr=subprocess.STDOUT)
        for r in range(DP_WORLD)]
    deadline = time.monotonic() + DP_TIMEOUT
    while any(p.poll() is None for p in procs):
        if (any(p.poll() not in (None, 0) for p in procs)
                or time.monotonic() > deadline):
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    res["world_seconds"] = time.perf_counter() - t0
    try:
        trainer.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        trainer.kill()
        trainer.wait()
    for f in files:
        f.close()
    out, err, *rank_logs = (f.read_text() for f in logs)
    shutil.rmtree(run_dir, ignore_errors=True)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("data-parallel ranks failed: "
                             + " | ".join(log[-3000:] for log in rank_logs))
    lines = out.splitlines()
    found = [ln for ln in lines if ln.startswith("DP_TRAINER_LAUNCHES ")]
    if trainer.returncode != 0 or not found:
        raise AssertionError(f"torchrun train_DenseCap failed "
                             f"({trainer.returncode}): {err[-3000:]}")
    res["torchrun_nccl_world1"] = {
        "seconds": time.perf_counter() - t0,
        "log": [ln for ln in lines if ln.startswith(("iter ", "eval@"))],
        "launches": json.loads(found[-1].split(" ", 1)[1])}
    ranks = [json.loads((out_dir / f"dp_rank{r}.json").read_text())
             for r in range(DP_WORLD)]
    res["mesh"] = ranks[0]["mesh"]
    res["rank_launches"] = [r["launches"] for r in ranks]
    res["rank_seconds"] = [r["seconds"] for r in ranks]
    for name in ("rpn", "alexcap"):
        res[name] = ranks[0][name]
        res[name]["rank_losses"] = [r["losses"][name] for r in ranks]
    accum = [r["alexcap_k2"] for r in ranks]
    res["alexcap_k2"] = {
        **accum[0], "rank_resumed_bitwise": [a["resumed_bitwise"]
                                             for a in accum],
        "rank_grad_calls_per_update": [a["grad_calls_per_update"]
                                       for a in accum]}
    print(f"data-parallel accumulation (world {DP_WORLD}, gloo on one card; "
          f"AlexCap LSTM, fp64, grad_accum_steps {DP_ACCUM}): Axis.calls "
          f"per applied update {json.dumps(accum[0]['calls_per_update'])}, "
          f"of them in the gradient reductions "
          f"{json.dumps(accum[0]['grad_calls_per_update'])}; each "
          f"micro-step's grad_norm relative to one process "
          f"{res['alexcap_k2']['grad_norm_rel_err']}; mid-window resume "
          f"bitwise on every rank {res['alexcap_k2']['rank_resumed_bitwise']}"
          f" [{card}]", flush=True)
    accum_ok = (
        all(a["resumed_bitwise"] for a in accum)
        and all(sum(a["grad_calls_per_update"].values()) == DP_ACCUM
                for a in accum)
        and res["alexcap_k2"]["agreement"]["ok"]
        and all(np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
                for m in accum[0]["micro_steps"])
        and max(res["alexcap_k2"]["grad_norm_rel_err"]) <= DP_NORM_REL)
    res["split_mesh"] = ranks[0]["split_mesh"]
    for model_type in DP_SPLIT_FAMILIES:
        key = f"split_{model_type}"
        res[key] = ranks[0][key]
        res[key]["rank_losses"] = [r["losses"][key] for r in ranks]
        res[key]["split_params_of_all"] = ranks[0][f"{key}_params"]
        res[key]["rank_devices"] = [r[f"{key}_devices"] for r in ranks]
        res[key]["rank_collectives"] = [r[f"{key}_collectives"]
                                        for r in ranks]
    calls = [c for model_type in DP_SPLIT_FAMILIES
             for c in res[f"split_{model_type}"]["rank_collectives"]]
    res["collectives_staged_through_host"] = any(
        "(host)" in name for c in calls for axis in c.values()
        for name in axis)
    res["dryrun"] = ranks[0]["dryrun"]
    res["dryrun_launches"] = {k: sum(r["launches"]["dryrun"][k]
                                     for r in ranks) for k in ROI_WRAPPERS}
    once = {k: 1 for k in DP_KERNELS}
    res["roi_once_a_rank"] = all(
        {k: r["launches"]["rpn"][k] for k in DP_KERNELS} == once
        for r in ranks)
    res["launches"] = {k: sum(r["launches"]["rpn"][k]
                              + r["launches"]["alexcap"][k]
                              + r["alexcap_k2"]["launches"][k] for r in ranks)
                       for k in ROI_WRAPPERS}
    res["tolerance"] = (f"phase 14's: each loss {LOSS_REL_TOL} relative; "
                        f"each gradient {GRAD_REL_TOL} relative in all but "
                        f"{GRAD_SHARE_TOL} of each tensor's elements; "
                        f"params within 2 lr, at most 1e-5 of them more "
                        f"than 1e-7 apart ({SPLIT_PARAM_SHARE_TOL} for the "
                        f"split steps); BatchNorm statistics {BN_TOL}")
    print(f"data-parallel training and the tensor split (world "
          f"{DP_WORLD}, gloo on one card; torchrun NCCL world 1): "
          f"{json.dumps(res)}", flush=True)
    a = res["torchrun_nccl_world1"]["launches"]
    split_ok = all(
        res[f"split_{m}"]["ok"] and 0 < res[f"split_{m}"][
            "split_params_of_all"][0]
        and all(d == ["cuda:0"] for d in res[f"split_{m}"]["rank_devices"])
        for m in DP_SPLIT_FAMILIES)
    dry = res["dryrun"]
    dry_ok = (len(dry) == 2 and dry[-1].startswith(
        f"dryrun_multichip({DP_WORLD}): mesh={{'data': 1, 'model': "
        f"{DP_WORLD}}} vitb_loss=") and dry[-1].endswith(" OK")
        and all(int(w.split("=")[1].split("/")[0]) > 0
                for w in dry[0].split()[-3:])
        and all(res["dryrun_launches"][k] > 0 for k in DRYRUN_KERNELS))
    if not (res["rpn"]["ok"] and res["alexcap"]["ok"] and accum_ok
            and res["roi_once_a_rank"] and res["mesh"] == {"data": DP_WORLD}
            and all(a[k] > 0 for k in DP_KERNELS) and split_ok and dry_ok
            and route_ok
            and res["split_mesh"] == {"data": 1, "model": DP_WORLD}):
        raise AssertionError(f"data-parallel training failed: {res}")
    return res


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] in ("--dp-rank", "--dp-trainer"):
        return dp_child(sys.argv[1], sys.argv[2:])
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
    # seconds from the end of one group of phases to the end of the next
    laps, t_lap = {}, [t_start]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
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
    lap("1 build")

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
    add_cupti(slice_roi, slice_calls, CUPTI_CALLS, flush)
    add_cupti(canvas_roi, canvas_calls, CUPTI_CALLS, flush)
    prof = profile(run_beam, run_greedy, args.out_dir, card=smi,
                   served=served)
    ref = reference_check(dev, model, build, api, card=smi)
    del model, run_beam, run_greedy
    lap("2-6 ROI forward, GT LSTM-head serving")

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
    lap("10 GT transformer-head serving")

    train_bwd, train_bwd_calls = check_roi_backward(
        dev, roi, TRAIN_BATCH, N_REGIONS, TRAIN_IMAGE // 32, 512,
        TRAIN_IMAGE, 200, flush)
    serve_bwd, serve_bwd_calls = check_roi_backward(
        dev, roi, N_IMAGES, N_REGIONS, IMAGE // 32, 512, IMAGE, 200, flush)
    add_cupti(train_bwd, train_bwd_calls, CUPTI_CALLS, flush)
    add_cupti(serve_bwd, serve_bwd_calls, CUPTI_CALLS, flush)
    # outputs beyond the staged kernels' 32 a side and 256 cells: the
    # general kernels, at the GT training shape
    general_bwd = {}
    for out_hw in GENERAL_BWD_SHAPES:
        cases, _ = check_roi_backward(
            dev, roi, TRAIN_BATCH, N_REGIONS, TRAIN_IMAGE // 32, 512,
            TRAIN_IMAGE, 20, flush, out_hw)
        general_bwd.update({f"{case} {out_hw[0]}x{out_hw[1]}": v
                            for case, v in cases.items()})
    lap("7 ROI backward")
    trained = train(dev, roi, args.out_dir, card=smi)
    step_check = train_step_check(dev, card=smi)
    # phase 11: the transformer head's training
    t_trained = train(dev, roi, args.out_dir, kind="transformer",
                      label="transformer training", card=smi,
                      table="chip_smoke_transformer_train_profile.txt")
    t_step_check = train_step_check(
        dev, kind="transformer", card=smi,
        label="transformer train step (fp32 card vs CPU, full width)")
    lap("8-9, 11 GT training")

    # phases 12-15: the RPN model (get_densecap_config: 128 + 128 sampled
    # boxes, 300 test proposals)
    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    rpn_cfg = get_densecap_config()

    def build_rpn(d, dtype):
        """The serving model: weights stored in the compute dtype."""
        name = {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dtype]
        cfg = rpn_cfg.replace(compute_dtype=name, param_dtype=name)
        return dd.build_rpn_model(cfg, VOCAB, SEQ, d).eval()
    rpn_model = weights.seeded_init_(dd.build_rpn_model(rpn_cfg, VOCAB, SEQ,
                                                        dev), SEED)
    rpn_feats, rpn_boxes, rpn_sample = sampled_rpn_boxes(dev, rpn_model,
                                                         normalize_images)
    del rpn_model
    rpn_roi = check_rpn_roi(dev, roi, rpn_feats, rpn_boxes, rpn_sample, 200,
                            flush, card=smi)
    del rpn_feats, rpn_boxes, rpn_sample
    rpn_trained = train(dev, roi, args.out_dir, kind="rpn",
                        label="RPN training", card=smi,
                        table="chip_smoke_rpn_train_profile.txt")
    rpn_step_check = train_step_check(
        dev, kind="rpn", card=smi,
        label="RPN train step (fp32 card vs CPU, full width)")
    rpn_served = serve_rpn(dev, build_rpn, normalize_images, roi,
                           args.out_dir, card=smi)
    rpn_ref = rpn_reference_check(dev, build_rpn, card=smi)
    lap("12-15 RPN")

    # phases 16-18: the AlexCap LSTM captioner (ResNet-101, get_lstm_config)
    alex_served, alex_model = alexcap_serve(dev, roi, args.out_dir, card=smi)
    alex_ref = alexcap_reference_check(dev, alex_model, card=smi)
    del alex_model
    alex_trained = alexcap_train(dev, roi, args.out_dir, card=smi)
    alex_step = alexcap_step_check(dev, card=smi)
    lap("16-18 AlexCap LSTM")
    alexcap_paths = {"alexcap_serving": alex_served["roi_launches"],
                     "alexcap_training": alex_trained["finetune"][
                         "roi_launches"]}
    # phases 19-21: the other three AlexCap families
    families = {}
    for model_type in ("lstm_attention", "transformer", "vitb"):
        fam_served, fam_model = alexcap_serve(dev, roi, args.out_dir,
                                              card=smi, model_type=model_type)
        fam_ref = alexcap_reference_check(dev, fam_model, card=smi,
                                          model_type=model_type)
        del fam_model
        fam_trained = alexcap_train(dev, roi, args.out_dir, card=smi,
                                    model_type=model_type)
        families[model_type] = {
            "serving": fam_served, "reference_check": fam_ref,
            "training": fam_trained,
            "train_step_check": family_step_check(dev, model_type, smi)}
        alexcap_paths[f"alexcap_{model_type}_serving"] = fam_served[
            "roi_launches"]
        alexcap_paths[f"alexcap_{model_type}_training"] = fam_trained[
            "finetune"]["roi_launches"]
        torch.cuda.empty_cache()
        lap(f"{19 + len(families) - 1} AlexCap {model_type}")

    # phases 22-23: gradient accumulation, k = ACCUM
    rpn_accum = rpn_accum_train(dev, roi, args.out_dir, card=smi)
    rpn_accum["update_check"] = train_step_check(
        dev, kind="rpn", card=smi, accum=ACCUM,
        label=f"RPN accumulated update (fp32 card vs CPU, k={ACCUM}, full "
              f"width)")
    lap("22 RPN, grad_accum_steps 2")
    alex_accum = alexcap_accum_train(dev, roi, args.out_dir, card=smi)
    alex_accum["update_check"] = alexcap_accum_step_check(dev, card=smi)
    alexcap_paths["alexcap_training_k2"] = alex_accum["roi_launches"]
    torch.cuda.empty_cache()
    lap("23 AlexCap LSTM, grad_accum_steps 2")

    # phase 24: the trainers' own evals; phase 25: evidence_run
    evals = trainer_evals(dev, roi, args.out_dir, card=smi)
    lap("24 trainers' evals")
    evidence = evidence_runs(dev, roi, args.out_dir, card=smi)
    lap("25 evidence_run")
    # phase 26: convert_checkpoint, encoder_init and infer
    interchange = checkpoint_interchange(dev, roi, args.out_dir, card=smi)
    lap("26 checkpoint interchange")
    # phase 27: data-parallel training across processes
    dp = dp_training(dev, roi, args.out_dir, card=smi)
    lap("27 data-parallel training")
    eval_paths = {
        "gt_trainer_with_evals": evals["gt"]["launches"],
        "gt_trainer_evals": {n: sum(e["roi_launches"][n]
                                    for e in evals["gt"]["evals"])
                             for n in ROI_WRAPPERS},
        "rpn_trainer_with_evals": evals["rpn"]["launches"],
        "rpn_trainer_evals": {n: sum(e["roi_launches"][n]
                                     for e in evals["rpn"]["evals"])
                              for n in ROI_WRAPPERS},
        "evidence_gt": evidence["gt"]["launches"],
        "evidence_rpn": evidence["rpn"]["launches"],
        "interchange_gt_infer": interchange["gt_infer"]["launches"],
        "interchange_setup_restore": interchange["setup"]["launches"],
        "interchange_gt_step_after_encoder_init": interchange[
            "gt_train_step"]["launches"],
        # phase 27: both ranks' steps of the gloo world, and the torchrun
        # trainer's run with its eval
        "dp": dp["launches"],
        "dp_dryrun_multichip": dp["dryrun_launches"],
        "dp_torchrun_train_DenseCap": dp["torchrun_nccl_world1"][
            "launches"]}
    alexcap_paths["alexcap_trainer_with_evals"] = evals["alexcap"]["launches"]
    alexcap_paths["evidence_lstm_attention"] = evidence[
        "alexcap_evidence"]["launches"]
    alexcap_paths["interchange_lstm_infer"] = interchange["lstm_infer"][
        "launches"]
    # the evals' launches are inside the trainers' runs
    new_paths = {k: v for k, v in eval_paths.items()
                 if not k.endswith("_evals")}

    # the serving path's kernel: the fused entry, bf16 map → bf16 codes
    main_case = slice_roi["roi_align_batch_chw bf16->bf16 CHW"]
    # launches over every path that runs the kernel: both GT heads'
    # serving and training, the RPN's training and serving
    serving = {"lstm": served["launches"], "transformer": t_served["launches"]}
    training = {"lstm": trained["launches"],
                "transformer": t_trained["launches"]}
    rpn_paths = {"rpn_training": rpn_trained["launches"],
                 "rpn_serving": rpn_served["launches"],
                 "rpn_training_k2": rpn_accum["launches"]}
    kernel = {
        "name": "roi_align_batch_chw", "route": "cuda",
        "source": "imagecaptioning_tpu_torch/csrc/roi_align.cu",
        "replaces": "imagecaptioning_tpu/ops/roi_align.py:204",
        "launches": sum(v["roi_align_batch_chw"]
                        for path in (serving, training)
                        for v in path.values())
        + sum(v["roi_align_batch_chw"] for v in rpn_paths.values())
        + sum(v["roi_align_batch_chw"] for v in new_paths.values()),
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
        "launches_by_path": {"serving": serving, "training": training,
                             **rpn_paths,
                             **{k: v["roi_align_batch_chw"]
                                for k, v in eval_paths.items()},
                             **{k: v["roi_align_batch_chw"]
                                for k, v in alexcap_paths.items()}},
        "launches_per_applied_update_k2": rpn_accum[
            "launches_per_applied_update"]["roi_align_batch_chw"],
        "rpn_shape": rpn_roi["roi_align_batch_chw"],
        "entries": {"serving_shape": slice_roi, "n1_canvas": canvas_roi},
    }
    backward = []
    for name in ("roi_align_bwd_features", "roi_align_bwd_boxes"):
        # the main path's case: bf16 map, bf16 CHW gradient from fc6, at the
        # GT training shape for kernel A, at the RPN's (its only main path)
        # for kernel B
        main_bwd = (rpn_roi[name] if name == "roi_align_bwd_boxes" else
                    train_bwd[f"{name} bf16 map, bf16 CHW grad"])
        backward.append({
            "name": name, "route": "cuda",
            "source": "imagecaptioning_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "imagecaptioning_tpu/ops/roi_align.py:234-242",
            "launches": sum(v[name] for v in training.values())
            + rpn_trained["launches"][name] + rpn_accum["launches"][name]
            + sum(v[name] for v in new_paths.values()),
            "launches_by_path": {"training": {k: v[name] for k, v in
                                              training.items()},
                                 "rpn_training": rpn_trained["launches"][
                                     name],
                                 "rpn_training_k2": rpn_accum["launches"][
                                     name],
                                 **{k: v[name]
                                    for k, v in eval_paths.items()},
                                 **{k: v[name]
                                    for k, v in alexcap_paths.items()}},
            "main_path": ("GT training with either head and RPN training, "
                          "once a step" if name == "roi_align_bwd_features"
                          else "RPN training, once a step (the sampled "
                          "proposals' gradient; GT boxes are data)")
            + "; k per applied update at grad_accum_steps k; in the "
              "trainers with their evals and evidence_run; in a GT step "
              "after encoder_init from converted torchvision weights; "
              "once a rank a step in data-parallel RPN training (dp)",
            "launches_per_applied_update_k2": rpn_accum[
                "launches_per_applied_update"][name],
            "max_abs_err": max(rpn_roi[name]["max_abs_err"],
                               *(v["max_abs_err"] for k, v in
                                 {**train_bwd, **serve_bwd,
                                  **general_bwd}.items()
                                 if k.startswith(name + " "))),
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
                "rpn_shape": rpn_roi[name],
                "training_shape": {k: v for k, v in train_bwd.items()
                                   if k.startswith(name + " ")},
                "serving_shape": {k: v for k, v in serve_bwd.items()
                                  if k.startswith(name + " ")},
                "general_kernel_shapes": {k: v for k, v in
                                          general_bwd.items()
                                          if k.startswith(name + " ")}},
        })
    summary = {"card": smi, "serving": served, "profile": prof,
               "reference_check": ref, "training": trained,
               "train_step_check": step_check,
               "transformer": {"serving": t_served, "profile": t_prof,
                               "reference_check": t_ref,
                               "training": t_trained,
                               "train_step_check": t_step_check},
               "rpn": {"roi_kernels": rpn_roi, "training": rpn_trained,
                       "train_step_check": rpn_step_check,
                       "serving": rpn_served, "reference_check": rpn_ref},
               "alexcap": {"serving": alex_served,
                           "reference_check": alex_ref,
                           "training": alex_trained,
                           "train_step_check": alex_step, **families},
               "grad_accum_k2": {"rpn": rpn_accum, "alexcap": alex_accum},
               "trainer_evals": evals, "evidence_run": evidence,
               "checkpoint_interchange": interchange,
               "data_parallel": dp,
               "seconds": time.perf_counter() - t_start,
               "phase_seconds": laps}
    print(f"summary: {json.dumps(summary)}")
    print(smi)
    print(json.dumps({"kernels": [kernel, *backward]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
