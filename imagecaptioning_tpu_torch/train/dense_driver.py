"""Dense-caption training — port of `imagecaptioning_tpu/train/
dense_driver.py`: the GT-box model (`train_gt`, :44-375) and the full RPN
model (`train_rpn`, :151-172, 375-619).

`train_gt` reproduces the `traingt.py` loop: hard `max_iter` / `pad`,
optional curriculum `teacher_prob = 40000/(40000+exp(iter/40000))`
(`traingt.py:72-73`), Adam with additive weight decay, the CNN's
conv1_*/conv2_* frozen for good and the rest of the trunk trained from
`finetune_start_step` on (`traingt.py:58-64,87-88`), eval by the GT mAP
protocol with the best checkpoint kept on val mAP (`traingt.py:95-109`),
loss/result history JSONs in the reference schema, resume from the
newest full-state checkpoint and a preemption checkpoint on SIGTERM.

`train_rpn` is the JAX package's repaired `DenseCap/train.py` loop (the
committed reference unpacks 5 values from a 4-tuple, `train.py:49`):
the RPN model's 5-loss dict each step, the same optimizer groups,
`eval_split_rpn` (the DenseCap mAP protocol over `forward_test` and
greedy captions, with proposal recall and an anchor-assignment
diagnostic) at every checkpoint, the same histories, resume and
preemption.

A step normalizes the uint8 images on the device, runs the model in
training mode (VGG16 and the classifier in bf16 over fp32 master
weights, the ROI kernel forward and its backward kernels, the heads in
fp32), backpropagates and takes one optimizer update. Dropout masks and
the RPN sampler's keys come from the trainer's generator. Runs on the
first CUDA card unless the caller passes `device="cpu"`.

Data-parallel, as the JAX drivers shard their steps over
`mesh_for_batch(batch_size, mesh_shape, mesh_axis_names)`: under torchrun
each data rank takes its rows of every batch (the same batch order on
every rank) and runs the step under `parallel.mesh.active`, so the ROI
kernels run on its own images, the losses are its parts of the global
means, the draws are its rows of the global batch's, and each step sums
its gradients over the ranks after the backward, before the optimizer
folds them into its window (JAX's order: `MultiSteps` sees the global
batch's gradient); the step returns the global losses. Rank 0 alone
evaluates (over the whole split) and writes the histories, TensorBoard
and checkpoints while the others wait at a barrier; every rank resumes
from the same checkpoint, mid-window too, since every rank holds the
same window.

The knobs, as in the JAX drivers: `grad_accum_steps` = k makes each step
a micro-step and updates once per k (optax's `MultiSteps`: the mean of
the k gradients through the group-wise clip and Adam), the encoder's lr
boundary counted in applied updates, `-(-finetune_start // k)`;
`encoder_init` merges converted VGG weights (`features` and `classifier`
of the GT model, `conv_trunk` of the RPN model by default) into the
seeded init; `tensorboard_dir` writes the losses and val scores as
TensorBoard scalars; `debug_nans` runs the loop in autograd's anomaly
mode; `synthetic_learnable` trains on region captions that describe the
rendered boxes.
"""

from __future__ import annotations

import os
from contextlib import ExitStack, closing
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch.config.dense_configs import (DenseConfig,
                                                            RegionLMConfig,
                                                            name_gt_model)
from imagecaptioning_tpu_torch.data import synthetic
from imagecaptioning_tpu_torch.data.vg_loader import (VGDataLoader,
                                                      normalize_images)
from imagecaptioning_tpu_torch.eval import dense_eval
from imagecaptioning_tpu_torch.models import moe_lm
from imagecaptioning_tpu_torch.models.densecap import (DenseCapRPN,
                                                       GTDenseCaptioner,
                                                       GTRegionLMCaptioner)
from imagecaptioning_tpu_torch.ops import boxes as boxlib
from imagecaptioning_tpu_torch.ops.box_sampler import candidate_masks
from imagecaptioning_tpu_torch.parallel import mesh as meshlib
from imagecaptioning_tpu_torch.train.optim import (Accumulating,
                                                   applied_updates)
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils import pretrained, profiling
from imagecaptioning_tpu_torch.utils.io import LossHistory, ResultsHistory
from imagecaptioning_tpu_torch.utils.platform import resolve_device
from imagecaptioning_tpu_torch.utils.profiling import count, span
from imagecaptioning_tpu_torch.utils.tb import TBWriter
from imagecaptioning_tpu_torch.utils.weights import seeded_init_

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the loop's steps (counted from its start, the first three left out as
# warm-up) that `profile_dir` traces: [3, 13)
PROFILED_STEPS = (3, 13)
# the VGG trunk's module name in the GT model and in the RPN model
TRUNKS = ("features", "conv_trunk")
# torchvision vgg16.features indices of conv1_* and conv2_* (with their
# ReLUs and pools): frozen for good when the CNN is finetuned
FROZEN_FEATURES = 10


def make_vg_loader(cfg: DenseConfig, synthetic_fallback: bool = True,
                   synthetic_images: int = 8, image_size: int = 64,
                   synthetic_seq_length: int = 8,
                   synthetic_learnable: bool = False) -> VGDataLoader:
    """The VG HDF5 named by the config, else seeded synthetic arrays of
    `synthetic_seq_length` tokens: random-word captions, or with
    `synthetic_learnable` region captions that describe the rendered box
    (colour, size, half)."""
    if os.path.exists(cfg.data_h5) and os.path.exists(cfg.data_json):
        return VGDataLoader(data_h5=cfg.data_h5, data_json=cfg.data_json)
    if not synthetic_fallback:
        raise FileNotFoundError(cfg.data_h5)
    make = (synthetic.make_learnable_vg_arrays if synthetic_learnable
            else synthetic.make_vg_arrays)
    arrays, info = make(num_images=synthetic_images, image_size=image_size,
                        seq_length=synthetic_seq_length, seed=cfg.seed)
    return VGDataLoader(arrays=arrays, info=info)


def teacher_prob_schedule(it) -> float:
    """Curriculum schedule 40000/(40000+exp(iter/40000)) in fp32
    (`traingt.py:72`)."""
    k = np.float32(40000.0)
    return float(k / (k + np.exp(np.float32(it) / k)))


class DenseAdam(Accumulating, torch.optim.Adam):
    """torch Adam — whose `weight_decay` is the additive L2 on the gradient
    before the moments, as optax's `add_decayed_weights` before
    `scale_by_adam` (`traingt.py:62`), not AdamW — accumulating as
    optax's `MultiSteps` (`Accumulating`), with two per-group keys of the
    dense drivers, kept in the optimizer's state dict:

    - `start_step`: the group's lr is `base_lr` from that applied update
      on and 0 before it, while its moments accumulate from the first
      update (optax's schedule inside the group's chain);
    - `clip_norm` > 0: the group's gradients are scaled to that global
      norm where theirs is larger, before the weight decay (optax's
      `clip_by_global_norm` inside each group).
    """

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            grads = [p.grad for p in group["params"] if p.grad is not None]
            if group.get("clip_norm", 0.0) > 0 and grads:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g.float()) for g in grads]))
                clip = group["clip_norm"]
                for g in grads:
                    g.copy_(torch.where(norm < clip, g, g / norm * clip))
            if "start_step" in group:
                state = self.state.get(group["params"][0], {})
                done = int(state["step"]) if "step" in state else 0
                group["lr"] = (group["base_lr"] if done >= group["start_step"]
                               else 0.0)
        return super().step(closure)


def make_dense_optimizer(cfg: DenseConfig, model: torch.nn.Module,
                         finetune_start_step: int) -> DenseAdam:
    """Adam over three groups of `model`'s parameters, as the JAX
    package's `multi_transform` over `_vgg_label_fn`:
    - frozen: conv1_*/conv2_* of the trunk (`features.0-9` of the GT
      model, `conv_trunk.0-9` of the RPN model), and the whole trunk when
      `finetune_cnn` is off. Their `requires_grad` is cleared, which
      leaves them where optax's `set_to_zero` does and spares their
      gradients; they are in no group.
    - encoder: the rest of the trunk, lr 0 before `finetune_start_step`
      (in applied updates) and `learning_rate` from it on; its moments
      accumulate from the first update.
    - head: everything else, at `learning_rate`.
    `grad_clip_norm` > 0 clips each group on its own. `grad_accum_steps`
    micro-steps make one update, over the mean of their gradients."""
    encoder, head = [], []
    for name, p in model.named_parameters():
        top, idx = name.split(".")[:2]
        if top in TRUNKS:
            if cfg.finetune_cnn and int(idx) >= FROZEN_FEATURES:
                encoder.append((name, p))
            else:
                p.requires_grad_(False)
        else:
            head.append((name, p))

    def group(name, named, **extra):
        return {"group": name, "names": [n for n, _ in named],
                "params": [p for _, p in named],
                "clip_norm": cfg.grad_clip_norm, **extra}
    groups = [group("head", head)]
    if encoder:
        groups.append(group("encoder", encoder, lr=0.0,
                            base_lr=cfg.learning_rate,
                            start_step=finetune_start_step))
    return DenseAdam(groups, lr=cfg.learning_rate,
                     betas=(cfg.optim_beta1, cfg.optim_beta2),
                     eps=cfg.optim_epsilon, weight_decay=cfg.weight_decay,
                     every=cfg.grad_accum_steps, accumulated=encoder + head)


def build_gt_model(cfg: DenseConfig, vocab_size: int, seq_length: int,
                   device: torch.device) -> GTDenseCaptioner:
    """The captioner for `cfg` on `device`: compute in
    `cfg.compute_dtype`, parameters in `cfg.param_dtype`. The transformer
    head (`use_lstm` False) takes the model's default widths, as the JAX
    driver does: `num_layers` sizes the LSTM only. A `RegionLMConfig`
    builds the region language model instead, its widths and vocabulary
    the config's (`vocab_size` and `seq_length` unused)."""
    if isinstance(cfg, RegionLMConfig):
        with torch.device(device):
            return GTRegionLMCaptioner(
                moe_lm.LMSpec.from_config(cfg), vgg_stages=cfg.vgg_stages,
                compute_dtype=DTYPES[cfg.compute_dtype],
                param_dtype=DTYPES[cfg.param_dtype])
    with torch.device(device):
        return GTDenseCaptioner(
            vocab_size=vocab_size, seq_length=seq_length,
            use_lstm=cfg.use_lstm, embedding_size=cfg.input_encoding_size,
            rnn_size=cfg.rnn_size, num_lstm_layers=cfg.num_layers,
            dropout=cfg.drop_value if cfg.use_dropout else 0.0,
            vgg_stages=cfg.vgg_stages,
            compute_dtype=DTYPES[cfg.compute_dtype],
            param_dtype=DTYPES[cfg.param_dtype])


def build_rpn_model(cfg: DenseConfig, vocab_size: int, seq_length: int,
                    device: torch.device) -> DenseCapRPN:
    """The RPN model for `cfg` on `device` (JAX `build_rpn_model`): half
    the sampler's batch positives and half negatives, at most 300 test
    proposals, the config's loss weights and anchor ladder; compute in
    `cfg.compute_dtype`, trunk and classifier parameters in
    `cfg.param_dtype`."""
    with torch.device(device):
        return DenseCapRPN(
            vocab_size=vocab_size, seq_length=seq_length,
            num_pos=cfg.sampler_batch_size // 2,
            num_neg=cfg.sampler_batch_size // 2,
            test_proposals=min(cfg.test_num_proposals, 300),
            embedding_size=cfg.input_encoding_size, rnn_size=cfg.rnn_size,
            mid_obj_weight=cfg.mid_objectness_weight,
            mid_reg_weight=cfg.mid_box_reg_weight,
            end_obj_weight=cfg.end_objectness_weight,
            end_reg_weight=cfg.end_box_reg_weight,
            caption_weight=cfg.captioning_weight,
            box_reg_decay=cfg.box_reg_decay,
            with_captioning=not cfg.roi_only, vgg_stages=cfg.vgg_stages,
            anchor_sizes=tuple(cfg.anchor_sizes),
            anchor_ratios=tuple(cfg.anchor_ratios),
            apply_box_decay=cfg.apply_box_decay,
            compute_dtype=DTYPES[cfg.compute_dtype],
            param_dtype=DTYPES[cfg.param_dtype])


def setup(cfg: DenseConfig, vocab_size: int, seq_length: int,
          device=None):
    """The reference's `SetupModule.setup(opt)` (DenseCap/models.py:10-42),
    as the JAX driver's `setup`: the GT model for `model_type="gt"`, else
    the RPN model (with its captioning branch unless `roi_only`), seeded
    from `cfg.seed`, on the card unless `device="cpu"`. Where
    `cfg.checkpoint_start_from` names a port checkpoint (a training state
    or `{"model": ...}`), its weights are restored into the model →
    (model, the checkpoint's state); else (model, None). The trainers do
    not call it, as the JAX trainers do not."""
    dev = resolve_device(device)
    build = build_gt_model if cfg.model_type == "gt" else build_rpn_model
    model = seeded_init_(build(cfg, vocab_size, seq_length, dev), cfg.seed)
    state = None
    if cfg.checkpoint_start_from:
        state = ckptlib.restore_checkpoint(cfg.checkpoint_start_from,
                                           map_location=dev)
        model.load_state_dict(state["model"])
    return model, state


def make_gt_train_step(model: GTDenseCaptioner, optimizer: DenseAdam,
                       use_curriculum: bool, generator: torch.Generator,
                       dp: Optional[meshlib.DataParallel] = None):
    """One step: (uint8 images (N, S, S, 3), boxes (N, R, 4), labels
    (N, R, T) long, box mask (N, R), teacher_prob) on the model's device
    → the captioning loss (a 0-d tensor, not synchronised); an update at
    the end of each accumulation window. Dropout and scheduled sampling
    draw from `generator`. With `dp` the inputs are this rank's rows of
    the global batch and the loss is the global one."""
    dp = dp or meshlib.IDENTITY

    def train_step(images_u8, boxes, labels, mask, teacher_prob):
        with span("dense.step"):
            with meshlib.active(dp):
                x = normalize_images(images_u8, dtype=model.compute_dtype)
                out = model(x, boxes, labels, train=True,
                            teacher_prob=(teacher_prob if use_curriculum
                                          else None),
                            generator=generator)
                loss = model.loss(out, labels, mask)
                optimizer.zero_grad(set_to_none=True)
                with span("dense.backward"):
                    loss.backward()
                _update(optimizer, dp)
            return dp.all_sum(loss.detach())
    return train_step


def _update(optimizer: DenseAdam, dp: meshlib.DataParallel) -> None:
    """The global batch's gradient, summed over the data ranks before the
    window's mean, then an update at the window's end."""
    with span("dense.update"):
        dp.reduce_grads(p.grad for p in optimizer.accumulated.values())
        if optimizer.accumulate():
            optimizer.step()


def make_rpn_train_step(model: DenseCapRPN, optimizer: DenseAdam,
                        generator: torch.Generator,
                        dp: Optional[meshlib.DataParallel] = None):
    """One step: (uint8 images (N, S, S, 3), GT boxes (N, M, 4), box
    mask (N, M), labels (N, M, T) long) on the model's device → the loss
    dict (0-d tensors, not synchronised), the gradient taken of `total`;
    an update at the end of each accumulation window.
    The dropout masks draw from `generator`, and so do the sampler's keys
    unless they are given (`keys`, as `DenseCapRPN.forward` takes
    them; this rank's rows of them with `dp`). With `dp` the inputs are
    this rank's rows of the global batch and the losses the global ones
    (one reduction of the stacked dict)."""
    dp = dp or meshlib.IDENTITY

    def train_step(images_u8, boxes, mask, labels, keys=None):
        with span("dense.step"):
            with meshlib.active(dp):
                x = normalize_images(images_u8, dtype=model.compute_dtype)
                losses = model(x, boxes, mask, labels, keys=keys, train=True,
                               generator=generator)
                optimizer.zero_grad(set_to_none=True)
                with span("dense.backward"):
                    losses["total"].backward()
                _update(optimizer, dp)
            if dp.size == 1:
                return {k: v.detach() for k, v in losses.items()}
            summed = dp.all_sum(torch.stack([v.detach().float()
                                             for v in losses.values()]))
            return dict(zip(losses, summed.unbind()))
    return train_step


def _endless_batches(loader: VGDataLoader, cfg: DenseConfig,
                     start_images: int = 0) -> Iterator[Dict]:
    """Endless pass over the train split; `start_images` fast-forwards
    the first epoch — the reference's resume cursor (traingt.py:51)."""
    while True:
        yield from loader.padded_batches(0, cfg.batch_size,
                                         max_regions=cfg.max_regions,
                                         start=start_images)
        start_images = 0


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              rows: slice = slice(None)):
    """A loader batch's `rows` (a data rank's; all by default) → (images
    u8, boxes, labels long, box mask) on `device`. Counts the batches and
    the bytes of the rows copied (`to_device.batches`, `to_device.bytes`)."""
    with span("dense.to_device"):
        host = [batch[k][rows] for k in ("image", "boxes", "labels",
                                         "box_mask")]
        count("to_device.batches")
        count("to_device.bytes", sum(a.nbytes for a in host))
        images, boxes, labels, mask = (torch.from_numpy(a).to(device)
                                       for a in host)
        return images, boxes, labels.long(), mask


def _seeded_model(model: torch.nn.Module, cfg: DenseConfig, trunk: str,
                  verbose: bool) -> torch.nn.Module:
    """`model` from `cfg.seed`, with `encoder_init`'s converted weights
    merged in (`trunk` the default module)."""
    seeded_init_(model, cfg.seed)
    if cfg.encoder_init:
        pretrained.apply_encoder_init(model, cfg.encoder_init, trunk)
        if verbose:
            print(f"encoder initialized from {cfg.encoder_init}")
    return model


def _idle_summary(mesh: meshlib.Mesh, cfg) -> Dict:
    """A rank beyond `mesh_for_batch`'s cap: it says so and runs nothing."""
    meshlib.announce_idle(mesh, cfg.batch_size)
    return {"iters": 0, "idle": True, "mesh": mesh.shape}


def _train_loop(cfg: DenseConfig, *, model, optimizer, generator, loader,
                step: Callable[[Dict, int], Dict[str, float]],
                evaluate: Callable[[], Dict], save_path: str,
                loss_file: str, result_file: str, loss_key: str,
                log_every: int, max_iter: int, eval_every: int,
                verbose: bool, mesh: Optional[meshlib.Mesh] = None) -> Dict:
    """The dense drivers' shared loop: resume from the newest full-state
    checkpoint under `save_path` (with `from_checkpoint`); then up to
    `max_iter` steps of `step(batch, it)` → losses, the loss history's
    `loss_key` every `log_every` steps, `evaluate()` every `eval_every`
    steps and at the end, keeping the checkpoint of the best val mAP,
    and a preemption checkpoint `<save_path>.preempt` on SIGTERM/SIGINT;
    the losses, the step's ms (to the device's end of the step) and the
    val scores as TensorBoard scalars with `tensorboard_dir`, the loop in
    anomaly mode with `debug_nans`, and with `profile_dir` rank 0's
    profiler trace of the steady steps `PROFILED_STEPS` (`<profile_dir>/
    trace.json`, the program's spans beside its operators and kernels).
    Over a `mesh` of several ranks, rank 0 alone evaluates and writes
    while the others wait at a barrier, and a signal seen by any rank
    stops every rank at the same step. Returns the summary's common
    part."""
    mesh = mesh or meshlib.single()
    writer = meshlib.is_writer()
    loss_hist = LossHistory(loss_file, resume=cfg.from_checkpoint)
    res_hist = ResultsHistory(result_file, resume=cfg.from_checkpoint)
    start_iter, start_images = 0, 0
    resume_from = ckptlib.resume_path(save_path) if cfg.from_checkpoint \
        else None
    if resume_from:
        start_iter, start_images = ckptlib.load_train_state(
            ckptlib.restore_checkpoint(resume_from, torch.device("cpu")),
            model, optimizer, generator)
        if verbose:
            print(f"resumed from {resume_from} at iter {start_iter}")

    # each epoch pass consumes steps_per_epoch batches (ragged tail
    # dropped), so the cursor wraps in whole batches
    steps_per_epoch = max(len(loader.train_ix) // cfg.batch_size, 1)
    it = start_iter
    last: Dict[str, float] = {}
    timer = profiling.StepTimer(sync=next(model.parameters()).device)

    def state():
        cursor = (it % steps_per_epoch) * cfg.batch_size
        return ckptlib.train_state(model, optimizer, it, generator, cursor)
    with ckptlib.SignalCheckpointer() as sig, \
            closing(TBWriter(cfg.tensorboard_dir)) as tb, \
            profiling.enable_nan_debugging(cfg.debug_nans), \
            ExitStack() as profiled:
        for batch in _endless_batches(loader, cfg, start_images):
            if it >= max_iter:
                break
            if mesh.any(sig.requested):
                ckptlib.save_checkpoint(save_path + ".preempt", state())
                mesh.barrier()
                if verbose and writer:
                    print(f"preemption checkpoint written at iter {it}")
                break
            done = it - start_iter
            if cfg.profile_dir and writer and done == PROFILED_STEPS[0]:
                profiled.enter_context(profiling.trace(cfg.profile_dir))
            with timer:
                last = step(batch, it)
            step_ms = timer.last_ms
            it += 1
            if done + 1 == PROFILED_STEPS[1]:
                profiled.close()
            if it % log_every == 0:
                loss_hist.append(it, last[loss_key], step_ms)
                loss_hist.flush()
                tb.scalars(last, it, prefix="train/")
                tb.scalar("train/step_ms", step_ms, it)
                if verbose and writer:
                    msg = ", ".join(f"{k} {v:.5f}" for k, v in last.items())
                    print(f"iter {it}/{max_iter} {msg} ({step_ms:.1f} ms)")
            if (it % eval_every == 0 or it == max_iter) and writer:
                results = evaluate()
                is_best = res_hist.append(it, results,
                                          score_key=("ap_results", "map"))
                res_hist.flush()
                tb.scalars(results.get("ap_results", {}), it, prefix="val/")
                tb.flush()
                if verbose:
                    print(f"eval@{it}: "
                          f"map={results['ap_results']['map']:.4f} "
                          f"best={is_best}")
                if is_best:
                    ckptlib.save_checkpoint(save_path, state())
            if it % eval_every == 0 or it == max_iter:
                mesh.barrier()
    loss_hist.flush()         # the file exists for a run shorter than a log
    return {"iters": it, "max_iter": max_iter, "final_losses": last,
            "best_val_score": res_hist.best_score,
            "best_iter": res_hist.best_iter, "loss_file": loss_file,
            "result_file": result_file, "save_path": save_path,
            "model": model, "optimizer": optimizer, "loader": loader}


def train_gt(cfg: DenseConfig, *, device=None,
             max_iter_override: Optional[int] = None,
             eval_every_override: Optional[int] = None,
             synthetic_fallback: bool = True, synthetic_images: int = 8,
             synthetic_image_size: int = 64, synthetic_seq_length: int = 8,
             synthetic_learnable: bool = False,
             verbose: bool = True) -> Dict:
    """The traingt.py loop. Returns a summary with the histories' paths,
    the model, optimizer and loader."""
    dev = resolve_device(device)
    mesh = meshlib.mesh_for_batch(cfg.batch_size, cfg.mesh_shape,
                                  cfg.mesh_axis_names, dev)
    if mesh.idle:
        return _idle_summary(mesh, cfg)
    loss_file, result_file, save_path = name_gt_model(cfg)
    loader = make_vg_loader(cfg, synthetic_fallback, synthetic_images,
                            synthetic_image_size, synthetic_seq_length,
                            synthetic_learnable)
    model = _seeded_model(build_gt_model(cfg, loader.getVocabSize(),
                                         loader.getSeqLength(), dev),
                          cfg, "features", verbose)
    # traingt.py:87-88 counts the train split's IMAGES and compares that
    # with the iteration count (ROADMAP.md, Queue 3): kept as it is, in
    # applied updates under accumulation
    optimizer = make_dense_optimizer(
        cfg, model, applied_updates(len(loader.train_ix),
                                    cfg.grad_accum_steps))
    generator = torch.Generator(dev)
    generator.manual_seed(cfg.seed + 1)
    train_step = make_gt_train_step(model, optimizer,
                                    cfg.use_curriculum_learning, generator,
                                    mesh.data)
    rows = mesh.data.rows(cfg.batch_size)

    def step(batch, it):
        loss = train_step(*to_device(batch, dev, rows),
                          teacher_prob_schedule(it))
        return {"captioning_loss": float(loss)}

    def evaluate():
        return dense_eval.eval_split_gt(
            model, loader, split=1, batch_size=cfg.eval_batch_size,
            max_regions=cfg.max_regions)
    out = _train_loop(
        cfg, model=model, optimizer=optimizer, generator=generator,
        loader=loader, step=step, evaluate=evaluate, save_path=save_path,
        loss_file=loss_file, result_file=result_file,
        loss_key="captioning_loss", log_every=cfg.loss_log_pad,
        max_iter=max_iter_override or cfg.max_iters,
        eval_every=eval_every_override or cfg.save_checkpoint_every,
        verbose=verbose, mesh=mesh)
    out["final_loss"] = out["final_losses"].get("captioning_loss",
                                                float("nan"))
    return out


# ------------------------------------------------------------- RPN path

def eval_split_rpn(model: DenseCapRPN, loader, split: int = 1,
                   max_regions: Optional[int] = None, max_images: int = -1,
                   score_thresh: float = -10.0,
                   return_records: bool = False) -> Dict:
    """The `DenseCap/eval/eval_utils.eval_split` protocol over the RPN
    model (on its own device), one image at a time: `forward_test`
    detections and greedy captions of seq_length + 1 steps, kept where
    NMS keeps them and the score is above `score_thresh`, scored by the
    full DenseCap mAP; per image also the kept detections' proposal
    recall (`eval_box_recalls` at 10, 50, 100 and all) and the anchor
    assignment: each real GT's best anchor IoU and how many proposals
    qualify as positive candidates (`candidate_masks`). `max_images` > 0
    stops once that many images are scored. An image's results come to
    the host in one copy.

    Returns {'ap_results': {..., 'proposal_recall', 'anchor_assignment'},
    'num_images': n} and, with `return_records`, 'records': each kept
    detection's caption beside its matched GT references."""
    dev = next(model.parameters()).device
    steps = loader.getSeqLength() + 1
    evaluator = dense_eval.DenseCaptioningEvaluator()
    seen = 0
    best_anchor_ious: list = []
    pos_candidates: list = []
    recall_acc: Dict[str, list] = {}
    for batch in loader.padded_batches(split, 1, max_regions):
        if 0 < max_images <= seen:
            break
        images = normalize_images(torch.from_numpy(batch["image"]).to(dev))
        gt_b = torch.from_numpy(batch["boxes"][0]).to(dev)
        gt_m = torch.from_numpy(batch["box_mask"][0]).to(dev)
        with torch.inference_mode():
            boxes, scores, codes, keep = model.forward_test(images)
            toks = model.generate_captions(codes, steps)
            rpn = model.proposals_only(images)
            best_iou = boxlib.box_iou(gt_b, rpn.anchors).max(dim=1).values
            _, in_b = boxlib.clip_boxes(rpn.proposals[0], *images.shape[1:3])
            pos_mask, _, _ = candidate_masks(rpn.proposals[0], gt_b, gt_m,
                                             in_bounds=in_b)
            # one copy to the host: boxes, scores, keep, best IoUs and
            # the positive count beside the tokens
            flat = torch.cat([boxes[0].float(), scores[0].float()[:, None],
                              keep[0].float()[:, None]], 1).reshape(-1)
            host = torch.cat([flat, best_iou.float(),
                              pos_mask.sum().float()[None],
                              toks.float().reshape(-1)]).cpu().numpy()
        d, g = boxes.shape[1], gt_b.shape[0]
        packed, host = host[:d * 6].reshape(d, 6), host[d * 6:]
        b, s = packed[:, :4], packed[:, 4]
        k = (packed[:, 5] > 0) & (s > score_thresh)
        best_iou, n_pos = host[:g], host[g]
        toks = host[g + 1:].astype(np.int64).reshape(d, -1)
        m = batch["box_mask"][0] > 0
        best_anchor_ious.extend(best_iou[m])
        pos_candidates.append(float(n_pos))
        if k.any():
            gt_caps = loader.vocab.decode_sequence(batch["labels"][0][m])
            evaluator.addResult(s[k], b[k],
                                loader.vocab.decode_sequence(toks[k]),
                                batch["boxes"][0][m], gt_caps)
            # how well the detection stage alone covers the GT
            order = np.argsort(-s[k])
            n_kept = int(k.sum())
            rec = dense_eval.eval_box_recalls(
                b[k][order], batch["boxes"][0][m], ns=[10, 50, 100, n_kept])
            for key, v in rec.items():
                # the n_kept column averages consistently as 'at_all'
                if key.endswith(f"_at_{n_kept}"):
                    key = key.replace(f"_at_{n_kept}", "_at_all")
                recall_acc.setdefault(key, []).append(v)
        seen += 1
    out = {"ap_results": evaluator.evaluate(), "num_images": seen}
    out["ap_results"]["proposal_recall"] = {
        k: round(float(np.mean(v)), 4) for k, v in recall_acc.items()}
    if best_anchor_ious:
        bai = np.asarray(best_anchor_ious)
        pc = np.asarray(pos_candidates)
        out["ap_results"]["anchor_assignment"] = {
            "gt_frac_best_anchor_iou_ge_0.7": round(float(
                (bai >= 0.7).mean()), 4),
            "gt_frac_best_anchor_iou_ge_0.5": round(float(
                (bai >= 0.5).mean()), 4),
            "mean_best_anchor_iou": round(float(bai.mean()), 4),
            "pos_candidates_mean": round(float(pc.mean()), 2),
            "pos_occupancy": round(float(
                np.minimum(pc, model.num_pos).mean() / model.num_pos), 4),
        }
    if return_records:
        out["records"] = [{"candidate": r["candidate"],
                           "references": r["references"]}
                          for r in evaluator.records]
    return out


def train_rpn(cfg: DenseConfig, *, device=None,
              max_iter_override: Optional[int] = None,
              eval_every_override: Optional[int] = None,
              synthetic_fallback: bool = True, synthetic_images: int = 8,
              synthetic_image_size: int = 64, synthetic_seq_length: int = 8,
              synthetic_learnable: bool = False,
              verbose: bool = True) -> Dict:
    """The repaired DenseCap/train.py loop over the RPN model. Returns a
    summary with the last step's losses, the histories' paths, the model,
    optimizer and loader."""
    dev = resolve_device(device)
    mesh = meshlib.mesh_for_batch(cfg.batch_size, cfg.mesh_shape,
                                  cfg.mesh_axis_names, dev)
    if mesh.idle:
        return _idle_summary(mesh, cfg)
    loader = make_vg_loader(cfg, synthetic_fallback, synthetic_images,
                            synthetic_image_size, synthetic_seq_length,
                            synthetic_learnable)
    model = _seeded_model(build_rpn_model(cfg, loader.getVocabSize(),
                                          loader.getSeqLength(), dev),
                          cfg, "conv_trunk", verbose)
    optimizer = make_dense_optimizer(
        cfg, model, applied_updates(len(loader.train_ix),
                                    cfg.grad_accum_steps))
    generator = torch.Generator(dev)
    generator.manual_seed(cfg.seed + 1)
    train_step = make_rpn_train_step(model, optimizer, generator, mesh.data)
    rows = mesh.data.rows(cfg.batch_size)

    def step(batch, it):
        images, boxes, labels, mask = to_device(batch, dev, rows)
        losses = train_step(images, boxes, mask, labels)
        return {k: float(v) for k, v in losses.items()}

    def evaluate():
        return eval_split_rpn(model, loader, 1, cfg.max_regions)
    return _train_loop(
        cfg, model=model, optimizer=optimizer, generator=generator,
        loader=loader, step=step, evaluate=evaluate,
        save_path=cfg.save_path, loss_file=cfg.loss_file,
        result_file=cfg.result_file, loss_key="total",
        log_every=cfg.losses_log_every,
        max_iter=max_iter_override or cfg.max_iters,
        eval_every=eval_every_override or cfg.save_checkpoint_every,
        verbose=verbose, mesh=mesh)
