"""GT-box dense-caption training — port of the GT half of
`imagecaptioning_tpu/train/dense_driver.py` (:44-375).

`train_gt` reproduces the `traingt.py` loop: hard `max_iter` / `pad`,
optional curriculum `teacher_prob = 40000/(40000+exp(iter/40000))`
(`traingt.py:72-73`), Adam with additive weight decay, the CNN's
conv1_*/conv2_* frozen for good and the rest of the trunk trained from
`finetune_start_step` on (`traingt.py:58-64,87-88`), eval by the GT mAP
protocol with the best checkpoint kept on val mAP (`traingt.py:95-109`),
loss/result history JSONs in the reference schema, resume from the
newest full-state checkpoint and a preemption checkpoint on SIGTERM.

A step (`make_gt_train_step`) normalizes the uint8 images on the device,
runs the captioner in training mode (VGG16 and the classifier in bf16
over fp32 master weights, the ROI kernel forward and its backward
kernel, the caption head in fp32: the transformer head of the default
config, or the LSTM head with `use_lstm`), backpropagates and takes one
optimizer
update. Runs on the first CUDA card unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch.config.dense_configs import (DenseConfig,
                                                            name_gt_model)
from imagecaptioning_tpu_torch.data import synthetic
from imagecaptioning_tpu_torch.data.vg_loader import (VGDataLoader,
                                                      normalize_images)
from imagecaptioning_tpu_torch.eval import dense_eval
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils.io import LossHistory, ResultsHistory
from imagecaptioning_tpu_torch.utils.platform import resolve_device
from imagecaptioning_tpu_torch.utils.weights import seeded_init_

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# torchvision vgg16.features indices of conv1_* and conv2_* (with their
# ReLUs and pools): frozen for good when the CNN is finetuned
FROZEN_FEATURES = 10


def make_vg_loader(cfg: DenseConfig, synthetic_fallback: bool = True,
                   synthetic_images: int = 8,
                   image_size: int = 64) -> VGDataLoader:
    """The VG HDF5 named by the config, else seeded synthetic arrays
    (captions of at most 8 words)."""
    if os.path.exists(cfg.data_h5) and os.path.exists(cfg.data_json):
        return VGDataLoader(data_h5=cfg.data_h5, data_json=cfg.data_json)
    if not synthetic_fallback:
        raise FileNotFoundError(cfg.data_h5)
    arrays, info = synthetic.make_vg_arrays(
        num_images=synthetic_images, image_size=image_size, seq_length=8,
        seed=cfg.seed)
    return VGDataLoader(arrays=arrays, info=info)


def teacher_prob_schedule(it) -> float:
    """Curriculum schedule 40000/(40000+exp(iter/40000)) in fp32
    (`traingt.py:72`)."""
    k = np.float32(40000.0)
    return float(k / (k + np.exp(np.float32(it) / k)))


class DenseAdam(torch.optim.Adam):
    """torch Adam — whose `weight_decay` is the additive L2 on the gradient
    before the moments, as optax's `add_decayed_weights` before
    `scale_by_adam` (`traingt.py:62`), not AdamW — with two per-group
    keys of the dense drivers, kept in the optimizer's state dict:

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


def make_dense_optimizer(cfg: DenseConfig, model: GTDenseCaptioner,
                         finetune_start_step: int) -> DenseAdam:
    """Adam over three groups of `model`'s parameters, as the JAX
    package's `multi_transform`:
    - frozen: conv1_*/conv2_* (`features.0-9`), and the whole trunk when
      `finetune_cnn` is off. Their `requires_grad` is cleared, which
      leaves them where optax's `set_to_zero` does and spares their
      gradients; they are in no group.
    - encoder: the rest of the trunk, lr 0 before `finetune_start_step`
      (in applied updates) and `learning_rate` from it on; its moments
      accumulate from the first update.
    - head: everything else, at `learning_rate`.
    `grad_clip_norm` > 0 clips each group on its own. Gradient
    accumulation (`grad_accum_steps` > 1) is not ported and raises."""
    if cfg.grad_accum_steps > 1:
        raise NotImplementedError(
            "grad_accum_steps > 1 (optax.MultiSteps) is not ported yet "
            "(ROADMAP.md, Queue 3)")
    encoder, head = [], []
    for name, p in model.named_parameters():
        if name.startswith("features."):
            idx = int(name.split(".")[1])
            if cfg.finetune_cnn and idx >= FROZEN_FEATURES:
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
                     eps=cfg.optim_epsilon, weight_decay=cfg.weight_decay)


def build_gt_model(cfg: DenseConfig, vocab_size: int, seq_length: int,
                   device: torch.device) -> GTDenseCaptioner:
    """The captioner for `cfg` on `device`: compute in
    `cfg.compute_dtype`, parameters in `cfg.param_dtype`. The transformer
    head (`use_lstm` False) takes the model's default widths, as the JAX
    driver does: `num_layers` sizes the LSTM only."""
    with torch.device(device):
        return GTDenseCaptioner(
            vocab_size=vocab_size, seq_length=seq_length,
            use_lstm=cfg.use_lstm, embedding_size=cfg.input_encoding_size,
            rnn_size=cfg.rnn_size, num_lstm_layers=cfg.num_layers,
            dropout=cfg.drop_value if cfg.use_dropout else 0.0,
            vgg_stages=cfg.vgg_stages,
            compute_dtype=DTYPES[cfg.compute_dtype],
            param_dtype=DTYPES[cfg.param_dtype])


def make_gt_train_step(model: GTDenseCaptioner, optimizer: DenseAdam,
                       use_curriculum: bool, generator: torch.Generator):
    """One update: (uint8 images (N, S, S, 3), boxes (N, R, 4), labels
    (N, R, T) long, box mask (N, R), teacher_prob) on the model's device
    → the captioning loss (a 0-d tensor, not synchronised). Dropout and
    scheduled sampling draw from `generator`."""
    def train_step(images_u8, boxes, labels, mask, teacher_prob):
        x = normalize_images(images_u8, dtype=model.compute_dtype)
        out = model(x, boxes, labels, train=True,
                    teacher_prob=teacher_prob if use_curriculum else None,
                    generator=generator)
        loss = model.loss(out, labels, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return train_step


def gt_train_state(model: GTDenseCaptioner, optimizer: DenseAdam, step: int,
                   generator: torch.Generator, loader_cursor: int) -> Dict:
    """The full training state a checkpoint holds."""
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "step": step, "generator": generator.get_state(),
            "loader_cursor": loader_cursor}


def load_gt_train_state(state: Dict, model: GTDenseCaptioner,
                        optimizer: DenseAdam, generator: torch.Generator):
    """Put a checkpoint's state back → (step, loader cursor)."""
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    generator.set_state(state["generator"])
    return state["step"], state["loader_cursor"]


def _endless_batches(loader: VGDataLoader, cfg: DenseConfig,
                     start_images: int = 0) -> Iterator[Dict]:
    """Endless pass over the train split; `start_images` fast-forwards
    the first epoch — the reference's resume cursor (traingt.py:51)."""
    while True:
        yield from loader.padded_batches(0, cfg.batch_size,
                                         max_regions=cfg.max_regions,
                                         start=start_images)
        start_images = 0


def to_device(batch: Dict[str, np.ndarray], device: torch.device):
    """A loader batch → (images u8, boxes, labels long, box mask) on
    `device`."""
    return (torch.from_numpy(batch["image"]).to(device),
            torch.from_numpy(batch["boxes"]).to(device),
            torch.from_numpy(batch["labels"]).to(device).long(),
            torch.from_numpy(batch["box_mask"]).to(device))


def train_gt(cfg: DenseConfig, *, device=None,
             max_iter_override: Optional[int] = None,
             eval_every_override: Optional[int] = None,
             synthetic_fallback: bool = True, synthetic_images: int = 8,
             synthetic_image_size: int = 64, verbose: bool = True) -> Dict:
    """The traingt.py loop. Returns a summary with the histories' paths,
    the model, optimizer and loader."""
    dev = resolve_device(device)
    for knob in ("encoder_init", "tensorboard_dir"):
        if getattr(cfg, knob):
            raise NotImplementedError(f"{knob} is not ported yet "
                                      f"(ROADMAP.md, Queue 3)")
    loss_file, result_file, save_path = name_gt_model(cfg)
    loader = make_vg_loader(cfg, synthetic_fallback, synthetic_images,
                            synthetic_image_size)
    model = seeded_init_(build_gt_model(cfg, loader.getVocabSize(),
                                        loader.getSeqLength(), dev), cfg.seed)
    max_iter = max_iter_override or cfg.max_iters
    pad = cfg.loss_log_pad
    eval_every = eval_every_override or cfg.save_checkpoint_every
    # traingt.py:87-88 counts the train split's IMAGES and compares that
    # with the iteration count (ROADMAP.md, Queue 3): kept as it is
    finetune_start = len(loader.train_ix)
    optimizer = make_dense_optimizer(cfg, model, finetune_start)
    generator = torch.Generator(dev)
    generator.manual_seed(cfg.seed + 1)
    train_step = make_gt_train_step(model, optimizer,
                                    cfg.use_curriculum_learning, generator)

    loss_hist = LossHistory(loss_file, resume=cfg.from_checkpoint)
    res_hist = ResultsHistory(result_file, resume=cfg.from_checkpoint)
    start_iter, start_images = 0, 0
    resume_from = ckptlib.resume_path(save_path) if cfg.from_checkpoint \
        else None
    if resume_from:
        start_iter, start_images = load_gt_train_state(
            ckptlib.restore_checkpoint(resume_from, torch.device("cpu")),
            model, optimizer, generator)
        if verbose:
            print(f"resumed from {resume_from} at iter {start_iter}")

    # each epoch pass consumes steps_per_epoch batches (ragged tail
    # dropped), so the cursor wraps in whole batches
    steps_per_epoch = max(len(loader.train_ix) // cfg.batch_size, 1)
    it = start_iter
    last_loss = float("nan")

    def state():
        cursor = (it % steps_per_epoch) * cfg.batch_size
        return gt_train_state(model, optimizer, it, generator, cursor)
    with ckptlib.SignalCheckpointer() as sig, \
            torch.autograd.set_detect_anomaly(cfg.debug_nans):
        for batch in _endless_batches(loader, cfg, start_images):
            if it >= max_iter:
                break
            if sig.requested:
                ckptlib.save_checkpoint(save_path + ".preempt", state())
                if verbose:
                    print(f"preemption checkpoint written at iter {it}")
                break
            t0 = time.perf_counter()
            loss = train_step(*to_device(batch, dev),
                              teacher_prob_schedule(it))
            last_loss = float(loss)
            step_ms = (time.perf_counter() - t0) * 1000.0
            it += 1
            if it % pad == 0:
                loss_hist.append(it, last_loss, step_ms)
                loss_hist.flush()
                if verbose:
                    print(f"iter {it}/{max_iter} captioning_loss "
                          f"{last_loss:.5f} ({step_ms:.1f} ms)")
            if it % eval_every == 0 or it == max_iter:
                results = dense_eval.eval_split_gt(
                    model, loader, split=1, batch_size=cfg.eval_batch_size,
                    max_regions=cfg.max_regions)
                is_best = res_hist.append(it, results,
                                          score_key=("ap_results", "map"))
                res_hist.flush()
                if verbose:
                    print(f"eval@{it}: "
                          f"map={results['ap_results']['map']:.4f} "
                          f"best={is_best}")
                if is_best:
                    ckptlib.save_checkpoint(save_path, state())
    return {
        "iters": it, "max_iter": max_iter, "final_loss": last_loss,
        "best_val_score": res_hist.best_score,
        "best_iter": res_hist.best_iter,
        "loss_file": loss_file, "result_file": result_file,
        "save_path": save_path, "model": model, "optimizer": optimizer,
        "loader": loader,
    }
