"""The AlexCap training driver — port of `imagecaptioning_tpu/train/
driver.py` (`make_loader`, `_batch_iterator`, `_resident_mode`, `train`)
for the four families.

The skeleton every reference driver shares (`train_LSTM.py` …, SURVEY
§2.2): `iters_per_epoch = save_checkpoint_every // batch_size`,
`max_iter = iters_per_epoch · num_epochs`, the loss-log stride `pad =
save_checkpoint_every // batch_size²` (`log_every`, where it is set); the frozen-CNN phase until
`finetune_start = finetuning_after_nepoch · iters_per_epoch`, then the
finetune phase; `eval_split` on val every epoch, the best checkpoint kept
by val METEOR (with the loader's `iterators`); a preemption checkpoint
`<save_path>.preempt` on SIGTERM/SIGINT; a final test-split eval, with a
beam sweep of 1–5 when `use_beam` (`train_Transformer.py:166-178`); the
loss and results histories in the reference schema. The encoder's
gradient is stopped in the frozen phase, and for the whole run in a
`trained_encoder` ViT (`encoder_frozen`); after the boundary the
Transformer's trunk runs in training mode and its gradient enters the
clip, though its optimizer group is a hard zero (`train/optim.py`).
`encoder_init` merges converted encoder weights into the seeded init
(`utils/pretrained.py`).

The knobs: `grad_accum_steps` = k averages k micro-steps into one update
(optax's `MultiSteps`, `train/optim.py`): the loop counts micro-steps,
the finetune boundary is rounded up to a window's edge and the
optimizer's schedules count applied updates, `-(-max_iter // k)` in all;
`tensorboard_dir` writes the loss and the val scores as TensorBoard
scalars (`utils/tb.py`); `debug_nans` runs the loop in autograd's anomaly
mode (`utils/profiling.py`); `synthetic_learnable` trains on captions
that describe the images (`data/synthetic.py`).

The input path is the device-resident store (`data.device_store`: the
uint8 train split on the card, index batches per step) or the streaming
one (host gather in a prefetch thread, then a copy per batch), chosen by
`device_resident_data`; both give the same batches in the same order.
Runs on the first CUDA card unless the caller passes `device="cpu"`.

Data-parallel over `mesh_for_batch(batch_size, mesh_shape,
mesh_axis_names)` under torchrun, as the JAX driver shards its step:
every rank walks the same batch order and takes its rows (the resident
store is staged whole on every rank's card, replicated, and each rank
gathers its rows of the index batch); the step sums the loss parts and
the gradients over the data ranks (`train/step.py`), so every rank
applies the same update. Rank 0 alone evaluates (over the whole split,
as JAX's unsharded eval) and writes the histories, TensorBoard and
checkpoints, the others meeting it at a barrier; every rank resumes from
the same checkpoint, the generator's state with it.
"""

from __future__ import annotations

import os
from contextlib import closing
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch.config.configs import CaptionConfig, name_model
from imagecaptioning_tpu_torch.data import device_store, synthetic
from imagecaptioning_tpu_torch.data.loader import (AlexDataLoader,
                                                   prefetch_batches)
from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
from imagecaptioning_tpu_torch.eval.eval_split import eval_split
from imagecaptioning_tpu_torch.models.captioners import (
    DTYPES, build_model, encoder_always_frozen, encoder_name)
from imagecaptioning_tpu_torch.parallel import mesh as meshlib
from imagecaptioning_tpu_torch.train import optim
from imagecaptioning_tpu_torch.train.step import (make_eval_step,
                                                  make_train_step)
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils import pretrained, profiling
from imagecaptioning_tpu_torch.utils.io import LossHistory, ResultsHistory
from imagecaptioning_tpu_torch.utils.platform import resolve_device
from imagecaptioning_tpu_torch.utils.tb import TBWriter
from imagecaptioning_tpu_torch.utils.weights import seeded_init_


def make_loader(cfg: CaptionConfig, synthetic_fallback: bool = True,
                synthetic_images: int = 64,
                synthetic_learnable: bool = False) -> AlexDataLoader:
    """The Face2Text HDF5 named by the config, else seeded synthetic
    arrays: random-word captions, or with `synthetic_learnable` captions
    that describe the rendered image."""
    if os.path.exists(cfg.data_h5) and os.path.exists(cfg.data_json):
        return AlexDataLoader(data_h5=cfg.data_h5, data_json=cfg.data_json,
                              seed=cfg.seed)
    if not synthetic_fallback:
        raise FileNotFoundError(cfg.data_h5)
    make = (synthetic.make_learnable_face2text_arrays if synthetic_learnable
            else synthetic.make_face2text_arrays)
    arrays, info = make(num_images=synthetic_images, seed=cfg.seed)
    return AlexDataLoader(arrays=arrays, info=info, seed=cfg.seed)


def _batch_iterator(loader, cfg, batch_size, start_images: int = 0):
    """Endless train-split batches: sequential when `cfg.iterate`, else a
    fresh shuffle each epoch (the reference's sampling without
    replacement). `start_images` fast-forwards the first sequential epoch
    to the resume cursor."""
    while True:
        yield from loader.epoch_batches(0, batch_size,
                                        shuffle=not cfg.iterate,
                                        start=start_images if cfg.iterate
                                        else 0)
        start_images = 0


def _resident_mode(cfg: CaptionConfig, loader,
                   device: torch.device) -> bool:
    """'on'/'off' are forced; 'auto' stages the train split on the card
    when its images are in RAM (not a lazy HDF5 handle) and it fits the
    card's free memory (`device_store.fits`)."""
    mode = cfg.device_resident_data
    if mode == "off":
        return False
    if mode == "on":
        return True
    if not isinstance(loader.images, np.ndarray):
        return False      # lazy h5: staging would re-read the whole file
    n = len(loader.split_ix[0])
    if n == 0:
        return False
    per_image = int(np.prod(loader.images.shape[1:]))      # uint8 bytes
    nbytes = n * (per_image + loader.labels.shape[1] * 8)  # int64 labels
    return device_store.fits(nbytes, device_store.device_memory_budget(device))


def encoder_frozen(cfg: CaptionConfig, it: int, frozen_until: int) -> bool:
    """Whether iteration `it` stops the encoder's gradient: the frozen
    phase, and every iteration of a `trained_encoder` ViT."""
    return it < frozen_until or encoder_always_frozen(cfg)


def train(cfg: CaptionConfig, *, device=None,
          max_iter_override: Optional[int] = None,
          eval_every_override: Optional[int] = None,
          synthetic_fallback: bool = True, synthetic_images: int = 64,
          synthetic_learnable: bool = False, verbose: bool = True) -> Dict:
    """Train per config → a summary with the histories' paths, the best
    val score, the final test evals, the model, optimizer and loader."""
    dev = resolve_device(device)
    mesh = meshlib.mesh_for_batch(cfg.batch_size, cfg.mesh_shape,
                                  cfg.mesh_axis_names, dev)
    if mesh.idle:
        meshlib.announce_idle(mesh, cfg.batch_size)
        return {"iters": 0, "idle": True, "mesh": mesh.shape}
    writer = meshlib.is_writer()
    loss_file, result_file, save_path = name_model(cfg)
    loader = make_loader(cfg, synthetic_fallback, synthetic_images,
                         synthetic_learnable)
    bs = cfg.batch_size
    iters_per_epoch = max(cfg.save_checkpoint_every // bs, 1)
    max_iter = max_iter_override or iters_per_epoch * cfg.num_epochs
    eval_every = eval_every_override or iters_per_epoch
    pad = cfg.log_every or max(cfg.save_checkpoint_every // (bs * bs), 1)
    # the loop counts micro-steps, the optimizer applied updates: the
    # boundary goes up to a window's edge, so that no window mixes phases
    accum = max(cfg.grad_accum_steps, 1)
    finetune_start = optim.applied_updates(
        cfg.finetuning_after_nepoch * iters_per_epoch, accum) * accum
    # the frozen-CNN phase (train_LSTM.py:48-54): no gradient reaches the
    # trunk before the finetune boundary
    frozen_until = finetune_start if cfg.finetune_cnn else 0

    model = seeded_init_(build_model(cfg, loader.getVocabSize(),
                                     loader.getSeqLength(), device=dev),
                         cfg.seed)
    if cfg.encoder_init:
        pretrained.apply_encoder_init(
            model, cfg.encoder_init,
            encoder_name(cfg.model_type))
        if verbose:
            print(f"encoder initialized from {cfg.encoder_init}")
    optimizer = optim.make_optimizer(cfg, model,
                                     optim.applied_updates(max_iter, accum))
    generator = torch.Generator(dev)
    generator.manual_seed(cfg.seed + 1)
    preprocess = partial(resnet_v2_preprocess,
                         dtype=DTYPES[cfg.compute_dtype])
    train_step = make_train_step(
        model, optimizer, generator, preprocess,
        clip_norm=cfg.grad_clip_norm if cfg.clip_grad else None,
        dp=mesh.data)
    rows = mesh.data.rows(bs)
    eval_loss = make_eval_step(model)

    loss_hist = LossHistory(loss_file, resume=cfg.from_checkpoint)
    res_hist = ResultsHistory(result_file, resume=cfg.from_checkpoint)
    start_iter = 0
    resume_from = ckptlib.resume_path(save_path) if cfg.from_checkpoint \
        else None
    if resume_from:
        state = ckptlib.restore_checkpoint(resume_from, torch.device("cpu"))
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        generator.set_state(state["generator"])
        loader.iterators = {int(k): int(v)
                            for k, v in state["iterators"].items()}
        start_iter = int(state["step"])
        if verbose:
            print(f"resumed from {resume_from} at iter {start_iter}")

    # the sequential cursor in whole batches (ragged tail dropped)
    steps_per_epoch_data = max(len(loader.split_ix[0]) // bs, 1)
    start_images = ((start_iter % steps_per_epoch_data) * bs
                    if cfg.iterate else 0)
    if _resident_mode(cfg, loader, dev):
        store = device_store.stage_split(loader, 0, dev)
        feed = device_store.index_stream(loader, 0, bs, iterate=cfg.iterate,
                                         start_images=start_images)

        def run_step(item):
            idx = torch.from_numpy(item[rows]).to(dev)
            return train_step(*device_store.gather_batch(store, idx))
        if verbose and writer:
            print(f"train split resident on {dev} "
                  f"({store.nbytes / 2**20:.0f} MiB)")
    else:
        feed = prefetch_batches(
            _batch_iterator(loader, cfg, bs, start_images=start_images),
            size=2, to_device=lambda a: torch.from_numpy(a[rows]).to(dev))

        def run_step(item):
            images_u8, labels = item
            return train_step(images_u8, labels.long())

    def state():
        return {"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": it,
                "generator": generator.get_state(),
                "iterators": dict(loader.iterators)}

    def evaluate(split, **kw):
        return eval_split(model, loader, split=split,
                          batch_size=cfg.eval_val_batch_size,
                          preprocess=preprocess, **kw)

    it = start_iter
    last_loss = float("nan")
    timer = profiling.StepTimer(sync=dev)
    with ckptlib.SignalCheckpointer() as sig, \
            closing(TBWriter(cfg.tensorboard_dir)) as tb, \
            profiling.enable_nan_debugging(cfg.debug_nans):
        for item in feed:
            if it >= max_iter:
                break
            if mesh.any(sig.requested):
                ckptlib.save_checkpoint(save_path + ".preempt", state())
                mesh.barrier()
                if verbose and writer:
                    print(f"preemption checkpoint written at iter {it}")
                break
            model.freeze_encoder = encoder_frozen(cfg, it, frozen_until)
            with timer:
                metrics = run_step(item)
                last_loss = float(metrics["loss"])
            step_ms = timer.last_ms
            it += 1
            if it % pad == 0:
                loss_hist.append(it, last_loss, step_ms)
                loss_hist.flush()
                tb.scalar("train/loss", last_loss, it)
                tb.scalar("train/step_ms", step_ms, it)
                if verbose and writer:
                    print(f"iter {it}/{max_iter} loss {last_loss:.4f} "
                          f"({step_ms:.1f} ms)")
            if it % eval_every == 0 or it == max_iter:
                if not writer:
                    mesh.barrier()
                    continue
                results = evaluate(1, eval_loss_fn=eval_loss)
                is_best = res_hist.append(it, results)
                res_hist.flush()
                tb.scalars(results.get("ap_results", {}), it, prefix="val/")
                tb.flush()
                if verbose:
                    print(f"eval@{it}: {results['ap_results']} "
                          f"best={is_best}")
                if is_best:
                    ckptlib.save_checkpoint(save_path, state())
                mesh.barrier()
    final = {}
    if loader.split_ix[2] and writer:
        final["greedy"] = evaluate(2, return_records=True)
        if cfg.use_beam:
            for k in range(1, 6):
                final[f"beam_{k}"] = evaluate(2, use_beam=True, beam_size=k,
                                              return_records=True)
    return {"iters": it, "max_iter": max_iter, "final_loss": last_loss,
            "best_val_score": res_hist.best_score,
            "best_iter": res_hist.best_iter, "final_test": final,
            "loss_file": loss_file, "result_file": result_file,
            "save_path": save_path, "model": model, "optimizer": optimizer,
            "loader": loader}
