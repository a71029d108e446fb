"""AlexCap train and eval steps — port of `imagecaptioning_tpu/train/
step.py` (`make_train_step`, `make_eval_step`; `create_train_state` is the
model's and the optimizer's construction in the driver).

One step: uint8 images → `resnet_v2_preprocess` on the card → forward in
training mode (BatchNorm on batch statistics and its running statistics
updated while the encoder trains) → smoothed cross-entropy → backward →
global-norm clip → Adam. It returns the loss and the global norm of the
gradients before the clip, as 0-d tensors that are not synchronised.
Dropout masks draw from the trainer's generator.

Under gradient accumulation (the optimizer's `every` = k > 1, optax's
`MultiSteps`) a call is a micro-step: backward on every call, the clip
and the update once a window, over the mean of its k gradients; each
call returns its own loss and gradient norm, as JAX's step does.

Data-parallel (`dp`, a `parallel.mesh.DataParallel`): the images and
captions are this rank's rows of the global batch; the forward, backward
and update run under `mesh.active(dp)`, so the loss is this rank's part
of the global mean, BatchNorm takes the global batch's statistics and
the dropout masks are this rank's rows of the global batch's. Each call
sums its gradients over the data ranks right after the backward (one
coalesced `reduce_grads`), before the norm and before the optimizer
folds them into its window: the order of JAX's sharded step, whose
`MultiSteps` sees the global batch's gradient. So every k, every world
size and a split over 'model' (each shard's squares summed over that
axis, `optim.global_norm`) take the same line for the norm, every rank
holds the same window and takes the same update, and a call on n > 1
ranks costs one gradient all-reduce, k an applied update. The returned
loss and gradient norm are the global batch's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from imagecaptioning_tpu_torch.models.api import make_forward_fn
from imagecaptioning_tpu_torch.parallel import mesh
from imagecaptioning_tpu_torch.train import optim


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    generator: Optional[torch.Generator] = None,
                    preprocess: Optional[Callable] = None,
                    clip_norm: Optional[float] = None,
                    dp: Optional[mesh.DataParallel] = None) -> Callable:
    """(images (B, H, W, 3), gt (B, T)) → {"loss", "grad_norm"}. With
    `preprocess` the images are uint8 and go through it first; with
    `clip_norm` the gradients are clipped to that global norm; with `dp`
    the batch is this rank's rows (module docstring)."""
    forward = make_forward_fn(model)
    params = [p for p in model.parameters() if p.requires_grad]
    dp = dp or mesh.IDENTITY

    def train_step(images, gt) -> Dict[str, torch.Tensor]:
        with mesh.active(dp):
            x = preprocess(images) if preprocess is not None else images
            model.train()
            loss, _ = forward(x, gt, generator=generator, train=True)
            # every parameter's: a trunk outside the optimizer (finetune_cnn
            # off) still has gradients, for the global norm
            model.zero_grad(set_to_none=True)
            loss.backward()
            dp.reduce_grads(p.grad for p in params)    # the global batch's
            gnorm = optim.global_norm(params)
            if optimizer.accumulate():
                if clip_norm is not None:  # the norm of the window's mean
                    optim.clip_by_global_norm_(
                        params, clip_norm,
                        gnorm if optimizer.every == 1 else None)
                optimizer.step()
        return {"loss": dp.all_sum(loss.detach()), "grad_norm": gnorm}
    return train_step


def make_eval_step(model) -> Callable:
    """(preprocessed images, gt) → the eval-mode loss (no dropout, running
    statistics, no update), a 0-d tensor."""
    forward = make_forward_fn(model)

    @torch.no_grad()
    def eval_step(images, gt) -> torch.Tensor:
        model.eval()
        return forward(images, gt, train=False)[0]
    return eval_step
