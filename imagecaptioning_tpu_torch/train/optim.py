"""The AlexCap optimizer — port of `imagecaptioning_tpu/train/optim.py`
(`warmup_cosine`, `gate_until`, `make_optimizer`) for the LSTM families.

The JAX chain is: global-norm clip over every gradient → two groups, the
CNN trunk (`encoder`) and the rest (`head`), each Adam with the L2 decay
added to the gradient before the moments (torch `Adam(weight_decay=...)`,
`train_LSTM.py:59`) → the learning rate, constant or `warmup_cosine` on
global time (`train_LSTM.py:57-75`).

- The clip is `clip_by_global_norm_`, which the train step calls over the
  model's gradients before the update (optax's formula: scaled to the
  norm only where the norm is larger).
- `gate_until` keeps the encoder's Adam state and step count untouched
  until `finetune_start_step`. torch's Adam skips a parameter whose
  `.grad` is None and creates its state at its first step with one; the
  frozen phase gives the trunk no gradient (the model runs it under
  `torch.no_grad()`), so the encoder's moments and bias-correction count
  start at the boundary, as the gate's do. The lr schedule keeps global
  time for both groups: `AlexAdam` sets each group's lr from the count of
  updates taken, which it keeps in its state dict.
- `finetune_cnn=False` leaves the trunk out of every group (optax's
  `set_to_zero`); its gradients still enter the global norm.
The Transformer and ViT families' AdamW groups come with Slice E.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

ENCODER_MODULES = ("features",)


def warmup_cosine(lr: float, min_lr: float, warmup_steps: int,
                  total_steps: int) -> Callable[[int], float]:
    """Step → lr: linear warmup 0 → lr over `warmup_steps`, then cosine
    decay lr → min_lr over the rest (optax's `join_schedules` of
    `linear_schedule` and `cosine_decay_schedule(alpha=min_lr/lr)`, in
    fp32 as optax computes it)."""
    warmup_steps = max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)
    f32 = np.float32

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = f32(1.0) - f32(step) / f32(warmup_steps)
            return float(f32(-lr) * frac + f32(lr))
        count = f32(min(step - warmup_steps, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * count
                                                 / f32(decay_steps)))
        alpha = f32(min_lr / lr)
        return float(f32(lr) * ((f32(1.0) - alpha) * cosine + alpha))
    return schedule


class AlexAdam(torch.optim.Adam):
    """torch Adam (additive L2 before the moments) whose groups' lr
    follows `schedule` over the updates taken, the count kept in each
    group (`updates`) so that a checkpoint resumes on the same lr."""

    def __init__(self, groups, schedule: Callable[[int], float],
                 betas, eps: float, weight_decay: float):
        super().__init__(groups, lr=schedule(0), betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self.schedule = schedule
        for group in self.param_groups:
            group.setdefault("updates", 0)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.schedule(group["updates"])
            group["updates"] += 1
        return super().step(closure)


def make_optimizer(cfg, model: torch.nn.Module,
                   total_steps: int) -> AlexAdam:
    """The update chain of a CaptionConfig over `model` (an
    `LSTMCaptioner`): groups `head` and, when `finetune_cnn`, `encoder`
    (the trunk, `features.*`), each with its parameter names. The gate's
    boundary is the driver's: it freezes the encoder's gradient until
    then."""
    if cfg.model_type in ("transformer", "vitb"):
        raise NotImplementedError(
            f"the {cfg.model_type} family's AdamW groups are not ported yet "
            f"(ROADMAP.md, Queue 1, Slice E — the other caption families)")
    if cfg.grad_accum_steps > 1:
        raise NotImplementedError(
            "grad_accum_steps > 1 (optax.MultiSteps) is not ported yet "
            "(ROADMAP.md, Queue 1, item 2)")
    if cfg.use_scheduler:
        warmup = max(2 * total_steps // max(cfg.num_epochs, 1), 1)
        schedule = warmup_cosine(cfg.learning_rate, cfg.min_lr, warmup,
                                 total_steps)
    else:
        schedule = lambda step: cfg.learning_rate      # noqa: E731
    named = {"head": [], "encoder": []}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        named["encoder" if top in ENCODER_MODULES else "head"].append(
            (name, p))
    groups = [{"group": "head", "names": [n for n, _ in named["head"]],
               "params": [p for _, p in named["head"]]}]
    if cfg.finetune_cnn and named["encoder"]:
        groups.append({"group": "encoder",
                       "names": [n for n, _ in named["encoder"]],
                       "params": [p for _, p in named["encoder"]]})
    return AlexAdam(groups, schedule, betas=(cfg.beta1, cfg.beta2),
                    eps=cfg.eps, weight_decay=cfg.weight_decay)


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the parameters' gradients (fp32, fp64 for
    fp64 gradients; those without a gradient count as zeros, as optax's
    zeros for a frozen encoder do)."""
    grads = [p.grad.to(torch.promote_types(p.grad.dtype, torch.float32))
             for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> None:
    """optax's `clip_by_global_norm`, in place: where the global norm is
    `max_norm` or more, every gradient becomes g / norm · max_norm (else
    g / 1 · 1, the same bits), with no read of the norm on the host."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if norm is None:
        norm = global_norm(params)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(norm),
                                           torch.full_like(norm, max_norm)))
