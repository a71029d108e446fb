"""The AlexCap optimizer — port of `imagecaptioning_tpu/train/optim.py`
(`warmup_cosine`, `gate_until`, `make_optimizer`, with `optax.MultiSteps`
as `Accumulating`) for the four families.

The JAX chain is: global-norm clip over every gradient → two groups, the
encoder (`encoder`: the CNN trunk `features`, or the ViT's `encoder_vit`)
and the rest (`head`) → the learning rate, constant or `warmup_cosine`
on global time (`train_LSTM.py:57-75`). Each group is:
- LSTM families: Adam with the L2 decay added to the gradient before the
  moments (torch `Adam(weight_decay=...)`, `train_LSTM.py:59`);
- Transformer and ViT: AdamW, the decay decoupled: update = −lr·(m̂ /
  (√v̂ + ε) + wd·p) (`train_Transformer.py:72-83`).

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
- A hard-zero encoder group (optax's `set_to_zero`: no update, no
  decay, no state) is the encoder left out of every group; its gradients
  still enter the global norm. That is the trunk with
  `finetune_cnn=False`; the Transformer's trunk for the whole run (the
  reference's encoder group has base lr 0, which LambdaLR scales, and
  lr 0 kills the AdamW decay too, `train_Transformer.py:79-83`), though
  after the finetune boundary it runs in training mode and its gradient
  enters the clip; and the ViT's encoder with `trained_encoder`
  (`requires_grad=False` for the whole run, `VitbModel.py:162-166`).
  Without it, the ViT's encoder follows the LSTM's gate.
- `grad_accum_steps` = k > 1 is optax's `MultiSteps` around the whole
  chain (`Accumulating`): k micro-gradients averaged by optax's running
  mean, the mean through the clip, the gate and Adam once per window,
  the weights and moments untouched in between. Schedules and the gate
  count applied updates: the driver passes `total_steps` in them and
  puts the finetune boundary on a window's edge.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch.models.captioners import encoder_always_frozen

ENCODER_MODULES = ("features", "encoder_vit")


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


def applied_updates(micro_steps: int, every: int) -> int:
    """The updates that `micro_steps` make at `every` micro-steps an
    update, a partial window counted: a horizon or boundary in micro-steps
    (the drivers' loop count) in the units of the schedules and gates."""
    return -(-micro_steps // max(every, 1))


class Accumulating:
    """optax's `MultiSteps` (mean of k micro-gradients) for a torch
    optimizer; a mixin before its class, with `every` = k and
    `accumulated`, the (name, parameter) pairs whose gradients it averages
    — every trained one, the clip's too where they are in no group.

    After each micro-step's backward, `accumulate()` folds each `.grad`
    into its running mean as optax does, acc + (g − acc) / (n + 1) (a
    missing gradient is optax's zero where the window has a mean, else it
    stays missing); at the k-th micro-step it puts the means in `.grad`
    and returns True, for the caller to clip and `step()`; before, it
    clears `.grad` and returns False: nothing else changes. The
    micro-step count and the means are in `state_dict()`, so a run saved
    mid-window resumes bitwise."""

    def __init__(self, *args, every: int = 1, accumulated=(), **kw):
        super().__init__(*args, **kw)
        self.every = max(int(every), 1)
        self.accumulated = dict(accumulated)
        self.mini_step = 0
        self.means: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def accumulate(self) -> bool:
        if self.every == 1:
            return True
        n = self.mini_step
        # CUDA divides by a Python scalar as a multiply by its reciprocal,
        # inexact at n + 1 = 3; a divisor tensor on the device divides
        counts: Dict[tuple, torch.Tensor] = {}

        def count(t: torch.Tensor) -> torch.Tensor:
            key = (t.device, t.dtype)
            if key not in counts:
                counts[key] = torch.tensor(n + 1, dtype=t.dtype,
                                           device=t.device)
            return counts[key]
        for name, p in self.accumulated.items():
            acc = self.means.get(name)
            if p.grad is None:
                if acc is not None:             # acc + (0 - acc) / (n + 1)
                    acc.sub_(acc / count(acc))
                continue
            if acc is None:
                acc = self.means[name] = torch.zeros_like(p.grad)
            acc.add_((p.grad - acc) / count(acc))
            p.grad = None
        self.mini_step = n + 1
        if self.mini_step < self.every:
            return False
        for name, acc in self.means.items():
            self.accumulated[name].grad = acc
        self.mini_step, self.means = 0, {}
        return True

    def state_dict(self):
        sd = super().state_dict()
        sd["accumulation"] = {"mini_step": self.mini_step,
                              "means": dict(self.means)}
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        acc = state_dict.pop("accumulation", {"mini_step": 0, "means": {}})
        super().load_state_dict(state_dict)
        self.mini_step = int(acc["mini_step"])
        self.means = {k: v.to(self.accumulated[k].device, copy=True)
                      for k, v in acc["means"].items()}


class _Scheduled:
    """A torch optimizer whose groups' lr follows `schedule` over the
    updates taken, the count kept in each group (`updates`) so that a
    checkpoint resumes on the same lr."""

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


class AlexAdam(Accumulating, _Scheduled, torch.optim.Adam):
    """torch Adam (additive L2 before the moments), scheduled."""


class AlexAdamW(Accumulating, _Scheduled, torch.optim.AdamW):
    """torch AdamW (decoupled decay), scheduled."""


def trains_encoder(cfg) -> bool:
    """Whether the encoder has a group of its own: `finetune_cnn`, except
    the Transformer's trunk and a `trained_encoder` ViT, which are a hard
    zero for the whole run."""
    if cfg.model_type == "transformer" or encoder_always_frozen(cfg):
        return False
    return cfg.finetune_cnn


def make_optimizer(cfg, model: torch.nn.Module, total_steps: int):
    """The update chain of a CaptionConfig over `model`: an `AlexAdam`
    (LSTM families) or `AlexAdamW` (Transformer, ViT) with groups `head`
    and, where `trains_encoder`, `encoder` (`features.*` or
    `encoder_vit.*`), each with its parameter names, accumulating
    `grad_accum_steps` micro-steps over every trained parameter of
    `model`. `total_steps` counts applied updates. The gate's boundary is
    the driver's: it freezes the encoder's gradient until then."""
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
    if trains_encoder(cfg) and named["encoder"]:
        groups.append({"group": "encoder",
                       "names": [n for n, _ in named["encoder"]],
                       "params": [p for _, p in named["encoder"]]})
    adam = (AlexAdamW if cfg.model_type in ("transformer", "vitb")
            else AlexAdam)
    return adam(groups, schedule, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
                weight_decay=cfg.weight_decay, every=cfg.grad_accum_steps,
                accumulated=[(n, p) for n, p in model.named_parameters()
                             if p.requires_grad])


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
