"""Loss functions — port of `imagecaptioning_tpu/ops/losses.py`,
behaviour-compatible with the reference's criteria:

- `smoothed_cross_entropy`: the AlexCap families' criterion, torch
  `nn.CrossEntropyLoss(ignore_index=0, label_smoothing=0.1)` over the
  flattened logits (`AlexCap/CustomLoss.py:7-14`), written out as the JAX
  package writes it;
- `temporal_cross_entropy`: the GT captioner's criterion, DenseCap's
  masked gather CE (`DenseCap/densecap/LSTMLoss.py:4-26`);
- `sum_cross_entropy`: DenseCap's `CustomCrossEntropyLoss`, the RPN's
  captioning loss (`LSTMLoss.py:28-40`);
- `temporal_sum_cross_entropy` and `log_softmax_nll`: DenseCap's
  `TemporalCrossEntropyLoss` and `OurCrossEntropyCriterion`, declared in
  the reference and on none of its paths (nor the port's);
- `logistic_criterion`: the stable objectness loss
  (`DenseCap/densecap/LogisticCriterion.py:17-30`);
- `smooth_l1` and `box_regression_loss`: the masked smooth-L1 on box
  transforms (`DenseCap/densecap/BoxRegressionCriterion.py`);
- `doubly_stochastic_regularizer`: the attention family's penalty on
  attention mass (`AlexCap/LSTMwAttentionModel.py:59-71`).

All compute in fp32 whatever the inputs' dtype. Softplus is written as
`logaddexp(x, 0)`, which is `jax.nn.softplus`: `F.softplus` turns into
the identity above 20.
"""

from __future__ import annotations

from typing import Optional

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           ignore_index: int = 0,
                           label_smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed CE, mean over the positions whose target is not
    `ignore_index`: per position (1 − ε)·nll + ε·mean_c(−log p_c), in fp32
    (fp64 for fp64 logits)."""
    c = logits.shape[-1]
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logp = torch.log_softmax(logits.reshape(-1, c), dim=-1)
    t = targets.reshape(-1).long()
    nll = -logp.gather(-1, t[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    per = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    mask = (t != ignore_index).float()
    return (per * mask).sum() / mask.sum().clamp_min(1.0)


def temporal_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           null_token: int = 0) -> torch.Tensor:
    """Masked CE averaged over non-NULL timesteps (no smoothing):
    logits (..., V), targets (...)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    mask = (targets != null_token).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def sum_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                      null_token: int = 0) -> torch.Tensor:
    """CE summed over the non-NULL positions, divided by their count
    (`size = target.nonzero().numel() / 2` for a 2-D target): logits
    (..., V) flattened against targets (...)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float().reshape(-1, c), dim=-1)
    t = targets.reshape(-1).long()
    nll = -logp.gather(-1, t[:, None])[:, 0]
    mask = (t != null_token).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def temporal_sum_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                               null_token: int = 0,
                               batch_average: bool = True,
                               time_average: bool = False) -> torch.Tensor:
    """Masked NLL of logits (N, T, V) against targets (N, T), SUMMED, then
    divided by N (`batch_average`) and/or T (`time_average`), not by the
    non-NULL count (`LSTMLoss.py:4-26`)."""
    n, t = targets.shape
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    total = torch.where(targets != null_token, nll, 0.0).sum()
    if batch_average:
        total = total / n
    if time_average:
        total = total / t
    return total


def log_softmax_nll(logits: torch.Tensor, targets: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LogSoftmax + NLL with optional per-class weights, torch
    `NLLLoss(weight=w)`'s mean: the weighted sum of per-sample NLL over
    the summed weights of the realized targets
    (`OurCrossEntropyCriterion.py:4-14`)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float().reshape(-1, c), dim=-1)
    t = targets.reshape(-1).long()
    nll = -logp.gather(-1, t[:, None])[:, 0]
    if weights is None:
        return nll.mean()
    w = weights.float()[t]
    return (nll * w).sum() / w.sum().clamp_min(1e-12)


def doubly_stochastic_regularizer(alphas: torch.Tensor) -> torch.Tensor:
    """((1 − Σ_t α_{t,p})²) averaged over batch and positions, from alphas
    (B, T, P), in fp32 (fp64 for fp64 alphas): attention mass near 1 at
    every position over the caption."""
    a = alphas.to(torch.promote_types(alphas.dtype, torch.float32))
    return ((1.0 - a.sum(dim=1)) ** 2).mean()


def logistic_criterion(scores: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """mean(log(1 + exp(−y·s))) with y = 2·label − 1, labels in {0, 1}:
    sigmoid BCE, stable."""
    s = scores.float().reshape(-1)
    y = 2.0 * labels.float().reshape(-1) - 1.0
    return softplus(-y * s).mean()


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def box_regression_loss(pred_trans: torch.Tensor, target_trans: torch.Tensor,
                        weight: float = 1.0,
                        valid_mask: Optional[torch.Tensor] = None,
                        max_trans: float = 10.0) -> torch.Tensor:
    """Smooth-L1 between predicted and target transforms (..., P, 4), per
    slab → (...). Rows with any |target| > `max_trans` are zeroed (the
    reference's "DIRTY HACK", BoxRegressionCriterion.py:18-25) but still
    count in the denominator, as the reference's mean over all elements
    counts them; padding rows (`valid_mask` False, the static shapes'
    addition) do not."""
    pred = pred_trans.float()
    target = target_trans.float()
    sane = (target.abs() <= max_trans).all(dim=-1)
    if valid_mask is not None:
        sane = sane & valid_mask
        denom = valid_mask.sum(-1).clamp_min(1)
    else:
        denom = pred.shape[-2]
    per_box = smooth_l1(pred - target).mean(dim=-1)
    return weight * (per_box * sane).sum(-1) / denom
