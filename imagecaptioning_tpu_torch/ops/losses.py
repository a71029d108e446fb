"""Caption loss — port of `temporal_cross_entropy` in
`imagecaptioning_tpu/ops/losses.py:51-61`, the GT captioner's criterion
(DenseCap `TemporalCrossEntropyLoss` behaviour). The other criteria of
that module come with the slices that use them (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch


def temporal_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           null_token: int = 0) -> torch.Tensor:
    """Masked CE averaged over non-NULL timesteps (no smoothing), in fp32
    whatever the logits' dtype: logits (..., V), targets (...)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    mask = (targets != null_token).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
