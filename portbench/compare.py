"""The numbers that decide `correct`, each a gap between what the timed
path produced and what the reference makes of the same inputs."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable

import torch


def rel(got: float, want: float) -> float:
    """|got - want| relative to |want|."""
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip: Iterable[str] = ()) -> Dict[str, float]:
    """Each leaf's gap between its two norms against the larger of the
    reference's norm of that leaf and of the median leaf (the median over
    the reference's nonzero norms), for the leaves not in `skip`."""
    if set(got) != set(want):
        raise KeyError(f"leaves differ: {sorted(set(got) ^ set(want))}")
    pool = [v for v in want.values() if v > 0]
    med = statistics.median(pool) if pool else 0.0
    skip = set(skip)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in want if k not in skip}



def logit_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the best logit at its
    position: logits (B, L, V), tokens (B, L) -> (B, L), 0 where the
    served token is the best."""
    best = logits.max(-1).values
    return best - logits.gather(-1, tokens.long()[..., None])[..., 0]
