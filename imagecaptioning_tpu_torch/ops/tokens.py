"""Token-id conventions and target construction (port of
`imagecaptioning_tpu/ops/tokens.py:26-77`).

The AlexCap family and the GT LSTM head use NULL=0, START=V+1, END=V+2
(LanguageModule.py:39-41). The DenseCap transformers index sos=V-2 and
eos=V-1 over a V+3 table (`TokenSpec.densecap`); the GT transformer head
builds it over V+3, so its ids are the same V+1 and V+2. Its targets scan
for the first NULL from t=0 (`decoder_target(..., scan_from=0)`), the LSTM
head's from t=1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class TokenSpec:
    """Special token ids for a vocabulary of `vocab_size` real tokens."""

    vocab_size: int
    null: int
    start: int
    end: int
    num_embeddings: int

    @classmethod
    def alexcap(cls, vocab_size: int) -> "TokenSpec":
        return cls(vocab_size, 0, vocab_size + 1, vocab_size + 2, vocab_size + 3)

    @classmethod
    def densecap(cls, vocab_size: int) -> "TokenSpec":
        # DenseCap transformers index sos/eos *below* V over a V+3 table.
        return cls(vocab_size, 0, vocab_size - 2, vocab_size - 1, vocab_size + 3)


def decoder_input(gt: torch.Tensor, start_token: int) -> torch.Tensor:
    """[START; gt] of shape (N, T+1) — reference get_target(make_target=False)."""
    start_col = torch.full((gt.shape[0], 1), start_token, dtype=gt.dtype,
                           device=gt.device)
    return torch.cat([start_col, gt], dim=1)


def decoder_target(gt: torch.Tensor, end_token: int,
                   scan_from: int = 1) -> torch.Tensor:
    """gt padded to (N, T+1) with END written at the first NULL position
    at or after `scan_from` — reference get_target(make_target=True).

    Because the pad column is always NULL, a full-length caption gets its
    END at position T, and an empty caption (scan_from=0) at position 0.
    """
    n, t = gt.shape
    padded = torch.cat([gt, gt.new_zeros((n, 1))], dim=1)
    is_null = padded == 0
    if scan_from > 0:
        is_null &= torch.arange(t + 1, device=gt.device) >= scan_from
    # argmax returns the first maximum, as jnp.argmax does
    first_null = is_null.to(torch.int32).argmax(dim=1, keepdim=True)
    return padded.scatter(1, first_null, end_token)


def sequence_mask(targets: torch.Tensor, null_token: int = 0) -> torch.Tensor:
    """Loss mask: positions where the target is not NULL."""
    return targets != null_token


def caption_lengths(gt) -> np.ndarray:
    """Number of non-NULL tokens per row (host-side helper)."""
    return (np.asarray(gt) != 0).sum(axis=1)
