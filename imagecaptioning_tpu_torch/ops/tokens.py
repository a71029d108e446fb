"""Token-id conventions (port of `imagecaptioning_tpu/ops/tokens.py:26-50`).

The AlexCap family and the GT LSTM head use NULL=0, START=V+1, END=V+2
(LanguageModule.py:39-41). The DenseCap transformers' sos=V-2/eos=V-1
convention comes with the transformer head's slice.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def decoder_input(gt: torch.Tensor, start_token: int) -> torch.Tensor:
    """[START; gt] of shape (N, T+1) — reference get_target(make_target=False)."""
    start_col = torch.full((gt.shape[0], 1), start_token, dtype=gt.dtype,
                           device=gt.device)
    return torch.cat([start_col, gt], dim=1)
