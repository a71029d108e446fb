"""LSTM caption head — port of `LanguageHead` in
`imagecaptioning_tpu/models/heads.py:31-79`.

Submodule names follow the reference (`AlexCap/LanguageModule.py`):
`image_encoder.encode`, `lookup_table`, `lstm`, `rnn.linear`. The image
code is fed THROUGH the LSTM as a one-step prefix from a zero state
("image as prefix"); it is not used as h0. This is the GT variant: the
dropout rides inside the LSTM (between layers) and there is no dropout
after it (`AlexDenseLangage.py:53-55`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioning_tpu_torch.ops.rnn import LSTM, LSTMState


class LanguageHead(nn.Module):
    """LSTM caption head over a V+3 vocabulary table (NULL/START/END)."""

    def __init__(self, vocab_size: int, embedding_size: int, rnn_size: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 image_dim: int = 4096):
        super().__init__()
        self.image_encoder = nn.ModuleDict(
            {"encode": nn.Linear(image_dim, embedding_size)})
        self.lookup_table = nn.Embedding(vocab_size + 3, embedding_size)
        self.lstm = LSTM(embedding_size, rnn_size, num_layers, dropout)
        self.rnn = nn.ModuleDict(
            {"linear": nn.Linear(rnn_size, vocab_size + 3)})

    def _warm_state(self, image_vectors: torch.Tensor) -> LSTMState:
        encoded = F.relu(self.image_encoder["encode"](image_vectors))
        _, state = self.lstm(encoded, train=False)
        return state

    def forward(self, image_vectors: torch.Tensor,
                tokens_with_start: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        """Teacher-forced logits (B, T+1, V+3) from image vectors (B, P, D)
        and [START; gt] tokens (B, T+1). The LSTM's inter-layer dropout acts
        when `train` (default: the module's mode), as flax's
        `deterministic=not train`; the warm-up pass never drops."""
        state = self._warm_state(image_vectors)
        out, _ = self.lstm(self.lookup_table(tokens_with_start), state,
                           generator=generator, train=train)
        return self.rnn["linear"](out)

    def init_state(self, image_vectors: torch.Tensor) -> LSTMState:
        return self._warm_state(image_vectors)

    def step(self, tokens: torch.Tensor, state: LSTMState):
        """One decode step: (B, 1) tokens + state → ((B, V+3), state)."""
        out, state = self.lstm(self.lookup_table(tokens), state, train=False)
        return self.rnn["linear"](out)[:, 0], state
