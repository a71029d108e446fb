"""Vocabulary (copy of `Vocab` in `imagecaptioning_tpu/data/tokenizer.py`),
the part serving needs: loading the dicts JSON and decoding token ids.

The 1-indexed `token_to_idx` / `idx_to_token` layout is the reference's
(`my_model_preprocess.py:90-131`), so dicts JSON files are shared with
the JAX package and the reference pipeline. Token ids (AlexCap family
and the GT LSTM head, `AlexCap/LanguageModule.py:39-41`): NULL = 0,
START = V + 1, END = V + 2, embedding table size V + 3. Building a
vocabulary and encoding captions belong to the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class Vocab:
    """Vocabulary with the reference's 1-indexed layout. `vocab_size`
    counts real tokens (len(idx_to_token))."""

    def __init__(self, token_to_idx: Dict[str, int],
                 idx_to_token: Optional[Dict[str, str]] = None):
        self.token_to_idx = dict(token_to_idx)
        if idx_to_token is None:
            idx_to_token = {str(i): t for t, i in token_to_idx.items()}
        # JSON round-trips keys as str; normalize.
        self.idx_to_token = {str(k): v for k, v in idx_to_token.items()}
        self.vocab_size = len(self.idx_to_token)
        self.null_token = 0
        self.start_token = self.vocab_size + 1
        self.end_token = self.vocab_size + 2
        self.num_embeddings = self.vocab_size + 3

    @classmethod
    def from_dicts_json(cls, info: Dict) -> "Vocab":
        return cls(info["token_to_idx"], info["idx_to_token"])

    def decode_row(self, ids: Sequence[int]) -> str:
        """Int ids → string; stops at END or NULL, space-joined
        (reference `decode_sequence`, `LanguageModule.py:52-97`)."""
        words = []
        for idx in ids:
            idx = int(idx)
            if idx == self.end_token or idx == self.null_token:
                break
            if idx == self.start_token:
                words.append("<SOS>")
            else:
                words.append(self.idx_to_token[str(idx)])
        return " ".join(words)

    def decode_sequence(self, seq):
        """Decode 1D (T,), 2D (N, T) or 3D (N, K, T) int arrays (numpy or
        CPU tensors). 1D/2D → list of strings; 3D → list of lists."""
        seq = np.asarray(seq)
        if seq.ndim == 1:
            seq = seq[None]
        if seq.ndim == 3:
            return [[self.decode_row(row) for row in beams]
                    for beams in seq]
        return [self.decode_row(row) for row in seq]
