"""Vocabulary and tokenization (copy of
`imagecaptioning_tpu/data/tokenizer.py`): `words_preprocess`, the
min-count `build_vocab` with `<UNK>`, the 1-indexed dict layout
(`my_model_preprocess.py:90-131`) and `Vocab`, which loads the dicts
JSON, builds a vocabulary from captions, encodes captions and decodes
token ids. Dicts JSON files are shared with the JAX package and the
reference pipeline. Token ids (AlexCap family and the GT LSTM head,
`AlexCap/LanguageModule.py:39-41`): NULL = 0, START = V + 1,
END = V + 2, embedding table size V + 3.
"""

from __future__ import annotations

import string
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

_REPLACEMENTS = {
    "\u00bd": "half",     # ½
    "\u2014": "-",        # —
    "\u2122": "",         # ™
    "\u00a2": "cent",     # ¢
    "\u00e7": "c",        # ç
    "\u00fb": "u",        # û
    "\u00e9": "e",        # é
    "\u00b0": " degree",  # °
    "\u2026": "",         # …
}
_PUNC_TABLE = str.maketrans("\u00e8", "e", string.punctuation)


def words_preprocess(phrase: str) -> List[str]:
    """Lowercase, normalize a fixed set of unicode chars, strip ASCII
    punctuation (è→e), split on whitespace. Bit-compatible with the
    reference tokenizer."""
    for k, v in _REPLACEMENTS.items():
        phrase = phrase.replace(k, v)
    return str(phrase).lower().translate(_PUNC_TABLE).split()


def build_vocab(token_lists: Iterable[Sequence[str]],
                min_token_instances: int = 15,
                verbose: bool = False) -> set:
    """Min-count vocab filter; adds '<UNK>' iff any token was dropped
    (reference `my_model_preprocess.py:90-112`)."""
    counter: Counter = Counter()
    n_lists = 0
    for tokens in token_lists:
        if tokens is not None:
            counter.update(tokens)
            n_lists += 1
    vocab = {t for t, c in counter.items() if c >= min_token_instances}
    if len(vocab) < len(counter):
        vocab.add("<UNK>")
    if verbose:
        print(f"Keeping {len(vocab)} / {len(counter)} tokens "
              f"from {n_lists} captions")
    return vocab


def build_vocab_dict(vocab: Iterable[str]):
    """1-indexed token maps, in sorted order (the JAX package's choice;
    the reference iterates a `set`)."""
    token_to_idx: Dict[str, int] = {}
    idx_to_token: Dict[str, str] = {}
    for next_idx, token in enumerate(sorted(vocab), start=1):
        token_to_idx[token] = next_idx
        idx_to_token[str(next_idx)] = token
    return token_to_idx, idx_to_token


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
    def from_captions(cls, captions: Iterable[str],
                      min_token_instances: int = 15) -> "Vocab":
        token_lists = [words_preprocess(c) for c in captions]
        t2i, i2t = build_vocab_dict(build_vocab(token_lists,
                                                min_token_instances))
        return cls(t2i, i2t)

    @classmethod
    def from_dicts_json(cls, info: Dict) -> "Vocab":
        return cls(info["token_to_idx"], info["idx_to_token"])

    def encode_caption(self, caption: str, seq_length: int) -> np.ndarray:
        """Caption → int32 row of length seq_length, 0-padded, unknown
        tokens → '<UNK>' id (reference `encode_captions`,
        `my_model_preprocess.py:114-131`)."""
        unk = self.token_to_idx.get("<UNK>")
        row = np.zeros(seq_length, dtype=np.int32)
        for i, tok in enumerate(words_preprocess(caption)[:seq_length]):
            idx = self.token_to_idx.get(tok, unk)
            if idx is None:
                raise KeyError(f"token {tok!r} not in vocab and no <UNK>")
            row[i] = idx
        return row

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
