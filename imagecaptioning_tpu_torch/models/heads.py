"""Caption heads — port of `LanguageHead` and `AttentionHead` in
`imagecaptioning_tpu/models/heads.py:31-208`, and the transformer head
that the GT captioner and the AlexCap Transformer family share.

`LanguageHead` (the LSTM head):

Submodule names follow the reference (`AlexCap/LanguageModule.py`):
`image_encoder.encode`, `lookup_table`, `lstm`, `rnn.linear`. The image
code is fed THROUGH the LSTM as a one-step prefix from a zero state
("image as prefix"); it is not used as h0. By default this is the GT
variant: the dropout rides inside the LSTM (between layers) and there is no
dropout after it (`AlexDenseLangage.py:53-55`). The AlexCap captioners set
`output_dropout`, which adds the reference's Dropout after the LSTM
(`LanguageModule.py:48`), and feed their image's grid vectors (49 ×
2048 for ResNet-101 at 224²) through the LSTM as the prefix.

`AttentionHead` (Show-Attend-Tell, `AlexCap/AttentionLanguageModule.py`):
h0, c0 = tanh(init_h/init_c(mean of the grid vectors)); each step
attends with e = v·tanh(W·feat + U·h) + b_v, softmax over the P
positions, gates the context by sigmoid(f_beta·h), feeds concat(emb,
gate·ctx) to an `nn.LSTMCell` (`lstm`) and reads the logits off h
(`deep_output`, dropout on h before it). The embedding half of the
cell's input product is carry-independent: teacher-forced, it is one
product over all T+1 steps before the loop; W·feat is computed once a
call (`attention_keys`).

`TransformerHead` (reference `AlexTransformer` / the `Transformer` of
`TransformerModule.py`): `fc.0` and a ReLU, an `Encoder` over
`patch_length` positions, a `Decoder` over the V+3 table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioning_tpu_torch.ops.rnn import LSTM, LSTMState, lstm_gates_step
from imagecaptioning_tpu_torch.ops.transformer import Decoder, Encoder, dropout


class LanguageHead(nn.Module):
    """LSTM caption head over a V+3 vocabulary table (NULL/START/END)."""

    def __init__(self, vocab_size: int, embedding_size: int, rnn_size: int,
                 num_layers: int = 1, dropout: float = 0.0,
                 image_dim: int = 4096, output_dropout: bool = False):
        super().__init__()
        self.out_drop = dropout if output_dropout else 0.0
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
        and [START; gt] tokens (B, T+1). The LSTM's inter-layer dropout and
        the output dropout act when `train` (default: the module's mode),
        as flax's `deterministic=not train`, with masks drawn from
        `generator`; the warm-up pass never drops."""
        state = self._warm_state(image_vectors)
        out, _ = self.lstm(self.lookup_table(tokens_with_start), state,
                           generator=generator, train=train)
        train = self.training if train is None else train
        if train and self.out_drop > 0:
            keep = 1.0 - self.out_drop
            out = out * torch.bernoulli(torch.full_like(out, keep),
                                        generator=generator) / keep
        return self.rnn["linear"](out)

    def init_state(self, image_vectors: torch.Tensor) -> LSTMState:
        return self._warm_state(image_vectors)

    def step(self, tokens: torch.Tensor, state: LSTMState):
        """One decode step: (B, 1) tokens + state → ((B, V+3), state)."""
        out, state = self.lstm(self.lookup_table(tokens), state, train=False)
        return self.rnn["linear"](out)[:, 0], state


class AttentionHead(nn.Module):
    """Show-Attend-Tell LSTM head over a V+3 vocabulary table (module
    docstring); fp32, or the dtype of its parameters."""

    def __init__(self, vocab_size: int, embedding_size: int,
                 encoder_dim: int, rnn_size: int, dropout: float = 0.5):
        super().__init__()
        v3, w, d, h = vocab_size + 3, embedding_size, encoder_dim, rnn_size
        self.embedding_size = w
        self.dropout = dropout
        self.init_h = nn.Linear(d, h)
        self.init_c = nn.Linear(d, h)
        self.embedding = nn.Embedding(v3, w)
        self.attention = nn.ModuleDict({"W": nn.Linear(d, h),
                                        "U": nn.Linear(h, h),
                                        "v": nn.Linear(h, 1)})
        self.f_beta = nn.Linear(h, d)
        self.deep_output = nn.Linear(h, v3)
        self.lstm = nn.LSTMCell(w + d, h)

    def init_state(self, feats: torch.Tensor) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
        """(h, c), each (B, H), from the grid vectors (B, P, D)."""
        avg = feats.mean(dim=1)
        return torch.tanh(self.init_h(avg)), torch.tanh(self.init_c(avg))

    def attention_keys(self, feats: torch.Tensor) -> torch.Tensor:
        """W·feat (B, P, H): the same at every step of a call."""
        return self.attention["W"](feats)

    def _pre_emb(self, emb: torch.Tensor) -> torch.Tensor:
        """The embedding columns of the cell's input product, plus b_ih."""
        return F.linear(emb, self.lstm.weight_ih[:, :self.embedding_size],
                        self.lstm.bias_ih)

    def _cell(self, w_s, feats, pre_emb, state,
              generator: Optional[torch.Generator] = None,
              train: bool = False):
        """One step → (logits (B, V+3), alpha (B, P), (h, c))."""
        h, c = state
        att = self.attention
        e = att["v"](torch.tanh(w_s + att["U"](h)[:, None]))[..., 0]
        alpha = torch.softmax(e, dim=1)
        context = torch.bmm(alpha[:, None], feats)[:, 0]
        gate = torch.sigmoid(self.f_beta(h))
        gates_x = pre_emb + F.linear(
            gate * context, self.lstm.weight_ih[:, self.embedding_size:])
        h, c = lstm_gates_step(gates_x, self.lstm.weight_hh,
                               self.lstm.bias_hh, h, c)
        logits = self.deep_output(dropout(h, self.dropout, train, generator))
        return logits, alpha, (h, c)

    def forward(self, feats: torch.Tensor, tokens_with_start: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = False):
        """Teacher-forced (logits (B, T+1, V+3), alphas (B, T+1, P)) from
        grid vectors (B, P, D) and [START; gt] tokens (B, T+1); dropout on
        h acts when `train`, its masks from `generator`."""
        state = self.init_state(feats)
        pre = self._pre_emb(self.embedding(tokens_with_start))
        w_s = self.attention_keys(feats)
        logits, alphas = [], []
        for t in range(pre.shape[1]):
            lg, alpha, state = self._cell(w_s, feats, pre[:, t], state,
                                          generator, train)
            logits.append(lg)
            alphas.append(alpha)
        return torch.stack(logits, dim=1), torch.stack(alphas, dim=1)

    def step(self, feats: torch.Tensor, tokens: torch.Tensor, state,
             w_s: torch.Tensor):
        """One decode step of tokens (B, 1) → (logits, alpha, state), with
        `w_s` from `attention_keys`."""
        pre = self._pre_emb(self.embedding(tokens[:, 0]))
        return self._cell(w_s, feats, pre, state)


class TransformerHead(nn.Module):
    """`fc.0` (image_dim → E) and a ReLU, an Encoder over `patch_length`
    positions, and a Decoder over the V+3 table with `seq_length + 1`
    positions. The GT captioner's (one position, no embedding scale) and
    the AlexCap Transformer's (the 7×7 or 14×14 grid, `emb·sqrt(E)`)."""

    def __init__(self, vocab_size: int, seq_length: int, embed_size: int,
                 num_layers: int, heads: int, dropout: float,
                 image_dim: int = 4096, patch_length: int = 1,
                 forward_expansion: int = 4, scale_embedding: bool = False):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(image_dim, embed_size), nn.ReLU())
        self.encoder = Encoder(embed_size, num_layers, heads,
                               forward_expansion, dropout, patch_length)
        self.decoder = Decoder(vocab_size + 3, embed_size, num_layers, heads,
                               forward_expansion, dropout,
                               max_length=seq_length + 1,
                               scale_embedding=scale_embedding)

    def encode(self, codes: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Codes (B, P, image_dim) → encoder output (B, P, E)."""
        return self.encoder(self.fc(codes), train, generator)

    def forward(self, codes: torch.Tensor, tokens_with_start: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = False, return_alphas: bool = False):
        """Teacher-forced logits (B, T+1, V+3) under the causal × non-NULL
        key mask; with `return_alphas`, also the last decoder layer's
        cross-attention (B, h, T+1, P)."""
        enc = self.encode(codes, train, generator)
        return self.decoder(tokens_with_start, enc, train, generator,
                            return_alphas)
