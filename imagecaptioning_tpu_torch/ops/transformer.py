"""Transformer encoder/decoder of the reference family's math — port of
`imagecaptioning_tpu/ops/transformer.py:37-265`.

The reference's quirks change the trained function, so they are kept:
- scores are scaled by 1/sqrt(embed_size), not 1/sqrt(head_dim), and
  masked scores are filled with -1e20 BEFORE the scaling, in fp32 (a
  fully masked row comes out uniform, never NaN; no -inf, no boolean
  attention mask of a library call);
- q/k/v projections have no bias, `fc_out` has one;
- blocks are post-norm: norm1(attn + query) → dropout → ReLU FFN (4×) →
  norm2(ffn + x) → dropout; a decoder block runs masked self-attention,
  norm(attn + x) → dropout, then a `TransformerBlock` over the encoder
  output;
- LayerNorm epsilon is 1e-6 (flax's default, torch's is 1e-5);
- the decoder adds `position_embedding[t]` to the word embedding and does
  not scale the embedding by sqrt(E) (the GT head's `scale_embedding=
  False`; the AlexCap transformer's sqrt(E) scale comes with its slice).

Dropout acts only when `train` (flax's `deterministic=not train`), its
masks drawn from the `generator` passed in. Module names follow the
reference state-dict (`attention.{values,keys,queries,fc_out}`, `norm1`,
`norm2`, `feed_forward.0/.2`, `norm`, `transformer_block`,
`word_embedding`, `position_embedding`, `fc_out`).

Cached decode (JAX `:77-115`): the cross-attention keys and values of the
encoder output are projected once per decode (`Decoder.init_state`), and
each layer's self-attention keeps preallocated (B, T, h, d) key and value
caches, written in place at step t; step t attends over positions ≤ t
with no key masking (a decoded NULL token is attended to). Plain torch
products and elementwise ops: no TPU kernel sits under them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

NEG_INF = -1e20
LN_EPS = 1e-6
KV = Tuple[torch.Tensor, torch.Tensor]


def make_trg_mask(trg: torch.Tensor) -> torch.Tensor:
    """(N, 1, T, T) causal mask times the outer product of the non-NULL
    key mask (reference `make_trg_mask`). 1 = attend, 0 = masked."""
    n, t = trg.shape
    causal = torch.ones((t, t), dtype=torch.float32, device=trg.device).tril()
    keep = (trg > 0).float()
    return causal * (keep[:, :, None] * keep[:, None, :])[:, None]


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout at rate `p` when `train`, mask from `generator`."""
    if not train or p <= 0:
        return x
    keep = 1.0 - p
    mask = torch.bernoulli(torch.full_like(x, keep), generator=generator)
    return x * mask / keep


class MultiHeadAttention(nn.Module):
    """Reference-math multi-head attention."""

    def __init__(self, embed_size: int, heads: int):
        super().__init__()
        if embed_size % heads:
            raise ValueError(f"embed_size {embed_size} is not a multiple of "
                             f"heads {heads}")
        self.embed_size, self.heads = embed_size, heads
        self.values = nn.Linear(embed_size, embed_size, bias=False)
        self.keys = nn.Linear(embed_size, embed_size, bias=False)
        self.queries = nn.Linear(embed_size, embed_size, bias=False)
        self.fc_out = nn.Linear(embed_size, embed_size)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1, self.heads,
                         self.embed_size // self.heads)

    def project_kv(self, values: torch.Tensor, keys: torch.Tensor) -> KV:
        """(keys, values) projected and split into heads, (N, L, h, d)."""
        return self._split(self.keys(keys)), self._split(self.values(values))

    def attend(self, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               masked: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (N, Tq, E) against projected k/v (N, L, h, d); `masked`
        (True where a score is filled, broadcast to (N, h, Tq, L))."""
        q = self._split(self.queries(query))
        energy = torch.einsum("nqhd,nkhd->nhqk", q, k)
        if masked is not None:
            energy = energy.masked_fill(masked, NEG_INF)
        attn = torch.softmax(energy / math.sqrt(self.embed_size), dim=3)
        out = torch.einsum("nhql,nlhd->nqhd", attn, v)
        return self.fc_out(out.reshape(query.shape[0], -1, self.embed_size))

    def forward(self, values: torch.Tensor, keys: torch.Tensor,
                query: torch.Tensor,
                masked: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.attend(query, *self.project_kv(values, keys), masked)


class TransformerBlock(nn.Module):
    """Post-norm block: x = drop(norm1(attn + q)); drop(norm2(ffn(x) + x))."""

    def __init__(self, embed_size: int, heads: int, dropout: float,
                 forward_expansion: int = 4):
        super().__init__()
        self.attention = MultiHeadAttention(embed_size, heads)
        self.norm1 = nn.LayerNorm(embed_size, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(embed_size, eps=LN_EPS)
        self.feed_forward = nn.Sequential(
            nn.Linear(embed_size, forward_expansion * embed_size), nn.ReLU(),
            nn.Linear(forward_expansion * embed_size, embed_size))
        self.dropout = dropout

    def forward(self, value, key, query, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.finish(self.attention(value, key, query), query, train,
                           generator)

    def finish(self, attn: torch.Tensor, query: torch.Tensor,
               train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The block after its attention: norms, FFN and dropouts."""
        x = dropout(self.norm1(attn + query), self.dropout, train, generator)
        out = self.norm2(self.feed_forward(x) + x)
        return dropout(out, self.dropout, train, generator)


class Encoder(nn.Module):
    """Learned absolute positions over a fixed `patch_length`, then
    `num_layers` TransformerBlocks of self-attention."""

    def __init__(self, embed_size: int, num_layers: int, heads: int,
                 forward_expansion: int, dropout: float, patch_length: int):
        super().__init__()
        self.position_embedding = nn.Embedding(patch_length, embed_size)
        self.layers = nn.ModuleList(
            TransformerBlock(embed_size, heads, dropout, forward_expansion)
            for _ in range(num_layers))
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = x + self.position_embedding.weight[None, :x.shape[1]]
        out = dropout(out, self.dropout, train, generator)
        for layer in self.layers:
            out = layer(out, out, out, train, generator)
        return out


class DecoderBlock(nn.Module):
    """Masked self-attention + post-norm, then a TransformerBlock of
    cross-attention against the encoder output."""

    def __init__(self, embed_size: int, heads: int, forward_expansion: int,
                 dropout: float):
        super().__init__()
        self.attention = MultiHeadAttention(embed_size, heads)
        self.norm = nn.LayerNorm(embed_size, eps=LN_EPS)
        self.transformer_block = TransformerBlock(embed_size, heads, dropout,
                                                  forward_expansion)
        self.dropout = dropout

    def forward(self, x, enc_out, trg_masked, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        query = dropout(self.norm(self.attention(x, x, x, trg_masked) + x),
                        self.dropout, train, generator)
        return self.transformer_block(enc_out, enc_out, query, train,
                                      generator)

    def step(self, x: torch.Tensor, t: int, cache: KV, cross: KV,
             future: torch.Tensor) -> torch.Tensor:
        """One cached decode step of x (B, 1, E) at position t: this step's
        keys and values go into `cache` (each (B, T, h, d)) at t, and the
        scores of the positions after t (`future`, (T,) bool) are masked."""
        att = self.attention
        k, v = att.project_kv(x, x)
        cache[0][:, t] = k[:, 0]
        cache[1][:, t] = v[:, 0]
        query = self.norm(att.attend(x, cache[0], cache[1], future) + x)
        block = self.transformer_block
        return block.finish(block.attention.attend(query, *cross), query)


class Decoder(nn.Module):
    """Token decoder: word embedding + position embedding → DecoderBlocks
    → vocabulary logits."""

    def __init__(self, vocab_out: int, embed_size: int, num_layers: int,
                 heads: int, forward_expansion: int, dropout: float,
                 max_length: int):
        super().__init__()
        self.word_embedding = nn.Embedding(vocab_out, embed_size)
        self.position_embedding = nn.Embedding(max_length, embed_size)
        self.layers = nn.ModuleList(
            DecoderBlock(embed_size, heads, forward_expansion, dropout)
            for _ in range(num_layers))
        self.fc_out = nn.Linear(embed_size, vocab_out)
        self.dropout = dropout
        # row t: the cache positions after step t, masked in its scores
        self.register_buffer(
            "future", torch.ones(max_length, max_length,
                                 dtype=torch.bool).triu(1), persistent=False)

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits (N, T, vocab_out) under `make_trg_mask`
        of `tokens`; the encoder output is attended unmasked."""
        trg_masked = make_trg_mask(tokens) == 0
        x = (self.word_embedding(tokens)
             + self.position_embedding.weight[None, :tokens.shape[1]])
        x = dropout(x, self.dropout, train, generator)
        for layer in self.layers:
            x = layer(x, enc_out, trg_masked, train, generator)
        return self.fc_out(x)

    def init_state(self, enc_out: torch.Tensor
                   ) -> Tuple[List[KV], List[KV]]:
        """Decode state for `enc_out` (B, L, E): (cross, cache). `cross`
        holds each layer's cross-attention (k, v), fixed for the whole
        decode; `cache` each layer's zeroed self-attention (k, v) of
        (B, max_length, h, d)."""
        b, t = enc_out.shape[0], self.position_embedding.num_embeddings
        cross, cache = [], []
        for layer in self.layers:
            cross.append(layer.transformer_block.attention.project_kv(
                enc_out, enc_out))
            k = enc_out.new_zeros((b, t, *cross[-1][0].shape[2:]))
            cache.append((k, torch.zeros_like(k)))
        return cross, cache

    def step(self, cross: List[KV], cache: List[KV], tokens: torch.Tensor,
             t: int) -> torch.Tensor:
        """Logits (B, vocab_out) of tokens (B, 1) at step t; writes this
        step's keys and values into `cache`."""
        x = self.word_embedding(tokens) + self.position_embedding.weight[t]
        future = self.future[t]
        for layer, layer_cache, layer_cross in zip(self.layers, cache, cross):
            x = layer.step(x, t, layer_cache, layer_cross, future)
        return self.fc_out(x)[:, 0]
