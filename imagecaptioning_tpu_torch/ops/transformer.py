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
- the decoder adds `position_embedding[t]` to the word embedding; the
  AlexCap families scale the embedding by sqrt(E) first (`emb·sqrt(E) +
  pos`, `scale_embedding=True`), the GT head does not.

Dropout acts only when `train` (flax's `deterministic=not train`), its
masks drawn from the `generator` passed in. Module names follow the
reference state-dict (`attention.{values,keys,queries,fc_out}`, `norm1`,
`norm2`, `feed_forward.0/.2`, `norm`, `transformer_block`,
`word_embedding`, `position_embedding`, `fc_out`).

Under `parallel.mesh.shard_params` the projections are split over a
`'model'` axis: each rank computes its heads (the local width over the
head size) against the global 1/sqrt(embed_size) scale, `fc_out` sums
the ranks' parts, and probabilities asked for are gathered over all
heads first.

Cached decode (JAX `:77-115`): the cross-attention keys and values of the
encoder output are projected once per decode (`Decoder.init_state`), and
each layer's self-attention keeps preallocated (B, T, h, d) key and value
caches, written in place at step t; step t attends over positions ≤ t
with no key masking (a decoded NULL token is attended to). Asked for
them, the decoder also returns its alphas: the last layer's
cross-attention probabilities, (N, h, T, L) teacher-forced and averaged
over heads, (B, L), at a decode step (JAX `captioners.py:253-254, 316`);
unasked, it computes nothing for them. Plain torch products and
elementwise ops: no TPU kernel sits under them.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from imagecaptioning_tpu_torch.parallel import mesh

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
    mask = mesh.current().bernoulli(x, keep, generator)
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
        """(N, L, width) → (N, L, heads, d): all heads, or this rank's
        where `shard_params` split the projections' columns over
        `'model'`."""
        d = self.embed_size // self.heads
        return x.reshape(x.shape[0], -1, x.shape[-1] // d, d)

    def project_kv(self, values: torch.Tensor, keys: torch.Tensor) -> KV:
        """(keys, values) projected and split into heads, (N, L, h, d)."""
        return self._split(self.keys(keys)), self._split(self.values(values))

    def attend(self, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               masked: Optional[torch.Tensor] = None,
               return_attn: bool = False):
        """query (N, Tq, E) against projected k/v (N, L, h, d); `masked`
        (True where a score is filled, broadcast to (N, h, Tq, L)). With
        `return_attn`, → (output, the probabilities (N, h, Tq, L))."""
        q = self._split(self.queries(query))
        energy = torch.einsum("nqhd,nkhd->nhqk", q, k)
        if masked is not None:
            energy = energy.masked_fill(masked, NEG_INF)
        attn = torch.softmax(energy / math.sqrt(self.embed_size), dim=3)
        out = torch.einsum("nhql,nlhd->nqhd", attn, v)
        out = self.fc_out(out.flatten(2))
        if not return_attn:
            return out
        axis = mesh.split_axis(self.queries)
        return out, (attn if axis is None else axis.gather_out(attn, 1))

    def forward(self, values: torch.Tensor, keys: torch.Tensor,
                query: torch.Tensor, masked: Optional[torch.Tensor] = None,
                return_attn: bool = False):
        return self.attend(query, *self.project_kv(values, keys), masked,
                           return_attn)


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
                generator: Optional[torch.Generator] = None,
                return_attn: bool = False):
        """The block's output, or (output, attention probabilities) with
        `return_attn`."""
        if not return_attn:
            return self.finish(self.attention(value, key, query), query,
                               train, generator)
        attn, probs = self.attention(value, key, query, return_attn=True)
        return self.finish(attn, query, train, generator), probs

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
                generator: Optional[torch.Generator] = None,
                return_attn: bool = False):
        """The block's output, or (output, its cross-attention
        probabilities (N, h, T, L)) with `return_attn`."""
        query = dropout(self.norm(self.attention(x, x, x, trg_masked) + x),
                        self.dropout, train, generator)
        return self.transformer_block(enc_out, enc_out, query, train,
                                      generator, return_attn)

    def step(self, x: torch.Tensor, t: int, cache: KV, cross: KV,
             future: torch.Tensor, return_attn: bool = False):
        """One cached decode step of x (B, 1, E) at position t: this step's
        keys and values go into `cache` (each (B, T, h, d)) at t, and the
        scores of the positions after t (`future`, (T,) bool) are masked.
        With `return_attn`, → (output, the cross-attention probabilities
        (B, h, 1, L))."""
        att = self.attention
        k, v = att.project_kv(x, x)
        cache[0][:, t] = k[:, 0]
        cache[1][:, t] = v[:, 0]
        query = self.norm(att.attend(x, cache[0], cache[1], future) + x)
        block = self.transformer_block
        if not return_attn:
            return block.finish(block.attention.attend(query, *cross), query)
        out, probs = block.attention.attend(query, *cross, return_attn=True)
        return block.finish(out, query), probs


class Decoder(nn.Module):
    """Token decoder: word embedding (times sqrt(E) with
    `scale_embedding`) + position embedding → DecoderBlocks → vocabulary
    logits."""

    def __init__(self, vocab_out: int, embed_size: int, num_layers: int,
                 heads: int, forward_expansion: int, dropout: float,
                 max_length: int, scale_embedding: bool = False):
        super().__init__()
        self.word_embedding = nn.Embedding(vocab_out, embed_size)
        self.position_embedding = nn.Embedding(max_length, embed_size)
        self.layers = nn.ModuleList(
            DecoderBlock(embed_size, heads, forward_expansion, dropout)
            for _ in range(num_layers))
        self.fc_out = nn.Linear(embed_size, vocab_out)
        self.dropout = dropout
        self.scale = math.sqrt(embed_size) if scale_embedding else None

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.word_embedding(tokens)
        return emb if self.scale is None else emb * self.scale

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_alphas: bool = False):
        """Teacher-forced logits (N, T, vocab_out) under `make_trg_mask`
        of `tokens`; the encoder output is attended unmasked. With
        `return_alphas`, → (logits, the last layer's cross-attention
        probabilities (N, h, T, L))."""
        trg_masked = make_trg_mask(tokens) == 0
        x = (self._embed(tokens)
             + self.position_embedding.weight[None, :tokens.shape[1]])
        x = dropout(x, self.dropout, train, generator)
        last = len(self.layers) - 1
        alphas = None
        for i, layer in enumerate(self.layers):
            if return_alphas and i == last:
                x, alphas = layer(x, enc_out, trg_masked, train, generator,
                                  return_attn=True)
            else:
                x = layer(x, enc_out, trg_masked, train, generator)
        logits = self.fc_out(x)
        return (logits, alphas) if return_alphas else logits

    def init_state(self, enc_out: torch.Tensor, steps: Optional[int] = None,
                   alphas: bool = False) -> Tuple[List[KV], Callable]:
        """Decode state for `enc_out` (B, L, E) and a decode of `steps`
        steps (default `max_length`): (cache, step). `cache` holds each
        layer's zeroed self-attention (k, v) of (B, steps, h, d), as the
        JAX decode sizes its cache by its step count; `step(cache, tokens
        (B, 1), t)` returns the logits (B, vocab_out) at step t, or with
        `alphas` (logits, the last layer's cross-attention averaged over
        heads (B, L)), and writes this step's keys and values into
        `cache`. The step closes over each layer's cross-attention (k, v),
        fixed for the whole decode, and the causal mask (row t: the cache
        positions after step t). Past the position table, the last
        position's embedding is added (JAX's gather clamps the index)."""
        b = enc_out.shape[0]
        steps = steps or self.position_embedding.num_embeddings
        future = torch.ones(steps, steps, dtype=torch.bool,
                            device=enc_out.device).triu(1)
        cross, cache = [], []
        for layer in self.layers:
            cross.append(layer.transformer_block.attention.project_kv(
                enc_out, enc_out))
            k = enc_out.new_zeros((b, steps, *cross[-1][0].shape[2:]))
            cache.append((k, torch.zeros_like(k)))
        last = self.position_embedding.num_embeddings - 1

        final = self.layers[-1]

        def step(cache: List[KV], tokens: torch.Tensor, t: int):
            x = (self._embed(tokens)
                 + self.position_embedding.weight[min(t, last)])
            for layer, layer_cache, layer_cross in zip(self.layers, cache,
                                                       cross):
                if alphas and layer is final:
                    x, probs = layer.step(x, t, layer_cache, layer_cross,
                                          future[t], return_attn=True)
                else:
                    x = layer.step(x, t, layer_cache, layer_cross, future[t])
            logits = self.fc_out(x)[:, 0]
            return (logits, probs.mean(dim=1)[:, 0]) if alphas else logits
        return cache, step
