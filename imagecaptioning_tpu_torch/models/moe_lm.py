"""A decoder-only language model with latent attention and routed experts
(DeepSeek-V3's architecture, at Kimi-VL-A3B-Instruct's widths), as the
caption head of the GT-box region captioner (`densecap.
GTRegionLMCaptioner`). It has no counterpart in the JAX package.

The equations follow the published DeepSeek-V3 modelling code:

- RMSNorm in fp32, its output cast back before the weight multiplies it.
- Multi-head latent attention without a query LoRA: `q_proj` gives each
  head a part without RoPE (`qk_nope_head_dim`) and one with it
  (`qk_rope_head_dim`); `kv_a_proj_with_mqa` gives the `kv_lora_rank`
  latent, RMS-normed, and one RoPE key shared by the heads; `kv_b_proj`
  expands the latent to each head's key part and value. RoPE rotates the
  pairs of the de-interleaved RoPE part (the published code's
  `view(d/2, 2).transpose` before `rotate_half`). Scores are scaled by
  1/sqrt(nope + rope dims) and softmaxed in fp32.
- Layers below `first_k_dense_replace` have a SwiGLU of
  `intermediate_size`; the others route each token to
  `num_experts_per_tok` of `n_routed_experts` SwiGLU experts of
  `moe_intermediate_size` (`ops/moe.py`: sigmoid scores, the correction
  bias in the choice only, normalised weights times
  `routed_scaling_factor`) and add `n_shared_experts` shared experts, run
  as one SwiGLU of `n_shared_experts * moe_intermediate_size`.
- The router's logits are taken in fp32; the logits of the head too.

Each position keeps one latent a layer, `kv_lora_rank + qk_rope_head_dim`
values (the normed latent, then the rotated RoPE key): the cache. A
region's sequence is its image's tokens (the prefix), its region token,
the prompt and its decoded tokens. Causal attention makes the prefix's
latents the same for every region of the image, so they are computed
once an image and read by all its regions:

- `prefill_prefix`: the image tokens, causal within each image, in the
  expanded form (keys and values for every head);
- `prefill`: the prefix's latents into the caches, then the region token
  and the prompt of every region, expanded, against its image's prefix
  and its own causal suffix; the logits of its last position give the
  first decoded token;
- `decode_step`: one token a region in the absorbed form: the query's
  no-RoPE part is multiplied through the key half of `kv_b_proj` into
  the latent space, scored against the stored latents (prefix and the
  whole suffix, its slots not yet written masked), and the weighted
  latent is multiplied through the value half.

The caches, the step's token and its position live at fixed addresses
(`DecodeState`), so on the card the step is captured once a shape as
CUDA graphs, one a span's piece, and replayed: a step is ~80 graph
launches, not ~1,600 kernel launches, and the spans still hold their
kernels. Nothing in a step reads the device back (the experts' offsets
come from a sort, not a `bincount`).

Spans: `lm.attn` (norm, projections, cache write, attention),
`lm.router` (the post-attention norm and the routing), `lm.moe` (routed
and shared experts, the residual), `lm.head`. Counters:
`moe.assignments` (token-expert pairs a MoE layer computes),
`lm.prefill_tokens`, `lm.decode_tokens`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import partial
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imagecaptioning_tpu_torch.ops import moe as moe_ops
from imagecaptioning_tpu_torch.utils.profiling import count, span


@dataclass(frozen=True)
class LMSpec:
    """The widths of the language model (the published config's keys)."""
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    n_shared_experts: int
    n_routed_experts: int
    num_experts_per_tok: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    first_k_dense_replace: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rms_norm_eps: float
    rope_theta: float
    prompt_length: int

    # what this implementation computes: anything else in the config is
    # another model, and is refused
    FIXED = {"q_lora_rank": None, "topk_method": "noaux_tc", "n_group": 1,
             "topk_group": 1, "scoring_func": "sigmoid", "hidden_act": "silu",
             "rope_scaling": None, "attention_bias": False,
             "tie_word_embeddings": False, "moe_layer_freq": 1}

    @classmethod
    def from_config(cls, cfg) -> "LMSpec":
        """The spec of a config object or dict holding the published keys;
        raises where it asks for what this model does not compute."""
        get = (cfg.get if isinstance(cfg, dict)
               else lambda k, d=None: getattr(cfg, k, d))
        for key, want in cls.FIXED.items():
            if get(key, want) != want:
                raise NotImplementedError(f"{key}={get(key)!r}: the region "
                                          f"language model computes {want!r}")
        if get("num_key_value_heads", get("num_attention_heads")) != \
                get("num_attention_heads"):
            raise NotImplementedError("latent attention has a key per head")
        return cls(**{f.name: get(f.name) for f in fields(cls)})

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


def rope_table(positions: int, dim: int, theta: float, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (positions, dim) fp32 of RoPE over `dim` dims."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device).float()
                          / dim)
    f = torch.arange(positions, device=device).float()[:, None] * inv
    emb = torch.cat([f, f], -1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """The published rotation of x (..., dim): its interleaved pairs laid
    out as two halves, then rotated (`rotate_half`); fp32 out."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2).float()
    a, b = x.chunk(2, -1)
    return x * cos + torch.cat([-b, a], -1) * sin


class MLA(nn.Module):
    """Multi-head latent attention (no query LoRA)."""

    def __init__(self, s: LMSpec, dtype=None):
        super().__init__()
        self.s = s
        h = s.num_attention_heads
        kw = {"bias": False, "dtype": dtype}
        self.q_proj = nn.Linear(s.hidden_size, h * s.qk_head_dim, **kw)
        self.kv_a_proj_with_mqa = nn.Linear(s.hidden_size, s.latent_dim, **kw)
        self.kv_a_layernorm = RMSNorm(s.kv_lora_rank, s.rms_norm_eps, dtype)
        self.kv_b_proj = nn.Linear(
            s.kv_lora_rank, h * (s.qk_nope_head_dim + s.v_head_dim), **kw)
        self.o_proj = nn.Linear(h * s.v_head_dim, s.hidden_size, **kw)
        self.scale = s.qk_head_dim ** -0.5

    def project(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normed hidden states (B, L, D), RoPE tables (L, rope) -> the
        queries (B, L, H, nope + rope) and the positions' latents
        (B, L, rank + rope): the normed latent, then the rotated key."""
        s = self.s
        q = self.q_proj(h).unflatten(-1, (s.num_attention_heads,
                                          s.qk_head_dim))
        q_nope, q_pe = q.split([s.qk_nope_head_dim, s.qk_rope_head_dim], -1)
        q_pe = apply_rope(q_pe, cos[:, None], sin[:, None]).to(h.dtype)
        c, k_pe = self.kv_a_proj_with_mqa(h).split(
            [s.kv_lora_rank, s.qk_rope_head_dim], -1)
        k_pe = apply_rope(k_pe, cos, sin).to(h.dtype)
        return (torch.cat([q_nope, q_pe], -1),
                torch.cat([self.kv_a_layernorm(c), k_pe], -1))

    def expand(self, lat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latents (..., L, rank + rope) -> keys (..., H, L, nope + rope)
        and values (..., H, L, v), heads before positions."""
        s = self.s
        c, k_pe = lat.split([s.kv_lora_rank, s.qk_rope_head_dim], -1)
        kv = self.kv_b_proj(c).unflatten(-1, (s.num_attention_heads, -1))
        k_nope, v = kv.split([s.qk_nope_head_dim, s.v_head_dim], -1)
        k_pe = k_pe[..., None, :].expand(*k_nope.shape[:-1],
                                         s.qk_rope_head_dim)
        return (torch.cat([k_nope, k_pe], -1).transpose(-2, -3),
                v.transpose(-2, -3))

    def _softmax(self, scores: torch.Tensor, dtype) -> torch.Tensor:
        return torch.softmax(scores.float() * self.scale, -1).to(dtype)

    def attend_prefix(self, q: torch.Tensor,
                      lat: torch.Tensor) -> torch.Tensor:
        """Causal attention of each image's tokens among themselves, in the
        expanded form: q (N, P, H, d), lat (N, P, rank + rope) -> (N, P,
        D)."""
        n, p = q.shape[:2]
        k, v = self.expand(lat)
        scores = q.transpose(1, 2) @ k.transpose(-1, -2)       # (N, H, P, P)
        mask = torch.ones(p, p, dtype=torch.bool, device=q.device).triu(1)
        attn = self._softmax(scores.masked_fill(mask, float("-inf")),
                             q.dtype)
        out = (attn @ v).transpose(1, 2).reshape(n, p, -1)
        return self.o_proj(out)

    def attend_regions(self, q: torch.Tensor, lat: torch.Tensor,
                       prefix: torch.Tensor,
                       masked: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Attention of the regions' last Sq positions in the expanded
        form: q (B, Sq, H, d); lat (B, L, rank + rope), the region's
        suffix; prefix (N, P, rank + rope), its image's (regions grouped
        by image, B = N * R); `masked`, the suffix slots each query does
        not see (bool, broadcast to (Sq, L); by default those after it,
        the queries being the suffix's last Sq) -> (B, Sq, D)."""
        b, sq, h, d = q.shape
        n, p = prefix.shape[:2]
        r, sk = b // n, lat.shape[1]
        kp, vp = self.expand(prefix)            # (N, H, P, d), (N, H, P, v)
        ks, vs = self.expand(lat)                   # (B, H, L, d)
        qh = q.transpose(1, 2)                      # (B, H, Sq, d)
        qg = qh.reshape(n, r, h, sq, d).transpose(1, 2).reshape(n, h,
                                                                r * sq, d)
        s_pre = (qg @ kp.transpose(-1, -2)).reshape(n, h, r, sq, p)
        s_pre = s_pre.transpose(1, 2).reshape(b, h, sq, p)
        s_suf = qh @ ks.transpose(-1, -2)           # (B, H, Sq, L)
        if masked is None:
            masked = torch.ones(sq, sk, dtype=torch.bool,
                                device=q.device).triu(sk - sq + 1)
        scores = torch.cat([s_pre, s_suf.masked_fill(masked,
                                                     float("-inf"))], -1)
        a_pre, a_suf = self._softmax(scores, q.dtype).split([p, sk], -1)
        a_pre = a_pre.reshape(n, r, h, sq, p).transpose(1, 2).reshape(
            n, h, r * sq, p)
        o_pre = (a_pre @ vp).reshape(n, h, r, sq, -1).transpose(1, 2)
        out = o_pre.reshape(b, h, sq, -1).float() + (a_suf @ vs).float()
        return self.o_proj(out.to(q.dtype).transpose(1, 2).reshape(b, sq, -1))

    def attend_absorbed(self, q: torch.Tensor, lat: torch.Tensor,
                        prefix: torch.Tensor,
                        masked: torch.Tensor) -> torch.Tensor:
        """`attend_regions` for one query a region (q (B, 1, H, d)) in the
        absorbed form, against the latents themselves; `masked` (L,)."""
        s = self.s
        b, _, h, _ = q.shape
        n, p = prefix.shape[:2]
        r = b // n
        w = self.kv_b_proj.weight.view(h, -1, s.kv_lora_rank)
        w_uk, w_uv = w.split([s.qk_nope_head_dim, s.v_head_dim], 1)
        q_nope, q_pe = q[:, 0].split([s.qk_nope_head_dim,
                                      s.qk_rope_head_dim], -1)
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
        qq = torch.cat([q_lat, q_pe], -1)                      # (B, H, latent)
        s_pre = (qq.reshape(n, r * h, -1) @ prefix.transpose(1, 2))
        s_suf = (qq @ lat.transpose(1, 2)).masked_fill(masked,
                                                       float("-inf"))
        scores = torch.cat([s_pre.reshape(b, h, p), s_suf], -1)
        a_pre, a_suf = self._softmax(scores, q.dtype).split(
            [p, lat.shape[1]], -1)
        rank = s.kv_lora_rank
        o_lat = ((a_pre.reshape(n, r * h, p) @ prefix[..., :rank]).reshape(
            b, h, rank).float() + (a_suf @ lat[..., :rank]).float())
        out = torch.bmm(o_lat.to(q.dtype).transpose(0, 1),
                        w_uv.transpose(1, 2))                   # (H, B, v)
        return self.o_proj(out.transpose(0, 1).reshape(b, 1, -1))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, width: int, dtype=None):
        super().__init__()
        kw = {"bias": False, "dtype": dtype}
        self.gate_proj = nn.Linear(dim, width, **kw)
        self.up_proj = nn.Linear(dim, width, **kw)
        self.down_proj = nn.Linear(width, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Gate(nn.Module):
    """The router: logits weight (E, D) and the correction bias (E,), kept
    in fp32 as the published checkpoints keep it."""

    def __init__(self, s: LMSpec, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(s.n_routed_experts,
                                               s.hidden_size, dtype=dtype))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(s.n_routed_experts))
        nn.init.uniform_(self.weight, -s.hidden_size ** -0.5,
                         s.hidden_size ** -0.5)


class Experts(nn.Module):
    """The routed experts, stacked for the grouped products: gate and up
    side by side, (E, D, 2F), and down, (E, F, D)."""

    def __init__(self, s: LMSpec, dtype=None):
        super().__init__()
        e, d, f = s.n_routed_experts, s.hidden_size, s.moe_intermediate_size
        self.gate_up_proj = nn.Parameter(torch.empty(e, d, 2 * f,
                                                     dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(e, f, d, dtype=dtype))
        nn.init.uniform_(self.gate_up_proj, -d ** -0.5, d ** -0.5)
        nn.init.uniform_(self.down_proj, -f ** -0.5, f ** -0.5)


class MoE(nn.Module):
    def __init__(self, s: LMSpec, dtype=None):
        super().__init__()
        self.top_k = s.num_experts_per_tok
        self.scale = s.routed_scaling_factor
        self.normalize = s.norm_topk_prob
        self.gate = Gate(s, dtype)
        self.experts = Experts(s, dtype)
        self.shared_experts = SwiGLU(
            s.hidden_size, s.n_shared_experts * s.moe_intermediate_size, dtype)

    def route(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normed tokens (T, D) -> routing weights (T, k) fp32 and expert
        ids (T, k), from fp32 logits."""
        logits = F.linear(h.float(), self.gate.weight.float())
        return moe_ops.route(logits, self.gate.e_score_correction_bias,
                             self.top_k, self.scale, self.normalize)

    def forward(self, h: torch.Tensor, w: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
        """The routed experts under the routing, plus the shared ones."""
        y = moe_ops.experts_swiglu(h, w, idx, self.experts.gate_up_proj,
                                   self.experts.down_proj)
        return (y + self.shared_experts(h).float()).to(h.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, s: LMSpec, index: int, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(s.hidden_size, s.rms_norm_eps, dtype)
        self.self_attn = MLA(s, dtype)
        self.post_attention_layernorm = RMSNorm(s.hidden_size,
                                                s.rms_norm_eps, dtype)
        self.mlp = (SwiGLU(s.hidden_size, s.intermediate_size, dtype)
                    if index < s.first_k_dense_replace else MoE(s, dtype))

    def attend(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               attend: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
        """x plus its attention, and the positions' latents: `attend(q,
        latents)` attends the queries."""
        q, lat = self.self_attn.project(self.input_layernorm(x), cos, sin)
        return x + attend(q, lat), lat

    def router(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """A MoE layer's normed tokens (T, D) and their routing."""
        h = self.post_attention_layernorm(x).reshape(-1, x.shape[-1])
        return (h, *self.mlp.route(h))

    def moe(self, x: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
        return x + self.mlp(h, w, idx).view(x.shape)

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(self.mlp, MoE):
            return x + self.mlp(self.post_attention_layernorm(x))
        with span("lm.router"):
            h, w, idx = self.router(x)
        count("moe.assignments", idx.numel())
        with span("lm.moe"):
            return self.moe(x, h, w, idx)


class DecodeState:
    """What the decode of one shape keeps from call to call, at fixed
    addresses for the step's CUDA graphs: each layer's image prefixes
    (N, P, latent) and region suffixes (B, L, latent) (zeros at first,
    so that the slots not yet written are finite), the step's tokens
    (B, 1) and suffix index (1,), the RoPE tables over P + L positions,
    and once captured the graphs and the dict their outputs live in."""

    def __init__(self, s: LMSpec, key: Tuple, like: torch.Tensor):
        n, p, b, length = key[:4]
        self.key = key
        self.prefix = [like.new_zeros(n, p, s.latent_dim)
                       for _ in range(s.num_hidden_layers)]
        self.suffix = [like.new_zeros(b, length, s.latent_dim)
                       for _ in range(s.num_hidden_layers)]
        self.toks = torch.zeros(b, 1, dtype=torch.long, device=like.device)
        self.at = torch.zeros(1, dtype=torch.long, device=like.device)
        self.slots = torch.arange(length, device=like.device)
        self.cos, self.sin = rope_table(p + length, s.qk_rope_head_dim,
                                        s.rope_theta, like.device)
        self.warm = False
        self.graphs = None
        self.out = None


class RegionLMCarry(NamedTuple):
    """The decode's carry: each layer's image prefixes (N, P, latent) and
    region suffixes (B, S + steps - 1, latent), written in place, the
    prefill's logits of each region's first token, and the state that
    holds the caches."""
    prefix: List[torch.Tensor]
    suffix: List[torch.Tensor]
    first_logits: torch.Tensor
    state: DecodeState


class MoELM(nn.Module):
    """Embedding, the decoder layers, the final norm and the untied head;
    the fixed prompt (`prompt_ids`, a buffer the caller sets) that follows
    each region token. `graphs`: whether the decode step replays CUDA
    graphs on the card (the eager path otherwise, and always on the CPU
    or in float32, whose experts' loop reads the offsets back)."""

    def __init__(self, s: LMSpec, dtype=None):
        super().__init__()
        self.s = s
        self.embed_tokens = nn.Embedding(s.vocab_size, s.hidden_size,
                                         dtype=dtype)
        self.layers = nn.ModuleList(DecoderLayer(s, i, dtype)
                                    for i in range(s.num_hidden_layers))
        self.norm = RMSNorm(s.hidden_size, s.rms_norm_eps, dtype)
        self.lm_head = nn.Linear(s.hidden_size, s.vocab_size, bias=False,
                                 dtype=dtype)
        self.register_buffer("prompt_ids", torch.arange(s.prompt_length),
                             persistent=False)
        self.graphs = True
        self._state: Optional[DecodeState] = None

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.norm(x)).float()

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        with span("lm.head"):
            return self._head(x)

    def _rope(self, start: int, length: int, device):
        cos, sin = rope_table(start + length, self.s.qk_rope_head_dim,
                              self.s.rope_theta, device)
        return cos[start:], sin[start:]

    def prefill_prefix(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Image tokens (N, P, D) -> each layer's latents (N, P, latent)."""
        cos, sin = self._rope(0, x.shape[1], x.device)
        cache = []
        for layer in self.layers:
            with span("lm.attn"):
                x, lat = layer.attend(x, cos, sin,
                                      layer.self_attn.attend_prefix)
            cache.append(lat)
            x = layer.feed_forward(x)
        return cache

    def prefill(self, image: torch.Tensor, region: torch.Tensor,
                steps: int) -> RegionLMCarry:
        """Image tokens (N, P, D) once each, then the region tokens (B, D),
        grouped by image, each followed by the prompt (S = 1 + prompt
        positions) -> the carry of a decode of `steps` tokens, the first
        from the logits at each region's last prompt position. The caches
        are the model's own for this shape, reused by its next call."""
        n, p = image.shape[:2]
        b = region.shape[0]
        length = self.s.prompt_length + steps
        key = (n, p, b, length, image.device, image.dtype)
        if self._state is None or self._state.key != key:
            self._state = None          # its buffers and graphs go first
            self._state = DecodeState(self.s, key, image)
        st = self._state
        for buf, lat in zip(st.prefix, self.prefill_prefix(image)):
            buf.copy_(lat)
        prompt = self.embed_tokens(self.prompt_ids)
        x = torch.cat([region[:, None], prompt.expand(b, -1, -1)], 1)
        s = x.shape[1]
        cos, sin = self._rope(p, s, x.device)
        for layer, pre, suf in zip(self.layers, st.prefix, st.suffix):
            with span("lm.attn"):
                x, lat = layer.attend(x, cos, sin, lambda q, lat: (
                    layer.self_attn.attend_regions(q, lat, pre)))
                suf[:, :s] = lat
            x = layer.feed_forward(x)
        return RegionLMCarry(st.prefix, st.suffix, self.logits(x[:, -1]), st)

    def _pieces(self, st: DecodeState, absorbed: bool) -> List[Tuple]:
        """The decode step as (span or None, fn, assignments) pieces run in
        order: each fn reads and writes the dict it is given (`x`, the
        hidden states; `logits` at the end) and the state's caches; the
        router's pieces give their token-expert pairs for the count."""
        p, b = st.prefix[0].shape[1], st.toks.shape[0]

        def embed(v):
            v["x"] = self.embed_tokens(st.toks)
            at = st.at + p
            v["cos"], v["sin"] = st.cos[at], st.sin[at]
            v["masked"] = st.slots > st.at

        def attn(layer, pre, suf, v):
            def attend(q, lat):
                suf.index_copy_(1, st.at, lat)
                how = (layer.self_attn.attend_absorbed if absorbed
                       else layer.self_attn.attend_regions)
                return how(q, suf, pre, v["masked"])
            v["x"] = layer.attend(v["x"], v["cos"], v["sin"], attend)[0]

        def route(layer, v):
            v["h"], v["w"], v["idx"] = layer.router(v["x"])

        def moe(layer, v):
            v["x"] = layer.moe(v["x"], v["h"], v["w"], v["idx"])

        def dense(layer, v):
            v["x"] = layer.feed_forward(v["x"])

        def head(v):
            v["logits"] = self._head(v["x"][:, 0])

        pieces = [(None, embed, 0)]
        for layer, pre, suf in zip(self.layers, st.prefix, st.suffix):
            pieces.append(("lm.attn", partial(attn, layer, pre, suf), 0))
            if isinstance(layer.mlp, MoE):
                pieces += [("lm.router", partial(route, layer),
                            b * layer.mlp.top_k),
                           ("lm.moe", partial(moe, layer), 0)]
            else:
                pieces.append((None, partial(dense, layer), 0))
        return pieces + [("lm.head", head, 0)]

    def _capture(self, st: DecodeState) -> None:
        """Each piece of the absorbed step captured as a CUDA graph, in
        order and in one memory pool: replayed in the same order, a piece
        finds its inputs where the one before left them."""
        pool = torch.cuda.graph_pool_handle()
        st.out, st.graphs = {}, []
        for name, fn, n in self._pieces(st, True):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                fn(st.out)
            st.graphs.append((name, g.replay, n))

    def decode_step(self, carry: RegionLMCarry, toks: torch.Tensor, at: int,
                    absorbed: bool = True) -> torch.Tensor:
        """Tokens (B, 1) at suffix index `at` -> logits (B, V); their
        latents written into the suffix caches. On the card the absorbed
        step runs eagerly once, then as replays of its captured pieces,
        whose logits are the same tensor every step: read them before the
        next step."""
        st = carry.state
        st.toks.copy_(toks)
        st.at.fill_(at)
        graphed = (absorbed and self.graphs
                   and moe_ops.grouped_on_card(carry.prefix[0]))
        if graphed and st.graphs is None and st.warm:
            self._capture(st)
        if graphed and st.graphs is not None:
            pieces, v = st.graphs, st.out
        else:
            v = {}
            pieces = [(name, partial(fn, v), n)
                      for name, fn, n in self._pieces(st, absorbed)]
            st.warm = st.warm or graphed
        for name, run, n in pieces:
            if name is None:
                run()
            else:
                with span(name):
                    run()
            if n:
                count("moe.assignments", n)
        return v["logits"]
