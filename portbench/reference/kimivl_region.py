"""Plain float32 reference of region captioning with Kimi-VL-A3B's
language model: the GT-box encoder of `gt_lstm` (VGG16 with all five
pools, bilinear 7x7 ROI pooling, fc6/fc7), Kimi-VL's projector on the
trunk's map merged 2 x 2 (the image tokens), a projector of each region's
fc7 code (its region token), and DeepSeek-V3's decoder (multi-head latent
attention, a dense SwiGLU layer, then sigmoid-routed experts with shared
experts) at the configuration's widths.

Each region's whole sequence (its image's tokens, its region token, the
prompt, the served tokens) runs through the full causal forward: latent
attention in its expanded form (keys and values of every head), no
cache, no prefix shared between regions. The experts route every token on
its own fp32 scores and run in a loop over the experts. TF32 is off.

Departures from the published description, each for want of what the
repository cannot hold: the vision tower (MoonViT) is replaced by the
VGG16 region encoder, whose map takes the place of MoonViT's patches
before the merge; the region token and its projector are this model's
own; there is no tokenizer, so a fixed prompt of ids stands for the chat
template and the instruction; weights are seeded (`make_weights`), the
RMSNorm and LayerNorm scales 1 and the LayerNorm shifts 0.

The functions from `rms_norm` to `sequence_logits` are the model and are
kept equal, letter for letter, to `tests/plain_kimivl_region.py` (a test
holds the two together). What follows them is for the benchmark: the
parameter layout, a weight maker that draws each tensor on its own from
the seed (so that a layer can be made again without the others), and
`logits`, which builds the weights one layer at a time so that the whole
model need never be held in fp32. Nothing here comes from the measured
program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import layers as L
from portbench.reference.layers import EXACT, Precision
from portbench.weights import subseed


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def linear(x, w, name, prec, bias=False):
    """x times the weight `name`.weight (its bias too with `bias`), the
    operands in fp8 under the control."""
    return F.linear(L.narrow(x, prec), L.narrow(w[name + ".weight"], prec),
                    w[name + ".bias"] if bias else None)


def rope(length, dim, theta, device):
    """cos and sin (length, dim) of RoPE at positions 0 .. length - 1."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device).float()
                          / dim)
    freqs = torch.outer(torch.arange(length, device=device).float(), inv)
    emb = torch.cat((freqs, freqs), -1)
    return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
    """DeepSeek-V3's `apply_rotary_pos_emb`: the interleaved pairs of x
    (..., L, d) laid out as two halves, then `rotate_half`."""
    *lead, n, d = x.shape
    x = x.view(*lead, n, d // 2, 2).transpose(-1, -2).reshape(*lead, n, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat((-x2, x1), -1) * sin


def attention(x, w, p, cfg, cos, sin, prec):
    """Causal multi-head latent attention, expanded: x (B, L, D) normed."""
    b, n, _ = x.shape
    h, dn, dr = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                 cfg["qk_rope_head_dim"])
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = linear(x, w, p + "q_proj", prec).view(b, n, h, dn + dr)
    q_nope, q_pe = q.transpose(1, 2).split([dn, dr], -1)
    c, k_pe = linear(x, w, p + "kv_a_proj_with_mqa", prec).split([r, dr], -1)
    c = rms_norm(c, w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = linear(c, w, p + "kv_b_proj", prec).view(b, n, h, dn + dv)
    k_nope, v = kv.transpose(1, 2).split([dn, dv], -1)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, None], cos, sin).expand(b, h, n, dr)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe], -1)
    scores = q @ k.transpose(-1, -2) / math.sqrt(dn + dr)
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    attn = torch.softmax(scores.masked_fill(causal, float("-inf")), -1)
    out = (attn @ v).transpose(1, 2).reshape(b, n, h * dv)
    return linear(out, w, p + "o_proj", prec)


def swiglu(x, w, p, prec):
    return linear(F.silu(linear(x, w, p + "gate_proj", prec))
                  * linear(x, w, p + "up_proj", prec), w, p + "down_proj",
                  prec)


def route(x, w, p, cfg):
    """Each token's experts and weights: sigmoid of the fp32 router
    logits, the top k of score + correction bias, the chosen scores
    normalised and scaled."""
    scores = torch.sigmoid(x @ w[p + "gate.weight"].T)
    choice = scores + w[p + "gate.e_score_correction_bias"]
    idx = choice.topk(cfg["num_experts_per_tok"], -1).indices
    weight = scores.gather(-1, idx)
    if cfg["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    return idx, weight * cfg["routed_scaling_factor"]


def moe(x, w, p, cfg, prec):
    """The routed experts, one at a time over their tokens, and the
    shared experts: x (T, D) normed."""
    idx, weight = route(x, w, p, cfg)
    gate_up, down = w[p + "experts.gate_up_proj"], w[p + "experts.down_proj"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        g, u = (L.narrow(x[tok], prec) @ L.narrow(gate_up[e], prec)).chunk(
            2, -1)
        y = L.narrow(F.silu(g) * u, prec) @ L.narrow(down[e], prec)
        out.index_add_(0, tok, y * weight[tok, slot, None])
    return out + swiglu(x, w, p + "shared_experts.", prec)


def decoder_layer(x, w, i, cfg, cos, sin, prec):
    p = f"lm.layers.{i}."
    eps = cfg["rms_norm_eps"]
    x = x + attention(rms_norm(x, w[p + "input_layernorm.weight"], eps), w,
                      p + "self_attn.", cfg, cos, sin, prec)
    h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return x + swiglu(h, w, p + "mlp.", prec)
    return x + moe(h.reshape(-1, h.shape[-1]), w, p + "mlp.", cfg,
                   prec).view_as(x)


def projector(x, w, p, prec):
    """Kimi-VL's projector: LayerNorm over the last axis of x (..., k, C),
    the k vectors side by side, Linear, GELU, Linear."""
    x = F.layer_norm(x, x.shape[-1:], w[p + "pre_norm.weight"],
                     w[p + "pre_norm.bias"], 1e-5).flatten(-2)
    return linear(F.gelu(linear(x, w, p + "linear_1", prec, bias=True)), w,
                  p + "linear_2", prec, bias=True)


def image_tokens(feats, w, prec):
    """The trunk's map (N, C, Hf, Wf) -> (N, Hf/2 * Wf/2, D): each 2 x 2
    block of pixels one token, row-major over the blocks, the block's
    pixels row-major inside it."""
    n, c, hf, wf = feats.shape
    x = feats.permute(0, 2, 3, 1).reshape(n, hf // 2, 2, wf // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, (hf // 2) * (wf // 2), 4, c)
    return projector(x, w, "image_proj.", prec)


def region_tokens(codes, w, prec):
    """fc7 codes (..., 4096) -> region tokens (..., D)."""
    return projector(codes[..., None, :], w, "region_proj.", prec)


def sequence_logits(image, region, prompt, served, w, cfg, prec=EXACT):
    """Regions' whole sequences, teacher-forced: their images' tokens
    (B, P, D), region tokens (B, D), the prompt ids (S,) and the served
    tokens (B, T) -> the logits (B, T, V) that predict each served token
    (from the last prompt position and each served token but the last)."""
    b, t = served.shape
    emb = w["lm.embed_tokens.weight"]
    x = torch.cat([image, region[:, None], emb[prompt].expand(b, -1, -1),
                   emb[served[:, :-1]]], 1)
    cos, sin = rope(x.shape[1], cfg["qk_rope_head_dim"], cfg["rope_theta"],
                    x.device)
    for i in range(cfg["num_hidden_layers"]):
        x = decoder_layer(x, w, i, cfg, cos, sin, prec)
    x = rms_norm(x[:, -t:], w["lm.norm.weight"], cfg["rms_norm_eps"])
    return linear(x, w, "lm.lm_head", prec)


# --------------------------------------------------- for the benchmark

# The query projection is drawn this many times wider than +-1/sqrt(
# fan_in), so that attention scores spread as a trained model's do
# (a standard deviation near 2.6 against 0.33). At +-1/sqrt(fan_in)
# every head averages nearly every position: each region's caption
# hardly depends on its image or its box (of 256 regions, 1-3 distinct
# first tokens an image), and the MoE routes a decode step's 256 tokens
# to 23 of the 64 experts on average; at 8x the regions' captions differ
# (251 of 256 distinct) and a decode step reaches 41.5 experts (measured
# on the H100 at the published widths).
QUERY_SCALE = 8.0


def param_layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, init, fan in) of every parameter, in the program's
    names. Inits: `he` uniform +-sqrt(6/fan_in) for a weight, +-1/sqrt(
    fan_in) for a bias (the trunk and fc6/fc7, as `gt_lstm`); `default`
    +-1/sqrt(fan_in); `query` QUERY_SCALE times that (the attention's
    query projection); `unit` +-1 (the embedding); `one` and `zero` (norm
    scales and shifts)."""
    out = []
    cin = 3
    for n, ch in zip(L.vgg_conv_names(cfg["vgg_stages"]),
                     [c for s in L.VGG16[:cfg["vgg_stages"]] for c in s]):
        out += [(f"features.{n}.weight", (ch, cin, 3, 3), "he", cin * 9),
                (f"features.{n}.bias", (ch,), "he", cin * 9)]
        cin = ch
    roi = cfg["roi_size"][0] * cfg["roi_size"][1]
    fc, d = cfg["fc"], cfg["hidden_size"]
    out += [("classifier.0.weight", (fc, cin * roi), "he", cin * roi),
            ("classifier.0.bias", (fc,), "he", cin * roi),
            ("classifier.3.weight", (fc, fc), "he", fc),
            ("classifier.3.bias", (fc,), "he", fc)]

    def lin(name, fin, fout, bias=False):
        return [(f"{name}.weight", (fout, fin), "default", fin)] + (
            [(f"{name}.bias", (fout,), "default", fin)] if bias else [])

    for name, cn, fin, mid in (("image_proj", cin, 4 * cin, 4 * cin),
                               ("region_proj", fc, fc, d)):
        out += [(f"{name}.pre_norm.weight", (cn,), "one", cn),
                (f"{name}.pre_norm.bias", (cn,), "zero", cn),
                *lin(f"{name}.linear_1", fin, mid, True),
                *lin(f"{name}.linear_2", mid, d, True)]
    h, dn, dr = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                 cfg["qk_rope_head_dim"])
    dv, r, v = cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["vocab_size"]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out.append(("lm.embed_tokens.weight", (v, d), "unit", d))
    for i in range(cfg["num_hidden_layers"]):
        p = f"lm.layers.{i}."
        out += [(p + "input_layernorm.weight", (d,), "one", d),
                (p + "self_attn.q_proj.weight", (h * (dn + dr), d), "query",
                 d),
                *lin(p + "self_attn.kv_a_proj_with_mqa", d, r + dr),
                (p + "self_attn.kv_a_layernorm.weight", (r,), "one", r),
                *lin(p + "self_attn.kv_b_proj", r, h * (dn + dv)),
                *lin(p + "self_attn.o_proj", h * dv, d),
                (p + "post_attention_layernorm.weight", (d,), "one", d)]
        if i < cfg["first_k_dense_replace"]:
            width = cfg["intermediate_size"]
            mlps = [p + "mlp."]
        else:
            width = cfg["n_shared_experts"] * f
            mlps = [p + "mlp.shared_experts."]
            out += [(p + "mlp.gate.weight", (e, d), "default", d),
                    (p + "mlp.gate.e_score_correction_bias", (e,), "default",
                     d),
                    (p + "mlp.experts.gate_up_proj", (e, d, 2 * f), "default",
                     d),
                    (p + "mlp.experts.down_proj", (e, f, d), "default", f)]
        for m in mlps:
            out += [*lin(m + "gate_proj", d, width),
                    *lin(m + "up_proj", d, width),
                    *lin(m + "down_proj", width, d)]
    out += [("lm.norm.weight", (d,), "one", d),
            *lin("lm.lm_head", d, v)]
    return out


def narrow_params(cfg: Dict) -> Tuple[str, ...]:
    """Names served in the narrow type: all but the router's correction
    bias."""
    return tuple(n for n, *_ in param_layout(cfg)
                 if not n.endswith("e_score_correction_bias"))


def make_one(name: str, shape, init: str, fan_in: int, seed: int, device,
             narrow_dtype=None) -> torch.Tensor:
    """The float32 tensor `name` from `subseed(seed, name)`, rounded to
    `narrow_dtype` where given."""
    if init in ("one", "zero"):
        return torch.full(shape, 1.0 if init == "one" else 0.0,
                          device=device)
    bound = {"he": (math.sqrt(6.0 / fan_in) if len(shape) > 1
                    else 1.0 / math.sqrt(fan_in)),
             "default": 1.0 / math.sqrt(fan_in),
             "query": QUERY_SCALE / math.sqrt(fan_in), "unit": 1.0}[init]
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, name))
    t = torch.rand(shape, generator=gen, device=device).mul_(2 * bound)
    t.sub_(bound)
    if narrow_dtype is not None:
        t = t.to(narrow_dtype).float()
    return t


def make_weights(cfg: Dict, seed: int, device, narrow_dtype=None
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every parameter, one at a time; the narrow ones
    rounded to `narrow_dtype` where given."""
    narrow = set(narrow_params(cfg))
    for name, shape, init, fan_in in param_layout(cfg):
        yield name, make_one(name, shape, init, fan_in, seed, device,
                             narrow_dtype if name in narrow else None)


class SeededWeights:
    """A mapping that makes each weight from the seed when it is read,
    and keeps none of them: a forward that reads each weight once holds
    one layer's weights at a time."""

    def __init__(self, cfg: Dict, seed: int, device, narrow_dtype=None):
        self.seed, self.device = seed, device
        self.narrow = set(narrow_params(cfg))
        self.narrow_dtype = narrow_dtype
        self.layout = {n: (s, i, f) for n, s, i, f in param_layout(cfg)}

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, init, fan_in = self.layout[name]
        return make_one(name, shape, init, fan_in, self.seed, self.device,
                        self.narrow_dtype if name in self.narrow else None)


@torch.no_grad()
def logits(w, cfg: Dict, images_u8: torch.Tensor, boxes: torch.Tensor,
           prompt: torch.Tensor, served: torch.Tensor,
           prec: Precision = EXACT) -> torch.Tensor:
    """images (N, H, W, 3) uint8, boxes (N, R, 4) xcycwh, the prompt ids
    (S,), served tokens (N*R, T) -> the logits (N*R, T, V) that predict
    each served token. `w` is any mapping of the weights by name (a dict,
    or `SeededWeights`)."""
    ih, iw = float(images_u8.shape[1]), float(images_u8.shape[2])
    feats = L.vgg16_trunk(L.normalize(images_u8), w, "features",
                          cfg["vgg_stages"], True, prec)
    pooled = L.roi_pool(feats, boxes, (ih, iw), tuple(cfg["roi_size"]))
    codes = L.classifier(pooled, w, "classifier", prec=prec)
    n, r = boxes.shape[:2]
    image = image_tokens(feats, w, prec).repeat_interleave(r, 0)
    region = region_tokens(codes, w, prec).reshape(n * r, -1)
    return sequence_logits(image, region, prompt.long(), served.long(), w,
                           cfg, prec)
