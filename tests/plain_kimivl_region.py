"""Plain float32 reference of the region language model of the port's
`gt-vgg16-kimivl-a3b` configuration, for the CPU tests: Kimi-VL's
projector on the GT-box encoder's map merged 2 x 2 (the image tokens), a
projector of each region's fc7 code (the region token), and DeepSeek-V3's
decoder at Kimi-VL-A3B's equations: multi-head latent attention in its
expanded form (keys and values of every head), a dense SwiGLU layer, then
sigmoid-routed experts, each token routed on its own fp32 scores, run in
a loop over the experts, and shared experts.

Each region's whole sequence (its image's tokens, its region token, the
prompt, the served tokens) runs through the full causal forward: no
cache, and no prefix shared between regions. Weights are a dict of
float32 tensors keyed by the port's parameter names. It imports nothing
of the port; the VGG16 encoder and the fp8 rounding of the control come
from the benchmark's plain layers (`portbench/reference/layers.py`).

Departures from the published description: the vision tower (MoonViT) is
replaced by the VGG16 region encoder, whose map takes the place of
MoonViT's patches before the merge; the region token and its projector
are this model's own; a fixed prompt of ids stands for the chat template
and the instruction (there is no tokenizer).

The functions below are kept equal, letter for letter, to the model
functions of `portbench/reference/kimivl_region.py`
(`tests/test_torch_kimivl_region.py` holds the two together).
"""

import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import layers as L  # noqa: E402
from portbench.reference.layers import EXACT  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
