"""Analytic operation counts of a greedy call of the GT captioner with its
region language model (`gt-vgg16-kimivl-a3b`), from the shapes alone:
2 per multiply-add of every convolution and matrix product the algorithm
needs (norms, activations, RoPE, softmax, routing's top-k and the ROI
sampling are left out: they are not products and are small beside them).

A call is the encoder (`portbench.flops`: the trunk, fc6/fc7), the two
projectors, the prefill of every image's tokens once (latent attention
in the expanded form, causal within the image), the prefill of every
region's token and prompt against its image's tokens and its own causal
suffix, and `decode_steps - 1` decode steps in the absorbed form (the
first token comes from the prefill). Each token of a MoE layer counts
its router, its `num_experts_per_tok` routed experts and the shared
experts; the head counts only the rows whose logits are taken (each
region's last prefill position and each decode step).
"""

from __future__ import annotations

from typing import Dict

from portbench.flops import VGG16, linear, vgg16


def _per_token(cfg: Dict) -> Dict[str, int]:
    """Multiply-adds of one token's products outside the attention
    scores, by part (the first layer dense, the others MoE)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, f = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    dense = cfg["first_k_dense_replace"]
    moe_layers = cfg["num_hidden_layers"] - dense
    proj = d * h * (dn + dr) + d * (r + dr) + h * dv * d
    expert = 3 * d * f
    return {
        "attn_proj": cfg["num_hidden_layers"] * proj,
        "mlp": (dense * 3 * d * cfg["intermediate_size"]
                + moe_layers * (d * cfg["n_routed_experts"]
                                + cfg["num_experts_per_tok"] * expert
                                + cfg["n_shared_experts"] * expert)),
    }


def region_lm_call(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """One greedy call -> {"encode", "prefill", "decode", "total"}."""
    n, side, m = traffic["images"], traffic["image_side"], traffic["boxes"]
    steps = traffic["decode_steps"]
    b = n * m
    stages = cfg["vgg_stages"]
    c = VGG16[stages - 1][-1]
    hf = side // 2 ** stages
    p = (hf // 2) ** 2                               # image tokens an image
    s = 1 + cfg["prompt_length"]                     # a region's prefill
    d, v, fc = cfg["hidden_size"], cfg["vocab_size"], cfg["fc"]
    roi = cfg["roi_size"][0] * cfg["roi_size"][1]
    layers = cfg["num_hidden_layers"]
    h = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]

    encode = n * sum(f for _, f in vgg16(side, stages))
    encode += linear(b, c * roi, fc) + linear(b, fc, fc)
    encode += linear(n * p, 4 * c, 4 * c) + linear(n * p, 4 * c, d)
    encode += linear(b, fc, d) + linear(b, d, d)

    tok = _per_token(cfg)
    per_token = 2 * (tok["attn_proj"] + tok["mlp"])
    # expanded attention: each position's latent through kv_b once, and
    # per (query, key) pair the score over nope + rope and the value sum
    expand = 2 * layers * r * h * (dn + dv)
    pair = 2 * layers * h * (dn + dr + dv)
    prefix_pairs = n * p * (p + 1) // 2
    suffix_pairs = b * (s * p + s * (s + 1) // 2)
    prefill = ((n * p + b * s) * (per_token + expand)
               + (prefix_pairs + suffix_pairs) * pair + linear(b, d, v))
    # absorbed decode: a query through W_UK and its output through W_UV,
    # and per key the score over the latent and rope key and the latent
    # sum
    absorbed = 2 * layers * h * (dn * r + dv * r)
    apair = 2 * layers * h * (r + dr + r)
    keys = sum(p + s + t for t in range(1, steps))
    decode = ((steps - 1) * b * (per_token + absorbed) + b * keys * apair
              + (steps - 1) * linear(b, d, v))
    return {"encode": encode, "prefill": prefill, "decode": decode,
            "total": encode + prefill + decode}
