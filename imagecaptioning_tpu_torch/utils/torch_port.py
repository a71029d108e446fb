"""Checkpoint interchange — port of
`imagecaptioning_tpu/utils/torch_port.py`.

Layout moves, bit for bit, between torch state dicts (torchvision's
`resnet101`/`vgg16`/`vit_b_16` and the reference's training checkpoints,
`model.state_dict()` of any AlexCap family or of AlexGTModel) and the JAX
package's variables: nested dicts of numpy arrays, `{'params': ...,
'batch_stats': ...}`, which `utils/pretrained.py` flattens into the
`.npz` files that `encoder_init` reads. `convert_checkpoint.py` is the
command line over them.

Layout rules:
  conv    torch (O, I, kh, kw)  → kernel (kh, kw, I, O)
  linear  torch (O, I)          → kernel (I, O)
  bn      weight/bias           → scale/bias; running stats → batch_stats
  mha     in_proj (3D, D)       → per-head q/k/v kernels (D, h, d)

The converters take numpy-convertible values (torch tensors or ndarrays)
and return numpy arrays. One difference from the JAX module: the VGG
classifier's pooled channel count is read from fc6 (its input rows ÷ the
7 × 7 cells) where the JAX module fixes 512, so that a trunk cut below
five stages round-trips.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from imagecaptioning_tpu_torch.models.backbones.vgg import VGG16_STAGES

# the pooled (7, 7) code that fc6 reads, flattened CHW by torch and HWC
# by the JAX package
_POOL_CELLS = 7 * 7


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def convert_conv(sd: Mapping, prefix: str, use_bias: bool = False) -> Dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if use_bias:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def convert_linear(sd: Mapping, prefix: str) -> Dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def convert_bn(sd: Mapping, prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def convert_embedding(sd: Mapping, prefix: str) -> Dict:
    return {"embedding": _np(sd[f"{prefix}.weight"])}


def convert_lstm(sd: Mapping, prefix: str, num_layers: int = 1) -> Dict:
    """torch nn.LSTM state_dict slice → ops.rnn.LSTM params (identical
    layout by design)."""
    params = {}
    for l in range(num_layers):
        params[f"w_ih_l{l}"] = _np(sd[f"{prefix}.weight_ih_l{l}"])
        params[f"w_hh_l{l}"] = _np(sd[f"{prefix}.weight_hh_l{l}"])
        params[f"b_ih_l{l}"] = _np(sd[f"{prefix}.bias_ih_l{l}"])
        params[f"b_hh_l{l}"] = _np(sd[f"{prefix}.bias_hh_l{l}"])
    return params


def convert_lstm_cell(sd: Mapping, prefix: str) -> Dict:
    return {"w_ih": _np(sd[f"{prefix}.weight_ih"]),
            "w_hh": _np(sd[f"{prefix}.weight_hh"]),
            "b_ih": _np(sd[f"{prefix}.bias_ih"]),
            "b_hh": _np(sd[f"{prefix}.bias_hh"])}


def convert_reference_lstm_head(sd: Mapping, prefix: str = "",
                                num_layers: int = 1) -> Dict:
    """AlexCap LanguageModule state_dict (or any same-keyed tensor dict,
    e.g. per-parameter gradients) → the JAX LanguageHead param tree. The
    converters are linear transpose/reshape maps, so the same map ports
    weights, gradients, and post-step states alike."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    return {
        "image_encoder": convert_linear(sd, "image_encoder.encode"),
        "lookup_table": convert_embedding(sd, "lookup_table"),
        "lstm": convert_lstm(sd, "lstm", num_layers=num_layers),
        "linear": convert_linear(sd, "rnn.linear"),
    }


# ---------------------------------------------------------------- ResNet

_RESNET_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def convert_resnet(sd: Mapping, depth: int = 101,
                   stages: Tuple[int, ...] = None) -> Dict:
    """torchvision resnet{depth} state_dict → ResNetFeatures variables
    {'params': ..., 'batch_stats': ...}. Classifier (fc.*) is ignored —
    the reference drops it too. `stages` overrides the per-stage block
    counts (shrunk test models; matches ResNetFeatures(stage_sizes=...))."""
    params: Dict = {}
    stats: Dict = {}

    params["conv1"] = convert_conv(sd, "conv1")
    params["bn1"], stats["bn1"] = convert_bn(sd, "bn1")

    for stage, blocks in enumerate(stages or _RESNET_STAGES[depth]):
        for b in range(blocks):
            t = f"layer{stage + 1}.{b}"
            name = f"layer{stage + 1}_{b}"
            bp: Dict = {}
            bs: Dict = {}
            for i in (1, 2, 3):
                bp[f"conv{i}"] = convert_conv(sd, f"{t}.conv{i}")
                bp[f"bn{i}"], bs[f"bn{i}"] = convert_bn(sd, f"{t}.bn{i}")
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample_conv"] = convert_conv(sd, f"{t}.downsample.0")
                bp["downsample_bn"], bs["downsample_bn"] = convert_bn(
                    sd, f"{t}.downsample.1")
            params[name] = bp
            stats[name] = bs
    return {"params": params, "batch_stats": stats}


# ------------------------------------------------------------------ VGG

def _vgg_conv_indices():
    """torchvision vgg16.features module indices of the 13 convs."""
    idx, out = 0, []
    for stage in VGG16_STAGES:
        for _ in stage:
            out.append(idx)
            idx += 2      # conv + relu
        idx += 1          # maxpool
    return out


def convert_vgg_features(sd: Mapping, prefix: str = "features",
                         end_stage: int = 5) -> Dict:
    """torchvision vgg16.features (or the VGGFace checkpoint's equivalent
    keys) → VGGFeatures params. `end_stage` truncates to the first N
    stages (matching VGGFeatures(end_stage=N), used by shrunk test
    models)."""
    params: Dict = {}
    conv_idx = _vgg_conv_indices()
    k = 0
    for stage, chans in enumerate(VGG16_STAGES[:end_stage]):
        for i in range(len(chans)):
            params[f"conv{stage + 1}_{i + 1}"] = convert_conv(
                sd, f"{prefix}.{conv_idx[k]}", use_bias=True)
            k += 1
    return {"params": params}


def _torch(a) -> torch.Tensor:
    """A C-contiguous, writable array as a tensor sharing its memory."""
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def fc6_hwc(weight, cells: int = _POOL_CELLS) -> np.ndarray:
    """torch's fc6 weight (out, C·cells), its input the pooled code
    flattened CHW → the JAX kernel (cells·C, out), flattened HWC (C read
    from the shape). A 2-D transpose and a gather of whole rows, torch's
    copies: at 4096 × 25088, half the time of numpy's one strided copy."""
    w = _torch(weight)
    c = w.shape[1] // cells
    return (w.t().contiguous().view(c, cells, -1).transpose(0, 1)
            .reshape(cells * c, -1).numpy())


def fc6_chw(kernel, cells: int = _POOL_CELLS) -> np.ndarray:
    """The inverse of `fc6_hwc`: (cells·C, out) HWC → (out, C·cells)."""
    k = _torch(kernel)
    c = k.shape[0] // cells
    return (k.view(cells, c, -1).transpose(0, 1).reshape(c * cells, -1)
            .t().contiguous().numpy())


def convert_vgg_classifier(sd: Mapping, prefix: str = "classifier") -> Dict:
    """vgg16.classifier[0]/[3] → VGGClassifierHead. torchvision flattens
    CHW while the JAX package flattens HWC, so fc6's input rows are
    permuted to match; the channel count is fc6's rows ÷ 49."""
    fc6 = convert_linear(sd, f"{prefix}.0")
    fc6["kernel"] = fc6_hwc(_np(sd[f"{prefix}.0.weight"]))
    return {"params": {"fc6": fc6, "fc7": convert_linear(sd, f"{prefix}.3")}}


# ------------------------------------------------------------------ ViT

def convert_vit(sd: Mapping, num_layers: int = 12, num_heads: int = 12,
                hidden: int = 768) -> Dict:
    """torchvision vit_b_16 state_dict → ViTEncoder params."""
    d = hidden // num_heads
    params: Dict = {
        "conv_proj": convert_conv(sd, "conv_proj", use_bias=True),
        "class_token": _np(sd["class_token"]),
        "pos_embedding": _np(sd["encoder.pos_embedding"]),
        "ln": {"scale": _np(sd["encoder.ln.weight"]),
               "bias": _np(sd["encoder.ln.bias"])},
    }
    for i in range(num_layers):
        t = f"encoder.layers.encoder_layer_{i}"
        in_w = _np(sd[f"{t}.self_attention.in_proj_weight"])   # (3D, D)
        in_b = _np(sd[f"{t}.self_attention.in_proj_bias"])     # (3D,)
        qw, kw, vw = np.split(in_w, 3, axis=0)
        qb, kb, vb = np.split(in_b, 3, axis=0)

        def head(w, b):
            # torch (D_out, D_in) → flax (D_in, heads, head_dim)
            return {"kernel": w.T.reshape(hidden, num_heads, d),
                    "bias": b.reshape(num_heads, d)}

        out_w = _np(sd[f"{t}.self_attention.out_proj.weight"])  # (D, D)
        attn = {
            "query": head(qw, qb),
            "key": head(kw, kb),
            "value": head(vw, vb),
            "out": {"kernel": out_w.T.reshape(num_heads, d, hidden),
                    "bias": _np(sd[f"{t}.self_attention.out_proj.bias"])},
        }
        params[f"encoder_layer_{i}"] = {
            "ln_1": {"scale": _np(sd[f"{t}.ln_1.weight"]),
                     "bias": _np(sd[f"{t}.ln_1.bias"])},
            "self_attention": attn,
            "ln_2": {"scale": _np(sd[f"{t}.ln_2.weight"]),
                     "bias": _np(sd[f"{t}.ln_2.bias"])},
            "mlp_0": convert_linear(sd, f"{t}.mlp.0"),
            "mlp_3": convert_linear(sd, f"{t}.mlp.3"),
        }
    return {"params": params}


# -------------------------------------- reference AlexCap Transformer

def convert_norm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def convert_reference_transformer(sd: Mapping, num_layers: int) -> Dict:
    """The reference's from-scratch Transformer state_dict
    (`AlexCap/TransformerModule.py`) → the JAX {fc, encoder, decoder} param
    trees for `ops.transformer.Encoder/Decoder` + the fc projection.
    Works on weight state_dicts and (because every map is a linear
    transpose/reshape) on per-parameter GRADIENT dicts too."""
    def block(prefix):
        return {
            "attention": {
                "values": convert_linear(sd, f"{prefix}.attention.values"),
                "keys": convert_linear(sd, f"{prefix}.attention.keys"),
                "queries": convert_linear(sd,
                                          f"{prefix}.attention.queries"),
                "fc_out": convert_linear(sd, f"{prefix}.attention.fc_out"),
            },
            "norm1": convert_norm(sd, f"{prefix}.norm1"),
            "norm2": convert_norm(sd, f"{prefix}.norm2"),
            "ff1": convert_linear(sd, f"{prefix}.feed_forward.0"),
            "ff2": convert_linear(sd, f"{prefix}.feed_forward.2"),
        }

    enc_params = {"position_embedding":
                  _np(sd["encoder.position_embedding.weight"])}
    for i in range(num_layers):
        enc_params[f"layer_{i}"] = block(f"encoder.layers.{i}")
    dec_params = {
        "word_embedding": convert_embedding(sd, "decoder.word_embedding"),
        "position_embedding":
            _np(sd["decoder.position_embedding.weight"]),
        "fc_out": convert_linear(sd, "decoder.fc_out"),
    }
    for i in range(num_layers):
        dec_params[f"layer_{i}"] = {
            "norm": convert_norm(sd, f"decoder.layers.{i}.norm"),
            "attention": {
                "values": convert_linear(
                    sd, f"decoder.layers.{i}.attention.values"),
                "keys": convert_linear(
                    sd, f"decoder.layers.{i}.attention.keys"),
                "queries": convert_linear(
                    sd, f"decoder.layers.{i}.attention.queries"),
                "fc_out": convert_linear(
                    sd, f"decoder.layers.{i}.attention.fc_out"),
            },
            "transformer_block": block(
                f"decoder.layers.{i}.transformer_block"),
        }
    return {"fc": convert_linear(sd, "fc.0"),
            "encoder": enc_params, "decoder": dec_params}


def convert_reference_vitb_decoder(sd: Mapping, num_layers: int,
                                   prefix: str = "decoder.") -> Dict:
    """The ViT-B captioner's own Decoder copy state_dict
    (`AlexCap/VitbModel.py:114-149` — the TransformerModule decoder that
    also returns cross-attention alphas) → the JAX `ops.transformer.Decoder`
    params. Same layout as convert_reference_transformer's decoder
    part, but rooted at `prefix` with no encoder/fc siblings."""
    s = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def block(p):
        return {
            "attention": {k: convert_linear(s, f"{p}.attention.{k}")
                          for k in ("values", "keys", "queries", "fc_out")},
            "norm1": convert_norm(s, f"{p}.norm1"),
            "norm2": convert_norm(s, f"{p}.norm2"),
            "ff1": convert_linear(s, f"{p}.feed_forward.0"),
            "ff2": convert_linear(s, f"{p}.feed_forward.2"),
        }

    dec = {
        "word_embedding": convert_embedding(s, "word_embedding"),
        "position_embedding": _np(s["position_embedding.weight"]),
        "fc_out": convert_linear(s, "fc_out"),
    }
    for i in range(num_layers):
        dec[f"layer_{i}"] = {
            "norm": convert_norm(s, f"layers.{i}.norm"),
            "attention": {k: convert_linear(s, f"layers.{i}.attention.{k}")
                          for k in ("values", "keys", "queries", "fc_out")},
            "transformer_block": block(f"layers.{i}.transformer_block"),
        }
    return dec


# ------------------------------------- full reference model checkpoints

def convert_reference_attention_head(sd: Mapping,
                                     prefix: str = "llm.") -> Dict:
    """Reference Show-Attend-Tell Decoder state_dict slice
    (`AlexCap/AttentionLanguageModule.py`, stored as `llm.` inside
    `LSTMwAttentionModel.AlexCapModel`) → the JAX AttentionHead param tree.
    Same linear transpose maps as the other head converters, so it
    ports weights and per-parameter gradients alike."""
    s = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    lin = lambda p: {"kernel": _np(s[f"{p}.weight"]).T,
                     "bias": _np(s[f"{p}.bias"])}
    return {
        "init_h": lin("init_h"),
        "init_c": lin("init_c"),
        "embedding": {"embedding": _np(s["embedding.weight"])},
        "att_W_kernel": _np(s["attention.W.weight"]).T,
        "att_W_bias": _np(s["attention.W.bias"]),
        "att_U_kernel": _np(s["attention.U.weight"]).T,
        "att_U_bias": _np(s["attention.U.bias"]),
        "att_v_kernel": _np(s["attention.v.weight"]).T,
        "att_v_bias": _np(s["attention.v.bias"]),
        "f_beta_kernel": _np(s["f_beta.weight"]).T,
        "f_beta_bias": _np(s["f_beta.bias"]),
        "deep_output_kernel": _np(s["deep_output.weight"]).T,
        "deep_output_bias": _np(s["deep_output.bias"]),
        "cell_w_ih": _np(s["lstm.weight_ih"]),
        "cell_w_hh": _np(s["lstm.weight_hh"]),
        "cell_b_ih": _np(s["lstm.bias_ih"]),
        "cell_b_hh": _np(s["lstm.bias_hh"]),
    }


# nn.Sequential(*resnet.children())[:-2] (LSTMModel.py:26-27) renumbers
# the resnet stages; relu(2)/maxpool(3) hold no params.
_SEQ_RESNET_MAP = {"0": "conv1", "1": "bn1", "4": "layer1",
                   "5": "layer2", "6": "layer3", "7": "layer4"}
_LAYER3_DEPTH = {6: 50, 23: 101, 36: 152}


def convert_sequential_resnet(
        sd: Mapping,
        prefix: str = "features.") -> Tuple[Dict, Tuple[int, ...]]:
    """Reference resnet encoder slice — `nn.Sequential(*children[:-2])`
    numbers the stages 0..7 — remapped back to torchvision names and
    run through `convert_resnet`. Returns (variables, stage sizes
    inferred from the block indices; (3,4,23,3) for a real resnet101)."""
    remapped = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        head, _, tail = k[len(prefix):].partition(".")
        if head in _SEQ_RESNET_MAP:
            remapped[f"{_SEQ_RESNET_MAP[head]}.{tail}"] = v
    stages = tuple(
        len({k.split(".")[1] for k in remapped
             if k.startswith(f"layer{s}.")}) for s in (1, 2, 3, 4))
    return convert_resnet(remapped, stages=stages), stages


def detect_reference_family(sd: Mapping) -> str:
    """Which reference family saved this `model.state_dict()`? The
    families have disjoint key roots (LSTMModel/LSTMwAttentionModel/
    TransformerModel store the decoder as `llm.`; VitbModel stores the
    torchvision ViT pieces as `proj`/`class_token`/`encoder` plus its
    own `decoder`, VitbModel.py:159-168; AlexGTModel additionally
    re-registers the trunk under `net.vgg16_backbone` and carries the
    VGG `classifier`, AlexDenseModel.py:20-29)."""
    if any(k.startswith("net.vgg16_backbone.") for k in sd):
        return "gt"
    if any(k.startswith("proj.") for k in sd) and "class_token" in sd:
        return "vitb"
    if any(k.startswith("llm.encoder.position_embedding") for k in sd):
        return "transformer"
    if "llm.attention.W.weight" in sd:
        return "attention"
    if "llm.lstm.weight_ih_l0" in sd:
        return "lstm"
    raise ValueError(
        "unrecognized checkpoint: expected the state_dict of one of the "
        "reference's AlexCap families or the AlexGTModel")


def reference_layout(sd: Mapping) -> Dict:
    """A port model's state dict → the reference's key layout, which
    `convert_reference_captioner` reads: ViT-B's `encoder_vit.*` back to
    VitbModel's `proj.*`, `class_token` and `encoder.*`, and the GT
    model's trunk and classifier also under `net.vgg16_backbone.*` and
    `net.full_conv.*`, the same tensors, as the reference registers them
    twice (the inverse of `weights.load_alexcap_checkpoint` and
    `load_gt_checkpoint`)."""
    out: Dict = {}
    for k, v in sd.items():
        if k.startswith("encoder_vit."):
            k = k[len("encoder_vit."):]
            if k.startswith("conv_proj."):
                k = "proj." + k[len("conv_proj."):]
        out[k] = v
    if "classifier.0.weight" in out:
        for k in list(out):
            if k.startswith("features."):
                out["net.vgg16_backbone." + k[len("features."):]] = out[k]
            elif k.startswith("classifier."):
                out["net.full_conv." + k[len("classifier."):]] = out[k]
    return out


def _layer_count(keys, pattern: str) -> int:
    found = {int(m.group(1)) for k in keys
             for m in [re.match(pattern, k)] if m}
    return max(found) + 1 if found else 0


def convert_reference_gt_model(sd: Mapping) -> Tuple[Dict, Dict]:
    """AlexGTModel `AlexCapModel.state_dict()` (traingt.py checkpoints)
    → GTDenseCaptioner variables. The reference registers the trunk and
    classifier TWICE (as `features`/`classifier` and inside `net.*`,
    AlexDenseModel.py:20-29) — the duplicates alias the same tensors, so
    only the direct names are read. The GT transformer head's encoder
    carries a dead `word_embedding` (AlexTransformer.py:111, never used
    in forward) which has no slot here and is dropped."""
    use_lstm = "llm.lstm.weight_ih_l0" in sd
    params: Dict = {
        "features": convert_vgg_features(sd, prefix="features")["params"],
        "classifier": convert_vgg_classifier(sd)["params"],
    }
    meta: Dict = {"family": "gt", "use_lstm": use_lstm}
    if use_lstm:
        n = _layer_count(sd, r"llm\.lstm\.weight_ih_l(\d+)")
        head = convert_reference_lstm_head(sd, prefix="llm.",
                                           num_layers=n)
        params["llm"] = head
        meta.update(
            vocab_size=int(head["lookup_table"]["embedding"].shape[0]) - 3,
            embedding_size=int(head["lookup_table"]["embedding"]
                               .shape[-1]),
            rnn_size=int(head["lstm"]["w_hh_l0"].shape[-1]), num_layers=n)
    else:
        llm_sd = {k[len("llm."):]: v for k, v in sd.items()
                  if k.startswith("llm.")}
        n = _layer_count(llm_sd, r"encoder\.layers\.(\d+)\.")
        params.update(convert_reference_transformer(llm_sd, num_layers=n))
        # the GT encoder sees a length-1 sequence (one projected ROI
        # code, AlexTransformer.py:313-316) so only position row 0 is
        # ever read; the JAX Encoder(patch_length=1) holds exactly that row
        params["encoder"]["position_embedding"] = (
            params["encoder"]["position_embedding"][:1])
        emb = _np(llm_sd["decoder.word_embedding.weight"])
        # AlexTransformer takes src_vocab_size ALREADY including the +3
        # specials (AlexDenseModel.py:43, sos=V-2/eos=V-1 convention)
        meta.update(vocab_size=int(emb.shape[0]) - 3,
                    embed_size=int(emb.shape[-1]), num_layers=n)
    return {"params": params, "batch_stats": {}}, meta


def export_reference_gt_model(variables: Mapping) -> Tuple[Dict, Dict]:
    """Inverse of `convert_reference_gt_model`. Emits the duplicate
    `net.vgg16_backbone`/`net.full_conv` registrations (same tensors)
    so the reference's strict `load_state_dict` accepts the export; the
    dead GT-transformer `encoder.word_embedding` is re-emitted as zeros
    (it never participates in the forward pass)."""
    params = variables["params"]
    use_lstm = "llm" in params
    sd = export_vgg_features({"params": params["features"]},
                             prefix="features")
    sd.update(export_vgg_classifier({"params": params["classifier"]}))
    meta: Dict = {"family": "gt", "use_lstm": use_lstm}
    if use_lstm:
        sd.update(export_reference_lstm_head(params["llm"]))
    else:
        sd.update(export_reference_transformer(
            {k: params[k] for k in ("fc", "encoder", "decoder")},
            prefix="llm."))
        dead = np.zeros_like(
            np.asarray(params["decoder"]["word_embedding"]["embedding"]))
        sd["llm.encoder.word_embedding.weight"] = dead
        # pad the encoder position table back to the reference's
        # max_length rows (only row 0 participates in the forward pass)
        dec_pos = np.asarray(
            params["decoder"]["position_embedding"])
        enc_pos = np.zeros_like(dec_pos)
        enc_pos[:1] = np.asarray(sd["llm.encoder.position_embedding.weight"])
        sd["llm.encoder.position_embedding.weight"] = enc_pos
    for k in list(sd):
        if k.startswith("features."):
            sd["net.vgg16_backbone." + k[len("features."):]] = sd[k]
        elif k.startswith("classifier."):
            sd["net.full_conv." + k[len("classifier."):]] = sd[k]
    return sd, meta


def convert_reference_captioner(sd: Mapping, family: str = "auto",
                                vit_heads: int = 12) -> Tuple[Dict, Dict]:
    """A full trained reference checkpoint (`model.state_dict()` as
    saved by `train_*.py:122-125`) → the JAX captioner variables
    {'params', 'batch_stats'} plus a meta dict of the inferred
    architecture (what to pass to the matching *Captioner / config).

    Covers all four AlexCap families and both CNN encoders: the
    vggface VGG trunk keeps torchvision's `features.N` numbering, the
    resnet trunk comes via `convert_sequential_resnet`, and VitbModel's
    `proj.*` is torchvision's `conv_proj.*` renamed (VitbModel.py:159).
    """
    if family == "auto":
        family = detect_reference_family(sd)
    if family == "gt":
        return convert_reference_gt_model(sd)
    meta: Dict = {"family": family}

    if family == "vitb":
        sd2 = {("conv_proj." + k[len("proj."):] if k.startswith("proj.")
                else k): v for k, v in sd.items()}
        hidden = int(_np(sd["class_token"]).shape[-1])
        n_enc = _layer_count(sd2, r"encoder\.layers\.encoder_layer_(\d+)\.")
        n_dec = _layer_count(sd2, r"decoder\.layers\.(\d+)\.")
        emb = int(_np(sd["decoder.word_embedding.weight"]).shape[-1])
        patch = int(_np(sd["proj.weight"]).shape[-1])
        n_tokens = int(_np(sd["encoder.pos_embedding"]).shape[1])
        image_size = int(round((n_tokens - 1) ** 0.5)) * patch
        params = {
            "encoder_vit": convert_vit(sd2, num_layers=n_enc,
                                       num_heads=vit_heads,
                                       hidden=hidden)["params"],
            "decoder": convert_reference_vitb_decoder(sd2,
                                                      num_layers=n_dec),
        }
        meta.update(
            vocab_size=int(_np(sd["decoder.word_embedding.weight"])
                           .shape[0]) - 3,
            embedding_size=emb, num_layers=n_dec, vit_encoder_layers=n_enc,
            vit_hidden=hidden, vit_heads=vit_heads, patch_size=patch,
            image_size=image_size)
        return {"params": params, "batch_stats": {}}, meta

    # CNN-encoder families: resnet's stem conv is 7x7, vgg's is 3x3
    use_vggface = int(_np(sd["features.0.weight"]).shape[-1]) == 3
    batch_stats: Dict = {}
    if use_vggface:
        enc_params = convert_vgg_features(sd, prefix="features")["params"]
        meta["encoder"] = "vggface"
    else:
        enc_vars, stages = convert_sequential_resnet(sd)
        enc_params = enc_vars["params"]
        batch_stats["features"] = enc_vars["batch_stats"]
        depth = _LAYER3_DEPTH.get(stages[2])
        meta["encoder"] = f"resnet{depth}" if depth else "resnet-custom"
        meta["backbone_stages"] = stages

    if family == "transformer":
        llm_sd = {k[len("llm."):]: v for k, v in sd.items()
                  if k.startswith("llm.")}
        n = _layer_count(llm_sd, r"encoder\.layers\.(\d+)\.")
        params = {"features": enc_params,
                  **convert_reference_transformer(llm_sd, num_layers=n)}
        meta.update(
            vocab_size=int(_np(llm_sd["decoder.word_embedding.weight"])
                           .shape[0]) - 3,
            embed_size=int(_np(llm_sd["decoder.word_embedding.weight"])
                           .shape[-1]),
            num_layers=n)
    elif family == "attention":
        head = convert_reference_attention_head(sd)
        params = {"features": enc_params, "llm": head}
        meta.update(vocab_size=int(head["embedding"]["embedding"]
                                   .shape[0]) - 3,
                    embedding_size=int(head["embedding"]["embedding"]
                                       .shape[-1]),
                    rnn_size=int(head["cell_w_hh"].shape[-1]))
    else:                                                      # lstm
        n = _layer_count(sd, r"llm\.lstm\.weight_ih_l(\d+)")
        head = convert_reference_lstm_head(sd, prefix="llm.",
                                           num_layers=n)
        params = {"features": enc_params, "llm": head}
        meta.update(vocab_size=int(head["lookup_table"]["embedding"]
                                   .shape[0]) - 3,
                    embedding_size=int(head["lookup_table"]["embedding"]
                                       .shape[-1]),
                    rnn_size=int(head["lstm"]["w_hh_l0"].shape[-1]),
                    num_layers=n)
    return {"params": params, "batch_stats": batch_stats}, meta


# --------------------------------------------- reverse (JAX layout → torch)

def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def export_conv(block: Mapping, prefix: str) -> Dict:
    out = {f"{prefix}.weight": np.asarray(block["kernel"])
           .transpose(3, 2, 0, 1)}
    if "bias" in block:
        out[f"{prefix}.bias"] = np.asarray(block["bias"])
    return out


def export_linear(block: Mapping, prefix: str) -> Dict:
    out = {f"{prefix}.weight": np.asarray(block["kernel"]).T}
    if "bias" in block:
        out[f"{prefix}.bias"] = np.asarray(block["bias"])
    return out


def export_bn(params: Mapping, stats: Mapping, prefix: str) -> Dict:
    # num_batches_tracked is a torch-side step counter with no flax
    # equivalent; emit 0 so strict load_state_dict accepts the export
    # (it only matters for momentum=None BN, which torchvision never
    # uses).
    return {f"{prefix}.weight": np.asarray(params["scale"]),
            f"{prefix}.bias": np.asarray(params["bias"]),
            f"{prefix}.running_mean": np.asarray(stats["mean"]),
            f"{prefix}.running_var": np.asarray(stats["var"]),
            f"{prefix}.num_batches_tracked": np.asarray(0, np.int64)}


def export_resnet(variables: Mapping, depth: int = 101,
                  stages: Tuple[int, ...] = None) -> Dict:
    """ResNetFeatures variables → torchvision resnet{depth} state_dict
    (tensor layout; no fc.* — the reference drops the classifier). The
    exact inverse of `convert_resnet`, so checkpoints round-trip.
    `stages` overrides the per-stage block counts (shrunk models)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict = {}
    sd.update(export_conv(params["conv1"], "conv1"))
    sd.update(export_bn(params["bn1"], stats["bn1"], "bn1"))
    for stage, blocks in enumerate(stages or _RESNET_STAGES[depth]):
        for b in range(blocks):
            t = f"layer{stage + 1}.{b}"
            name = f"layer{stage + 1}_{b}"
            bp, bs = params[name], stats[name]
            for i in (1, 2, 3):
                sd.update(export_conv(bp[f"conv{i}"], f"{t}.conv{i}"))
                sd.update(export_bn(bp[f"bn{i}"], bs[f"bn{i}"], f"{t}.bn{i}"))
            if "downsample_conv" in bp:
                sd.update(export_conv(bp["downsample_conv"],
                                      f"{t}.downsample.0"))
                sd.update(export_bn(bp["downsample_bn"],
                                    bs["downsample_bn"],
                                    f"{t}.downsample.1"))
    return sd


def export_vgg_features(variables: Mapping, prefix: str = "features",
                        end_stage: int = 5) -> Dict:
    params = variables["params"]
    sd: Dict = {}
    conv_idx = _vgg_conv_indices()
    k = 0
    for stage, chans in enumerate(VGG16_STAGES[:end_stage]):
        for i in range(len(chans)):
            sd.update(export_conv(params[f"conv{stage + 1}_{i + 1}"],
                                  f"{prefix}.{conv_idx[k]}"))
            k += 1
    return sd


def export_vgg_classifier(variables: Mapping,
                          prefix: str = "classifier") -> Dict:
    params = variables["params"]
    sd = {f"{prefix}.0.weight": fc6_chw(params["fc6"]["kernel"]),
          f"{prefix}.0.bias": np.asarray(params["fc6"]["bias"])}
    sd.update(export_linear(params["fc7"], f"{prefix}.3"))
    return sd


def export_vit(variables: Mapping, num_layers: int = 12,
               num_heads: int = 12, hidden: int = 768) -> Dict:
    """ViTEncoder params → torchvision vit_b_16 state_dict; inverse of
    `convert_vit`."""
    p = variables["params"]
    sd: Dict = {}
    sd.update(export_conv(p["conv_proj"], "conv_proj"))
    sd["class_token"] = np.asarray(p["class_token"])
    sd["encoder.pos_embedding"] = np.asarray(p["pos_embedding"])
    sd["encoder.ln.weight"] = np.asarray(p["ln"]["scale"])
    sd["encoder.ln.bias"] = np.asarray(p["ln"]["bias"])
    for i in range(num_layers):
        t = f"encoder.layers.encoder_layer_{i}"
        lp = p[f"encoder_layer_{i}"]
        attn = lp["self_attention"]

        def unhead(blk):
            w = np.asarray(blk["kernel"]).reshape(hidden, hidden).T
            b = np.asarray(blk["bias"]).reshape(hidden)
            return w, b
        qw, qb = unhead(attn["query"])
        kw, kb = unhead(attn["key"])
        vw, vb = unhead(attn["value"])
        sd[f"{t}.self_attention.in_proj_weight"] = np.concatenate(
            [qw, kw, vw], axis=0)
        sd[f"{t}.self_attention.in_proj_bias"] = np.concatenate(
            [qb, kb, vb], axis=0)
        ow = np.asarray(attn["out"]["kernel"]).reshape(hidden, hidden).T
        sd[f"{t}.self_attention.out_proj.weight"] = ow
        sd[f"{t}.self_attention.out_proj.bias"] = np.asarray(
            attn["out"]["bias"])
        sd[f"{t}.ln_1.weight"] = np.asarray(lp["ln_1"]["scale"])
        sd[f"{t}.ln_1.bias"] = np.asarray(lp["ln_1"]["bias"])
        sd[f"{t}.ln_2.weight"] = np.asarray(lp["ln_2"]["scale"])
        sd[f"{t}.ln_2.bias"] = np.asarray(lp["ln_2"]["bias"])
        sd.update(export_linear(lp["mlp_0"], f"{t}.mlp.0"))
        sd.update(export_linear(lp["mlp_3"], f"{t}.mlp.3"))
    return sd


def export_lstm(params: Mapping, prefix: str, num_layers: int = 1) -> Dict:
    sd: Dict = {}
    for l in range(num_layers):
        sd[f"{prefix}.weight_ih_l{l}"] = np.asarray(params[f"w_ih_l{l}"])
        sd[f"{prefix}.weight_hh_l{l}"] = np.asarray(params[f"w_hh_l{l}"])
        sd[f"{prefix}.bias_ih_l{l}"] = np.asarray(params[f"b_ih_l{l}"])
        sd[f"{prefix}.bias_hh_l{l}"] = np.asarray(params[f"b_hh_l{l}"])
    return sd


def export_norm(block: Mapping, prefix: str) -> Dict:
    return {f"{prefix}.weight": np.asarray(block["scale"]),
            f"{prefix}.bias": np.asarray(block["bias"])}


def export_embedding(block: Mapping, prefix: str) -> Dict:
    return {f"{prefix}.weight": np.asarray(block["embedding"])}


# ------------------------------ full reference models (JAX layout → torch)

def export_reference_lstm_head(head: Mapping, prefix: str = "llm.") -> Dict:
    """Inverse of `convert_reference_lstm_head`: the JAX LanguageHead params
    → the reference LanguageModule's state_dict keys."""
    n = sum(1 for k in head["lstm"] if k.startswith("w_ih_l"))
    sd: Dict = {}
    sd.update(export_linear(head["image_encoder"],
                            f"{prefix}image_encoder.encode"))
    sd.update(export_embedding(head["lookup_table"],
                               f"{prefix}lookup_table"))
    sd.update(export_lstm(head["lstm"], f"{prefix}lstm", num_layers=n))
    sd.update(export_linear(head["linear"], f"{prefix}rnn.linear"))
    return sd


def export_reference_attention_head(head: Mapping,
                                    prefix: str = "llm.") -> Dict:
    """Inverse of `convert_reference_attention_head` (the reference
    Show-Attend-Tell Decoder's state_dict keys)."""
    sd: Dict = {}
    sd.update(export_linear(head["init_h"], f"{prefix}init_h"))
    sd.update(export_linear(head["init_c"], f"{prefix}init_c"))
    sd.update(export_embedding(head["embedding"], f"{prefix}embedding"))
    for torch_name, ours in (("attention.W", "att_W"),
                             ("attention.U", "att_U"),
                             ("attention.v", "att_v"),
                             ("f_beta", "f_beta"),
                             ("deep_output", "deep_output")):
        sd[f"{prefix}{torch_name}.weight"] = np.asarray(
            head[f"{ours}_kernel"]).T
        sd[f"{prefix}{torch_name}.bias"] = np.asarray(head[f"{ours}_bias"])
    for torch_k, ours_k in (("weight_ih", "cell_w_ih"),
                            ("weight_hh", "cell_w_hh"),
                            ("bias_ih", "cell_b_ih"),
                            ("bias_hh", "cell_b_hh")):
        sd[f"{prefix}lstm.{torch_k}"] = np.asarray(head[ours_k])
    return sd


def _export_transformer_block(block: Mapping, prefix: str) -> Dict:
    sd: Dict = {}
    for k in ("values", "keys", "queries", "fc_out"):
        sd.update(export_linear(block["attention"][k],
                                f"{prefix}.attention.{k}"))
    sd.update(export_norm(block["norm1"], f"{prefix}.norm1"))
    sd.update(export_norm(block["norm2"], f"{prefix}.norm2"))
    sd.update(export_linear(block["ff1"], f"{prefix}.feed_forward.0"))
    sd.update(export_linear(block["ff2"], f"{prefix}.feed_forward.2"))
    return sd


def _export_transformer_decoder(dec: Mapping, prefix: str) -> Dict:
    sd: Dict = {}
    sd.update(export_embedding(dec["word_embedding"],
                               f"{prefix}word_embedding"))
    sd[f"{prefix}position_embedding.weight"] = np.asarray(
        dec["position_embedding"])
    sd.update(export_linear(dec["fc_out"], f"{prefix}fc_out"))
    n = sum(1 for k in dec if str(k).startswith("layer_"))
    for i in range(n):
        lp = dec[f"layer_{i}"]
        t = f"{prefix}layers.{i}"
        sd.update(export_norm(lp["norm"], f"{t}.norm"))
        for k in ("values", "keys", "queries", "fc_out"):
            sd.update(export_linear(lp["attention"][k],
                                    f"{t}.attention.{k}"))
        sd.update(_export_transformer_block(lp["transformer_block"],
                                            f"{t}.transformer_block"))
    return sd


def export_reference_transformer(tree: Mapping,
                                 prefix: str = "") -> Dict:
    """Inverse of `convert_reference_transformer`: the JAX {fc, encoder,
    decoder} param trees → the reference Transformer's state_dict."""
    sd: Dict = {}
    sd.update(export_linear(tree["fc"], f"{prefix}fc.0"))
    enc = tree["encoder"]
    sd[f"{prefix}encoder.position_embedding.weight"] = np.asarray(
        enc["position_embedding"])
    n = sum(1 for k in enc if str(k).startswith("layer_"))
    for i in range(n):
        sd.update(_export_transformer_block(
            enc[f"layer_{i}"], f"{prefix}encoder.layers.{i}"))
    sd.update(_export_transformer_decoder(tree["decoder"],
                                          f"{prefix}decoder."))
    return sd


def export_reference_vitb_decoder(dec: Mapping,
                                  prefix: str = "decoder.") -> Dict:
    """Inverse of `convert_reference_vitb_decoder`."""
    return _export_transformer_decoder(dec, prefix)


def export_sequential_resnet(variables: Mapping,
                             prefix: str = "features.") -> Dict:
    """Inverse of `convert_sequential_resnet`: torchvision-named export
    renumbered back to the reference's `nn.Sequential(*children[:-2])`
    scheme. Stage sizes are read off the param tree."""
    params = variables["params"]
    stages = tuple(
        sum(1 for k in params if str(k).startswith(f"layer{s}_"))
        for s in (1, 2, 3, 4))
    tv = export_resnet(variables, stages=stages)
    inverse = {v: k for k, v in _SEQ_RESNET_MAP.items()}
    sd: Dict = {}
    for k, v in tv.items():
        head, _, tail = k.partition(".")
        sd[f"{prefix}{inverse[head]}.{tail}"] = v
    return sd


def detect_our_family(params: Mapping) -> str:
    """Which captioner family does this param tree belong to?"""
    if "encoder_vit" in params:
        return "vitb"
    if "classifier" in params:                 # GTDenseCaptioner
        return "gt"
    if "encoder" in params and "decoder" in params:
        return "transformer"
    if "llm" in params and "att_W_kernel" in params["llm"]:
        return "attention"
    if "llm" in params:
        return "lstm"
    raise ValueError("unrecognized captioner param tree")


def export_reference_captioner(variables: Mapping,
                               family: str = "auto") -> Tuple[Dict, Dict]:
    """Inverse of `convert_reference_captioner`: the JAX trained captioner
    variables {'params', 'batch_stats'} → a state_dict loadable by the
    reference's torch model of the same family ("same checkpoints",
    both directions — BASELINE.json). Returns (state_dict, meta)."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    if family == "auto":
        family = detect_our_family(params)
    if family == "gt":
        return export_reference_gt_model(variables)
    meta: Dict = {"family": family}

    if family == "vitb":
        heads = int(np.shape(
            params["encoder_vit"]["encoder_layer_0"]["self_attention"]
            ["query"]["kernel"])[1])
        hidden = int(np.shape(params["encoder_vit"]["class_token"])[-1])
        n_enc = sum(1 for k in params["encoder_vit"]
                    if str(k).startswith("encoder_layer_"))
        tv = export_vit({"params": params["encoder_vit"]},
                        num_layers=n_enc, num_heads=heads, hidden=hidden)
        sd = {("proj." + k[len("conv_proj."):]
               if k.startswith("conv_proj.") else k): v
              for k, v in tv.items()}
        sd.update(export_reference_vitb_decoder(params["decoder"]))
        meta.update(vit_encoder_layers=n_enc, vit_hidden=hidden,
                    vit_heads=heads)
        return sd, meta

    feats = params["features"]
    if "conv1" in feats:                                      # resnet
        sd = export_sequential_resnet(
            {"params": feats,
             "batch_stats": (stats or {}).get("features", {})})
        meta["encoder"] = "resnet"
    else:                                                     # vggface
        sd = export_vgg_features({"params": feats}, prefix="features")
        meta["encoder"] = "vggface"

    if family == "transformer":
        sd.update(export_reference_transformer(
            {k: params[k] for k in ("fc", "encoder", "decoder")},
            prefix="llm."))
    elif family == "attention":
        sd.update(export_reference_attention_head(params["llm"]))
    else:
        sd.update(export_reference_lstm_head(params["llm"]))
    return sd, meta


def save_state_dict(path: str, sd: Mapping) -> None:
    """Write a flat tensor dict as a torch `.pth`, or as a numpy `.npz`
    where `path` ends so."""
    if path.endswith(".npz"):
        np.savez(path, **{k: np.asarray(v) for k, v in sd.items()})
        return
    torch.save({k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
                for k, v in sd.items()}, path)


def load_state_dict(path: str) -> Dict:
    """A torch `.pth` state dict (read with `weights_only=True`) or its
    `.npz` re-export → a flat name → ndarray dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}
