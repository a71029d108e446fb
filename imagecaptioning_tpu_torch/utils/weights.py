"""Weights carried into the port.

- `gt_state_dict_from_jax`: the JAX `GTDenseCaptioner` params tree
  (nested dicts of numpy arrays) → the port's `state_dict`, which is the
  reference AlexGTModel key layout. The layout logic is a copy of
  `imagecaptioning_tpu/utils/torch_port.py` (`export_conv`/`export_linear`
  :610-622, `export_vgg_features`/`export_vgg_classifier` :664-687,
  `export_lstm`/`export_reference_lstm_head` :730-762,
  `export_reference_transformer` and its block and decoder helpers
  :789-836), not an import.
- `load_gt_checkpoint`: a `torch.save`d state dict in that layout (what
  the JAX package's `export_reference_gt_model` + `save_state_dict`
  write, or a reference `.pth`), minus the reference's duplicate `net.*`
  registrations of the same tensors and, for the transformer head, its
  dead encoder word embedding and the encoder position rows after row 0.
- `rpn_state_dict_from_jax`: the JAX `DenseCapRPN` params → the port's
  `DenseCapRPN` state_dict (JAX's module names, torch layouts), from the
  same trunk, classifier and LSTM-head helpers; the RPN's convolutions
  go HWIO → OIHW.
- `gt_train_state_from_jax` / `rpn_train_state_from_jax`: a JAX GT or
  RPN training state (params and the optax Adam state of each group) →
  the port's model and optimizer state dicts, so that a JAX run resumes
  in the port.
- `lstm_captioner_state_dict_from_jax`: the JAX AlexCap `LSTMCaptioner`
  params and BatchNorm statistics → the port's `LSTMCaptioner`
  state_dict, the reference `LSTMModel` key layout (`features.{0,1,4-7}`
  for the ResNet trunk as `nn.Sequential(*resnet.children())[:-2]`
  numbers it, or the VGG trunk's `features.{idx}`; `llm.*`), after
  `export_sequential_resnet`, `export_bn` and `export_reference_lstm_head`
  (`utils/torch_port.py:637-662, 845-862, 751-762`).
- `captioner_train_state_from_jax`: a JAX AlexCap training state (params,
  BatchNorm statistics, the optax state of `make_optimizer`) of any family
  → the port's model and `AlexAdam`/`AlexAdamW` state dicts, the moments
  and counts and the frozen phase's gate carried over.
- `captioner_state_dict_from_jax`: the JAX params (and BatchNorm
  statistics) of any AlexCap family → the port's state dict: the
  attention head's `llm.{init_h, init_c, embedding, attention.{W,U,v},
  f_beta, deep_output, lstm}` (`export_reference_attention_head`,
  :711-733), the Transformer's `llm.{fc.0, encoder, decoder}`
  (`export_reference_transformer`, :789-802), the ViT's `encoder_vit.*`
  in torchvision's `vit_b_16` names (`export_vit`, :689-727) and its
  `decoder.*` (`export_reference_vitb_decoder`);
  `load_alexcap_checkpoint` reads a port checkpoint or a
  reference state dict of any family (VitbModel's `proj.*`,
  `class_token` and `encoder.*` → `encoder_vit.conv_proj.*`, … as
  `convert_reference_captioner`, :506-597, renames them).
- `vit_flat_variables`: the inverse of `vit_state_dict`, a ViT
  encoder's tensors in the flat `.npz` layout `encoder_init` reads (the
  JAX package's `flatten_tree` of its params).
- `seeded_init_`: random weights from a seed, for serving or training
  without a trained checkpoint (a model's `ZERO_INIT` parameters stay
  zero; BatchNorm and LayerNorm weights 1 and biases 0, torch's init).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.vgg import VGG16_STAGES


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # own copy


def _conv(block: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    # flax (kh, kw, I, O) → torch (O, I, kh, kw)
    return {f"{prefix}.weight": _t(np.asarray(block["kernel"])
                                   .transpose(3, 2, 0, 1)),
            f"{prefix}.bias": _t(block["bias"])}


def _linear(block: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    sd = {f"{prefix}.weight": _t(np.asarray(block["kernel"]).T)}
    if "bias" in block:
        sd[f"{prefix}.bias"] = _t(block["bias"])
    return sd


def _norm(block: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(block["scale"]),
            f"{prefix}.bias": _t(block["bias"])}


def vgg_conv_indices():
    """torchvision vgg16.features module indices of the 13 convs."""
    idx, out = 0, []
    for stage in VGG16_STAGES:
        for _ in stage:
            out.append(idx)
            idx += 2      # conv + relu
        idx += 1          # maxpool
    return out


def vgg_features_state_dict(params: Mapping,
                            prefix: str = "features") -> Dict[str, torch.Tensor]:
    """VGGFeatures params (`conv{stage}_{i}`) → `features.{idx}.*`; as
    many stages as the tree holds."""
    sd: Dict[str, torch.Tensor] = {}
    conv_idx = iter(vgg_conv_indices())
    for stage, chans in enumerate(VGG16_STAGES):
        if f"conv{stage + 1}_1" not in params:
            break
        for i in range(len(chans)):
            sd.update(_conv(params[f"conv{stage + 1}_{i + 1}"],
                            f"{prefix}.{next(conv_idx)}"))
    return sd


def vgg_classifier_state_dict(params: Mapping, channels: int,
                              prefix: str = "classifier"
                              ) -> Dict[str, torch.Tensor]:
    """VGGClassifierHead params → `classifier.0/.3`. JAX flattens the
    pooled (oh, ow, C) code in HWC order; the reference (and the port)
    flatten CHW, so fc6's input rows are reordered."""
    w = np.asarray(params["fc6"]["kernel"])            # (oh*ow*C HWC, 4096)
    side = math.isqrt(w.shape[0] // channels)
    if side * side * channels != w.shape[0]:
        raise ValueError(f"fc6 has {w.shape[0]} input rows, not a square "
                         f"pooled map of {channels} channels")
    w = (w.reshape(side, side, channels, -1).transpose(2, 0, 1, 3)
         .reshape(w.shape[0], -1))
    sd = _linear({"kernel": w, "bias": params["fc6"]["bias"]}, f"{prefix}.0")
    sd.update(_linear(params["fc7"], f"{prefix}.3"))
    return sd


def lstm_state_dict(params: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """LSTM params (`w_ih_l{k}` …) → torch `nn.LSTM` names."""
    sd: Dict[str, torch.Tensor] = {}
    layer = 0
    while f"w_ih_l{layer}" in params:
        for jax_name, torch_name in (("w_ih", "weight_ih"),
                                     ("w_hh", "weight_hh"),
                                     ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"{prefix}.{torch_name}_l{layer}"] = _t(
                params[f"{jax_name}_l{layer}"])
        layer += 1
    return sd


def language_head_state_dict(params: Mapping,
                             prefix: str = "llm") -> Dict[str, torch.Tensor]:
    """LanguageHead params → the reference LanguageModule's keys."""
    sd = _linear(params["image_encoder"], f"{prefix}.image_encoder.encode")
    sd[f"{prefix}.lookup_table.weight"] = _t(
        params["lookup_table"]["embedding"])
    sd.update(lstm_state_dict(params["lstm"], f"{prefix}.lstm"))
    sd.update(_linear(params["linear"], f"{prefix}.rnn.linear"))
    return sd


def _attention_state_dict(attention: Mapping, prefix: str
                          ) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for name in ("values", "keys", "queries", "fc_out"):
        sd.update(_linear(attention[name], f"{prefix}.{name}"))
    return sd


def _transformer_block_state_dict(block: Mapping, prefix: str
                                  ) -> Dict[str, torch.Tensor]:
    sd = _attention_state_dict(block["attention"], f"{prefix}.attention")
    sd.update(_norm(block["norm1"], f"{prefix}.norm1"))
    sd.update(_norm(block["norm2"], f"{prefix}.norm2"))
    sd.update(_linear(block["ff1"], f"{prefix}.feed_forward.0"))
    sd.update(_linear(block["ff2"], f"{prefix}.feed_forward.2"))
    return sd


def transformer_decoder_state_dict(dec: Mapping, prefix: str
                                   ) -> Dict[str, torch.Tensor]:
    """A `Decoder`'s params → the reference decoder's keys under
    `prefix`."""
    sd = {f"{prefix}.word_embedding.weight": _t(
              dec["word_embedding"]["embedding"]),
          f"{prefix}.position_embedding.weight": _t(
              dec["position_embedding"])}
    sd.update(_linear(dec["fc_out"], f"{prefix}.fc_out"))
    i = 0
    while f"layer_{i}" in dec:
        layer, t = dec[f"layer_{i}"], f"{prefix}.layers.{i}"
        sd.update(_norm(layer["norm"], f"{t}.norm"))
        sd.update(_attention_state_dict(layer["attention"],
                                        f"{t}.attention"))
        sd.update(_transformer_block_state_dict(layer["transformer_block"],
                                                f"{t}.transformer_block"))
        i += 1
    return sd


def transformer_head_state_dict(params: Mapping, prefix: str = "llm"
                                ) -> Dict[str, torch.Tensor]:
    """A transformer head's params ({fc, encoder, decoder}: the GT head's
    or the AlexCap Transformer's) → the reference's keys (`fc.0`,
    `encoder.*`, `decoder.*`)."""
    enc = params["encoder"]
    sd = _linear(params["fc"], f"{prefix}.fc.0")
    sd[f"{prefix}.encoder.position_embedding.weight"] = _t(
        enc["position_embedding"])
    i = 0
    while f"layer_{i}" in enc:
        sd.update(_transformer_block_state_dict(
            enc[f"layer_{i}"], f"{prefix}.encoder.layers.{i}"))
        i += 1
    sd.update(transformer_decoder_state_dict(params["decoder"],
                                             f"{prefix}.decoder"))
    return sd


def gt_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `GTDenseCaptioner` params (either head) → the port's
    state_dict in the reference AlexGTModel key layout."""
    sd = vgg_features_state_dict(params["features"])
    sd.update(vgg_classifier_state_dict(
        params["classifier"], channels=_trunk_channels(sd, "features")))
    if "llm" in params:
        sd.update(language_head_state_dict(params["llm"]))
    else:
        sd.update(transformer_head_state_dict(params))
    return sd


def _trunk_channels(sd: Mapping[str, torch.Tensor], prefix: str) -> int:
    """Output channels of the last convolution of the trunk `prefix`."""
    convs = [k for k in sd if k.startswith(prefix + ".")
             and k.endswith(".weight")]
    return sd[max(convs, key=lambda k: int(k.split(".")[1]))].shape[0]


def rpn_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `DenseCapRPN` params → the port's `DenseCapRPN` state_dict."""
    sd = vgg_features_state_dict(params["conv_trunk"], prefix="conv_trunk")
    sd.update(vgg_classifier_state_dict(
        params["recog_base"], channels=_trunk_channels(sd, "conv_trunk"),
        prefix="recog_base"))
    for name in ("rpn_conv", "rpn_scores", "rpn_trans"):
        sd.update(_conv(params[name], name))
    for name in ("objectness", "box_reg"):
        sd.update(_linear(params[name], name))
    if "llm" in params:
        sd.update(language_head_state_dict(params["llm"]))
    return sd


def _fill(params, tree):
    """`tree` shaped like `params`, with zeros where it holds no array
    (optax's `MaskedNode` marks another group's leaf)."""
    if isinstance(params, Mapping):
        return {k: _fill(v, tree.get(k) if isinstance(tree, Mapping) else None)
                for k, v in params.items()}
    return tree if hasattr(tree, "shape") else np.zeros_like(params)


def _train_state_from_jax(params: Mapping, adam: Mapping, optimizer,
                          convert: Callable[[Mapping], Dict]
                          ) -> Tuple[Dict, Dict]:
    """A JAX training state → (the port's model state_dict, the state dict
    for `optimizer`, a `DenseAdam` that `make_dense_optimizer` built over
    the port's model), with `convert` the model's params converter.

    `params` is the JAX params tree; `adam` maps each optax group name of
    `make_dense_optimizer` ("encoder", "head") to its `scale_by_adam`
    state (count, mu, nu), the moments as trees shaped like `params`
    whose leaves outside the group are anything but arrays. The moments
    go through the same layout conversion as the weights."""
    opt_sd = optimizer.state_dict()
    state = {}
    for group in opt_sd["param_groups"]:
        count, mu, nu = adam[group["group"]]
        mu_sd = convert(_fill(params, mu))
        nu_sd = convert(_fill(params, nu))
        for idx, name in zip(group["params"], group["names"]):
            state[idx] = {"step": torch.tensor(float(count)),
                          "exp_avg": mu_sd[name], "exp_avg_sq": nu_sd[name]}
    opt_sd["state"] = state
    return convert(params), opt_sd


def gt_train_state_from_jax(params: Mapping, adam: Mapping,
                            optimizer) -> Tuple[Dict, Dict]:
    """A JAX GT training state → the port's (model, optimizer) state
    dicts (see `_train_state_from_jax`)."""
    return _train_state_from_jax(params, adam, optimizer,
                                 gt_state_dict_from_jax)


def rpn_train_state_from_jax(params: Mapping, adam: Mapping,
                             optimizer) -> Tuple[Dict, Dict]:
    """A JAX RPN training state → the port's (model, optimizer) state
    dicts (see `_train_state_from_jax`)."""
    return _train_state_from_jax(params, adam, optimizer,
                                 rpn_state_dict_from_jax)


def _bn(params: Mapping, stats: Mapping,
        prefix: str) -> Dict[str, torch.Tensor]:
    sd = _norm(params, prefix)
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    # torch's step counter, which flax has not
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def resnet_state_dict(params: Mapping, stats: Mapping,
                      prefix: str = "features") -> Dict[str, torch.Tensor]:
    """ResNetFeatures params and batch stats (`conv1`, `bn1`,
    `layer{s}_{b}`) → `nn.Sequential(*resnet.children())[:-2]` keys:
    `{prefix}.0` conv1, `.1` bn1, `.4`–`.7` layer1–4; as many blocks as the
    tree holds."""
    def conv(block):     # flax (kh, kw, I, O) → torch (O, I, kh, kw)
        return _t(np.asarray(block["kernel"]).transpose(3, 2, 0, 1))
    sd = {f"{prefix}.0.weight": conv(params["conv1"])}
    sd.update(_bn(params["bn1"], stats["bn1"], f"{prefix}.1"))
    stage = 1
    while f"layer{stage}_0" in params:
        b = 0
        while f"layer{stage}_{b}" in params:
            bp, bs = params[f"layer{stage}_{b}"], stats[f"layer{stage}_{b}"]
            t = f"{prefix}.{stage + 3}.{b}"
            for i in (1, 2, 3):
                sd[f"{t}.conv{i}.weight"] = conv(bp[f"conv{i}"])
                sd.update(_bn(bp[f"bn{i}"], bs[f"bn{i}"], f"{t}.bn{i}"))
            if "downsample_conv" in bp:
                sd[f"{t}.downsample.0.weight"] = conv(bp["downsample_conv"])
                sd.update(_bn(bp["downsample_bn"], bs["downsample_bn"],
                              f"{t}.downsample.1"))
            b += 1
        stage += 1
    return sd


def _trunk_state_dict(params: Mapping, batch_stats: Optional[Mapping]
                      ) -> Dict[str, torch.Tensor]:
    """The CNN captioners' `features`: ResNet (with its statistics) or
    VGG."""
    if "bn1" in params["features"]:
        return resnet_state_dict(params["features"], batch_stats["features"])
    return vgg_features_state_dict(params["features"])


def lstm_captioner_state_dict_from_jax(params: Mapping,
                                       batch_stats: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """JAX `LSTMCaptioner` params and `batch_stats` → the port's
    state_dict, weights and BatchNorm running statistics, in the reference
    `LSTMModel` key layout (a VGG trunk has no statistics)."""
    sd = _trunk_state_dict(params, batch_stats)
    sd.update(language_head_state_dict(params["llm"]))
    return sd


def attention_head_state_dict(params: Mapping, prefix: str = "llm"
                              ) -> Dict[str, torch.Tensor]:
    """AttentionHead params → the reference Show-Attend-Tell decoder's
    keys (its `nn.LSTMCell` as `lstm.weight_ih` …)."""
    sd = _linear(params["init_h"], f"{prefix}.init_h")
    sd.update(_linear(params["init_c"], f"{prefix}.init_c"))
    sd[f"{prefix}.embedding.weight"] = _t(params["embedding"]["embedding"])
    for torch_name, jax_name in (("attention.W", "att_W"),
                                 ("attention.U", "att_U"),
                                 ("attention.v", "att_v"),
                                 ("f_beta", "f_beta"),
                                 ("deep_output", "deep_output")):
        sd.update(_linear({"kernel": params[f"{jax_name}_kernel"],
                           "bias": params[f"{jax_name}_bias"]},
                          f"{prefix}.{torch_name}"))
    for torch_name, jax_name in (("weight_ih", "cell_w_ih"),
                                 ("weight_hh", "cell_w_hh"),
                                 ("bias_ih", "cell_b_ih"),
                                 ("bias_hh", "cell_b_hh")):
        sd[f"{prefix}.lstm.{torch_name}"] = _t(params[jax_name])
    return sd


def vit_state_dict(params: Mapping, prefix: str = "encoder_vit"
                   ) -> Dict[str, torch.Tensor]:
    """ViTEncoder params → torchvision `vit_b_16` keys under `prefix`:
    flax's per-head q/k/v kernels (D, h, d) become one `in_proj_weight`
    (3D, D), its out kernel (h, d, D) `out_proj.weight` (D, D)."""
    sd = _conv(params["conv_proj"], f"{prefix}.conv_proj")
    sd[f"{prefix}.class_token"] = _t(params["class_token"])
    sd[f"{prefix}.encoder.pos_embedding"] = _t(params["pos_embedding"])
    sd.update(_norm(params["ln"], f"{prefix}.encoder.ln"))
    i = 0
    while f"encoder_layer_{i}" in params:
        lp, t = (params[f"encoder_layer_{i}"],
                 f"{prefix}.encoder.layers.encoder_layer_{i}")
        attn = lp["self_attention"]
        qkv = [np.asarray(attn[n]["kernel"]) for n in ("query", "key",
                                                       "value")]
        d = qkv[0].shape[0]
        sd[f"{t}.self_attention.in_proj_weight"] = _t(np.concatenate(
            [k.reshape(d, d).T for k in qkv]))
        sd[f"{t}.self_attention.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(d)
             for n in ("query", "key", "value")]))
        sd.update(_linear({"kernel": np.asarray(attn["out"]["kernel"])
                           .reshape(d, d), "bias": attn["out"]["bias"]},
                          f"{t}.self_attention.out_proj"))
        sd.update(_norm(lp["ln_1"], f"{t}.ln_1"))
        sd.update(_norm(lp["ln_2"], f"{t}.ln_2"))
        sd.update(_linear(lp["mlp_0"], f"{t}.mlp.0"))
        sd.update(_linear(lp["mlp_3"], f"{t}.mlp.3"))
        i += 1
    return sd


def vit_flat_variables(encoder: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of `vit_state_dict`: a `ViTEncoder`'s tensors as fp32
    numpy arrays under the flat `/`-joined keys of the JAX layout
    (`params/conv_proj/kernel`, `params/encoder_layer_0/self_attention/
    query/kernel` (D, h, d), ...), the `.npz` that `encoder_init`
    reads."""
    def a(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()
    out = {"params/conv_proj/kernel":
           a(encoder.conv_proj.weight).transpose(2, 3, 1, 0),
           "params/conv_proj/bias": a(encoder.conv_proj.bias),
           "params/class_token": a(encoder.class_token),
           "params/pos_embedding": a(encoder.encoder.pos_embedding),
           "params/ln/scale": a(encoder.encoder.ln.weight),
           "params/ln/bias": a(encoder.encoder.ln.bias)}
    for name, block in encoder.encoder.layers.named_children():
        p, attn = f"params/{name}", block.self_attention
        w, b = a(attn.in_proj_weight), a(attn.in_proj_bias)
        dim, heads = w.shape[1], attn.heads
        for n, wn, bn in zip(("query", "key", "value"), np.split(w, 3),
                             np.split(b, 3)):
            out[f"{p}/self_attention/{n}/kernel"] = wn.T.reshape(
                dim, heads, dim // heads)
            out[f"{p}/self_attention/{n}/bias"] = bn.reshape(heads, -1)
        out[f"{p}/self_attention/out/kernel"] = a(
            attn.out_proj.weight).T.reshape(heads, dim // heads, dim)
        out[f"{p}/self_attention/out/bias"] = a(attn.out_proj.bias)
        for ln in ("ln_1", "ln_2"):
            out[f"{p}/{ln}/scale"] = a(getattr(block, ln).weight)
            out[f"{p}/{ln}/bias"] = a(getattr(block, ln).bias)
        for i in (0, 3):
            out[f"{p}/mlp_{i}/kernel"] = a(block.mlp[i].weight).T
            out[f"{p}/mlp_{i}/bias"] = a(block.mlp[i].bias)
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _captioner_family(params: Mapping) -> str:
    """The AlexCap family of a JAX captioner's params tree (`model_type`)."""
    if "encoder_vit" in params:
        return "vitb"
    if "decoder" in params:
        return "transformer"
    if "att_W_kernel" in params["llm"]:
        return "lstm_attention"
    return "lstm"


def captioner_state_dict_from_jax(params: Mapping,
                                  batch_stats: Optional[Mapping] = None
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX params (and BatchNorm statistics, for a ResNet trunk) of
    any AlexCap captioner → the port's state dict."""
    family = _captioner_family(params)
    if family == "vitb":
        sd = vit_state_dict(params["encoder_vit"])
        sd.update(transformer_decoder_state_dict(params["decoder"],
                                                 "decoder"))
        return sd
    sd = _trunk_state_dict(params, batch_stats)
    if family == "transformer":
        sd.update(transformer_head_state_dict(params))
    elif family == "lstm_attention":
        sd.update(attention_head_state_dict(params["llm"]))
    else:
        sd.update(language_head_state_dict(params["llm"]))
    return sd


def captioner_train_state_from_jax(params: Mapping,
                                   batch_stats: Optional[Mapping], opt_state,
                                   optimizer) -> Tuple[Dict, Dict]:
    """A JAX AlexCap training state → (the port's model state_dict, the
    state dict for `optimizer`, an `AlexAdam` or `AlexAdamW` that
    `make_optimizer` built over the port's model).

    `opt_state` is `make_optimizer`'s optax state: the clip's (where
    `clip_grad`), then the `multi_transform` over `encoder` and `head`,
    each a chain whose Adam state (`ScaleByAdamState`) is found inside,
    the encoder's behind `gate_until`'s count; a hard-zero group has none,
    and the port's optimizer no such group. An Adam that has not yet
    taken a step (the encoder before the finetune boundary) leaves its
    parameters without state, as torch's Adam leaves a parameter that
    has had no gradient. Each group's `updates` is the head's Adam count:
    the updates taken."""
    def adam_state(tree):
        if hasattr(tree, "mu") and hasattr(tree, "nu"):
            return tree
        if isinstance(tree, (tuple, list)):
            for leaf in tree:
                found = adam_state(leaf)
                if found is not None:
                    return found
        if isinstance(tree, Mapping):
            for leaf in tree.values():
                found = adam_state(leaf)
                if found is not None:
                    return found
        if hasattr(tree, "inner_states"):
            return adam_state(tree.inner_states)
        if hasattr(tree, "inner_state"):
            return adam_state(tree.inner_state)
        return None

    inner = (opt_state if hasattr(opt_state, "inner_states") else
             next(t for t in opt_state if hasattr(t, "inner_states")))
    adams = {name: adam_state(inner.inner_states[name])
             for name in inner.inner_states}

    def convert(tree):
        return captioner_state_dict_from_jax(tree, batch_stats)
    opt_sd = optimizer.state_dict()
    updates = int(adams["head"].count)
    state = {}
    for group in opt_sd["param_groups"]:
        adam = adams[group["group"]]
        group["updates"] = updates
        if adam is None or int(adam.count) == 0:
            continue
        mu_sd = convert(_fill(params, adam.mu))
        nu_sd = convert(_fill(params, adam.nu))
        for idx, name in zip(group["params"], group["names"]):
            state[idx] = {"step": torch.tensor(float(adam.count)),
                          "exp_avg": mu_sd[name], "exp_avg_sq": nu_sd[name]}
    opt_sd["state"] = state
    return convert(params), opt_sd


def load_alexcap_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a port training checkpoint (its `model`
    entry), or of a reference AlexCap model's `state_dict()` saved with
    `torch.save`: the CNN families' keys are the port's; VitbModel's
    torchvision pieces (`proj.*`, `class_token`, `encoder.*`) go under
    `encoder_vit.`, `proj` renamed `conv_proj` (VitbModel.py:159)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), Mapping):
        return sd["model"]
    if "class_token" not in sd:
        return sd
    out = {}
    for k, v in sd.items():
        if k.startswith("proj."):
            k = "encoder_vit.conv_proj." + k[len("proj."):]
        elif k == "class_token" or k.startswith("encoder."):
            k = "encoder_vit." + k
        out[k] = v
    return out



def load_gt_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference-layout GT state dict saved with `torch.save`,
    dropping the `net.vgg16_backbone.*`/`net.full_conv.*` duplicates the
    reference registers for the same tensors. A transformer head's encoder
    keeps position row 0 only, the one its single projected code reads,
    and loses its `word_embedding`, which the reference's forward never
    uses (AlexTransformer.py:111, :313-316; as the JAX package's
    `convert_reference_gt_model`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith("net.")
          and k != "llm.encoder.word_embedding.weight"}
    positions = "llm.encoder.position_embedding.weight"
    if positions in sd:
        sd[positions] = sd[positions][:1]
    return sd


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from one seeded generator on the parameters'
    device: U(−1/√fan_in, 1/√fan_in) with the fan-in of the tensor's
    weight (torch's nn.Linear bound), biases included; BatchNorm and
    LayerNorm scales 1 and shifts 0 (torch's and flax's init: a scale
    drawn from ±1/√E would shrink every normalized activation to about
    1/√E of its size, and a transformer's decode would all but ignore its
    image); those
    whose names start with an entry of the module's `ZERO_INIT` (the
    RPN's deltas and box refinement, zero-initialised in JAX) are zeroed.
    Returns `module`."""
    zero = getattr(module, "ZERO_INIT", ())
    params = dict(module.named_parameters())
    norms = {f"{n}.{k}" for n, m in module.named_modules()
             if isinstance(m, (nn.modules.batchnorm._BatchNorm,
                               nn.LayerNorm))
             for k in ("weight", "bias")}
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(seed)
    for name, p in params.items():
        if name in norms:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
            continue
        weight = params.get(name.replace("bias", "weight"), p)
        fan_in = weight[0].numel() if weight.dim() > 1 else weight.numel()
        bound = 1.0 / math.sqrt(fan_in)
        p.uniform_(-bound, bound, generator=gen)
        if name.startswith(zero):
            p.zero_()
    return module
