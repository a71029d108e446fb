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
- `gt_train_state_from_jax`: a JAX GT training state (params and the
  optax Adam state of each group) → the port's model and optimizer state
  dicts, so that a JAX run resumes in the port.
- `seeded_init_`: random weights from a seed, for serving or training
  without a trained checkpoint.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

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


def transformer_head_state_dict(params: Mapping, prefix: str = "llm"
                                ) -> Dict[str, torch.Tensor]:
    """The GT transformer head's params ({fc, encoder, decoder}) → the
    reference AlexTransformer's keys (`fc.0`, `encoder.*`, `decoder.*`)."""
    enc, dec = params["encoder"], params["decoder"]
    sd = _linear(params["fc"], f"{prefix}.fc.0")
    sd[f"{prefix}.encoder.position_embedding.weight"] = _t(
        enc["position_embedding"])
    i = 0
    while f"layer_{i}" in enc:
        sd.update(_transformer_block_state_dict(
            enc[f"layer_{i}"], f"{prefix}.encoder.layers.{i}"))
        i += 1
    sd[f"{prefix}.decoder.word_embedding.weight"] = _t(
        dec["word_embedding"]["embedding"])
    sd[f"{prefix}.decoder.position_embedding.weight"] = _t(
        dec["position_embedding"])
    sd.update(_linear(dec["fc_out"], f"{prefix}.decoder.fc_out"))
    i = 0
    while f"layer_{i}" in dec:
        layer, t = dec[f"layer_{i}"], f"{prefix}.decoder.layers.{i}"
        sd.update(_norm(layer["norm"], f"{t}.norm"))
        sd.update(_attention_state_dict(layer["attention"],
                                        f"{t}.attention"))
        sd.update(_transformer_block_state_dict(layer["transformer_block"],
                                                f"{t}.transformer_block"))
        i += 1
    return sd


def gt_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `GTDenseCaptioner` params (either head) → the port's
    state_dict in the reference AlexGTModel key layout."""
    sd = vgg_features_state_dict(params["features"])
    last = sd[max((k for k in sd if k.endswith(".weight")),
                  key=lambda k: int(k.split(".")[1]))]
    sd.update(vgg_classifier_state_dict(params["classifier"],
                                        channels=last.shape[0]))
    if "llm" in params:
        sd.update(language_head_state_dict(params["llm"]))
    else:
        sd.update(transformer_head_state_dict(params))
    return sd


def _fill(params, tree):
    """`tree` shaped like `params`, with zeros where it holds no array
    (optax's `MaskedNode` marks another group's leaf)."""
    if isinstance(params, Mapping):
        return {k: _fill(v, tree.get(k) if isinstance(tree, Mapping) else None)
                for k, v in params.items()}
    return tree if hasattr(tree, "shape") else np.zeros_like(params)


def gt_train_state_from_jax(params: Mapping, adam: Mapping,
                            optimizer) -> Tuple[Dict, Dict]:
    """A JAX GT training state → (the port's model state_dict, the state
    dict for `optimizer`, a `DenseAdam` that `make_dense_optimizer` built
    over the port's model).

    `params` is the JAX params tree; `adam` maps each optax group name of
    `make_dense_optimizer` ("encoder", "head") to its `scale_by_adam`
    state (count, mu, nu), the moments as trees shaped like `params`
    whose leaves outside the group are anything but arrays. The moments
    go through the same layout conversion as the weights."""
    opt_sd = optimizer.state_dict()
    state = {}
    for group in opt_sd["param_groups"]:
        count, mu, nu = adam[group["group"]]
        mu_sd = gt_state_dict_from_jax(_fill(params, mu))
        nu_sd = gt_state_dict_from_jax(_fill(params, nu))
        for idx, name in zip(group["params"], group["names"]):
            state[idx] = {"step": torch.tensor(float(count)),
                          "exp_avg": mu_sd[name], "exp_avg_sq": nu_sd[name]}
    opt_sd["state"] = state
    return gt_state_dict_from_jax(params), opt_sd


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
    weight (torch's nn.Linear bound), biases included. Returns `module`."""
    params = dict(module.named_parameters())
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(seed)
    for name, p in params.items():
        weight = params.get(name.replace("bias", "weight"), p)
        fan_in = weight[0].numel() if weight.dim() > 1 else weight.numel()
        bound = 1.0 / math.sqrt(fan_in)
        p.uniform_(-bound, bound, generator=gen)
    return module
