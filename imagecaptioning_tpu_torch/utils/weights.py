"""Weights carried into the port.

- `gt_state_dict_from_jax`: the JAX `GTDenseCaptioner` params tree
  (nested dicts of numpy arrays) → the port's `state_dict`, which is the
  reference AlexGTModel key layout. The layout logic is a copy of
  `imagecaptioning_tpu/utils/torch_port.py` (`export_conv`/`export_linear`
  :610-622, `export_vgg_features`/`export_vgg_classifier` :664-687,
  `export_lstm`/`export_reference_lstm_head` :730-762), not an import.
- `load_gt_checkpoint`: a `torch.save`d state dict in that layout (what
  the JAX package's `export_reference_gt_model` + `save_state_dict`
  write, or a reference `.pth`), minus the reference's duplicate `net.*`
  registrations of the same tensors.
- `seeded_init_`: random weights from a seed, for serving without a
  trained checkpoint.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

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
    return {f"{prefix}.weight": _t(np.asarray(block["kernel"]).T),
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


def gt_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `GTDenseCaptioner` (use_lstm=True) params → the port's
    state_dict in the reference AlexGTModel key layout."""
    sd = vgg_features_state_dict(params["features"])
    last = sd[max((k for k in sd if k.endswith(".weight")),
                  key=lambda k: int(k.split(".")[1]))]
    sd.update(vgg_classifier_state_dict(params["classifier"],
                                        channels=last.shape[0]))
    sd.update(language_head_state_dict(params["llm"]))
    return sd


def load_gt_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference-layout GT state dict saved with `torch.save`,
    dropping the `net.vgg16_backbone.*`/`net.full_conv.*` duplicates the
    reference registers for the same tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not k.startswith("net.")}


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
