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
- `lstm_train_state_from_jax`: a JAX AlexCap LSTM training state (params,
  BatchNorm statistics, the optax state of `make_optimizer`) → the port's
  model and `AlexAdam` state dicts, Adam's moments and counts and the
  frozen phase's gate carried over.
- `load_lstm_checkpoint`: a port training checkpoint or a reference
  `LSTMModel` state dict saved with `torch.save` → the model's state dict.
- `seeded_init_`: random weights from a seed, for serving or training
  without a trained checkpoint (a model's `ZERO_INIT` parameters stay
  zero; BatchNorm weights 1 and biases 0, torch's init).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Tuple

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


def lstm_captioner_state_dict_from_jax(params: Mapping,
                                       batch_stats: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """JAX `LSTMCaptioner` params and `batch_stats` → the port's
    state_dict, weights and BatchNorm running statistics, in the reference
    `LSTMModel` key layout (a VGG trunk has no statistics)."""
    if "bn1" in params["features"]:
        sd = resnet_state_dict(params["features"], batch_stats["features"])
    else:
        sd = vgg_features_state_dict(params["features"])
    sd.update(language_head_state_dict(params["llm"]))
    return sd


def lstm_train_state_from_jax(params: Mapping, batch_stats: Mapping,
                              opt_state, optimizer) -> Tuple[Dict, Dict]:
    """A JAX AlexCap LSTM training state → (the port's model state_dict,
    the state dict for `optimizer`, an `AlexAdam` that `make_optimizer`
    built over the port's model).

    `opt_state` is `make_optimizer`'s optax state: the clip's, then the
    `multi_transform` over `encoder` and `head`, each a chain whose Adam
    state (`ScaleByAdamState`) is found inside, the encoder's behind
    `gate_until`'s count. An Adam that has not yet taken a step (the
    encoder before the finetune boundary) leaves its parameters without
    state, as torch's Adam leaves a parameter that has had no gradient.
    Each group's `updates` is the head's Adam count: the updates taken."""
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

    inner = next(t for t in opt_state if hasattr(t, "inner_states"))
    adams = {name: adam_state(inner.inner_states[name])
             for name in inner.inner_states}

    def convert(tree):
        return lstm_captioner_state_dict_from_jax(tree, batch_stats)
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


def load_lstm_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a port training checkpoint (its `model`
    entry), or a reference `LSTMModel` state dict saved with
    `torch.save`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model"] if isinstance(sd.get("model"), Mapping) else sd


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
    weight (torch's nn.Linear bound), biases included; those whose names
    start with an entry of the module's `ZERO_INIT` (the RPN's deltas
    and box refinement, zero-initialised in JAX) are zeroed. Returns
    `module`."""
    zero = getattr(module, "ZERO_INIT", ())
    params = dict(module.named_parameters())
    norms = {f"{n}.{k}" for n, m in module.named_modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)
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
