"""Pretrained-encoder initialization of the training drivers — port of
`imagecaptioning_tpu/utils/pretrained.py`.

The reference builds every model from pretrained weights (ResNet-101 or
VGGFace, `AlexCap/LSTMModel.py:18-27`; ViT-B/16, `VitbModel.py:156-166`;
VGG16 for the dense models, `DenseCap/densecap/net_utils.py:8-13`). The
config field `encoder_init` names converted
`.npz` files in the JAX package's layout (`convert_checkpoint.py
import`: the module's flax variables, `/`-joined paths such as
`params/conv1/kernel` and `batch_stats/bn1/mean`), each merged into one
module of the seeded model through the port's own converters
(`utils/weights.py`). The merge demands an exact structural match: every
leaf of the file is read, every tensor of the module is written, at its
shape, and BatchNorm statistics are in the file iff the module has them;
anything else raises, so a wrong or partial file never trains silently.

Spec syntax (the `encoder_init` value): `"r101.npz"` for the model's
default module — `features` for the CNN captioners and the GT model,
`encoder_vit` for ViT-B (`captioners.encoder_name`), `conv_trunk` for the
RPN model — or explicit modules, `"features=a.npz,classifier=b.npz"`. A
module is a ResNet or VGG trunk, a ViT encoder, or a VGG classifier head
(`classifier` of the GT model, `recog_base` of the RPN model; JAX
flattens its pooled input in HWC order, the port in CHW, and the
converter reorders fc6's rows).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Set, Tuple

import numpy as np
import torch
from torch import nn

from imagecaptioning_tpu_torch.models.backbones.resnet import ResNetFeatures
from imagecaptioning_tpu_torch.models.backbones.vgg import VGGClassifierHead
from imagecaptioning_tpu_torch.models.backbones.vit import ViTEncoder
from imagecaptioning_tpu_torch.utils import weights


def flatten_tree(tree: Mapping, prefix: str = "",
                 sep: str = "/") -> Dict:
    """A nested variables tree → its leaves under `sep`-joined paths
    (`params/conv1/kernel`), the `.npz` layout; the inverse of
    `unflatten_tree`."""
    out: Dict = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key, sep))
        else:
            out[key] = v
    return out


def unflatten_tree(flat: Mapping, sep: str = "/") -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(sep)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_npz_variables(path: str) -> Dict:
    """A converted `.npz` → its nested variables tree, {'params': ...} and,
    for a trunk with BatchNorm, 'batch_stats'."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def parse_spec(spec: str, default_module: str) -> List[Tuple[str, str]]:
    """'path' | 'mod=path[,mod2=path2...]' → [(module, path), ...]."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        mod, path = part.split("=", 1) if "=" in part else (default_module,
                                                            part)
        out.append((mod.strip(), path.strip()))
    if not out:
        raise ValueError(f"empty encoder_init spec: {spec!r}")
    return out


class _Missing(KeyError):
    pass


class _Reads(Mapping):
    """A read-only view of a nested tree that records the path of every
    leaf read through it, and names the full path of a missing one."""

    def __init__(self, tree: Mapping, path: str, seen: Set[str]):
        self._tree, self._path, self._seen = tree, path, seen

    def __getitem__(self, key):
        path = f"{self._path}/{key}"
        if key not in self._tree:
            raise _Missing(path)
        value = self._tree[key]
        if isinstance(value, Mapping):
            return _Reads(value, path, self._seen)
        self._seen.add(path)
        return value

    def __contains__(self, key) -> bool:
        return key in self._tree

    def __iter__(self):
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _leaves(tree: Mapping, path: str) -> List[str]:
    out = []
    for k, v in tree.items():
        p = f"{path}/{k}"
        out += _leaves(v, p) if isinstance(v, Mapping) else [p]
    return out


def _convert(model: nn.Module, module: nn.Module, name: str, params: Mapping,
             stats: Mapping) -> Dict[str, torch.Tensor]:
    if isinstance(module, ViTEncoder):
        return weights.vit_state_dict(params, prefix=name)
    if isinstance(module, ResNetFeatures):
        return weights.resnet_state_dict(params, stats, prefix=name)
    if isinstance(module, VGGClassifierHead):
        oh, ow = model.roi_size               # the pooled code's side
        return weights.vgg_classifier_state_dict(
            params, channels=module[0].in_features // (oh * ow), prefix=name)
    return weights.vgg_features_state_dict(params, prefix=name)


def module_state_dict(model: nn.Module, module: str,
                      variables: Mapping) -> Dict[str, torch.Tensor]:
    """`variables` (a converted module's tree) → the state dict of
    `model.<module>`, keys relative to it, after the exact structural
    check (module docstring)."""
    target = getattr(model, module, None)
    if not isinstance(target, nn.Module):
        raise KeyError(f"encoder_init: model has no module {module!r}; its "
                       f"modules: {sorted(dict(model.named_children()))}")
    has_stats = any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                    for m in target.modules())
    if ("batch_stats" in variables) != has_stats:
        raise ValueError(
            f"encoder_init: batch_stats mismatch for {module!r}: checkpoint "
            f"has stats={'batch_stats' in variables}, model has "
            f"stats={has_stats}")
    seen: Set[str] = set()
    try:
        sd = _convert(model, target, module,
                      _Reads(variables.get("params", {}), "params", seen),
                      _Reads(variables.get("batch_stats", {}), "batch_stats",
                             seen))
    except _Missing as e:
        raise ValueError(f"encoder_init {module}: missing from checkpoint: "
                         f"{e.args[0]}") from None
    unread = sorted(set(_leaves(variables, "")) - {f"/{p}" for p in seen})
    want = {f"{module}.{k}": v for k, v in target.state_dict().items()}
    if unread or sorted(sd) != sorted(want):
        raise ValueError(
            f"encoder_init {module}: checkpoint does not cover the module "
            f"exactly; unexpected in checkpoint: {unread[:8]}; missing from "
            f"checkpoint: {sorted(set(want) - set(sd))[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"encoder_init {module}: shape mismatch at {k}: "
                             f"model {tuple(want[k].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
    return {k[len(module) + 1:]: v for k, v in sd.items()}


def default_module_for(model_type: str) -> str:
    """The module a bare `encoder_init` path initializes (module
    docstring)."""
    return {"vitb": "encoder_vit", "rpn": "conv_trunk"}.get(
        model_type, "features")


def apply_encoder_init(model: nn.Module, spec: str,
                       default_module: str) -> nn.Module:
    """Merge the converted encoder weights `spec` names into `model`, in
    place, each tensor keeping its dtype and device; → `model`. The
    optimizer is built after, so it holds no state to reset."""
    for module, path in parse_spec(spec, default_module):
        sd = module_state_dict(model, module, load_npz_variables(path))
        getattr(model, module).load_state_dict(sd)
    return model

