#!/usr/bin/env python
"""Checkpoint converter — port of the root `convert_checkpoint.py`:
torch state dicts ↔ the JAX package's variables, bit for bit
(`utils/torch_port.py`).

- `import --arch A`: a torchvision backbone's state dict (`.pth`, or its
  `.npz` re-export) → a `.npz` of the JAX layout's flattened variables
  (`params/conv1/kernel`, `batch_stats/bn1/mean`, ...), which the
  trainers' `encoder_init` reads.
- `export --arch A`: the reverse, a state dict torchvision's model loads.
- `import-model`: a reference training checkpoint
  (`torch.save(model.state_dict(), ...)` of any AlexCap family, either
  CNN trunk or the ViT, or of AlexGTModel) → a port checkpoint
  (`{"model": state dict}`: the port's models keep the reference's key
  layout, so it is the source's tensors as `infer --ckpt` reads them);
  with `--npz` also the JAX layout's flattened variables. The family and the
  architecture's sizes are read from the state dict and printed.
- `export-model`: a port checkpoint (`import-model`'s or a trainer's, its
  `model` entry) or such an `.npz` → the state dict the reference's
  model of that family loads. The JAX CLI also reads and writes orbax
  checkpoint directories; this one does not, and refuses a directory.

    python -m imagecaptioning_tpu_torch.convert_checkpoint import \\
        --arch resnet101 --src r101.pth --dst r101.npz
    python -m imagecaptioning_tpu_torch.convert_checkpoint import-model \\
        --src best_model_LSTM_resnet_ft6_bs12_clip.pth --dst lstm.ckpt \\
        [--npz lstm.npz]
    python -m imagecaptioning_tpu_torch.convert_checkpoint export-model \\
        --src lstm.ckpt --dst lstm_reference.pth

Host code: it touches no card.
"""

from __future__ import annotations

import argparse
import json
import os
from collections.abc import Mapping

import numpy as np
import torch

from imagecaptioning_tpu_torch.utils import checkpoint
from imagecaptioning_tpu_torch.utils import torch_port as tp
from imagecaptioning_tpu_torch.utils import weights
from imagecaptioning_tpu_torch.utils.pretrained import (flatten_tree,
                                                        unflatten_tree)

ARCHS = ("resnet50", "resnet101", "resnet152", "vgg16_features",
         "vgg16_classifier", "vit_b_16")
FAMILIES = ("auto", "lstm", "attention", "transformer", "vitb", "gt")


def do_import(arch: str, src: str, dst: str) -> None:
    sd = tp.load_state_dict(src)
    if arch.startswith("resnet"):
        variables = tp.convert_resnet(sd, depth=int(arch[6:]))
    elif arch == "vgg16_features":
        variables = tp.convert_vgg_features(sd)
    elif arch == "vgg16_classifier":
        variables = tp.convert_vgg_classifier(sd)
    elif arch == "vit_b_16":
        variables = tp.convert_vit(sd)
    else:
        raise SystemExit(f"unknown arch {arch}")
    flat = flatten_tree(variables)
    np.savez(dst, **flat)
    print(f"wrote {dst} ({len(flat)} arrays)")


def do_export(arch: str, src: str, dst: str) -> None:
    with np.load(src) as z:
        variables = unflatten_tree({k: z[k] for k in z.files})
    if arch.startswith("resnet"):
        sd = tp.export_resnet(variables, depth=int(arch[6:]))
    elif arch == "vgg16_features":
        sd = tp.export_vgg_features(variables)
    elif arch == "vgg16_classifier":
        sd = tp.export_vgg_classifier(variables)
    elif arch == "vit_b_16":
        sd = tp.export_vit(variables)
    else:
        raise SystemExit(f"unknown arch {arch}")
    tp.save_state_dict(dst, sd)
    print(f"wrote {dst} ({len(sd)} tensors)")


def do_import_model(src: str, dst: str, family: str, vit_heads: int,
                    npz: str = "") -> dict:
    sd = tp.load_state_dict(src)
    variables, meta = tp.convert_reference_captioner(sd, family=family,
                                                     vit_heads=vit_heads)
    # the port's models keep the reference's key layout: its checkpoint is
    # the source's tensors as the port's loaders read them
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    checkpoint.save_checkpoint(dst, {"model": (
        weights.gt_model_state_dict(tensors) if meta["family"] == "gt"
        else weights.alexcap_model_state_dict(tensors))})
    if npz:
        np.savez(npz, **flatten_tree(variables))
    print(json.dumps({"wrote": dst, "npz": npz or None, **meta}))
    return meta


def load_variables(src: str, family: str = "auto") -> dict:
    """A port checkpoint or an `.npz` of the JAX layout's flattened
    variables → {'params', 'batch_stats'}."""
    if os.path.isdir(src):
        raise SystemExit(
            f"{src} is a directory: orbax checkpoints are read by the JAX "
            f"package's CLI (python convert_checkpoint.py export-model), "
            f"which can write the .npz this one reads")
    if src.endswith(".npz"):
        with np.load(src) as z:
            tree = unflatten_tree({k: z[k] for k in z.files})
        if "params" not in tree:          # a bare params tree
            tree = {"params": tree}
        tree.setdefault("batch_stats", {})
        return tree
    state = torch.load(src, map_location="cpu", weights_only=True)
    if not isinstance(state.get("model"), Mapping):
        raise SystemExit(f"{src}: no 'model' entry, not a port checkpoint")
    variables, _ = tp.convert_reference_captioner(
        tp.reference_layout(state["model"]), family=family)
    return variables


def do_export_model(src: str, dst: str, family: str) -> dict:
    sd, meta = tp.export_reference_captioner(load_variables(src, family),
                                             family=family)
    tp.save_state_dict(dst, sd)
    print(json.dumps({"wrote": dst, "tensors": len(sd), **meta}))
    return meta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for cmd in ("import", "export"):
        sp = sub.add_parser(cmd)
        sp.add_argument("--arch", choices=ARCHS, required=True)
        sp.add_argument("--src", required=True)
        sp.add_argument("--dst", required=True)
    sp = sub.add_parser("import-model",
                        help="a reference model.state_dict() → a port "
                             "checkpoint for infer --ckpt")
    sp.add_argument("--src", required=True)
    sp.add_argument("--dst", required=True)
    sp.add_argument("--npz", default="",
                    help="also write the JAX layout's flattened "
                         "variables here")
    sp.add_argument("--family", default="auto", choices=FAMILIES)
    sp.add_argument("--vit-heads", type=int, default=12,
                    help="ViT encoder head count (not recoverable from "
                         "the fused in_proj shapes)")
    sp = sub.add_parser("export-model",
                        help="a port checkpoint or flattened-variables "
                             ".npz → a state_dict the reference's torch "
                             "model loads (.pth, or .npz)")
    sp.add_argument("--src", required=True,
                    help="a port checkpoint (its 'model' entry) or a "
                         "flattened-variables .npz")
    sp.add_argument("--dst", required=True)
    sp.add_argument("--family", default="auto", choices=FAMILIES)
    a = p.parse_args(argv)
    if a.cmd == "import-model":
        return do_import_model(a.src, a.dst, a.family, a.vit_heads, a.npz)
    if a.cmd == "export-model":
        return do_export_model(a.src, a.dst, a.family)
    return (do_import if a.cmd == "import" else do_export)(a.arch, a.src,
                                                           a.dst)


if __name__ == "__main__":
    main()
