"""What the benchmark hands to, and takes from, the program under test
(`imagecaptioning_tpu_torch`): its configuration object, the seeded
weights, and the device."""

from __future__ import annotations

import dataclasses
import gc
import importlib
from typing import Dict

import torch

from portbench import weights


def dense_config(cfg: Dict):
    """The program's DenseConfig from its factory named by the
    configuration, with every key of the configuration that names one of
    its fields."""
    from imagecaptioning_tpu_torch.config import dense_configs

    base = getattr(dense_configs, cfg["factory"])()
    fields = {f.name for f in dataclasses.fields(base)}
    return base.replace(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in cfg.items() if k in fields})


def reference(cfg: Dict):
    """The plain reference module the configuration names
    (`portbench/reference/<reference>.py`)."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def seeded_weights(reference, cfg: Dict, seed: int, device,
                   served: bool) -> Dict[str, torch.Tensor]:
    """The reference layout's weights from `seed`; with `served`, those
    the configuration serves in its narrow type rounded to it."""
    narrow = weights.DTYPES[cfg["param_dtype"]] if served else None
    return weights.make(reference.param_layout(cfg), seed, device,
                        reference.narrow_params(cfg), narrow)


def free(device) -> None:
    """Hand the memory of released program state back to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
