"""Dataset and checkpoint fixups — port of
`imagecaptioning_tpu/data/fixups.py`, the tested form of the reference's
one-off `AlexCap/json_modify.py`:

1. `strip_backbone_keys`: drop the backbone's entries from a checkpoint
   state dict (json_modify.py:8-16 strips 'resnet_backbone').
2. `merge_duplicate_test_descriptions`: Face2Text's test JSONs hold
   consecutive records of one image; collapse them, keeping the longest
   description (json_modify.py:32-47).
3. `channel_mean_std`: per-channel dataset statistics over [0, 1]
   floats, the mean of per-image channel means and the mean of per-image
   channel stds (json_modify.py:84-99 averages per-image stds rather than
   pooling; kept).
"""

from __future__ import annotations

import numpy as np


def strip_backbone_keys(state_dict: dict, marker: str = "resnet_backbone"):
    """A copy of `state_dict` without the keys that contain `marker`."""
    return {k: v for k, v in state_dict.items() if marker not in k}


def merge_duplicate_test_descriptions(records: list[dict]) -> list[dict]:
    """Collapse consecutive records sharing a filename into one record
    whose 'description' is the single longest of the group's
    descriptions, in a one-element list (as the reference's
    my_clean_test_2.1.json)."""
    out: list[dict] = []
    for rec in records:
        desc = rec["description"]
        descs = [desc] if isinstance(desc, str) else list(desc)
        if out and out[-1]["filename"] == rec["filename"]:
            out[-1]["description"].extend(descs)
        else:
            merged = dict(rec)
            merged["description"] = descs
            out.append(merged)
    for rec in out:
        if len(rec["description"]) > 1:
            lengths = [len(s) for s in rec["description"]]
            rec["description"] = [
                rec["description"][lengths.index(max(lengths))]]
    return out


def channel_mean_std(images_u8: np.ndarray):
    """(N, H, W, 3) uint8 → (mean[3], std[3]) over [0, 1] floats: the
    mean of per-image channel means, and the mean of per-image channel
    stds (population, sqrt(E[x²] − E[x]²) per image)."""
    x = np.asarray(images_u8, dtype=np.float64) / 255.0
    per_img_mean = x.mean(axis=(1, 2))                       # (N, 3)
    per_img_sq = (x ** 2).mean(axis=(1, 2))
    per_img_std = np.sqrt(np.maximum(per_img_sq - per_img_mean ** 2, 0))
    return per_img_mean.mean(axis=0), per_img_std.mean(axis=0)
