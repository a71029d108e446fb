"""ImageNet normalization for the dense-caption families (the device-side
part of `imagecaptioning_tpu/data/vg_loader.py`). The HDF5 loader itself
belongs to the training slice."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# ImageNet statistics used by the reference (DataLoader.py:57-58).
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_images(images_u8: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """uint8 (B, H, W, 3) → ImageNet-normalized float on the tensor's own
    device — the reference's ToTensor+Normalize (DataLoader.py:142-146)."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(images_u8.device)
    std = torch.from_numpy(IMAGENET_STD).to(images_u8.device)
    x = images_u8.to(torch.float32) / 255.0
    x = (x - mean) / std
    if dtype is not None:
        x = x.to(dtype)
    return x
