"""Image preprocessing on the device — port of
`imagecaptioning_tpu/data/transforms.py:28-74`.

The reference applies torchvision's `ResNet101_Weights.IMAGENET1K_V2
.transforms()` on the host per batch (`AlexCap/MyDataLoader.py:38,86`):
bilinear resize of the short side to 232 (antialiased), center crop 224,
scale to [0, 1], ImageNet normalize. Here, as in the JAX package, the
uint8 pixels go to the card and the transform runs there, on the batch.

`jax.image.resize(method="linear", antialias=True)` scales its triangle
kernel with the resize factor when it shrinks and is plain bilinear when it
grows. `F.interpolate(mode="bilinear", align_corners=False)` is that
bilinear, and with `antialias=True` that shrink (its CPU kernel takes a
longer road when it grows, ~3e-6 off), so the antialiased kernel is asked
for only when an axis shrinks.

The resize, crop and normalize run in fp32 (fp64 for an fp64 `dtype`) and
the result is rounded once to `dtype`. (The JAX driver computes the whole
chain in bf16 on the chip; torch's antialiased CPU kernel takes no bf16.)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_short_side(images: torch.Tensor, size: int) -> torch.Tensor:
    """Resize (B, H, W, C) float images so that the shorter side is `size`,
    the aspect kept (Python's round, as the JAX package computes it)."""
    _, h, w, _ = images.shape
    if h <= w:
        new_h, new_w = size, max(1, round(size * w / h))
    else:
        new_h, new_w = max(1, round(size * h / w)), size
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(new_h, new_w),
                      mode="bilinear", align_corners=False,
                      antialias=new_h < h or new_w < w)
    return x.permute(0, 2, 3, 1)


def center_crop(images: torch.Tensor, crop: int) -> torch.Tensor:
    _, h, w, _ = images.shape
    top = (h - crop) // 2
    left = (w - crop) // 2
    return images[:, top:top + crop, left:left + crop, :]


def normalize(images: torch.Tensor,
              mean: Tuple[float, ...] = IMAGENET_MEAN,
              std: Tuple[float, ...] = IMAGENET_STD) -> torch.Tensor:
    m = torch.tensor(mean, dtype=images.dtype, device=images.device)
    s = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - m) / s


def resnet_v2_preprocess(images_u8: torch.Tensor, resize_size: int = 232,
                         crop_size: int = 224,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) → normalized (B, 224, 224, 3) in `dtype`, NHWC
    contiguous: the torchvision IMAGENET1K_V2 eval transform the reference
    applies to every split, on the tensor's own device. It computes in fp32
    (fp64 when `dtype` is) and rounds once to `dtype`."""
    x = images_u8.to(torch.promote_types(dtype, torch.float32)) / 255.0
    x = center_crop(resize_short_side(x, resize_size), crop_size)
    return normalize(x).to(dtype).contiguous()


def imagenet_preprocess(images_u8: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ToTensor + ImageNet normalize (the DenseCap path), no resize: uint8
    (B, H, W, 3) → `dtype`, computed in `dtype` as the JAX function does,
    on the tensor's own device."""
    return normalize(images_u8.to(dtype) / 255.0)
