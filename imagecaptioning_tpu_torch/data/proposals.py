"""Inference-from-file image processing with pluggable box proposals
(port of `imagecaptioning_tpu/data/proposals.py`).

A proposal source is a plain callable `(image_u8 (H, W, 3)) -> boxes
(R, 4) xcycwh`. `ImageProcessor.preprocess_img` keeps the reference's
resize contract (`DenseCap/densecap/DataLoader.py:170-186`): shorter
edge → 700 capped at 720 on the longest edge, /255, ImageNet normalize.
All of it is host-side numpy but `rpn_proposer`, which runs the RPN
model's detection path on the model's device; PIL is imported inside the
functions.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from imagecaptioning_tpu_torch.data.vg_loader import IMAGENET_MEAN, IMAGENET_STD

Proposer = Callable[[np.ndarray], np.ndarray]


def resize_shorter_edge(img: np.ndarray, target: int = 700,
                        max_size: int = 720) -> np.ndarray:
    """torchvision `Resize(700, max_size=720)` semantics (bilinear)."""
    from PIL import Image
    h, w = img.shape[:2]
    scale = target / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return np.asarray(Image.fromarray(img).resize((nw, nh),
                                                  Image.BILINEAR))


def grid_proposer(cell: int = 64, box: int = 96) -> Proposer:
    """Deterministic sliding-window proposals (smoke/fallback)."""
    def propose(img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        xs = np.arange(box // 2, max(w - box // 2, box // 2) + 1, cell)
        ys = np.arange(box // 2, max(h - box // 2, box // 2) + 1, cell)
        boxes = [[float(x), float(y), float(box), float(box)]
                 for y in ys for x in xs]
        return np.asarray(boxes, np.float32)
    return propose


def rpn_proposer(model, pad_to: int = 720) -> Proposer:
    """Proposals from a `DenseCapRPN`'s `forward_test` on its own device
    (the self-contained stand-in for the reference's YOLOv5 hub
    download): the image is fitted into a zero-padded `pad_to`² canvas,
    and the kept boxes come back in the image's own coordinates."""
    import torch

    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images

    dev = next(model.parameters()).device

    def propose(img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        scale = 1.0
        if max(h, w) > pad_to:     # fit the fixed detection canvas
            scale = pad_to / max(h, w)
            img = resize_shorter_edge(img, target=int(min(h, w) * scale),
                                      max_size=pad_to)
            h, w = img.shape[:2]
        padded = np.zeros((pad_to, pad_to, 3), np.uint8)
        padded[:h, :w] = img
        x = normalize_images(torch.from_numpy(padded[None]).to(dev),
                             dtype=model.compute_dtype)
        with torch.inference_mode():
            boxes, _, _, keep = model.forward_test(x)
        b = boxes[0][keep[0]].float().cpu().numpy()
        return (b / scale).astype(np.float32)    # back to raw coords
    return propose


class ImageProcessor:
    """Reference-contract facade: `preprocess_img(path)` → (normalized
    image (1, H, W, 3) float32, proposal boxes (1, R, 4) xcycwh)."""

    def __init__(self, proposer: Optional[Proposer] = None,
                 target: int = 700, max_size: int = 720):
        self.proposer = proposer or grid_proposer()
        self.target = target
        self.max_size = max_size

    def preprocess_img(self, img_path: str, return_scale: bool = False):
        """(normalized image (1,H,W,3), boxes (1,R,4) in RESIZED coords);
        with `return_scale` also a dict {sx, sy, raw_hw, resized_hw} so
        callers can map boxes back onto the source image's pixel frame."""
        from PIL import Image
        raw = np.asarray(Image.open(img_path).convert("RGB"))
        boxes = self.proposer(raw)
        img = resize_shorter_edge(raw, self.target, self.max_size)
        # proposals are produced in raw coords; rescale to resized coords
        sy = img.shape[0] / raw.shape[0]
        sx = img.shape[1] / raw.shape[1]
        boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
        x = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        if return_scale:
            return x[None], boxes[None], {
                "sx": sx, "sy": sy,
                "raw_hw": (int(raw.shape[0]), int(raw.shape[1])),
                "resized_hw": (int(img.shape[0]), int(img.shape[1]))}
        return x[None], boxes[None]
