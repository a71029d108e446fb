"""Visual-Genome region data loader for the GT dense captioner — port of
`imagecaptioning_tpu/data/vg_loader.py:33-240`.

The VG HDF5 schema of the reference loaders (`DenseCap/densecap/
DataLoader.py`, `AlexGTModel/DataLoader.py`): square-padded uint8 images
with true `image_heights/widths`, 1-indexed region slabs
`img_to_first_box/img_to_last_box`, boxes as (xc, yc, w, h) in 1-indexed
resized coords, split codes 0/1/2. `padded_batches` yields fixed-shape
batches (square-padded uint8 images, regions padded or truncated to
`max_regions` with a mask), normalized on the device by
`normalize_images`. The HDF5 branch imports `h5py` only when it is used;
in-memory arrays (`arrays=`, `info=`) need nothing beyond numpy. Images
are gathered with a numpy stack (the JAX package uses a C++ gather
there; the bytes are the same). The reference's one-image `get_batch`
API and shuffling are not ported: the GT trainer and eval use neither.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch.data.tokenizer import Vocab

# ImageNet statistics used by the reference (DataLoader.py:57-58).
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class VGDataLoader:
    """Loads VG-regions HDF5 + dicts JSON (the reference preprocessor's
    schema), or the same arrays held in memory."""

    def __init__(self, *, data_h5: Optional[str] = None,
                 data_json: Optional[str] = None,
                 arrays: Optional[Dict] = None, info: Optional[Dict] = None):
        if arrays is None:
            import h5py
            with open(data_json, "r") as f:
                info = json.load(f)
            with h5py.File(data_h5, "r") as f5:
                arrays = {k: f5["/" + k][:] for k in (
                    "images", "boxes", "image_heights", "image_widths",
                    "img_to_first_box", "img_to_last_box", "labels",
                    "split")}
        if info is None:
            raise ValueError("in-memory arrays need their dicts (`info`)")

        self.info = info
        self.vocab = Vocab.from_dicts_json(info)
        self.vocab_size = self.vocab.vocab_size

        self.images = arrays["images"]
        self.boxes = np.asarray(arrays["boxes"], np.float32)
        self.labels = np.asarray(arrays["labels"], np.int32)
        self.split = np.asarray(arrays["split"], np.int32)
        self.image_heights = np.asarray(arrays["image_heights"], np.int32)
        self.image_widths = np.asarray(arrays["image_widths"], np.int32)
        # 1-indexed slab pointers (preprocess.py:185-223)
        self.img_to_first_box = np.asarray(arrays["img_to_first_box"],
                                           np.int64)
        self.img_to_last_box = np.asarray(arrays["img_to_last_box"], np.int64)

        shp = self.images.shape
        if len(shp) != 4 or shp[1] != shp[2]:
            raise ValueError(f"/images should be (N, S, S, 3), got {shp}")
        self.num_images = shp[0]
        self.seq_length = int(self.labels.shape[1])
        self.max_regions_per_image = int(
            (self.img_to_last_box - self.img_to_first_box + 1).max())

        self.split_ix: Dict[int, List[int]] = {0: [], 1: [], 2: []}
        for i in range(self.num_images):
            self.split_ix[int(self.split[i])].append(i)
        self.train_ix = self.split_ix[0]

    def getSeqLength(self) -> int:
        return self.seq_length

    def getVocabSize(self) -> int:
        return self.vocab_size

    def region_slab(self, ix: int):
        """(boxes (R,4), labels (R,T)) for image `ix` — the 1-indexed slab
        read `labels[r0-1:r1]` (DataLoader.py:148-151)."""
        r0 = int(self.img_to_first_box[ix])
        r1 = int(self.img_to_last_box[ix])
        return self.boxes[r0 - 1:r1], self.labels[r0 - 1:r1]

    def _image_u8(self, ix: int) -> np.ndarray:
        return np.asarray(self.images[int(ix)])

    def padded_example(self, ix: int, max_regions: int):
        """Fixed-shape example: square-padded uint8 image + padded region
        slab with mask. Box coords stay in resized-image space."""
        boxes, labels = self.region_slab(ix)
        rm = max_regions
        out_boxes = np.zeros((rm, 4), np.float32)
        out_labels = np.zeros((rm, self.seq_length), np.int32)
        mask = np.zeros((rm,), np.float32)
        take = min(boxes.shape[0], rm)
        out_boxes[:take] = boxes[:take]
        out_labels[:take] = labels[:take]
        # padded rows get a degenerate but in-bounds unit box so ROI math
        # stays finite; the mask removes them from every loss.
        if take < rm:
            out_boxes[take:] = [8.0, 8.0, 8.0, 8.0]
        mask[:take] = 1.0
        return {
            "image": self._image_u8(ix),
            "image_hw": np.asarray([self.image_heights[ix],
                                    self.image_widths[ix]], np.float32),
            "boxes": out_boxes,
            "box_mask": mask,
            "labels": out_labels,
        }

    def padded_batches(self, split_val: int, batch_size: int,
                       max_regions: Optional[int] = None,
                       start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield dict batches of stacked fixed-shape examples covering the
        split once, in order (ragged tail dropped). `start` skips that many
        leading images — the resume cursor, the reference's
        `loader.iterators[0] = iter % len(train_ix)` (traingt.py:51)."""
        rm = max_regions or self.max_regions_per_image
        ix = np.asarray(self.split_ix[split_val])
        if start:
            ix = ix[start % len(ix):]
        for s in range(0, len(ix) - batch_size + 1, batch_size):
            ex = [self.padded_example(int(i), rm)
                  for i in ix[s:s + batch_size]]
            yield {k: np.stack([e[k] for e in ex]) for k in ex[0]}


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
