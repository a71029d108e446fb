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
in-memory arrays (`arrays=`, `info=`) need nothing beyond numpy. A
batch's images come from the native multi-threaded gather
(`native.gather_records`) where the store is a uint8 array in RAM, as in
the JAX loader.

The reference's own API is here too, as in the JAX loader: construction
from an `opt` mapping (`data_h5`, `data_json`, `debug_max_train_images`),
`iterators` per split and a numpy `RandomState(seed)`, `getImageMaxSize`,
`getVocab`, `reset_iterator`, `decodeSequence`, the one-image
`get_batch(opt, idx)` (the image cropped to its true size and
ImageNet-normalized on the host, with its region slab and `info_table`,
`DataLoader.py:107-167`) and `padded_batches(shuffle=True)`. The same
seed draws the same images and permutations as the JAX loader's. The
trainers use neither the one-image API nor the shuffle.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch import native
from imagecaptioning_tpu_torch.data.tokenizer import Vocab

# ImageNet statistics used by the reference (DataLoader.py:57-58).
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class VGDataLoader:
    """Loads VG-regions HDF5 + dicts JSON (the reference preprocessor's
    schema), or the same arrays held in memory."""

    def __init__(self, opt=None, *, data_h5: Optional[str] = None,
                 data_json: Optional[str] = None,
                 arrays: Optional[Dict] = None, info: Optional[Dict] = None,
                 cache_images: bool = True, seed: int = 123,
                 debug_max_train_images: int = -1):
        if opt is not None:
            data_h5 = data_h5 or opt.get("data_h5")
            data_json = data_json or opt.get("data_json")
            debug_max_train_images = opt.get("debug_max_train_images", -1)
        if arrays is None:
            import h5py
            with open(data_json, "r") as f:
                info = json.load(f)
            f5 = h5py.File(data_h5, "r")
            arrays = {k: f5["/" + k][:] for k in (
                "box_to_img", "boxes", "image_heights", "image_widths",
                "img_to_first_box", "img_to_last_box", "labels", "lengths",
                "original_heights", "original_widths", "split")}
            if cache_images:
                arrays["images"] = f5["/images"][:]
                f5.close()
            else:
                arrays["images"] = f5["/images"]      # read image by image
        if info is None:
            raise ValueError("in-memory arrays need their dicts (`info`)")

        self.info = info
        self.vocab = Vocab.from_dicts_json(info)
        self.vocab_size = self.vocab.vocab_size
        self.idx_to_token = self.vocab.idx_to_token
        self.debug_max_train_images = debug_max_train_images

        self.images = arrays["images"]
        self.boxes = np.asarray(arrays["boxes"], np.float32)
        self.labels = np.asarray(arrays["labels"], np.int32)
        self.lengths = np.asarray(arrays["lengths"], np.int32)
        self.split = np.asarray(arrays["split"], np.int32)
        self.image_heights = np.asarray(arrays["image_heights"], np.int32)
        self.image_widths = np.asarray(arrays["image_widths"], np.int32)
        self.original_heights = np.asarray(arrays["original_heights"],
                                           np.int32)
        self.original_widths = np.asarray(arrays["original_widths"], np.int32)
        # 1-indexed slab pointers (preprocess.py:185-223)
        self.img_to_first_box = np.asarray(arrays["img_to_first_box"],
                                           np.int64)
        self.img_to_last_box = np.asarray(arrays["img_to_last_box"], np.int64)
        self.box_to_img = np.asarray(arrays["box_to_img"], np.int64)

        shp = self.images.shape
        if len(shp) != 4 or shp[1] != shp[2]:
            raise ValueError(f"/images should be (N, S, S, 3), got {shp}")
        self.num_images = shp[0]
        self.num_channels = shp[3]
        self.max_image_size = shp[2]
        self.num_regions = self.boxes.shape[0]
        self.seq_length = int(self.labels.shape[1])
        self.max_regions_per_image = int(
            (self.img_to_last_box - self.img_to_first_box + 1).max())

        self.split_ix: Dict[int, List[int]] = {0: [], 1: [], 2: []}
        for i in range(self.num_images):
            self.split_ix[int(self.split[i])].append(i)
        self.train_ix = self.split_ix[0]
        self.val_ix = self.split_ix[1]
        self.test_ix = self.split_ix[2]
        self.iterators = {0: 0, 1: 0, 2: 0}
        self._rng = np.random.RandomState(seed)

    # --- reference API ----------------------------------------------------
    def getImageMaxSize(self) -> int:
        return self.max_image_size

    def getSeqLength(self) -> int:
        return self.seq_length

    def getVocabSize(self) -> int:
        return self.vocab_size

    def getVocab(self):
        return self.info["idx_to_token"]

    def reset_iterator(self, split_val: int) -> None:
        if split_val not in (0, 1, 2):
            raise ValueError(f"split must be 0, 1 or 2, got {split_val}")
        self.iterators[split_val] = 0

    def decodeSequence(self, seq):
        """Int matrix → list of caption strings (DataLoader.py:92-105)."""
        return self.vocab.decode_sequence(np.asarray(seq))

    def region_slab(self, ix: int):
        """(boxes (R,4), labels (R,T)) for image `ix` — the 1-indexed slab
        read `labels[r0-1:r1]` (DataLoader.py:148-151)."""
        r0 = int(self.img_to_first_box[ix])
        r1 = int(self.img_to_last_box[ix])
        return self.boxes[r0 - 1:r1], self.labels[r0 - 1:r1]

    def _image_u8(self, ix: int) -> np.ndarray:
        return np.asarray(self.images[int(ix)])

    def get_batch(self, opt, idx: int = -1):
        """One image, reference semantics: cropped to its true (H, W),
        scaled to [0,1] and ImageNet-normalized, with its region slab.
        `opt["iterate"]` (default True) walks the split (`opt["split"]`,
        default 0) in order and wraps at its end (or at
        `debug_max_train_images`); otherwise the image is `idx`, or a draw
        of the loader's `RandomState` where `idx` is -1. Returns (img
        (1,H,W,3) f32, boxes (1,R,4), labels (1,R,T), info_table), numpy."""
        split_val = opt.get("split", 0) if hasattr(opt, "get") else 0
        iterate = opt.get("iterate", True) if hasattr(opt, "get") else True
        split_ix = self.split_ix[split_val]
        if not split_ix:
            raise ValueError(f"split {split_val} is empty")

        max_index = len(split_ix)
        if self.debug_max_train_images > 0:
            max_index = self.debug_max_train_images
        if iterate:
            ri = self.iterators[split_val]
            ri_next = ri + 1
            if ri_next >= max_index:
                ri_next = 0
            self.iterators[split_val] = ri_next
        else:
            ri = int(self._rng.randint(max_index)) if idx == -1 else idx
        ix = split_ix[ri]

        h, w = int(self.image_heights[ix]), int(self.image_widths[ix])
        img = self._image_u8(ix)[:h, :w].astype(np.float32) / 255.0
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        boxes, labels = self.region_slab(ix)

        filename = self.info.get("idx_to_filename", {}).get(str(ix + 1))
        info_table = [{
            "filename": filename,
            "split_bounds": [ri + 1, len(split_ix)],
            "width": w, "height": h,
            "ori_width": int(self.original_widths[ix]),
            "ori_height": int(self.original_heights[ix]),
        }]
        return img[None], boxes[None], labels[None], info_table

    # --- batched feeding --------------------------------------------------
    def padded_example(self, ix: int, max_regions: int):
        """Fixed-shape example: square-padded uint8 image + padded region
        slab with mask. Box coords stay in resized-image space."""
        return {"image": self._image_u8(ix),
                **self._padded_regions(ix, max_regions)}

    def _padded_regions(self, ix: int, max_regions: int):
        """`padded_example` without its image."""
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
            "image_hw": np.asarray([self.image_heights[ix],
                                    self.image_widths[ix]], np.float32),
            "boxes": out_boxes,
            "box_mask": mask,
            "labels": out_labels,
        }

    def padded_batches(self, split_val: int, batch_size: int,
                       max_regions: Optional[int] = None,
                       shuffle: bool = False,
                       start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield dict batches of stacked fixed-shape examples covering the
        split once (ragged tail dropped): in order, or with `shuffle` in a
        permutation drawn from the loader's `RandomState`. `start` skips
        that many leading images — the resume cursor, the reference's
        `loader.iterators[0] = iter % len(train_ix)` (traingt.py:51)."""
        rm = max_regions or self.max_regions_per_image
        ix = np.asarray(self.split_ix[split_val])
        if shuffle:
            ix = self._rng.permutation(ix)
        if start:
            ix = ix[start % len(ix):]
        for s in range(0, len(ix) - batch_size + 1, batch_size):
            sel = ix[s:s + batch_size]
            ex = [self._padded_regions(int(i), rm) for i in sel]
            if isinstance(self.images, np.ndarray):
                images = native.gather_records(self.images, sel)
            else:
                images = np.stack([self._image_u8(i) for i in sel])
            yield {"image": images,
                   **{k: np.stack([e[k] for e in ex]) for k in ex[0]}}


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
