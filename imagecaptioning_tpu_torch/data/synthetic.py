"""Deterministic synthetic data with the reference preprocessors' HDF5
schemas (copy of `synthetic_captions`, `make_face2text_arrays` and
`make_vg_arrays` in `imagecaptioning_tpu/data/synthetic.py:30-106,
249-303`), so the training paths run end to end without a CelebA or
Visual Genome download. The same `np.random.RandomState` stream as the
JAX package, so the arrays are byte-equal to its own.

Face2Text schema (reference `AlexCap/my_model_preprocess.py:282-330`):
  images (N, 218, 178, 3) u8 | labels (M, T) i32 | lengths (M,) i32 |
  split (N,) i32 {0,1,2} | attributes (N, 40) i32 |
  img_to_first_phr/img_to_last_phr (N,) i32 (0-indexed phrase slab)
  dicts JSON: token_to_idx (1-indexed), idx_to_token, idx_to_filename,
  attributes_labels.

Visual Genome schema (reference `preprocess.py:363-424`):
  images (N, S, S, 3) u8 square-padded | image_heights/widths |
  boxes (M, 4) xc,yc,w,h 1-indexed | labels (M, T) | lengths |
  img_to_first_box/img_to_last_box (1-indexed slab) | box_to_img | split.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from imagecaptioning_tpu_torch.data.tokenizer import Vocab

_WORDS = ("a the man woman young old face hair beard smile big small long "
          "short dark light brown black blond wearing glasses hat round "
          "oval eyes nose mouth with and has is her his she he looks").split()


def synthetic_captions(rng: np.random.RandomState, n: int,
                       min_len: int = 4, max_len: int = 12):
    caps = []
    for _ in range(n):
        k = rng.randint(min_len, max_len + 1)
        caps.append(" ".join(rng.choice(_WORDS) for _ in range(k)))
    return caps


def make_face2text_arrays(num_images: int = 32,
                          captions_per_image: int = 2,
                          seq_length: int = 16,
                          image_hw: Tuple[int, int] = (218, 178),
                          seed: int = 0) -> Tuple[Dict, Dict]:
    """Face2Text-style arrays → (h5-like dict of arrays, dicts-json dict):
    random uint8 CelebA-size images, two captions each over a 34-word
    pool, a ~70/15/15 split."""
    rng = np.random.RandomState(seed)
    m = num_images * captions_per_image
    caps = synthetic_captions(rng, m)
    vocab = Vocab.from_captions(caps, min_token_instances=1)

    labels = np.stack([vocab.encode_caption(c, seq_length) for c in caps])
    lengths = (labels != 0).sum(axis=1).astype(np.int32)

    h, w = image_hw
    images = rng.randint(0, 256, size=(num_images, h, w, 3), dtype=np.uint8)

    # splits: ~70/15/15 like the reference's CSV-driven split codes
    split = np.zeros(num_images, np.int32)
    n_val = max(1, num_images * 15 // 100)
    n_test = max(1, num_images * 15 // 100)
    split[num_images - n_val - n_test:num_images - n_test] = 1
    split[num_images - n_test:] = 2

    attributes = rng.randint(-1, 2, size=(num_images, 40)).astype(np.int32)
    first = np.arange(num_images, dtype=np.int32) * captions_per_image
    last = first + captions_per_image - 1

    arrays = {
        "images": images,
        "labels": labels.astype(np.int32),
        "lengths": lengths,
        "split": split,
        "attributes": attributes,
        "img_to_first_phr": first,
        "img_to_last_phr": last,
    }
    info = {
        "token_to_idx": vocab.token_to_idx,
        "idx_to_token": vocab.idx_to_token,
        "idx_to_filename": {str(i): f"synthetic_{i:06d}.jpg"
                            for i in range(num_images)},
        "filename_to_idx": {f"synthetic_{i:06d}.jpg": i
                            for i in range(num_images)},
        "attributes_labels": [f"attr_{i}" for i in range(40)],
    }
    return arrays, info


def make_vg_arrays(num_images: int = 8,
                   regions_per_image: int = 6,
                   seq_length: int = 15,
                   image_size: int = 256,
                   seed: int = 0) -> Tuple[Dict, Dict]:
    """Visual-Genome-style arrays for the GT model → (h5-like dict of
    arrays, dicts-json dict). Boxes are (xc, yc, w, h), 1-indexed coords
    like the reference encoder (preprocess.py:146-183); slab pointers are
    1-indexed."""
    rng = np.random.RandomState(seed)
    m = num_images * regions_per_image
    caps = synthetic_captions(rng, m, 2, 8)
    vocab = Vocab.from_captions(caps, min_token_instances=1)

    labels = np.stack([vocab.encode_caption(c, seq_length) for c in caps])
    lengths = (labels != 0).sum(axis=1).astype(np.int32)

    s = image_size
    # (N, S, S, 3) HWC uint8, square-padded — the reference layout
    # (preprocess.py:228-229; DataLoader.py asserts H==W at :48-50).
    images = rng.randint(0, 256, size=(num_images, s, s, 3), dtype=np.uint8)
    wh = rng.randint(s // 8, s // 2, size=(m, 2)).astype(np.float64)
    xc = rng.uniform(wh[:, 0] / 2 + 1, s - wh[:, 0] / 2)
    yc = rng.uniform(wh[:, 1] / 2 + 1, s - wh[:, 1] / 2)
    boxes = np.stack([xc, yc, wh[:, 0], wh[:, 1]], axis=1).astype(np.float32)

    split = np.zeros(num_images, np.int32)
    if num_images >= 3:
        split[-2] = 1
        split[-1] = 2

    first = (np.arange(num_images, dtype=np.int32) * regions_per_image) + 1
    last = first + regions_per_image - 1
    arrays = {
        "images": images,
        "image_heights": np.full(num_images, s, np.int32),
        "image_widths": np.full(num_images, s, np.int32),
        "labels": labels.astype(np.int32),
        "lengths": lengths,
        "boxes": boxes,
        "img_to_first_box": first,
        "img_to_last_box": last,
        "box_to_img": np.repeat(np.arange(1, num_images + 1, dtype=np.int32),
                                regions_per_image),
        "split": split,
        "original_heights": np.full(num_images, s, np.int32),
        "original_widths": np.full(num_images, s, np.int32),
    }
    info = {
        "token_to_idx": vocab.token_to_idx,
        "idx_to_token": vocab.idx_to_token,
        "filename_to_idx": {f"vg_{i}.jpg": i + 1 for i in range(num_images)},
    }
    return arrays, info
