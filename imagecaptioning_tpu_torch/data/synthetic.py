"""Deterministic synthetic data with the reference preprocessors' HDF5
schemas (copy of `imagecaptioning_tpu/data/synthetic.py`:
`synthetic_captions`, `make_face2text_arrays`, `make_vg_arrays`, the
learnable `make_learnable_face2text_arrays` and
`make_learnable_vg_arrays` with their word and colour tables, and the
HDF5 writers), so the training paths run end to end without a CelebA or
Visual Genome download. The same `np.random.RandomState` stream as the
JAX package, so the arrays are byte-equal to its own.

The learnable sets render their captions' content (colour bands and
strips of a face; coloured boxes, one a quadrant) with sampled templates
and synonyms, so a captioner can generalise to held-out images and a
training run can show that it learns; the random-word sets support only
memorisation.

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

import json
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


_HAIR = {"black": (25, 22, 20), "brown": (120, 72, 40),
         "blond": (222, 188, 120), "red": (168, 48, 32),
         "gray": (185, 185, 185)}
_TONE = {"light": (232, 200, 178), "dark": (124, 84, 60),
         "tan": (198, 150, 110)}
_SHIRT = {"red": (200, 30, 30), "green": (30, 160, 50),
          "blue": (30, 60, 200), "white": (238, 238, 238),
          "yellow": (225, 205, 40), "purple": (130, 40, 170)}
_HAT = (60, 90, 60)

# synonym pools for the UNPREDICTABLE caption slots (sampled per image;
# color words stay canonical so grounding is testable)
_SMILE_W = ("smiling", "happy", "cheerful")
_SERIOUS_W = ("serious", "stern", "unsmiling")
_GLASSES_Y = ("with glasses", "wearing glasses")
_GLASSES_N = ("without glasses", "with no glasses")


def make_learnable_face2text_arrays(num_images: int = 256,
                                    seq_length: int = 12,
                                    image_hw: Tuple[int, int] = (218, 178),
                                    seed: int = 0,
                                    noise: float = 8.0
                                    ) -> Tuple[Dict, Dict]:
    """Face2Text-schema dataset whose captions are DERIVED from rendered
    image content (hat strip, hair/skin/shirt color bands, glasses
    strip, mouth shape), so a captioner can genuinely GENERALIZE to
    held-out images — unlike `make_face2text_arrays`, whose random-word
    captions only support memorization. This is the strongest offline
    stand-in for the reference's committed real-data experiments
    (AlexCap/logs/, SURVEY §6): val/test METEOR measures real visual
    grounding, not train-set recall.

    DE-SATURATED by design: each caption samples its TEMPLATE and its
    synonym slots (smiling/happy, with/wearing glasses, optional hat
    mention, optional tone mention) independently of the image, so even
    a perfect captioner cannot reproduce the held-out surface form
    exactly — METEOR lands mid-range (like BASELINE.md's 0.33–0.41 band
    on real data) instead of pinning at 1.0, beam sizes separate, and
    model families rank-order."""
    rng = np.random.RandomState(seed)
    h, w = image_hw
    hairs = list(_HAIR)
    tones = list(_TONE)
    shirts = list(_SHIRT)

    images = np.zeros((num_images, h, w, 3), np.float32)
    caps = []
    factors = []
    for i in range(num_images):
        hair = hairs[rng.randint(len(hairs))]
        tone = tones[rng.randint(len(tones))]
        shirt = shirts[rng.randint(len(shirts))]
        glasses = bool(rng.randint(2))
        smiling = bool(rng.randint(2))
        hat = bool(rng.randint(2))
        factors.append((hair, tone, shirt, glasses, smiling, hat))

        img = images[i]
        img[: int(0.28 * h)] = _HAIR[hair]
        if hat:
            img[: int(0.10 * h)] = _HAT
        img[int(0.28 * h): int(0.72 * h)] = _TONE[tone]
        if glasses:
            img[int(0.38 * h): int(0.45 * h),
                int(0.15 * w): int(0.85 * w)] = (40, 40, 40)
        if smiling:
            img[int(0.58 * h): int(0.66 * h),
                int(0.30 * w): int(0.70 * w)] = (200, 60, 60)
        else:
            img[int(0.61 * h): int(0.63 * h),
                int(0.35 * w): int(0.65 * w)] = (60, 30, 30)
        img[int(0.72 * h):] = _SHIRT[shirt]

        # caption 1 — appearance; always carries the canonical hair and
        # shirt color words, but the template (and whether the skin
        # tone is mentioned) is sampled
        t1 = rng.randint(3)
        if t1 == 0:
            caps.append(f"a {tone} skinned face with {hair} hair "
                        f"wearing a {shirt} shirt")
        elif t1 == 1:
            caps.append(f"a person with {hair} hair and a {shirt} "
                        f"shirt")
        else:
            caps.append(f"this {tone} skinned person has {hair} hair "
                        f"and wears a {shirt} shirt")

        # caption 2 — expression/accessories; synonym slots sampled,
        # the hat mentioned only half the time it is present
        smile_w = (_SMILE_W if smiling else _SERIOUS_W)[rng.randint(3)]
        glasses_p = (_GLASSES_Y if glasses else _GLASSES_N)[rng.randint(2)]
        mention_hat = hat and bool(rng.randint(2))
        t2 = rng.randint(2)
        if t2 == 0:
            caps.append(f"a {smile_w} person {glasses_p} and "
                        f"{hair} hair"
                        + (" under a hat" if mention_hat else ""))
        else:
            caps.append(f"a {smile_w} face {glasses_p}"
                        + (" and a hat" if mention_hat else ""))

    images += rng.normal(0.0, noise, images.shape)
    images = np.clip(images, 0, 255).astype(np.uint8)

    vocab = Vocab.from_captions(caps, min_token_instances=1)
    labels = np.stack([vocab.encode_caption(c, seq_length) for c in caps])
    lengths = (labels != 0).sum(axis=1).astype(np.int32)

    split = np.zeros(num_images, np.int32)
    n_val = max(1, num_images * 15 // 100)
    n_test = max(1, num_images * 15 // 100)
    split[num_images - n_val - n_test:num_images - n_test] = 1
    split[num_images - n_test:] = 2

    # factor codes in the reference's ±1 attribute slots
    attributes = -np.ones((num_images, 40), np.int32)
    for i, (hair, tone, shirt, glasses, smiling, hat) in enumerate(factors):
        attributes[i, 0] = 1 if glasses else -1
        attributes[i, 1] = 1 if smiling else -1
        attributes[i, 2] = 1 if hat else -1
        attributes[i, 3 + hairs.index(hair)] = 1
        attributes[i, 8 + tones.index(tone)] = 1
        attributes[i, 11 + shirts.index(shirt)] = 1

    first = np.arange(num_images, dtype=np.int32) * 2
    arrays = {
        "images": images,
        "labels": labels.astype(np.int32),
        "lengths": lengths,
        "split": split,
        "attributes": attributes,
        "img_to_first_phr": first,
        "img_to_last_phr": first + 1,
    }
    info = {
        "token_to_idx": vocab.token_to_idx,
        "idx_to_token": vocab.idx_to_token,
        "idx_to_filename": {str(i): f"learnable_{i:06d}.jpg"
                            for i in range(num_images)},
        "filename_to_idx": {f"learnable_{i:06d}.jpg": i
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


_BOX_COLORS = {"red": (200, 30, 30), "green": (30, 160, 50),
               "blue": (30, 60, 200), "yellow": (220, 200, 40),
               "purple": (140, 40, 170), "white": (235, 235, 235),
               "orange": (230, 130, 30)}

# synonym pools for the unpredictable VG caption slots
_SIZE_BIG = ("big", "large")
_SIZE_SMALL = ("small", "little")
_HALF_TOP = ("top", "upper")
_HALF_BOT = ("bottom", "lower")


def make_learnable_vg_arrays(num_images: int = 64,
                             seq_length: int = 8,
                             image_size: int = 256,
                             seed: int = 0,
                             noise: float = 6.0) -> Tuple[Dict, Dict]:
    """VG-schema dataset whose region captions DESCRIBE the rendered
    region (a colored rectangle: color, big/small, top/bottom half) —
    the dense-captioning counterpart of `make_learnable_face2text_arrays`:
    held-out mAP/METEOR measure real grounding, not recall. Four
    regions per image, one per quadrant (no occlusion, so every caption
    is visually recoverable).

    DE-SATURATED like the face variant: the template and the
    size/position synonym slots are sampled per region (big/large,
    top/upper, …), so held-out METEOR — and with it the
    language-thresholded mAP cells — cannot pin at the ceiling even for
    a perfect model."""
    rng = np.random.RandomState(seed)
    s = image_size
    regions_per_image = 4
    m = num_images * regions_per_image
    colors = list(_BOX_COLORS)
    big_thresh = (s // 4) ** 2          # quadrant boxes: 'big' ≥ half-cell²

    images = np.full((num_images, s, s, 3), 110.0, np.float32)
    boxes = np.zeros((m, 4), np.float32)
    caps = []
    k = 0
    for i in range(num_images):
        for qy in range(2):
            for qx in range(2):
                cell = s // 2
                w = int(rng.randint(cell // 4, cell - 8))
                h = int(rng.randint(cell // 4, cell - 8))
                x0 = qx * cell + int(rng.randint(2, cell - w - 2))
                y0 = qy * cell + int(rng.randint(2, cell - h - 2))
                color = colors[rng.randint(len(colors))]
                images[i, y0:y0 + h, x0:x0 + w] = _BOX_COLORS[color]
                # (xc, yc, w, h), 1-indexed like preprocess.py:146-183
                boxes[k] = (x0 + (w - 1) / 2 + 1, y0 + (h - 1) / 2 + 1,
                            w, h)
                size = (_SIZE_BIG if w * h >= big_thresh
                        else _SIZE_SMALL)[rng.randint(2)]
                half = (_HALF_TOP if qy == 0
                        else _HALF_BOT)[rng.randint(2)]
                if rng.randint(2):
                    caps.append(f"a {size} {color} box in the {half} "
                                f"half")
                else:
                    caps.append(f"the {color} {size} box near the "
                                f"{half} edge")
                k += 1
    images += rng.normal(0.0, noise, images.shape)
    images = np.clip(images, 0, 255).astype(np.uint8)

    vocab = Vocab.from_captions(caps, min_token_instances=1)
    labels = np.stack([vocab.encode_caption(c, seq_length) for c in caps])
    lengths = (labels != 0).sum(axis=1).astype(np.int32)

    split = np.zeros(num_images, np.int32)
    n_val = max(1, num_images * 15 // 100)
    n_test = max(1, num_images * 15 // 100)
    split[num_images - n_val - n_test:num_images - n_test] = 1
    split[num_images - n_test:] = 2

    first = (np.arange(num_images, dtype=np.int32) * regions_per_image) + 1
    arrays = {
        "images": images,
        "image_heights": np.full(num_images, s, np.int32),
        "image_widths": np.full(num_images, s, np.int32),
        "labels": labels.astype(np.int32),
        "lengths": lengths,
        "boxes": boxes,
        "img_to_first_box": first,
        "img_to_last_box": first + regions_per_image - 1,
        "box_to_img": np.repeat(np.arange(1, num_images + 1, dtype=np.int32),
                                regions_per_image),
        "split": split,
        "original_heights": np.full(num_images, s, np.int32),
        "original_widths": np.full(num_images, s, np.int32),
    }
    info = {
        "token_to_idx": vocab.token_to_idx,
        "idx_to_token": vocab.idx_to_token,
        "filename_to_idx": {f"vg_{i}.jpg": i + 1
                            for i in range(num_images)},
    }
    return arrays, info


def _write_h5(h5_path: str, json_path: str, arrays: Dict, info: Dict) -> None:
    import h5py
    with h5py.File(h5_path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    with open(json_path, "w") as f:
        json.dump(info, f)


def write_face2text_h5(h5_path: str, json_path: str, **kw) -> None:
    """`make_face2text_arrays(**kw)` as the Face2Text HDF5 and dicts JSON
    that `AlexDataLoader(data_h5=..., data_json=...)` reads (needs
    `h5py`)."""
    _write_h5(h5_path, json_path, *make_face2text_arrays(**kw))


def write_vg_h5(h5_path: str, json_path: str, **kw) -> None:
    """`make_vg_arrays(**kw)` as the VG HDF5 and dicts JSON that
    `VGDataLoader(data_h5=..., data_json=...)` reads (needs `h5py`)."""
    _write_h5(h5_path, json_path, *make_vg_arrays(**kw))
