"""Offline Visual-Genome preprocessing — port of
`imagecaptioning_tpu/data/preprocess_vg.py`: raw JPEGs + region JSON →
HDF5 + dicts JSON, schema-compatible with the reference `preprocess.py`
(root, 466 LoC; byte-identical copy at `AlexGTModel/preprocess.py`), and
byte for byte the JAX package's output: the same PIL calls and reader
threads, the port's copy of the tokenizer. Host code; it needs h5py,
imported by `run` (the card's machine has none).

Pipeline (reference `preprocess.py:363-424`):
  filter_images (keep split members with regions, `:411-421`) →
  add_images (threaded: read, grayscale fix, aspect-resize longest edge
  to `image_size`, upper-left aligned zero padding, `:225-274`) →
  split_filter_captions (tokenize via words_preprocess, drop >15-token
  captions, `:294-335`) → build_vocab(min_count)+dicts (`:85-120`) →
  encode_captions (M,T) int32 (`:133-143`) → encode_boxes (scale to
  resized coords, clamp, (xc,yc,w,h) 1-indexed ints, `:146-183`) →
  img_to_first/last_box 1-indexed slabs + box_to_img (`:185-223`).

All quirks kept: boxes round with `round()` then `floor(w/2)` center
arithmetic, upper-bound clamps increment the `*wasbad` counters (printed
as the reference's diagnostic line, `:182`; the x<0/y<0 fixes are silent
there too), slab pointers are 1-indexed inclusive.
"""

from __future__ import annotations

import json
import os
from math import floor
from queue import Queue
from threading import Lock, Thread
from typing import Dict, List, Optional, Sequence

import numpy as np

from imagecaptioning_tpu_torch.data.tokenizer import (build_vocab,
                                                      build_vocab_dict,
                                                      words_preprocess)
from imagecaptioning_tpu_torch.utils.io import write_json


def import_h5py():
    """h5py, or an ImportError that says the HDF5 writers need it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("preprocessing writes HDF5 files and needs h5py, "
                          "which does not import here") from e
    return h5py


def _imread_rgb(path: str) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(path))
    if img.ndim == 2:                       # grayscale fix (:247-248)
        img = img[:, :, None][:, :, [0, 0, 0]]
    if img.shape[2] == 4:                   # defensive: drop alpha
        img = img[:, :, :3]
    return img


def filter_images(data: List[Dict], split_data: Dict) -> List[Dict]:
    """Keep images that are in some split and have regions (:411-421)."""
    all_ids = set()
    for ids in split_data.values():
        all_ids.update(ids)
    return [img for img in data
            if img["id"] in all_ids and len(img["regions"]) > 0]


def encode_splits(data: List[Dict], split_data: Dict) -> np.ndarray:
    lookup = {"train": 0, "val": 1, "test": 2}
    id_to_split = {}
    for split, idxs in split_data.items():
        for idx in idxs:
            id_to_split[idx] = split
    return np.asarray([lookup[id_to_split[img["id"]]] for img in data])


def split_filter_captions(data: List[Dict], max_token_length: int,
                          verbose: bool = False) -> None:
    """Adds 'tokens' per region (None when over-length) in place."""
    kept = removed = 0
    for img in data:
        regions_per_image = 0
        for region in img["regions"]:
            tokens = words_preprocess(region["phrase"])
            if max_token_length > 0 and len(tokens) <= max_token_length:
                region["tokens"] = tokens
                kept += 1
                regions_per_image += 1
            else:
                region["tokens"] = None
                removed += 1
        assert regions_per_image > 0, \
            "image with no valid regions (reference asserts too, :330-331)"
    if verbose:
        print(f"Keeping {kept} captions; skipped {removed} as too long")


def iter_tokens(data: List[Dict]):
    for img in data:
        for region in img["regions"]:
            if region.get("tokens") is not None:
                yield region["tokens"]


def encode_captions(data: List[Dict], token_to_idx: Dict[str, int],
                    max_token_length: int):
    unk = token_to_idx.get("<UNK>")
    rows, lengths = [], []
    for img in data:
        for region in img["regions"]:
            tokens = region.get("tokens")
            if tokens is None:
                continue
            row = np.zeros(max_token_length, np.int32)
            for i, tok in enumerate(tokens):
                row[i] = token_to_idx.get(tok, unk)
            rows.append(row)
            lengths.append(len(tokens))
    return np.vstack(rows), np.asarray(lengths, np.int32)


def encode_boxes(data: List[Dict], original_heights, original_widths,
                 image_size: int) -> np.ndarray:
    """Scale 1-indexed (x, y, w, h) to resized coords, clamp, convert to
    integer (xc, yc, w, h) — bitwise the reference math (:146-183)."""
    all_boxes = []
    xwasbad = ywasbad = wwasbad = hwasbad = 0   # clamp counters (:148-151)
    for i, img in enumerate(data):
        h0, w0 = original_heights[i], original_widths[i]
        scale = float(image_size) / max(h0, w0)
        for region in img["regions"]:
            if region.get("tokens") is None:
                continue
            x = round(scale * (region["x"] - 1) + 1)
            y = round(scale * (region["y"] - 1) + 1)
            w = round(scale * region["width"])
            h = round(scale * region["height"])
            if x < 0:
                x = 0
            if y < 0:
                y = 0
            if x > image_size - 1:
                x = image_size - 1
                xwasbad += 1
            if y > image_size - 1:
                y = image_size - 1
                ywasbad += 1
            if x + w > image_size:
                w = image_size - x
                wwasbad += 1
            if y + h > image_size:
                h = image_size - y
                hwasbad += 1
            box = np.asarray([x + floor(w / 2), y + floor(h / 2), w, h],
                             np.int32)
            assert box[2] >= 0 and box[3] >= 0
            all_boxes.append(box)
    # the reference's clamp diagnostic (:182) — only the upper-bound
    # clamps count; x<0/y<0 fixes are silent there too
    print("number of bad x,y,w,h: ", xwasbad, ywasbad, wwasbad, hwasbad)
    return np.vstack(all_boxes)


def build_img_idx_to_box_idxs(data: List[Dict]):
    n = len(data)
    first = np.zeros(n, np.int32)
    last = np.zeros(n, np.int32)
    box_idx = 1
    for i, img in enumerate(data):
        first[i] = box_idx
        for region in img["regions"]:
            if region.get("tokens") is not None:
                box_idx += 1
        last[i] = box_idx - 1
    return first, last


def build_filename_dict(data: List[Dict]):
    filenames = ["%d.jpg" % img["id"] for img in data]
    assert len(filenames) == len(set(filenames))
    filename_to_idx = {f: i + 1 for i, f in enumerate(filenames)}
    idx_to_filename = {i + 1: f for i, f in enumerate(filenames)}
    return filename_to_idx, idx_to_filename


def encode_filenames(data: List[Dict], filename_to_idx) -> np.ndarray:
    out = []
    for img in data:
        idx = filename_to_idx["%d.jpg" % img["id"]]
        for region in img["regions"]:
            if region.get("tokens") is not None:
                out.append(idx)
    return np.asarray(out, np.int32)


def add_images(data: List[Dict], h5_file, image_dir: str, image_size: int,
               num_workers: int = 4, verbose: bool = False):
    """Threaded resize-and-write: longest edge → image_size, upper-left
    aligned, zero padded (:225-274)."""
    from PIL import Image

    n = len(data)
    dset = h5_file.create_dataset("images", (n, image_size, image_size, 3),
                                  dtype=np.uint8)
    original_heights = np.zeros(n, np.int32)
    original_widths = np.zeros(n, np.int32)
    image_heights = np.zeros(n, np.int32)
    image_widths = np.zeros(n, np.int32)

    lock = Lock()
    q: "Queue" = Queue()
    for i, img in enumerate(data):
        q.put((i, os.path.join(image_dir, "%d.jpg" % img["id"])))

    def worker():
        while True:
            i, filename = q.get()
            img = _imread_rgb(filename)
            h0, w0 = img.shape[0], img.shape[1]
            img = np.array(Image.fromarray(img).resize(
                (int(image_size * w0 / max(h0, w0)),
                 int(image_size * h0 / max(h0, w0)))))
            h, w = img.shape[0], img.shape[1]
            with lock:
                if verbose and i % 1000 == 0:
                    print(f"Writing image {i} / {n}")
                original_heights[i] = h0
                original_widths[i] = w0
                image_heights[i] = h
                image_widths[i] = w
                dset[i, :h, :w, :] = img
            q.task_done()

    for _ in range(num_workers):
        t = Thread(target=worker, daemon=True)
        t.start()
    q.join()
    return original_heights, original_widths, image_heights, image_widths


def run(region_data: str, image_dir: str, split_json: str,
        h5_output: str, json_output: str, *, image_size: int = 720,
        max_token_length: int = 15, min_token_instances: int = 15,
        max_images: int = -1, num_workers: int = 4,
        verbose: bool = False) -> Dict:
    """Full preprocessing pass; returns the dicts-JSON struct."""
    h5py = import_h5py()

    with open(region_data) as f:
        data = json.load(f)
    with open(split_json) as f:
        split_data = json.load(f)
    data = filter_images(data, split_data)
    if max_images > 0:
        data = data[:max_images]

    os.makedirs(os.path.dirname(h5_output) or ".", exist_ok=True)
    with h5py.File(h5_output, "w") as f:
        f.create_dataset("split", data=encode_splits(data, split_data))
        (oh, ow, ih, iw) = add_images(data, f, image_dir, image_size,
                                      num_workers, verbose)
        f.create_dataset("image_heights", data=ih)
        f.create_dataset("image_widths", data=iw)
        f.create_dataset("original_heights", data=oh)
        f.create_dataset("original_widths", data=ow)

        split_filter_captions(data, max_token_length, verbose)
        vocab = build_vocab(iter_tokens(data), min_token_instances, verbose)
        token_to_idx, idx_to_token = build_vocab_dict(vocab)
        captions, lengths = encode_captions(data, token_to_idx,
                                            max_token_length)
        f.create_dataset("labels", data=captions)
        f.create_dataset("lengths", data=lengths)
        f.create_dataset("boxes", data=encode_boxes(data, oh, ow,
                                                    image_size))
        first, last = build_img_idx_to_box_idxs(data)
        f.create_dataset("img_to_first_box", data=first)
        f.create_dataset("img_to_last_box", data=last)
        filename_to_idx, idx_to_filename = build_filename_dict(data)
        f.create_dataset("box_to_img",
                         data=encode_filenames(data, filename_to_idx))

    json_struct = {
        "token_to_idx": token_to_idx,
        "idx_to_token": idx_to_token,
        "filename_to_idx": filename_to_idx,
        "idx_to_filename": {str(k): v for k, v in idx_to_filename.items()},
    }
    write_json(json_output, json_struct)
    return json_struct


def main(argv: Optional[Sequence[str]] = None):
    import argparse
    p = argparse.ArgumentParser(
        description="VG-regions preprocessing (reference preprocess.py)")
    p.add_argument("--region_data",
                   default="datasets/vg/region_descriptions.json")
    p.add_argument("--image_dir", default="datasets/vg/VG_100K")
    p.add_argument("--split_json", default="info/densecap_splits.json")
    p.add_argument("--json_output", default="data/VG-regions-dicts.json")
    p.add_argument("--h5_output", default="data/VG-regions.h5")
    p.add_argument("--image_size", default=720, type=int)
    p.add_argument("--max_token_length", default=15, type=int)
    p.add_argument("--min_token_instances", default=15, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--max_images", default=-1, type=int)
    a = p.parse_args(argv)
    run(a.region_data, a.image_dir, a.split_json, a.h5_output,
        a.json_output, image_size=a.image_size,
        max_token_length=a.max_token_length,
        min_token_instances=a.min_token_instances,
        max_images=a.max_images, num_workers=a.num_workers, verbose=True)


if __name__ == "__main__":
    main()
