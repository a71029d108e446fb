"""Offline Face2Text/CelebA preprocessing — port of
`imagecaptioning_tpu/data/preprocess_face2text.py`: aligned CelebA JPEGs +
Face2Text caption JSONs + 40-attribute CSV → HDF5 + dicts JSON,
schema-compatible with the reference `AlexCap/my_model_preprocess.py`
and byte for byte the JAX package's output. The JAX module reads the
attribute CSV with pandas; this one with the `csv` module, keeping what
pandas gives (row order, the first row of a repeated `image_id`, the
columns without `image_id`, int64 for integer columns, float64 where any
value is fractional or empty). Host code; it needs h5py, imported by
`run` (the card's machine has none).

Pipeline (reference `:282-330`):
  split_data (concat train/val/test JSONs → split codes 0/1/2 + align
  attribute rows by filename via `list_attr_celeba.csv`, `:269-280`) →
  add_images (threaded write of fixed 218×178 JPEGs, grayscale fix,
  `:180-213`) → split_filter_captions (tokenize; `max_token_length<=0`
  derives T from the data, `:251-264`) → build_vocab(min_count=1 by
  default)+dicts (`:90-124`) → encode_captions (M,T) int32 (`:137-145`) →
  img_to_first_phr/img_to_last_phr **0-indexed** phrase slabs (`:148-162`
  — NB unlike the VG preprocessor's 1-indexed box slabs).

Input JSON format: a list of {"filename": str, "description": [str, ...]}.
"""

from __future__ import annotations

import csv
import json
import os
from queue import Queue
from threading import Lock, Thread
from typing import Dict, List, Optional, Sequence

import numpy as np

from imagecaptioning_tpu_torch.data.preprocess_vg import import_h5py
from imagecaptioning_tpu_torch.data.tokenizer import (build_vocab,
                                                      build_vocab_dict,
                                                      words_preprocess)
from imagecaptioning_tpu_torch.utils.io import write_json


def split_data(train_data: List[Dict], val_data: List[Dict],
               test_data: List[Dict], attr_csv_path: str):
    """Concatenate splits, derive split codes and aligned attribute rows
    (`my_model_preprocess.py:269-280`)."""
    full_data = list(train_data) + list(val_data) + list(test_data)
    split = np.zeros(len(full_data), dtype=int)
    split[len(train_data):len(train_data) + len(val_data)] = 1
    split[len(train_data) + len(val_data):] = 2

    ids, values, attr_label = read_attributes(attr_csv_path)
    first = {}
    for row, image_id in enumerate(ids):
        first.setdefault(image_id, row)
    missing = [d["filename"] for d in full_data if d["filename"] not in first]
    if missing:
        raise ValueError(f"{attr_csv_path} has no row for {missing[:3]}")
    attr_list = values[[first[dic["filename"]] for dic in full_data]]
    return split, full_data, attr_list, attr_label


def _number(cell: str):
    """A CSV cell as pandas' parser reads a numeric one: int, else float
    (an empty cell is NaN), else None."""
    cell = cell.strip()
    if not cell:
        return float("nan")
    try:
        return int(cell)
    except ValueError:
        pass
    try:
        return float(cell)
    except ValueError:
        return None


def read_attributes(path: str):
    """The attribute CSV → (image ids in file order, values (rows,
    columns), column names without `image_id`), as
    `pandas.read_csv(path, index_col="image_id")` gives them: int64 where
    every value is an integer, else float64."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = rows[0]
    col = header.index("image_id")
    ids = [r[col] for r in rows[1:]]
    cells = [[_number(c) for i, c in enumerate(r) if i != col]
             for r in rows[1:]]
    if any(v is None for r in cells for v in r):
        raise ValueError(f"{path}: attribute values must be numbers")
    ints = all(isinstance(v, int) for r in cells for v in r)
    values = np.asarray(cells, np.int64 if ints else np.float64).reshape(
        len(cells), len(header) - 1)
    return ids, values, [h for i, h in enumerate(header) if i != col]


def split_filter_captions(data: List[Dict], max_token_length: int,
                          verbose: bool = False):
    """Tokenize each description in place; over-length → None. Returns
    (lengths vector over kept captions, resolved max_token_length)."""
    kept = removed = 0
    lengths: List[int] = []
    for img in data:
        for j, phrase in enumerate(img["description"]):
            tokens = words_preprocess(phrase)
            if max_token_length <= 0 or len(tokens) <= max_token_length:
                img["description"][j] = tokens
                kept += 1
                lengths.append(len(tokens))
            else:
                img["description"][j] = None
                removed += 1
    if max_token_length <= 0:
        max_token_length = int(np.max(lengths))
    if verbose:
        print(f"Keeping {kept} captions; skipped {removed} as too long")
    return np.asarray(lengths, np.int32), max_token_length


def iter_tokens(data: List[Dict]):
    for img in data:
        for phrase in img["description"]:
            if phrase is not None:
                yield phrase


def encode_captions(data: List[Dict], token_to_idx: Dict[str, int],
                    max_token_length: int) -> np.ndarray:
    unk = token_to_idx.get("<UNK>")
    rows = []
    for img in data:
        for tokens in img["description"]:
            if tokens is None:
                continue
            row = np.zeros(max_token_length, np.int32)
            for i, tok in enumerate(tokens):
                row[i] = token_to_idx.get(tok, unk)
            rows.append(row)
    return np.vstack(rows)


def build_img_idx_to_phr_idxs(data: List[Dict]):
    """0-indexed inclusive phrase slabs (`my_model_preprocess.py:148-162`)."""
    n = len(data)
    first = np.zeros(n, np.int32)
    last = np.zeros(n, np.int32)
    phr_idx = 0
    for i, img in enumerate(data):
        first[i] = phr_idx
        for phrase in img["description"]:
            if phrase is not None:
                phr_idx += 1
        last[i] = phr_idx - 1
    return first, last


def build_filename_dict(data: List[Dict]):
    filenames = [img["filename"] for img in data]
    assert len(filenames) == len(set(filenames))
    filename_to_idx = {f: i for i, f in enumerate(filenames)}
    idx_to_filename = {i: f for i, f in enumerate(filenames)}
    return filename_to_idx, idx_to_filename


def add_images(data: List[Dict], h5_file, image_dir: str,
               image_height: int = 218, image_width: int = 178,
               num_workers: int = 4, verbose: bool = False) -> None:
    from PIL import Image

    n = len(data)
    dset = h5_file.create_dataset(
        "images", (n, image_height, image_width, 3), dtype=np.uint8)
    lock = Lock()
    q: "Queue" = Queue()
    for i, dic in enumerate(data):
        q.put((i, os.path.join(image_dir, dic["filename"])))

    def worker():
        while True:
            i, filename = q.get()
            img = np.asarray(Image.open(filename))
            if img.ndim == 2:
                img = img[:, :, None][:, :, [0, 0, 0]]
            with lock:
                if verbose and i % 1000 == 0:
                    print(f"Writing image {i} / {n}")
                dset[i] = img
            q.task_done()

    for _ in range(num_workers):
        t = Thread(target=worker, daemon=True)
        t.start()
    q.join()


def run(train_data_path: str, val_data_path: str, test_data_path: str,
        attr_data: str, image_dir: str, h5_output: str, json_output: str,
        *, image_height: int = 218, image_width: int = 178,
        max_token_length: int = 0, min_token_instances: int = 1,
        num_workers: int = 4, verbose: bool = False) -> Dict:
    h5py = import_h5py()

    with open(train_data_path) as f:
        train_data = json.load(f)
    with open(val_data_path) as f:
        val_data = json.load(f)
    with open(test_data_path) as f:
        test_data = json.load(f)

    splits, data, attributes, attributes_labels = split_data(
        train_data, val_data, test_data, attr_data)

    os.makedirs(os.path.dirname(h5_output) or ".", exist_ok=True)
    with h5py.File(h5_output, "w") as f:
        f.create_dataset("split", data=splits)
        f.create_dataset("attributes", data=attributes)
        add_images(data, f, image_dir, image_height, image_width,
                   num_workers, verbose)
        lengths, max_token_length = split_filter_captions(
            data, max_token_length, verbose)
        f.create_dataset("lengths", data=lengths)
        vocab = build_vocab(iter_tokens(data), min_token_instances, verbose)
        token_to_idx, idx_to_token = build_vocab_dict(vocab)
        f.create_dataset("labels",
                         data=encode_captions(data, token_to_idx,
                                              max_token_length))
        first, last = build_img_idx_to_phr_idxs(data)
        f.create_dataset("img_to_first_phr", data=first)
        f.create_dataset("img_to_last_phr", data=last)
        filename_to_idx, idx_to_filename = build_filename_dict(data)

    json_struct = {
        "token_to_idx": token_to_idx,
        "idx_to_token": idx_to_token,
        "filename_to_idx": filename_to_idx,
        "idx_to_filename": {str(k): v for k, v in idx_to_filename.items()},
        "attributes_labels": attributes_labels,
    }
    write_json(json_output, json_struct)
    return json_struct


def main(argv: Optional[Sequence[str]] = None):
    import argparse
    p = argparse.ArgumentParser(
        description="Face2Text preprocessing "
                    "(reference AlexCap/my_model_preprocess.py)")
    p.add_argument("--train_data", default="data/my_clean_train_2.1.json")
    p.add_argument("--val_data", default="data/my_clean_dev_2.1.json")
    p.add_argument("--test_data", default="data/my_clean_test_2.1.json")
    p.add_argument("--attr_data", default="data/list_attr_celeba.csv")
    p.add_argument("--image_dir",
                   default="data/img_align_celeba/img_align_celeba")
    p.add_argument("--json_output", default="data/face2text-dicts.json")
    p.add_argument("--h5_output", default="data/face2text-data.h5")
    p.add_argument("--image_height", default=218, type=int)
    p.add_argument("--image_width", default=178, type=int)
    p.add_argument("--max_token_length", default=0, type=int)
    p.add_argument("--min_token_instances", default=1, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    a = p.parse_args(argv)
    run(a.train_data, a.val_data, a.test_data, a.attr_data, a.image_dir,
        a.h5_output, a.json_output, image_height=a.image_height,
        image_width=a.image_width, max_token_length=a.max_token_length,
        min_token_instances=a.min_token_instances,
        num_workers=a.num_workers, verbose=True)


if __name__ == "__main__":
    main()
