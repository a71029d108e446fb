"""Face2Text data loader — port of `imagecaptioning_tpu/data/loader.py`
(`AlexDataLoader`, `prefetch_batches`).

API parity with the reference's `AlexCap/MyDataLoader.py`: split codes
0/1/2, a per-split iterator with wrap-to-zero semantics (`:71-83`),
random sampling without replacement when not iterating, `getSeqLength` /
`getVocabSize` / `reset_iterator`, and the `(img, labels, info,
attributes)` tuple of `get_batch` with clamped attributes (`:88-95`).

Batches leave the host as uint8 HWC; the resize and normalization run on
the card (`data.transforms`). The images come from arrays, or from the
HDF5 file (`h5py`, imported only then), read whole into RAM
(`cache_images`, the default; batches then come from the native
multi-threaded gather, `native.gather_records`, as in the JAX loader) or
lazily per batch. One `RandomState`
drives every shuffle and draw, in the JAX package's order, so batches
come in the same order in both packages, on the streaming path and the
device-resident one (`data.device_store`) alike; the resume cursor is
`iterators`.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from imagecaptioning_tpu_torch import native
from imagecaptioning_tpu_torch.data.tokenizer import Vocab


class AlexDataLoader:
    """Loads the Face2Text HDF5 + dicts JSON (the reference preprocessor's
    output), or the same arrays held in memory."""

    def __init__(self, opt=None, *, data_h5: Optional[str] = None,
                 data_json: Optional[str] = None,
                 arrays: Optional[Dict] = None, info: Optional[Dict] = None,
                 cache_images: bool = True, seed: int = 123):
        if opt is not None:
            data_h5 = data_h5 or opt.get("data_h5")
            data_json = data_json or opt.get("data_json")
        if arrays is None:
            import h5py
            with open(data_json, "r") as f:
                info = json.load(f)
            f5 = h5py.File(data_h5, "r")
            keys = ["img_to_first_phr", "img_to_last_phr", "labels",
                    "lengths", "split", "attributes"]
            arrays = {k: f5["/" + k][:] for k in keys}
            if cache_images:
                arrays["images"] = f5["/images"][:]
                f5.close()
            else:
                arrays["images"] = f5["/images"]  # lazy h5 dataset
        assert info is not None

        self.info = info
        self.vocab = Vocab.from_dicts_json(info)
        self.vocab_size = self.vocab.vocab_size
        self.idx_to_token = self.vocab.idx_to_token
        self.attributes_labels = info.get("attributes_labels", [])

        self.images = arrays["images"]
        self.labels = np.asarray(arrays["labels"])
        self.lengths = np.asarray(arrays["lengths"])
        self.split = np.asarray(arrays["split"])
        self.attributes = np.asarray(arrays["attributes"])
        self.img_to_first_phr = np.asarray(arrays["img_to_first_phr"])
        self.img_to_last_phr = np.asarray(arrays["img_to_last_phr"])

        self.num_images = self.images.shape[0]
        self.seq_length = int(self.labels.shape[1])
        self.iterators = {0: 0, 1: 0, 2: 0}
        self._rng = np.random.RandomState(seed)

        self.split_ix: Dict[int, List[int]] = {0: [], 1: [], 2: []}
        for i in range(self.num_images):
            self.split_ix[int(self.split[i])].append(i)

    # --- reference API -------------------------------------------------
    def getSeqLength(self) -> int:
        return self.seq_length

    def getVocabSize(self) -> int:
        return self.vocab_size

    def reset_iterator(self, split_val: int) -> None:
        self.iterators[split_val] = 0

    def _gather(self, ix: np.ndarray) -> np.ndarray:
        """The images `ix`: the native gather over an in-RAM array (the
        JAX loader's `gather_records`), a per-record read of a lazy HDF5
        store."""
        if isinstance(self.images, np.ndarray):
            return native.gather_records(self.images, ix)
        return np.stack([np.asarray(self.images[int(i)]) for i in ix])

    def get_batch(self, opt, batch_size: int, idx: int = -1):
        """(images_u8 (B, H, W, 3), labels (B, T) i32, info_table,
        attributes (B, 40) clamped ≥ 0). One caption per image: the first
        phrase of the image's slab, like the reference preprocessor's
        labels layout."""
        split_val = opt.get("split", 0) if hasattr(opt, "get") else 0
        iterate = opt.get("iterate", True) if hasattr(opt, "get") else True
        split_ix = self.split_ix[split_val]
        assert len(split_ix) > 0, "split is empty?"
        max_index = len(split_ix)

        if iterate:
            ri = self.iterators[split_val]
            ri_next = ri + batch_size
            if ri_next >= max_index:
                ri_next = 0      # wrap like the reference (drops tail batch)
            self.iterators[split_val] = ri_next
            ix = split_ix[ri:ri + batch_size]
        elif idx != -1:
            ix = [split_ix[idx]]
            ri = idx
        else:
            ri = np.sort(self._rng.choice(max_index, size=batch_size,
                                          replace=False))
            ix = [split_ix[r] for r in ri]

        ix = np.asarray(ix)
        images = self._gather(ix)
        labels = self.labels[self.img_to_first_phr[ix]]
        attrs = np.clip(self.attributes[ix], 0, None)
        filenames = [self.info["idx_to_filename"][str(int(i))]
                     for i in ix] if "idx_to_filename" in self.info else []
        info_table = [{"filename": filenames, "split_bounds": [ri, max_index]}]
        return images, labels, info_table, attrs

    # --- feeding the card ----------------------------------------------
    def epoch_position_batches(self, split_val: int, batch_size: int,
                               shuffle: bool = False,
                               start: int = 0) -> Iterator[np.ndarray]:
        """Sorted split-local position batches (indices into the split's
        own 0..n-1 range) covering the split once, ragged tail dropped:
        the single source of batch order. The streaming path maps them to
        global ids and gathers on the host; the device-resident path ships
        the positions and gathers on the card."""
        n = len(self.split_ix[split_val])
        pos = np.arange(n)
        if shuffle:
            pos = self._rng.permutation(pos)
        if start:
            pos = pos[start % n:]
        for s in range(0, len(pos) - batch_size + 1, batch_size):
            yield np.sort(pos[s:s + batch_size])

    def epoch_batches(self, split_val: int, batch_size: int,
                      shuffle: bool = False,
                      start: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(images_u8, labels) covering a split once, ragged tail dropped.
        `start` skips that many leading images: the sequential-mode resume
        cursor."""
        ix_arr = np.asarray(self.split_ix[split_val])
        for p in self.epoch_position_batches(split_val, batch_size,
                                             shuffle=shuffle, start=start):
            sel = ix_arr[p]      # sorted: ix_arr ascending, p sorted
            yield self._gather(sel), self.labels[self.img_to_first_phr[sel]]

    def resident_arrays(self, split_val: int) -> Tuple[np.ndarray, np.ndarray]:
        """(images_u8 (n, H, W, 3), labels (n, T)) of a whole split in
        split-local position order: the host side of staging the split on
        the card (`data.device_store`); positions from
        `epoch_position_batches` index it directly."""
        ix_arr = np.asarray(self.split_ix[split_val])
        return (self._gather(ix_arr),
                self.labels[self.img_to_first_phr[ix_arr]])


def prefetch_batches(it: Iterator, size: int = 2,
                     to_device: Optional[Callable] = None) -> Iterator:
    """Run `it` in a background thread, `to_device` applied to each
    element of every item (a tuple) there, keeping `size` items in flight,
    so that the host's reads and copies overlap the card's work. An error
    in the thread is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(tuple(map(to_device, item)) if to_device else item)
        except BaseException as err:       # handed to the consumer
            q.put(err)
            return
        q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
