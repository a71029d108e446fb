"""Device-resident dataset — port of `imagecaptioning_tpu/data/
device_store.py` (`stage_split`, `gather_batch`, `index_stream`, `fits`).

Face2Text is 8,489 uint8 images of 218×178×3, about 0.99 GB. The whole
training split is copied to the card once, and each step sends only its
(batch,) int64 positions (96 bytes at batch 12); the gather, the
preprocess and the first convolution then run on the card. When the
split does not fit the budget (`fits`), the driver streams batches from
the host instead (`loader.prefetch_batches`): the same batches in the same
order, since both paths follow `AlexDataLoader.epoch_position_batches`.
In a data-parallel run every rank stages the whole split on its own card
(replicated, as the JAX package stages it over its mesh) and gathers
only its rows of each index batch (the driver passes them).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch


class ResidentStore(NamedTuple):
    """A split's images and labels in the card's memory."""
    images: torch.Tensor    # (n, H, W, 3) uint8
    labels: torch.Tensor    # (n, T) int64

    @property
    def num_items(self) -> int:
        return self.images.shape[0]

    @property
    def nbytes(self) -> int:
        return (self.images.numel() * self.images.element_size()
                + self.labels.numel() * self.labels.element_size())


def device_memory_budget(device: torch.device) -> Optional[int]:
    """The card's free memory in bytes (`torch.cuda.mem_get_info`); None
    for the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


# the share of the budget a store may take, beside the parameters,
# optimizer state and activations
BUDGET_SHARE = 0.35


def fits(nbytes: int, budget: Optional[int]) -> bool:
    """Whether a store of `nbytes` fits in BUDGET_SHARE of `budget` bytes.
    With no budget (the CPU) host memory is taken to be ample."""
    return budget is None or nbytes <= BUDGET_SHARE * budget


def stage_split(loader, split_val: int,
                device: torch.device) -> ResidentStore:
    """One copy of a split of an `AlexDataLoader` to `device`, in position
    order: the positions of `epoch_position_batches` index it directly."""
    images_np, labels_np = loader.resident_arrays(split_val)
    return ResidentStore(
        images=torch.from_numpy(np.ascontiguousarray(images_np)).to(device),
        labels=torch.from_numpy(np.asarray(labels_np)).to(device).long())


def gather_batch(store: ResidentStore,
                 idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) positions on the store's device → (images, labels)."""
    return (store.images.index_select(0, idx),
            store.labels.index_select(0, idx))


def index_stream(loader, split_val: int, batch_size: int, *,
                 iterate: bool, start_images: int = 0) -> Iterator[np.ndarray]:
    """Endless sorted position batches with the training loop's order:
    sequential epochs when `iterate` (the resume cursor honoured), else a
    fresh shuffle each epoch."""
    while True:
        yield from loader.epoch_position_batches(
            split_val, batch_size, shuffle=not iterate,
            start=start_images if iterate else 0)
        start_images = 0
