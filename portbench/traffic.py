"""The one traffic generator: host batches made from a traffic file's
parameters and the run's seed.

A traffic file (`portbench/workloads/<traffic>.json`) names its loop
(`loop`) and the shape of its work: images a batch and their side, boxes
an image and their sides, caption lengths, and how many distinct batches
the pool holds (`pool`). The sizes of the boxes and the lengths of the
captions are one fixed multiset for the traffic, the same for every seed;
the seed deals them out in another order, places the boxes and draws the
pixels and the words. So two seeds give the same work in another
arrangement.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.weights import subseed


def _fixed(traffic: Dict, n: int, lo: float, hi: float, log: bool):
    """n values of the traffic's fixed multiset in [lo, hi] (from its name,
    not the run's seed)."""
    rng = np.random.default_rng(subseed(0, "sizes:" + traffic["name"]))
    u = rng.random(n)
    if log:
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return lo + u * (hi - lo)


def boxes(traffic: Dict, rng: np.random.Generator, count: int, side: int):
    """(count, 4) float32 xcycwh boxes in 1-indexed pixels, wholly inside
    a side x side image, sides from the traffic's `box_side` range."""
    lo, hi = traffic["box_side"]
    wh = _fixed(traffic, 2 * count, lo, hi, log=True).reshape(count, 2)
    wh = np.floor(wh[rng.permutation(count)])
    c = 1 + (wh - 1) / 2 + rng.random((count, 2)) * (side - wh)
    return np.concatenate([c, wh], 1).astype(np.float32)


def captions(traffic: Dict, rng: np.random.Generator, count: int,
             vocab: int, width: int):
    """(count, width) int32 captions of words 1..vocab, zero padded, their
    lengths from the traffic's `caption_length` range."""
    lo, hi = traffic["caption_length"]
    lengths = np.floor(_fixed(traffic, count, lo, hi + 1, log=False))
    lengths = lengths.astype(np.int64)[rng.permutation(count)]
    words = rng.integers(1, vocab + 1, (count, width))
    return np.where(np.arange(width) < lengths[:, None], words,
                    0).astype(np.int32)


def pool(traffic: Dict, config: Dict,
         seed: int) -> List[Dict[str, np.ndarray]]:
    """The traffic's `pool` distinct host batches, each {"image": uint8
    (B, S, S, 3), "boxes": float32 (B, M, 4)}, and for captioned traffic
    "labels" int32 (B, M, T) and "box_mask" float32 (B, M)."""
    rng = np.random.default_rng(subseed(seed, "traffic"))
    b, s, m = traffic["images"], traffic["image_side"], traffic["boxes"]
    n = traffic["pool"]
    all_boxes = boxes(traffic, rng, n * b * m, s).reshape(n, b, m, 4)
    if "caption_length" in traffic:
        caps = captions(traffic, rng, n * b * m, config["vocab_size"],
                        config["seq_length"]).reshape(n, b, m, -1)
    out = []
    for i in range(n):
        batch = {"image": rng.integers(0, 256, (b, s, s, 3), np.uint8),
                 "boxes": all_boxes[i]}
        if "caption_length" in traffic:
            batch["labels"] = caps[i]
            batch["box_mask"] = np.ones((b, m), np.float32)
        out.append(batch)
    return out
