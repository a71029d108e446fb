"""Seeded weights for a parameter layout, made on the device in one draw.

Both sides get the same tensors: the benchmark copies them into the
program's parameters by name, and makes them again from the same seed for
the reference once the program's state is freed. Parameters that the
configuration serves in a narrow type are rounded to it here, so that the
reference computes with the very values the program holds.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's `--seed`."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def bound(init: str, shape: Sequence[int], weight_shape: Sequence[int]):
    """The half-width of the uniform draw: the fan-in is the weight's
    (a bias takes its layer's)."""
    fan_in = int(np.prod(weight_shape[1:])) if len(weight_shape) > 1 \
        else int(weight_shape[0])
    if init == "he":
        return math.sqrt(6.0 / fan_in) if len(shape) > 1 \
            else 1.0 / math.sqrt(fan_in)
    if init == "default":
        return 1.0 / math.sqrt(fan_in)
    if init == "zero":
        return 0.0
    raise ValueError(f"unknown init {init!r}")


def make(layout: Iterable[Tuple[str, Tuple[int, ...], str]], seed: int,
         device, narrow: Tuple[str, ...] = (),
         narrow_dtype: Optional[torch.dtype] = None
         ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for `layout`, from one uniform draw of a
    generator on `device` seeded with `subseed(seed, "weights")`; names
    starting with a prefix in `narrow` rounded to `narrow_dtype`."""
    layout = list(layout)
    shapes = {n: s for n, s, _ in layout}
    total = sum(int(np.prod(s)) for _, s, _ in layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights"))
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in layout:
        n = int(np.prod(shape))
        w_shape = shapes.get(name.rsplit(".", 1)[0] + ".weight", shape)
        b = bound(init, shape, w_shape)
        t = flat[at:at + n].view(shape).mul(2 * b).sub_(b)
        at += n
        if narrow_dtype is not None and name.startswith(narrow):
            t = t.to(narrow_dtype).float()
        out[name] = t
    del flat
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy `weights` into `module`'s parameters of the same names (cast to
    each parameter's type); the two name sets and shapes must agree."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"parameters the program has and the layout lacks: "
                       f"{sorted(set(params) - set(weights))}; the layout "
                       f"has and the program lacks: "
                       f"{sorted(set(weights) - set(params))}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, layout "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
