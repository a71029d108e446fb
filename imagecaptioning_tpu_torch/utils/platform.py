"""Device resolution for the port's entry points.

Plays the role of the JAX package's `utils/platform.py` (which makes an
explicit `JAX_PLATFORMS` win): the port's entry points run on the first
CUDA card, or under torchrun on the card `cuda:LOCAL_RANK`, unless the
caller asks for the CPU, and they never fall back to the CPU silently.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` → ``cuda:0``, or ``cuda:LOCAL_RANK`` in a torchrun launch.
    Raises when CUDA is asked for (explicitly or by default) and is not
    available; pass ``"cpu"`` to run on the CPU."""
    if device is None:
        device = f"cuda:{os.environ.get('LOCAL_RANK', 0)}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
