"""Published dense peaks of the cards the benchmark knows (NVIDIA's data
sheets, SXM parts, without sparsity, at the full power limit)."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp32_flops": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}


def for_device(name: str) -> Optional[Dict[str, float]]:
    """The peaks of the card whose `torch.cuda.get_device_name()` is
    `name`, or None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return None
