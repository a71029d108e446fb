"""Fixed-budget greedy non-maximum suppression — port of
`imagecaptioning_tpu/ops/nms.py:22-52`.

The reference calls `torchvision.ops.nms`, whose output size depends on
the data (`DenseCap/densecap/LocalizationLayer.py:228-234`). The JAX
package returns exactly `max_out` indices and a keep mask instead, a
greedy loop over the fixed budget, and so does the port: each step picks
the live box of highest score, then suppresses it and every box whose IoU
with it is above the threshold.

The JAX version precomputes the N×N IoU matrix. At the RPN's 720² canvas
an image has 24,300 proposals, and eager PyTorch would hold ~20 GB of
intermediates for that matrix; so each step here computes only the picked
box's row, with the matrix's elementwise operations in the same order
(`ops.boxes.corners_iou`): the same values, so the same picks. One loop
of `max_out` steps serves the whole batch, with no host synchronisation
inside it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from imagecaptioning_tpu_torch.ops.boxes import (corner_areas, corners_iou,
                                                 xcycwh_to_x1y1x2y2)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
        max_out: int, valid: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (..., A, 4) xcycwh, scores (..., A) → (indices (..., max_out)
    long, keep (..., max_out) bool). A box with `valid` False is never
    picked; slots past the last pick are (0, False). Among equal scores
    the lower index is picked first (argmax's first maximum, as
    `jnp.argmax`)."""
    lead = scores.shape[:-1]
    corners = xcycwh_to_x1y1x2y2(boxes.float()).reshape(
        -1, boxes.shape[-2], 4)
    areas = corner_areas(corners)                        # (B, A)
    live = scores.float().reshape(-1, scores.shape[-1])  # (B, A)
    neg = torch.tensor(float("-inf"), device=live.device)
    if valid is not None:
        live = torch.where(valid.reshape(live.shape), live, neg)
    positions = torch.arange(live.shape[-1], device=live.device)
    picks, kept = [], []
    for _ in range(max_out):
        best = live.argmax(dim=-1, keepdim=True)         # (B, 1)
        ok = live.gather(-1, best) > neg
        picks.append(torch.where(ok, best, 0))
        kept.append(ok)
        picked = corners.gather(1, best[..., None].expand(-1, 1, 4))
        row = corners_iou(picked, areas.gather(-1, best), corners,
                          areas)[:, 0]
        suppress = (row > iou_thresh) | (positions == best)
        live = torch.where(ok & suppress, neg, live)
    return (torch.cat(picks, -1).reshape(*lead, max_out),
            torch.cat(kept, -1).reshape(*lead, max_out))
