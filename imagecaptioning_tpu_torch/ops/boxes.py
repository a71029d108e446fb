"""Box geometry — port of `imagecaptioning_tpu/ops/boxes.py`
(reference `DenseCap/densecap/box_utils.py`, `ApplyBoxTransform.py`,
`InvertBoxTransform.py`, `BoxIoU.py`, `MakeAnchors.py`, `MakeBoxes.py`).

Every function works on (..., 4) tensors with any leading batch
dimensions and does the JAX package's elementwise operations in the same
order, so fp32 results are the same bits. `xcycwh` is (x_center,
y_center, w, h) in 1-indexed pixel coordinates, `x1y1x2y2` corners.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def xcycwh_to_x1y1x2y2(boxes: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = boxes.unbind(-1)
    return torch.stack([xc - (w - 1) / 2, yc - (h - 1) / 2,
                        xc + (w - 1) / 2, yc + (h - 1) / 2], dim=-1)


def x1y1x2y2_to_xcycwh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1 + 1,
                        y2 - y1 + 1], dim=-1)


def xcycwh_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = boxes.unbind(-1)
    return torch.stack([xc - (w - 1) / 2, yc - (h - 1) / 2, w, h], dim=-1)


def xywh_to_xcycwh(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x + (w - 1) / 2, y + (h - 1) / 2, w, h], dim=-1)


def corner_areas(corners: torch.Tensor) -> torch.Tensor:
    return ((corners[..., 2] - corners[..., 0])
            * (corners[..., 3] - corners[..., 1]))


def corners_iou(a: torch.Tensor, area_a: torch.Tensor, b: torch.Tensor,
                area_b: torch.Tensor) -> torch.Tensor:
    """IoU of corner boxes a (..., N, 4) against b (..., M, 4) with their
    areas → (..., N, M), in `box_iou`'s order of operations."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xcycwh boxes: (..., N, 4) × (..., M, 4) →
    (..., N, M)."""
    a = xcycwh_to_x1y1x2y2(a)
    b = xcycwh_to_x1y1x2y2(b)
    return corners_iou(a, corner_areas(a), b, corner_areas(b))


def clip_boxes(boxes: torch.Tensor, h: float, w: float,
               fmt: str = "xcycwh") -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip to [1, W]×[1, H] (1-indexed like the reference) → (clipped,
    valid), valid where the clipped box has a positive area (reference
    clip_boxes, box_utils.py:132-159)."""
    corners = xcycwh_to_x1y1x2y2(boxes) if fmt == "xcycwh" else boxes
    x1 = corners[..., 0].clamp(1, w)
    y1 = corners[..., 1].clamp(1, h)
    x2 = corners[..., 2].clamp(1, w)
    y2 = corners[..., 3].clamp(1, h)
    clipped = torch.stack([x1, y1, x2, y2], dim=-1)
    valid = (x2 > x1) & (y2 > y1)
    if fmt == "xcycwh":
        clipped = x1y1x2y2_to_xcycwh(clipped)
    return clipped, valid


def make_anchors(anchor_wh: torch.Tensor, x0: float, y0: float, sx: float,
                 sy: float, hf: int, wf: int) -> torch.Tensor:
    """(k, 2) anchor sizes and the conv field-center arithmetic → the
    (k, Hf, Wf, 4) xcycwh anchor grid (reference MakeAnchors.py:14-30)."""
    k = anchor_wh.shape[0]
    dev = anchor_wh.device
    xs = x0 + sx * torch.arange(wf, dtype=torch.float32, device=dev)
    ys = y0 + sy * torch.arange(hf, dtype=torch.float32, device=dev)
    return torch.stack([xs[None, None, :].expand(k, hf, wf),
                        ys[None, :, None].expand(k, hf, wf),
                        anchor_wh[:, 0, None, None].expand(k, hf, wf),
                        anchor_wh[:, 1, None, None].expand(k, hf, wf)],
                       dim=-1)


def apply_box_transform(anchors: torch.Tensor, trans: torch.Tensor,
                        max_log_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """(tx, ty, tw, th) deltas → boxes: x = xa + tx·wa, w = wa·exp(tw)
    (reference ApplyBoxTransform.py:42-46), tw and th clamped to
    ±`max_log_scale` before the exp when it is given (the JAX package's
    stability clamp at the reference's own garbage threshold)."""
    xa, ya, wa, ha = anchors.unbind(-1)
    tx, ty, tw, th = trans.unbind(-1)
    if max_log_scale is not None:
        tw = tw.clamp(-max_log_scale, max_log_scale)
        th = th.clamp(-max_log_scale, max_log_scale)
    return torch.stack([xa + tx * wa, ya + ty * ha, wa * torch.exp(tw),
                        ha * torch.exp(th)], dim=-1)


def make_boxes(trans_maps: torch.Tensor, anchor_wh: torch.Tensor,
               x0: float, y0: float, sx: float, sy: float):
    """Anchors and deltas fused into proposal boxes, the legacy
    `MakeBoxes` module (reference `MakeBoxes.py:26-66`; the live path
    composes `make_anchors` and `apply_box_transform`, which this is).
    trans_maps (N, 4k, H, W), anchor_wh (k, 2) → (boxes, anchors), each
    (N, k·H·W, 4) xcycwh."""
    n, c4k, hf, wf = trans_maps.shape
    k = c4k // 4
    t = trans_maps.reshape(n, k, 4, hf, wf)
    anchors = make_anchors(anchor_wh, x0, y0, sx, sy, hf, wf)   # (k,H,W,4)
    anchors = anchors[None].expand(n, k, hf, wf, 4)
    boxes = apply_box_transform(anchors, t.movedim(2, -1))
    return (boxes.reshape(n, k * hf * wf, 4),
            anchors.reshape(n, k * hf * wf, 4))


def invert_box_transform(anchors: torch.Tensor,
                         boxes: torch.Tensor) -> torch.Tensor:
    """Regression targets: the deltas that map anchors onto boxes
    (reference InvertBoxTransform.py:20-25), widths held at ≥ 1e-8."""
    xa, ya, wa, ha = anchors.unbind(-1)
    xb, yb, wb, hb = boxes.unbind(-1)
    eps = 1e-8
    wa, ha = wa.clamp_min(eps), ha.clamp_min(eps)
    return torch.stack([(xb - xa) / wa, (yb - ya) / ha,
                        torch.log(wb.clamp_min(eps) / wa),
                        torch.log(hb.clamp_min(eps) / ha)], dim=-1)


def field_centers(num_pools: int):
    """Receptive-field centers of a VGG-like trunk: a 3×3 pad-1 conv keeps
    (x0, sx); each 2×2 max-pool does x0 += sx/2, sx *= 2 (reference
    net_utils.compute_field_centers:58-82) → (x0, y0, sx, sy)."""
    x0 = y0 = 1.0
    sx = sy = 1.0
    for _ in range(num_pools):
        x0, y0 = x0 + sx / 2, y0 + sy / 2
        sx, sy = sx * 2, sy * 2
    return x0, y0, sx, sy


def merge_boxes_host(boxes, iou_thresh: float = 0.7):
    """Greedy IoU clustering of the eval protocol (reference
    box_utils.merge_boxes:188-204), on the host: (N, 4) xcycwh → (the
    clusters' mean boxes (M, 4) fp64, each box's cluster (N,) int64). The
    IoU is fp32, as the JAX package computes it."""
    boxes = np.asarray(boxes, dtype=np.float64)
    n = boxes.shape[0]
    assignment = -np.ones(n, dtype=np.int64)
    centers = []
    b32 = torch.from_numpy(boxes.astype(np.float32))
    iou = box_iou(b32, b32).numpy()
    for i in range(n):
        if assignment[i] >= 0:
            continue
        members = [j for j in range(n)
                   if assignment[j] < 0 and iou[i, j] >= iou_thresh]
        cid = len(centers)
        for j in members:
            assignment[j] = cid
        centers.append(boxes[members].mean(axis=0))
    return np.stack(centers), assignment
