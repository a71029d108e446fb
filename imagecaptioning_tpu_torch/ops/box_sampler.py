"""Fixed-shape positive/negative box sampling for RPN training — port of
`imagecaptioning_tpu/ops/box_sampler.py:32-112`.

Reference semantics (`DenseCap/densecap/BoxSampler.py`): IoU of the
proposals against the GT boxes; positives are IoU > 0.7 together with the
argmax proposal of each GT, negatives max-IoU < 0.3, out-of-bounds
proposals excluded; up to `num_pos` positives, and negatives fill their
`num_neg` slots with replacement when short. The JAX package makes the
counts static with a masked, padded top-k over random keys, and so does
this port, with every quirk kept (see `candidate_masks` and
`masked_random_topk`).

Everything works per image over a leading batch axis: proposals
(N, A, 4), GT boxes (N, M, 4) and mask (N, M), keys (N, A). The keys are
uniform draws the caller makes (`torch.rand` from the trainer's
generator); the JAX package draws them inside with `jax.random.uniform`,
and the parity tests pass those in.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from imagecaptioning_tpu_torch.ops.boxes import box_iou


class SampleResult(NamedTuple):
    pos_idx: torch.Tensor         # (N, num_pos) indices into the proposals
    pos_mask: torch.Tensor        # (N, num_pos) bool: a real positive?
    pos_target_idx: torch.Tensor  # (N, num_pos) the matched GT's index
    neg_idx: torch.Tensor         # (N, num_neg)
    neg_mask: torch.Tensor        # (N, num_neg)


def masked_random_topk(keys: torch.Tensor, mask: torch.Tensor, k: int,
                       count_replacement: bool):
    """The k True positions of `mask` (..., A) with the largest `keys`,
    padded by cycling the valid picks when fewer than k exist → (indices
    (..., k), valid (..., k)). Padding slots are valid only with
    `count_replacement` (the reference counts replacement-sampled
    negatives in its losses, and never duplicates positives), and no slot
    is valid when nothing is True.

    The keys are ranked by a stable descending sort, so equal keys go to
    the lower index, as XLA's `top_k` gives them (`torch.topk` promises
    no order for ties, and the masked-out entries all tie at −1)."""
    keys = torch.where(mask, keys, torch.full_like(keys, -1.0))
    idx = torch.sort(keys, dim=-1, descending=True, stable=True)[1][..., :k]
    count = mask.sum(-1, keepdim=True)
    slots = torch.arange(k, device=keys.device)
    slot_ok = slots < count
    wrapped = idx.gather(-1, slots % count.clamp_min(1))
    idx = torch.where(slot_ok, idx, wrapped)
    ok = torch.ones_like(slot_ok) if count_replacement else slot_ok
    return idx, ok & (count > 0)


def candidate_masks(proposals: torch.Tensor, gt: torch.Tensor,
                    gt_mask: torch.Tensor, high_thresh: float = 0.7,
                    low_thresh: float = 0.3,
                    in_bounds: Optional[torch.Tensor] = None):
    """The deterministic stage of `BoxSampler.forward` (:20-53) →
    (pos_mask, neg_mask, argmax_gt), each (..., A):

    - pos = IoU > high ∧ in bounds, neg = max-IoU < low ∧ in bounds;
    - then the argmax proposal of each real GT is forced positive (and
      cleared from neg) even when out of bounds: the reference sets
      `pos_mask[target_idx] = 1` after its bounds zeroing (:42-44);
    - where no negative qualifies, every proposal becomes a negative
      candidate, positives included (the reference's
      `neg.mul(-pos).add(1)` on an all-zero mask, :52-53)."""
    gt_mask = gt_mask > 0
    iou = box_iou(proposals, gt)                            # (..., A, M)
    iou = torch.where(gt_mask[..., None, :], iou, torch.full_like(iou, -1.0))
    max_iou, argmax_gt = iou.max(dim=-1)
    ok = torch.ones_like(max_iou, dtype=torch.bool) if in_bounds is None \
        else in_bounds
    pos_mask = (max_iou > high_thresh) & ok
    neg_mask = (max_iou < low_thresh) & ok
    # argmax (first maximum, as jnp.argmax) over the proposals per GT;
    # padded GT rows scatter 0 into proposal 0, which max() leaves alone
    best_prop = torch.where(gt_mask, iou.argmax(dim=-2),
                            torch.zeros_like(gt_mask, dtype=torch.long))
    force = torch.zeros_like(pos_mask, dtype=torch.int32).scatter_reduce(
        -1, best_prop, gt_mask.to(torch.int32), "amax") > 0
    pos_mask = pos_mask | force
    neg_mask = neg_mask & ~pos_mask
    neg_mask = neg_mask | (neg_mask.sum(-1, keepdim=True) == 0)
    return pos_mask, neg_mask, argmax_gt


def sample_boxes(pos_keys: torch.Tensor, neg_keys: torch.Tensor,
                 proposals: torch.Tensor, gt: torch.Tensor,
                 gt_mask: torch.Tensor, num_pos: int = 128,
                 num_neg: int = 128, high_thresh: float = 0.7,
                 low_thresh: float = 0.3,
                 in_bounds: Optional[torch.Tensor] = None) -> SampleResult:
    """proposals (..., A, 4) and GT (..., M, 4) xcycwh, gt_mask (..., M)
    marking the real GT rows, uniform keys (..., A) for the positives'
    and the negatives' draws → fixed-shape samples."""
    pos_mask, neg_mask, argmax_gt = candidate_masks(
        proposals, gt, gt_mask, high_thresh, low_thresh, in_bounds)
    pos_idx, pos_ok = masked_random_topk(pos_keys, pos_mask, num_pos,
                                         count_replacement=False)
    neg_idx, neg_ok = masked_random_topk(neg_keys, neg_mask, num_neg,
                                         count_replacement=True)
    return SampleResult(pos_idx, pos_ok, argmax_gt.gather(-1, pos_idx),
                        neg_idx, neg_ok)
