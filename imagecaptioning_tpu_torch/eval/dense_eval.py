"""GT-box dense-captioning evaluation — port of the GT half of
`imagecaptioning_tpu/eval/dense_eval.py` (:46-160, 253-381): host-side
numpy, plus the eval loop over the port's region greedy decode.

- `merge_boxes` / `pluck_boxes`: greedy IoU≥0.7 clustering of the boxes
  and per-cluster mean box + reference-text pluck
  (`DenseCap/densecap/box_utils.py:188-204`, `eval/eval_utils.py:11-30`).
- `GTDenseCaptioningEvaluator`: the AlexGTModel protocol
  (`AlexGTModel/eval/eval_gt.py:113-168`): merges the GT boxes, matches
  prediction i (region order) by IoU argmax with a one-use flag, AP over
  min_score only (101-point interpolated), plus mean METEOR.
- `eval_split_gt`: the `eval_gt.eval_split` loop (`eval_gt.py:170-236`):
  per batch, the eval-mode loss and greedy captions of every region; per
  image, `addResult(gt_boxes, captions, gt_captions)`. (The JAX loop's
  beam, image-budget and records options have no caller here.)

METEOR uses NLTK's word_tokenize when its data is available, else
whitespace tokens (`eval_utils.py:245-257`); `nltk` is imported only
when scoring.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from imagecaptioning_tpu_torch.eval.scorer import (meteor_pair,
                                                   scorer_provenance)

GT_MIN_SCORES = (0, 0.05, 0.1, 0.15, 0.2, 0.25)


def xcycwh_to_corners(boxes: np.ndarray) -> np.ndarray:
    """(xc, yc, w, h) → (x1, y1, x2, y2), the reference's ±(w−1)/2
    1-indexed pixel convention (`box_utils.py:7-38`)."""
    b = np.asarray(boxes, np.float64)
    xc, yc, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([xc - (w - 1) / 2, yc - (h - 1) / 2,
                     xc + (w - 1) / 2, yc + (h - 1) / 2], axis=-1)


def corners_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """torchvision.ops.box_iou semantics on corner boxes: (N,4)×(M,4)→(N,M)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def merge_boxes(boxes_corners: np.ndarray,
                thr: float = 0.7) -> List[np.ndarray]:
    """Greedy IoU clustering: repeatedly take the box with the most
    IoU≥thr partners, emit that cluster, zero its rows/cols."""
    if thr <= 0:
        raise ValueError(f"threshold {thr} must be positive")
    d = corners_iou(boxes_corners, boxes_corners)
    clusters = []
    while True:
        good = d >= thr
        good_sum = good.sum(axis=0)
        topix = int(np.argmax(good_sum))
        if good_sum[topix] == 0:
            break
        mergeix = np.nonzero(good[topix])[0]
        clusters.append(mergeix)
        d[mergeix, :] = 0
        d[:, mergeix] = 0
    return clusters


def pluck_boxes(clusters: Sequence[np.ndarray], boxes_corners: np.ndarray,
                text: Sequence[str]):
    """Per cluster: mean box + the member texts (`eval_utils.py:11-30`)."""
    merged = np.stack([boxes_corners[c].mean(axis=0) for c in clusters]) \
        if clusters else np.zeros((0, 4))
    merged_text = [[text[j] for j in c] if len(text) else []
                   for c in clusters]
    return merged, merged_text


def _meteor(references: Sequence[str], candidate: str) -> float:
    try:
        from nltk import word_tokenize
        refs = [word_tokenize(r) for r in references]
        cand = word_tokenize(candidate)
    except LookupError:            # punkt data unavailable offline
        refs = [r.split() for r in references]
        cand = candidate.split()
    if not refs or not cand:
        return 0.0
    try:
        return round(meteor_pair(refs, cand), 4)
    except ValueError:
        return 0.0


def score_records(records: Sequence[Dict]) -> Dict:
    """{'scores': [...], 'average_score': mean} — eval_utils.score_captions."""
    scores = [_meteor(r["references"], r["candidate"]) for r in records]
    avg = sum(scores) / len(scores) if scores else 0.0
    return {"scores": scores, "average_score": avg}


def _interpolated_ap(tp: np.ndarray, fp: np.ndarray, npos: int) -> float:
    """101-point interpolated AP (`eval_utils.py:144-157`)."""
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    with np.errstate(divide="ignore", invalid="ignore"):
        rec = tp / max(npos, 1)
        prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
    ap = 0.0
    for t in range(101):
        mask = rec >= (t / 100.0)
        ap += float(np.max(prec * mask)) if prec.size else 0.0
    return ap / 101.0


class GTDenseCaptioningEvaluator:
    """The AlexGTModel protocol (`eval_gt.py:8-168`): boxes are the GT
    boxes themselves; prediction i is the caption for GT box i."""

    def __init__(self):
        self.records: List[Dict] = []
        self.npos = 0

    def addResult(self, boxes, text, target_text):
        boxes = xcycwh_to_corners(boxes)
        clusters = merge_boxes(boxes, 0.7)
        merged_boxes, merged_text = pluck_boxes(clusters, boxes, target_text)
        nt = merged_boxes.shape[0]
        used = np.zeros(nt, np.int64)
        ov = corners_iou(merged_boxes, boxes)
        for i in range(boxes.shape[0]):
            ovmax, jmax = 0.0, 0
            for j in range(nt):
                if ov[j, i] > ovmax:
                    ovmax, jmax = float(ov[j, i]), j
            ok = 1
            if nt > 0 and used[jmax] == 0:
                used[jmax] = 1
            else:
                ok = 0
            self.records.append({
                "ok": ok,
                "candidate": text[i],
                "references": merged_text[jmax] if nt > 0 else [],
            })
        self.npos += nt

    def evaluate(self) -> Dict:
        scores = score_records(self.records)
        ap_results: Dict[str, float] = {}
        for min_score in GT_MIN_SCORES:
            tp = np.zeros(len(self.records))
            fp = np.zeros(len(self.records))
            for i, r in enumerate(self.records):
                if scores["scores"][i] > min_score and r["ok"] == 1:
                    tp[i] = 1
                else:
                    fp[i] = 1
            ap_results[f"score{min_score}"] = _interpolated_ap(tp, fp,
                                                               self.npos)
        return {
            "map": (sum(ap_results.values()) / len(ap_results)
                    if ap_results else 0.0),
            "ap_breakdown": ap_results,
            "meteor": scores["average_score"],
            "scorer": scorer_provenance(),
        }


def eval_split_gt(model, loader, *, split: int = 1, batch_size: int = 2,
                  max_regions: Optional[int] = None) -> Dict:
    """The `eval_gt.eval_split` loop over the port's `GTDenseCaptioner`
    (on its own device): per batch the eval-mode loss and one greedy
    caption per padded region; per image, the evaluator over its real
    regions.

    Returns {'loss_results': mean_loss, 'ap_results': {'map',
    'ap_breakdown', 'meteor', 'scorer'}, 'num_images': n}."""
    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
    from imagecaptioning_tpu_torch.models import api

    dev = next(model.parameters()).device
    decode = api.make_region_greedy_fn(model, loader.getSeqLength() + 1)
    evaluator = GTDenseCaptioningEvaluator()
    losses: List[float] = []
    seen = 0
    for batch in loader.padded_batches(split, batch_size, max_regions):
        images = normalize_images(torch.from_numpy(batch["image"]).to(dev))
        boxes = torch.from_numpy(batch["boxes"]).to(dev)
        labels = torch.from_numpy(batch["labels"]).to(dev).long()
        mask = torch.from_numpy(batch["box_mask"]).to(dev)
        with torch.no_grad():
            out = model(images, boxes, labels)
            losses.append(float(model.loss(out, labels, mask)))
        n, r = batch["box_mask"].shape
        toks = decode(images, boxes).cpu().numpy().reshape(n, r, -1)
        for i in range(n):
            m = batch["box_mask"][i] > 0
            evaluator.addResult(batch["boxes"][i][m],
                                loader.vocab.decode_sequence(toks[i][m]),
                                loader.vocab.decode_sequence(
                                    batch["labels"][i][m]))
            seen += 1
    return {
        "loss_results": float(np.mean(losses)) if losses else None,
        "ap_results": evaluator.evaluate(),
        "num_images": seen,
    }
