"""Dense-captioning evaluation — port of
`imagecaptioning_tpu/eval/dense_eval.py` (:46-381): host-side numpy,
plus the GT eval loop over the port's region greedy decode (the RPN
model's loop, `eval_split_rpn`, is in `train/dense_driver.py`).

- `merge_boxes` / `pluck_boxes`: greedy IoU≥0.7 clustering of the boxes
  and per-cluster mean box + reference-text pluck
  (`DenseCap/densecap/box_utils.py:188-204`, `eval/eval_utils.py:11-30`).
- `DenseCaptioningEvaluator`: the DenseCap protocol (`eval_utils.py:
  32-170`): predictions sorted by score, greedily matched to the merged
  GT with a one-use flag (a zero-overlap prediction still consumes
  merged-GT slot 0, the reference's quirk); METEOR per record; AP over
  min_overlap {.3..7} × min_score {−1, 0, .05..25}, 101-point
  interpolated; `map` averages the language-aware cells, `detmap` the
  min_score −1 column.
- `eval_box_recalls`: recall of the top-n proposals at IoU {.5, .7, .9}
  (`box_utils.py:162-185`, repaired: the reference's indexes a list by
  a string key).
- `GTDenseCaptioningEvaluator`: the AlexGTModel protocol
  (`AlexGTModel/eval/eval_gt.py:113-168`): merges the GT boxes, matches
  prediction i (region order) by IoU argmax with a one-use flag, AP over
  min_score only (101-point interpolated), plus mean METEOR.
- `eval_split_gt`: the `eval_gt.eval_split` loop (`eval_gt.py:170-236`):
  per batch, the eval-mode loss and the captions of every region (greedy,
  or the best beam); per image, `addResult(gt_boxes, captions,
  gt_captions)`; an image budget and the records, as the JAX loop.

METEOR (`eval/scorer.py`, the port's copy of nltk's) takes nltk's
`word_tokenize` tokens where nltk and its punkt data load, else
whitespace tokens (`eval_utils.py:245-257`), as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from imagecaptioning_tpu_torch.eval.scorer import (meteor_pair,
                                                   scorer_provenance)

MIN_OVERLAPS = (0.3, 0.4, 0.5, 0.6, 0.7)
MIN_SCORES = (-1, 0, 0.05, 0.1, 0.15, 0.2, 0.25)
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


def eval_box_recalls(boxes_xcycwh: np.ndarray, gt_xcycwh: np.ndarray,
                     ns: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Recall of the top-n proposals (sorted best first) against the GT at
    IoU {.5, .7, .9}, for each n of `ns` that the proposals reach."""
    ns = list(ns) if ns is not None else [100, 200, 300]
    ious = corners_iou(xcycwh_to_corners(boxes_xcycwh),
                       xcycwh_to_corners(gt_xcycwh))   # (P, G)
    stats: Dict[str, float] = {}
    for thresh in (0.5, 0.7, 0.9):
        hit = np.cumsum(ious > thresh, axis=0) > 0     # GT hit by the top i
        recalls = hit.sum(axis=1) / max(gt_xcycwh.shape[0], 1)
        for n in ns:
            if n <= recalls.shape[0]:
                stats[f"{thresh:.2f}_recall_at_{n}"] = float(recalls[n - 1])
    return stats


_TOKENIZER: Dict = {}


def _tokenizer():
    """nltk's `word_tokenize` where nltk and its punkt data load, else
    whitespace split (`eval_utils.py:245-257`); looked up once."""
    if not _TOKENIZER:
        fn = str.split
        try:
            from nltk import word_tokenize
            word_tokenize("a b")
            fn = word_tokenize
        except (ImportError, LookupError):
            pass
        _TOKENIZER["fn"] = fn
    return _TOKENIZER["fn"]


def _meteor(references: Sequence[str], candidate: str) -> float:
    tokenize = _tokenizer()
    refs = [tokenize(r) for r in references]
    cand = tokenize(candidate)
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


def _average_values(d: Dict[str, float]) -> float:
    return sum(d.values()) / len(d) if d else 0.0


class DenseCaptioningEvaluator:
    """The DenseCap protocol (`eval_utils.py:32-170`)."""

    def __init__(self):
        self.all_logprobs: List[np.ndarray] = []
        self.records: List[Dict] = []
        self.n = 1
        self.npos = 0

    def addResult(self, logprobs, boxes, text, target_boxes, target_text):
        """One image: predicted (logprobs (D,), boxes (D, 4) xcycwh,
        captions [D]) against its GT (target_boxes (G, 4) xcycwh,
        captions [G])."""
        logprobs = np.asarray(logprobs, np.float64).reshape(-1)
        boxes = xcycwh_to_corners(boxes)
        target_boxes = xcycwh_to_corners(target_boxes)
        if not (logprobs.shape[0] == boxes.shape[0] == len(text)
                and target_boxes.shape[0] == len(target_text)):
            raise ValueError("predictions or targets of unequal lengths")
        clusters = merge_boxes(target_boxes, 0.7)
        merged_boxes, merged_text = pluck_boxes(clusters, target_boxes,
                                                target_text)
        order = np.argsort(-logprobs, kind="stable")
        nt = merged_boxes.shape[0]
        used = np.zeros(nt, np.int64)
        ov = corners_iou(merged_boxes, boxes)     # (nt, nd)
        for ii in order:
            ovmax, jmax, j_ok = 0.0, 0, False
            for j in range(nt):
                if ov[j, ii] > ovmax:
                    ovmax, jmax, j_ok = float(ov[j, ii]), j, True
            # the reference consumes the `used` slot even at overlap 0
            ok = 1
            if nt > 0 and used[jmax] == 0:
                used[jmax] = 1
            else:
                ok = 0
            self.records.append({
                "ok": ok, "ov": ovmax, "candidate": text[ii],
                "references": merged_text[jmax] if j_ok else [],
                "imgid": self.n,
            })
        self.n += 1
        self.npos += nt
        self.all_logprobs.append(np.sort(logprobs)[::-1])

    def numAdded(self) -> int:
        return self.n - 1

    def evaluate(self) -> Dict:
        logprobs = (np.concatenate(self.all_logprobs)
                    if self.all_logprobs else np.zeros(0))
        scores = score_records(self.records)
        ix = np.argsort(-logprobs, kind="stable")
        ap_results: Dict[str, float] = {}
        det_results: Dict[str, float] = {}
        for min_overlap in MIN_OVERLAPS:
            for min_score in MIN_SCORES:
                tp = np.zeros(len(ix))
                fp = np.zeros(len(ix))
                for i, ii in enumerate(ix):
                    r = self.records[ii]
                    if (r["ov"] >= min_overlap and r["ok"] == 1
                            and scores["scores"][ii] > min_score):
                        tp[i] = 1
                    else:
                        fp[i] = 1
                ap = _interpolated_ap(tp, fp, self.npos)
                if min_score == -1:
                    det_results[f"ov{min_overlap}"] = ap
                else:
                    ap_results[f"ov{min_overlap}score{min_score}"] = ap
        return {
            "map": _average_values(ap_results),
            "ap_breakdown": ap_results,
            "detmap": _average_values(det_results),
            "det_breakdown": det_results,
            "meteor": scores["average_score"],
            "scorer": scorer_provenance(),
        }


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
                  max_regions: Optional[int] = None, max_images: int = -1,
                  use_beam: bool = False, beam_size: int = 3,
                  return_records: bool = False) -> Dict:
    """The `eval_gt.eval_split` loop over the port's `GTDenseCaptioner`
    (on its own device): per batch the eval-mode loss and one caption per
    padded region, greedy or the best of `beam_size` log-prob beams
    (`use_beam`), pulled to the host in one copy; per image, the
    evaluator over its real regions. `max_images` > 0 stops before the
    first batch once that many images are scored.

    Returns {'loss_results': mean_loss, 'ap_results': {'map',
    'ap_breakdown', 'meteor', 'scorer'}, 'num_images': n} and, with
    `return_records`, 'records': each region's caption beside its merged
    GT references."""
    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
    from imagecaptioning_tpu_torch.models import api

    dev = next(model.parameters()).device
    steps = loader.getSeqLength() + 1
    decode = (api.make_region_beam_fn(model, steps, beam_size) if use_beam
              else api.make_region_greedy_fn(model, steps))
    evaluator = GTDenseCaptioningEvaluator()
    losses: List[float] = []
    seen = 0
    for batch in loader.padded_batches(split, batch_size, max_regions):
        if 0 < max_images <= seen:
            break
        images = normalize_images(torch.from_numpy(batch["image"]).to(dev))
        boxes = torch.from_numpy(batch["boxes"]).to(dev)
        labels = torch.from_numpy(batch["labels"]).to(dev).long()
        mask = torch.from_numpy(batch["box_mask"]).to(dev)
        with torch.no_grad():
            out = model(images, boxes, labels)
            losses.append(float(model.loss(out, labels, mask)))
        res = decode(images, boxes)
        toks = res.tokens[:, 0] if use_beam else res
        n, r = batch["box_mask"].shape
        toks = toks.cpu().numpy().reshape(n, r, -1)
        for i in range(n):
            m = batch["box_mask"][i] > 0
            evaluator.addResult(batch["boxes"][i][m],
                                loader.vocab.decode_sequence(toks[i][m]),
                                loader.vocab.decode_sequence(
                                    batch["labels"][i][m]))
            seen += 1
    out = {
        "loss_results": float(np.mean(losses)) if losses else None,
        "ap_results": evaluator.evaluate(),
        "num_images": seen,
    }
    if return_records:
        out["records"] = [{"candidate": r["candidate"],
                           "references": r["references"]}
                          for r in evaluator.records]
    return out
