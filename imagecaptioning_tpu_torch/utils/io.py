"""JSON histories in the reference's log schema and the reference's
small option and loss helpers — port of `imagecaptioning_tpu/utils/io.py`.

- loss history: a list of {"iter", "loss", "epoch time in ms"} records;
- results history: a list of eval dicts, each carrying "iter",
  "best_val_score" and "best_iter" (`AlexCap/my_utils.py:10-18`,
  `train_LSTM.py:89-94,131-133`);
- `getopt`, `dict_average`, `average_values`, `build_loss_string`
  (`my_utils.getopt`, DenseCap's `densecap_utils`).

In a run of several processes only rank 0 writes the histories
(`parallel.mesh.is_writer`); elsewhere `flush` is a no-op.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from imagecaptioning_tpu_torch.parallel import mesh


def getopt(opt, key: str, default=None):
    """Dict-or-attribute option lookup (reference my_utils.getopt); a
    None value reads as `default`."""
    if opt is None:
        return default
    if hasattr(opt, "get"):
        v = opt.get(key, default)
        return default if v is None else v
    return getattr(opt, key, default)


def write_json(path: str, data: Any) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def read_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def dict_average(dicts) -> Dict[str, float]:
    """Mean of each key over a list of numeric dicts, values that are not
    numbers skipped (reference `densecap_utils.dict_average`)."""
    sums: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for d in dicts:
        for k, v in d.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            sums[k] = sums.get(k, 0.0) + v
            counts[k] = counts.get(k, 0) + 1
    return {k: sums[k] / counts[k] for k in sums}


def average_values(d: Dict) -> float:
    """Mean of a dict's values, 0 for none (reference
    `densecap_utils.average_values`)."""
    vals = list(d.values())
    return sum(vals) / len(vals) if vals else 0.0


def build_loss_string(losses: Dict) -> str:
    """'k1: v1, k2: v2, ..., total_loss: t', the per-iteration log line
    (reference `densecap_utils.build_loss_string`)."""
    parts = [f"{k}: {float(v):.5f}" for k, v in losses.items()
             if k != "total"]
    if "total" in losses:
        parts.append(f"total_loss: {float(losses['total']):.5f}")
    return ", ".join(parts)


class LossHistory:
    """Accumulates per-iteration loss records and flushes them to the
    loss file in the reference schema."""

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        self.records: List[Dict] = []
        if resume and os.path.exists(path):
            self.records = read_json(path)

    def append(self, it: int, loss: float, step_ms: float) -> None:
        self.records.append({"iter": it, "loss": float(loss),
                             "epoch time in ms": float(step_ms)})

    def flush(self) -> None:
        if mesh.is_writer():
            write_json(self.path, self.records)


class ResultsHistory:
    """Eval-results history with best-score tracking (the reference keeps
    best_val_score/best_iter in the last record, train_LSTM.py:131-133)."""

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        self.records: List[Dict] = []
        self.best_score: Optional[float] = None
        self.best_iter: int = 0
        if resume and os.path.exists(path):
            self.records = read_json(path)
            if self.records:
                last = self.records[-1]
                self.best_score = last.get("best_val_score")
                self.best_iter = last.get("best_iter", 0)

    def append(self, it: int, results: Dict,
               score_key=("ap_results", "meteor")) -> bool:
        """Returns True iff this eval is a new best. `score_key` selects
        the model-selection metric (mAP for the dense drivers,
        traingt.py:103)."""
        score = results
        for k in score_key:
            score = score.get(k, {}) if isinstance(score, dict) else 0.0
        score = score if isinstance(score, (int, float)) else 0.0
        is_best = self.best_score is None or score > self.best_score
        if is_best:
            self.best_score = score
            self.best_iter = it
        rec = dict(results)
        rec.update({"iter": it, "best_val_score": self.best_score,
                    "best_iter": self.best_iter})
        self.records.append(rec)
        return is_best

    def flush(self) -> None:
        if mesh.is_writer():
            write_json(self.path, self.records)
