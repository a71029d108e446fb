"""Split evaluation of the AlexCap captioners — port of
`imagecaptioning_tpu/eval/eval_split.py` (the reference's `eval_split`,
`AlexCap/eval/eval_resnet.py:43-123`): one sequential pass over a split;
per batch the eval-mode loss (when asked for) and the decoded predictions
against the decoded ground truth; then METEOR and BLEU averages, corpus
BLEU-4 and CIDEr-D.

Returns the reference's schema: {'loss_results': mean loss or None,
'ap_results': {'meteor', 'bleu', 'bleu4', 'cider', 'scorer'},
'num_images': n} and, with `return_records`, the decoded records.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from imagecaptioning_tpu_torch.eval.scorer import CaptioningEvaluator
from imagecaptioning_tpu_torch.models import api


def eval_split(model, loader, *, split: int = 1, batch_size: int = 12,
               preprocess: Optional[Callable] = None,
               use_beam: bool = False, beam_size: int = 3,
               max_images: int = -1,
               eval_loss_fn: Optional[Callable] = None,
               return_records: bool = False) -> Dict:
    """Greedy (or beam, best beam) captions of `seq_length + 1` steps for
    every full batch of `split`, on the model's device. `preprocess` maps
    the uint8 batch on that device to the model's input;
    `eval_loss_fn(images, gt)` gives a batch's loss; `max_images` > 0
    stops after the batch that reaches it."""
    dev = next(model.parameters()).device
    steps = loader.getSeqLength() + 1
    decode = (api.make_beam_fn(model, steps, beam_size) if use_beam
              else api.make_greedy_fn(model, steps))
    evaluator = CaptioningEvaluator()
    losses = []
    vocab = loader.vocab
    model.eval()
    seen = 0
    for images_u8, labels in loader.epoch_batches(split, batch_size):
        if 0 < max_images <= seen:
            break
        seen += images_u8.shape[0]
        x = torch.from_numpy(images_u8).to(dev)
        if preprocess is not None:
            x = preprocess(x)
        gt = torch.from_numpy(labels).to(dev).long()
        if eval_loss_fn is not None:
            losses.append(float(eval_loss_fn(x, gt)))
        toks = decode(x).tokens[:, 0] if use_beam else decode(x)
        preds = vocab.decode_sequence(toks.cpu().numpy())
        refs = vocab.decode_sequence(np.asarray(labels))
        evaluator.add_result(preds, [[r] for r in refs])
    out = {"loss_results": float(np.mean(losses)) if losses else None,
           "ap_results": evaluator.evaluate(), "num_images": seen}
    if return_records:
        out["records"] = evaluator.records
    return out
