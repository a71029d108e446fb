"""Plain float32 reference of a training step of the ground-truth-box
captioner with its LSTM head (`gt_lstm`'s model): the captioning loss over
every region of the batch (DenseCap's language model teacher-forced from
START, END after the caption, the mean cross-entropy over the non-NULL
targets), the classifier's dropout from the masks given, autograd, and
Adam over the trained leaves: the trunk's first four convolutions
frozen, the rest of the trunk at lr 0 until `finetune_start_step`
applied updates, every other leaf at `learning_rate`. Nothing here comes
from the measured program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from portbench.reference import layers as L
from portbench.reference.densecap_rpn import caption_loss, caption_targets
from portbench.reference.layers import EXACT, Precision, Weights

# the trunk's first layers (conv1_* and conv2_*, torchvision indexes
# 0-9) are frozen, as DenseCap's fine-tuning keeps them
FROZEN_BELOW = 10


def groups(names: Sequence[str]) -> Dict[str, str]:
    """Each leaf's group: "frozen", "encoder" (the rest of the trunk) or
    "head"."""
    out = {}
    for n in names:
        top, idx = n.split(".")[:2]
        if top == "features":
            out[n] = "encoder" if int(idx) >= FROZEN_BELOW else "frozen"
        else:
            out[n] = "head"
    return out


def loss(w: Weights, cfg: Dict, images_u8, boxes, labels, dropout_mask,
         keep: float, prec: Precision = EXACT) -> torch.Tensor:
    """The captioning loss of one batch: images (N, H, W, 3) uint8, boxes
    (N, R, 4), labels (N, R, T), dropout mask (N, R, fc)."""
    ih, iw = float(images_u8.shape[1]), float(images_u8.shape[2])
    feats = L.vgg16_trunk(L.normalize(images_u8), w, "features",
                          cfg["vgg_stages"], True, prec)
    pooled = L.roi_pool(feats, boxes, (ih, iw), tuple(cfg["roi_size"]))
    codes = L.classifier(pooled, w, "classifier", dropout_mask, keep, prec)
    caps = labels.reshape(-1, labels.shape[-1])
    v = cfg["vocab_size"]
    start = torch.full((caps.shape[0], 1), v + 1, dtype=caps.dtype,
                       device=caps.device)
    logits = L.caption_logits(codes.reshape(-1, codes.shape[-1]),
                              torch.cat([start, caps], 1), w)
    return caption_loss(logits, caption_targets(caps, v + 2))


def train(w0: Weights, cfg: Dict, opt_cfg: Dict, batches: Sequence,
          masks: Sequence, prec: Precision = EXACT) -> Dict:
    """Steps from the weights `w0` (float32, not modified) over
    `batches[i]` = (images u8, boxes, labels) with the classifier's
    dropout `masks[i]` -> {"loss": [per step], "grad": {leaf: norm of the
    first step's gradient as Adam took it}, "change": {leaf: norm of the
    weights' change over all the steps}}. `opt_cfg` holds the trainer's
    settings (learning_rate, optim_beta1/2, optim_epsilon, weight_decay,
    finetune_start_step)."""
    kind = groups(list(w0))
    params = {k: v.detach().clone() for k, v in w0.items()}
    train_keys = [k for k in params if kind[k] != "frozen"]
    for k in train_keys:
        params[k].requires_grad_(True)
    lr = {k: opt_cfg["learning_rate"] for k in train_keys}
    start = {k: (opt_cfg["finetune_start_step"] if kind[k] == "encoder"
                 else 0) for k in train_keys}
    opt = L.Adam({k: params[k] for k in train_keys}, lr, start,
                 (opt_cfg["optim_beta1"], opt_cfg["optim_beta2"]),
                 opt_cfg["optim_epsilon"], opt_cfg["weight_decay"])
    out = {"loss": [], "grad": None}
    for batch, mask in zip(batches, masks):
        total = loss(params, cfg, *batch, mask, opt_cfg["classifier_keep"],
                     prec)
        grads = torch.autograd.grad(total, [params[k] for k in train_keys])
        taken = opt.step(dict(zip(train_keys, grads)))
        out["loss"].append(float(total.detach()))
        if out["grad"] is None:
            out["grad"] = L.norms(taken)
        del total, grads, taken
    out["change"] = L.norms({k: params[k].detach() - w0[k]
                             for k in train_keys})
    return out
