"""Plain float32 reference of DenseCap with its region proposal network,
trained end to end (DenseCapModel.lua, LocalizationLayer.lua,
BoxSamplerHelper.lua of jcjohnson/densecap, with the fixed-shape sampler
of the repository's JAX model: its sampled counts are static and padded).

One training step: the VGG16 trunk without its last pool -> the RPN head
(3x3 conv to `rpn_hidden`, ReLU, 1x1 objectness and box-delta heads, per
(row, column, anchor)) -> proposals on the anchor grid -> the sampler
(positives: IoU above the high threshold or the best proposal of a GT;
negatives below the low one; a random `num_pos` and `num_neg` of them by
the given uniform keys) -> bilinear ROI pooling of the sampled proposals
(differentiable in the boxes) -> fc6/fc7 with dropout -> objectness and
box refinement of every sampled region, the language model on the
positives' GT captions -> five weighted losses -> Adam.

Nothing here comes from the measured program: the weights, the sampler's
keys and the dropout masks are drawn by the benchmark from the seed and
given to both sides.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import layers as L
from portbench.reference.layers import EXACT, Precision, Weights


# ------------------------------------------------------------- parameters

def param_layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, in the state-dict layout.
    init: "he" (uniform, +-sqrt(6/fan_in): the trunk, fc6/fc7 and the
    region code's encoding, so that the activations keep their scale
    through the ReLUs and the captions follow the regions), "default"
    (uniform, +-1/sqrt(fan_in)) or "zero" (the RPN's box deltas and the
    box refinement, as DenseCap initialises them)."""
    out = []
    cin = 3
    for n, ch in zip(L.vgg_conv_names(cfg["vgg_stages"]),
                     [c for s in L.VGG16[:cfg["vgg_stages"]] for c in s]):
        out += [(f"conv_trunk.{n}.weight", (ch, cin, 3, 3), "he"),
                (f"conv_trunk.{n}.bias", (ch,), "he")]
        cin = ch
    k, hid = len(cfg["anchors_wh"]), cfg["rpn_hidden"]
    roi = cfg["roi_size"][0] * cfg["roi_size"][1]
    v3, e, h = cfg["vocab_size"] + 3, cfg["input_encoding_size"], \
        cfg["rnn_size"]
    out += [("rpn_conv.weight", (hid, cin, 3, 3), "he"),
            ("rpn_conv.bias", (hid,), "he"),
            ("rpn_scores.weight", (k, hid, 1, 1), "default"),
            ("rpn_scores.bias", (k,), "default"),
            ("rpn_trans.weight", (4 * k, hid, 1, 1), "zero"),
            ("rpn_trans.bias", (4 * k,), "zero"),
            ("recog_base.0.weight", (cfg["fc"], cin * roi), "he"),
            ("recog_base.0.bias", (cfg["fc"],), "he"),
            ("recog_base.3.weight", (cfg["fc"], cfg["fc"]), "he"),
            ("recog_base.3.bias", (cfg["fc"],), "he"),
            ("objectness.weight", (1, cfg["fc"]), "default"),
            ("objectness.bias", (1,), "default"),
            ("box_reg.weight", (4, cfg["fc"]), "zero"),
            ("box_reg.bias", (4,), "zero"),
            ("llm.image_encoder.encode.weight", (e, cfg["fc"]), "he"),
            ("llm.image_encoder.encode.bias", (e,), "default"),
            ("llm.lookup_table.weight", (v3, e), "default"),
            ("llm.lstm.weight_ih_l0", (4 * h, e), "default"),
            ("llm.lstm.weight_hh_l0", (4 * h, h), "default"),
            ("llm.lstm.bias_ih_l0", (4 * h,), "default"),
            ("llm.lstm.bias_hh_l0", (4 * h,), "default"),
            ("llm.rnn.linear.weight", (v3, h), "default"),
            ("llm.rnn.linear.bias", (v3,), "default")]
    return out


def narrow_params(cfg: Dict) -> Tuple[str, ...]:
    """Prefixes of the parameters the configuration computes in its
    narrow compute type (the trunk, the RPN conv, fc6/fc7)."""
    return ("conv_trunk.", "rpn_conv.", "recog_base.")


def groups(cfg: Dict, names: Sequence[str]) -> Dict[str, str]:
    """name -> "frozen" (the trunk below `frozen_below` in torchvision's
    indexing), "encoder" (the rest of the trunk: lr 0 until
    `finetune_start_step` updates) or "head"."""
    out = {}
    for n in names:
        top, idx = n.split(".")[:2]
        if top == "conv_trunk":
            out[n] = ("encoder" if int(idx) >= cfg["frozen_below"]
                      else "frozen")
        else:
            out[n] = "head"
    return out


# ------------------------------------------------------------- geometry

def corners(b: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = b.unbind(-1)
    return torch.stack([xc - (w - 1) / 2, yc - (h - 1) / 2,
                        xc + (w - 1) / 2, yc + (h - 1) / 2], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xcycwh (..., A, 4) x (..., M, 4) -> (..., A, M)."""
    a, b = corners(a), corners(b)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def anchors(cfg: Dict, hf: int, wf: int, device) -> torch.Tensor:
    """(Hf*Wf*k, 4) xcycwh anchors in (row, column, anchor) order, centred
    on the receptive fields of the trunk's output: x0 = 1, stride 1,
    and each of the trunk's vgg_stages - 1 pools adds half the stride and
    doubles it (4 pools, stride 16, at the published 5 stages)."""
    x0, s = 1.0, 1.0
    for _ in range(cfg["vgg_stages"] - 1):
        x0, s = x0 + s / 2, s * 2
    wh = torch.tensor(cfg["anchors_wh"], dtype=torch.float32, device=device)
    k = wh.shape[0]
    xs = x0 + s * torch.arange(wf, dtype=torch.float32, device=device)
    ys = x0 + s * torch.arange(hf, dtype=torch.float32, device=device)
    grid = torch.stack([xs[None, :, None].expand(hf, wf, k),
                        ys[:, None, None].expand(hf, wf, k),
                        wh[None, None, :, 0].expand(hf, wf, k),
                        wh[None, None, :, 1].expand(hf, wf, k)], -1)
    return grid.reshape(-1, 4)


def apply_deltas(a: torch.Tensor, d: torch.Tensor, clamp: float):
    xa, ya, wa, ha = a.unbind(-1)
    tx, ty, tw, th = d.unbind(-1)
    tw, th = tw.clamp(-clamp, clamp), th.clamp(-clamp, clamp)
    return torch.stack([xa + tx * wa, ya + ty * ha, wa * torch.exp(tw),
                        ha * torch.exp(th)], -1)


def deltas_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The deltas that move boxes a onto boxes b (sizes held at >= 1e-8)."""
    xa, ya, wa, ha = a.unbind(-1)
    xb, yb, wb, hb = b.unbind(-1)
    wa, ha = wa.clamp_min(1e-8), ha.clamp_min(1e-8)
    return torch.stack([(xb - xa) / wa, (yb - ya) / ha,
                        torch.log(wb.clamp_min(1e-8) / wa),
                        torch.log(hb.clamp_min(1e-8) / ha)], -1)


def inside(b: torch.Tensor, ih: float, iw: float) -> torch.Tensor:
    """Whether a box keeps a positive area once clipped to the image."""
    c = corners(b)
    x1, x2 = c[..., 0].clamp(1, iw), c[..., 2].clamp(1, iw)
    y1, y2 = c[..., 1].clamp(1, ih), c[..., 3].clamp(1, ih)
    return (x2 > x1) & (y2 > y1)


# ---------------------------------------------------------------- sampler

def _pick(keys: np.ndarray, cand: np.ndarray, k: int):
    """The k candidates with the largest keys (ties to the lower index),
    cycled when fewer than k exist -> (indices, count)."""
    idx = np.flatnonzero(cand)
    if idx.size == 0:
        return np.zeros(k, np.int64), 0
    order = idx[np.lexsort((idx, -keys[idx]))]
    return order[np.arange(k) % idx.size], idx.size


def sample(proposals: torch.Tensor, gt: torch.Tensor, gt_mask: torch.Tensor,
           keys: Tuple[torch.Tensor, torch.Tensor], num_pos: int,
           num_neg: int, hi: float, lo: float, ih: float, iw: float):
    """Each image's positives (IoU > hi, or a GT's best proposal, in the
    image or not) and negatives (max IoU < lo; every proposal where none
    is), proposals that vanish once clipped left out, ranked by the keys
    -> (pos_idx, pos_valid, pos_gt, neg_idx, neg_valid), each (N, k).
    A positive slot past the candidates repeats one and is not valid; a
    negative one repeats and is."""
    ov = iou(proposals, gt)                                  # (N, A, M)
    real = gt_mask > 0
    ov = torch.where(real[:, None, :], ov, torch.full_like(ov, -1.0))
    ok = inside(proposals, ih, iw)
    ov, ok = ov.cpu().numpy(), ok.cpu().numpy()
    real = real.cpu().numpy()
    pk, nk = keys[0].cpu().numpy(), keys[1].cpu().numpy()
    out = [[] for _ in range(5)]
    for i in range(ov.shape[0]):
        best = ov[i].max(1)
        best_gt = ov[i].argmax(1)
        pos = (best > hi) & ok[i]
        neg = (best < lo) & ok[i]
        for m in np.flatnonzero(real[i]):
            pos[np.argmax(ov[i][:, m])] = True
        neg &= ~pos
        if not neg.any():
            neg[:] = True
        p_idx, p_n = _pick(pk[i], pos, num_pos)
        n_idx, n_n = _pick(nk[i], neg, num_neg)
        for lst, v in zip(out, (p_idx, np.arange(num_pos) < p_n,
                                best_gt[p_idx], n_idx,
                                np.full(num_neg, n_n > 0))):
            lst.append(v)
    dev = proposals.device
    return tuple(torch.from_numpy(np.stack(v)).to(dev) for v in out)


# ----------------------------------------------------------------- losses

def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1, 0.5 * ax * ax, ax - 0.5)


def box_loss(pred, target, valid) -> torch.Tensor:
    """Per image: smooth-L1 over the valid rows, rows whose target has a
    component above 10 in magnitude zeroed but counted."""
    sane = (target.abs() <= 10).all(-1) & valid
    per = smooth_l1(pred - target).mean(-1)
    return (per * sane).sum(-1) / valid.sum(-1).clamp_min(1)


def objectness_loss(pos_s, neg_s, pos_v, neg_v) -> torch.Tensor:
    """Per image: the logistic loss of positives (target 1) and negatives
    (target 0), mean over the valid slots."""
    signed = torch.cat([-pos_s, neg_s], 1)
    w = torch.cat([pos_v, neg_v], 1).float()
    soft = torch.logaddexp(signed, torch.zeros_like(signed))
    return (soft * w).sum(1) / w.sum(1).clamp_min(1)


def caption_targets(labels: torch.Tensor, end: int) -> torch.Tensor:
    """labels (B, T) -> (B, T+1): the caption with END at its first empty
    position after the first word."""
    b, t = labels.shape
    padded = torch.cat([labels, labels.new_zeros(b, 1)], 1)
    empty = (padded == 0) & (torch.arange(t + 1, device=labels.device) >= 1)
    first = empty.int().argmax(1, keepdim=True)
    return padded.scatter(1, first, end)


def caption_loss(logits, targets) -> torch.Tensor:
    logp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), -1)
    t = targets.reshape(-1)
    nll = -logp.gather(1, t[:, None])[:, 0]
    m = (t != 0).float()
    return (nll * m).sum() / m.sum().clamp_min(1)


def losses(w: Weights, cfg: Dict, images_u8, gt, gt_mask, labels,
           keys, dropout_mask, prec: Precision = EXACT) -> Dict:
    """The five weighted losses of one batch and their sum `total`."""
    n, ih, iw = images_u8.shape[0], float(images_u8.shape[1]), \
        float(images_u8.shape[2])
    feats = L.vgg16_trunk(L.normalize(images_u8), w, "conv_trunk",
                          cfg["vgg_stages"], False, prec)
    x = L.narrow(F.relu(F.conv2d(feats, L.narrow(w["rpn_conv.weight"], prec),
                                 w["rpn_conv.bias"], padding=1)), prec)
    x = x.permute(0, 2, 3, 1)                               # (N, Hf, Wf, D)
    hf, wf = x.shape[1:3]
    scores = (x @ w["rpn_scores.weight"].flatten(1).T
              + w["rpn_scores.bias"]).reshape(n, -1)
    deltas = (x @ w["rpn_trans.weight"].flatten(1).T
              + w["rpn_trans.bias"]).reshape(n, -1, 4)
    anc = anchors(cfg, hf, wf, x.device)
    props = apply_deltas(anc, deltas, cfg["box_transform_clamp"])
    half = cfg["sampler_batch_size"] // 2
    pos_i, pos_v, pos_gt, neg_i, neg_v = sample(
        props.detach(), gt, gt_mask, keys, half, half,
        cfg["sampler_high_thresh"], cfg["sampler_low_thresh"], ih, iw)

    def rows(t, idx):
        return t.gather(1, idx.reshape(*idx.shape, *[1] * (t.dim() - 2))
                        .expand(*idx.shape, *t.shape[2:]))
    boxes = rows(props, torch.cat([pos_i, neg_i], 1))
    targets = rows(gt, pos_gt)
    mid_obj = objectness_loss(scores.gather(1, pos_i),
                              scores.gather(1, neg_i), pos_v, neg_v)
    mid_reg = box_loss(rows(deltas, pos_i),
                       deltas_between(anc[pos_i], targets), pos_v)
    pooled = L.roi_pool(feats, boxes, (ih, iw), tuple(cfg["roi_size"]))
    codes = L.classifier(pooled, w, "recog_base", dropout_mask,
                         cfg["classifier_keep"], prec)
    end_s = (codes @ w["objectness.weight"].T + w["objectness.bias"])[..., 0]
    end_obj = objectness_loss(end_s[:, :half], end_s[:, half:], pos_v, neg_v)
    pos_codes = codes[:, :half]
    end_reg = box_loss(pos_codes @ w["box_reg.weight"].T + w["box_reg.bias"],
                       deltas_between(boxes[:, :half], targets), pos_v)
    caps = rows(labels, pos_gt)
    t = caps.shape[-1]
    caps = torch.where(pos_v.reshape(n, half, 1), caps, 0).reshape(-1, t)
    v = cfg["vocab_size"]
    start = torch.full((caps.shape[0], 1), v + 1, dtype=caps.dtype,
                       device=caps.device)
    logits = L.caption_logits(pos_codes.reshape(-1, pos_codes.shape[-1]),
                              torch.cat([start, caps], 1), w)
    tgt = torch.where(pos_v.reshape(-1, 1), caption_targets(caps, v + 2), 0)
    terms = {"mid_objectness": mid_obj.mean(), "mid_box_reg": mid_reg.mean(),
             "end_objectness": end_obj.mean(), "end_box_reg": end_reg.mean(),
             "captioning": caption_loss(logits, tgt)}
    out = {k: cfg[f"{k}_weight"] * val for k, val in terms.items()}
    out["total"] = sum(out.values())
    return out


# ----------------------------------------------------------------- steps

def train(w0: Weights, cfg: Dict, batches: Sequence, keys: Sequence,
          masks: Sequence, prec: Precision = EXACT) -> Dict:
    """Steps from the weights `w0` (float32, not modified) over
    `batches[i]` = (images u8, gt boxes, gt mask, labels) with the
    sampler's `keys[i]` and the classifier's dropout `masks[i]` ->
    {"loss": [total per step], "terms": [{term: weighted loss} per step],
    "grad": {leaf: norm of the first step's
    gradient as Adam took it}, "change": {leaf: norm of the weights'
    change over all the steps}}."""
    kind = groups(cfg, w0)
    params = {k: v.detach().clone() for k, v in w0.items()}
    train_keys = [k for k in params if kind[k] != "frozen"]
    for k in train_keys:
        params[k].requires_grad_(True)
    lr = {k: (cfg["learning_rate"]) for k in train_keys}
    start = {k: (cfg["finetune_start_step"] if kind[k] == "encoder" else 0)
             for k in train_keys}
    opt = L.Adam({k: params[k] for k in train_keys}, lr, start,
                 (cfg["optim_beta1"], cfg["optim_beta2"]),
                 cfg["optim_epsilon"], cfg["weight_decay"])
    out = {"loss": [], "terms": [], "grad": None}
    for batch, key, mask in zip(batches, keys, masks):
        terms = losses(params, cfg, *batch, key, mask, prec)
        total = terms["total"]
        grads = torch.autograd.grad(total, [params[k] for k in train_keys])
        taken = opt.step(dict(zip(train_keys, grads)))
        out["loss"].append(float(total.detach()))
        out["terms"].append({k: float(v.detach()) for k, v in terms.items()
                             if k != "total"})
        if out["grad"] is None:
            out["grad"] = L.norms(taken)
        del terms, total, grads, taken
    out["change"] = L.norms({k: params[k].detach() - w0[k]
                           for k in train_keys})
    return out

