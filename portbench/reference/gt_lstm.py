"""Plain float32 reference of the ground-truth-box region captioner with
the LSTM head (DenseCap's recognition path and language model on given
boxes): the VGG16 trunk with all five pools -> bilinear 7x7 ROI pooling
of the boxes -> fc6/fc7 -> the 512-wide LSTM over a vocabulary of V+3
(NULL 0, START V+1, END V+2).

`logits` runs the language model teacher-forced over served tokens, so
that each served token can be judged against the reference's own best
token at its position. Nothing here comes from the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import layers as L
from portbench.reference.layers import EXACT, Precision, Weights


def param_layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter (see densecap_rpn's)."""
    out = []
    cin = 3
    for n, ch in zip(L.vgg_conv_names(cfg["vgg_stages"]),
                     [c for s in L.VGG16[:cfg["vgg_stages"]] for c in s]):
        out += [(f"features.{n}.weight", (ch, cin, 3, 3), "he"),
                (f"features.{n}.bias", (ch,), "he")]
        cin = ch
    roi = cfg["roi_size"][0] * cfg["roi_size"][1]
    v3, e, h = cfg["vocab_size"] + 3, cfg["input_encoding_size"], \
        cfg["rnn_size"]
    out += [("classifier.0.weight", (cfg["fc"], cin * roi), "he"),
            ("classifier.0.bias", (cfg["fc"],), "he"),
            ("classifier.3.weight", (cfg["fc"], cfg["fc"]), "he"),
            ("classifier.3.bias", (cfg["fc"],), "he"),
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
    """Prefixes of the parameters served in the narrow type."""
    return ("features.", "classifier.")


@torch.no_grad()
def logits(w: Weights, cfg: Dict, images_u8: torch.Tensor,
           boxes: torch.Tensor, tokens: torch.Tensor,
           prec: Precision = EXACT) -> torch.Tensor:
    """images (N, H, W, 3) uint8, boxes (N, R, 4) xcycwh, served tokens
    (N*R, L) -> the logits (N*R, L, V+3) at each served position, the
    language model fed START and then the served tokens before it."""
    ih, iw = float(images_u8.shape[1]), float(images_u8.shape[2])
    feats = L.vgg16_trunk(L.normalize(images_u8), w, "features",
                          cfg["vgg_stages"], True, prec)
    pooled = L.roi_pool(feats, boxes, (ih, iw), tuple(cfg["roi_size"]))
    codes = L.classifier(pooled, w, "classifier", prec=prec)
    codes = codes.reshape(-1, codes.shape[-1])
    start = torch.full((tokens.shape[0], 1), cfg["vocab_size"] + 1,
                       dtype=torch.long, device=tokens.device)
    fed = torch.cat([start, tokens[:, :-1].long()], 1)
    return L.caption_logits(codes, fed, w)
