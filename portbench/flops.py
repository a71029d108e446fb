"""Analytic operation counts of the DenseCap models, from the shapes
alone, whatever computes them: 2 per multiply-add of every convolution
and matrix product (pooling, ROI sampling, activations and the losses
are left out: they are not products and are small beside them).

A training step counts the forward pass and the backward of what the
optimizer updates: each trained layer's weight gradient (as many
operations as its forward) and the gradient of its input wherever a
trained layer lies below it (as many again). Frozen layers (the trunk
below `frozen_below`) count their forward only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

VGG16 = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
         (512, 512, 512))


def conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> int:
    """A k x k convolution, stride 1, 'same' padding, at h x w."""
    return 2 * h * w * cin * cout * k * k


def linear(rows: int, fin: int, fout: int) -> int:
    return 2 * rows * fin * fout


def vgg16(side: int, stages: int) -> List[Tuple[int, int]]:
    """(torchvision index, operations) of each trunk conv on one side x
    side image."""
    out, idx, s, cin = [], 0, side, 3
    for st in range(stages):
        for ch in VGG16[st]:
            out.append((idx, conv(s, s, cin, ch)))
            idx += 2
            cin = ch
        if st < len(VGG16) - 1:
            idx += 1
            s //= 2
    return out


def lstm_caption(rows: int, tokens: int, e: int, h: int, v3: int,
                 fc: int) -> int:
    """The language model over `rows` regions: the image encoding, the
    prefix step and `tokens` token steps of the LSTM, and the vocabulary
    projection of every token step."""
    step = linear(rows, e, 4 * h) + linear(rows, h, 4 * h)
    return (linear(rows, fc, e) + (tokens + 1) * step
            + linear(rows * tokens, h, v3))


def rpn_train_step(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """One training step of DenseCap with its RPN -> {"forward",
    "backward", "total"}."""
    n, side = traffic["images"], traffic["image_side"]
    stages = cfg["vgg_stages"]
    trunk = vgg16(side, stages)
    fwd = n * sum(f for _, f in trunk)
    bwd = 0
    trained = [i for i, _ in trunk if i >= cfg["frozen_below"]]
    for i, f in trunk:
        if i in trained:
            bwd += n * f                                  # weight gradient
            if i > trained[0]:
                bwd += n * f                              # input gradient
    hf = side // 2 ** min(stages, len(VGG16) - 1)
    cin = VGG16[stages - 1][-1]
    k, hid = len(cfg["anchors_wh"]), cfg["rpn_hidden"]
    head = n * (conv(hf, hf, cin, hid) + linear(hf * hf, hid, 5 * k))
    regions = n * cfg["sampler_batch_size"]
    roi = cfg["roi_size"][0] * cfg["roi_size"][1]
    pos = n * (cfg["sampler_batch_size"] // 2)
    fcs = (linear(regions, cin * roi, cfg["fc"])
           + linear(regions, cfg["fc"], cfg["fc"])
           + linear(regions, cfg["fc"], 1) + linear(pos, cfg["fc"], 4))
    lm = lstm_caption(pos, cfg["seq_length"] + 1, cfg["input_encoding_size"],
                      cfg["rnn_size"], cfg["vocab_size"] + 3, cfg["fc"])
    fwd += head + fcs + lm
    # the prefix step's hidden product takes the zero state, whose
    # gradient nothing needs
    bwd += 2 * (head + fcs + lm) - linear(pos, cfg["rnn_size"],
                                          4 * cfg["rnn_size"])
    return {"forward": fwd, "backward": bwd, "total": fwd + bwd}


def gt_greedy_call(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """One greedy call of the GT-box LSTM captioner -> {"forward",
    "total"}."""
    n, side = traffic["images"], traffic["image_side"]
    fwd = n * sum(f for _, f in vgg16(side, cfg["vgg_stages"]))
    cin = VGG16[cfg["vgg_stages"] - 1][-1]
    regions = n * traffic["boxes"]
    roi = cfg["roi_size"][0] * cfg["roi_size"][1]
    fwd += (linear(regions, cin * roi, cfg["fc"])
            + linear(regions, cfg["fc"], cfg["fc"]))
    fwd += lstm_caption(regions, traffic["decode_steps"],
                        cfg["input_encoding_size"], cfg["rnn_size"],
                        cfg["vocab_size"] + 3, cfg["fc"])
    return {"forward": fwd, "total": fwd}
