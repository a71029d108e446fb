"""Analytic operation counts of a training step of the ground-truth-box
captioner with its LSTM head, from the shapes alone, as
`portbench.flops` counts the RPN step: 2 per multiply-add of every
convolution and matrix product; the forward, then each trained layer's
weight gradient and the gradient of its input wherever a trained layer
lies below it. The trunk's convolutions below torchvision index 10 are
frozen and count their forward only.
"""

from __future__ import annotations

from typing import Dict

from portbench.flops import VGG16, linear, lstm_caption, vgg16
from portbench.reference.gt_lstm_train import FROZEN_BELOW


def step(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """One step over `images` x `boxes` regions -> {"forward", "backward",
    "total"}."""
    n, side = traffic["images"], traffic["image_side"]
    stages = cfg["vgg_stages"]
    trunk = vgg16(side, stages)
    fwd = n * sum(f for _, f in trunk)
    bwd = 0
    trained = [i for i, _ in trunk if i >= FROZEN_BELOW]
    for i, f in trunk:
        if i in trained:
            bwd += n * f                                  # weight gradient
            if i > trained[0]:
                bwd += n * f                              # input gradient
    regions = n * traffic["boxes"]
    cin = VGG16[stages - 1][-1]
    roi = cfg["roi_size"][0] * cfg["roi_size"][1]
    fcs = (linear(regions, cin * roi, cfg["fc"])
           + linear(regions, cfg["fc"], cfg["fc"]))
    lm = lstm_caption(regions, cfg["seq_length"] + 1,
                      cfg["input_encoding_size"], cfg["rnn_size"],
                      cfg["vocab_size"] + 3, cfg["fc"])
    fwd += fcs + lm
    # the prefix step's hidden product takes the zero state, whose
    # gradient nothing needs
    bwd += 2 * (fcs + lm) - linear(regions, cfg["rnn_size"],
                                   4 * cfg["rnn_size"])
    return {"forward": fwd, "backward": bwd, "total": fwd + bwd}
