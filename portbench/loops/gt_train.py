"""Closed-loop training of the ground-truth-box captioner with its LSTM
head, as the program's `train_gt` runs its steps: each step takes a host
batch of the pool, hands it to `dense_driver.to_device` and the step of
`make_gt_train_step` (teacher forcing, the classifier's dropout drawn by
the benchmark's generator from the seed), and every `loss_every` steps
reads the loss on the host. The trainer's settings (`train` in the
traffic file: fp32 master weights, Adam's, the step at which the trunk
starts to learn) are laid over the configuration's own.

Set-up builds one model, optimizer and step, drives them through the
traffic's `checked_steps` first steps on distinct batches and keeps what
the check reads (each step's loss, the first gradient from Adam's first
moment, each leaf's change after the last checked step), then warms up
to `warmup` steps. The window and the traced stretch continue the same
object. Once the program's state is freed, the reference
(`reference/gt_lstm_train.py`) follows the checked steps from the same
weights, batches and dropout masks.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

import torch

from portbench import compare, gt_train_flops, program, roi_bounds, traffic
from portbench.loops import rpn_train
from portbench.reference import gt_lstm_train
from portbench.reference.layers import EXACT, FP8, VGG16, exact_float32
from portbench.weights import DTYPES, subseed

# the LSTM's word-score weight: its first gradient sums every caption
# position's hidden state against its error, so each position carries the
# rounding of the image's code into it and none is diluted by the word
# embeddings, which are exact on both sides; compared as
# `grad_step1_words`
WORDS = "llm.rnn.linear.weight"

class Loop(rpn_train.Loop):
    """The RPN loop's window, traced stretch, first gradient and change,
    over the GT captioner's own set-up, step and check."""

    def __init__(self, cfg: Dict, traffic_cfg: Dict, seed: int, device,
                 plant: Optional[str] = None):
        self.cfg = {**cfg, **traffic_cfg["train"]}
        self.traffic, self.seed = traffic_cfg, seed
        self.dev = torch.device(device)
        self.plant = plant
        self.ref = program.reference(cfg)
        self.n, self.r = traffic_cfg["images"], traffic_cfg["boxes"]
        self.flops_per_unit = gt_train_flops.step(self.cfg,
                                                  traffic_cfg)["total"]
        hf = traffic_cfg["image_side"] // 2 ** cfg["vgg_stages"]
        elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        # GT boxes are data: kernel B, the boxes' gradient, never runs
        self.roi_bounds = {k: v for k, v in roi_bounds.per_launch(
            "train", self.n, self.r, hf, hf,
            VGG16[cfg["vgg_stages"] - 1][-1], elem).items() if k != "B"}
        self.units_per_s = None

    # ------------------------------------------------------------ set-up
    def _dropout(self) -> torch.Generator:
        g = torch.Generator(self.dev)
        g.manual_seed(subseed(self.seed, "dropout"))
        return g

    def setup(self) -> None:
        from imagecaptioning_tpu_torch.train import dense_driver

        self.phases = {"imports": time.perf_counter()}
        dcfg = program.dense_config(self.cfg)
        self.pool = traffic.pool(self.traffic, self.cfg, self.seed)
        self.phases["pool"] = time.perf_counter()
        model = dense_driver.build_gt_model(
            dcfg, self.cfg["vocab_size"], self.cfg["seq_length"], self.dev)
        self.phases["model"] = time.perf_counter()
        w = program.seeded_weights(self.ref, self.cfg, self.seed, self.dev,
                                   served=False)
        program.weights.load_into(model, w)
        del w
        self.phases["weights"] = time.perf_counter()
        self.model = model
        self.optimizer = dense_driver.make_dense_optimizer(
            dcfg, model, self.cfg["finetune_start_step"])
        self.step = dense_driver.make_gt_train_step(
            model, self.optimizer, False, self._dropout())
        self.to_device = dense_driver.to_device
        self.i = 0
        self.phases["built"] = time.perf_counter()
        losses = [self._step()]
        self.grad1 = self._first_gradient()
        self.phases["first step"] = time.perf_counter()
        for _ in range(self.traffic["checked_steps"] - 1):
            losses.append(self._step())
        self.losses = [float(v["total"]) for v in losses]
        self.change = self._change()
        self.phases["checked steps"] = time.perf_counter()
        while self.i < self.traffic["warmup"]:
            self._step()
        program.sync(self.dev)
        self.phases["warm-up"] = time.perf_counter()

    def _step(self) -> torch.Tensor:
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        images, boxes, labels, mask = self.to_device(batch, self.dev)
        if self.plant == "half_batch":
            h = self.n // 2
            images, boxes, labels, mask = (images[:h], boxes[:h],
                                           labels[:h], mask[:h])
        # the RPN step's form, which the inherited window reads
        return {"total": self.step(images, boxes, labels, mask, 1.0)}

    # ------------------------------------------------------------ window
    # ------------------------------------------------------------- check
    def _reference(self, prec) -> Dict:
        gen = self._dropout()
        batches, masks = [], []
        dtype = DTYPES[self.cfg["compute_dtype"]]
        keep = self.cfg["classifier_keep"]
        for i in range(self.traffic["checked_steps"]):
            b = self.pool[i % len(self.pool)]
            images, boxes = (torch.from_numpy(b[k]).to(self.dev)
                             for k in ("image", "boxes"))
            labels = torch.from_numpy(b["labels"]).to(self.dev).long()
            batches.append((images, boxes, labels))
            like = torch.full((self.n, self.r, self.cfg["fc"]), keep,
                              dtype=dtype, device=self.dev)
            masks.append(torch.bernoulli(like, generator=gen).float())
        w0 = program.seeded_weights(self.ref, self.cfg, self.seed, self.dev,
                                    served=False)
        return gt_lstm_train.train(w0, self.cfg, self.cfg, batches, masks,
                                   prec)

    def _numbers(self, got: Dict, want: Dict) -> Dict[str, float]:
        n = len(want["loss"])
        out = {f"loss_step{i + 1}": compare.rel(g, w)
               for i, (g, w) in enumerate(zip(got["loss"], want["loss"]))}
        grad = compare.leaf_gaps(got["grad"], want["grad"])
        out["grad_step1"] = max(grad.values())
        out["grad_step1_median"] = statistics.median(grad.values())
        out["grad_step1_words"] = grad[WORDS]
        # leaves whose gradient is nought to rounding move by round-off
        # alone under Adam: left out of the change by the reference's own
        # gradient, under a thousandth of the median leaf's
        gmed = statistics.median(want["grad"].values())
        still = [k for k, v in want["grad"].items() if v < 1e-3 * gmed]
        change = compare.leaf_gaps(got["change"], want["change"], skip=still)
        out[f"change_step{n}"] = max(change.values())
        moved = [v for k, v in change.items() if want["change"][k] > 0]
        out[f"change_step{n}_median"] = statistics.median(moved)
        return out

    def readings(self, control: bool = False,
                 detail: bool = False) -> Dict[str, Dict]:
        """{"program": numbers} and, with `control`, {"control": the same
        numbers of the reference in fp8 put in the program's place}; with
        `detail`, each side's losses and every leaf's gaps too."""
        with exact_float32():
            want = self._reference(EXACT)
            sides = {"program": {"loss": self.losses, "grad": self.grad1,
                                 "change": self.change}}
            if control:
                sides["control"] = self._reference(FP8)
        out = {k: self._numbers(v, want) for k, v in sides.items()}
        if detail:
            out["detail"] = {"reference": {"loss": want["loss"]}, **{
                k: {"loss": v["loss"], **{
                    part: {leaf: round(g, 7) for leaf, g in
                           compare.leaf_gaps(v[part], want[part]).items()}
                    for part in ("grad", "change")}}
                for k, v in sides.items()}}
        return out

