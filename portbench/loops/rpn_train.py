"""Closed-loop training of DenseCap with its RPN, as the program's
`train_rpn` runs its steps: each step takes a host batch of the pool,
hands it to `dense_driver.to_device` and the step of
`make_rpn_train_step` (the sampler's keys drawn by the benchmark from the
seed), and every `loss_every` steps reads the loss on the host.

Set-up builds one model, optimizer and step, drives them through the
traffic's `checked` first steps on distinct batches and keeps what the
check reads (each step's loss, the first gradient from Adam's first
moment, each leaf's change after the last checked step), then warms up
to `warmup` steps. The window and the traced stretch continue the same
object. Once the program's state is freed, the reference follows the
checked steps from the same weights, batches, keys and dropout masks.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from portbench import compare, flops, program, roi_bounds, trace, traffic
from portbench.reference.layers import (EXACT, FP8, VGG16, exact_float32,
                                        norms)
from portbench.weights import subseed

TERMS = ("mid_objectness", "mid_box_reg", "end_objectness", "end_box_reg",
         "captioning")


class Loop:
    kind = "train"
    # faults that a test or a calibration may plant in the timed path
    PLANTS = ("half_batch",)

    def __init__(self, cfg: Dict, traffic_cfg: Dict, seed: int, device,
                 plant: Optional[str] = None):
        self.cfg, self.traffic, self.seed = cfg, traffic_cfg, seed
        self.dev = torch.device(device)
        self.plant = plant
        self.ref = program.reference(cfg)
        self.n = traffic_cfg["images"]
        side = traffic_cfg["image_side"]
        hf = side // 2 ** min(cfg["vgg_stages"], 4)
        self.anchors = hf * hf * len(cfg["anchors_wh"])
        self.flops_per_unit = flops.rpn_train_step(cfg, traffic_cfg)["total"]
        elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        self.roi_bounds = roi_bounds.per_launch(
            "train", self.n, cfg["sampler_batch_size"], hf, hf,
            VGG16[cfg["vgg_stages"] - 1][-1], elem)
        self.units_per_s = None

    # ------------------------------------------------------------ set-up
    def _draws(self):
        """Fresh generators for the sampler's keys and the dropout masks."""
        gens = []
        for tag in ("sampler", "dropout"):
            g = torch.Generator(self.dev)
            g.manual_seed(subseed(self.seed, tag))
            gens.append(g)
        return gens

    def setup(self) -> None:
        from imagecaptioning_tpu_torch.train import dense_driver

        self.phases = {"imports": time.perf_counter()}
        dcfg = program.dense_config(self.cfg)
        self.pool = traffic.pool(self.traffic, self.cfg, self.seed)
        self.phases["pool"] = time.perf_counter()
        model = dense_driver.build_rpn_model(
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
        self.keys_gen, dropout_gen = self._draws()
        self.step = dense_driver.make_rpn_train_step(model, self.optimizer,
                                                     dropout_gen)
        self.to_device = dense_driver.to_device
        self.i = 0
        self.phases["built"] = time.perf_counter()
        steps = [self._step()]
        self.grad1 = self._first_gradient()
        self.phases["first step"] = time.perf_counter()
        for _ in range(self.traffic["checked"] - 1):
            steps.append(self._step())
        self.losses = [float(v["total"]) for v in steps]
        self.terms = [{k: float(v) for k, v in d.items() if k in TERMS}
                      for d in steps]
        self.change = self._change()
        self.phases["checked steps"] = time.perf_counter()
        while self.i < self.traffic["warmup"]:
            self._step()
        program.sync(self.dev)
        self.phases["warm-up"] = time.perf_counter()

    def _step(self) -> Dict[str, torch.Tensor]:
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        images, boxes, labels, mask = self.to_device(batch, self.dev)
        keys = torch.rand((2, self.n, self.anchors), generator=self.keys_gen,
                          device=self.dev)
        if self.plant == "half_batch":
            h = self.n // 2
            return self.step(images[:h], boxes[:h], mask[:h], labels[:h],
                             keys=(keys[0, :h], keys[1, :h]))
        return self.step(images, boxes, mask, labels, keys=(keys[0], keys[1]))

    def _trained(self):
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}

    def _first_gradient(self) -> Dict[str, float]:
        """Each trained leaf's gradient as Adam took it in step 1: its
        first moment over (1 - beta1)."""
        b1 = self.cfg["optim_beta1"]
        zero = torch.zeros((), device=self.dev)
        # a leaf Adam has not stepped has no moment: nothing reached it
        return norms({n: self.optimizer.state.get(p, {}).get(
            "exp_avg", zero) / (1 - b1)
            for n, p in self._trained().items()})

    def _change(self) -> Dict[str, float]:
        w0 = program.seeded_weights(self.ref, self.cfg, self.seed, self.dev,
                                    served=False)
        out = norms({n: p.detach() - w0[n]
                     for n, p in self._trained().items()})
        del w0
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict:
        every = self.traffic["loss_every"]
        program.sync(self.dev)
        t0 = time.perf_counter()
        steps = failed = 0
        reads = []
        while True:
            losses = self._step()
            steps += 1
            if steps % every == 0:
                if not math.isfinite(float(losses["total"])):
                    failed += every
                reads.append((steps, time.perf_counter() - t0))
            if time.perf_counter() - t0 >= seconds:
                break
        program.sync(self.dev)
        elapsed = time.perf_counter() - t0
        self.units_per_s = steps / elapsed
        return {"attempted": steps, "failed": failed, "seconds": elapsed,
                "metrics": {"train_images_per_s": steps * self.n / elapsed},
                "quarters": _quarters(reads, seconds)}

    def traced(self, units: int) -> trace.Trace:
        return trace.record(self._step, units, lambda: program.sync(self.dev))

    def release(self) -> None:
        self.model = self.optimizer = self.step = None
        program.free(self.dev)

    # ------------------------------------------------------------- check
    def _reference(self, prec) -> Dict:
        keys_gen, dropout_gen = self._draws()
        batches, keys, masks = [], [], []
        dtype = program.weights.DTYPES[self.cfg["compute_dtype"]]
        r = self.cfg["sampler_batch_size"]
        for i in range(self.traffic["checked"]):
            b = self.pool[i % len(self.pool)]
            images, boxes, mask = (torch.from_numpy(b[k]).to(self.dev)
                                   for k in ("image", "boxes", "box_mask"))
            labels = torch.from_numpy(b["labels"]).to(self.dev).long()
            batches.append((images, boxes, mask, labels))
            k = torch.rand((2, self.n, self.anchors), generator=keys_gen,
                           device=self.dev)
            keys.append((k[0], k[1]))
            keep = torch.full((self.n, r, self.cfg["fc"]),
                              self.cfg["classifier_keep"], dtype=dtype,
                              device=self.dev)
            masks.append(torch.bernoulli(keep, generator=dropout_gen).float())
        w0 = program.seeded_weights(self.ref, self.cfg, self.seed, self.dev,
                                    served=False)
        return self.ref.train(w0, self.cfg, batches, keys, masks, prec)

    def _numbers(self, got: Dict, want: Dict) -> Dict[str, float]:
        n = len(want["loss"])
        out = {f"loss_step{i + 1}": compare.rel(g, w)
               for i, (g, w) in enumerate(zip(got["loss"], want["loss"]))}
        for i in range(n):
            out[f"terms_step{i + 1}"] = max(
                compare.rel(got["terms"][i][k], want["terms"][i][k])
                for k in TERMS)
        grad = compare.leaf_gaps(got["grad"], want["grad"])
        out["grad_step1"] = max(grad.values())
        out["grad_step1_median"] = statistics.median(grad.values())
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
            sides = {"program": {"loss": self.losses, "terms": self.terms,
                                 "grad": self.grad1, "change": self.change}}
            if control:
                sides["control"] = self._reference(FP8)
        out = {k: self._numbers(v, want) for k, v in sides.items()}
        if detail:
            out["detail"] = {"reference": {"loss": want["loss"],
                                           "terms": want["terms"]}, **{
                k: {"loss": v["loss"], "terms": v["terms"], **{
                    part: {leaf: round(g, 7) for leaf, g in
                           compare.leaf_gaps(v[part], want[part]).items()}
                    for part in ("grad", "change")}}
                for k, v in sides.items()}}
        return out


def _quarters(reads, seconds):
    """Steps a second in each quarter of the window, from the loss reads
    (step count, seconds since the window opened)."""
    out, last = [], (0, 0.0)
    for q in (0.25, 0.5, 0.75, 1.0):
        inside = [r for r in reads if r[1] <= q * seconds]
        if inside and inside[-1][1] > last[1]:
            out.append((inside[-1][0] - last[0]) / (inside[-1][1] - last[1]))
            last = inside[-1]
    return out

