"""Closed-loop region captioning with one caller: each request carries
`images` uint8 images of `image_side`^2 with `boxes` boxes each, taken
from host memory, copied to the card, normalised by the program's
`normalize_images`, captioned greedily by `api.make_region_greedy_fn`
over `decode_steps` steps, and ends when the tokens are on the host. A
request's latency runs from taking its host batch to its tokens on the
host.

Once the window has closed and the program's state is freed, a sample
of the finished requests drawn from the seed is run through the
reference, teacher-forced over the served tokens, and the widest gap by
which a served token's logit lies below the reference's best is the
number compared.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import compare, flops, program, roi_bounds, trace, traffic
from portbench.reference.layers import EXACT, FP8, VGG16, exact_float32
from portbench.weights import subseed



class Loop:
    kind = "serve"
    # faults that a test or a calibration may plant where tokens are made
    PLANTS = ("token", "half_batch")

    def __init__(self, cfg: Dict, traffic_cfg: Dict, seed: int, device,
                 plant: Optional[str] = None):
        self.cfg, self.traffic, self.seed = cfg, traffic_cfg, seed
        self.dev = torch.device(device)
        self.plant = plant
        self.ref = program.reference(cfg)
        self.regions = traffic_cfg["images"] * traffic_cfg["boxes"]
        self.flops_per_unit = flops.gt_greedy_call(cfg, traffic_cfg)["total"]
        hf = traffic_cfg["image_side"] // 2 ** cfg["vgg_stages"]
        elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        self.roi_bounds = roi_bounds.per_launch(
            "serve", traffic_cfg["images"], traffic_cfg["boxes"], hf, hf,
            VGG16[cfg["vgg_stages"] - 1][-1], elem)
        self.units_per_s = None
        self.served: List = []          # (pool index, host tokens) a request
        self.finished = 0               # requests of the window

    def setup(self) -> None:
        from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
        from imagecaptioning_tpu_torch.models import api
        from imagecaptioning_tpu_torch.train import dense_driver

        self.phases = {"imports": time.perf_counter()}
        dcfg = program.dense_config(self.cfg)
        self.pool = traffic.pool(self.traffic, self.cfg, self.seed)
        self.phases["pool"] = time.perf_counter()
        model = dense_driver.build_gt_model(
            dcfg, self.cfg["vocab_size"], self.cfg["seq_length"], self.dev)
        w = program.seeded_weights(self.ref, self.cfg, self.seed, self.dev,
                                   served=True)
        program.weights.load_into(model, w)
        del w
        self.model = model.eval()
        self.normalize = normalize_images
        self.greedy = api.make_region_greedy_fn(model,
                                                self.traffic["decode_steps"])
        self.i = 0
        self.phases["built"] = time.perf_counter()
        self._call()
        self.phases["first call"] = time.perf_counter()
        for _ in range(self.traffic["warmup"] - 1):
            self._call()
        self.served.clear()
        program.sync(self.dev)
        self.phases["warm-up"] = time.perf_counter()

    def _call(self) -> float:
        """One request -> its latency in seconds."""
        t0 = time.perf_counter()
        k = self.i % len(self.pool)
        self.i += 1
        batch = self.pool[k]
        images = torch.from_numpy(batch["image"]).to(self.dev)
        boxes = torch.from_numpy(batch["boxes"]).to(self.dev)
        toks = self.greedy(self.normalize(images), boxes).cpu()
        latency = time.perf_counter() - t0
        self.served.append((k, self._planted(toks.numpy().astype(np.int32))))
        return latency

    def _planted(self, toks: np.ndarray) -> np.ndarray:
        """The served tokens, altered where they are produced by a planted
        fault (for the checks that must see it)."""
        if self.plant == "token":
            toks = toks.copy()
            toks[0, 0] = (toks[0, 0] + 1) % (self.cfg["vocab_size"] + 3)
        elif self.plant == "half_batch":
            toks = toks.copy()
            h = toks.shape[0] // 2
            toks[h:] = toks[:h]
        return toks

    def window(self, seconds: float) -> Dict:
        program.sync(self.dev)
        self.served.clear()
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self._call())
        elapsed = time.perf_counter() - t0
        self.finished = len(lat)
        self.units_per_s = len(lat) / elapsed
        failed = sum(1 for _, t in self.served
                     if t.shape != (self.regions, self.traffic["decode_steps"])
                     or t.min() < 0 or t.max() > self.cfg["vocab_size"] + 2)
        p95 = statistics.quantiles(lat, n=100)[94] if len(lat) > 1 else lat[0]
        q = len(lat) // 4
        return {"attempted": len(lat), "failed": failed, "seconds": elapsed,
                "metrics": {"serve_regions_per_s":
                            len(lat) * self.regions / elapsed,
                            "serve_p95_ms": p95 * 1e3},
                "quarters": [statistics.mean(lat[i * q:(i + 1) * q]) * 1e3
                             for i in range(4)] if q else []}

    def traced(self, units: int) -> trace.Trace:
        return trace.record(self._call, units, lambda: program.sync(self.dev))

    def release(self) -> None:
        self.model = self.greedy = None
        program.free(self.dev)

    # ------------------------------------------------------------- check
    def _sample(self) -> List[int]:
        """The requests checked: `checked` of those finished in the window,
        drawn from the seed (all are the same length)."""
        rng = np.random.default_rng(subseed(self.seed, "sample"))
        n = self.finished
        take = min(self.traffic["checked"], n)
        return sorted(rng.choice(n, take, replace=False).tolist())

    def readings(self, control: bool = False,
                 detail: bool = False) -> Dict[str, Dict[str, float]]:
        """{"program": {"logit_gap": the widest gap of a served token}},
        and with `control` the gap of the token that the reference in fp8
        puts first at each of the same positions (no `detail` here)."""
        w = program.seeded_weights(self.ref, self.cfg, self.seed, self.dev,
                                   served=True)
        sample = self._sample()
        # a window that finished nothing has nothing right
        start = 0.0 if sample else float("inf")
        gaps = {"program": start, "control": start}
        with exact_float32():
            for r in sample:
                k, toks = self.served[r]
                batch = self.pool[k]
                images = torch.from_numpy(batch["image"]).to(self.dev)
                boxes = torch.from_numpy(batch["boxes"]).to(self.dev)
                toks = torch.from_numpy(toks).to(self.dev).long()
                want = self.ref.logits(w, self.cfg, images, boxes, toks, EXACT)
                gaps["program"] = max(gaps["program"], float(
                    compare.logit_gaps(want, toks).max()))
                if control:
                    low = self.ref.logits(w, self.cfg, images, boxes, toks,
                                          FP8)
                    gaps["control"] = max(gaps["control"], float(
                        compare.logit_gaps(want, low.argmax(-1)).max()))
                    del low
                del want
        out = {"program": {"logit_gap": gaps["program"]}}
        if control:
            out["control"] = {"logit_gap": gaps["control"]}
        return out
