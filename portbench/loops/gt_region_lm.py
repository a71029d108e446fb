"""Closed-loop region captioning with a language-model head, one caller:
each request carries `images` uint8 images of `image_side`^2 with `boxes`
boxes each, taken from host memory, copied to the card, normalised by the
program's `normalize_images`, captioned greedily by
`api.make_region_greedy_fn` over `decode_steps` tokens, and ends when the
tokens are on the host. The model is the program's GT captioner with its
region language model (`GTRegionLMCaptioner`): every image's tokens are
prefilled once and shared by its regions; each region's token and the
prompt are prefilled after them; the first token comes from that prefill
and the others from `decode_steps - 1` cached decode steps.

The prompt's ids are drawn from the seed. The weights are made one tensor
at a time from the seed (`reference.make_weights`) and copied into the
program's parameters, so that no whole copy of them is ever held in fp32.

While it serves, the loop keeps, of every position a request decodes,
two marks of the program's own logits: the largest (that of the token
it serves) and those of `PROBES` vocabulary ids drawn from the seed. It
reads them off the step's logits as the decode hands them on (a wrapper
of the model's `init_decode`), on the card, with no read back.

Once the window has closed and the program's state is freed, a sample of
the finished requests drawn from the seed is run through the reference,
teacher-forced over the served tokens, its weights made again from the
seed one layer at a time. The numbers compared are the program's logits
less the reference's at the same positions, each in units of the
spread (standard deviation over the vocabulary) of the reference's
logits at its position: `logit_err_rms`, the root mean square over the
positions and the probe ids, and `served_err_max`, the widest such error
at a served token (the logit the program chose it by against the
reference's logit of it).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import lm_flops, moe_bounds, program, roi_bounds
from portbench import trace, traffic
from portbench.reference.layers import EXACT, FP8, VGG16, exact_float32
from portbench.weights import DTYPES, subseed

# vocabulary ids a position whose logits the program and the reference
# are compared at, besides the served token's
PROBES = 128
# a configuration this many parameters or larger is not built on a CPU
CPU_PARAMS = 200_000_000


class Loop:
    kind = "serve"
    # faults that a test or a calibration may plant: in the served tokens
    # (`token`, `half_batch`) or in the program (`top5`: five experts a
    # token; `no_shared`: the shared experts left out; `no_bias`: the
    # correction bias left out of the choice; `other_prefix`: each region
    # reads the next image's prefix)
    PLANTS = ("token", "half_batch", "top5", "no_shared", "no_bias",
              "other_prefix")

    def __init__(self, cfg: Dict, traffic_cfg: Dict, seed: int, device,
                 plant: Optional[str] = None):
        self.cfg, self.traffic, self.seed = cfg, traffic_cfg, seed
        self.dev = torch.device(device)
        self.plant = plant
        self.ref = program.reference(cfg)
        self.regions = traffic_cfg["images"] * traffic_cfg["boxes"]
        self.steps = traffic_cfg["decode_steps"]
        self.flops_per_unit = lm_flops.region_lm_call(cfg,
                                                      traffic_cfg)["total"]
        hf = traffic_cfg["image_side"] // 2 ** cfg["vgg_stages"]
        elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        self.roi_bounds = roi_bounds.per_launch(
            "serve", traffic_cfg["images"], traffic_cfg["boxes"], hf, hf,
            VGG16[cfg["vgg_stages"] - 1][-1], elem)
        rng = np.random.default_rng(subseed(seed, "prompt"))
        self.prompt = torch.from_numpy(rng.integers(
            0, cfg["vocab_size"], cfg["prompt_length"]))
        rng = np.random.default_rng(subseed(seed, "probes"))
        self.probes = torch.from_numpy(rng.choice(
            cfg["vocab_size"], PROBES, replace=False)).to(self.dev)
        self.narrow = DTYPES[cfg["param_dtype"]]
        self.units_per_s = None
        # (pool index, host tokens, the program's marks) a request
        self.served: List = []
        self.finished = 0               # requests of the window

    def setup(self) -> None:
        from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
        from imagecaptioning_tpu_torch.models import api
        from imagecaptioning_tpu_torch.train import dense_driver

        self.phases = {"imports": time.perf_counter()}
        n_params = sum(int(np.prod(s)) for _, s, *_ in
                       self.ref.param_layout(self.cfg))
        if self.dev.type == "cpu" and n_params >= CPU_PARAMS:
            raise RuntimeError(f"{n_params:,} parameters: this configuration "
                               f"is built on the card only")
        dcfg = program.dense_config(self.cfg)
        self.pool = traffic.pool(self.traffic, self.cfg, self.seed)
        self.phases["pool"] = time.perf_counter()
        model = dense_driver.build_gt_model(dcfg, self.cfg["vocab_size"], 0,
                                            self.dev)
        self.phases["model"] = time.perf_counter()
        self._load(model)
        self.phases["weights"] = time.perf_counter()
        self.model = model.eval()
        self._plant_in_program(model)
        self._observe(model)
        self.normalize = normalize_images
        self.greedy = api.make_region_greedy_fn(model, self.steps)
        self.i = 0
        self.phases["built"] = time.perf_counter()
        self._call()
        self.phases["first call"] = time.perf_counter()
        for _ in range(self.traffic["warmup"] - 1):
            self._call()
        self.served.clear()
        program.sync(self.dev)
        self.phases["warm-up"] = time.perf_counter()

    @torch.no_grad()
    def _load(self, model) -> None:
        """The seeded weights, one tensor at a time, into the parameters
        of the same names (each cast to its parameter's type)."""
        params = dict(model.named_parameters())
        names = [n for n, *_ in self.ref.param_layout(self.cfg)]
        if set(params) != set(names):
            raise KeyError(f"parameters the program has and the layout "
                           f"lacks: {sorted(set(params) - set(names))}; the "
                           f"layout has and the program lacks: "
                           f"{sorted(set(names) - set(params))}")
        for name, t in self.ref.make_weights(self.cfg, self.seed, self.dev):
            if tuple(params[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: program {tuple(params[name].shape)}"
                                 f", layout {tuple(t.shape)}")
            params[name].copy_(t)
            del t
        model.lm.prompt_ids.copy_(self.prompt)

    @torch.no_grad()
    def _plant_in_program(self, model) -> None:
        """Put a planted fault of the program's own into `model`."""
        from imagecaptioning_tpu_torch.models import moe_lm

        moes = [m for m in model.modules() if isinstance(m, moe_lm.MoE)]
        if self.plant == "top5":
            for m in moes:
                m.top_k = 5
        elif self.plant == "no_shared":
            for m in moes:
                m.shared_experts.down_proj.weight.zero_()
        elif self.plant == "no_bias":
            for m in moes:
                m.gate.e_score_correction_bias.zero_()
        elif self.plant == "other_prefix":
            prefill = model.lm.prefill_prefix
            model.lm.prefill_prefix = lambda x: [
                c.roll(1, 0) for c in prefill(x)]

    def _observe(self, model) -> None:
        """Have each decode of `model` keep its positions' marks in
        `self._marks`: the largest logit, then the probe ids' logits
        (B, 1 + PROBES), a position at a time, from the prefill's first
        logits on."""
        init_decode = model.init_decode

        def marks(logits):
            return torch.cat([logits.max(-1, keepdim=True).values,
                              logits.index_select(1, self.probes)], 1)

        def observed(flat_enc, **kw):
            carry, step = init_decode(flat_enc, **kw)
            self._marks = [marks(carry.first_logits)]

            def marked(carry, toks, t):
                carry, logits = step(carry, toks, t)
                self._marks.append(marks(logits))
                return carry, logits
            return carry, marked
        model.init_decode = observed

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
        marks = torch.stack(self._marks, 1)
        self.served.append((k, *self._planted(
            toks.numpy().astype(np.int64), marks)))
        return latency

    def _planted(self, toks: np.ndarray, marks: torch.Tensor):
        """The served tokens and the marks, altered where a planted fault
        of the output makes them: `token` serves another token than the
        logits chose at one position; `half_batch` serves the first half
        of the regions' output for the second half too."""
        if self.plant == "token":
            toks = toks.copy()
            toks[0, 0] = (toks[0, 0] + 1) % self.cfg["vocab_size"]
        elif self.plant == "half_batch":
            toks, marks = toks.copy(), marks.clone()
            h = toks.shape[0] // 2
            toks[h:], marks[h:] = toks[:h], marks[:h]
        return toks, marks

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
        failed = sum(1 for _, t, _ in self.served
                     if t.shape != (self.regions, self.steps)
                     or t.min() < 0 or t.max() >= self.cfg["vocab_size"])
        q = len(lat) // 4
        return {"attempted": len(lat), "failed": failed, "seconds": elapsed,
                "metrics": {"serve_regions_per_s":
                            len(lat) * self.regions / elapsed},
                "quarters": [statistics.mean(lat[i * q:(i + 1) * q]) * 1e3
                             for i in range(4)] if q else []}

    def traced(self, units: int) -> trace.Trace:
        """The traced stretches, and for `moe_roofline.serve` the bound of
        the device stretch's grouped products: its calls run again with
        each launch's rows and experts recorded (`moe_bounds.record`)."""
        from imagecaptioning_tpu_torch.ops import moe as moe_ops
        from imagecaptioning_tpu_torch.utils.profiling import COUNTERS

        before, first = COUNTERS["moe.assignments"], self.i
        tr = trace.record(self._call, units, lambda: program.sync(self.dev))
        # record() runs the unit once to start the profiler, then the
        # device's stretch (`units` calls), then the host's
        counted = (COUNTERS["moe.assignments"] - before) / (2 * units + 1)
        last = self.i
        self.i = first + 1
        # eagerly: a replayed graph runs no dispatch for `record` to see
        self.model.lm.graphs = False
        with moe_bounds.record(moe_ops) as layers:
            for _ in range(units):
                self._call()
        self.model.lm.graphs = True
        self.i = last
        want = moe_bounds.expected_assignments(self.cfg, self.traffic)
        rows = sum(m for m, _ in layers) / units
        if counted == want == rows:
            tr.moe = {"bound_ms": moe_bounds.bound_ms(self.cfg, layers)
                      / units, "layers": len(layers) / units,
                      "experts_hit": sum(e for _, e in layers) / len(layers)}
        return tr

    def release(self) -> None:
        self.model = self.greedy = None
        program.free(self.dev)

    # ------------------------------------------------------------- check
    def _sample(self) -> List[int]:
        """The requests checked: `checked` of those finished in the window,
        drawn from the seed."""
        rng = np.random.default_rng(subseed(self.seed, "sample"))
        n = self.finished
        take = min(self.traffic["checked"], n)
        return sorted(rng.choice(n, take, replace=False).tolist())

    def _errors(self, want: torch.Tensor, toks: torch.Tensor,
                marks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The reference's logits (B, T, V), the served tokens (B, T) and
        the marks of the logits they were served by (B, T, 1 + PROBES) ->
        {"served": |error| at the served tokens (B, T), "probe": the errors
        at the probe ids (B, T, PROBES)}, each in units of the reference's
        spread at its position."""
        spread = want.std(-1)
        served = marks[..., 0] - want.gather(-1, toks[..., None])[..., 0]
        probe = marks[..., 1:] - want.index_select(-1, self.probes)
        return {"served": (served / spread).abs(),
                "probe": probe / spread[..., None]}

    @staticmethod
    def _numbers(errs: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
        if not errs:                    # a window that finished nothing
            return {"logit_err_rms": float("inf"),
                    "served_err_max": float("inf")}
        probe = torch.cat([e["probe"].reshape(-1) for e in errs]).double()
        return {"logit_err_rms": float(probe.pow(2).mean().sqrt()),
                "served_err_max": max(float(e["served"].max())
                                      for e in errs)}

    @staticmethod
    def _detail(errs: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
        """Quantiles of each region's and each position's root mean square
        error, and of the served tokens' errors, for a calibration."""
        region = torch.cat([e["probe"].pow(2).mean((1, 2)).sqrt()
                            for e in errs]).double()
        pos = torch.cat([e["probe"].pow(2).mean(2).sqrt().reshape(-1)
                         for e in errs]).double()
        first = torch.cat([e["probe"][:, 0] for e in errs]).double()
        served = torch.cat([e["served"].reshape(-1) for e in errs]).double()
        qs = (0.5, 0.9, 0.99, 0.999)
        out = {"first_rms": float(first.pow(2).mean().sqrt())}
        for name, v in (("region", region), ("position", pos),
                        ("served", served)):
            out.update({f"{name}_q{q}": float(torch.quantile(v, q))
                        for q in qs})
            out[f"{name}_max"] = float(v.max())
        return out

    def readings(self, control: bool = False,
                 detail: bool = False) -> Dict[str, Dict[str, float]]:
        """{"program": {"logit_err_rms", "served_err_max"}}, and with
        `control` the same of the reference in fp8 in the program's place
        (its marks from its own logits, its served tokens their argmax);
        with `detail`, quantiles of the errors (`_detail`)."""
        w = self.ref.SeededWeights(self.cfg, self.seed, self.dev,
                                   self.narrow)
        prompt = self.prompt.to(self.dev)
        errs = {"program": [], "control": []}
        with exact_float32():
            for r in self._sample():
                k, toks, marks = self.served[r]
                batch = self.pool[k]
                images = torch.from_numpy(batch["image"]).to(self.dev)
                boxes = torch.from_numpy(batch["boxes"]).to(self.dev)
                toks = torch.from_numpy(toks).to(self.dev)
                want = self.ref.logits(w, self.cfg, images, boxes, prompt,
                                       toks, EXACT)
                errs["program"].append(self._errors(
                    want, toks, marks.to(self.dev).float()))
                if control:
                    low = self.ref.logits(w, self.cfg, images, boxes, prompt,
                                          toks, FP8)
                    top = low.max(-1)
                    errs["control"].append(self._errors(
                        want, top.indices, torch.cat(
                            [top.values[..., None],
                             low.index_select(-1, self.probes)], -1)))
                    del low, top
                del want
        out = {"program": self._numbers(errs["program"])}
        if control:
            out["control"] = self._numbers(errs["control"])
        if detail:
            out["detail"] = {k: self._detail(v) for k, v in errs.items()
                             if v}
        return out
