"""Gradient accumulation on the card against the CPU, from the same
micro-gradients.

    python imagecaptioning_tpu_torch/tools/accum_check.py [--tree .] [--k 1 3]

For each k: a small AlexCap LSTM captioner (ResNet cut to one block a
stage, a 16-wide head) with seed 0's weights on the CPU and on the card;
k seeded micro-gradients, the same numbers on both, folded by the AlexCap
optimizer at grad_accum_steps k; then its update. One line `ACCUM {json}`
per k: how many running means and updated weights differ between the
devices, the largest gap, and the largest weight gap beyond one ulp of
the weight, in ulps of the lr. Run it as a file, so that `<tree>`'s
package is imported (a parent checkout under `build/` compares two
trees on one card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

LR = 1e-4                       # get_lstm_config's


def accumulated_update(device, k: int = 3):
    """`k` micro-gradients (the same seeded numbers on every device)
    folded by the AlexCap optimizer at grad_accum_steps `k`, then its
    update → ({name: mean in `.grad` before the step}, {name: weight
    after it}), on the CPU."""
    import torch

    from imagecaptioning_tpu_torch.config.configs import get_lstm_config
    from imagecaptioning_tpu_torch.models.captioners import LSTMCaptioner
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    def tiny(d):
        return LSTMCaptioner(30, 16, 16, backbone_stages=(1, 1, 1, 1)).to(d)
    model = tiny(device)
    model.load_state_dict(seeded_init_(tiny("cpu"), 0).state_dict())
    opt = optim.make_optimizer(get_lstm_config().replace(grad_accum_steps=k),
                               model, 10)
    rng = np.random.RandomState(11)
    for i in range(k):
        for p in opt.accumulated.values():
            p.grad = torch.from_numpy(
                rng.randn(*p.shape).astype(np.float32)).to(device)
        if opt.accumulate() != (i == k - 1):
            raise AssertionError(f"micro-step {i + 1} of {k} applied")
    means = {n: p.grad.cpu().clone() for n, p in opt.accumulated.items()}
    opt.step()
    return means, {n: p.detach().cpu() for n, p in opt.accumulated.items()}


def gaps(card: dict, cpu: dict) -> dict:
    """Where two {name: tensor} dicts differ, elementwise."""
    lr_ulp = float(np.spacing(np.float32(LR)))
    out = {"unequal": 0, "of": 0, "tensors_unequal": 0, "max_abs": 0.0,
           "max_beyond_one_ulp_in_lr_ulps": 0.0}
    for name, want in cpu.items():
        got = card[name]
        gap = (got.double() - want.double()).abs()
        beyond = (gap - 2.0 ** -23 * want.double().abs()) / lr_ulp
        out["unequal"] += int((got != want).sum())
        out["of"] += want.numel()
        out["tensors_unequal"] += int(not bool((got == want).all()))
        out["max_abs"] = max(out["max_abs"], float(gap.max()))
        out["max_beyond_one_ulp_in_lr_ulps"] = max(
            out["max_beyond_one_ulp_in_lr_ulps"], float(beyond.max()))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=".", help="the checkout to import")
    p.add_argument("--k", type=int, nargs="+", default=[1, 3])
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("accum_check: no CUDA card available", file=sys.stderr)
        return 1
    for k in args.k:
        (m0, w0), (m1, w1) = (accumulated_update(d, k) for d in (
            torch.device("cpu"), torch.device("cuda:0")))
        print("ACCUM " + json.dumps({
            "tree": args.tree, "k": k,
            "card": torch.cuda.get_device_name(0),
            "means": gaps(m1, m0), "weights": gaps(w1, w0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
