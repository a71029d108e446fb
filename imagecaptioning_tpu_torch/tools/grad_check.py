"""The fp32 train-step gradients behind `chip_smoke.py`'s phases 9, 11 and
14: the card against the CPU, and both against an fp64 CPU run.

    python imagecaptioning_tpu_torch/tools/grad_check.py \
        [--kinds rpn lstm transformer] [--fp64] [--plant F]

Run from the root of a checkout, as a file. For each kind it runs the
phase's own check (`chip_smoke.train_step_check`, its line printed) on
the card. `--fp64` adds the same step on the CPU in fp64 from the same
weights (the ROI wrappers' plain versions widened to fp64 in this process
only; the heads that the model runs in fp32 whatever its compute dtype
stay fp32) and prints, for the six tensors farthest from it, [max relative
error, share of elements over 1e-4] of the CPU's fp32 gradients and of
the card's: which device's fp32 strays, and in how many elements.
`--plant F` multiplies the card's d_boxes (kernel B's output) by F in this
process only (0 drops it), to show what phase 14 catches. Prints one
`GRAD {json}` line per kind; exits 1 if a check failed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))

import chip_smoke as cs  # noqa: E402
from imagecaptioning_tpu_torch.ops import _kernels  # noqa: E402
from imagecaptioning_tpu_torch.ops import roi_align as roi  # noqa: E402
from imagecaptioning_tpu_torch.train import dense_driver as dd  # noqa: E402


def widen_to_fp64() -> None:
    """Let the model build in fp64 and the ROI wrappers' plain versions
    take fp64 maps on the CPU."""
    dd.DTYPES["float64"] = torch.float64
    roi._DTYPES = (*roi._DTYPES, torch.float64)
    for name in ("_check", "_check_bwd"):
        check = getattr(roi, name)
        setattr(roi, name, lambda f, *a, _c=check: (
            None if f.dtype == torch.float64 else _c(f, *a)))


def plant(factor: float) -> None:
    """Scale kernel B's d_boxes on the card by `factor`."""
    boxes_bwd = roi.roi_align_bwd_boxes

    def planted(*args, **kw):
        out = boxes_bwd(*args, **kw)
        return out * factor if out.is_cuda else out
    # the wrapper counts its launches on the module's name, now this one
    planted.launches = 0
    roi.roi_align_bwd_boxes = planted


def worst(agree: dict, n: int = 6) -> dict:
    names = sorted(agree, key=lambda k: -agree[k][1] - agree[k][0])[:n]
    return {k: agree[k] for k in names}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kinds", nargs="+", default=["rpn"],
                   choices=["rpn", "lstm", "transformer"])
    p.add_argument("--fp64", action="store_true")
    p.add_argument("--plant", type=float, default=None)
    args = p.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build_all(["roi_align", "roi_align_bwd"])
    if args.fp64:
        widen_to_fp64()
    if args.plant is not None:
        plant(args.plant)
    dev, cpu, failed = torch.device("cuda:0"), torch.device("cpu"), False
    for kind in args.kinds:
        out = {"kind": kind, "plant": args.plant}
        try:
            cs.train_step_check(dev, kind, label=f"GRAD-CHECK {kind}")
            out["check"] = "passed"
        except AssertionError:
            out["check"] = "failed"
            failed = True
        if args.fp64:
            state, _, _, cpu32 = cs.step_grads(cpu, kind)
            _, _, _, card32 = cs.step_grads(dev, kind, state=state)
            _, _, _, cpu64 = cs.step_grads(cpu, kind, "float64", state)
            out["cpu_fp32_vs_fp64"] = worst(cs.grad_agreement(cpu32, cpu64))
            out["card_fp32_vs_fp64"] = worst(cs.grad_agreement(card32,
                                                               cpu64))
        print(f"GRAD {json.dumps(out)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
