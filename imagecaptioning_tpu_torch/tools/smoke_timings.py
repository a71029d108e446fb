"""Where `chip_smoke.py`'s seconds go, function by function, on the card.

    python imagecaptioning_tpu_torch/tools/smoke_timings.py [--tree .]
    python imagecaptioning_tpu_torch/tools/smoke_timings.py --phases 25,26
    python imagecaptioning_tpu_torch/tools/smoke_timings.py --phases 27

The first form runs `<tree>/chip_smoke.py`'s `main()` with every function
defined at the top of that script wrapped in a timer, and prints, after
the script's own output, one line `TIMINGS {json}`: per function its
inclusive seconds (a nested call counts in both) and its number of calls,
the largest first. The script's own `phase_seconds` give each group of
phases; these split them (e.g. the profiler's `profiled` over all its
sites). The second form builds the kernels and runs only the named
phases of the trainers' evals (24), `evidence_run` (25), checkpoint
interchange (26) and data-parallel training (27), each timed, and prints
`PHASES {json}`. Run it as a
file, so that `<tree>`'s package is imported.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import types


def timed(module) -> dict:
    """Wrap every function defined in `module` (but `main`) so that each
    call adds its seconds to the returned totals."""
    totals: dict = {}

    def wrap(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                entry = totals.setdefault(name, [0.0, 0])
                entry[0] += time.perf_counter() - t0
                entry[1] += 1
        return run
    for name, fn in list(vars(module).items()):
        if (isinstance(fn, types.FunctionType) and name != "main"
                and fn.__module__ == module.__name__):
            setattr(module, name, wrap(name, fn))
    return totals


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=".", help="the checkout to time")
    p.add_argument("--phases", default="",
                   help="'24,25,26,27' or a part: only the trainers' "
                        "evals, evidence_run, checkpoint interchange, "
                        "data-parallel training")
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    if not args.phases:
        totals = timed(cs)
        sys.argv = ["chip_smoke.py"]
        rc = cs.main()
        rows = sorted(totals.items(), key=lambda kv: -kv[1][0])
        print("TIMINGS " + json.dumps({k: v for k, v in rows}))
        return rc

    from pathlib import Path

    import torch

    from imagecaptioning_tpu_torch.ops import _kernels
    from imagecaptioning_tpu_torch.ops import roi_align as roi
    if not torch.cuda.is_available():
        print("smoke_timings: no CUDA card available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.build_all(["roi_align", "roi_align_bwd"])
    _kernels.roi_align_lib()
    _kernels.roi_align_bwd_lib()
    seconds = {"build": time.perf_counter() - t0}
    dev, out = torch.device("cuda:0"), Path("build/chip_smoke")
    phases = {"24": cs.trainer_evals, "25": cs.evidence_runs,
              "26": cs.checkpoint_interchange, "27": cs.dp_training}
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        phases[name](dev, roi, out, card=torch.cuda.get_device_name(0))
        seconds[name] = time.perf_counter() - t0
    print("PHASES " + json.dumps(seconds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
