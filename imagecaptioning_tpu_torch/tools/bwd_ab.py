"""Backward-kernel numbers of source trees, for comparing commits on one card.

    python imagecaptioning_tpu_torch/tools/bwd_ab.py <tree>
    python imagecaptioning_tpu_torch/tools/bwd_ab.py --runs 3 <tree A> <tree B>

A `<tree>` is the root of a checkout (`.`, or a commit unpacked with
`git archive` into a directory that `.gitignore` lists). With one tree the
script builds that tree's backward kernels and runs its own
`chip_smoke.py` phase 7 (`check_roi_backward`: both kernels against the
plain backward, at the training shape and the serving shape, in all three
cases), with nothing else run before it in the process, then the
kernels' CUPTI times, and prints one line, `AB {json}`: per case the event
times L2-cold and hot, the CUPTI times, the bound and its share, and the
error. With two trees and `--runs k` it runs the one-tree form k times
for each, one process each, in turns (A B B A A B ...), prints each run's
line and then one line `AB-MEDIANS {json}`: per tree, shape and case the
median of each number over its runs. Run it as a file, not with `-m`, so
that the one-tree form imports the package from `<tree>`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KEYS = ("ms_cold", "ms_hot", "kernel_ms_cold", "kernel_ms_hot", "bound_ms",
        "cold_share_of_bound", "max_abs_err", "max_rel_err", "plain_ms",
        "library_ms")


def one_tree(tree: str) -> dict:
    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from imagecaptioning_tpu_torch.ops import _kernels
    from imagecaptioning_tpu_torch.ops import roi_align as roi

    dev = torch.device("cuda:0")
    _kernels.roi_align_lib()
    _kernels.roi_align_bwd_lib()
    flush = torch.zeros(2, cs.FLUSH_BYTES // 4, device=dev)
    out = {"tree": tree}
    for name, n, hf, image in (
            ("training", cs.TRAIN_BATCH, cs.TRAIN_IMAGE // 32,
             cs.TRAIN_IMAGE),
            ("serving", cs.N_IMAGES, cs.IMAGE // 32, cs.IMAGE)):
        res, calls = cs.check_roi_backward(dev, roi, n, cs.N_REGIONS, hf,
                                           512, image, 200, flush)
        cs.add_cupti(res, calls, 200, flush)
        out[name] = {case: {k: v[k] for k in KEYS if k in v}
                     for case, v in res.items()}
    return out


def medians(runs: list) -> dict:
    """{tree: {shape: {case: {key: median over the runs}}}}."""
    import numpy as np
    out = {}
    for run in runs:
        tree = out.setdefault(run["tree"], {})
        for shape, cases in run.items():
            if shape == "tree":
                continue
            for case, nums in cases.items():
                slot = tree.setdefault(shape, {}).setdefault(case, {})
                for k, v in nums.items():
                    if isinstance(v, float):
                        slot.setdefault(k, []).append(v)
    for tree in out.values():
        for cases in tree.values():
            for nums in cases.values():
                for k, v in nums.items():
                    nums[k] = float(np.median(v))
    return out


def alternate(trees, k: int) -> dict:
    """k runs of each of two trees, one process each, in turns."""
    a, b = trees
    order = [(a, b) if i % 2 == 0 else (b, a) for i in range(k)]
    runs = []
    for tree in (t for pair in order for t in pair):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               tree], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                               f"{proc.stderr[-3000:]}")
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1][3:]))
    return medians(runs)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+")
    p.add_argument("--runs", type=int, default=0,
                   help="runs per tree, in turns (two trees)")
    args = p.parse_args()
    if args.runs and len(args.trees) == 2:
        print("AB-MEDIANS " + json.dumps(alternate(args.trees, args.runs)),
              flush=True)
    elif len(args.trees) == 1 and not args.runs:
        print("AB " + json.dumps(one_tree(args.trees[0])), flush=True)
    else:
        sys.exit(__doc__)
