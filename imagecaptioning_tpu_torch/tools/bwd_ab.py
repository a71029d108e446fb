"""Backward-kernel numbers of source trees, for comparing commits on one card.

    python imagecaptioning_tpu_torch/tools/bwd_ab.py <tree>
    python imagecaptioning_tpu_torch/tools/bwd_ab.py --runs 3 <tree A> <tree B>

A `<tree>` is the root of a checkout (`.`, or a commit unpacked with
`git archive` into a directory that `.gitignore` lists). With one tree the
script builds that tree's backward kernels and runs its own
`chip_smoke.py` phase 7 (`check_roi_backward`: both kernels against the
plain backward, at the GT training shape and the GT serving shape, in all
three cases), with nothing else run before it in the process, then the
kernels' CUPTI times, then phase 12's `check_rpn_roi` (K1 and both
kernels at the RPN training shape, on the sample of the seeded RPN model
at init: 4 × 256 boxes of its 45×45×512 bf16 map, bf16 CHW gradient),
then kernels A and B on the same sample in fp32 (the fp32 RPN step's map
and CHW gradient: shape `rpn_fp32`), and prints one line, `AB {json}`: per shape and case the event times L2-cold
and hot, the CUPTI times, the bound and its share, and the error. With
two trees and `--runs k` it runs the one-tree form k times for each, one
process each, in turns (A B B A A B ...), prints each run's
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
    del flush
    out["rpn"], out["rpn_fp32"] = rpn_shape(cs, dev, roi)
    return out


def rpn_shape(cs, dev, roi) -> tuple:
    """Phase 12's checks and times at the RPN training shape, on the
    seeded DenseCap RPN model's own sample, then `rpn_fp32`'s."""
    import torch

    from imagecaptioning_tpu_torch.config.dense_configs import \
        get_densecap_config
    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils import weights

    model = weights.seeded_init_(dd.build_rpn_model(
        get_densecap_config(), cs.VOCAB, cs.SEQ, dev), cs.SEED)
    feats, boxes, sample = cs.sampled_rpn_boxes(dev, model, normalize_images)
    del model
    torch.cuda.empty_cache()
    flush = torch.zeros(2, cs.FLUSH_BYTES // 4, device=dev)
    res = cs.check_rpn_roi(dev, roi, feats, boxes, sample, 200, flush)
    res32 = rpn_fp32(cs, dev, roi, feats.float(), boxes, flush)
    return tuple({case: {k: v[k] for k in KEYS if k in v}
                  for case, v in r.items()} for r in (res, res32))


def rpn_fp32(cs, dev, roi, feats, boxes, flush) -> dict:
    """Kernels A and B on the RPN's sample with an fp32 map and fp32 CHW
    gradient, each against the plain backward (two launches bitwise the
    same), with event and CUPTI times, the plain version's and the bound,
    as phase 12 takes them in bf16 → {entry: numbers}."""
    import numpy as np
    import torch

    n, r = boxes.shape[:2]
    hw = (float(cs.TRAIN_IMAGE), float(cs.TRAIN_IMAGE))
    rng = np.random.RandomState(cs.SEED + 6)
    grad = torch.from_numpy(rng.randn(n, r, 49 * feats.shape[-1])
                            .astype(np.float32)).to(dev)
    cases = {
        "roi_align_bwd_features": (
            lambda: roi.roi_align_bwd_features(feats, boxes, grad, hw),
            lambda: roi.roi_align_backward_reference(
                feats, boxes, grad, hw, need_boxes=False)[0],
            cs.compare, (grad, boxes), 8 * grad.numel()),
        "roi_align_bwd_boxes": (
            lambda: roi.roi_align_bwd_boxes(feats, boxes, grad, hw),
            lambda: roi.roi_align_backward_reference(
                feats, boxes, grad, hw, need_features=False)[1],
            cs.compare_boxes, (feats, boxes, grad), 14 * grad.numel()),
    }
    out = {}
    for name, (kernel, plain, check, reads, flops) in cases.items():
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} in fp32 at the RPN shape: two "
                                 f"launches differ")
        res = {**check(got, plain()), **cs.roofline(reads, got, flops),
               **cs.timings(kernel, 200, flush),
               **cs.cupti_times(kernel, cs.CUPTI_CALLS, flush),
               "plain_ms": cs.cuda_ms(plain, 50)}
        res["cold_share_of_bound"] = res["bound_ms"] / res["ms_cold"]
        out[name] = res
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
