"""Serving numbers of one source tree, for comparing two commits on one card.

    python imagecaptioning_tpu_torch/tools/serve_ab.py <tree>

`<tree>` is the root of a checkout (`.`, or a commit unpacked with
`git archive` into a directory that `.gitignore` lists). The script runs
that tree's own `chip_smoke.py` serving phase and profile, with nothing
else run before them in the process, and prints one line, `AB {json}`:
greedy and beam-3 regions/s, the encode time, the card's busy time per
greedy and per beam-3 call (profiler), and the host's time to issue one
encode and one greedy call from an idle card. Run it as a file, not with
`-m`, so that the package is imported from `<tree>`; alternate the trees
over several processes, since the host-bound decode's rate varies from
run to run.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path


def host_ms(fn, reps: int = 20) -> float:
    """Median host milliseconds to issue one call, from an idle card."""
    import numpy as np
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def main(tree: str) -> dict:
    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
    from imagecaptioning_tpu_torch.models import api
    from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
    from imagecaptioning_tpu_torch.ops import _kernels
    from imagecaptioning_tpu_torch.ops import roi_align as roi
    from imagecaptioning_tpu_torch.utils import weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    _kernels.roi_align_lib()
    with torch.device(dev):
        model = GTDenseCaptioner(
            vocab_size=cs.VOCAB, seq_length=cs.SEQ, embedding_size=512,
            rnn_size=512, num_lstm_layers=1, vgg_stages=5,
            compute_dtype=torch.bfloat16)
    model = weights.seeded_init_(model.eval(), cs.SEED)
    flush = torch.zeros(2, cs.FLUSH_BYTES // 4, device=dev)
    served, run_beam, run_greedy = cs.serve(dev, model, api,
                                            normalize_images, roi, flush)
    prof = cs.profile(run_beam, run_greedy, Path("build/ab"))
    rng = np.random.RandomState(cs.SEED)
    x = normalize_images(torch.from_numpy(rng.randint(
        0, 256, (cs.N_IMAGES, cs.IMAGE, cs.IMAGE, 3),
        dtype=np.uint8)).to(dev))
    boxes = torch.from_numpy(cs.edge_boxes(
        rng, cs.N_IMAGES, cs.N_REGIONS, cs.IMAGE, cs.IMAGE)).to(dev)
    greedy = api.make_region_greedy_fn(model, cs.SEQ + 1)
    with torch.inference_mode():
        encode_host = host_ms(lambda: model.encode_flat(x, boxes))
    greedy_host = host_ms(lambda: greedy(x, boxes))
    return {"tree": tree, "greedy": served["greedy_regions_per_s"],
            "beam": served["beam3_regions_per_s"],
            "encode_ms": served["encode_ms"],
            "greedy_busy_ms": prof["greedy"]["device_busy_ms"],
            "beam_busy_ms": prof["beam"]["device_busy_ms"],
            "encode_host_ms": encode_host, "greedy_host_ms": greedy_host}


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    print("AB " + json.dumps(main(sys.argv[1])), flush=True)
