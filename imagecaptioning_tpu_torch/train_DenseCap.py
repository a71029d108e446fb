"""RPN dense-caption training CLI — the port's counterpart of the root
`train_DenseCap.py` (DenseCap: VGG16 → RPN → sampled-region ROI pooling
→ recognition base → objectness, box refinement and the LSTM caption
head, trained on the 5-loss sum).

  python -m imagecaptioning_tpu_torch.train_DenseCap [key=value ...] \
      [--device cpu]

e.g. `max_iters=1000 roi_only=true`. Each `key=value` overrides a field
of the DenseCap config, typed like its default. Runs on the first CUDA
card unless `--device cpu`. Without the config's VG HDF5 it trains on
seeded synthetic data. Under torchrun each process is a data rank (NCCL
on the cards, gloo with `--device cpu`):

  python -m torch.distributed.run --nproc_per_node=N \
      -m imagecaptioning_tpu_torch.train_DenseCap [key=value ...]
"""

from __future__ import annotations

import argparse

from imagecaptioning_tpu_torch.config.dense_configs import (
    apply_overrides, get_densecap_config)
from imagecaptioning_tpu_torch.parallel import mesh as meshlib
from imagecaptioning_tpu_torch.train.dense_driver import train_rpn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("overrides", nargs="*", metavar="KEY=VALUE")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card, or "
                        "the rank's card under torchrun)")
    a = p.parse_args(argv)
    with meshlib.process_group(a.device):
        return train_rpn(apply_overrides(get_densecap_config(),
                                         a.overrides), device=a.device)


if __name__ == "__main__":
    main()
