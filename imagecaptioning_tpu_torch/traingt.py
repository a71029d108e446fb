"""GT-box dense-caption training CLI — the port's counterpart of the root
`traingt.py` (AlexGTModel: VGG16 → GT-box ROI pooling → the transformer
caption head, or the LSTM head with `use_lstm=true`).

  python -m imagecaptioning_tpu_torch.traingt [key=value ...] [--device cpu]

e.g. `use_lstm=true max_iters=1000`. Each `key=value` overrides a field of
the GT config, typed like its default. Runs on the first CUDA card unless
`--device cpu`. Without the config's VG HDF5 it trains on seeded
synthetic data.
"""

from __future__ import annotations

import argparse

from imagecaptioning_tpu_torch.config.dense_configs import (apply_overrides,
                                                            get_gt_config)
from imagecaptioning_tpu_torch.train.dense_driver import train_gt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("overrides", nargs="*", metavar="KEY=VALUE")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    a = p.parse_args(argv)
    return train_gt(apply_overrides(get_gt_config(), a.overrides),
                    device=a.device)


if __name__ == "__main__":
    main()
