"""AlexCap ViTB training CLI — the port's counterpart of the root
`train_ViTB.py` (the reference's ViT-B/16 captioner,
`get_vitb_config`):

  python -m imagecaptioning_tpu_torch.train_ViTB [--smoke] \\
      [--set KEY=VALUE ...] [--device cpu]

e.g. `--smoke --device cpu --set vit_dims=224,16,2,2,32,64
embedding_size=32 num_layers=2` trains a few steps of a cut
model on seeded synthetic data on the CPU. Runs on the first CUDA card
unless `--device cpu`. Without the config's Face2Text HDF5 it trains on
seeded synthetic data.
"""

from __future__ import annotations

import sys

from imagecaptioning_tpu_torch.train.cli import main

MODEL_TYPE = "vitb"

if __name__ == "__main__":
    main(MODEL_TYPE, sys.argv[1:])
