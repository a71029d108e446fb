"""AlexCap Transformer training CLI — the port's counterpart of the root
`train_Transformer.py` (the reference's ResNet-101 + 6-layer
encoder-decoder captioner, `get_transformer_config`):

  python -m imagecaptioning_tpu_torch.train_Transformer [--smoke] \\
      [--set KEY=VALUE ...] [--device cpu]

e.g. `--smoke --device cpu --set backbone_stages=1,1,1,1
transformer_size=32 num_layers=2` trains a few steps of a cut
model on seeded synthetic data on the CPU. Runs on the first CUDA card
unless `--device cpu`. Without the config's Face2Text HDF5 it trains on
seeded synthetic data.

Under torchrun each process is a data rank (NCCL on the cards, gloo
with `--device cpu`):

  python -m torch.distributed.run --nproc_per_node=N \\
      -m imagecaptioning_tpu_torch.train_Transformer [--smoke] [--set ...]
"""

from __future__ import annotations

import sys

from imagecaptioning_tpu_torch.train.cli import main

MODEL_TYPE = "transformer"

if __name__ == "__main__":
    main(MODEL_TYPE, sys.argv[1:])
