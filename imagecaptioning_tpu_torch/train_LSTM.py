"""AlexCap LSTM training CLI — the port's counterpart of the root
`train_LSTM.py` (the reference's LSTM + ResNet-101 captioner,
`get_lstm_config`):

  python -m imagecaptioning_tpu_torch.train_LSTM [--smoke] \\
      [--set KEY=VALUE ...] [--device cpu]

e.g. `--smoke --device cpu --set backbone_stages=1,1,1,1` trains a few
steps of a cut trunk on seeded synthetic data on the CPU. Runs on the
first CUDA card unless `--device cpu`. Without the config's Face2Text
HDF5 it trains on seeded synthetic data.

Under torchrun each process is a data rank (NCCL on the cards, gloo
with `--device cpu`):

  python -m torch.distributed.run --nproc_per_node=N \\
      -m imagecaptioning_tpu_torch.train_LSTM [--smoke] [--set ...]
"""

from __future__ import annotations

import sys

from imagecaptioning_tpu_torch.train.cli import main

MODEL_TYPE = "lstm"

if __name__ == "__main__":
    main(MODEL_TYPE, sys.argv[1:])
