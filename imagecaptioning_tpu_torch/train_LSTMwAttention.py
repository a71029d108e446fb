"""AlexCap LSTMwAttention training CLI — the port's counterpart of the root
`train_LSTMwAttention.py` (the reference's Show-Attend-Tell captioner on
ResNet-101, `get_lstm_attention_config`):

  python -m imagecaptioning_tpu_torch.train_LSTMwAttention [--smoke] \\
      [--set KEY=VALUE ...] [--device cpu]

e.g. `--smoke --device cpu --set backbone_stages=1,1,1,1
embedding_size=16 lstm_size=16` trains a few steps of a cut
model on seeded synthetic data on the CPU. Runs on the first CUDA card
unless `--device cpu`. Without the config's Face2Text HDF5 it trains on
seeded synthetic data.
"""

from __future__ import annotations

import sys

from imagecaptioning_tpu_torch.train.cli import main

MODEL_TYPE = "lstm_attention"

if __name__ == "__main__":
    main(MODEL_TYPE, sys.argv[1:])
