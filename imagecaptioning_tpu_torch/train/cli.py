"""Shared CLI of the port's AlexCap training entry points — port of
`imagecaptioning_tpu/train/cli.py`.

The reference drivers are bare scripts with hard-coded configs; as in the
JAX package, every config field takes a `--set KEY=VALUE` override, and:
  --smoke        a tiny run (few iterations, synthetic data)
  --synthetic    the synthetic dataset even where the HDF5 exists
  --synthetic-learnable  the learnable synthetic dataset (captions
                 derived from the rendered images)
  --device       the torch device (default: the first CUDA card, or the
                 rank's card under torchrun; `cpu` runs on the CPU)

Under `python -m torch.distributed.run --nproc_per_node=N -m
imagecaptioning_tpu_torch.train_LSTM ...` each process is a data rank
(`parallel/mesh.py`: NCCL on the cards, gloo with `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import sys

from imagecaptioning_tpu_torch.config.configs import (apply_overrides,
                                                      get_config)
from imagecaptioning_tpu_torch.parallel import mesh as meshlib
from imagecaptioning_tpu_torch.train.driver import train


def main(model_type: str, argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description=f"Train the {model_type} captioner (PyTorch port)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny synthetic smoke run")
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic dataset")
    parser.add_argument("--synthetic-learnable", action="store_true",
                        help="synthetic data whose captions describe the "
                             "rendered images (hair, skin, shirt, glasses, "
                             "mouth, hat), so a run can show that it learns")
    parser.add_argument("--synthetic-images", type=int, default=None)
    parser.add_argument("--max-iter", type=int, default=None)
    parser.add_argument("--eval-every", type=int, default=None)
    parser.add_argument("--set", nargs="*", default=[],
                        metavar="KEY=VALUE", help="config field overrides")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card)")
    args = parser.parse_args(argv)

    cfg = get_config(model_type)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if args.synthetic or args.smoke or args.synthetic_learnable:
        overrides.setdefault("data_h5", "/nonexistent")
        overrides.setdefault("from_checkpoint", "false")
    if args.smoke:
        overrides.setdefault("batch_size", "4")
        overrides.setdefault("save_checkpoint_every", "16")
        overrides.setdefault("num_epochs", "2")
        overrides.setdefault("eval_val_batch_size", "4")
    cfg = apply_overrides(cfg, overrides)

    with meshlib.process_group(args.device):
        summary = train(cfg, device=args.device,
                        max_iter_override=args.max_iter or (8 if args.smoke
                                                            else None),
                        eval_every_override=args.eval_every or (
                            4 if args.smoke else None),
                        synthetic_images=(args.synthetic_images
                                          or (32 if args.smoke else 64)),
                        synthetic_learnable=args.synthetic_learnable)
        if meshlib.is_writer():
            printable = {k: v for k, v in summary.items()
                         if k not in ("model", "optimizer", "loader")}
            print(json.dumps(printable, default=str))
    return summary


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
