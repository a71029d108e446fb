"""Dense-caption serving CLI — the port's counterpart of the root `infer.py`
(`--model-type gt`, its `caption_dense`).

Captions proposed regions of every image in a directory with the fused
greedy or beam region decoder:

  python -m imagecaptioning_tpu_torch.infer --model-type gt \\
      --ckpt gt_model.pth --dicts data/VG-regions-dicts.json \\
      --images photos/ [--beam 3] [--device cpu]

`--ckpt` is a `torch.save`d state dict in the reference AlexGTModel key
layout (what the JAX package's `export_reference_gt_model` +
`save_state_dict` write). Each image is resized (shorter edge 700, longer
at most 720), padded onto a fixed 720×720 canvas, and its region slab
padded to `--max-regions` with degenerate (1, 1, 1, 1) boxes, as the
JAX CLI does. Runs on the first CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from imagecaptioning_tpu_torch.config.dense_configs import (DenseConfig,
                                                            get_gt_config)
from imagecaptioning_tpu_torch.data.proposals import ImageProcessor
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.utils.platform import resolve_device
from imagecaptioning_tpu_torch.utils.weights import load_gt_checkpoint

CANVAS = 720
# The slice each other --model-type waits for (ROADMAP.md, Queue 1).
_NOT_PORTED = {
    "lstm": "Slice D — AlexCap LSTM + ResNet-101 trainer",
    "lstm_attention": "Slice E — the other caption families",
    "transformer": "Slice E — the other caption families",
    "vitb": "Slice E — the other caption families",
}


def load_vocab(dicts_path: str) -> Vocab:
    with open(dicts_path) as f:
        return Vocab.from_dicts_json(json.load(f))


def apply_overrides(cfg: DenseConfig, pairs) -> DenseConfig:
    """`KEY=VALUE` strings → config fields, typed like the defaults."""
    for key, value in (kv.split("=", 1) for kv in pairs):
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, (int, float)):
            value = type(cur)(value)
        cfg = cfg.replace(**{key: value})
    return cfg


def build_gt_model(cfg: DenseConfig, vocab_size: int, seq_length: int,
                   device: torch.device) -> GTDenseCaptioner:
    """The serving model for `cfg`, built on `device`, in eval mode."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    with torch.device(device):
        model = GTDenseCaptioner(
            vocab_size=vocab_size, seq_length=seq_length,
            use_lstm=cfg.use_lstm, embedding_size=cfg.input_encoding_size,
            rnn_size=cfg.rnn_size, num_lstm_layers=cfg.num_layers,
            dropout=cfg.drop_value if cfg.use_dropout else 0.0,
            vgg_stages=cfg.vgg_stages, compute_dtype=dtype)
    return model.eval()


def caption_dense(args) -> dict:
    device = resolve_device(args.device)
    vocab = load_vocab(args.dicts)
    cfg = apply_overrides(get_gt_config(), args.set)
    model = build_gt_model(cfg, vocab.vocab_size, args.seq_length, device)
    model.load_state_dict(load_gt_checkpoint(args.ckpt))
    if args.beam > 1:
        beam = api.make_region_beam_fn(model, args.seq_length + 1, args.beam)
        decode = lambda x, b: beam(x, b).tokens[:, 0]
    else:
        decode = api.make_region_greedy_fn(model, args.seq_length + 1)

    paths = sorted(
        os.path.join(args.images, f) for f in os.listdir(args.images)
        if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not paths:
        raise SystemExit(f"no images in {args.images}")
    proc = ImageProcessor()
    rmax = args.max_regions
    out = {}
    for path in paths:
        # (1, H, W, 3), (1, R, 4) resized-frame boxes, + resize scale
        x, boxes, scale = proc.preprocess_img(path, return_scale=True)
        h, w = x.shape[1:3]
        xp = np.zeros((1, CANVAS, CANVAS, 3), np.float32)
        xp[0, :h, :w] = x[0]
        b = boxes[0][:rmax]
        n_real = b.shape[0]
        bp = np.full((rmax, 4), 1.0, np.float32)  # degenerate pad boxes
        bp[:n_real] = b
        toks = decode(torch.from_numpy(xp).to(device),
                      torch.from_numpy(bp[None]).to(device))
        caps = vocab.decode_sequence(toks.cpu().numpy().reshape(rmax, -1))
        # boxes reported in the ORIGINAL image's pixel frame
        inv = np.asarray([1.0 / scale["sx"], 1.0 / scale["sy"]] * 2,
                         np.float32)
        out[os.path.basename(path)] = {
            "resize": {"sx": scale["sx"], "sy": scale["sy"],
                       "raw_hw": list(scale["raw_hw"]),
                       "resized_hw": list(scale["resized_hw"])},
            "regions": [
                {"box_xcycwh": [float(v) for v in bp[i] * inv],
                 "caption": caps[i]}
                for i in range(n_real)],
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-type", default="gt",
                   choices=["lstm", "lstm_attention", "transformer",
                            "vitb", "gt"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dicts", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--seq-length", type=int, default=16)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--max-regions", type=int, default=32,
                   help="region-slab budget per image")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides (must match the checkpoint)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if a.model_type != "gt":
        raise NotImplementedError(
            f"--model-type {a.model_type} is not ported yet (ROADMAP.md, "
            f"Queue 1, {_NOT_PORTED[a.model_type]})")
    result = caption_dense(a)
    text = json.dumps(result, indent=2)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return result


if __name__ == "__main__":
    main()
