"""Serving CLI — the port's counterpart of the root `infer.py`
(`caption_alexcap` for the AlexCap `--model-type`s `lstm`,
`lstm_attention`, `transformer` and `vitb`; `caption_dense` for
`--model-type gt`).

An AlexCap `--model-type` captions every image of a directory with that
family's config (ResNet-101 by default; `--set backbone_stages=...`,
`use_vggface=true` or `vit_dims=...` must match the checkpoint), greedy
or beam (`--beam K`, raw-logit scores as in the JAX package): each image
is resized to 218×178 (CelebA's size) as the JAX CLI does, then
preprocessed on the card (short side 232, center crop 224, ImageNet
normalize). `--ckpt` is a port training checkpoint (the best model of
`train_LSTM`, `train_LSTMwAttention`, `train_Transformer` or
`train_ViTB`) or a reference model's `state_dict()` of that family saved
with `torch.save`:

  python -m imagecaptioning_tpu_torch.infer --model-type lstm \\
      --ckpt runs/models/best_model_LSTM_resnet_ft_bs12_clip.ckpt \\
      --dicts data/face2text-dicts.json --images photos/ [--device cpu]

`--model-type gt` captions proposed regions of every image in a directory
with the fused greedy or beam region decoder, through the GT config's
caption head: the transformer head by default, the LSTM head with
`--set use_lstm=true`:

  python -m imagecaptioning_tpu_torch.infer --model-type gt \\
      --ckpt gt_model.pth --dicts data/VG-regions-dicts.json \\
      --images photos/ [--beam 3] [--device cpu]

`--ckpt` is a port checkpoint (`traingt`'s, or what `convert_checkpoint
import-model` writes from a reference AlexGTModel `.pth`) or a
`torch.save`d state dict in the reference AlexGTModel key layout. Each
image is resized (shorter edge 700, longer at most 720), padded onto a fixed 720×720 canvas, and its region slab
padded to `--max-regions` with degenerate (1, 1, 1, 1) boxes, as the
JAX CLI does. Runs on the first CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from imagecaptioning_tpu_torch.config import configs
from imagecaptioning_tpu_torch.config.dense_configs import (DenseConfig,
                                                            apply_overrides,
                                                            get_gt_config)
from imagecaptioning_tpu_torch.data.proposals import ImageProcessor
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.captioners import build_model
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.train import dense_driver
from imagecaptioning_tpu_torch.utils.platform import resolve_device
from imagecaptioning_tpu_torch.utils.weights import (load_alexcap_checkpoint,
                                                     load_gt_checkpoint)

CANVAS = 720


def load_vocab(dicts_path: str) -> Vocab:
    with open(dicts_path) as f:
        return Vocab.from_dicts_json(json.load(f))


def _load_images(image_dir: str, hw=(218, 178)):
    """Every .jpg/.jpeg/.png of `image_dir`, RGB, resized to `hw` →
    (paths, uint8 (N, H, W, 3))."""
    from PIL import Image
    paths = sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png")))
    imgs = [np.asarray(Image.open(p).convert("RGB").resize((hw[1], hw[0])),
                       np.uint8) for p in paths]
    return paths, (np.stack(imgs) if imgs
                   else np.zeros((0, *hw, 3), np.uint8))


def caption_alexcap(args) -> dict:
    """{file name: caption} for every image of `args.images`."""
    device = resolve_device(args.device)
    vocab = load_vocab(args.dicts)
    cfg = configs.apply_overrides(configs.get_config(args.model_type),
                                  dict(kv.split("=", 1) for kv in args.set))
    # serving stores the encoder's weights in its compute dtype
    model = build_model(cfg.replace(param_dtype=cfg.compute_dtype),
                        vocab.vocab_size, args.seq_length,
                        device=device).eval()
    model.load_state_dict(load_alexcap_checkpoint(args.ckpt))
    return alexcap_captions(model, vocab, args.images, args.seq_length,
                            args.beam)


def alexcap_captions(model, vocab: Vocab, image_dir: str, seq_length: int,
                     beam: int = 1) -> dict:
    """{file name: caption} for every image of `image_dir`, from a served
    AlexCap model."""
    paths, images_u8 = _load_images(image_dir)
    if not paths:
        raise SystemExit(f"no images in {image_dir}")
    device = next(model.parameters()).device
    x = resnet_v2_preprocess(torch.from_numpy(images_u8).to(device))
    if beam > 1:
        toks = api.make_beam_fn(model, seq_length + 1, beam)(x).tokens[:, 0]
    else:
        toks = api.make_greedy_fn(model, seq_length + 1)(x)
    captions = vocab.decode_sequence(toks.cpu().numpy())
    return {os.path.basename(p): c for p, c in zip(paths, captions)}


def build_gt_model(cfg: DenseConfig, vocab_size: int, seq_length: int,
                   device: torch.device) -> GTDenseCaptioner:
    """The serving model for `cfg`, built on `device`, in eval mode, its
    weights stored in the compute dtype."""
    return dense_driver.build_gt_model(
        cfg.replace(param_dtype=cfg.compute_dtype), vocab_size, seq_length,
        device).eval()


def caption_dense(args) -> dict:
    device = resolve_device(args.device)
    vocab = load_vocab(args.dicts)
    cfg = apply_overrides(get_gt_config(), args.set)
    model = build_gt_model(cfg, vocab.vocab_size, args.seq_length, device)
    model.load_state_dict(load_gt_checkpoint(args.ckpt))
    return dense_captions(model, vocab, args.images, args.seq_length,
                          args.beam, args.max_regions)


def dense_captions(model: GTDenseCaptioner, vocab: Vocab, image_dir: str,
                   seq_length: int, beam: int = 1,
                   max_regions: int = 32) -> dict:
    """{file name: its resize and its regions' boxes and captions} for
    every image of `image_dir`, from a served GT model."""
    device = next(model.parameters()).device
    if beam > 1:
        beam_fn = api.make_region_beam_fn(model, seq_length + 1, beam)
        decode = lambda x, b: beam_fn(x, b).tokens[:, 0]
    else:
        decode = api.make_region_greedy_fn(model, seq_length + 1)

    paths = sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not paths:
        raise SystemExit(f"no images in {image_dir}")
    proc = ImageProcessor()
    rmax = max_regions
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
                            "vitb", "gt"],
                   help="an AlexCap family (lstm, lstm_attention, "
                        "transformer, vitb), or gt: the GT-box dense "
                        "captioner")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dicts", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--seq-length", type=int, default=16)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--max-regions", type=int, default=32,
                   help="region-slab budget per image")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides (must match the checkpoint), "
                        "e.g. use_lstm=true for an LSTM-head checkpoint")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    result = caption_dense(a) if a.model_type == "gt" else caption_alexcap(a)
    text = json.dumps(result, indent=2)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return result


if __name__ == "__main__":
    main()
