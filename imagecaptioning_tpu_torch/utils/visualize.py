"""Visualization artifacts — copy of `imagecaptioning_tpu/utils/
visualize.py`: training curves, attention overlays and dense-caption box
drawings, matching the reference's outputs.

- `display_logs` ← `AlexCap/my_utils.py:20-35`: loss + METEOR curves
  over eval steps → PNG in the graphs dir; `display_loss_history` ←
  `net_utils.display_loss_history:96-106`.
- `generate_caption_vis` ← `AlexCap/generate_vis.py:11-85`: image +
  caption text, then a per-word grid of attention heatmaps — alpha
  reshaped to the patch grid (7×7 ResNet / 14×14 ViT, the ViT's class
  token dropped), bilinearly upsampled (`bilinear_upsample`,
  align_corners=True), grey colormap overlay, METEOR/BLEU in the output
  filename. `visualize_model_prediction` decodes a batch with the port's
  model and renders its first image.
- `densecap_draw` ← `DenseCap/vis_utils.py:29-89`: GT/predicted boxes +
  captions over the image with the WAD palette (PIL).

Everything but the decode is host-side numpy, matplotlib (Agg) and PIL,
each imported when a function needs it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

WAD_COLORS = np.array([
    [173, 35, 25],    # Red
    [42, 75, 215],    # Blue
    [87, 87, 87],     # Dark Gray
    [29, 105, 20],    # Green
    [129, 74, 25],    # Brown
    [129, 197, 122],  # Light green
    [157, 175, 255],  # Light blue
    [41, 208, 208],   # Cyan
    [255, 146, 51],   # Orange
    [255, 238, 51],   # Yellow
    [233, 222, 187],  # Tan
    [255, 205, 243],  # Pink
    [0, 0, 0],        # Black
], dtype=np.uint8)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def display_logs(results_history: Sequence[Dict], model_name: str,
                 out_dir: str = "runs/graphs",
                 save: bool = True) -> Optional[str]:
    """Loss + METEOR curves from a results-history list (the reference's
    `display_logs`; same two stacked axes)."""
    plt = _plt()
    losses = [o.get("loss_results") for o in results_history]
    meteor = [o.get("ap_results", {}).get("meteor", 0.0)
              for o in results_history]
    steps = [o.get("iter", i + 1) for i, o in enumerate(results_history)]

    fig, ax = plt.subplots(2, 1, sharex="col")
    ax[0].plot(steps, losses, "bo-")
    ax[0].set_ylabel("loss")
    ax[0].set_title(
        "Loss and METEOR score during training, on evaluation dataset")
    ax[1].plot(steps, meteor, "go-")
    ax[1].set_ylabel("METEOR")
    fig.text(.5, .04, "iter")
    path = None
    if save:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, model_name + ".png")
        fig.savefig(path)
    plt.close(fig)
    return path


def display_loss_history(loss_history: Sequence[Dict], out_path: str,
                         key: str = "loss") -> str:
    """Loss-vs-iteration curve from a loss-history list (reference
    `net_utils.display_loss_history:96-106`)."""
    plt = _plt()
    steps = [r.get("iter", i) for i, r in enumerate(loss_history)]
    losses = [r.get(key) for r in loss_history]
    fig, ax = plt.subplots()
    ax.plot(steps, losses, "b-")
    ax.set_xlabel("iter")
    ax.set_ylabel(key)
    ax.set_title("training loss")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def bilinear_upsample(grid: np.ndarray, scale: int) -> np.ndarray:
    """(h, w) → (h*scale, w*scale) bilinear with align_corners=True —
    the reference's F.interpolate call (`generate_vis.py:78`)."""
    h, w = grid.shape
    oh, ow = h * scale, w * scale
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    g = grid.astype(np.float64)
    return ((1 - wy) * (1 - wx) * g[np.ix_(y0, x0)]
            + (1 - wy) * wx * g[np.ix_(y0, x1)]
            + wy * (1 - wx) * g[np.ix_(y1, x0)]
            + wy * wx * g[np.ix_(y1, x1)])


def generate_caption_vis(image: np.ndarray, caption: str,
                         alphas: Optional[np.ndarray],
                         out_dir: str = "runs/vis_results",
                         name: str = "test",
                         grid_size: Optional[int] = None,
                         gt_caption: Optional[str] = None,
                         meteor: Optional[float] = None,
                         bleu: Optional[float] = None) -> List[str]:
    """image (H, W, 3) float [0,1] or uint8; alphas (T, P) per decoded
    word. Writes (1) the captioned image and (2) the per-word attention
    grid; returns the written paths."""
    plt = _plt()
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    words = caption.split()
    os.makedirs(out_dir, exist_ok=True)
    suffix = ""
    if meteor is not None and bleu is not None:
        suffix = f"_M{round(meteor * 100, 2)}_B{round(bleu * 100, 2)}"
    paths = []

    fig, ax = plt.subplots()
    ax.imshow(np.clip(image, 0, 1))
    ax.axis("off")
    txt = f"GT: {gt_caption}" if gt_caption is not None else f"PRED: {caption}"
    fig.text(0.5, 0.01, txt, wrap=True, horizontalalignment="center",
             fontsize=12)
    p1 = os.path.join(out_dir, f"{name}{suffix}.jpg")
    fig.savefig(p1)
    plt.close(fig)
    paths.append(p1)

    if alphas is not None and words:
        alphas = np.asarray(alphas)
        if grid_size is None:
            # infer patch grid from alpha width (drop ViT class token)
            p = alphas.shape[-1]
            g = int(round(np.sqrt(p)))
            if g * g != p and int(round(np.sqrt(p - 1))) ** 2 == p - 1:
                alphas = alphas[:, 1:]
                g = int(round(np.sqrt(p - 1)))
            grid_size = g
        scale = max(image.shape[0] // grid_size, 1)
        w = int(np.round(np.sqrt(len(words))))
        h = int(np.ceil(len(words) / max(w, 1)))
        fig = plt.figure()
        for idx, label in enumerate(words[:alphas.shape[0]]):
            ax = fig.add_subplot(w, h, idx + 1)
            ax.text(0, 1, label, backgroundcolor="white", fontsize=10)
            ax.text(0, 1, label, color="black", fontsize=10)
            ax.imshow(np.clip(image, 0, 1))
            heat = bilinear_upsample(
                alphas[idx].reshape(grid_size, grid_size), scale)
            ax.imshow(heat, alpha=0.8, cmap="Greys_r")
            ax.axis("off")
        p2 = os.path.join(out_dir, f"{name}_attention{suffix}.jpg")
        fig.savefig(p2)
        plt.close(fig)
        paths.append(p2)
    return paths


def visualize_model_prediction(model, images, vocab, seq_length: int,
                               gt_labels: Optional[np.ndarray] = None,
                               out_dir: str = "runs/vis_results",
                               name: str = "test") -> List[str]:
    """Greedy-decode one batch of preprocessed images (NHWC, on the
    model's device) with alphas and render the first image's overlay
    (the reference's `generate_caption_vis(model, data, path,
    use_dataset_img)` flow), METEOR and BLEU against `gt_labels` in the
    file names."""
    from imagecaptioning_tpu_torch.eval.scorer import score_captions
    from imagecaptioning_tpu_torch.models import api

    greedy = api.make_greedy_fn(model, seq_length + 1, collect_alphas=True)
    model.eval()
    toks, alphas = greedy(images)
    pred = vocab.decode_sequence(toks.cpu().numpy())[0]
    n_words = len(pred.split())
    a = alphas[0, :n_words].float().cpu().numpy()

    meteor = bleu = None
    gt_caption = None
    if gt_labels is not None:
        gt_caption = vocab.decode_sequence(np.asarray(gt_labels))[0]
        blob = score_captions([{"candidate": pred,
                                "references": [gt_caption]}])
        meteor, bleu = blob["meteor"], blob["bleu"]

    img = images[0].float().cpu().numpy()
    return generate_caption_vis(img, pred, a, out_dir=out_dir, name=name,
                                gt_caption=gt_caption, meteor=meteor,
                                bleu=bleu)


def densecap_draw(image: np.ndarray, boxes_xcycwh: np.ndarray,
                  captions: Sequence[str],
                  out_path: Optional[str] = None,
                  box_width: int = 2) -> np.ndarray:
    """Draw boxes + caption labels with the WAD palette onto a copy of
    the image (reference `vis_utils.densecap_draw`). image uint8
    (H, W, 3); boxes (N, 4) xcycwh. Returns the drawn array."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.ascontiguousarray(image))
    draw = ImageDraw.Draw(img)
    h, w = image.shape[0], image.shape[1]
    for i, box in enumerate(np.asarray(boxes_xcycwh)):
        xc, yc, bw, bh = box
        x1 = float(np.clip(xc - (bw - 1) / 2, 0, w - 1))
        y1 = float(np.clip(yc - (bh - 1) / 2, 0, h - 1))
        x2 = float(np.clip(xc + (bw - 1) / 2, 0, w - 1))
        y2 = float(np.clip(yc + (bh - 1) / 2, 0, h - 1))
        color = tuple(int(c) for c in WAD_COLORS[i % (len(WAD_COLORS) - 1)])
        draw.rectangle([x1, y1, x2, y2], outline=color, width=box_width)
        if i < len(captions):
            draw.text((x1 + 2, max(y1 - 10, 0)), captions[i], fill=color)
    out = np.asarray(img)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        img.save(out_path)
    return out
