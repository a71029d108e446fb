"""Compile-and-run checks of the port — counterpart of the JAX package's
`__graft_entry__.py` (`entry`, `dryrun_multichip`).

`entry()` returns the forward-loss step of the flagship model, the ViT-B/16
captioner (the reference's heaviest family, `train_ViTB.py`), with its
arguments. `dryrun_multichip(n)` starts n processes, a process group over
them and a mesh over ('data', 'model') of (n/2, 2) where n is even, (n,
1) where it is odd, as the JAX dry run lays out its devices. The ranks
run where `route` puts them: one card each under NCCL where there are n
cards; sharing the cards round-robin under gloo where there are fewer
(on a one-card machine both ranks of `multichip 2` run on `cuda:0`); on
the CPU under gloo only when the caller passes `device="cpu"`. Without a
card and without `device="cpu"` it raises, as the JAX dry run asserts
its device count. Then one train step
on each rank for five families at tiny shapes: the ViT captioner, the
Transformer captioner and the attention-LSTM over a ResNet trunk
(BatchNorm's statistics over the global batch), their parameters split
over `'model'` by `parallel.mesh.shard_params` (the JAX package's
`PARTITION_RULES`), the batch over `'data'`; then the GT dense step (VGG
trunk → ROI pooling → LSTM head) and the full RPN step (anchors → sampler
→ ROI pooling → the five losses), data-parallel, their parameters
replicated over `'model'` as JAX's dry run leaves them. Rank 0 prints how
many parameters each split step holds as DTensor shards, then the JAX
package's line with the mesh and the global losses. `rank_steps` runs the
same on the ranks of a process group that exists already (on one card
under gloo, say).

  python -m imagecaptioning_tpu_torch.dryrun [multichip [n] [--device cpu]]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def entry(device=None, **overrides):
    """(fn, (model, images, gt)): `fn(model, images, gt)` is the eval-mode
    caption loss of the ViT-B/16 captioner (vocabulary 512, 16 tokens,
    batch 4, bf16, seeded weights). `overrides` replace config fields
    (e.g. `vit_dims` and widths, to shrink it)."""
    from imagecaptioning_tpu_torch.config.configs import get_vitb_config
    from imagecaptioning_tpu_torch.models.api import make_forward_fn
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.utils.platform import resolve_device
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    dev = resolve_device(device)
    b, t, v = 4, 16, 512
    cfg = get_vitb_config().replace(**{
        "embedding_size": 768, "num_layers": 6, "num_heads": 8,
        "use_dropout": False, "compute_dtype": "bfloat16", **overrides})
    model = seeded_init_(build_model(cfg, v, t, device=dev), 0).eval()
    size = cfg.vit_dims[0] if cfg.vit_dims else 224
    gen = torch.Generator(dev).manual_seed(0)
    images = torch.rand((b, size, size, 3), generator=gen, device=dev)
    gt = torch.randint(1, v + 1, (b, t), generator=gen, device=dev)
    forward = make_forward_fn(model)

    @torch.no_grad()
    def fn(model, images, gt):
        return forward(images, gt, train=False)[0]
    return fn, (model, images, gt)


# ----------------------------------------------------- one rank's steps

def _captioner_loss(mesh, dev, cfg, images, gt) -> Tuple[float, int, int]:
    """One train step of a captioner family, its parameters split over the
    mesh's `'model'` axis and its batch over `'data'` → (loss, the
    parameters that are DTensor shards, all parameters)."""
    from imagecaptioning_tpu_torch.models.captioners import build_model
    from imagecaptioning_tpu_torch.parallel import mesh as meshlib
    from imagecaptioning_tpu_torch.train import optim
    from imagecaptioning_tpu_torch.train.step import make_train_step
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    model = seeded_init_(build_model(cfg, 64, gt.shape[1], device=dev), 0)
    meshlib.shard_params(model, mesh)
    params = list(model.parameters())
    opt = optim.make_optimizer(cfg, model, 100)
    gen = torch.Generator(dev).manual_seed(cfg.seed + 1)
    step = make_train_step(model, opt, gen, clip_norm=cfg.grad_clip_norm,
                           dp=mesh.data)
    rows = mesh.data.rows(images.shape[0])
    out = step(torch.from_numpy(images[rows]).to(dev),
               torch.from_numpy(gt[rows]).to(dev))
    return (float(out["loss"]), sum(map(meshlib.is_split, params)),
            len(params))


def _dense_inputs(b, r, v, t, labels_below):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, size=(b, 64, 64, 3), dtype=np.uint8)
    wh = rng.uniform(8, 24, size=(b, r, 2))
    cxy = rng.uniform(16, 48, size=(b, r, 2))
    boxes = np.concatenate([cxy, wh], -1).astype(np.float32)
    labels = rng.randint(1, labels_below, size=(b, r, t)).astype(np.int64)
    return images, boxes, labels, np.ones((b, r), np.float32)


def _dense_loss(mesh, dev, kind: str, n: int) -> float:
    """One data-parallel GT dense ("gt") or RPN ("rpn") step at batch n."""
    from imagecaptioning_tpu_torch.config.dense_configs import (
        get_densecap_config, get_gt_config)
    from imagecaptioning_tpu_torch.train import dense_driver as dd
    from imagecaptioning_tpu_torch.utils.weights import seeded_init_

    b, r, v, t = n, 3, 32, 6
    base = get_gt_config() if kind == "gt" else get_densecap_config()
    cfg = base.replace(batch_size=b, max_regions=r, use_lstm=True,
                       rnn_size=32, input_encoding_size=32, vgg_stages=2,
                       sampler_batch_size=16, compute_dtype="float32")
    build = dd.build_gt_model if kind == "gt" else dd.build_rpn_model
    model = seeded_init_(build(cfg, v, t, dev), 0)
    opt = dd.make_dense_optimizer(cfg, model, 10)
    gen = torch.Generator(dev).manual_seed(cfg.seed + 1)
    images, boxes, labels, mask = _dense_inputs(
        b, r, v, t, v + 1 if kind == "gt" else v - 2)
    rows = mesh.data.rows(b)
    x, bx, lb, m = (torch.from_numpy(a[rows]).to(dev)
                    for a in (images, boxes, labels, mask))
    if kind == "gt":
        step = dd.make_gt_train_step(model, opt, False, gen, mesh.data)
        return float(step(x, bx, lb, m, 1.0))
    step = dd.make_rpn_train_step(model, opt, gen, mesh.data)
    losses = step(x, bx, m, lb)
    if not all(np.isfinite(float(val)) for val in losses.values()):
        raise FloatingPointError(f"rpn losses {losses}")
    return float(losses["captioning"])


def rank_steps(n: int, dev) -> List[str]:
    """The five families' steps on this rank of a process group of n ranks
    (every rank calls it) → rank 0's lines (empty on the others)."""
    from imagecaptioning_tpu_torch.config.configs import (
        get_lstm_attention_config, get_transformer_config, get_vitb_config)
    from imagecaptioning_tpu_torch.parallel import mesh as meshlib

    tp = 2 if n % 2 == 0 else 1
    mesh = meshlib.create_mesh((n // tp, tp), ("data", "model"), dev)
    b, t, v = n * 2, 8, 64
    rng = np.random.RandomState(0)
    gt = rng.randint(1, v + 1, size=(b, t)).astype(np.int64)
    common = dict(batch_size=b, clip_grad=True, use_dropout=True,
                  drop_value=0.1, compute_dtype="float32")
    vit_imgs = rng.rand(b, 32, 32, 3).astype(np.float32)
    cnn_imgs = rng.rand(b, 64, 64, 3).astype(np.float32)
    steps = {
        "vitb": (get_vitb_config().replace(
            embedding_size=32, num_layers=2, num_heads=4,
            vit_dims=(32, 16, 2, 4, 32, 64), **common), vit_imgs),
        "transformer": (get_transformer_config().replace(
            transformer_size=32, num_layers=2, num_heads=4,
            backbone_stages=(1, 1, 1, 1), **common), cnn_imgs),
        "attention_lstm": (get_lstm_attention_config().replace(
            embedding_size=32, lstm_size=32, backbone_stages=(1, 1, 1, 1),
            **common), cnn_imgs)}
    losses: Dict[str, float] = {}
    split: Dict[str, str] = {}
    for name, (cfg, images) in steps.items():
        losses[name], k, total = _captioner_loss(mesh, dev, cfg, images, gt)
        split[name] = f"{k}/{total}"
    losses["gt_dense"] = _dense_loss(mesh, dev, "gt", n)
    losses["rpn"] = _dense_loss(mesh, dev, "rpn", n)
    if not all(np.isfinite(v) for v in losses.values()):
        raise FloatingPointError(f"dryrun losses {losses}")
    if not meshlib.is_writer():
        return []
    return [f"dryrun_multichip({n}): parameters split over 'model' "
            "(DTensor shards/all): "
            + " ".join(f"{k}={val}" for k, val in split.items()),
            f"dryrun_multichip({n}): mesh={mesh.shape} "
            + " ".join(f"{k}_loss={val:.4f}" for k, val in losses.items())
            + " OK"]


def _rank_main(n: int, init_method: str, device: str,
               backend: str) -> None:
    """One rank of `dryrun_multichip`: `rank_steps`; rank 0 prints its
    lines."""
    from imagecaptioning_tpu_torch.parallel import mesh as meshlib

    dev = meshlib.init_distributed(device, backend=backend,
                                   init_method=init_method)
    try:
        for line in rank_steps(n, dev):
            print(line, flush=True)
    finally:
        meshlib.shutdown()


def route(n_devices: int, device: Optional[str] = None
          ) -> Tuple[List[str], str, str]:
    """Where the dry run's ranks run → (each rank's device, the backend, a
    line naming the route). `device` None or "cuda": one card a rank under
    NCCL where there are `n_devices` cards or more; on fewer cards every
    rank on `cuda:{rank % count}` under gloo (collectives staged through
    the host, as `parallel.mesh` does on a shared card); raises where there
    is no card. `device="cpu"`: every rank on the CPU under gloo."""
    if device == "cpu":
        return ["cpu"] * n_devices, "gloo", (
            f"route: {n_devices} ranks on the CPU, gloo (device='cpu')")
    if device not in (None, "cuda"):
        raise ValueError(f"device must be None, 'cuda' or 'cpu', got "
                         f"{device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs a CUDA card and CUDA is "
            "not available; pass device='cpu' to run on the CPU")
    count = torch.cuda.device_count()
    devices = [f"cuda:{rank % count}" for rank in range(n_devices)]
    if count >= n_devices:
        return devices, "nccl", (
            f"route: {n_devices} ranks on {n_devices} cards, nccl")
    return devices, "gloo", (
        f"route: {n_devices} ranks sharing {count} card(s) "
        f"({', '.join(devices)}), gloo")


def dryrun_lines(n_devices: int, timeout: float = 600.0,
                 device: Optional[str] = None) -> List[str]:
    """Run `_rank_main` in `n_devices` processes on `route`'s devices →
    rank 0's lines (also printed, after the route's line). Raises if a
    process fails."""
    devices, backend, line = route(n_devices, device)
    print(f"dryrun_multichip({n_devices}): {line}", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = []
        for rank, dev in enumerate(devices):
            env = {"OMP_NUM_THREADS": "2", **os.environ, "RANK": str(rank),
                   "WORLD_SIZE": str(n_devices), "LOCAL_RANK": str(rank),
                   "PYTHONPATH": os.pathsep.join(
                       [root, os.environ.get("PYTHONPATH", "")])}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "imagecaptioning_tpu_torch.dryrun",
                 "rank", str(n_devices), init, dev, backend],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [(r, p.returncode, err[-2000:])
              for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed: {failed}")
    lines = outs[0][0].strip().splitlines()
    print("\n".join(lines))
    return lines


def dryrun_multichip(n_devices: int, timeout: float = 600.0,
                     device: Optional[str] = None) -> str:
    """`dryrun_lines` → the last line, the JAX package's."""
    return dryrun_lines(n_devices, timeout, device)[-1]


def main(argv: Optional[List[str]] = None) -> None:
    """`[multichip [n] [--device cpu|cuda]]`, or one rank of it (`rank n
    init device backend`, as `dryrun_lines` starts them); nothing: run
    `entry()` on the card."""
    import argparse

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["rank"]:
        _rank_main(int(argv[1]), argv[2], argv[3], argv[4])
        return
    p = argparse.ArgumentParser(prog="python -m "
                                "imagecaptioning_tpu_torch.dryrun")
    p.add_argument("mode", nargs="?", choices=("multichip",))
    p.add_argument("n", nargs="?", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cpu: every rank on the CPU (gloo); default: the "
                   "cards, raising where there is none")
    args = p.parse_args(argv)
    if args.mode == "multichip":
        dryrun_multichip(args.n, device=args.device)
    else:
        fn, fargs = entry(args.device)
        print("entry() ran; loss =", float(fn(*fargs)))


if __name__ == "__main__":
    main()
