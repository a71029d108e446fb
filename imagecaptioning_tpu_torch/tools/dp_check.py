"""One rank of a data-parallel (or split) check: the train steps of a list
of cases on this rank's rows of each global batch, their parameters split
over the mesh's 'model' axis where a case says so → what they computed,
as `.npz`.

  RANK=r WORLD_SIZE=n python -m imagecaptioning_tpu_torch.tools.dp_check \\
      SPEC OUT_DIR INIT_METHOD

SPEC is a `torch.save`d list of cases (`run_case` says what a case
holds); each rank writes `OUT_DIR/<case>_w<n>_r<rank>.npz` (`compact`:
a tensor of more than `FULL_LIMIT` elements as two fixed random
projections), rank 0 the gradients and weights, the others a digest of
each (its fp64 sum and sum of squares, equal on every rank). A world of 1
gives the one-process reference (its reducer is the identity), so a
caller can hold a world of n against it: the losses and gradients are
global on every rank, the draws and the sampled indices are this rank's
rows. It runs on the CPU (gloo) and imports nothing but the port.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from imagecaptioning_tpu_torch.config import configs, dense_configs
from imagecaptioning_tpu_torch.models.captioners import build_model
from imagecaptioning_tpu_torch.parallel import mesh as meshlib
from imagecaptioning_tpu_torch.train import dense_driver as dd
from imagecaptioning_tpu_torch.train import optim
from imagecaptioning_tpu_torch.train.step import make_train_step
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils.weights import seeded_init_


class _Recorder:
    """Wraps a `DataParallel`'s draws and `reduce_grads` and an
    optimizer's `accumulate` to keep each draw (this rank's rows, with
    its batch axis), each applied update's gradients (summed over the
    ranks, before the clip, whole: `full` joins a split one's shards) and
    the data axis's collectives in its gradient reductions (from
    `Axis.calls`)."""

    def __init__(self, dp: meshlib.DataParallel, model, optimizer, full):
        self.draws: List[tuple] = []
        self.grads: List[Dict[str, np.ndarray]] = []
        self.reduces: List[int] = []
        window = [0]
        rand, bernoulli, reduce_grads, accumulate = (
            dp.rand, dp.bernoulli, dp.reduce_grads, optimizer.accumulate)

        def rec_rand(shape, generator=None, device=None, batch_axis=0):
            out = rand(shape, generator, device, batch_axis)
            self.draws.append((out.clone(), batch_axis))
            return out

        def rec_bernoulli(like, keep, generator=None, batch_axis=0):
            out = bernoulli(like, keep, generator, batch_axis)
            self.draws.append((out.clone(), batch_axis))
            return out

        def rec_reduce_grads(grads):
            before = sum(dp.calls.values())
            reduce_grads(grads)
            window[0] += sum(dp.calls.values()) - before

        def rec_accumulate():
            done = accumulate()
            if done:
                self.grads.append({n: full(p.grad).detach().clone().numpy()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None})
                self.reduces.append(window[0])
                window[0] = 0
            return done
        dp.rand, dp.bernoulli, dp.reduce_grads = (rec_rand, rec_bernoulli,
                                                  rec_reduce_grads)
        optimizer.accumulate = rec_accumulate


def _config(case):
    if case["kind"] == "alexcap":
        return configs.CaptionConfig(**case["cfg"])
    return dense_configs.DenseConfig(**case["cfg"])


@torch.no_grad()
def perturb_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Move the norms' scales and biases, BatchNorm's running statistics
    and the ViT's class token off their init (so that a check sees them)."""
    gen = torch.Generator().manual_seed(seed)
    norms = (torch.nn.LayerNorm, torch.nn.modules.batchnorm._BatchNorm)
    for m in model.modules():
        if isinstance(m, norms):
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0, 0.1, generator=gen)
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
        if hasattr(m, "class_token"):
            m.class_token.normal_(0, 0.1, generator=gen)
    return model


@torch.no_grad()
def initial_model(case: Dict) -> torch.nn.Module:
    """The case's model from `case["seed"]`: `seeded_init_`, then the
    AlexCap models' norms perturbed (`perturb_`) and the RPN's box heads
    moved off their zero init, so that the proposals move."""
    cfg = _config(case)
    dev = torch.device("cpu")
    if case["kind"] == "alexcap":
        model = build_model(cfg, case["vocab"], case["seq"], device=dev)
    elif case["kind"] == "gt":
        model = dd.build_gt_model(cfg, case["vocab"], case["seq"], dev)
    else:
        model = dd.build_rpn_model(cfg, case["vocab"], case["seq"], dev)
    seeded_init_(model, case["seed"])
    if case["kind"] == "alexcap":
        perturb_(model, case["seed"] + 1)
    elif case["kind"] == "rpn":
        gen = torch.Generator().manual_seed(case["seed"] + 1)
        for m, scale in ((model.rpn_trans, 0.05), (model.box_reg, 0.01)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * scale)
    return model


# seconds a resumed case waits for its checkpoint
RESUME_WAIT = 600


def _bits(t: np.ndarray) -> np.ndarray:
    """SHA-256 of an array's bytes: equal digests are equal bits."""
    return np.frombuffer(hashlib.sha256(
        np.ascontiguousarray(t).view(np.uint8)).digest(), np.uint8)


def run_case(case: Dict, mesh: meshlib.Mesh) -> Dict[str, np.ndarray]:
    """The case's steps on the rows of the mesh's data axis → {name:
    array}. A case holds:
    `kind` ("alexcap", "gt" or "rpn"), `cfg` (the config's fields),
    `vocab`, `seq`, `seed` (`initial_model`), `batches` (the global batch
    of each step: "images", "gt" for AlexCap; "images", "boxes",
    "labels", "mask" for the dense models), and optionally
    `frozen_until` (AlexCap: the steps with the encoder frozen),
    `teacher_prob` (GT, with `use_curriculum_learning`), `keys` (RPN: the
    sampler's global (positives', negatives') keys of each step),
    `no_dropout` (the VGG classifier's dropout off, as in eval mode),
    `f64` (the model and the images in fp64), `split` (AlexCap: the
    parameters split over the mesh's `'model'` axis by `shard_params`;
    `split_params` lists those that split), `exact` (a SHA-256 of each
    weight and statistic after the steps as `bits/state/<name>`, and of
    each tensor of the optimizer's state as
    `bits/moment/<parameter>/<key>`), `checkpoint` (a path) with
    `save_after` m (after m steps rank 0 writes the drivers'
    `train_state` there with `save_checkpoint`, and the run goes on) or
    with `resume_after` m (no steps of its own before m: it waits for the
    file, which another case or world writes, loads it into the model,
    optimizer and generator it built and takes the steps from m on) and,
    read by `main`, `mesh` (the mesh's shape and axis names, default all
    ranks on 'data'). `reduces/<u>` counts the data axis's collectives in
    the gradient reductions of applied update u."""
    cfg = _config(case)
    # a reducer of its own: the recorder wraps its draws and reductions
    dp = meshlib.DataParallel(mesh.data.index, mesh.data.size,
                              mesh.data.group, mesh.data.stage_on_host)
    model = initial_model(case)
    if case.get("f64"):
        model.double()
        for m in model.modules():
            if getattr(m, "compute_dtype", None) is not None:
                m.compute_dtype = torch.float64
    if case.get("no_dropout"):
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    full = (mesh.model.full if mesh.model is not None
            else (lambda t: t))
    out: Dict[str, np.ndarray] = {}
    if case.get("split"):
        meshlib.shard_params(model, mesh)
        out["split_params"] = np.array(sorted(
            n for n, p in model.named_parameters() if meshlib.is_split(p)))
    if case["kind"] == "alexcap":
        opt = optim.make_optimizer(cfg, model, case.get("total_steps", 8))
    else:
        opt = dd.make_dense_optimizer(cfg, model,
                                      case.get("finetune_start", 10))
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    rec = _Recorder(dp, model, opt, full)
    if case["kind"] == "alexcap":
        step = make_train_step(
            model, opt, gen,
            clip_norm=cfg.grad_clip_norm if cfg.clip_grad else None, dp=dp)
    elif case["kind"] == "gt":
        step = dd.make_gt_train_step(model, opt, cfg.use_curriculum_learning,
                                     gen, dp)
    else:
        step = dd.make_rpn_train_step(model, opt, gen, dp)
        sample = model.sample_regions
        samples = []

        def rec_sample(*a, **kw):
            s = sample(*a, **kw)
            samples.append((s.pos_idx.clone(), s.neg_idx.clone()))
            return s
        model.sample_regions = rec_sample
    first = case.get("resume_after", 0)
    if first:
        # `save_checkpoint` renames the file into place whole
        deadline = time.monotonic() + RESUME_WAIT
        while not os.path.exists(case["checkpoint"]):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no checkpoint {case['checkpoint']}")
            time.sleep(0.1)
        ckptlib.load_train_state(ckptlib.restore_checkpoint(
            case["checkpoint"], torch.device("cpu")), model, opt, gen)
    for i, batch in enumerate(case["batches"][first:], first):
        if i == case.get("save_after"):
            ckptlib.save_checkpoint(case["checkpoint"], ckptlib.train_state(
                model, opt, i, gen, 0))
            mesh.barrier()
        n = batch["images"].shape[0]
        rows = dp.rows(n)
        local = {k: (v[rows].double() if case.get("f64")
                     and v.is_floating_point() else v[rows])
                 for k, v in batch.items()}
        if case["kind"] == "alexcap":
            if "frozen_until" in case:
                model.freeze_encoder = i < case["frozen_until"]
            got = step(local["images"], local["gt"])
            out[f"loss/{i}"] = got["loss"].numpy()
            out[f"gnorm/{i}"] = got["grad_norm"].numpy()
        elif case["kind"] == "gt":
            got = step(local["images"], local["boxes"], local["labels"],
                       local["mask"], case.get("teacher_prob", 1.0))
            out[f"loss/{i}"] = got.numpy()
        else:
            keys = case.get("keys")
            keys = (None if keys is None else
                    tuple(k[rows] for k in keys[i]))
            got = step(local["images"], local["boxes"], local["mask"],
                       local["labels"], keys)
            for k, v in got.items():
                out[f"loss/{i}/{k}"] = v.numpy()
    for name, t in model.state_dict().items():
        out[f"state/{name}"] = full(t).detach().numpy()
    if case.get("exact"):
        for key in [k for k in out if k.startswith("state/")]:
            out[f"bits/{key}"] = _bits(out[key])
        names = {p: n for n, p in model.named_parameters()}
        for p, st in opt.state.items():
            for key, v in st.items():
                if torch.is_tensor(v):
                    out[f"bits/moment/{names[p]}/{key}"] = _bits(
                        full(v).detach().numpy())
    # a resumed run counts the updates before it too
    done = first // max(cfg.grad_accum_steps, 1)
    for u, grads in enumerate(rec.grads, done):
        for name, g in grads.items():
            out[f"grad/{u}/{name}"] = g
        out[f"reduces/{u}"] = np.asarray(rec.reduces[u - done])
    for j, (d, axis) in enumerate(rec.draws):
        out[f"draw/{j}"] = d.numpy()
        out[f"draw_axis/{j}"] = np.asarray(axis)
    if case["kind"] == "rpn":
        for i, (pos, neg) in enumerate(samples):
            out[f"sample/{i}/pos"] = pos.numpy()
            out[f"sample/{i}/neg"] = neg.numpy()
    return out


# larger tensors (the VGG classifier's fc6 and fc7, most of ResNet's
# convolutions) travel as projections
FULL_LIMIT = 1 << 16
KEPT = ("grad/", "state/", "proj/")


def projection_vectors(shape) -> tuple:
    """The fixed N(0, 1) vectors (over the trailing elements, over the
    leading axis) that `compact` projects a tensor of `shape` on."""
    rows, cols = shape[0], int(np.prod(shape[1:]))
    rng = np.random.RandomState(rows * 7919 + cols)
    return rng.randn(cols), rng.randn(rows)


def compact(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`out` with each gradient or weight of more than `FULL_LIMIT`
    elements replaced by `proj/<key>/rows` (the tensor, flattened to
    (leading, rest), times the first vector) and `proj/<key>/cols` (the
    second vector times it), in fp64."""
    res = {}
    for k, v in out.items():
        if k.startswith(("grad/", "state/")) and v.size > FULL_LIMIT:
            a = np.ascontiguousarray(v, np.float64).reshape(v.shape[0], -1)
            u, w = projection_vectors(v.shape)
            res[f"proj/{k}/rows"], res[f"proj/{k}/cols"] = a @ u, w @ a
        else:
            res[k] = v
    return res


def digest(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The gradients, weights and projections of `out` each as (fp64 sum,
    sum of squares); the rest as they are."""
    def two(v):
        v = np.ascontiguousarray(v, np.float64)
        return np.array([v.sum(), np.square(v).sum()])
    return {(f"digest/{k}" if k.startswith(KEPT) else k):
            (two(v) if k.startswith(KEPT) else v) for k, v in out.items()}


def main(argv=None) -> None:
    spec, out_dir, init_method = (argv or sys.argv[1:])[:3]
    meshlib.init_distributed("cpu", init_method=init_method)
    try:
        rank = torch.distributed.get_rank()
        world = torch.distributed.get_world_size()
        meshes = {}
        for case in torch.load(spec, weights_only=True):
            layout = tuple(map(tuple, case.get("mesh", ((-1,), ("data",)))))
            if layout not in meshes:
                meshes[layout] = meshlib.create_mesh(*layout)
            got = compact(run_case(case, meshes[layout]))
            np.savez(Path(out_dir) / f"{case['name']}_w{world}_r{rank}.npz",
                     **(got if rank == 0 else digest(got)))
    finally:
        meshlib.shutdown()


if __name__ == "__main__":
    main()
