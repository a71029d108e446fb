"""The port's data-parallel training (`parallel/mesh.py` and the sharded
steps of every trainer) on the CPU: a world of 2 processes under gloo,
each on its rows of the global batch, at tiny sizes.

One world of 2 runs every port-side case (`tools/dp_check.py`, which
imports only the port; rendezvous through a file under `tmp_path`), while
this process computes the references:

- JAX parity, the setups of `tests/test_parallel.py` (dropout off, the
  RPN sampler's keys injected): the AlexCap LSTM and attention-LSTM
  across the frozen → finetune boundary (3 steps, BatchNorm in training
  mode once the trunk trains), the Transformer, the GT dense step and the
  RPN step, each against the JAX package's single-device step. Each loss
  within 1e-4 relative; each gradient before the update within 1e-4 of
  its tensor's largest element (the attention's score weights are held in
  fp64 by `test_torch_alexcap_families_train.py`: in fp32 their
  gradients cancel over positions); the weights within 2·lr of JAX's
  after each applied update (Adam's first step moves a weight whose
  gradient is within rounding of zero by up to lr either way); BatchNorm's
  running statistics within rtol 1e-3, atol 1e-5.
- World-size invariance with dropout and the sampler on: the same five
  steps on 2 ranks against the port's own one-process step:
  every draw identical (the dropout masks, the teacher-forcing uniforms,
  the sampler's keys), the sampled proposals identical, the losses and
  gradients within 1e-5 of their tensor's largest element (plus 1e-7),
  the weights and statistics after the steps as close.
- `grad_accum_steps` 2 on 2 ranks against 2 on one process (AlexCap
  LSTM, GT, RPN), each micro-step's gradient norm included, and the LSTM
  against JAX's step sharded over a 2-device 'data' mesh at k = 2; a
  checkpoint that rank 0 writes mid-window through the drivers'
  `train_state` / `save_checkpoint`, resumed by the world of 2 (bitwise
  the unbroken run) and by one process (the world-size gate); the
  gradient all-reduces of each applied update (`Axis.calls`: k on 2
  ranks); a rank whose every region is masked; `mesh_for_batch`'s cap as
  a pure function against JAX's; `dryrun_multichip(2)`.

The ResNet families are held in fp64 on both sides: with BatchNorm in
training mode over 4 images of 64², fp32 rounding moves their trunk
gradients by up to a few percent between two runs that differ only in
the CPU threads' reduction order, where fp64 agrees to 1e-14. The GT and
RPN models run in fp32.
"""

import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecaptioning_tpu.config import configs as jax_configs
from imagecaptioning_tpu.config import dense_configs as jax_dense_configs
from imagecaptioning_tpu.data.vg_loader import normalize_images as jax_norm
from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.parallel import mesh as jax_mesh
from imagecaptioning_tpu.train import dense_driver as jax_driver
from imagecaptioning_tpu.train import optim as jax_optim
from imagecaptioning_tpu.train import step as jax_step
from imagecaptioning_tpu.utils import torch_port as jax_torch_port
from imagecaptioning_tpu_torch import dryrun
from imagecaptioning_tpu_torch.config import configs, dense_configs
from imagecaptioning_tpu_torch.parallel import mesh as meshlib
from imagecaptioning_tpu_torch.tools import dp_check
from imagecaptioning_tpu_torch.utils.weights import (
    captioner_state_dict_from_jax, gt_state_dict_from_jax,
    rpn_state_dict_from_jax)
from test_torch_alexcap_families import jax_model, reference_layout
from test_torch_rpn import jax_keys
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
VOCAB, SEQ = 20, 6
STAGES = (1, 1, 1, 1)
JAX_PARITY = ["lstm", "lstm_attention", "transformer", "gt", "rpn"]
SCORE_WEIGHTS = ("llm.attention.W.", "llm.attention.U.", "llm.attention.v.")
INVARIANCE_REL, INVARIANCE_ABS = 1e-5, 1e-7
# the micro-step after which the world of 2 writes a checkpoint (k = 2)
RESUME_AFTER = {"lstm": 3, "gt": 1}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ------------------------------------------------------------- the cases

def _alexcap_cfg(family, dropout):
    widths = ({"transformer_size": 32, "num_layers": 1, "num_heads": 4}
              if family == "transformer" else
              {"embedding_size": 16, "lstm_size": 16})
    return configs.get_config(family).replace(
        backbone_stages=STAGES, compute_dtype="float32", batch_size=4,
        clip_grad=True, use_dropout=dropout, drop_value=0.5, **widths)


def _alexcap_case(family, dropout, name, accum=1, steps=3):
    """4 images a step (2 a rank); the LSTM families frozen for 2 steps
    then finetuned, the Transformer's trunk training from the start."""
    cfg = _alexcap_cfg(family, dropout).replace(grad_accum_steps=accum)
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(steps):
        gt = rng.randint(1, VOCAB + 1, (4, SEQ)).astype(np.int64)
        gt[1, 3:] = 0
        batches.append({"images": rng.randn(4, 64, 64, 3).astype(np.float32),
                        "gt": gt})
    case = {"name": name, "kind": "alexcap", "cfg": cfg.to_dict(),
            "vocab": VOCAB, "seq": SEQ, "seed": 3,
            "batches": [_t(b) for b in batches], "total_steps": 8}
    if family != "transformer" and accum == 1:
        case["frozen_until"] = 2
    case["f64"] = True
    return case, batches


def _dense_cfg(kind, dropout):
    base = (dense_configs.get_gt_config() if kind == "gt"
            else dense_configs.get_densecap_config())
    extra = ({"sampler_batch_size": 16, "anchor_sizes": (8.0, 16.0, 32.0)}
             if kind == "rpn" else {})
    return base.replace(batch_size=4, max_regions=3, use_lstm=True,
                        rnn_size=16, input_encoding_size=16, vgg_stages=2,
                        compute_dtype="float32", use_dropout=dropout,
                        use_curriculum_learning=dropout and kind == "gt",
                        **extra)


def _jax_dense_cfg(cfg):
    return jax_dense_configs.DenseConfig(**{
        k: v for k, v in cfg.to_dict().items()
        if k not in ("backend", "device")})


def _dense_batches(kind, steps=1, masked_rows=()):
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(steps):
        wh = rng.uniform(6, 16, (4, 3, 2))
        cxy = rng.uniform(10, 22, (4, 3, 2))
        labels = rng.randint(1, VOCAB - 2, (4, 3, SEQ)).astype(np.int64)
        labels[0, 1, 3:] = 0
        mask = np.ones((4, 3), np.float32)
        mask[1, 2] = 0.0
        mask[list(masked_rows)] = 0.0
        batches.append({
            "images": rng.randint(0, 256, (4, 32, 32, 3), dtype=np.uint8),
            "boxes": np.concatenate([cxy, wh], -1).astype(np.float32),
            "labels": labels, "mask": mask})
    return batches


def _num_anchors(cfg, size=32):
    side = size // 2 ** cfg.vgg_stages
    return side * side * len(cfg.anchor_sizes) * len(cfg.anchor_ratios)


def _dense_case(kind, dropout, name, steps=1, accum=1, masked_rows=(),
                jax_keys_rng=None, **cfg_fields):
    cfg = _dense_cfg(kind, dropout).replace(grad_accum_steps=accum,
                                            **cfg_fields)
    batches = _dense_batches(kind, steps, masked_rows)
    case = {"name": name, "kind": kind, "cfg": cfg.to_dict(),
            "vocab": VOCAB, "seq": SEQ, "seed": 4,
            "batches": [_t(b) for b in batches], "finetune_start": 10,
            "no_dropout": not dropout, "teacher_prob": 0.5}
    if jax_keys_rng is not None:
        case["keys"] = [jax_keys(jax_keys_rng, 4, _num_anchors(cfg))]
    return case, batches


def _build_cases(tmp):
    """{name: (case, what the JAX reference needs)}; the resume cases
    write their checkpoints under `tmp`."""
    cases = {}
    # first in the world of 2, which writes their checkpoints mid-window
    # (the LSTM's in its second window of 2, with Adam's moments; the
    # GT's, whose 4096-wide classifier makes a large file and a slow
    # step, in its only one, over one VGG stage) for the resume cases,
    # last in each world
    for kind, at in RESUME_AFTER.items():
        case, batches = (
            _alexcap_case("lstm", True, "accum_lstm", accum=2, steps=4)
            if kind == "lstm" else
            _dense_case("gt", True, "accum_gt", steps=2, accum=2,
                        vgg_stages=1))
        case.update(exact=True, checkpoint=str(tmp / f"{kind}.ckpt"),
                    save_after=at)
        cases[f"accum_{kind}"] = case, batches
    for fam in ("lstm", "lstm_attention", "transformer"):
        steps = 1 if fam == "transformer" else 3
        cases[f"jax_{fam}"] = _alexcap_case(fam, False, f"jax_{fam}",
                                            steps=steps)
        cases[f"inv_{fam}"] = _alexcap_case(fam, True, f"inv_{fam}",
                                            steps=steps)
    cases["jax_gt"] = _dense_case("gt", False, "jax_gt")
    cases["inv_gt"] = _dense_case("gt", True, "inv_gt", steps=2)
    cases["jax_rpn"] = _dense_case("rpn", False, "jax_rpn",
                                   jax_keys_rng=jax.random.PRNGKey(7))
    cases["inv_rpn"] = _dense_case("rpn", True, "inv_rpn", steps=2)
    # the trunk frozen (a frozen model's step, JAX's gate closed)
    case, batches = _alexcap_case("lstm", False, "jax_accum_lstm", accum=2,
                                  steps=4)
    cases["jax_accum_lstm"] = {**case, "frozen_until": 4}, batches
    cases["accum_rpn"] = _dense_case("rpn", True, "accum_rpn", steps=2,
                                     accum=2)
    cases["masked_gt"] = _dense_case("gt", True, "masked_gt",
                                     masked_rows=(2, 3))
    # the world of 2 as ('data', 'model') = (1, 2): both ranks take the
    # whole batch, as JAX's replicated parameters over 'model' do
    case, batches = _dense_case("gt", True, "model_gt", steps=2)
    case["mesh"] = ((-1, 2), ("data", "model"))
    cases["model_gt"] = case, batches
    # the window's last micro-step from the world of 2's checkpoint: the
    # optimizer's state, the window's mean and the generator in the file
    for kind, at in RESUME_AFTER.items():
        case, batches = cases[f"accum_{kind}"]
        cases[f"resume_{kind}"] = {
            **{k: v for k, v in case.items() if k != "save_after"},
            "name": f"resume_{kind}", "resume_after": at}, batches
    return cases


# ------------------------------------------------------- JAX references

def _port_names(tree, kind="alexcap", stats=None):
    """A JAX parameter tree (and BatchNorm statistics) → {the port's name:
    array}."""
    if kind == "alexcap":
        sd = captioner_state_dict_from_jax(_np(tree), stats or None)
    else:
        sd = (gt_state_dict_from_jax if kind == "gt"
              else rpn_state_dict_from_jax)(_np(tree))
    return {k: t.numpy() for k, t in sd.items()}


def _jax_params_from_port(case, jm, batch, sd):
    """The port's dense state dict `sd` as the JAX model's parameters: the
    JAX → port converter only moves elements, so it is run on element
    codes (which leaf, and the index in it, exact in fp32) to learn where
    each element goes, then inverted."""
    kind = case["kind"]
    x = jax_norm(jnp.asarray(batch["images"]))
    labels = jnp.asarray(batch["labels"], jnp.int32)
    args = ((x, jnp.asarray(batch["boxes"]), labels) if kind == "gt" else
            (x, jnp.asarray(batch["boxes"]), jnp.asarray(batch["mask"]),
             labels))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(partial(jm.init, train=False),
                            {"params": k, "dropout": k, "sampling": k},
                            *args)["params"]
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    convert = gt_state_dict_from_jax if kind == "gt" else \
        rpn_state_dict_from_jax

    def coded(code):
        return {n: t.numpy().astype(np.int64) for n, t in convert(
            treedef.unflatten([code(i, leaf) for i, leaf in
                               enumerate(leaves)])).items()}
    which = coded(lambda i, leaf: np.full(leaf.shape, i, np.float32))
    lo = coded(lambda i, leaf: (np.arange(leaf.size) % 4096).reshape(
        leaf.shape).astype(np.float32))
    hi = coded(lambda i, leaf: (np.arange(leaf.size) // 4096).reshape(
        leaf.shape).astype(np.float32))
    out = [np.zeros(leaf.shape, np.float32) for leaf in leaves]
    for name, t in sd.items():
        i = np.unique(which[name])
        assert i.size == 1, name
        out[int(i[0])].reshape(-1)[(hi[name] * 4096 + lo[name]).ravel()] = \
            t.numpy().ravel()
    return treedef.unflatten(out)


def _jax_alexcap(case, batches):
    """JAX's single-device steps → ([(loss, grads)] a step, the params and
    statistics after the last, lr), in the port's names."""
    cfg = configs.CaptionConfig(**case["cfg"])
    pm = dp_check.initial_model(case)
    variables, _ = jax_torch_port.convert_reference_captioner(
        reference_layout(pm.state_dict()), vit_heads=12)
    with jax.enable_x64(True):
        return _jax_alexcap_f64(case, cfg, variables, batches)


def _jax_alexcap_f64(case, cfg, variables, batches):
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             variables)
    frozen_until = case.get("frozen_until", 0)
    jcfg = jax_configs.get_config(cfg.model_type).replace(
        **{k: getattr(cfg, k) for k in (
            "use_scheduler", "num_epochs", "learning_rate", "min_lr", "eps",
            "weight_decay", "finetune_cnn", "trained_encoder", "clip_grad",
            "grad_clip_norm", "beta1", "beta2")})
    tx = jax_optim.make_optimizer(jcfg, case["total_steps"], frozen_until)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    opt_state = tx.init(params)

    def make(model):
        def step(params, stats, opt_state, x, gt):
            def loss_fn(p):
                v = {"params": p, **({"batch_stats": stats} if stats
                                     else {})}
                out, new_stats = jax_api.apply_train(model, v, x, gt)
                return model.loss(out, gt), new_stats
            (loss, new_stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            upd, opt_state = tx.update(grads, opt_state, params)
            return (loss, grads, optax.apply_updates(params, upd),
                    new_stats if stats else stats, opt_state)
        return jax.jit(step)
    def f64(model):       # a rolled scan: the unrolled one compiles slowly
        rolled = {"scan_unroll": 1} if hasattr(model, "scan_unroll") else {}
        return model.clone(compute_dtype=jnp.float64, **rolled)
    steps = {False: make(f64(jax_model(cfg, VOCAB, SEQ)))}
    if frozen_until:
        steps[True] = make(f64(jax_model(cfg, VOCAB, SEQ,
                                         freeze_encoder=True)))
    out = []
    for i, b in enumerate(batches):
        loss, grads, params, stats, opt_state = steps[i < frozen_until](
            params, stats, opt_state, jnp.asarray(b["images"], jnp.float64),
            jnp.asarray(b["gt"], jnp.int32))
        out.append((float(loss), _port_names(grads, stats=_np(stats))))
    return (out, _port_names(params, stats=_np(stats)), cfg.learning_rate)


def _jax_dense(case, batches):
    """JAX's single-device step of the GT or RPN model (eval-mode forward,
    so no dropout; the RPN's keys from the case's key) → ([(losses,
    grads)], params after the update, lr), in the port's names."""
    kind = case["kind"]
    jcfg = _jax_dense_cfg(dense_configs.DenseConfig(**case["cfg"]))
    jm = (jax_driver.build_gt_model if kind == "gt" else
          jax_driver.build_rpn_model)(jcfg, vocab_size=VOCAB,
                                      seq_length=SEQ)
    params = _jax_params_from_port(case, jm, batches[0],
                                   dp_check.initial_model(case).state_dict())
    tx = jax_driver.make_dense_optimizer(jcfg, case["finetune_start"])
    b = batches[0]
    x = jax_norm(jnp.asarray(b["images"]))
    boxes, mask = jnp.asarray(b["boxes"]), jnp.asarray(b["mask"])
    labels = jnp.asarray(b["labels"], jnp.int32)
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        if kind == "gt":
            out = jm.apply({"params": p}, x, boxes, labels, train=False)
            loss = jm.loss(out, labels, mask)
            return loss, {"loss": loss}
        d = jm.apply({"params": p}, x, boxes, mask, labels, rng=rng,
                     train=False)
        return d["total"], d

    @jax.jit
    def step(params):
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        upd, _ = tx.update(grads, tx.init(params), params)
        return losses, grads, optax.apply_updates(params, upd)
    losses, grads, new = step(jax.tree.map(jnp.asarray, params))
    return ([({k: float(v) for k, v in losses.items()},
              _port_names(grads, kind))], _port_names(new, kind),
            jcfg.learning_rate)


def jax_sharded_steps(case, batches, mesh, vocab, seq):
    """JAX's sharded steps of an AlexCap case in fp64: `make_train_step`'s
    step, which also returns the gradients, jitted by `shard_train_step`
    over `mesh` with the parameters placed by `infer_param_shardings` and
    the batch over 'data'; the optimizer `make_optimizer`'s,
    `grad_accum_steps` = k wrapping it in optax's `MultiSteps`, its gate
    at the case's `frozen_until` micro-steps (a window's edge), until
    which the frozen model's step runs → ([(loss, grad_norm, grads)] a
    micro-step, the params and statistics after the last, lr), in the
    port's names."""
    cfg = configs.CaptionConfig(**case["cfg"])
    pm = dp_check.initial_model(case)
    variables, _ = jax_torch_port.convert_reference_captioner(
        reference_layout(pm.state_dict()),
        vit_heads=cfg.vit_dims[3] if cfg.vit_dims else 12)
    with jax.enable_x64(True):
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 variables)
        jcfg = jax_configs.get_config(cfg.model_type).replace(
            **{k: getattr(cfg, k) for k in (
                "use_scheduler", "num_epochs", "learning_rate", "min_lr",
                "eps", "weight_decay", "finetune_cnn", "trained_encoder",
                "clip_grad", "grad_clip_norm", "beta1", "beta2",
                "grad_accum_steps")})
        frozen_until = case.get("frozen_until", 0)
        tx = jax_optim.make_optimizer(jcfg, case["total_steps"],
                                      frozen_until // cfg.grad_accum_steps)

        def make(frozen):
            model = jax_model(cfg, vocab, seq, freeze_encoder=frozen)
            model = model.clone(compute_dtype=jnp.float64, **(
                {"scan_unroll": 1} if hasattr(model, "scan_unroll") else {}))
            return partial(train_step, model)

        def train_step(model, state, images, gt):
            def loss_fn(p):
                v = {"params": p, **({"batch_stats": state.batch_stats}
                                     if state.batch_stats else {})}
                out, new_stats = jax_api.apply_train(model, v, images, gt)
                return model.loss(out, gt), new_stats
            (loss, new_stats), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            state = jax_step.TrainState(
                state.step + 1, optax.apply_updates(state.params, updates),
                opt_state, new_stats if state.batch_stats
                else state.batch_stats, state.rng)
            return state, {"loss": loss, "grad_norm": optax.global_norm(grads),
                           "grads": grads}
        params = variables["params"]
        state = jax_step.TrainState(
            jnp.array(0, jnp.int32), params, tx.init(params),
            variables.get("batch_stats", {}), jax.random.PRNGKey(0))
        shardings = jax_mesh.infer_param_shardings(params, mesh)
        state = state._replace(params=jax.tree.map(jax.device_put, params,
                                                   shardings))
        steps = {frozen: jax_step.shard_train_step(make(frozen), mesh,
                                                   shardings, state)
                 for frozen in {i < frozen_until
                                for i in range(len(batches))}}
        data = jax_mesh.data_sharding(mesh)
        out = []
        for i, b in enumerate(batches):
            state, m = steps[i < frozen_until](
                state,
                jax.device_put(jnp.asarray(b["images"], jnp.float64), data),
                jax.device_put(jnp.asarray(b["gt"], jnp.int32), data))
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        _port_names(m["grads"],
                                    stats=_np(state.batch_stats))))
        return (out, _port_names(state.params, stats=_np(state.batch_stats)),
                cfg.learning_rate)


def _jax_reference(name, case, batches):
    if name == "jax_accum_lstm":        # a 2-device 'data' mesh
        mesh = jax_mesh.create_mesh((WORLD,), ("data",),
                                    jax.devices()[:WORLD])
        return jax_sharded_steps(case, batches, mesh, VOCAB, SEQ)
    return (_jax_alexcap if case["kind"] == "alexcap" else _jax_dense)(
        case, batches)


# ----------------------------------------------- the worlds of one and two

def _launch(spec, out_dir, init, world):
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "2",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "imagecaptioning_tpu_torch.tools.dp_check",
             str(spec), str(out_dir), init], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, timeout):
    """The processes' output once all end, or as soon as one fails (the
    others then wait in a collective, and are killed)."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) or \
                time.monotonic() > deadline:
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    return [p.communicate()[0] for p in procs]


CLI_ARGS = ("--smoke", "--max-iter", "2", "--eval-every", "2", "--set",
            "backbone_stages=1,1,1,1", "embedding_size=16", "lstm_size=16",
            "batch_size=2", "log_every=1")


def _launch_cli(cwd, world=3):
    """`train_LSTM` as torchrun would start it on `world` CPU ranks, its
    batch of 2 keeping 2 ranks (the third idles)."""
    with socket.socket() as sock:          # a free port for env://
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "imagecaptioning_tpu_torch.train_LSTM",
             *CLI_ARGS, "--device", "cpu"], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {"case", "world2": [rank 0's, rank 1's], "world1" or "jax"}}:
    the world of 2 and the one-process world run while this process
    computes the JAX references."""
    tmp = tmp_path_factory.mktemp("dp")
    cases = _build_cases(tmp)
    out = tmp / "out"
    out.mkdir()
    torch.save([c for c, _ in cases.values()], tmp / "spec2.pt")
    # the one process resumes the world of 2's checkpoints, writing none
    torch.save([{k: v for k, v in c.items() if k != "save_after"}
                for n, (c, _) in cases.items()
                if not n.startswith(("jax_", "model_"))], tmp / "spec1.pt")
    procs = (_launch(tmp / "spec2.pt", out, f"file://{tmp / 'rdzv2'}", 2)
             + _launch(tmp / "spec1.pt", out, f"file://{tmp / 'rdzv1'}", 1))
    (tmp / "cli").mkdir()
    cli = _launch_cli(tmp / "cli")
    try:
        # JAX compiles mostly outside the GIL: the references in threads,
        # beside the dry run's processes
        with ThreadPoolExecutor(4) as pool:
            dry = pool.submit(dryrun.dryrun_multichip, 2, device="cpu")
            # the longest compiles first
            refs = {name: pool.submit(_jax_reference, name, *cases[name])
                    for name in ("jax_lstm_attention", "jax_lstm",
                                 "jax_accum_lstm", "jax_rpn", "jax_gt",
                                 "jax_transformer")}
            results = {name: {"case": case} for name, (case, _) in
                       cases.items()}
            for name, ref in refs.items():
                results[name]["jax"] = ref.result()
            results["dryrun_multichip(2)"] = dry.result()
        logs = _wait(procs, timeout=300)
        cli_logs = _wait(cli, timeout=300)
    finally:
        for p in procs + cli:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    results["cli"] = {"rcs": [p.returncode for p in cli], "logs": cli_logs,
                      "dir": tmp / "cli"}
    for name, r in results.items():
        if name not in cases:
            continue
        r["world2"] = [dict(np.load(out / f"{name}_w2_r{rank}.npz"))
                       for rank in range(WORLD)]
        if not name.startswith(("jax_", "model_")):
            r["world1"] = dict(np.load(out / f"{name}_w1_r0.npz"))
    return results


def _close(got, want, rel, floor=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + floor, (what, err, scale)


def _tensors(d, prefix):
    """The tensor names under `prefix` (`grad/<u>/` or `state/`), whole or
    projected."""
    names = {k[len(prefix):] for k in d if k.startswith(prefix)}
    names |= {k[len("proj/" + prefix):].rsplit("/", 1)[0] for k in d
              if k.startswith("proj/" + prefix)}
    return sorted(names)


def _tensor_close(got, want, key, rel, floor=0.0):
    """A tensor of two `compact`ed dicts: whole, or both projections (each
    within `rel` of its own largest element)."""
    if key in want:
        _close(got[key], want[key], rel, floor, key)
        return
    for part in ("rows", "cols"):
        _close(got[f"proj/{key}/{part}"], want[f"proj/{key}/{part}"], rel,
               floor, f"{key} ({part})")


def _ranks_agree(r):
    """Every rank holds the same global losses, gradients and weights
    (rank 1 wrote a digest of each)."""
    a, b = r["world2"]
    mine = dp_check.digest(a)
    assert sorted(k for k in mine if not k.startswith(("draw", "sample"))) \
        == sorted(k for k in b if not k.startswith(("draw", "sample")))
    for key, v in mine.items():
        if key.startswith(("loss/", "digest/", "gnorm/", "bits/",
                           "reduces/")):
            np.testing.assert_array_equal(v, b[key], err_msg=key)


# ------------------------------------------------------- JAX parity

@pytest.mark.parametrize("family", JAX_PARITY)
def test_world_of_two_matches_jax_single_device(runs, family):
    r = runs[f"jax_{family}"]
    _ranks_agree(r)
    got = r["world2"][0]
    steps, state, lr = r["jax"]
    want = dp_check.compact(
        {**{f"grad/{i}/{k}": v for i, (_, g) in enumerate(steps)
            for k, v in g.items()},
         **{f"state/{k}": v for k, v in state.items()}})
    for i, (want_loss, want_grads) in enumerate(steps):
        if family in ("gt", "rpn"):
            for k, v in want_loss.items():
                key = f"loss/{i}" if family == "gt" else f"loss/{i}/{k}"
                assert float(got[key]) == pytest.approx(v, rel=1e-4,
                                                        abs=1e-7), key
        else:
            assert float(got[f"loss/{i}"]) == pytest.approx(want_loss,
                                                            rel=1e-4)
        names = _tensors(got, f"grad/{i}/")
        assert names, "no gradients recorded"
        largest = max(float(np.abs(w).max()) for w in want_grads.values())
        for name in names:
            if name.startswith(SCORE_WEIGHTS):
                continue
            if name == "llm.attention.v.bias":   # zero up to rounding
                assert float(np.abs(got[f"grad/{i}/{name}"]).max()) <= \
                    1e-6 * largest
                continue
            _tensor_close(got, want, f"grad/{i}/{name}", 1e-4)
        if family not in ("gt", "rpn"):
            # a parameter without a port gradient (the frozen trunk) has a
            # zero one in JAX
            for name, w in want_grads.items():
                if name not in names and not name.endswith(
                        ("running_mean", "running_var",
                         "num_batches_tracked")):
                    assert not np.any(w), name
    # the weights after the last step: 2·lr an applied update
    _weights_close(got, want, state, 2 * lr * len(steps))


def _weights_close(got, want, state, bound):
    """The weights of `got` within `bound` of JAX's `state` (their
    projections within the bound's share), BatchNorm's statistics within
    rtol 1e-3, atol 1e-5; `want` is `state` `compact`ed."""
    for name, w in state.items():
        key = f"state/{name}"
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key], w, rtol=1e-3, atol=1e-5,
                                       err_msg=name)
        elif name.endswith("num_batches_tracked"):
            continue
        elif key in got:
            assert float(np.abs(got[key] - w).max()) <= bound, name
        else:       # |Δ·u| ≤ max|Δ|·Σ|u|
            u, v = dp_check.projection_vectors(w.shape)
            for part, vec in (("rows", u), ("cols", v)):
                diff = got[f"proj/{key}/{part}"] - want[f"proj/{key}/{part}"]
                assert float(np.abs(diff).max()) <= \
                    bound * float(np.abs(vec).sum()), (name, part)


# ------------------------------------------ world-size invariance

def _invariant(r):
    _ranks_agree(r)
    one, (a, b) = r["world1"], r["world2"]
    draws = sorted(k for k in one if k.startswith("draw/"))
    assert draws and sorted(k for k in a if k.startswith("draw/")) == draws
    for j in draws:
        axis = int(a[f"draw_axis/{j[len('draw/'):]}"])
        np.testing.assert_array_equal(
            np.concatenate([a[j], b[j]], axis=axis), one[j], err_msg=j)
    for key in one:
        if key.startswith("sample/"):
            np.testing.assert_array_equal(
                np.concatenate([a[key], b[key]]), one[key], err_msg=key)
        elif key.startswith(("loss/", "gnorm/")):
            assert np.isfinite(a[key]).all(), key
            _close(a[key], one[key], INVARIANCE_REL, INVARIANCE_ABS, key)
    for prefix in ["state/"] + sorted({"/".join(k.split("/")[:2]) + "/"
                                       for k in one if k.startswith("grad/")}):
        names = _tensors(one, prefix)
        assert names == _tensors(a, prefix), prefix
        for name in names:
            if name.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(a[prefix + name],
                                              one[prefix + name])
                continue
            _tensor_close(a, one, prefix + name, INVARIANCE_REL,
                          INVARIANCE_ABS)
    return one


@pytest.mark.parametrize("family", JAX_PARITY)
def test_world_of_two_matches_one_process_with_dropout_and_sampler(
        runs, family):
    one = _invariant(runs[f"inv_{family}"])
    if family == "rpn":
        assert any(k.startswith("sample/") for k in one)
    if family in ("lstm", "lstm_attention"):
        # the trunk trained after the boundary, so BatchNorm moved
        stats = [k for k in one if k.endswith("running_mean")]
        start = dp_check.initial_model(
            runs[f"inv_{family}"]["case"]).state_dict()
        assert not np.array_equal(one[stats[0]],
                                  start[stats[0][len("state/"):]].numpy())


@pytest.mark.parametrize("kind", ["accum_lstm", "accum_rpn", "accum_gt"])
def test_accumulation_on_two_ranks_matches_one_process(runs, kind):
    one = _invariant(runs[kind])
    # the applied updates: 2 windows of 2 (LSTM), 1 (RPN, GT)
    updates = {k.split("/")[1] for k in one if k.startswith("grad/")}
    updates |= {k.split("/")[2] for k in one if k.startswith("proj/grad/")}
    assert len(updates) == (2 if kind == "accum_lstm" else 1)
    # every micro-step's own gradient norm, the global batch's (`_invariant`
    # holds it to the one process's within INVARIANCE_REL)
    if kind == "accum_lstm":
        norms = [runs[kind]["world2"][0][f"gnorm/{i}"] for i in range(4)]
        assert np.isfinite(norms).all() and min(norms) > 0


def test_accumulation_on_two_ranks_matches_jax_sharded_step(runs):
    """The AlexCap LSTM at grad_accum_steps 2 over two windows (fp64,
    dropout off, the trunk frozen) on 2 ranks against JAX's step at
    k = 2 sharded over a 2-device 'data' mesh: each micro-step's loss and
    gradient norm within 1e-4 relative, each applied update's gradient
    (the mean of its window's) within 1e-4 of its tensor's largest
    element, the weights within 2·lr an applied update and BatchNorm's
    statistics as `test_world_of_two_matches_jax_single_device` holds
    them."""
    r = runs["jax_accum_lstm"]
    _ranks_agree(r)
    got = r["world2"][0]
    steps, state, lr = r["jax"]
    k = r["case"]["cfg"]["grad_accum_steps"]
    assert k == 2 and len(steps) == 4
    for i, (loss, norm, _) in enumerate(steps):
        assert float(got[f"loss/{i}"]) == pytest.approx(loss, rel=1e-4)
        assert float(got[f"gnorm/{i}"]) == pytest.approx(norm, rel=1e-4), i
    updates = len(steps) // k
    means = {}
    for u in range(updates):
        names = _tensors(got, f"grad/{u}/")
        assert names, "no gradients recorded"
        window = [g for _, _, g in steps[u * k:(u + 1) * k]]
        for name in names:
            means[f"grad/{u}/{name}"] = np.mean([g[name] for g in window], 0)
    want = dp_check.compact(
        {**means, **{f"state/{k}": v for k, v in state.items()}})
    for key in means:
        _tensor_close(got, want, key, 1e-4)
    _weights_close(got, want, state, 2 * lr * updates)


@pytest.mark.parametrize("kind", list(RESUME_AFTER))
def test_mid_window_checkpoint_resumes_on_any_world_size(runs, kind):
    """Accumulation at k = 2 on 2 ranks (dropout on), rank 0 writing the
    drivers' `train_state` mid-window (`RESUME_AFTER`) and every rank
    building its model, optimizer and generator anew from that file: the
    window's other micro-steps, its update, the weights, BatchNorm's
    statistics and the optimizer's moments are bitwise the unbroken world
    of 2's. One process that resumes the same file ends within the
    world-size gate (INVARIANCE_REL of each tensor's largest element,
    plus INVARIANCE_ABS)."""
    _ranks_agree(runs[f"resume_{kind}"])
    whole = runs[f"accum_{kind}"]["world2"][0]
    resumed = runs[f"resume_{kind}"]["world2"][0]
    at = RESUME_AFTER[kind]
    # the micro-steps and updates after the checkpoint
    after = tuple(f"{p}/{i}" for i in range(at, 4) for p in ("loss", "gnorm"))
    after += tuple(f"{p}/{u}/" for u in range(at // 2, 2)
                   for p in ("grad", "proj/grad"))
    last = sorted(k for k in whole if k.startswith(after))
    assert any("grad/" in k for k in last)
    assert last == sorted(k for k in resumed if k.startswith(
        ("loss/", "gnorm/", "grad/", "proj/grad/")))
    for key in last:
        np.testing.assert_array_equal(resumed[key], whole[key], err_msg=key)
    bits = sorted(k for k in whole if k.startswith("bits/"))
    assert any(k.startswith("bits/moment/") for k in bits)
    assert any(k.endswith("running_mean") for k in bits) == (kind == "lstm")
    assert sorted(k for k in resumed if k.startswith("bits/")) == bits
    for key in bits:
        np.testing.assert_array_equal(resumed[key], whole[key], err_msg=key)
    one = runs[f"resume_{kind}"]["world1"]
    for key in last:
        if not key.startswith(("grad/", "proj/")):
            _close(one[key], whole[key], INVARIANCE_REL, INVARIANCE_ABS, key)
    prefixes = ["state/"] + sorted(
        {"/".join(k.split("/")[:2]) + "/" for k in one
         if k.startswith("grad/")})
    for prefix in prefixes:
        names = _tensors(whole, prefix)
        assert names and names == _tensors(one, prefix), prefix
        for name in names:
            if name.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(one[prefix + name],
                                              whole[prefix + name])
                continue
            _tensor_close(one, whole, prefix + name, INVARIANCE_REL,
                          INVARIANCE_ABS)


@pytest.mark.parametrize("name,k", [
    ("accum_lstm", 2), ("accum_gt", 2), ("accum_rpn", 2), ("inv_lstm", 1),
    ("inv_gt", 1), ("inv_rpn", 1)])
def test_gradient_all_reduces_per_applied_update(runs, name, k):
    """The data axis's collectives in the steps' gradient reductions
    (`Axis.calls`): one a micro-step on 2 ranks, so k an applied update at
    grad_accum_steps k (one at k = 1, as before accumulation reduced every
    micro-step); none on one process."""
    a, one = runs[name]["world2"][0], runs[name]["world1"]
    counts = [int(a[key]) for key in sorted(a) if key.startswith("reduces/")]
    assert counts and counts == [k] * len(counts)
    assert all(int(one[key]) == 0 for key in one
               if key.startswith("reduces/"))


def test_a_rank_whose_regions_are_all_masked(runs):
    r = runs["masked_gt"]
    assert not r["case"]["batches"][0]["mask"][2:].any()
    one = _invariant(r)
    assert float(one["loss/0"]) > 0


def test_a_model_axis_replicates_the_step(runs):
    """('data', 'model') = (1, 2), as the JAX drivers take a 'model' axis
    without parameter shardings: each rank computes the whole batch, the
    same as one process (the GT step with dropout and curriculum on)."""
    a, b = runs["model_gt"]["world2"]
    _ranks_agree(runs["model_gt"])
    one = runs["inv_gt"]["world1"]      # the same case on one process
    for key, v in one.items():
        if key.startswith(("draw/", "draw_axis/")):
            np.testing.assert_array_equal(a[key], v, err_msg=key)
            np.testing.assert_array_equal(b[key], v, err_msg=key)
        elif key.startswith(("loss/", "grad/", "state/", "proj/")):
            _close(a[key], v, INVARIANCE_REL, INVARIANCE_ABS, key)


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("batch", [1, 2, 6, 7, 16])
def test_mesh_for_batch_caps_like_jax(batch):
    n = len(jax.devices())
    want = jax_mesh.mesh_for_batch(batch)
    assert meshlib.shape_for_batch(batch, n) == (want.shape["data"],)
    assert batch % meshlib.ranks_for_batch(batch, n) == 0
    want2 = jax_mesh.create_mesh((-1, 2), ("data", "model"))
    assert meshlib.resolve_shape((-1, 2), n) == (want2.shape["data"], 2)
    got = meshlib.mesh_for_batch(batch)        # no process group: one
    assert got.shape == {"data": 1} and not got.idle
    assert got.data is meshlib.IDENTITY


def test_rows_and_the_identity_reducer():
    assert meshlib.rows(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError):
        meshlib.rows(5, 0, 2)
    x = torch.randn(6, 5)
    ident = meshlib.IDENTITY
    assert ident.sum(x) is x and ident.all_sum(x) is x
    assert torch.equal(ident.mean(x), x.mean())
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    assert torch.equal(ident.rand((3, 4), g1),
                       torch.rand((3, 4), generator=g2))
    assert meshlib.current() is ident
    dp = meshlib.DataParallel(1, 2)
    with meshlib.active(dp):
        assert meshlib.current() is dp
    assert meshlib.current() is ident


def test_config_mesh_fields_parse_like_the_jax_ones():
    pc = configs.apply_overrides(configs.get_lstm_config(), {
        "mesh_shape": "-1,2", "mesh_axis_names": "data,model"})
    assert pc.mesh_shape == (-1, 2)
    assert pc.mesh_axis_names == ("data", "model")
    dc = dense_configs.apply_overrides(dense_configs.get_gt_config(),
                                       ["mesh_shape=-1,2",
                                        "mesh_axis_names=data,model"])
    assert dc.mesh_shape == (-1, 2)
    assert dc.mesh_axis_names == ("data", "model")
    jc = jax_dense_configs.get_gt_config()
    assert (dc.replace(mesh_shape=(-1,), mesh_axis_names=("data",))
            .mesh_shape == jc.mesh_shape)


def test_trainer_entry_point_on_three_ranks_with_one_idle(runs):
    """`train_LSTM --smoke` on 3 CPU ranks (env:// rendezvous, as
    torchrun sets it) at batch 2: 2 ranks train, rank 0 alone logs,
    evaluates and writes (one summary line, one loss history, one
    checkpoint), rank 2 says it joins no step; all exit 0."""
    cli = runs["cli"]
    assert cli["rcs"] == [0, 0, 0], [log[-3000:] for log in cli["logs"]]
    rank0, rank1, rank2 = cli["logs"]
    assert "iter 2/2" in rank0 and "eval@2" in rank0
    assert '"iters": 2' in rank0
    assert "iter " not in rank1 and "eval@" not in rank1
    assert '"iters"' not in rank1
    assert "rank 2 of 3 joins no step" in rank2 and "{'data': 2}" in rank2
    runs_dir = cli["dir"] / "runs"
    (hist,) = (runs_dir / "loss_logs").glob("loss_history_*.json")
    records = json.loads(hist.read_text())
    assert [h["iter"] for h in records] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in records)
    assert len(list((runs_dir / "models").glob("best_model_*"))) == 1


def test_dryrun_multichip_on_two_processes(runs):
    line = runs["dryrun_multichip(2)"]     # run beside the other worlds
    assert line.startswith("dryrun_multichip(2): mesh={'data': 1, "
                           "'model': 2}")
    losses = [float(w.split("=")[1]) for w in line.split()
              if w.endswith(tuple("0123456789")) and "_loss=" in w]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert line.endswith("OK")
