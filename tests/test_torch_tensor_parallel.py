"""The port's tensor split over a 'model' axis (`parallel/mesh.py`:
`PARTITION_RULES`, `infer_param_shardings`, `shard_params`) on the CPU.

One world of 4 processes, ('data', 'model') = (2, 2) under gloo, one torch
thread a rank, runs every split case (`tools/dp_check.py`, which imports
only the port; rendezvous through a file under `tmp_path`), beside a world
of 1 that runs the same cases unsplit, while this process computes the
JAX references and `dryrun_multichip(4)` runs in its own world:

- the placement table: the port's `infer_param_shardings` against the JAX
  package's over a (4, 2) mesh, leaf by leaf through the port's
  JAX → port converter (transposes included), for the ViT, Transformer,
  LSTM and attention-LSTM captioners, at a vocabulary whose output width
  splits (24) and one where it falls back (65). One named exception:
  `attention.fc_out.bias`, which JAX gives P('model') through its generic
  `(fc_out|linear|deep_output)/bias` rule; here a row split's bias is
  added once, after the sum over 'model', so it stays replicated. The
  function is the same;
- JAX parity (dropout off): the Transformer step, and the LSTM and
  attention-LSTM across the frozen → finetune boundary over 3 steps,
  split, against the JAX package's single-device step, at
  `tests/test_parallel.py`'s tolerances (loss rel 1e-4; weights rtol
  2e-3, atol 2e-5, 2e-3 across the boundary; BatchNorm statistics rtol
  1e-3, atol 1e-5), and each gradient within 1e-4 of its tensor's largest
  element;
- accumulation: the ViT split at grad_accum_steps 2,
  each micro-step's gradient norm and the weights after the window's
  update against JAX's step sharded by `infer_param_shardings` over a
  (2, 2) mesh, and against the port's unsplit one-process run;
- world-size invariance (dropout on): the split world against the port's
  own one-process step, the ViT included: every draw identical on the
  two model ranks of a data index and, joined over the data ranks, to the
  one process's; losses, gradients and weights within INVARIANCE_REL of
  their tensor's largest element plus INVARIANCE_ABS (measured on the
  CPU: at most 7.1e-13 relative; the attention's `v.bias` gradient, zero
  up to rounding, at most 8.7e-17 absolute; fp64);
- `dryrun_multichip(4)` lays out {'data': 2, 'model': 2} and splits each
  captioner.

The models are in fp64, as `tests/test_torch_parallel.py` explains for
the ResNet families (fp32 BatchNorm over 4 images of 64² moves trunk
gradients by percents with the reduction order).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from imagecaptioning_tpu.config import configs as jax_configs
from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.parallel import mesh as jax_mesh
from imagecaptioning_tpu.train import optim as jax_optim
from imagecaptioning_tpu.utils import torch_port as jax_torch_port
from imagecaptioning_tpu_torch import dryrun
from imagecaptioning_tpu_torch.config import configs
from imagecaptioning_tpu_torch.models.captioners import build_model
from imagecaptioning_tpu_torch.parallel import mesh as meshlib
from imagecaptioning_tpu_torch.tools import dp_check
from imagecaptioning_tpu_torch.utils.weights import (
    captioner_state_dict_from_jax)
from test_torch_alexcap_families import jax_model, reference_layout
from test_torch_parallel import (_close, _np, _port_names, _tensor_close,
                                 _tensors, _wait, jax_sharded_steps)
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
WORLD, MESH = 4, ((2, 2), ("data", "model"))
VOCAB, SEQ = 21, 6          # an output width of 24: the heads split too
STAGES = (1, 1, 1, 1)
JAX_PARITY = ["transformer", "lstm", "lstm_attention"]
INVARIANT = ["transformer", "lstm", "lstm_attention", "vitb"]
INVARIANCE_REL, INVARIANCE_ABS = 1e-9, 1e-12
# JAX's leaf is split, the port's tensor replicated (module docstring)
NAMED_EXCEPTIONS = (r"attention\.fc_out\.bias$",)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _cfg(family, dropout=False, **kw):
    widths = {"transformer": {"transformer_size": 32, "num_layers": 1,
                              "num_heads": 4},
              "vitb": {"embedding_size": 32, "num_layers": 1, "num_heads": 4,
                       "vit_dims": (32, 16, 2, 4, 32, 64),
                       "trained_encoder": False},
              }.get(family, {"embedding_size": 16, "lstm_size": 16})
    return configs.get_config(family).replace(
        backbone_stages=STAGES, compute_dtype="float32", batch_size=4,
        clip_grad=True, use_dropout=dropout, drop_value=0.5,
        **{**widths, **kw})


# ------------------------------------------------------------- the cases

def _case(family, dropout, name, steps, accum=1):
    """4 images a step (2 a data rank); the LSTM families frozen for 2
    steps then finetuned; `accum` micro-steps an update; fp64."""
    cfg = _cfg(family, dropout, grad_accum_steps=accum)
    size = 32 if family == "vitb" else 64
    rng = np.random.RandomState(13)
    batches = []
    for _ in range(steps):
        gt = rng.randint(1, VOCAB + 1, (4, SEQ)).astype(np.int64)
        gt[1, 3:] = 0
        batches.append({"images": rng.randn(4, size, size, 3).astype(
            np.float32), "gt": gt})
    case = {"name": name, "kind": "alexcap", "cfg": cfg.to_dict(),
            "vocab": VOCAB, "seq": SEQ, "seed": 5, "f64": True,
            "batches": [_t(b) for b in batches], "total_steps": 8}
    if family in ("lstm", "lstm_attention"):
        case["frozen_until"] = 2
    return case, batches


def _build_cases():
    cases = {}
    for fam in JAX_PARITY:
        cases[f"jax_{fam}"] = _case(fam, False, f"jax_{fam}",
                                    1 if fam == "transformer" else 3)
    for fam in INVARIANT:
        cases[f"inv_{fam}"] = _case(fam, True, f"inv_{fam}",
                                    3 if fam.startswith("lstm") else 2)
    # one window of 2 micro-steps, held against JAX and the one process:
    # the ViT, the cheapest split captioner to compile here (its encoder
    # trains and splits too)
    cases["accum_vitb"] = _case("vitb", False, "accum_vitb", 2, accum=2)
    return cases


def _jax_alexcap(case, batches):
    """JAX's single-device steps in fp64 → ([(loss, grads)] a step, the
    params and statistics after the last, lr), in the port's names (the
    setup of `tests/test_parallel.py`: the frozen model's step until the
    boundary, the optimizer's gate there)."""
    cfg = configs.CaptionConfig(**case["cfg"])
    pm = dp_check.initial_model(case)
    variables, _ = jax_torch_port.convert_reference_captioner(
        reference_layout(pm.state_dict()), vit_heads=12)
    with jax.enable_x64(True):
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 variables)
        frozen_until = case.get("frozen_until", 0)
        jcfg = jax_configs.get_config(cfg.model_type).replace(
            **{k: getattr(cfg, k) for k in (
                "use_scheduler", "num_epochs", "learning_rate", "min_lr",
                "eps", "weight_decay", "finetune_cnn", "trained_encoder",
                "clip_grad", "grad_clip_norm", "beta1", "beta2")})
        tx = jax_optim.make_optimizer(jcfg, case["total_steps"],
                                      frozen_until)
        params = variables["params"]
        stats = variables.get("batch_stats", {})
        opt_state = tx.init(params)

        def make(model):
            rolled = ({"scan_unroll": 1} if hasattr(model, "scan_unroll")
                      else {})
            model = model.clone(compute_dtype=jnp.float64, **rolled)

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
        steps = {False: make(jax_model(cfg, VOCAB, SEQ))}
        if frozen_until:
            steps[True] = make(jax_model(cfg, VOCAB, SEQ,
                                         freeze_encoder=True))
        out = []
        for i, b in enumerate(batches):
            loss, grads, params, stats, opt_state = steps[i < frozen_until](
                params, stats, opt_state,
                jnp.asarray(b["images"], jnp.float64),
                jnp.asarray(b["gt"], jnp.int32))
            out.append((float(loss), _port_names(grads, stats=_np(stats))))
        return (out, _port_names(params, stats=_np(stats)),
                cfg.learning_rate)


# ------------------------------------------------------------ the worlds

def _launch(spec, out_dir, init, world):
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "imagecaptioning_tpu_torch.tools.dp_check",
             str(spec), str(out_dir), init], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case name: {"case", "ranks": [the world of 4's outputs], "world1",
    and "jax" for the parity cases}, "dryrun": the dry run's lines}."""
    tmp = tmp_path_factory.mktemp("tp")
    cases = _build_cases()
    out = tmp / "out"
    out.mkdir()
    split = [{**c, "split": True, "mesh": MESH} for c, _ in cases.values()]
    torch.save(split, tmp / "spec4.pt")
    torch.save([c for n, (c, _) in cases.items()
                if n.startswith(("inv_", "accum_"))], tmp / "spec1.pt")
    procs = (_launch(tmp / "spec4.pt", out, f"file://{tmp / 'rdzv4'}",
                     WORLD)
             + _launch(tmp / "spec1.pt", out, f"file://{tmp / 'rdzv1'}", 1))
    results = {name: {"case": case} for name, (case, _) in cases.items()}
    try:
        with ThreadPoolExecutor(5) as pool:
            dry = pool.submit(dryrun.dryrun_lines, WORLD, device="cpu")
            refs = {"accum_vitb": pool.submit(
                jax_sharded_steps, *cases["accum_vitb"],
                jax_mesh.create_mesh(*MESH, jax.devices()[:WORLD]), VOCAB,
                SEQ)}
            refs.update({name: pool.submit(_jax_alexcap, case, batches)
                         for name, (case, batches) in cases.items()
                         if name.startswith("jax_")})
            for name, ref in refs.items():
                results[name]["jax"] = ref.result()
            results["dryrun"] = dry.result()
        logs = _wait(procs, timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    for name in cases:
        results[name]["ranks"] = [
            dict(np.load(out / f"{name}_w{WORLD}_r{rank}.npz"))
            for rank in range(WORLD)]
        if name.startswith(("inv_", "accum_")):
            results[name]["world1"] = dict(np.load(out / f"{name}_w1_r0.npz"))
    return results


def _ranks_agree(r):
    """Every rank holds the same global losses, gradients and weights
    (ranks 1-3 wrote a digest of each), and the same split."""
    first, *rest = r["ranks"]
    mine = dp_check.digest(first)
    for other in rest:
        assert sorted(k for k in mine if not k.startswith("draw")) == \
            sorted(k for k in other if not k.startswith("draw"))
        for key, v in mine.items():
            if key.startswith(("loss/", "digest/", "gnorm/",
                               "split_params")):
                np.testing.assert_array_equal(v, other[key], err_msg=key)
    assert len(first["split_params"]) > 0


# ------------------------------------------------ (a) the placement table

def _jax_leaf_placements(model):
    """{port name: the JAX placement as the port's `Shard(d)` or
    `Replicate()`}: JAX's `infer_param_shardings` over a (4, 2) mesh of
    the same weights, each leaf's split axis carried through the port's
    converter by coding each element with its leaf and its index along
    that axis."""
    variables, _ = jax_torch_port.convert_reference_captioner(
        reference_layout(model.state_dict()), vit_heads=4)
    params = _np(variables["params"])
    stats = _np(variables.get("batch_stats", {})) or None
    mesh = jax_mesh.create_mesh((4, 2), ("data", "model"))
    specs = jax_mesh.infer_param_shardings(params, mesh)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    spec_leaves = treedef.flatten_up_to(specs)
    split_dim = [next((d for d, a in enumerate(s.spec) if a == "model"), None)
                 for s in spec_leaves]

    def coded(fill):
        tree = treedef.unflatten([fill(i, leaf) for i, leaf in
                                  enumerate(leaves)])
        return {k: t.numpy() for k, t in
                captioner_state_dict_from_jax(tree, stats).items()}
    which = coded(lambda i, leaf: np.full(leaf.shape, i, np.float64))

    def along(i, leaf):
        d = split_dim[i]
        if d is None:
            return np.zeros(leaf.shape)
        shape = [1] * leaf.ndim
        shape[d] = leaf.shape[d]
        return np.broadcast_to(np.arange(leaf.shape[d]).reshape(shape),
                               leaf.shape).astype(np.float64)
    index = coded(along)
    out = {}
    for name, p in model.named_parameters():
        src = np.unique(which[name]).astype(int)
        dims = {split_dim[i] for i in src}
        if dims == {None}:
            out[name] = Replicate()
            continue
        assert len(src) == 1, (name, src)   # a split leaf maps whole
        code = index[name]
        varies = [a for a in range(code.ndim)
                  if np.ptp(code, axis=a).max() > 0]
        assert len(varies) == 1, (name, varies)
        a = varies[0]
        # JAX's k-th block along the axis is the port's k-th
        line = np.moveaxis(code, a, 0).reshape(code.shape[a], -1)[:, 0]
        np.testing.assert_array_equal(line, np.arange(code.shape[a]))
        out[name] = Shard(a)
    return out


TABLE_CASES = [("vitb", 62), ("vitb", 21), ("transformer", 21),
               ("transformer", 62), ("lstm", 21), ("lstm", 62),
               ("lstm_attention", 21), ("lstm_attention", 62)]


@pytest.mark.parametrize("family,vocab", TABLE_CASES,
                         ids=[f"{f}-width{v + 3}" for f, v in TABLE_CASES])
def test_placements_match_jax_infer_param_shardings(family, vocab):
    import re
    cfg = _cfg(family, trained_encoder=True) if family == "vitb" else \
        _cfg(family)
    if family in ("transformer", "vitb"):
        cfg = cfg.replace(num_layers=2)
    model = build_model(cfg, vocab, SEQ)
    want = _jax_leaf_placements(model)
    got = meshlib.infer_param_shardings(model, meshlib.Mesh(
        {"data": 4, "model": 2}, None, meshlib.IDENTITY))
    assert sorted(got) == sorted(want)
    exceptions = []
    for name in got:
        if got[name] == want[name]:
            continue
        assert any(re.search(p, name) for p in NAMED_EXCEPTIONS), (
            name, got[name], want[name])
        assert got[name] == Replicate() and want[name] == Shard(0), name
        exceptions.append(name)
    split = [n for n, pl in got.items() if pl != Replicate()]
    head = {"vitb": "decoder.fc_out.weight",
            "transformer": "llm.decoder.fc_out.weight",
            "lstm": "llm.rnn.linear.weight",
            "lstm_attention": "llm.deep_output.weight"}[family]
    # the vocabulary head splits only where its width is even; the
    # attention head's never (JAX's `deep_output_kernel` is a leaf of its
    # own, which no rule matches)
    assert (head in split) == ((vocab + 3) % 2 == 0
                               and family != "lstm_attention")
    if family in ("transformer", "vitb"):
        assert len(exceptions) == cfg.num_layers * (
            2 if family == "vitb" else 3)
        assert any(".feed_forward.0.weight" in n for n in split)
        assert any(".attention.queries.weight" in n for n in split)
    if family == "vitb":
        assert any(".mlp.0.weight" in n for n in split)
        assert not any("self_attention" in n for n in split)
    if family.startswith("lstm"):
        assert not exceptions and split


def test_placements_replicate_without_a_model_axis():
    model = build_model(_cfg("transformer"), VOCAB, SEQ)
    for shape in ({"data": 8}, {"data": 8, "model": 1}):
        got = meshlib.infer_param_shardings(
            model, meshlib.Mesh(shape, None, meshlib.IDENTITY))
        assert set(got.values()) == {Replicate()}
    # a one-process mesh has no axis to split over: nothing changes
    before = dict(model.named_parameters())
    meshlib.shard_params(model, meshlib.single(("data", "model")))
    assert all(p is before[n] for n, p in model.named_parameters())
    assert not any(meshlib.is_split(p) for p in model.parameters())


def test_an_attention_splits_only_along_whole_heads():
    """6 heads of 4 over 4 ranks: the width (24) divides, the heads do not,
    so the attention stays whole; its FFN (96 wide) still splits."""
    model = build_model(_cfg("transformer", transformer_size=24,
                             num_heads=6), VOCAB, SEQ)
    got = meshlib.infer_param_shardings(model, meshlib.Mesh(
        {"data": 2, "model": 4}, None, meshlib.IDENTITY))
    att = [n for n in got if ".attention." in n]
    assert att and all(got[n] == Replicate() for n in att)
    assert got["llm.encoder.layers.0.feed_forward.0.weight"] == Shard(0)
    assert got["llm.encoder.layers.0.feed_forward.2.weight"] == Shard(1)
    two = meshlib.infer_param_shardings(model, meshlib.Mesh(
        {"data": 4, "model": 2}, None, meshlib.IDENTITY))
    assert two["llm.encoder.layers.0.attention.queries.weight"] == Shard(0)


# ------------------------------------------------------ (b) JAX parity

@pytest.mark.parametrize("family", JAX_PARITY)
def test_split_step_matches_jax_single_device(runs, family):
    r = runs[f"jax_{family}"]
    _ranks_agree(r)
    got = r["ranks"][0]
    steps, state, lr = r["jax"]
    assert any(".weight" in n for n in got["split_params"])
    want = dp_check.compact(
        {**{f"grad/{i}/{k}": v for i, (_, g) in enumerate(steps)
            for k, v in g.items()},
         **{f"state/{k}": v for k, v in state.items()}})
    for i, (want_loss, want_grads) in enumerate(steps):
        assert float(got[f"loss/{i}"]) == pytest.approx(want_loss, rel=1e-4)
        names = _tensors(got, f"grad/{i}/")
        assert names
        largest = max(float(np.abs(w).max()) for w in want_grads.values())
        for name in names:
            if name == "llm.attention.v.bias":   # zero up to rounding
                assert float(np.abs(got[f"grad/{i}/{name}"]).max()) <= \
                    1e-6 * largest
                continue
            _tensor_close(got, want, f"grad/{i}/{name}", 1e-4)
    # tests/test_parallel.py's tolerances on the weights after the steps
    _jax_weights_close(got, state,
                       2e-3 if "frozen_until" in r["case"] else 2e-5)


def _jax_weights_close(got, state, atol):
    """The weights of `got` against JAX's `state` at
    `tests/test_parallel.py`'s tolerances (rtol 2e-3 and `atol`;
    BatchNorm's statistics rtol 1e-3, atol 1e-5), a projected tensor
    within the bound carried through its projection."""
    for name, w in state.items():
        key = f"state/{name}"
        if name.endswith("num_batches_tracked"):
            continue
        rtol, a = ((1e-3, 1e-5) if name.endswith(("running_mean",
                                                  "running_var"))
                   else (2e-3, atol))
        if key in got:
            np.testing.assert_allclose(got[key], w, rtol=rtol, atol=a,
                                       err_msg=name)
            continue
        # a projection p = W·u: |Δp| ≤ Σ|u|·(a + rtol·|w|) element-wise
        mat = np.asarray(w, np.float64).reshape(w.shape[0], -1)
        u, v = dp_check.projection_vectors(w.shape)
        for part, diff, bound in (
                ("rows", got[f"proj/{key}/rows"] - mat @ u,
                 a * np.abs(u).sum() + rtol * np.abs(mat) @ np.abs(u)),
                ("cols", got[f"proj/{key}/cols"] - v @ mat,
                 a * np.abs(v).sum() + rtol * np.abs(v) @ np.abs(mat))):
            assert np.all(np.abs(diff) <= bound), (name, part)


def test_split_accumulation_matches_jax_sharded_step_and_one_process(runs):
    """The ViT captioner split over ('data', 'model') = (2, 2) at
    grad_accum_steps 2, one window (fp64, dropout off, the encoder
    training): each micro-step's gradient norm, where `global_norm` sums
    each shard's squares over 'model' after the step's `reduce_grads`
    summed the shards over 'data', the window's gradient and the weights
    after its update, against JAX's step at k = 2 sharded by
    `infer_param_shardings` over a (2, 2) mesh at
    `test_split_step_matches_jax_single_device`'s gates (loss and norm
    1e-4 relative), and against the port's unsplit one process at
    INVARIANCE_REL of each tensor's largest element plus
    INVARIANCE_ABS."""
    r = runs["accum_vitb"]
    _ranks_agree(r)
    got, one = r["ranks"][0], r["world1"]
    assert any(".mlp." in n for n in got["split_params"])
    steps, state, _ = r["jax"]
    assert len(steps) == 2 and r["case"]["cfg"]["grad_accum_steps"] == 2
    for i, (loss, norm, _) in enumerate(steps):
        assert float(got[f"loss/{i}"]) == pytest.approx(loss, rel=1e-4)
        assert float(got[f"gnorm/{i}"]) == pytest.approx(norm, rel=1e-4), i
        for key in (f"loss/{i}", f"gnorm/{i}"):
            _close(got[key], one[key], INVARIANCE_REL, INVARIANCE_ABS, key)
    names = _tensors(got, "grad/0/")
    assert names and names == _tensors(one, "grad/0/")
    means = {f"grad/0/{n}": np.mean([g[n] for _, _, g in steps], 0)
             for n in names}
    want = dp_check.compact(means)
    for key in means:
        _tensor_close(got, want, key, 1e-4)
        _tensor_close(got, one, key, INVARIANCE_REL, INVARIANCE_ABS)
    _jax_weights_close(got, state, 2e-5)
    for name in _tensors(one, "state/"):
        if name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got["state/" + name],
                                          one["state/" + name])
            continue
        _tensor_close(got, one, "state/" + name, INVARIANCE_REL,
                      INVARIANCE_ABS)


# --------------------------------------- (c) world-size invariance

@pytest.mark.parametrize("family", INVARIANT)
def test_split_world_matches_one_process_with_dropout(runs, family):
    r = runs[f"inv_{family}"]
    _ranks_agree(r)
    one, ranks = r["world1"], r["ranks"]
    a = ranks[0]
    draws = sorted(k for k in one if k.startswith("draw/"))
    assert draws and sorted(k for k in a if k.startswith("draw/")) == draws
    # ranks (data, model): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1)
    for j in draws:
        axis = int(a[f"draw_axis/{j[len('draw/'):]}"])
        np.testing.assert_array_equal(ranks[1][j], ranks[0][j], err_msg=j)
        np.testing.assert_array_equal(ranks[3][j], ranks[2][j], err_msg=j)
        np.testing.assert_array_equal(
            np.concatenate([ranks[0][j], ranks[2][j]], axis=axis), one[j],
            err_msg=j)
    for key in one:
        if key.startswith(("loss/", "gnorm/")):
            _close(a[key], one[key], INVARIANCE_REL, INVARIANCE_ABS, key)
    prefixes = ["state/"] + sorted({"/".join(k.split("/")[:2]) + "/"
                                    for k in one if k.startswith("grad/")})
    for prefix in prefixes:
        names = _tensors(one, prefix)
        assert names == _tensors(a, prefix), prefix
        for name in names:
            if name.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(a[prefix + name],
                                              one[prefix + name])
                continue
            _tensor_close(a, one, prefix + name, INVARIANCE_REL,
                          INVARIANCE_ABS)
    split = set(a["split_params"])
    assert split
    if family in ("transformer", "vitb"):
        assert any("feed_forward.0" in n for n in split)
    if family == "vitb":          # trained: the encoder's MLP split too
        assert any(".mlp.3.weight" in n for n in split)
        assert any(k.startswith("grad/0/encoder_vit.") and ".mlp.0." in k
                   for k in a)


# ----------------------------------------------------- (d) the dry run

def test_dryrun_multichip_splits_on_four_processes(runs):
    *before, line = runs["dryrun"]
    assert line.startswith("dryrun_multichip(4): mesh={'data': 2, "
                           "'model': 2} vitb_loss=")
    losses = [float(w.split("=")[1]) for w in line.split()
              if "_loss=" in w]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert line.endswith(" OK")
    (split,) = [ln for ln in before if "split over 'model'" in ln]
    counts = dict(w.split("=") for w in split.split()[-3:])
    assert sorted(counts) == ["attention_lstm", "transformer", "vitb"]
    for name, frac in counts.items():
        k, total = map(int, frac.split("/"))
        assert 0 < k < total, name
