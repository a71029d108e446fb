"""The PyTorch port's training path for the attention-LSTM, Transformer and
ViT-B captioners against the JAX package, at the tiny sizes of
`test_torch_alexcap_families.py` (whose helpers build both sides from one
seeded port model), fp32 on the CPU.

- per family and phase (the CNN families frozen and finetuned, VGGFace
  finetuned; the ViT with its encoder frozen and trained): the train-mode
  loss, the attention family's doubly-stochastic regularizer included,
  within 1e-5, and every gradient within 1e-4 relative (max |got − want|
  ≤ 1e-4 · max |want| per tensor) of `jax.grad` in fp32, but the
  attention's score weights W, U and v, which the attention family holds
  in fp64 on both sides, with every other gradient once more (their
  gradients cancel over positions, so fp32 rounding moves them by 1e-3
  to 1e-1 of their largest element and more); the score bias v's, zero but for rounding, within 1e-6 of the
  largest gradient on both sides; a frozen encoder's gradients None in
  the port, zeros in JAX;
- `make_optimizer` (clip → AdamW for the Transformer and ViT, the
  encoder group a hard zero for the Transformer and a `trained_encoder`
  ViT, gated at the finetune boundary otherwise) against optax over 6-8
  updates across the boundary, constant lr and `use_scheduler`: weights
  within 1e-6, no state ever for a hard-zero group;
  `captioner_train_state_from_jax` carrying an AdamW state across the
  boundary, then the same updates within 1e-6;
- two train steps against JAX's `make_train_step` (the attention family
  frozen, the Transformer after the finetune boundary, the ViT with its
  trained encoder; Adam's eps 1e-3, as in the LSTM's test): losses
  within 1e-5 relative, weights and BatchNorm statistics within 1e-5, the
  gradient norm within 1e-4 relative; the Transformer's trunk weights
  bitwise unchanged while its running statistics move, and its gradient
  in the norm;
- `eval_split` (attention greedy, Transformer and ViT beam-3): records
  identical to JAX's, METEOR, BLEU, BLEU-4 and CIDEr within 1e-9;
- `encoder_init` from a `.npz` the test writes in the JAX layout
  (ResNet with statistics, VGGFace, ViT) equal to JAX's merge; an extra,
  missing or reshaped leaf, statistics where the module has none (or
  none where it has), and an unknown module each refused;
- `train_LSTMwAttention`, `train_Transformer` and `train_ViTB` train 2
  steps on the CPU, then resume from their checkpoint to 4 (the trunk
  frozen: a cut ResNet keeps its widths, so a CNN family's checkpoint
  is ~35 MB, the ViT's under 2 MB); without a card they raise unless
  asked for the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from imagecaptioning_tpu.config import configs as jax_configs
from imagecaptioning_tpu.data import synthetic as jax_synthetic
from imagecaptioning_tpu.data import transforms as jax_transforms
from imagecaptioning_tpu.data.loader import AlexDataLoader as JaxLoader
from imagecaptioning_tpu.eval.eval_split import eval_split as jax_eval_split
from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.train import optim as jax_optim
from imagecaptioning_tpu.train import step as jax_step
from imagecaptioning_tpu.utils import pretrained as jax_pretrained
from imagecaptioning_tpu_torch import (train_LSTMwAttention, train_Transformer,
                                       train_ViTB)
from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
from imagecaptioning_tpu_torch.eval.eval_split import eval_split
from imagecaptioning_tpu_torch.models.captioners import (build_model,
                                                          encoder_name)
from imagecaptioning_tpu_torch.train import cli, optim
from imagecaptioning_tpu_torch.train.step import make_train_step
from imagecaptioning_tpu_torch.utils import pretrained
from imagecaptioning_tpu_torch.utils.weights import (
    captioner_state_dict_from_jax, captioner_train_state_from_jax)
from test_torch_alexcap_families import (cfg_for, images_for, jax_model,
                                         labels, seeded_pair)
import torch_threads  # noqa: F401  (one torch thread a test process)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(cfg):
    return jax_configs.get_config(cfg.model_type).replace(
        **{k: getattr(cfg, k) for k in (
            "use_scheduler", "num_epochs", "learning_rate", "min_lr", "eps",
            "weight_decay", "finetune_cnn", "trained_encoder", "clip_grad",
            "grad_clip_norm", "beta1", "beta2")})


def _stats_of(variables):
    return variables.get("batch_stats") or None


# ------------------------------------ modules 1, 5 and 9: loss, gradients

GRAD_CASES = [
    (("lstm_attention", False), False), (("lstm_attention", False), True),
    (("lstm_attention", True), False),
    (("transformer", False), False), (("transformer", False), True),
    (("transformer", True), False),
    (("vitb", False), False), (("vitb", False), True),
]
GRAD_IDS = ["attention-finetune", "attention-frozen",
            "attention-vggface-finetune", "transformer-finetune",
            "transformer-frozen", "transformer-vggface-finetune",
            "vitb-encoder-trained", "vitb-encoder-frozen"]


def _jax_and_port_grads(cfg, frozen, pm, variables, x, gt, f64):
    """One loss and its gradients on each side, in fp64 or fp32 → (JAX's
    loss, JAX's gradients in the port's names, the port's loss, the
    port's model after `backward`)."""
    dtype = np.float64 if f64 else np.float32
    jm = jax_model(cfg, freeze_encoder=frozen)
    with jax.enable_x64(f64):
        if f64:
            jm = jm.clone(compute_dtype=jnp.float64)
        v = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)

        def loss_fn(params):
            out, _ = jax_api.apply_train(jm, {**v, "params": params},
                                         jnp.asarray(x, dtype),
                                         jnp.asarray(gt))
            return jm.loss(out, jnp.asarray(gt))
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
            v["params"])
        want_loss, want_grads = float(want_loss), _np(want_grads)
    want = {k: t.numpy() for k, t in captioner_state_dict_from_jax(
        want_grads, _stats_of(variables)).items()}

    model = build_model(cfg, 20, 6, freeze_encoder=frozen)
    model.load_state_dict(pm.state_dict())
    if f64:
        model.double()
        model.encoder.compute_dtype = torch.float64
    out = model(torch.from_numpy(x.astype(dtype)), torch.from_numpy(gt),
                train=True)
    loss = model.loss(out, torch.from_numpy(gt))
    loss.backward()
    return want_loss, want, float(loss.detach()), model


# the attention's score weights: their gradient sums terms over positions
# that cancel (a softmax's gradient sums to zero), so fp32 rounding moves
# them by 1e-3 to 1e-1 of their largest element and more in either
# framework; they are held in fp64
SCORE_WEIGHTS = ("llm.attention.W.", "llm.attention.U.", "llm.attention.v.")


@pytest.mark.parametrize("family,frozen", GRAD_CASES, ids=GRAD_IDS)
def test_loss_and_every_gradient_match_jax(family, frozen):
    cfg = cfg_for(*family)
    pm, variables = seeded_pair(cfg, seed=2)
    x, gt = images_for(cfg, seed=4), labels(4)
    # fp32 for every gradient but the attention's score weights; the
    # attention family once more in fp64 for all of them
    runs = [False] + ([True] if family[0] == "lstm_attention" else [])
    for f64 in runs:
        want_loss, want, loss, model = _jax_and_port_grads(
            cfg, frozen, pm, variables, x, gt, f64)
        assert abs(loss - want_loss) <= 1e-5
        encoder = {id(p) for p in model.encoder.parameters()}
        largest = max(float(np.abs(w).max()) for w in want.values())
        compared = 0
        for name, p in model.named_parameters():
            w = want[name]
            if frozen and id(p) in encoder:
                assert p.grad is None and not np.any(w), name
                continue
            assert p.grad is not None, name
            if not f64 and name.startswith(SCORE_WEIGHTS):
                continue
            if name == "llm.attention.v.bias":
                # the softmax over positions ignores a shift of every
                # score: this bias's gradient is zero up to rounding on
                # both sides
                assert max(float(p.grad.abs().max()),
                           float(np.abs(w).max())) <= 1e-6 * largest
                continue
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{name} (fp64: {f64})")
            compared += 1
        assert compared > 0


# ------------------------------------------------- module 8: the optimizer

class _Toy(nn.Module):
    """An encoder and a head parameter group under the family's names."""

    def __init__(self, params):
        super().__init__()
        for top, leaves in params.items():
            self.add_module(top, nn.ParameterDict({
                k: nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in leaves.items()}))


def _toy_case(encoder, head, steps, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {encoder: {"w": (6, 5), "b": (5,)}, head: {"w": (7, 3),
                                                        "b": (3,)}}
    params = {t: {k: (rng.randn(*s) * 0.1).astype(np.float32)
                  for k, s in leaves.items()} for t, leaves in shapes.items()}
    grads = [{t: {k: (rng.randn(*s) * 0.8).astype(np.float32)
                  for k, s in leaves.items()}
              for t, leaves in shapes.items()} for _ in range(steps)]
    return params, grads


OPT_CASES = [("transformer", True), ("vitb", True), ("vitb", False)]
OPT_IDS = ["transformer", "vitb-trained-encoder", "vitb-trains-encoder"]


@pytest.mark.parametrize("scheduler", [False, True],
                         ids=["constant", "use_scheduler"])
@pytest.mark.parametrize("model_type,trained", OPT_CASES, ids=OPT_IDS)
def test_adamw_and_zero_groups_match_optax(model_type, trained, scheduler):
    steps, total, boundary = (8, 12, 3) if scheduler else (6, 6, 3)
    pc = cfg_for(model_type).replace(
        use_scheduler=scheduler, num_epochs=4, learning_rate=3e-3,
        min_lr=1e-4, trained_encoder=trained)
    jc = _jax_cfg(pc)
    encoder, head = (("encoder_vit", "decoder") if model_type == "vitb"
                     else ("features", "llm"))
    params, grads = _toy_case(encoder, head, steps)
    # the encoder's gradient: stopped before the boundary, and always for
    # a trained ViT encoder; the Transformer's enters the norm after it
    stopped = [k < boundary or (model_type == "vitb" and trained)
               for k in range(steps)]
    tx = jax_optim.make_optimizer(jc, total, boundary)
    state = tx.init(params)
    model = _Toy(params)
    opt = optim.make_optimizer(pc, model, total)
    assert isinstance(opt, optim.AlexAdamW)
    zero = model_type == "transformer" or trained
    assert [g["group"] for g in opt.param_groups] == (
        ["head"] if zero else ["head", "encoder"])
    for k, g in enumerate(grads):
        jg = jax.tree.map(np.copy, g)
        if stopped[k]:
            jg[encoder] = jax.tree.map(np.zeros_like, jg[encoder])
        upd, state = tx.update(jg, state, params)
        params = _np(optax.apply_updates(params, upd))
        for top, leaves in g.items():
            for name, v in leaves.items():
                getattr(model, top)[name].grad = (
                    None if stopped[k] and top == encoder
                    else torch.from_numpy(v.copy()))
        ps = list(model.parameters())
        norm = optim.global_norm(ps)
        assert float(norm) == pytest.approx(float(optax.global_norm(jg)),
                                            rel=1e-6)
        optim.clip_by_global_norm_(ps, 1.0, norm)
        opt.step()
        for top, leaves in params.items():
            for name, want in leaves.items():
                np.testing.assert_allclose(
                    getattr(model, top)[name].detach().numpy(), want,
                    rtol=0, atol=1e-6, err_msg=f"{top}.{name} step {k}")
        enc_state = getattr(model, encoder)["w"] in opt.state
        assert enc_state == (not zero and not stopped[k])
    if zero:       # a hard zero: the encoder never moved, decay included
        np.testing.assert_array_equal(
            getattr(model, encoder)["w"].detach().numpy(),
            _toy_case(encoder, head, steps)[0][encoder]["w"])


@pytest.mark.parametrize("family", [("transformer", False), ("vitb", False)],
                         ids=["transformer", "vitb-trains-encoder"])
def test_train_state_from_jax_carries_adamw_across_the_boundary(family):
    pc = cfg_for(*family).replace(learning_rate=1e-3, trained_encoder=False)
    jc = _jax_cfg(pc)
    model, variables = seeded_pair(pc, seed=6)
    params, stats = variables["params"], _stats_of(variables)
    encoder = "encoder_vit" if family[0] == "vitb" else "features"
    tx = jax_optim.make_optimizer(jc, 10, 3)
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(8)
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.05).astype(
        np.float32), params) for _ in range(5)]

    def stopped(g, k):
        return ({**g, encoder: jax.tree.map(np.zeros_like, g[encoder])}
                if k < 3 else g)
    for k in range(2):                               # before the boundary
        upd, state = update(stopped(grads[k], k), state, params)
        params = _np(optax.apply_updates(params, upd))
    opt = optim.make_optimizer(pc, model, 10)
    sd, opt_sd = captioner_train_state_from_jax(params, stats, state, opt)
    model.load_state_dict(sd)
    opt.load_state_dict(opt_sd)
    assert not any(p in opt.state
                   for p in getattr(model, encoder).parameters())
    for k in range(2, 5):                            # across it
        upd, state = update(stopped(grads[k], k), state, params)
        params = _np(optax.apply_updates(params, upd))
        g = captioner_state_dict_from_jax(grads[k], stats)
        for name, p in model.named_parameters():
            p.grad = (None if k < 3 and name.startswith(encoder)
                      else g[name].clone())
        ps = list(model.parameters())
        optim.clip_by_global_norm_(ps, 1.0, optim.global_norm(ps))
        opt.step()
    want = captioner_state_dict_from_jax(params, stats)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


# --------------------------------------------- module 9: the train step

# the attention family in its frozen phase (a first Adam update on a
# trunk in training mode turns its gradients' rounding into weight
# differences of 1e-5: its finetune gradients are held above); the
# Transformer after the boundary, where its trunk trains in mode only;
# the ViT with its trained encoder, frozen for the whole run
STEP_CASES = [(("lstm_attention", False), True), (("transformer", False),
                                                  False),
              (("vitb", False), None)]


@pytest.mark.parametrize("family,frozen", STEP_CASES,
                         ids=["attention-frozen", "transformer-finetune",
                              "vitb-trained-encoder"])
def test_two_train_steps_match_jax(family, frozen):
    # Adam's eps 1e-3 keeps a first update continuous in the gradient
    # (test_torch_alexcap_train.py's two-step test says why)
    cfg = cfg_for(*family).replace(learning_rate=1e-4, eps=1e-3)
    pm, variables = seeded_pair(cfg, seed=9)
    xs = np.stack([images_for(cfg, seed=11 + k) for k in range(2)])
    gts = np.stack([labels(12 + k) for k in range(2)])
    jm = jax_model(cfg, freeze_encoder=frozen)
    tx = jax_optim.make_optimizer(_jax_cfg(cfg), 10, 5 if frozen else 0)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_step.TrainState(jnp.array(0, jnp.int32), params,
                                tx.init(params),
                                variables.get("batch_stats", {}),
                                jax.random.PRNGKey(1))
    jstep = jax.jit(jax_step.make_train_step(jm, tx))
    model = build_model(cfg, 20, 6, freeze_encoder=frozen)
    model.load_state_dict(pm.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.make_optimizer(cfg, model, 10)
    step = make_train_step(model, opt, torch.Generator().manual_seed(0),
                           clip_norm=1.0)
    for k in range(2):
        state, metrics = jstep(state, jnp.asarray(xs[k]),
                               jnp.asarray(gts[k]))
        got = step(torch.from_numpy(xs[k]), torch.from_numpy(gts[k]))
        assert float(got["loss"]) == pytest.approx(float(metrics["loss"]),
                                                   rel=1e-5), k
        assert float(got["grad_norm"]) == pytest.approx(
            float(metrics["grad_norm"]), rel=1e-4), k
    want = captioner_state_dict_from_jax(_np(state.params),
                                         _stats_of({"batch_stats": _np(
                                             state.batch_stats)}))
    got_sd = model.state_dict()
    for name, t in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got_sd[name].numpy(), t.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    if family[0] == "transformer":
        # the quirk: the trunk trains in mode only — statistics move,
        # weights never
        for name, t in before.items():
            if not name.startswith("features."):
                continue
            moved = not torch.equal(got_sd[name], t)
            assert moved == name.endswith(("running_mean", "running_var",
                                           "num_batches_tracked")), name
        assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
                   for p in model.features.parameters())


# --------------------------------------------------- module 14: eval

@pytest.mark.parametrize("model_type,use_beam", [
    ("lstm_attention", False), ("transformer", True), ("vitb", True)],
    ids=["attention-greedy", "transformer-beam3", "vitb-beam3"])
def test_eval_split_matches_jax(model_type, use_beam):
    arrays, info = jax_synthetic.make_face2text_arrays(num_images=20, seed=2)
    port_loader = AlexDataLoader(arrays=arrays, info=info, seed=7)
    jax_loader = JaxLoader(arrays=arrays, info=info, seed=7)
    vocab, seq = port_loader.getVocabSize(), port_loader.getSeqLength()
    cfg = cfg_for(model_type)
    if model_type == "vitb":
        cfg = cfg.replace(vit_dims=(224, 16, 2, 2, 32, 64))
    model, variables = seeded_pair(cfg, seed=16, vocab=vocab, seq=seq)
    kw = dict(split=0, batch_size=4, use_beam=use_beam, beam_size=3,
              max_images=8, return_records=True)
    want = jax_eval_split(jax_model(cfg, vocab, seq), variables, jax_loader,
                          preprocess=jax_transforms.resnet_v2_preprocess,
                          **kw)
    got = eval_split(model, port_loader, preprocess=resnet_v2_preprocess,
                     **kw)
    assert got["num_images"] == want["num_images"] == 8
    assert got["records"] == want["records"]
    for key in ("meteor", "bleu", "bleu4", "cider"):
        assert got["ap_results"][key] == pytest.approx(
            want["ap_results"][key], abs=1e-9), key


# ------------------------------------------------ module 10: encoder_init

def _write_npz(path, variables, module):
    tree = {"params": variables["params"][module]}
    if variables.get("batch_stats"):
        tree["batch_stats"] = variables["batch_stats"][module]
    np.savez(path, **jax_pretrained.flatten_tree(tree))
    return jax_pretrained.load_npz_variables(str(path))


@pytest.mark.parametrize("family", [("lstm_attention", False),
                                    ("transformer", True), ("vitb", False)],
                         ids=["resnet", "vggface", "vit"])
def test_encoder_init_matches_jax(family, tmp_path):
    cfg = cfg_for(*family)
    model, variables = seeded_pair(cfg, seed=13)
    _, source = seeded_pair(cfg, seed=14)
    module = encoder_name(cfg.model_type)
    npz = _write_npz(tmp_path / "enc.npz", source, module)
    params, stats = jax_pretrained.merge_module(
        variables["params"], variables.get("batch_stats"), module, npz)
    want = captioner_state_dict_from_jax(params, stats)
    pretrained.apply_encoder_init(model, str(tmp_path / "enc.npz"), module)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[name].numpy(), t.numpy(),
                                          err_msg=name)
    moved = [n for n in got if n.startswith(module + ".")
             and not n.endswith("num_batches_tracked")]
    src = captioner_state_dict_from_jax(source["params"],
                                        _stats_of(source))
    assert moved and all(torch.equal(got[n], src[n]) for n in moved)


def _drop(tree, path):
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree[p]
    return tree.pop(leaf)


@pytest.mark.parametrize("change", ["extra", "missing", "reshaped",
                                    "no-stats", "unknown-module"])
def test_encoder_init_refuses_a_structural_mismatch(change, tmp_path):
    cfg = cfg_for("lstm_attention")
    model, variables = seeded_pair(cfg, seed=15)
    tree = {"params": jax.tree.map(np.copy, variables["params"]["features"]),
            "batch_stats": jax.tree.map(np.copy,
                                        variables["batch_stats"]["features"])}
    spec = str(tmp_path / "enc.npz")
    if change == "extra":
        tree["params"]["layer1_0"]["extra"] = {"kernel": np.zeros(3)}
    elif change == "missing":
        _drop(tree, "params/layer4_0/bn2/scale")
    elif change == "reshaped":
        tree["params"]["conv1"]["kernel"] = np.zeros((3, 3, 3, 64),
                                                     np.float32)
    elif change == "no-stats":
        del tree["batch_stats"]
    else:
        spec = "decoder=" + spec
    np.savez(tmp_path / "enc.npz", **jax_pretrained.flatten_tree(tree))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    err = KeyError if change == "unknown-module" else ValueError
    with pytest.raises(err, match="encoder_init"):
        pretrained.apply_encoder_init(model, spec, "features")
    assert all(torch.equal(v, before[k]) for k, v in
               model.state_dict().items())


# ------------------------------------- module 11: the entry points

ENTRY = {
    train_LSTMwAttention: ["backbone_stages=1,1,1,1", "embedding_size=16",
                           "lstm_size=16"],
    train_Transformer: ["backbone_stages=1,1,1,1", "transformer_size=16",
                        "num_layers=1", "num_heads=2"],
    train_ViTB: ["vit_dims=224,16,1,2,16,32", "embedding_size=16",
                 "num_layers=1", "num_heads=2"],
}


@pytest.mark.parametrize("entry", list(ENTRY),
                         ids=["LSTMwAttention", "Transformer", "ViTB"])
def test_entry_point_trains_and_resumes_on_the_cpu(entry, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--smoke", "--device", "cpu", "--eval-every", "2"]
    # the trunk frozen throughout, so that the checkpoint holds no Adam
    # moments for it: a cut ResNet trunk keeps its widths, 8.5 M weights
    sets = ["--set", *ENTRY[entry], "compute_dtype=float32",
            "save_checkpoint_every=8", "eval_val_batch_size=2",
            "finetuning_after_nepoch=100"]
    first = cli.main(entry.MODEL_TYPE, args + ["--max-iter", "2"] + sets)
    assert first["iters"] == 2 and np.isfinite(first["final_loss"])
    assert os.path.isfile(first["save_path"])
    assert os.path.getsize(first["save_path"]) < (
        2e6 if entry is train_ViTB else 40e6)
    assert first["final_test"]["greedy"]["num_images"] > 0
    resumed = cli.main(entry.MODEL_TYPE, args + ["--max-iter", "4"] + sets
                       + ["from_checkpoint=true"])
    assert resumed["iters"] == 4 and np.isfinite(resumed["final_loss"])
    iters = [r["iter"] for r in json.loads(open(first["loss_file"]).read())]
    assert iters == [1, 2, 3, 4]


def test_new_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in ENTRY:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(entry.MODEL_TYPE, ["--smoke"])
