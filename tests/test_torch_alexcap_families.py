"""The PyTorch port's attention-LSTM, Transformer and ViT-B captioners
against the JAX package, at a tiny size, fp32 on the CPU.

Sizes: ResNet stages (1, 1, 1, 1) on 64×64 images (a 2×2 grid of 2048),
the VGGFace trunk on 32×32 (2×2 of 512); the attention head with
embedding 24 and LSTM 16; the Transformer at E=32, 2 + 2 layers, 4 heads;
the ViT-B family on 32×32 images, patch 16 (5 tokens), 2 layers, 2 heads,
width 32, MLP 64, and a 2-layer decoder at 32; vocabulary 20, captions of
6, batch 2. The port's seeded weights (BatchNorm's and LayerNorm's
scales, biases and statistics, and the class token, drawn away from
their init) go to JAX through the JAX package's own reference-checkpoint
converter (`convert_reference_captioner`; no JAX init), and come back by
the port's `captioner_state_dict_from_jax`; both sides run on the same
numpy inputs.

- `doubly_stochastic_regularizer` within 1e-6 of JAX's;
- the ViT encoder's 1 + 4 tokens within 1e-4, its state dict the JAX
  package's torchvision-layout export;
- per family, and for the VGGFace encoder of the CNN families: the
  teacher-forced logits and alphas within 1e-4 (the Transformer's
  (B, heads, T+1, P) cross-attention, the others' (B, T+1, P));
- greedy tokens identical and its alphas within 1e-4; beam-3 tokens and
  finished flags identical, scores and alphas within 1e-4, with and
  without `length_normalize`;
- the cached decode step by step against the teacher-forced logits on
  NULL-free captions within 1e-5;
- `CaptioningModel`: its loss the eval-mode loss, its greedy and beam-3
  captions and alphas the decoders';
- the JAX variables converted back (`captioner_state_dict_from_jax`) and
  the JAX package's reference-layout export of them
  (`export_reference_captioner`, VitbModel's `proj.*` and top-level
  `encoder.*` renamed by `load_alexcap_checkpoint`) both equal to the
  port's own state dict;
- `infer --model-type` on the CPU for each family, from a port checkpoint
  and from that export saved as a `.pth`: both give the JAX greedy
  captions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioning_tpu.data import transforms as jax_transforms
from imagecaptioning_tpu.data.tokenizer import Vocab as JaxVocab
from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.models import captioners as jax_captioners
from imagecaptioning_tpu.models.backbones.vit import ViTEncoder as JaxViT
from imagecaptioning_tpu.ops import losses as jax_losses
from imagecaptioning_tpu.utils import torch_port
from imagecaptioning_tpu_torch import infer
from imagecaptioning_tpu_torch.config import configs
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.backbones.vit import ViTEncoder
from imagecaptioning_tpu_torch.models.captioners import build_model
from imagecaptioning_tpu_torch.ops import losses
from imagecaptioning_tpu_torch.utils.weights import (
    captioner_state_dict_from_jax, load_alexcap_checkpoint, seeded_init_,
    vit_state_dict)
import torch_threads  # noqa: F401  (one torch thread a test process)

VOCAB, SEQ, STEPS = 20, 6, 7
STAGES = (1, 1, 1, 1)
# (model_type, use_vggface) → the config overrides of the tiny model
FAMILIES = {
    ("lstm_attention", False): dict(embedding_size=24, lstm_size=16),
    ("lstm_attention", True): dict(embedding_size=24, lstm_size=16),
    ("transformer", False): dict(transformer_size=32, num_layers=2,
                                 num_heads=4),
    ("transformer", True): dict(transformer_size=32, num_layers=2,
                                num_heads=4),
    ("vitb", False): dict(embedding_size=32, num_layers=2, num_heads=4,
                          vit_dims=(32, 16, 2, 2, 32, 64)),
}
IDS = ["attention", "attention-vggface", "transformer",
       "transformer-vggface", "vitb"]
MAIN = [("lstm_attention", False), ("transformer", False), ("vitb", False)]
MAIN_IDS = ["attention", "transformer", "vitb"]


@torch.no_grad()
def perturb_(model, seed):
    """Move norms' scales and biases, BatchNorm's statistics and the ViT's
    class token off their init; → `model`."""
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


def reference_layout(sd):
    """The port's state dict → the reference's (VitbModel's `proj.*`,
    `class_token` and `encoder.*` at the top), as numpy."""
    out = {}
    for k, v in sd.items():
        if k.startswith("encoder_vit."):
            k = k[len("encoder_vit."):]
            k = "proj." + k[len("conv_proj."):] if k.startswith(
                "conv_proj.") else k
        out[k] = v.numpy()
    return out


def cfg_for(model_type, use_vggface=False, **kw):
    """The port's config of a tiny family model (dropout off, fp32)."""
    over = FAMILIES[(model_type, use_vggface)]
    return configs.get_config(model_type).replace(
        backbone_stages=STAGES, use_vggface=use_vggface, use_dropout=False,
        compute_dtype="float32", **{**over, **kw})


def jax_model(cfg, vocab=VOCAB, seq=SEQ, freeze_encoder=None):
    from imagecaptioning_tpu.config import configs as jax_configs
    jcfg = jax_configs.get_config(cfg.model_type).replace(
        **{k: getattr(cfg, k) for k in (
            "backbone_stages", "use_vggface", "use_dropout", "compute_dtype",
            "embedding_size", "lstm_size", "transformer_size", "num_layers",
            "num_heads", "vit_dims", "trained_encoder", "drop_value")})
    return jax_captioners.build_model(jcfg, vocab, seq,
                                      freeze_encoder=freeze_encoder)


def seeded_pair(cfg, seed=0, vocab=VOCAB, seq=SEQ):
    """(the port's model from seeded weights, perturbed, in eval mode;
    the same weights as JAX variables, through the JAX package's own
    reference-checkpoint converter)."""
    model = perturb_(seeded_init_(build_model(cfg, vocab, seq), seed),
                     seed + 1)
    heads = cfg.vit_dims[3] if cfg.vit_dims else 12
    variables, _ = torch_port.convert_reference_captioner(
        reference_layout(model.state_dict()), vit_heads=heads)
    return model.eval(), variables


def images_for(cfg, seed=0, n=2):
    size = 32 if cfg.use_vggface or cfg.model_type == "vitb" else 64
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def labels(seed=0, n=2, null_free=False):
    rng = np.random.RandomState(seed + 7)
    gt = rng.randint(1, VOCAB + 1, (n, SEQ)).astype(np.int32)
    if not null_free:
        gt[1, 3:] = 0                                  # a short caption
    return gt


_PAIRS = {}


def pair(family):
    """(cfg, jax model, its variables, the port's model, images, labels),
    built once per family."""
    if family not in _PAIRS:
        cfg = cfg_for(*family)
        pm, variables = seeded_pair(cfg)
        _PAIRS[family] = (cfg, jax_model(cfg), variables, pm,
                          images_for(cfg), labels())
    return _PAIRS[family]


def close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------ modules 1 and 4

@pytest.mark.parametrize("shape", [(2, 7, 4), (3, 5, 49)])
def test_doubly_stochastic_regularizer_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    alphas = rng.dirichlet(np.ones(shape[-1]), shape[:2]).astype(np.float32)
    want = float(jax_losses.doubly_stochastic_regularizer(
        jnp.asarray(alphas)))
    got = float(losses.doubly_stochastic_regularizer(
        torch.from_numpy(alphas)))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(float(((1 - alphas.sum(1)) ** 2).mean()),
                                rel=1e-6)


def test_vit_encoder_matches_jax_and_the_torchvision_layout():
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    pv = perturb_(seeded_init_(ViTEncoder(32, 16, 2, 2, 32, 64), 3), 4)
    sd = {k: v.numpy() for k, v in pv.state_dict().items()}
    params = torch_port.convert_vit(sd, num_layers=2, num_heads=2,
                                    hidden=32)["params"]
    want = np.asarray(JaxViT(image_size=32, patch_size=16, num_layers=2,
                             num_heads=2, hidden_dim=32, mlp_dim=64).apply(
        {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pv(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 5, 32)
    close(got, want)
    back = vit_state_dict(params, prefix="vit")
    assert sorted(back) == sorted(f"vit.{k}" for k in sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[f"vit.{k}"].numpy(), t, err_msg=k)


# --------------------------------------------- modules 2, 3 and 5: models

@pytest.mark.parametrize("family", list(FAMILIES), ids=IDS)
def test_teacher_forced_logits_and_alphas_match_jax(family):
    cfg, jm, variables, pm, x, gt = pair(family)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(gt), train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(gt))
    assert got.logits.shape == (2, SEQ + 1, VOCAB + 3)
    assert got.alphas.shape == want.alphas.shape
    close(got.logits, want.logits)
    close(got.alphas, want.alphas)
    if cfg.model_type == "lstm_attention":   # a softmax over the positions
        close(got.alphas.sum(-1), np.ones((2, SEQ + 1)), 1e-6)


# --------------------------------------------- modules 6 and 7: decoding

@pytest.mark.parametrize("norm", [False, True], ids=["raw", "length-norm"])
@pytest.mark.parametrize("family", list(FAMILIES), ids=IDS)
def test_greedy_and_beam_match_jax(family, norm):
    _, jm, variables, pm, x, _ = pair(family)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want_toks, want_alphas = jax_api.make_greedy_fn(jm, STEPS)(variables, jx)
    toks, alphas = api.make_greedy_fn(pm, STEPS, collect_alphas=True)(tx)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_toks))
    close(alphas, want_alphas)
    assert torch.equal(api.make_greedy_fn(pm, STEPS)(tx), toks)
    # the JAX beam's length normalisation is a flag of `beam_search`
    jbeam = jax.jit(lambda v, images: jax_api.decoding.beam_search(
        *_jax_beam_args(jm, v, images), length_normalize=norm,
        collect_alphas=True, alpha_positions=alphas.shape[-1]))
    want = jbeam(variables, jx)
    got = api.make_beam_fn(pm, STEPS, 3, length_normalize=norm,
                           collect_alphas=True)(tx)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.finished.numpy(),
                                  np.asarray(want.finished))
    close(got.scores, want.scores)
    assert got.alphas.shape == (2, 3, STEPS, alphas.shape[-1])
    close(got.alphas, want.alphas)
    plain = api.make_beam_fn(pm, STEPS, 3, length_normalize=norm)(tx)
    assert plain.alphas is None and torch.equal(plain.tokens, got.tokens)


def _jax_beam_args(jm, variables, images):
    """`jax_api.make_beam_fn`'s beam search, its arguments spelled out so
    that `length_normalize` can be set."""
    params = variables["params"]
    feats = jm.apply(variables, images, method=jm.encode)
    init_carry, step = jax_api.make_step_fn(jm, params)
    carry, step = jax_api._beam_invariant_step(
        init_carry, step, jax_api.decoding.expand_for_beams(feats, 3), STEPS)
    return (step, carry, images.shape[0], 3, VOCAB + 1, VOCAB + 2, STEPS)


@pytest.mark.parametrize("family", MAIN, ids=MAIN_IDS)
def test_cached_decode_matches_teacher_forcing(family):
    _, _, _, pm, x, _ = pair(family)
    gt = torch.from_numpy(labels(5, null_free=True))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        want = pm(tx, gt)
        carry, step = api.make_step_fn(pm, SEQ + 1, collect_alphas=True)(
            pm.encode(tx))
        dec_in = torch.cat([torch.full((2, 1), VOCAB + 1), gt], dim=1)
        for t in range(SEQ + 1):
            carry, logits, alpha = step(carry, dec_in[:, t:t + 1], t)
            torch.testing.assert_close(logits, want.logits[:, t], rtol=1e-5,
                                       atol=1e-5)
            want_alpha = want.alphas[:, t] if want.alphas.dim() == 3 \
                else want.alphas[:, :, t].mean(dim=1)
            torch.testing.assert_close(alpha, want_alpha, rtol=1e-5,
                                       atol=1e-5)


def _vocab():
    words = [f"w{i}" for i in range(VOCAB)]
    return {"token_to_idx": {w: i + 1 for i, w in enumerate(words)},
            "idx_to_token": {str(i + 1): w for i, w in enumerate(words)}}


@pytest.mark.parametrize("family", MAIN, ids=MAIN_IDS)
def test_captioning_model_facade(family):
    _, _, _, pm, x, gt = pair(family)
    tx, tgt = torch.from_numpy(x), torch.from_numpy(gt)
    vocab = Vocab.from_dicts_json(_vocab())
    cm = api.CaptioningModel(pm, vocab, SEQ)
    cm.set_eval(True)
    with torch.no_grad():
        want_loss = pm.loss(pm(tx, tgt), tgt)
    assert float(cm.forward_train({"image": tx, "gt_labels": tgt})) == \
        float(want_loss)
    assert float(cm.forward_train(tx, tgt)) == float(want_loss)
    toks, alphas = api.make_greedy_fn(pm, STEPS, collect_alphas=True)(tx)
    caps, got_alphas = cm.forward_test({"image": tx})
    assert caps == vocab.decode_sequence(toks.numpy())
    assert torch.equal(got_alphas, alphas)
    cm.use_beam = True
    res = api.make_beam_fn(pm, STEPS, 3, collect_alphas=True)(tx)
    caps, got_alphas = cm.forward_test(tx)
    assert caps == vocab.decode_sequence(res.tokens[:, 0].numpy())
    assert torch.equal(got_alphas, res.alphas[:, 0])
    assert cm.llm.decode_sequence(toks) == vocab.decode_sequence(toks.numpy())


# ------------------------------------- modules 12 and 13: weights, infer

def _reference_export(variables):
    sd, _ = torch_port.export_reference_captioner(
        {"params": variables["params"],
         "batch_stats": variables.get("batch_stats", {})})
    return sd


@pytest.mark.parametrize("family", list(FAMILIES), ids=IDS)
def test_state_dict_is_the_reference_layout(family, tmp_path):
    _, _, variables, pm, _, _ = pair(family)
    path = tmp_path / "ref.pth"
    torch_port.save_state_dict(str(path), _reference_export(variables))
    got = load_alexcap_checkpoint(str(path))
    converted = captioner_state_dict_from_jax(variables["params"],
                                              variables.get("batch_stats"))
    want = pm.state_dict()
    assert sorted(got) == sorted(converted) == sorted(want)
    for name, t in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(got[name].numpy(), t.numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(converted[name].numpy(), t.numpy(),
                                      err_msg=name)
    if family[0] == "vitb":
        assert "encoder_vit.conv_proj.weight" in got
        assert "encoder_vit.encoder.layers.encoder_layer_1.mlp.3.bias" in got


INFER_SET = {
    "lstm_attention": ["backbone_stages=1,1,1,1", "embedding_size=24",
                       "lstm_size=16"],
    "transformer": ["backbone_stages=1,1,1,1", "transformer_size=32",
                    "num_layers=2", "num_heads=4"],
    "vitb": ["vit_dims=224,16,2,2,32,64", "embedding_size=32",
             "num_layers=2", "num_heads=4"],
}


@pytest.mark.parametrize("model_type", list(INFER_SET))
def test_infer_cli_serves_each_family_on_the_cpu(model_type, tmp_path):
    from PIL import Image
    cfg = configs.apply_overrides(
        configs.get_config(model_type),
        dict(kv.split("=", 1) for kv in INFER_SET[model_type]))
    cfg = cfg.replace(compute_dtype="float32")
    rng = np.random.RandomState(11)
    images = rng.randint(0, 256, (2, 218, 178, 3), dtype=np.uint8)
    (tmp_path / "photos").mkdir()
    for i, im in enumerate(images):
        Image.fromarray(im).save(tmp_path / f"photos/{i}.png")
    (tmp_path / "dicts.json").write_text(json.dumps(_vocab()))
    x = jax_transforms.resnet_v2_preprocess(jnp.asarray(images))
    pm, variables = seeded_pair(cfg)
    want_toks, _ = jax_api.make_greedy_fn(jax_model(cfg), SEQ + 1)(
        variables, x)
    want = JaxVocab.from_dicts_json(_vocab()).decode_sequence(
        np.asarray(want_toks))
    torch.save({"model": pm.state_dict()}, tmp_path / "port.ckpt")
    torch_port.save_state_dict(str(tmp_path / "ref.pth"),
                               _reference_export(variables))
    for ckpt in ("port.ckpt", "ref.pth"):
        args = ["--model-type", model_type, "--ckpt", str(tmp_path / ckpt),
                "--dicts", str(tmp_path / "dicts.json"), "--images",
                str(tmp_path / "photos"), "--seq-length", str(SEQ),
                "--device", "cpu", "--set", *INFER_SET[model_type],
                "compute_dtype=float32"]
        got = infer.main(args)
        assert [got[f"{i}.png"] for i in range(2)] == want, ckpt
        assert sorted(infer.main(args + ["--beam", "3"])) == ["0.png",
                                                              "1.png"]
