"""The port's checkpoint interchange (`utils/torch_port.py`,
`convert_checkpoint.py`) against the JAX package's, on the same seeded
state dicts at tiny sizes:

- every `convert_*` / `export_*` of a backbone and of a whole reference
  checkpoint of each family (LSTM on ResNet and on VGGFace, attention,
  Transformer, ViT-B, GT with either head): each array bitwise equal
  (`np.array_equal`, same dtype), `meta` equal, `detect_reference_family`
  equal and right for all five families;
- each CLI sub-command: `import`/`export` per architecture against the
  JAX CLI's `.npz` and `.pth`; `import-model`/`export-model` against the
  JAX CLI's orbax round trip (the port's `.npz` equal to what the JAX
  checkpoint restores, its export from the port checkpoint and from the
  `.npz` equal to the JAX export), and the refusal of a directory;
- round trips into the port's models: `encoder_init` from converted
  trunks (ResNet, and a VGG classifier of 128 channels, which the JAX
  converter's fixed 512 misreads), and `infer` from an imported
  reference `.pth`, with tokens identical to the seeded model's.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import convert_checkpoint as jax_cli
from imagecaptioning_tpu.utils import torch_port as jtp
from imagecaptioning_tpu.utils.checkpoint import restore_params
from imagecaptioning_tpu_torch import convert_checkpoint as cli
from imagecaptioning_tpu_torch import infer
from imagecaptioning_tpu_torch.config.configs import get_config
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.models import api
from imagecaptioning_tpu_torch.models.captioners import build_model
from imagecaptioning_tpu_torch.models.densecap import GTDenseCaptioner
from imagecaptioning_tpu_torch.utils import torch_port as tp
from imagecaptioning_tpu_torch.utils import weights
from imagecaptioning_tpu_torch.utils.pretrained import (apply_encoder_init,
                                                        flatten_tree)
import torch_threads  # noqa: F401  (one torch thread a test process)

CUT = dict(backbone_stages=(1, 1, 1, 1), compute_dtype="float32",
           use_dropout=False)
FAMILY_SETS = {
    "lstm": dict(embedding_size=16, lstm_size=16),
    "lstm_attention": dict(embedding_size=16, lstm_size=16),
    "transformer": dict(transformer_size=32, num_layers=2, num_heads=4),
    "vitb": dict(vit_dims=(224, 16, 2, 2, 32, 64), embedding_size=32,
                 num_layers=2, num_heads=4),
}


def _a(v):
    return v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)


def _assert_flat_equal(got, want):
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for k in want:
        g, w = _a(got[k]), _a(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _assert_tree_equal(got, want):
    _assert_flat_equal(flatten_tree(got), flatten_tree(want))


def _rand(rng, shapes):
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _vgg_features_shapes(prefix="features", width=2, last=512):
    """torchvision vgg16.features keys, every conv `width` channels but
    the last, which gives the classifier its `last` channels."""
    shapes, c_in = {}, 3
    convs = weights.vgg_conv_indices()
    for idx in convs:
        c_out = last if idx == convs[-1] else width
        shapes[f"{prefix}.{idx}.weight"] = (c_out, c_in, 3, 3)
        shapes[f"{prefix}.{idx}.bias"] = (c_out,)
        c_in = c_out
    return shapes


def _resnet_shapes(stages, width=2):
    """torchvision resnet keys at `width` channels everywhere, with
    num_batches_tracked as real checkpoints carry it."""
    shapes = {"conv1.weight": (width, 3, 7, 7)}
    bns = ["bn1"]
    for s, n in enumerate(stages):
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            for i, k in ((1, 1), (2, 3), (3, 1)):
                shapes[f"{t}.conv{i}.weight"] = (width, width, k, k)
                bns.append(f"{t}.bn{i}")
            if b == 0:
                shapes[f"{t}.downsample.0.weight"] = (width, width, 1, 1)
                bns.append(f"{t}.downsample.1")
    for bn in bns:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{leaf}"] = (width,)
    return shapes, bns


def _resnet_sd(rng, stages):
    shapes, bns = _resnet_shapes(stages)
    sd = _rand(rng, shapes)
    for bn in bns:
        sd[f"{bn}.running_var"] = np.abs(sd[f"{bn}.running_var"])
        sd[f"{bn}.num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def _vit_shapes(layers, hidden, mlp=8, tokens=5):
    shapes = {"conv_proj.weight": (hidden, 3, 2, 2),
              "conv_proj.bias": (hidden,), "class_token": (1, 1, hidden),
              "encoder.pos_embedding": (1, tokens, hidden),
              "encoder.ln.weight": (hidden,), "encoder.ln.bias": (hidden,)}
    for i in range(layers):
        t = f"encoder.layers.encoder_layer_{i}"
        shapes.update({
            f"{t}.self_attention.in_proj_weight": (3 * hidden, hidden),
            f"{t}.self_attention.in_proj_bias": (3 * hidden,),
            f"{t}.self_attention.out_proj.weight": (hidden, hidden),
            f"{t}.self_attention.out_proj.bias": (hidden,),
            f"{t}.ln_1.weight": (hidden,), f"{t}.ln_1.bias": (hidden,),
            f"{t}.ln_2.weight": (hidden,), f"{t}.ln_2.bias": (hidden,),
            f"{t}.mlp.0.weight": (mlp, hidden), f"{t}.mlp.0.bias": (mlp,),
            f"{t}.mlp.3.weight": (hidden, mlp),
            f"{t}.mlp.3.bias": (hidden,)})
    return shapes


def _classifier_shapes(channels=512, hidden=8, out=8):
    return {"classifier.0.weight": (hidden, channels * 49),
            "classifier.0.bias": (hidden,),
            "classifier.3.weight": (out, hidden), "classifier.3.bias": (out,)}


def _np_sd(model, **extra):
    return {**{k: v.numpy().copy() for k, v in model.state_dict().items()},
            **extra}


def _family_model(model_type, seed=0):
    cfg = get_config(model_type).replace(**CUT, **FAMILY_SETS[model_type])
    return weights.seeded_init_(build_model(cfg, 20, 5).eval(), seed)


def _gt_reference_sd(use_lstm, rng):
    """A reference AlexGTModel state dict: a 5-stage VGG16 trunk (2
    channels a conv, 512 out), a narrow classifier over 512 pooled channels, a
    tiny LSTM head or the default transformer head, the duplicate net.*
    registrations, and for the transformer its dead encoder word
    embedding and full position table."""
    head = GTDenseCaptioner(vocab_size=24, seq_length=5, use_lstm=use_lstm,
                            embedding_size=16, rnn_size=16, vgg_stages=1)
    sd = {k: v for k, v in _np_sd(weights.seeded_init_(head, 0)).items()
          if k.startswith("llm.")}
    sd.update(_rand(rng, {**_vgg_features_shapes(),
                          **_classifier_shapes(out=4096)}))
    if not use_lstm:
        dec = sd["llm.decoder.position_embedding.weight"]
        pos = np.zeros_like(dec)
        pos[:1] = sd["llm.encoder.position_embedding.weight"]
        sd["llm.encoder.position_embedding.weight"] = pos
        sd["llm.encoder.word_embedding.weight"] = rng.randn(
            *sd["llm.decoder.word_embedding.weight"].shape).astype(np.float32)
    return tp.reference_layout(sd)


def _reference_sd(family):
    """(the reference state dict of `family`, its expected detected
    family, the ViT head count)."""
    rng = np.random.RandomState(3)
    if family == "gt_lstm":
        return _gt_reference_sd(True, rng), "gt", 12
    if family == "gt_transformer":
        return _gt_reference_sd(False, rng), "gt", 12
    if family == "lstm_vggface":
        cfg = get_config("lstm").replace(use_vggface=True, **CUT,
                                         **FAMILY_SETS["lstm"])
        model = weights.seeded_init_(build_model(cfg, 20, 5), 0)
        return _np_sd(model), "lstm", 12
    sd = tp.reference_layout(_np_sd(_family_model(family)))
    want = {"lstm_attention": "attention"}.get(family, family)
    return sd, want, 2


FAMILIES = ("lstm", "lstm_vggface", "lstm_attention", "transformer", "vitb",
            "gt_lstm", "gt_transformer")


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_checkpoint_converters_match_jax(family):
    sd, want_family, heads = _reference_sd(family)
    assert tp.detect_reference_family(sd) == want_family
    assert jtp.detect_reference_family(sd) == want_family
    got, got_meta = tp.convert_reference_captioner(sd, vit_heads=heads)
    want, want_meta = jtp.convert_reference_captioner(sd, vit_heads=heads)
    _assert_tree_equal(got, want)
    assert got_meta == want_meta
    assert tp.detect_our_family(got["params"]) == jtp.detect_our_family(
        want["params"])
    got_sd, got_meta = tp.export_reference_captioner(got)
    want_sd, want_meta = jtp.export_reference_captioner(want)
    _assert_flat_equal(got_sd, want_sd)
    assert got_meta == want_meta
    with pytest.raises(ValueError, match="unrecognized"):
        tp.detect_reference_family({"fc.weight": np.zeros(1)})


def _backbone(arch, rng):
    """(a torch-layout state dict at tiny widths, its convert(module, sd),
    its export(module, variables)), `module` either package's
    `torch_port`."""
    if arch == "resnet101":
        return (_resnet_sd(rng, (3, 4, 23, 3)),
                lambda m, sd: m.convert_resnet(sd, depth=101),
                lambda m, v: m.export_resnet(v, depth=101))
    if arch == "sequential_resnet":
        sd = {f"features.{k}": v for k, v in _resnet_sd(rng, (1, 2, 1, 1))
              .items()}
        for old, new in (("conv1", "0"), ("bn1", "1"), ("layer1", "4"),
                         ("layer2", "5"), ("layer3", "6"), ("layer4", "7")):
            sd = {k.replace(f"features.{old}.", f"features.{new}."): v
                  for k, v in sd.items()}
        return (sd, lambda m, sd: m.convert_sequential_resnet(sd)[0],
                lambda m, v: m.export_sequential_resnet(v))
    if arch == "vgg16_features":
        return (_rand(rng, _vgg_features_shapes()),
                lambda m, sd: m.convert_vgg_features(sd),
                lambda m, v: m.export_vgg_features(v))
    if arch == "vgg16_classifier":
        return (_rand(rng, _classifier_shapes()),
                lambda m, sd: m.convert_vgg_classifier(sd),
                lambda m, v: m.export_vgg_classifier(v))
    return (_rand(rng, _vit_shapes(2, 8)),
            lambda m, sd: m.convert_vit(sd, num_layers=2, num_heads=2,
                                        hidden=8),
            lambda m, v: m.export_vit(v, num_layers=2, num_heads=2,
                                      hidden=8))


@pytest.mark.parametrize("arch", ["resnet101", "sequential_resnet",
                                  "vgg16_features", "vgg16_classifier",
                                  "vit"])
def test_backbone_converters_match_jax(arch):
    sd, convert, export = _backbone(arch, np.random.RandomState(4))
    got, want = convert(tp, sd), convert(jtp, sd)
    _assert_tree_equal(got, want)
    back = export(tp, got)
    _assert_flat_equal(back, export(jtp, want))
    _assert_flat_equal(back, sd)


def test_vgg_classifier_reads_its_channel_count_from_fc6():
    """A classifier over 128 pooled channels (a 2-stage trunk): the JAX
    converter's fixed 512 folds fc6 into the wrong shape; the port's
    round-trips it and agrees with the trainers' converter."""
    sd = _rand(np.random.RandomState(5), _classifier_shapes(channels=128))
    misread = jtp.convert_vgg_classifier(sd)["params"]["fc6"]["kernel"]
    assert misread.shape == (512 * 49, 2)
    variables = tp.convert_vgg_classifier(sd)
    assert variables["params"]["fc6"]["kernel"].shape == (128 * 49, 8)
    _assert_flat_equal(tp.export_vgg_classifier(variables), sd)
    _assert_flat_equal(weights.vgg_classifier_state_dict(
        variables["params"], channels=128), sd)


def _cli_source(arch, rng):
    if arch == "resnet101":
        return _resnet_sd(rng, (3, 4, 23, 3))
    if arch == "vgg16_features":
        return _rand(rng, _vgg_features_shapes())
    if arch == "vgg16_classifier":
        return _rand(rng, _classifier_shapes())
    return _rand(rng, _vit_shapes(12, 768))      # the CLI's ViT-B/16 dims


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _pth(path):
    return torch.load(path, weights_only=True)


@pytest.mark.parametrize("arch", ["resnet101", "vgg16_features",
                                  "vgg16_classifier", "vit_b_16"])
def test_import_and_export_cli_match_jax(tmp_path, arch):
    src = str(tmp_path / "src.pth")
    tp.save_state_dict(src, _cli_source(arch, np.random.RandomState(6)))
    for main, name in ((cli.main, "port"), (jax_cli.main, "jax")):
        main(["import", "--arch", arch, "--src", src,
              "--dst", str(tmp_path / f"{name}.npz")])
        main(["export", "--arch", arch, "--src", str(tmp_path / "port.npz"),
              "--dst", str(tmp_path / f"{name}.pth")])
    _assert_flat_equal(_npz(tmp_path / "port.npz"),
                       _npz(tmp_path / "jax.npz"))
    _assert_flat_equal(_pth(tmp_path / "port.pth"),
                       _pth(tmp_path / "jax.pth"))
    _assert_flat_equal(_pth(tmp_path / "port.pth"), _pth(src))


@pytest.mark.parametrize("family", ["gt_transformer", "lstm"])
def test_import_model_and_export_model_cli_match_jax(tmp_path, family):
    sd, want_family, _ = _reference_sd(family)
    src, ckpt, npz = (str(tmp_path / n) for n in ("src.pth", "port.ckpt",
                                                  "port.npz"))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    meta = cli.main(["import-model", "--src", src, "--dst", ckpt,
                     "--npz", npz])
    jax_cli.main(["import-model", "--src", src,
                  "--dst", str(tmp_path / "jax_ckpt")])
    assert meta["family"] == want_family
    load = (weights.load_gt_checkpoint if want_family == "gt"
            else weights.load_alexcap_checkpoint)
    _assert_flat_equal(load(ckpt), load(src))
    params, stats = restore_params(str(tmp_path / "jax_ckpt"))
    _assert_flat_equal(_npz(npz), flatten_tree(
        {"params": params, "batch_stats": stats}))
    for name, source in (("from_ckpt", ckpt), ("from_npz", npz)):
        cli.main(["export-model", "--src", source,
                  "--dst", str(tmp_path / f"{name}.pth")])
    jax_cli.main(["export-model", "--src", str(tmp_path / "jax_ckpt"),
                  "--dst", str(tmp_path / "jax.pth")])
    want = _pth(tmp_path / "jax.pth")
    for name in ("from_ckpt", "from_npz"):
        _assert_flat_equal(_pth(tmp_path / f"{name}.pth"), want)
    # what the loader keeps of the export is what it kept of the source;
    # both CLIs write BatchNorm's 0-d step counters as 1-element tensors
    kept = load(str(tmp_path / "from_npz.pth"))
    _assert_flat_equal({k: v.reshape(()) if k.endswith("_tracked") else v
                        for k, v in kept.items()}, load(src))
    with pytest.raises(SystemExit, match="JAX"):
        cli.main(["export-model", "--src", str(tmp_path / "jax_ckpt"),
                  "--dst", str(tmp_path / "x.pth")])


def _to_torchvision_resnet(sd):
    """The port's `features.{0,1,4-7}` ResNet keys → torchvision's."""
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
             "6": "layer3", "7": "layer4"}
    out = {}
    for k, v in sd.items():
        if k.startswith("features."):
            head, _, tail = k[len("features."):].partition(".")
            out[f"{names[head]}.{tail}"] = v
    return out


def _greedy(model, images):
    from imagecaptioning_tpu_torch.data.transforms import resnet_v2_preprocess
    return api.make_greedy_fn(model, 6)(resnet_v2_preprocess(images))


def test_encoder_init_from_converted_trunks_keeps_every_tensor(tmp_path):
    """Converted trunks merged by `encoder_init` into models seeded
    otherwise: every tensor equals the source's, and the decodes equal
    the source model's."""
    src = _family_model("lstm")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():       # BatchNorm's scales, shifts and statistics
        for t in [*src.features.parameters(), *src.features.buffers()]:
            if t.dim() == 1 and t.dtype.is_floating_point:
                t.uniform_(0.5, 1.5, generator=gen)
    tv = _to_torchvision_resnet(_np_sd(src))
    npz = tmp_path / "r.npz"
    variables = tp.convert_resnet(tv, stages=(1, 1, 1, 1))
    _assert_tree_equal(variables, jtp.convert_resnet(tv, stages=(1, 1, 1, 1)))
    np.savez(npz, **flatten_tree(variables))
    dst = _family_model("lstm", seed=1)
    dst.llm.load_state_dict(src.llm.state_dict())
    apply_encoder_init(dst, str(npz), "features")
    _assert_flat_equal(dst.features.state_dict(), src.features.state_dict())
    images = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 218, 178, 3), dtype=np.uint8))
    assert torch.equal(_greedy(dst, images), _greedy(src, images))

    # a GT model on a 2-stage trunk: its classifier reads 128 channels,
    # through the CLI
    gts = [weights.seeded_init_(GTDenseCaptioner(
        vocab_size=24, seq_length=5, embedding_size=16, rnn_size=16,
        vgg_stages=2).eval(), seed) for seed in (0, 1)]
    sd = _np_sd(gts[0])
    tp.save_state_dict(str(tmp_path / "vgg16.pth"),
                       {k: v for k, v in sd.items()
                        if k.startswith("classifier.")})
    cli.main(["import", "--arch", "vgg16_classifier",
              "--src", str(tmp_path / "vgg16.pth"),
              "--dst", str(tmp_path / "c.npz")])
    np.savez(tmp_path / "f.npz", **flatten_tree(
        tp.convert_vgg_features(sd, end_stage=2)))
    gts[1].llm.load_state_dict(gts[0].llm.state_dict())
    apply_encoder_init(gts[1], f"features={tmp_path / 'f.npz'},"
                               f"classifier={tmp_path / 'c.npz'}",
                       "features")
    _assert_flat_equal(gts[1].state_dict(), gts[0].state_dict())


def test_infer_serves_an_imported_reference_checkpoint(tmp_path):
    """A reference LSTMModel `.pth` (ResNet cut to one block a stage) →
    `import-model` → `infer --model-type lstm --ckpt`: the captions the
    seeded model gives directly."""
    model = _family_model("lstm")
    src = str(tmp_path / "ref.pth")
    torch.save(model.state_dict(), src)
    cli.main(["import-model", "--src", src,
              "--dst", str(tmp_path / "imported.ckpt")])
    words = [f"w{i}" for i in range(20)]
    dicts = {"token_to_idx": {w: i + 1 for i, w in enumerate(words)},
             "idx_to_token": {str(i + 1): w for i, w in enumerate(words)}}
    (tmp_path / "dicts.json").write_text(json.dumps(dicts))
    imdir = tmp_path / "photos"
    imdir.mkdir()
    rng = np.random.RandomState(1)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (120, 100, 3), dtype=np.uint8)
                        ).save(str(imdir / f"p{i}.png"))
    got = infer.main(["--model-type", "lstm", "--ckpt",
                      str(tmp_path / "imported.ckpt"), "--dicts",
                      str(tmp_path / "dicts.json"), "--images", str(imdir),
                      "--seq-length", "5", "--device", "cpu", "--set",
                      "backbone_stages=1,1,1,1", "embedding_size=16",
                      "lstm_size=16", "compute_dtype=float32"])
    want = infer.alexcap_captions(model, Vocab.from_dicts_json(dicts),
                                  str(imdir), 5)
    assert sorted(got) == ["p0.png", "p1.png"] and got == want
