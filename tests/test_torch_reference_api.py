"""The port's last public surface against the JAX package, on the CPU at
a tiny size, with the same numpy inputs on both sides:
- `VGDataLoader`'s reference API: `get_batch` walking a split (wrapping at
  its end or at `debug_max_train_images`), drawing from the seeded
  `RandomState` or taking `idx`; `decodeSequence`, `getVocab`,
  `getImageMaxSize`, `reset_iterator`, `padded_batches(shuffle=True)`,
  the `opt` construction and the lazy HDF5 store: bitwise;
- `dense_driver.setup`: the same family and `with_captioning` as JAX's
  for gt / rpn / `roi_only`, and a port checkpoint restored bitwise;
- `caption_lengths`, `Vocab.encode_tokens`, `default_module_for`:
  identical; `imagenet_preprocess` within 1e-6 absolute in fp32;
- `resnet50_features`, `resnet101_features`, `vit_b16`: the parameter
  names and shapes of JAX's `init` (by `jax.eval_shape`, no forward)
  through the port's converters; the ViT's dropout is the identity in
  eval mode and at p = 0, and one generator seed gives one set of masks;
- the METEOR bridge: both packages' bridges over one stand-in process
  speaking the METEOR-1.5 stdio protocol (no JVM, no jar) give the same
  scores, `score_records` and CLI JSON, and `_sanitize` agrees;
- `load_reference_module` on a fake reference tree: both loaders give
  the same module results, and `sys.path` / `sys.modules` come back;
- `SignalCheckpointer.save_if_requested`, and the dry run's device
  route (NCCL on enough cards, gloo on a shared card, a raise without a
  card, the CPU only when asked), with CUDA's answers monkeypatched.
"""

import json
import os
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioning_tpu.config.dense_configs import \
    get_densecap_config as jax_densecap_config
from imagecaptioning_tpu.data import synthetic as jax_synthetic
from imagecaptioning_tpu.data import tokenizer as jax_tokenizer
from imagecaptioning_tpu.data import transforms as jax_transforms
from imagecaptioning_tpu.data import vg_loader as jax_vg_loader
from imagecaptioning_tpu.eval import meteor_bridge as jax_bridge
from imagecaptioning_tpu.models.backbones import resnet as jax_resnet
from imagecaptioning_tpu.models.backbones import vit as jax_vit
from imagecaptioning_tpu.ops import tokens as jax_tokens
from imagecaptioning_tpu.train import dense_driver as jax_driver
from imagecaptioning_tpu.utils import pretrained as jax_pretrained
from imagecaptioning_tpu.utils import refload as jax_refload
from imagecaptioning_tpu_torch import dryrun
from imagecaptioning_tpu_torch.config.dense_configs import \
    get_densecap_config
from imagecaptioning_tpu_torch.data import transforms, vg_loader
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.eval import meteor_bridge
from imagecaptioning_tpu_torch.models.backbones import resnet, vit
from imagecaptioning_tpu_torch.ops import tokens
from imagecaptioning_tpu_torch.train import dense_driver
from imagecaptioning_tpu_torch.utils import checkpoint as ckptlib
from imagecaptioning_tpu_torch.utils import pretrained, refload, weights
import torch_threads  # noqa: F401  (one torch thread a test process)

# ------------------------------------------------------------ the loader


def _vg_arrays():
    """`make_vg_arrays` with true sizes below the padded square and file
    names, so the crop and the info table carry something."""
    arrays, info = jax_synthetic.make_vg_arrays(num_images=7, seed=5,
                                                regions_per_image=3,
                                                image_size=48, seq_length=6)
    rng = np.random.RandomState(1)
    arrays["image_heights"] = rng.randint(24, 49, 7).astype(np.int32)
    arrays["image_widths"] = rng.randint(24, 49, 7).astype(np.int32)
    arrays["original_heights"] = rng.randint(100, 800, 7).astype(np.int32)
    arrays["original_widths"] = rng.randint(100, 800, 7).astype(np.int32)
    info = {**info, "idx_to_filename": {str(i + 1): f"vg_{i}.jpg"
                                        for i in range(7)}}
    return arrays, info


def _loaders(**kw):
    arrays, info = _vg_arrays()
    return (vg_loader.VGDataLoader(arrays=arrays, info=info, **kw),
            jax_vg_loader.VGDataLoader(arrays=arrays, info=info, **kw))


def _same_batch(got, want):
    *arrays, info = got
    *ref_arrays, ref_info = want
    assert info == ref_info
    for a, b in zip(arrays, ref_arrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("split", [0, 1, 2])
def test_get_batch_iterates_and_wraps_like_jax(split):
    port, ref = _loaders()
    n = len(port.split_ix[split])
    for _ in range(2 * n + 1):
        _same_batch(port.get_batch({"split": split}),
                    ref.get_batch({"split": split}))
        assert port.iterators == ref.iterators
    port.reset_iterator(split)
    ref.reset_iterator(split)
    assert port.iterators[split] == ref.iterators[split] == 0
    _same_batch(port.get_batch({"split": split}),
                ref.get_batch({"split": split}))


@pytest.mark.parametrize("seed", [0, 123])
def test_get_batch_random_draws_like_jax(seed):
    port, ref = _loaders(seed=seed)
    opt = {"split": 0, "iterate": False}
    for _ in range(6):
        _same_batch(port.get_batch(opt), ref.get_batch(opt))
    for idx in (0, 3):
        _same_batch(port.get_batch(opt, idx), ref.get_batch(opt, idx))
    # a batch: (1, H, W, 3) normalized fp32 at the true size, the slab
    img, boxes, labels, info = port.get_batch(opt, 1)
    ix = port.split_ix[0][1]
    assert img.shape == (1, port.image_heights[ix], port.image_widths[ix], 3)
    assert boxes.shape == (1, 3, 4) and labels.shape == (1, 3, 6)
    assert info[0]["split_bounds"] == [2, len(port.split_ix[0])]
    assert info[0]["filename"] == f"vg_{ix}.jpg"


def test_opt_construction_and_debug_max_train_images():
    arrays, info = _vg_arrays()
    opt = {"debug_max_train_images": 2, "data_h5": None}
    port = vg_loader.VGDataLoader(opt, arrays=arrays, info=info)
    ref = jax_vg_loader.VGDataLoader(opt, arrays=arrays, info=info)
    assert port.debug_max_train_images == 2
    seen = []
    for _ in range(5):
        got = port.get_batch({"split": 0})
        _same_batch(got, ref.get_batch({"split": 0}))
        seen.append(got[3][0]["split_bounds"][0])
    assert seen == [1, 2, 1, 2, 1]
    for _ in range(4):
        _same_batch(port.get_batch({"iterate": False}),
                    ref.get_batch({"iterate": False}))


def test_reference_getters_and_decode_match_jax():
    port, ref = _loaders()
    assert port.getImageMaxSize() == ref.getImageMaxSize() == 48
    assert port.getVocab() == ref.getVocab()
    assert port.getSeqLength() == ref.getSeqLength()
    assert port.getVocabSize() == ref.getVocabSize()
    for name in ("num_channels", "num_regions", "max_regions_per_image",
                 "train_ix", "val_ix", "test_ix", "idx_to_token"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("lengths", "box_to_img", "original_heights",
                 "original_widths"):
        assert getattr(port, name).tobytes() == getattr(ref, name).tobytes()
    seq = port.labels[:5].copy()
    seq[1, 2] = port.vocab.end_token
    assert port.decodeSequence(seq) == ref.decodeSequence(seq)
    assert port.decodeSequence(torch.from_numpy(seq)) == \
        ref.decodeSequence(seq)
    with pytest.raises(ValueError):
        port.reset_iterator(3)


@pytest.mark.parametrize("start", [0, 2])
def test_padded_batches_shuffle_matches_jax(start):
    port, ref = _loaders(seed=7)
    for _ in range(2):              # the RandomState advances per epoch
        got = list(port.padded_batches(0, 2, max_regions=4, shuffle=True,
                                       start=start))
        want = list(ref.padded_batches(0, 2, max_regions=4, shuffle=True,
                                       start=start))
        assert len(got) == len(want) > 0
        for b1, b2 in zip(got, want):
            assert sorted(b1) == sorted(b2)
            for k in b1:
                assert b1[k].tobytes() == b2[k].tobytes(), k
    # in order without shuffle: the trainers' path, unchanged
    plain = [b["image"] for b in port.padded_batches(0, 2, 4)]
    assert [b.tobytes() for b in plain] == [
        b["image"].tobytes() for b in ref.padded_batches(0, 2, 4)]


def test_hdf5_store_read_image_by_image(tmp_path):
    h5py = pytest.importorskip("h5py")
    arrays, info = _vg_arrays()
    with h5py.File(tmp_path / "vg.h5", "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    (tmp_path / "vg.json").write_text(json.dumps(info))
    opt = {"data_h5": str(tmp_path / "vg.h5"),
           "data_json": str(tmp_path / "vg.json")}
    port = vg_loader.VGDataLoader(opt, cache_images=False)
    ref = jax_vg_loader.VGDataLoader(opt, cache_images=False)
    assert not isinstance(port.images, np.ndarray)
    for _ in range(3):
        _same_batch(port.get_batch({"split": 0}),
                    ref.get_batch({"split": 0}))
    for b1, b2 in zip(port.padded_batches(0, 2, 3),
                      ref.padded_batches(0, 2, 3)):
        for k in b1:
            assert b1[k].tobytes() == b2[k].tobytes(), k


# ----------------------------------------------------- setup() and helpers


def _small(cfg, **kw):
    return cfg.replace(vgg_stages=2, rnn_size=16, input_encoding_size=16,
                       use_lstm=True, compute_dtype="float32",
                       sampler_batch_size=8, **kw)


@pytest.mark.parametrize("kind", ["gt", "rpn", "roi_only"])
def test_setup_builds_the_family_jax_builds(kind):
    over = {"gt": {"model_type": "gt"}, "rpn": {},
            "roi_only": {"roi_only": True}}[kind]
    model, state = dense_driver.setup(
        _small(get_densecap_config(), **over), 20, 6, device="cpu")
    ref, ref_state = jax_driver.setup(
        _small(jax_densecap_config(), **over), 20, 6)
    assert state is None and ref_state is None
    assert type(model).__name__ == type(ref).__name__
    assert getattr(model, "with_captioning", True) == \
        getattr(ref, "with_captioning", True)
    assert next(model.parameters()).device.type == "cpu"


def test_setup_restores_a_port_checkpoint_bitwise(tmp_path, monkeypatch):
    # the source from another seed, so that only the restore can match it
    cfg = _small(get_densecap_config(), model_type="gt", seed=3)
    src, _ = dense_driver.setup(cfg.replace(seed=11), 20, 6, device="cpu")
    ckptlib.save_checkpoint(str(tmp_path / "gt.ckpt"),
                            {"model": src.state_dict(), "step": 4})
    model, state = dense_driver.setup(
        cfg.replace(checkpoint_start_from=str(tmp_path / "gt.ckpt")), 20, 6,
        device="cpu")
    assert state["step"] == 4
    want = src.state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dense_driver.setup(cfg, 20, 6)


def test_caption_lengths_and_encode_tokens_match_jax():
    rng = np.random.RandomState(2)
    gt = rng.randint(0, 5, size=(6, 9)).astype(np.int32)
    gt[:, 6:] = 0
    got, want = tokens.caption_lengths(gt), jax_tokens.caption_lengths(gt)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert tokens.caption_lengths(torch.from_numpy(gt)).tolist() == \
        want.tolist()
    caps = ["a man rides a red horse", "two dogs on the grass", "a horse"]
    port = Vocab.from_captions(caps, min_token_instances=2)
    ref = jax_tokenizer.Vocab.from_captions(caps, min_token_instances=2)
    for toks in (["a", "horse", "unseen", "a"], [], ["a"] * 12):
        for t in (4, 10):
            got = port.encode_tokens(toks, t)
            want = ref.encode_tokens(toks, t)
            assert got.dtype == want.dtype and got.tobytes() == \
                want.tobytes()
    for cap in caps:
        assert port.encode_caption(cap, 8).tobytes() == \
            ref.encode_caption(cap, 8).tobytes()


def test_imagenet_preprocess_matches_jax():
    images = np.random.RandomState(3).randint(0, 256, (2, 20, 28, 3),
                                              dtype=np.uint8)
    got = transforms.imagenet_preprocess(torch.from_numpy(images))
    want = np.asarray(jax_transforms.imagenet_preprocess(images))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_default_module_for_matches_jax():
    for kind in ("lstm", "lstm_attention", "transformer", "vitb", "rpn",
                 "gt"):
        assert pretrained.default_module_for(kind) == \
            jax_pretrained.default_module_for(kind)


def test_save_if_requested(tmp_path):
    path = str(tmp_path / "pre.ckpt")
    with ckptlib.SignalCheckpointer() as sig:
        assert not sig.save_if_requested(path, {"step": 1})
        assert not os.path.exists(path)
        sig.requested = True            # what the SIGTERM handler sets
        assert sig.save_if_requested(path, {"step": 2})
    assert ckptlib.restore_checkpoint(path) == {"step": 2}


# ----------------------------------------------------------- backbones


def _jax_shapes(module, image):
    x = jnp.zeros((1, image, image, 3), jnp.float32)
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))


def _zeros(tree):
    """Zero arrays of the tree's shapes that hold one element each."""
    zero = np.zeros((), np.float32)
    return jax.tree.map(lambda s: np.broadcast_to(zero, s.shape), tree)


@pytest.mark.parametrize("depth", [50, 101])
def test_resnet_constructors_match_jax_layout(depth):
    ref = getattr(jax_resnet, f"resnet{depth}_features")()
    shapes = _zeros(_jax_shapes(ref, 32))
    want = weights.resnet_state_dict(shapes["params"], shapes["batch_stats"],
                                     prefix="t")
    with torch.device("meta"):
        model = getattr(resnet, f"resnet{depth}_features")(torch.bfloat16)
    assert model.stage_sizes == ref.stage_sizes
    assert model.compute_dtype == torch.bfloat16
    got = model.state_dict()
    assert sorted(got) == sorted(k[2:] for k in want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want["t." + k].shape), k


def test_vit_b16_matches_jax_layout():
    shapes = _zeros(_jax_shapes(jax_vit.vit_b16(), 224))
    want = weights.vit_state_dict(shapes["params"], prefix="e")
    with torch.device("meta"):
        model = vit.vit_b16(dropout=0.1)
    got = model.state_dict()
    assert sorted(got) == sorted(k[2:] for k in want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want["e." + k].shape), k
    assert model.dropout == 0.1 and all(
        block.dropout == 0.1 for block in model.encoder.layers)


def test_vit_dropout():
    dims = (32, 16, 2, 4, 32, 64)        # image, patch, layers, heads, D, mlp
    plain = weights.seeded_init_(vit.ViTEncoder(*dims), 0)
    drop = vit.ViTEncoder(*dims, dropout=0.25)
    drop.load_state_dict(plain.state_dict())
    assert sorted(drop.state_dict()) == sorted(plain.state_dict())
    x = torch.rand((3, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    eval_out = plain(x)
    # the identity in eval mode and at p = 0
    assert torch.equal(drop(x), eval_out)
    assert torch.equal(plain(x, train=True,
                             generator=torch.Generator().manual_seed(0)),
                       eval_out)
    # in training, a generator's seed fixes the masks
    a = drop(x, train=True, generator=torch.Generator().manual_seed(5))
    b = drop(x, train=True, generator=torch.Generator().manual_seed(5))
    c = drop(x, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, eval_out)
    assert not torch.equal(a, c)


# -------------------------------------------------------- METEOR bridge

# A stand-in scorer process speaking the METEOR-1.5 stdio protocol
# (SCORE -> stats line, EVAL -> float): score = unigram-overlap F1 between
# the candidate and the best reference. It ignores its arguments, so it
# also stands in for `java -jar meteor-1.5.jar ...`.
_FAKE_METEOR = r"""
import sys
for line in sys.stdin:
    parts = [p.strip() for p in line.split('|||')]
    if parts[0] == 'SCORE':
        refs, cand = parts[1:-1], parts[-1].split()
        best = 0.0
        for ref in refs:
            r = ref.split()
            ov = len(set(r) & set(cand))
            if r and cand:
                best = max(best, 2.0 * ov / (len(r) + len(cand)))
        print('%d %.6f' % (len(refs), best), flush=True)
    elif parts[0] == 'EVAL':
        print(parts[1].split()[1], flush=True)
"""

RECORDS = [
    {"candidate": "a man riding a horse", "references": [
        "a man rides a horse", "someone on a brown horse"]},
    {"candidate": "two ||| dogs\non  grass", "references": ["two dogs"]},
    {"candidate": "", "references": ["nothing here"]},
    {"candidate": "x", "references": ["y", "x z"]},
]


@pytest.mark.parametrize("text", [
    "a ||| b", "line one\nline two\r\n", "double  space", " |||  ||| ",
    "plain words", "a||||b"])
def test_sanitize_matches_jax(text):
    assert meteor_bridge._sanitize(text) == jax_bridge._sanitize(text)


def test_bridge_scores_match_jax():
    cmd = [sys.executable, "-u", "-c", _FAKE_METEOR]
    with meteor_bridge.ExternalMeteor(cmd=cmd) as port, \
            jax_bridge.ExternalMeteor(cmd=cmd) as ref:
        for r in RECORDS:
            assert port.score(r["candidate"], r["references"]) == \
                ref.score(r["candidate"], r["references"])
        assert port.score_records(RECORDS) == ref.score_records(RECORDS)
        assert port.score_records([]) == ref.score_records([])
    assert not meteor_bridge.available("")
    with pytest.raises(RuntimeError, match="unavailable"):
        meteor_bridge.ExternalMeteor(jar_path="")


def test_bridge_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs through `--jar` with a stand-in `java` first on PATH."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    java = bin_dir / "java"
    java.write_text(f"#!{sys.executable} -u\n{_FAKE_METEOR}")
    java.chmod(java.stat().st_mode | stat.S_IEXEC)
    jar = tmp_path / "meteor-1.5.jar"
    jar.write_bytes(b"")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    assert meteor_bridge.available(str(jar)) and \
        jax_bridge.available(str(jar))
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps(RECORDS))
    meteor_bridge.main([str(inp), str(tmp_path / "port.json"),
                        "--jar", str(jar)])
    jax_bridge.main([str(inp), str(tmp_path / "jax.json"), "--jar", str(jar)])
    got = (tmp_path / "port.json").read_text()
    assert got == (tmp_path / "jax.json").read_text()
    assert json.loads(got)["scores"][0] == pytest.approx(2 * 3 / 10)


# ----------------------------------------------------- reference loader

_REF_MODULE = """
import easydict
import torchvision.models
from AlexCap.my_utils import double

cfg = easydict.EasyDict(a=1)
cfg.b = double(cfg.a)
try:
    cfg.missing
    MISSING = "no raise"
except AttributeError as e:
    MISSING = repr(e)
RESULT = (dict(cfg), cfg.b, MISSING, hasattr(torchvision, "models"))
"""


def test_load_reference_module_matches_jax(tmp_path):
    root = tmp_path / "reference"
    (root / "AlexCap").mkdir(parents=True)
    (root / "AlexCap" / "my_utils.py").write_text(
        "def double(x):\n    return 2 * x\n")
    (root / "AlexCap" / "config.py").write_text(_REF_MODULE)
    path, modules = list(sys.path), set(sys.modules)
    results = {}
    try:
        for name, load in (("port", refload.load_reference_module),
                           ("jax", jax_refload.load_reference_module)):
            mod = load("AlexCap/config.py", f"ref_config_{name}", str(root))
            results[name] = mod.RESULT
            assert sys.path == path          # the root left sys.path
            for added in set(sys.modules) - modules:
                del sys.modules[added]
    finally:
        sys.path[:] = path
        for added in set(sys.modules) - modules:
            del sys.modules[added]
    assert results["port"] == results["jax"]
    assert results["port"][:2] == ({"a": 1, "b": 2}, 2)
    assert set(sys.modules) == modules and sys.path == path
    assert refload.EasyDict(k=3).k == jax_refload.EasyDict(k=3).k


# ------------------------------------------------------ the dry run's route


@pytest.mark.parametrize("cards,n,want", [
    (4, 2, (["cuda:0", "cuda:1"], "nccl")),
    (2, 2, (["cuda:0", "cuda:1"], "nccl")),
    (1, 2, (["cuda:0", "cuda:0"], "gloo")),
    (2, 4, (["cuda:0", "cuda:1", "cuda:0", "cuda:1"], "gloo")),
])
def test_dryrun_route_on_cards(cards, n, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for device in (None, "cuda"):
        devices, backend, line = dryrun.route(n, device)
        assert (devices, backend) == want
        assert backend in line


def test_dryrun_route_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun.subprocess, "Popen", None)   # never launched
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_lines(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.route(2, "cuda")
    assert dryrun.route(3, "cpu")[:2] == (["cpu"] * 3, "gloo")
    with pytest.raises(ValueError):
        dryrun.route(2, "cuda:1")


def test_dryrun_cli_passes_the_device(monkeypatch):
    calls = []
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device=None: calls.append((n, device)))
    dryrun.main(["multichip", "3", "--device", "cpu"])
    dryrun.main(["multichip"])
    assert calls == [(3, "cpu"), (2, None)]
