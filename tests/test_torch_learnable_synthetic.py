"""The port's learnable synthetic datasets and HDF5 writers against the JAX
package (`data/synthetic.py`).

- `make_learnable_face2text_arrays` and `make_learnable_vg_arrays`
  byte-identical to JAX's for two seeds (every array, its dtype, and the
  dicts JSON), both being numpy `RandomState` streams;
- their captions describe the rendered image (hair and shirt colours of a
  face; a box's colour and half), as JAX's tests hold them;
- `write_face2text_h5` and `write_vg_h5` write JAX's files, and the files
  round-trip through the port's `AlexDataLoader` and `VGDataLoader`;
- the dense drivers' loader on learnable data equal to JAX's.
"""

import json

import numpy as np
import pytest

from imagecaptioning_tpu.data import synthetic as jax_synthetic
from imagecaptioning_tpu.train import dense_driver as jax_dense_driver
from imagecaptioning_tpu.config import dense_configs as jax_dense_configs
from imagecaptioning_tpu_torch.config import dense_configs
from imagecaptioning_tpu_torch.data import synthetic
from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
from imagecaptioning_tpu_torch.data.tokenizer import Vocab
from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader
from imagecaptioning_tpu_torch.train import dense_driver
import torch_threads  # noqa: F401  (one torch thread a test process)


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", ["face2text", "vg"])
def test_learnable_arrays_match_jax(kind, seed):
    if kind == "face2text":
        kw = dict(num_images=20, seed=seed)
        name = "make_learnable_face2text_arrays"
    else:
        kw = dict(num_images=7, image_size=96, seed=seed)
        name = "make_learnable_vg_arrays"
    got, got_info = getattr(synthetic, name)(**kw)
    want, want_info = getattr(jax_synthetic, name)(**kw)
    _assert_same_arrays(got, want)
    assert json.dumps(got_info, sort_keys=True) == json.dumps(want_info,
                                                              sort_keys=True)


def test_learnable_captions_describe_the_image():
    arrays, info = synthetic.make_learnable_face2text_arrays(
        num_images=12, seed=0, noise=0.0)
    assert arrays["images"].shape == (12, 218, 178, 3)
    assert arrays["labels"].shape[0] == 24             # 2 captions an image
    vocab = Vocab(info["token_to_idx"], info["idx_to_token"])
    h = arrays["images"].shape[1]
    for i in range(12):
        cap = vocab.decode_row(
            arrays["labels"][arrays["img_to_first_phr"][i]]).split()
        img = arrays["images"][i]
        hair = [w for w, c in synthetic._HAIR.items()
                if c == tuple(img[int(0.2 * h), 5])]      # below a hat
        shirt = [w for w, c in synthetic._SHIRT.items()
                 if c == tuple(img[-5, 5])]
        assert hair and hair[0] in cap, cap
        assert shirt and shirt[0] in cap, cap


def test_learnable_vg_captions_describe_their_boxes():
    arrays, info = synthetic.make_learnable_vg_arrays(
        num_images=6, image_size=128, seed=1, noise=0.0)
    assert arrays["boxes"].shape == (24, 4)                # 4 an image
    vocab = Vocab(info["token_to_idx"], info["idx_to_token"])
    for i in range(6):
        for r in range(4):
            k = arrays["img_to_first_box"][i] - 1 + r
            cap = vocab.decode_row(arrays["labels"][k]).split()
            xc, yc, _, _ = arrays["boxes"][k]
            px = tuple(arrays["images"][i, int(yc - 1), int(xc - 1)])
            color = [c for c, v in synthetic._BOX_COLORS.items() if v == px]
            assert color and color[0] in cap, cap
            half = ("top", "upper") if yc <= 64 else ("bottom", "lower")
            assert any(w in cap for w in half), cap


@pytest.mark.parametrize("kind", ["face2text", "vg"])
def test_hdf5_writer_round_trips(tmp_path, kind):
    h5py = pytest.importorskip("h5py")
    if kind == "face2text":
        kw = dict(num_images=10, seed=2)
        write, make = synthetic.write_face2text_h5, \
            synthetic.make_face2text_arrays
        jax_write = jax_synthetic.write_face2text_h5
    else:
        kw = dict(num_images=5, image_size=64, seed=2)
        write, make = synthetic.write_vg_h5, synthetic.make_vg_arrays
        jax_write = jax_synthetic.write_vg_h5
    paths = {side: (str(tmp_path / f"{side}.h5"),
                    str(tmp_path / f"{side}.json"))
             for side in ("port", "jax")}
    write(*paths["port"], **kw)
    jax_write(*paths["jax"], **kw)
    with h5py.File(paths["port"][0]) as a, h5py.File(paths["jax"][0]) as b:
        _assert_same_arrays({k: a[k][()] for k in a}, {k: b[k][()] for k in b})
    assert json.load(open(paths["port"][1])) == json.load(
        open(paths["jax"][1]))
    arrays, info = make(**kw)
    h5_path, json_path = paths["port"]
    if kind == "face2text":
        from_file = AlexDataLoader(data_h5=h5_path, data_json=json_path,
                                   seed=4)
        in_memory = AlexDataLoader(arrays=arrays, info=info, seed=4)
        pairs = zip(from_file.epoch_batches(0, 3, shuffle=True),
                    in_memory.epoch_batches(0, 3, shuffle=True))
        for (gi, gl), (wi, wl) in pairs:
            assert gi.tobytes() == wi.tobytes() and gl.tobytes() == \
                wl.tobytes()
    else:
        from_file = VGDataLoader(data_h5=h5_path, data_json=json_path)
        in_memory = VGDataLoader(arrays=arrays, info=info)
        for b1, b2 in zip(from_file.padded_batches(0, 2, 6),
                          in_memory.padded_batches(0, 2, 6)):
            for k in b2:
                assert b1[k].tobytes() == b2[k].tobytes(), k
    assert from_file.getVocabSize() == in_memory.getVocabSize()


def test_dense_loader_on_learnable_data_matches_jax(tmp_path):
    kw = dict(data_h5=str(tmp_path / "missing.h5"), seed=3)
    port = dense_driver.make_vg_loader(
        dense_configs.get_gt_config().replace(**kw), synthetic_images=6,
        image_size=64, synthetic_seq_length=10, synthetic_learnable=True)
    want = jax_dense_driver.make_vg_loader(
        jax_dense_configs.get_gt_config().replace(**kw), synthetic_images=6,
        image_size=64, synthetic_seq_length=10, synthetic_learnable=True)
    assert port.getSeqLength() == want.getSeqLength() == 10
    assert port.vocab.token_to_idx == want.vocab.token_to_idx
    assert "box" in port.vocab.token_to_idx
    for b1, b2 in zip(port.padded_batches(0, 2, 4),
                      want.padded_batches(0, 2, 4, shuffle=False)):
        for k in b2:
            assert np.asarray(b1[k]).tobytes() == np.asarray(
                b2[k]).tobytes(), k
