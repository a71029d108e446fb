"""The port's offline preprocessing and fixups against the JAX package's,
on tiny synthetic inputs:

- `preprocess_vg.run` and `preprocess_face2text.run` on the same JPEGs,
  JSONs and attribute CSV: every HDF5 dataset `array_equal` with the same
  dtype, the dicts JSON files and returned structs `==`; the port's
  loaders read the files;
- the attribute CSV read with the `csv` module against pandas (row order,
  first match of a repeated id, columns, int64 or float64);
- `run` without h5py raises an ImportError that names it;
- `fixups`: each function's output `==` the JAX one's.
"""

import json
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from imagecaptioning_tpu.data import fixups as jax_fixups
from imagecaptioning_tpu.data import preprocess_face2text as jax_f2t
from imagecaptioning_tpu.data import preprocess_vg as jax_vg
from imagecaptioning_tpu_torch.data import fixups
from imagecaptioning_tpu_torch.data import preprocess_face2text as f2t
from imagecaptioning_tpu_torch.data import preprocess_vg as vg
from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader
import torch_threads  # noqa: F401  (one torch thread a test process)


def _jpg(path, h, w, seed, gray=False):
    rng = np.random.RandomState(seed)
    shape = (h, w) if gray else (h, w, 3)
    Image.fromarray(rng.randint(0, 256, shape, np.uint8)).save(path)


def _assert_h5_equal(got, want):
    with h5py.File(got, "r") as g, h5py.File(want, "r") as w:
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert np.array_equal(g[k][()], w[k][()]), k


def _both(tmp_path, run, jax_run, *args, **kw):
    """Run both packages into their own files → the two returned structs
    and output paths."""
    out = {}
    for name, fn in (("port", run), ("jax", jax_run)):
        h5, js = str(tmp_path / f"{name}.h5"), str(tmp_path / f"{name}.json")
        out[name] = (fn(*args, h5, js, **kw), h5, js)
    (got, g_h5, g_js), (want, w_h5, w_js) = out["port"], out["jax"]
    assert got == want
    _assert_h5_equal(g_h5, w_h5)
    with open(g_js) as f, open(w_js) as g:
        assert json.load(f) == json.load(g)
    return g_h5, g_js


def test_preprocess_vg_matches_jax(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    sizes = {1: (60, 80), 2: (100, 50), 3: (70, 70), 4: (90, 120),
             5: (40, 40), 6: (50, 30)}
    for i, (h, w) in sizes.items():
        _jpg(str(img_dir / f"{i}.jpg"), h, w, seed=i, gray=(i == 2))
    phrases = ["A red box, on the left!", "the blue Sky above — wide",
               "a cat ½ asleep", "one two three four five six seven eight",
               "the red cat"]
    data = []
    for i, (h, w) in sizes.items():
        regions = [{"phrase": phrases[(i + j) % len(phrases)],
                    "x": 1 + 7 * j, "y": 2 + 5 * j,
                    # the last region runs past the image's right edge
                    "width": w // 2 + (w if j == 2 else 0),
                    "height": h // 3} for j in range(3)]
        data.append({"id": i, "regions": regions if i != 5 else []})
    region_json, split_json = tmp_path / "regions.json", tmp_path / "s.json"
    region_json.write_text(json.dumps(data))
    # image 6 is in no split; image 5 has no regions
    split_json.write_text(json.dumps({"train": [1, 2, 5], "val": [3],
                                      "test": [4]}))
    h5, js = _both(tmp_path, vg.run, jax_vg.run, str(region_json),
                   str(img_dir), str(split_json), image_size=48,
                   max_token_length=6, min_token_instances=2, num_workers=2)
    loader = VGDataLoader(data_h5=h5, data_json=js)
    assert loader.num_images == 4


def test_preprocess_face2text_matches_jax(tmp_path):
    img_dir = tmp_path / "celeba"
    img_dir.mkdir()
    names = [f"{i:06d}.jpg" for i in range(1, 8)]
    for i, name in enumerate(names):
        _jpg(str(img_dir / name), 218, 178, seed=i, gray=(i == 3))
    descs = ["A young woman with blond hair.", "He has a short grey beard",
             "smiling man, wearing glasses and a hat today"]
    splits = {}
    for split, idx in (("train", [0, 1, 2, 3]), ("val", [4]),
                       ("test", [5, 6])):
        recs = [{"filename": names[i],
                 "description": [descs[(i + k) % 3] for k in range(1 + i % 2)]}
                for i in idx]
        splits[split] = tmp_path / f"{split}.json"
        splits[split].write_text(json.dumps(recs))
    # rows out of order, one image twice (the first row counts), a spare
    rng = np.random.RandomState(9)
    order = [6, 2, 0, 5, 1, 3, 4, 2]
    lines = ["image_id,Bald,Smiling,Young"]
    lines += [f"{names[i]}," + ",".join(str(v) for v in rng.choice([-1, 1], 3))
              for i in order] + ["999999.jpg,1,1,1"]
    csv_path = tmp_path / "attrs.csv"
    csv_path.write_text("\n".join(lines) + "\n")
    h5, js = _both(tmp_path, f2t.run, jax_f2t.run, str(splits["train"]),
                   str(splits["val"]), str(splits["test"]), str(csv_path),
                   str(img_dir), num_workers=2)
    with h5py.File(h5, "r") as f:
        assert f["attributes"].dtype == np.int64
    loader = AlexDataLoader(data_h5=h5, data_json=js)
    assert loader.vocab_size > 0


@pytest.mark.parametrize("rows", [
    ["a.jpg,-1,1", "b.jpg,1,-1", "a.jpg,1,1"],        # CelebA's -1/1
    ["a.jpg,-1,0.5", "b.jpg,1,2"],                     # one fraction
    ["a.jpg,-1,", "b.jpg,1,1"],                        # an empty cell
], ids=["int", "float", "empty"])
def test_attribute_csv_reads_as_pandas_does(tmp_path, rows):
    path = tmp_path / "a.csv"
    path.write_text("\n".join(["image_id,x,y", *rows]) + "\n")
    ids, values, columns = f2t.read_attributes(str(path))
    frame = pd.read_csv(path, index_col="image_id")
    assert ids == list(frame.index) and columns == list(frame.columns)
    assert values.dtype == frame.values.dtype
    assert np.array_equal(values, frame.values, equal_nan=True)


def test_preprocess_without_h5py_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        vg.run("r.json", "imgs", "s.json", str(tmp_path / "x.h5"),
               str(tmp_path / "x.json"))
    with pytest.raises(ImportError, match="h5py"):
        f2t.run("a", "b", "c", "d", "e", str(tmp_path / "x.h5"),
                str(tmp_path / "x.json"))


def test_fixups_match_jax():
    sd = {"resnet_backbone.0.weight": 1, "llm.linear.weight": 2,
          "encoder.resnet_backbone.x": 3}
    assert fixups.strip_backbone_keys(sd) == jax_fixups.strip_backbone_keys(
        sd) == {"llm.linear.weight": 2}
    records = [{"filename": "a.jpg", "description": "short"},
               {"filename": "a.jpg", "description": ["a longer one", "mid"]},
               {"filename": "b.jpg", "description": "only"},
               {"filename": "a.jpg", "description": "again, later"}]
    got = fixups.merge_duplicate_test_descriptions(records)
    assert got == jax_fixups.merge_duplicate_test_descriptions(records)
    assert [r["description"] for r in got] == [["a longer one"], ["only"],
                                               ["again, later"]]
    images = np.random.RandomState(4).randint(0, 256, (3, 5, 6, 3), np.uint8)
    for g, w in zip(fixups.channel_mean_std(images),
                    jax_fixups.channel_mean_std(images)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
