"""The port's native host gather (`native/`, `fastloader.cpp` built with
g++ at first use) on the CPU: bitwise the JAX package's
`imagecaptioning_tpu.native` and the plain numpy versions, empty batches
and 0 × 0 windows included; an index or crop out of range raises; a
failed build raises with the compiler's output; concurrent builds publish
one library; and the loaders that use it give the bytes they gave with
the numpy gather, and the JAX loaders' bytes."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from imagecaptioning_tpu import native as jax_native
from imagecaptioning_tpu.data.loader import AlexDataLoader as JaxAlexLoader
from imagecaptioning_tpu.data.vg_loader import VGDataLoader as JaxVGLoader
from imagecaptioning_tpu_torch import native
from imagecaptioning_tpu_torch.data import synthetic
from imagecaptioning_tpu_torch.data.loader import AlexDataLoader
from imagecaptioning_tpu_torch.data.vg_loader import VGDataLoader
from imagecaptioning_tpu_torch.native import build
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randint(0, 256, (12, 9, 7, 3), np.uint8)


GATHERS = {"batch": [3, 0, 11, 3, 7], "one": [5], "empty": []}


@pytest.mark.parametrize("which", list(GATHERS))
@pytest.mark.parametrize("threads", [1, 3, 8])
def test_gather_records_is_bitwise_jax_and_numpy(images, which, threads):
    idx = np.asarray(GATHERS[which], np.int64)
    got = native.gather_records(images, idx, num_threads=threads)
    assert got.dtype == np.uint8 and got.shape == (len(idx), 9, 7, 3)
    np.testing.assert_array_equal(got, native.gather_records_reference(
        images, idx))
    np.testing.assert_array_equal(got, jax_native.gather_records(
        images, idx, num_threads=threads))
    out = np.full_like(got, 77)
    assert native.gather_records(images, idx, out=out) is out
    np.testing.assert_array_equal(out, got)


CROPS = {"mixed": ([2, 0, 11], [5, 9, 0], [7, 3, 7]),
         "zero_window": ([4, 4], [0, 0], [0, 0]),
         "full": ([1], [9], [7]),
         "empty": ([], [], [])}


@pytest.mark.parametrize("which", list(CROPS))
def test_gather_images_cropped_is_bitwise_jax_and_numpy(images, which):
    idx, ch, cw = (np.asarray(a, np.int64) for a in CROPS[which])
    got = native.gather_images_cropped(images, idx, ch, cw, num_threads=2)
    want = native.gather_images_cropped_reference(images, idx, ch, cw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.gather_images_cropped(
        images, idx, ch, cw, num_threads=2))
    if which == "zero_window":
        assert not got.any()
    if which == "mixed":        # the window kept, the rest zeroed
        np.testing.assert_array_equal(got[0, :5, :7], images[2, :5, :7])
        assert not got[0, 5:].any() and not got[2, :, 7:].any()


def test_out_of_range_raises(images):
    for bad in ([12], [-1], [0, 99]):
        with pytest.raises(ValueError, match="outside"):
            native.gather_records(images, np.asarray(bad))
        with pytest.raises(ValueError, match="outside"):
            native.gather_images_cropped(images, np.asarray(bad),
                                         np.ones(len(bad)), np.ones(len(bad)))
    for ch, cw in (([10], [1]), ([1], [8]), ([-1], [1])):
        with pytest.raises(ValueError, match="crop beyond"):
            native.gather_images_cropped(images, np.asarray([0]),
                                         np.asarray(ch), np.asarray(cw))
    with pytest.raises(ValueError, match="one crop an index"):
        native.gather_images_cropped(images, np.asarray([0, 1]),
                                     np.asarray([1]), np.asarray([1, 1]))
    with pytest.raises(ValueError, match="out must be"):
        native.gather_records(images, np.asarray([0]),
                              out=np.empty((2, 9, 7, 3), np.uint8))


def test_other_dtypes_take_the_plain_version(images):
    src = images.astype(np.float32) / 7
    idx = np.asarray([4, 1])
    np.testing.assert_array_equal(native.gather_records(src, idx), src[idx])
    got = native.gather_images_cropped(src, idx, np.asarray([3, 9]),
                                       np.asarray([2, 7]))
    np.testing.assert_array_equal(got, native.gather_images_cropped_reference(
        src, idx, [3, 9], [2, 7]))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int gather_records( { return 0; }\n')
    monkeypatch.setattr(build, "SRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"
                       ":\n(.|\n)*error"):
        build.build()
    assert not list((tmp_path / "native").glob("*.so"))
    assert not list((tmp_path / "native").glob("*.tmp"))
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(OSError):
        build.build()


def test_concurrent_builds_publish_one_library(tmp_path):
    """Four processes build into one empty directory at once: each loads
    the same library, and nothing half-written is left."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        from imagecaptioning_tpu_torch.native import build
        build.BUILD_DIR = Path({str(tmp_path / 'native')!r})
        print(build.build().name)
        """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    names = {o.strip() for o, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == \
        sorted(["build.lock", *names])


def test_the_face2text_loader_gives_the_same_bytes():
    """`get_batch`, `epoch_batches` and `resident_arrays` against the
    numpy gather they had and against the JAX loader's batches."""
    arrays, info = synthetic.make_face2text_arrays(num_images=20,
                                                   seq_length=10, seed=3)
    port = AlexDataLoader(arrays=arrays, info=info, seed=5)
    jax_loader = JaxAlexLoader(arrays=arrays, info=info, seed=5)
    first = np.asarray(port.split_ix[0][:4])
    for opt in ({"split": 0}, {"split": 0, "iterate": False}):
        got = port.get_batch(opt, 4)
        want = jax_loader.get_batch(opt, 4)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if opt.get("iterate", True):
            np.testing.assert_array_equal(got[0], arrays["images"][first])
    for (gi, gl), (wi, wl) in zip(
            port.epoch_batches(0, 3, shuffle=True),
            jax_loader.epoch_batches(0, 3, shuffle=True)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    ix = np.asarray(port.split_ix[1])
    images, labels = port.resident_arrays(1)
    np.testing.assert_array_equal(images, arrays["images"][ix])
    np.testing.assert_array_equal(images, jax_loader.resident_arrays(1)[0])


def test_the_vg_loader_gives_the_same_bytes():
    arrays, info = synthetic.make_vg_arrays(num_images=9, regions_per_image=3,
                                            image_size=32, seed=2)
    port = VGDataLoader(arrays=arrays, info=info)
    jax_loader = JaxVGLoader(arrays=arrays, info=info)
    got = list(port.padded_batches(0, 2, max_regions=4, start=1))
    want = list(jax_loader.padded_batches(0, 2, max_regions=4, start=1))
    assert got and len(got) == len(want)
    ix = np.asarray(port.split_ix[0])[1:]
    for b, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype, k
        # the numpy stack of the examples it gave before the native gather
        before = [port.padded_example(int(i), 4) for i in ix[2 * b:2 * b + 2]]
        for k in g:
            np.testing.assert_array_equal(
                g[k], np.stack([e[k] for e in before]), err_msg=k)
