"""The port's helpers that no path of either package runs, against the JAX
package's on the same seeded inputs: `ops/losses.log_softmax_nll` and
`temporal_sum_cross_entropy` within 1e-6; `ops/boxes.make_boxes` within
1e-6 and `merge_boxes_host` with identical cluster indices and centers
within 1e-6; `utils/io.getopt`, `dict_average`, `average_values` and
`build_loss_string` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioning_tpu.ops import boxes as jax_boxes
from imagecaptioning_tpu.ops import losses as jax_losses
from imagecaptioning_tpu.utils import io as jax_io
from imagecaptioning_tpu_torch.ops import boxes, losses
from imagecaptioning_tpu_torch.utils import io
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=1e-6, atol=1e-6)


def _logits_targets(seed=0, n=3, t=5, v=7):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(n, t, v)).astype(np.float32)
    targets = rng.randint(0, v, (n, t)).astype(np.int64)
    targets[0, 2:] = 0                               # NULL padding
    return logits, targets


@pytest.mark.parametrize("batch_average,time_average",
                         [(True, False), (False, True), (True, True),
                          (False, False)])
def test_temporal_sum_cross_entropy_matches_jax(batch_average, time_average):
    logits, targets = _logits_targets()
    kw = dict(batch_average=batch_average, time_average=time_average)
    got = losses.temporal_sum_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets), **kw)
    want = jax_losses.temporal_sum_cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets.astype(np.int32)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_log_softmax_nll_matches_jax(weighted):
    logits, targets = _logits_targets(seed=1)
    w = np.random.RandomState(2).uniform(0.1, 2, 7).astype(np.float32)
    got = losses.log_softmax_nll(
        torch.from_numpy(logits), torch.from_numpy(targets),
        torch.from_numpy(w) if weighted else None)
    want = jax_losses.log_softmax_nll(
        jnp.asarray(logits), jnp.asarray(targets.astype(np.int32)),
        jnp.asarray(w) if weighted else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_make_boxes_matches_jax():
    rng = np.random.RandomState(3)
    trans = (0.3 * rng.randn(2, 4 * 3, 5, 6)).astype(np.float32)
    anchor_wh = rng.uniform(8, 64, (3, 2)).astype(np.float32)
    centers = boxes.field_centers(4)
    got = boxes.make_boxes(torch.from_numpy(trans),
                           torch.from_numpy(anchor_wh), *centers)
    want = jax_boxes.make_boxes(jnp.asarray(trans), jnp.asarray(anchor_wh),
                                *centers)
    for g, w in zip(got, want):
        assert g.shape == (2, 3 * 5 * 6, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_merge_boxes_host_matches_jax():
    rng = np.random.RandomState(4)
    base = rng.uniform(20, 80, (5, 4))
    # clusters of near copies, so that IoU >= 0.7 groups them
    b = np.concatenate([base + rng.uniform(-2, 2, (5, 4)) for _ in range(3)])
    b = b[rng.permutation(len(b))].astype(np.float32)
    got_centers, got_idx = boxes.merge_boxes_host(b)
    want_centers, want_idx = jax_boxes.merge_boxes_host(b)
    assert got_idx.dtype == want_idx.dtype and np.array_equal(got_idx,
                                                              want_idx)
    assert len(got_centers) < len(b)
    np.testing.assert_allclose(got_centers, want_centers, **TOL)


def test_io_helpers_match_jax():
    class Opt:
        lr = 0.5
        none = None

    for opt, key, default in (({"lr": 1e-3}, "lr", 9), ({"lr": None}, "lr",
                                                        9), (Opt(), "lr", 9),
                              (Opt(), "missing", 7), (None, "lr", 3)):
        assert io.getopt(opt, key, default) == jax_io.getopt(opt, key,
                                                             default)
    dicts = [{"a": 1, "b": "x", "c": 2.5}, {"a": 3, "c": None},
             {"b": 4, "d": torch.tensor(2.0)}]
    assert io.dict_average(dicts) == jax_io.dict_average(dicts)
    for d in ({"a": 1.0, "b": 2.0, "c": 4.5}, {}):
        assert io.average_values(d) == jax_io.average_values(d)
    for losses_ in ({"captioning_loss": 1.25, "total": 3.5},
                    {"a": np.float32(0.1), "b": torch.tensor(2.0)}):
        assert io.build_loss_string(losses_) == jax_io.build_loss_string(
            losses_)
