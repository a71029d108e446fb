"""The PyTorch port's RPN DenseCap ops and model against the JAX package,
at a tiny size (2 VGG stages, 32² images, a 9-anchor ladder of 8–32 px
so that positives exist, 8 + 8 sampled boxes, LSTM 16), fp32.

Same numpy inputs and the same (converted) weights on both sides:
- box geometry within 1e-6 (the same elementwise operations in the same
  order: in practice the same bits); `default_anchors` verbatim;
- `candidate_masks` and `sample_boxes` identical given JAX's own
  uniform keys (the `split(rng, n)` → `split(rng_i)` chain of
  `DenseCapRPN.__call__`), with an out-of-bounds forced positive, the
  all-negatives fallback and padded GT rows;
- the four losses within 1e-6; `nms` indices and keep identical, with
  an invalid mask, score ties and a budget above the survivors;
- the RPN loss dict within 1e-5 and every parameter's gradient within
  1e-4 relative of `jax.value_and_grad` (`rpn_trans` included, which the
  caption and end losses reach through the ROI boxes), with and without
  captioning, JAX's plain einsum ROI and dropout off;
- `forward_test` boxes and scores within 1e-5 with keep identical, and
  `generate_captions` tokens identical;
- the converter's round trip, `apply_box_decay`, and the transformer
  decode past its position table (the cache sized by the step count):
  greedy and beam-3 tokens identical to JAX's, logits within 1e-4;
- `encoder_init` of `conv_trunk` and `recog_base` from JAX's own init:
  `forward_test` within 1e-4, keep identical; a partial file raises.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioning_tpu.models import api as jax_api
from imagecaptioning_tpu.models.densecap import DenseCapRPN as JaxRPN
from imagecaptioning_tpu.models.densecap import GTDenseCaptioner as JaxGT
from imagecaptioning_tpu.models import densecap as jax_densecap
from imagecaptioning_tpu.ops import box_sampler as jax_sampler
from imagecaptioning_tpu.ops import boxes as jax_boxes
from imagecaptioning_tpu.ops import losses as jax_losses
from imagecaptioning_tpu.ops import nms as jax_nms
from imagecaptioning_tpu_torch.models import api, decoding
from imagecaptioning_tpu_torch.models import densecap
from imagecaptioning_tpu_torch.models.densecap import (DenseCapRPN,
                                                       GTDenseCaptioner)
from imagecaptioning_tpu_torch.ops import box_sampler, boxes, losses, nms
from imagecaptioning_tpu_torch.utils.weights import (gt_state_dict_from_jax,
                                                     rpn_state_dict_from_jax,
                                                     seeded_init_)
import torch_threads  # noqa: F401  (one torch thread a test process)

KW = dict(vocab_size=20, seq_length=5, num_pos=8, num_neg=8,
          test_proposals=20, embedding_size=16, rnn_size=16, vgg_stages=2,
          anchor_sizes=(8.0, 16.0, 32.0), anchor_ratios=(0.5, 1.0, 2.0))
N, SIZE, M, T = 2, 32, 4, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _boxes(rng, n, lo, hi, wlo, whi):
    return np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                     rng.uniform(wlo, whi, n), rng.uniform(wlo, whi, n)],
                    -1).astype(np.float32)


def jax_keys(rng, n, a):
    """The sampler's keys as `DenseCapRPN.__call__` draws them: image i's
    (positives', negatives') uniforms from `split(split(rng, n)[i])`."""
    pos, neg = [], []
    for ri in jax.random.split(rng, n):
        r1, r2 = jax.random.split(ri)
        pos.append(np.array(jax.random.uniform(r1, (a,))))
        neg.append(np.array(jax.random.uniform(r2, (a,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


# ------------------------------------------------------------ geometry

def _geometry_inputs():
    rng = np.random.RandomState(0)
    a = _boxes(rng, 50, -20, 90, 1, 60)
    b = _boxes(rng, 7, 0, 64, 2, 40)
    trans = (rng.randn(50, 4) * 4).astype(np.float32)   # some |t| > 10
    return a, b, trans


GEOMETRY = {
    "xcycwh_to_x1y1x2y2": lambda m, a, b, t: m.xcycwh_to_x1y1x2y2(a),
    "x1y1x2y2_to_xcycwh": lambda m, a, b, t: m.x1y1x2y2_to_xcycwh(a),
    "xcycwh_to_xywh": lambda m, a, b, t: m.xcycwh_to_xywh(a),
    "xywh_to_xcycwh": lambda m, a, b, t: m.xywh_to_xcycwh(a),
    "box_iou": lambda m, a, b, t: m.box_iou(a, b),
    "clip_boxes": lambda m, a, b, t: m.clip_boxes(a, 48, 64),
    "clip_boxes_corners": lambda m, a, b, t: m.clip_boxes(a, 48, 64,
                                                          fmt="x1y1x2y2"),
    "apply_box_transform": lambda m, a, b, t: m.apply_box_transform(a, t),
    "apply_box_transform_clamped": lambda m, a, b, t: m.apply_box_transform(
        a, t, max_log_scale=10.0),
    "invert_box_transform": lambda m, a, b, t: m.invert_box_transform(
        a, m.apply_box_transform(a, t * 0.1)),
    "make_anchors": lambda m, a, b, t: m.make_anchors(
        a[:5, 2:], *m.field_centers(3), 4, 6),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_box_geometry_matches_jax(name):
    a, b, t = _geometry_inputs()
    want = GEOMETRY[name](jax_boxes, jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(t))
    got = GEOMETRY[name](boxes, *_t(a, b, t))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert boxes.field_centers(4) == jax_boxes.field_centers(4)


@pytest.mark.parametrize("sizes,ratios", [
    (densecap.REFERENCE_ANCHOR_SIZES, densecap.REFERENCE_ANCHOR_RATIOS),
    ((8.0, 16.0, 32.0), (0.5, 1.0, 2.0)),
    ((32.0, 90.0), (0.25, 1.0, 3.0))])
def test_default_anchors_match_jax(sizes, ratios):
    got = densecap.default_anchors(sizes, ratios)
    want = jax_densecap.default_anchors(sizes, ratios)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    if sizes == densecap.REFERENCE_ANCHOR_SIZES:
        assert got.tolist() == [list(r) for r in densecap.REFERENCE_ANCHORS]
        assert densecap.REFERENCE_ANCHORS == jax_densecap.REFERENCE_ANCHORS


# -------------------------------------------------------------- sampler

def _sampler_case(case):
    """(proposals (A, 4), gt (M, 4), gt mask (M,), in_bounds (A,)) on a
    64² image."""
    rng = np.random.RandomState(1)
    gt = _boxes(rng, 5, 16, 48, 10, 30)
    props = _boxes(rng, 120, -10, 74, 4, 50)
    props[:30] = gt[rng.randint(0, 5, 30)] + rng.randn(30, 4) * 1.5
    gm = np.ones(5, np.float32)
    if case == "padded_gt":
        gm[3:] = 0
    if case == "forced_out_of_bounds":
        # GT 0 hangs off the left border; its best proposal (an exact
        # copy) is out of bounds and is forced positive all the same
        gt[0] = [4.0, 30.0, 20.0, 20.0]
        props[5] = gt[0]
    if case == "all_negatives_fallback":
        props = gt[rng.randint(0, 5, 120)] + rng.randn(120, 4) * 0.3
    corners = np.asarray(jax_boxes.xcycwh_to_x1y1x2y2(jnp.asarray(props)))
    inb = ((corners[:, 0] >= 1) & (corners[:, 1] >= 1)
           & (corners[:, 2] <= 64) & (corners[:, 3] <= 64))
    return props.astype(np.float32), gt, gm, inb


CASES = ["plain", "padded_gt", "forced_out_of_bounds",
         "all_negatives_fallback"]


@pytest.mark.parametrize("case", CASES)
def test_candidate_masks_match_jax(case):
    props, gt, gm, inb = _sampler_case(case)
    want = jax_sampler.candidate_masks(jnp.asarray(props), jnp.asarray(gt),
                                       jnp.asarray(gm), in_bounds=inb)
    got = box_sampler.candidate_masks(*_t(props[None], gt[None], gm[None]),
                                      in_bounds=torch.from_numpy(inb[None]))
    for g, w in zip(got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w))
    pos, neg, _ = (g[0].numpy() for g in got)
    if case == "forced_out_of_bounds":
        assert pos[5] and not inb[5]
    if case == "all_negatives_fallback":
        assert neg.all() and pos.any()


@pytest.mark.parametrize("case", CASES)
def test_sample_boxes_match_jax_given_its_keys(case):
    props, gt, gm, inb = _sampler_case(case)
    rng = jax.random.PRNGKey(11)
    want = jax_sampler.sample_boxes(rng, jnp.asarray(props), jnp.asarray(gt),
                                    jnp.asarray(gm), num_pos=24, num_neg=16,
                                    in_bounds=inb)
    r1, r2 = jax.random.split(rng)
    keys = [torch.from_numpy(np.array(jax.random.uniform(r, (120,))))[None]
            for r in (r1, r2)]
    got = box_sampler.sample_boxes(*keys, *_t(props[None], gt[None],
                                              gm[None]), 24, 16,
                                   in_bounds=torch.from_numpy(inb[None]))
    for field in want._fields:
        assert np.array_equal(getattr(got, field)[0].numpy(),
                              np.asarray(getattr(want, field))), field
    # negatives pad by cycling and stay valid; positives pad masked out
    assert got.neg_mask.all()
    if case != "all_negatives_fallback":
        assert not got.pos_mask.all()


def test_masked_topk_ranks_ties_to_the_lower_index():
    keys = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    mask = torch.tensor([[True, True, True, True, False, True]])
    idx, ok = box_sampler.masked_random_topk(keys, mask, 6, False)
    assert idx.tolist() == [[1, 3, 0, 2, 5, 1]]
    assert ok.tolist() == [[True] * 5 + [False]]
    idx, ok = box_sampler.masked_random_topk(keys, mask & False, 3, True)
    assert idx.tolist() == [[0, 0, 0]] and not ok.any()


# --------------------------------------------------------------- losses

def _loss_inputs():
    rng = np.random.RandomState(2)
    pred = (rng.randn(3, 6, 4) * 2).astype(np.float32)
    target = (rng.randn(3, 6, 4) * 2).astype(np.float32)
    target[0, 1, 2] = 12.0                 # a "dirty hack" row
    valid = rng.rand(3, 6) > 0.3
    valid[2] = False                       # an image with no positive
    logits = rng.randn(4, 5, 9).astype(np.float32) * 3
    targets = rng.randint(0, 9, (4, 5))
    scores = (rng.randn(12) * 30).astype(np.float32)   # past softplus's 20
    labels = (rng.rand(12) > 0.5).astype(np.float32)
    return pred, target, valid, logits, targets, scores, labels


@pytest.mark.parametrize("name", ["logistic_criterion", "smooth_l1",
                                  "box_regression_loss",
                                  "box_regression_loss_unmasked",
                                  "sum_cross_entropy"])
def test_losses_match_jax(name):
    pred, target, valid, logits, targets, scores, labels = _loss_inputs()
    if name == "logistic_criterion":
        got = losses.logistic_criterion(*_t(scores, labels))
        want = [jax_losses.logistic_criterion(scores, labels)]
    elif name == "smooth_l1":
        got = losses.smooth_l1(*_t(pred - target))
        want = [jax_losses.smooth_l1(pred - target)]
    elif name == "box_regression_loss":
        got = losses.box_regression_loss(*_t(pred, target), weight=0.5,
                                         valid_mask=torch.from_numpy(valid))
        want = [jax_losses.box_regression_loss(p, t, 0.5, valid_mask=v)
                for p, t, v in zip(pred, target, valid)]
    elif name == "box_regression_loss_unmasked":
        got = losses.box_regression_loss(*_t(pred, target))
        want = [jax_losses.box_regression_loss(p, t)
                for p, t in zip(pred, target)]
    else:
        got = losses.sum_cross_entropy(*_t(logits, targets))
        want = [jax_losses.sum_cross_entropy(logits, targets)]
    want = np.stack([np.asarray(w) for w in want]).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ NMS

def _nms_case(case):
    rng = np.random.RandomState(3)
    n = 60
    bx = _boxes(rng, n, 10, 60, 5, 30)
    bx[20:30] = bx[:10] + rng.randn(10, 4).astype(np.float32)
    scores = rng.randn(n).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "invalid_mask":
        valid = rng.rand(n) > 0.3
    if case == "score_ties":
        scores[:12] = 0.5                  # ties among overlapping boxes
        scores[40:46] = 0.5
    return bx, scores, valid, 80 if case == "budget_above_survivors" else 25


@pytest.mark.parametrize("case", ["invalid_mask", "score_ties",
                                  "budget_above_survivors"])
@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_nms_matches_jax(case, thresh):
    bx, scores, valid, max_out = _nms_case(case)
    want_idx, want_keep = jax_nms.nms(jnp.asarray(bx), jnp.asarray(scores),
                                      thresh, max_out,
                                      valid=jnp.asarray(valid))
    got_idx, got_keep = nms.nms(*_t(np.stack([bx, bx[::-1]]),
                                    np.stack([scores, scores[::-1]])),
                                thresh, max_out,
                                valid=torch.from_numpy(np.stack(
                                    [valid, valid[::-1]])))
    assert np.array_equal(got_idx[0].numpy(), np.asarray(want_idx))
    assert np.array_equal(got_keep[0].numpy(), np.asarray(want_keep))
    assert got_keep[1].sum() == got_keep[0].sum()       # batched per image
    if case == "budget_above_survivors":
        kept = int(got_keep[0].sum())
        assert kept < max_out and not got_keep[0, kept:].any()
        assert not got_idx[0, kept:].any()               # pads are (0, False)


# ---------------------------------------------------------------- model

def _model_inputs():
    rng = np.random.RandomState(4)
    x = rng.randn(N, SIZE, SIZE, 3).astype(np.float32)
    gt = np.stack([_boxes(rng, M, 8, 24, 6, 20) for _ in range(N)])
    gm = np.ones((N, M), np.float32)
    gm[1, 3] = 0.0                                    # a padded GT row
    labels = rng.randint(1, KW["vocab_size"] + 1, (N, M, T)).astype(np.int32)
    labels[0, 1, 3:] = 0                              # a short caption
    return x, gt, gm, labels


@pytest.fixture(scope="module")
def rpn_pair():
    """{with_captioning: (jax model, params, port model)} at one init,
    `rpn_trans` and `box_reg` moved off their zero init so that the
    proposals and refined boxes differ from the anchors."""
    x, gt, gm, labels = _model_inputs()
    rng = np.random.RandomState(5)
    out = {}
    for cap in (True, False):
        jm = JaxRPN(with_captioning=cap, **KW)
        k = jax.random.PRNGKey(0)
        v = jax.jit(partial(jm.init, train=False))(
            {"params": k}, *map(jnp.asarray, (x, gt, gm, labels)), rng=k)
        params = _np(v["params"])
        for name, scale in (("rpn_trans", 0.05), ("box_reg", 0.01)):
            kern = params[name]["kernel"]
            params[name]["kernel"] = (rng.randn(*kern.shape)
                                      * scale).astype(np.float32)
        pm = DenseCapRPN(with_captioning=cap, **KW)
        pm.load_state_dict(rpn_state_dict_from_jax(params))
        out[cap] = (jm, params, pm)
    return out


def _num_anchors(pm):
    return (SIZE // 4) ** 2 * pm.anchor_wh.shape[0]


@pytest.mark.parametrize("with_captioning", [True, False])
def test_rpn_losses_and_every_gradient_match_jax(rpn_pair, with_captioning):
    jm, params, pm = rpn_pair[with_captioning]
    x, gt, gm, labels = _model_inputs()
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        d = jm.apply({"params": p}, *map(jnp.asarray, (x, gt, gm, labels)),
                     rng=rng, train=False)
        return d["total"], d
    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    want_grads = rpn_state_dict_from_jax(_np(grads))

    pm.zero_grad(set_to_none=True)
    tx, tgt, tgm, tl = _t(x, gt, gm, labels)
    got = pm(tx, tgt, tgm, tl.long(), keys=jax_keys(rng, N, _num_anchors(pm)))
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(float(got[key].detach()) - float(want[key])) <= 1e-5, key
    assert 0 < float(got["pos_occupancy"]) < 1
    got["total"].backward()
    names = [n for n, _ in pm.named_parameters()]
    assert sorted(names) == sorted(want_grads)
    for name, p in pm.named_parameters():
        w = want_grads[name].numpy()
        assert p.grad is not None and np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_apply_box_decay_sums_the_decay(rpn_pair):
    _, params, _ = rpn_pair[True]
    x, gt, gm, labels = _t(*_model_inputs())
    keys = jax_keys(jax.random.PRNGKey(1), N, _num_anchors(rpn_pair[True][2]))
    totals = {}
    for apply in (False, True):
        pm = DenseCapRPN(apply_box_decay=apply, box_reg_decay=0.5, **KW)
        pm.load_state_dict(rpn_state_dict_from_jax(params))
        with torch.no_grad():
            totals[apply] = pm(x, gt, gm, labels.long(), keys=keys)
    off, on = totals[False], totals[True]
    assert float(off["box_decay"]) > 0
    assert float(on["box_decay"]) == float(off["box_decay"])
    torch.testing.assert_close(on["total"], off["total"] + off["box_decay"])


def test_forward_test_and_captions_match_jax(rpn_pair):
    jm, params, pm = rpn_pair[True]
    x = _model_inputs()[0]
    bj, sj, cj, kj = jm.apply({"params": params}, jnp.asarray(x),
                              method=jm.forward_test)
    tj = jm.apply({"params": params}, cj, T + 1, method=jm.generate_captions)
    with torch.no_grad():
        bt, st, ct, kt = pm.forward_test(torch.from_numpy(x))
        tt = pm.generate_captions(ct, T + 1)
    assert bt.shape == (N, KW["test_proposals"], 4)
    assert np.array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < kt.sum() < kt.numel()
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(tt.numpy(), np.asarray(tj))


def test_converter_round_trip(rpn_pair):
    _, params, pm = rpn_pair[True]
    sd = rpn_state_dict_from_jax(params)
    assert set(sd) == set(pm.state_dict())
    for name, t in pm.state_dict().items():
        assert torch.equal(t, sd[name]), name
    # HWIO → OIHW, rows of fc6 from JAX's HWC flattening into CHW
    np.testing.assert_array_equal(
        sd["rpn_conv.weight"].numpy().transpose(2, 3, 1, 0),
        params["rpn_conv"]["kernel"])
    np.testing.assert_array_equal(
        sd["rpn_trans.weight"].numpy()[:, :, 0, 0].T,
        params["rpn_trans"]["kernel"][0, 0])
    c = pm.conv_trunk.out_channels
    fc6 = params["recog_base"]["fc6"]["kernel"].reshape(7, 7, c, -1)
    np.testing.assert_array_equal(
        sd["recog_base.0.weight"].numpy().T,
        fc6.transpose(2, 0, 1, 3).reshape(49 * c, -1))
    # a seeded model keeps the zero-initialised deltas and refinement
    seeded = seeded_init_(DenseCapRPN(**KW), 3)
    for name in ("rpn_trans.weight", "rpn_trans.bias", "box_reg.weight",
                 "box_reg.bias"):
        assert not seeded.state_dict()[name].any(), name
    assert seeded.state_dict()["rpn_scores.weight"].abs().sum() > 0


# --------------------------------------------------- decode past the table

@pytest.fixture(scope="module")
def transformer_pair():
    kw = dict(vocab_size=24, seq_length=5, vgg_stages=2)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    bx = np.stack([_boxes(rng, 3, 8, 24, 6, 20) for _ in range(2)])
    labels = rng.randint(1, 25, (2, 3, 5)).astype(np.int32)
    jm = JaxGT(use_lstm=False, **kw)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                         jnp.asarray(bx), jnp.asarray(labels))
    params = _np(v["params"])
    pm = GTDenseCaptioner(use_lstm=False, **kw).eval()
    pm.load_state_dict(gt_state_dict_from_jax(params))
    return jm, params, pm, x, bx


def test_transformer_decode_runs_past_its_position_table(transformer_pair):
    """seq_length + 3 steps, two past the decoder's seq_length + 1
    positions: the cache has a row per step and the position index clamps,
    as in JAX."""
    jm, params, pm, x, bx = transformer_pair
    steps = 5 + 3
    variables = {"params": params}
    want_greedy = jax_api.make_region_greedy_fn(jm, steps)(
        variables, jnp.asarray(x), jnp.asarray(bx))
    want_beam = jax_api.make_region_beam_fn(jm, steps, 3)(
        variables, jnp.asarray(x), jnp.asarray(bx))
    tx, tb = _t(x, bx)
    got_greedy = api.make_region_greedy_fn(pm, steps)(tx, tb)
    got_beam = api.make_region_beam_fn(pm, steps, 3)(tx, tb)
    assert np.array_equal(got_greedy.numpy(), np.asarray(want_greedy))
    assert np.array_equal(got_beam.tokens.numpy(),
                          np.asarray(want_beam.tokens))
    np.testing.assert_allclose(got_beam.scores.numpy(),
                               np.asarray(want_beam.scores), rtol=1e-4,
                               atol=1e-4)

    # each step's logits along JAX's greedy path
    enc = jm.apply(variables, jnp.asarray(x), jnp.asarray(bx),
                   method=jm.encode_flat)
    init_carry, step = jax_api._make_region_step(
        jm, jax.tree.map(jnp.asarray, params))
    carry = init_carry(enc, steps)
    step = jax.jit(step)        # a traced step index, as in the scan
    with torch.inference_mode():
        pcarry, pstep = pm.init_decode(pm.encode_flat(tx, tb),
                                       max_steps=steps)
        assert pcarry[0][0].shape[1] == steps
        tok = np.full((enc.shape[0], 1), pm.spec.start, np.int32)
        for t in range(steps):
            carry, want, _ = step(carry, jnp.asarray(tok), jnp.asarray(t))
            pcarry, got = pstep(pcarry, torch.from_numpy(tok).long(), t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
            tok = np.asarray(want).argmax(-1)[:, None].astype(np.int32)
    # again outside inference mode: the mask rows grown for this decode
    # length inside it are normal tensors
    with torch.no_grad():
        carry2, step2 = pm.init_decode(pm.encode_flat(tx, tb),
                                       max_steps=steps)
        greedy = decoding.greedy_decode(step2, carry2, enc.shape[0],
                                        pm.spec.start, steps)
    assert np.array_equal(greedy.numpy(), np.asarray(want_greedy))


def test_encoder_init_conv_trunk_matches_jax(rpn_pair, tmp_path):
    """`conv_trunk` (the RPN's default module) and `recog_base` written
    from the JAX model's own init into a differently seeded port model
    (its other weights from the same JAX params): `forward_test` boxes and
    scores within 1e-4 of JAX's, keep identical; a file without a conv of
    the trunk raises in both packages."""
    from imagecaptioning_tpu.train.step import TrainState
    from imagecaptioning_tpu.utils import pretrained as jax_pretrained
    from imagecaptioning_tpu_torch.utils import pretrained

    def write(name, tree):
        flat = {f"params/{layer}/{leaf}": np.asarray(v)
                for layer, leaves in tree.items()
                for leaf, v in leaves.items()}
        np.savez(tmp_path / name, **flat)
        return str(tmp_path / name)

    jm, params, _ = rpn_pair[True]
    x = _model_inputs()[0]
    bj, sj, _, kj = jm.apply({"params": params}, jnp.asarray(x),
                             method=jm.forward_test)
    trunk = write("trunk.npz", params["conv_trunk"])
    recog = write("recog.npz", params["recog_base"])
    model = seeded_init_(DenseCapRPN(with_captioning=True, **KW), 1)
    model.load_state_dict({k: v for k, v in rpn_state_dict_from_jax(
        params).items() if not k.startswith(("conv_trunk.", "recog_base."))},
        strict=False)
    pretrained.apply_encoder_init(model, f"{trunk},recog_base={recog}",
                                  "conv_trunk")
    with torch.no_grad():
        bt, st, _, kt = model.forward_test(torch.from_numpy(x))
    assert np.array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4,
                               atol=1e-4)
    partial = {k: v for k, v in params["conv_trunk"].items()
               if k != "conv2_2"}
    partial = write("partial.npz", partial)
    state = TrainState(0, params, None, {}, None)
    for apply in (
            lambda: pretrained.apply_encoder_init(model, partial,
                                                  "conv_trunk"),
            lambda: jax_pretrained.apply_encoder_init(state, partial,
                                                      "conv_trunk")):
        with pytest.raises(ValueError, match="conv2_2"):
            apply()
