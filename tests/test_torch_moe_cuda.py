"""The routed experts' grouped products on a CUDA card (marker `cuda`;
they skip without one), at Kimi-VL-A3B's widths (64 experts of 2,048 ->
2 x 1,408 -> 2,048, top 6), against the plain per-expert loop in fp32
on the same bf16 operands:

  python -m pytest --noconftest -m cuda tests/test_torch_moe_cuda.py -q

Tolerance: the card's products take bf16 operands and sum in fp32, then
round their output to bf16, so each element lies within a bf16 rounding
(2^-8 relative) of the fp32 loop's, plus the fp32 sums' order; 1e-2 of
the largest output bounds both. The launch is counted and the result is
the same on a second launch; float32 rows take the per-expert loop and
launch nothing grouped. The region language model's decode step,
replayed from its CUDA graphs, gives the eager step's tokens.
"""

import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test process)
from imagecaptioning_tpu_torch.ops import moe

E, D, F, K = 64, 2048, 1408, 6


def _operands(tokens: int):
    g = torch.Generator("cuda").manual_seed(7)

    def uniform(*shape, bound):
        return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1)
                * bound)
    x = uniform(tokens, D, bound=1.0).bfloat16()
    w, idx = moe.route(torch.randn(tokens, E, generator=g, device="cuda"),
                       uniform(E, bound=D ** -0.5), K, 2.446)
    gate_up = uniform(E, D, 2 * F, bound=D ** -0.5).bfloat16()
    down = uniform(E, F, D, bound=F ** -0.5).bfloat16()
    return x, w, idx, gate_up, down


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [256, 4352])
def test_grouped_product_against_the_loop(tokens):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, idx, gate_up, _ = _operands(tokens)
    order, offs = moe.dispatch(idx, E)
    rows = x.index_select(0, order // K)
    before = moe.grouped_mm.launches
    got = moe.grouped_mm(rows, gate_up, offs)
    assert moe.grouped_mm.launches == before + 1
    want = moe.grouped_mm_reference(rows.float(), gate_up.float(),
                                    offs.cpu())
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert float(err) < 1e-2
    assert torch.equal(got, moe.grouped_mm(rows, gate_up, offs))


@pytest.mark.cuda
def test_float32_rows_take_the_loop():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, _, idx, gate_up, _ = _operands(256)
    order, offs = moe.dispatch(idx, E)
    rows = x.index_select(0, order // K).float()
    before = moe.grouped_mm.launches
    got = moe.grouped_mm(rows, gate_up.float(), offs)
    assert moe.grouped_mm.launches == before
    assert torch.equal(got, moe.grouped_mm_reference(rows, gate_up.float(),
                                                     offs))


@pytest.mark.cuda
def test_experts_against_the_loop():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, idx, gate_up, down = _operands(256)
    got = moe.experts_swiglu(x, w, idx, gate_up, down)
    xs = x.float()
    want = torch.zeros_like(xs)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            g, u = (xs[tok] @ gate_up[e].float()).chunk(2, -1)
            h = (torch.nn.functional.silu(g) * u).bfloat16().float()
            want.index_add_(0, tok, (h @ down[e].float())
                            * w[tok, slot, None])
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) < 1e-2


@pytest.mark.cuda
def test_the_graphed_decode_equals_the_eager_one():
    # a small region language model in bf16: the same tokens from the
    # eager step, the call that captures the step's graphs and a call
    # that replays them
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from imagecaptioning_tpu_torch.data.vg_loader import normalize_images
    from imagecaptioning_tpu_torch.models import api
    from imagecaptioning_tpu_torch.train import dense_driver
    from portbench import harness, program
    from portbench.reference import kimivl_region

    cfg = harness.cell("gt-kimivl-serve-b8").config
    cfg.update(vgg_stages=2, vocab_size=211, hidden_size=64,
               num_attention_heads=4, num_key_value_heads=4,
               kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=16,
               v_head_dim=16, intermediate_size=96, moe_intermediate_size=24,
               num_hidden_layers=4, n_routed_experts=16, prompt_length=3)
    model = dense_driver.build_gt_model(program.dense_config(cfg), 0, 0,
                                        torch.device("cuda")).eval()
    program.weights.load_into(model, dict(kimivl_region.make_weights(
        cfg, 11, "cuda")))
    g = torch.Generator().manual_seed(5)
    images = normalize_images(torch.randint(0, 256, (2, 32, 32, 3),
                                            generator=g,
                                            dtype=torch.uint8).cuda())
    boxes = torch.tensor([[[9.0, 10.0, 8.0, 12.0], [20.0, 18.0, 14.0, 16.0],
                           [16.0, 16.0, 30.0, 30.0]]] * 2, device="cuda")
    greedy = api.make_region_greedy_fn(model, 6)
    model.lm.graphs = False
    eager = greedy(images, boxes)
    model.lm.graphs = True
    captured = greedy(images, boxes)
    assert model.lm._state.graphs is not None
    assert torch.equal(captured, eager)
    assert torch.equal(greedy(images, boxes), eager)
