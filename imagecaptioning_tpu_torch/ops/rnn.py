"""LSTM primitives in torch's layout — port of `imagecaptioning_tpu/ops/rnn.py`.

Gate order i, f, g, o; separate `b_ih`/`b_hh`; parameter names
`weight_ih_l{k}` … as in torch `nn.LSTM`, so the reference's
`llm.lstm.*` keys load directly. Plain `torch.matmul` and elementwise
ops: no TPU kernel sits under them, and cuBLAS takes the GEMMs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (h, c) each (L, B, H)


def lstm_gates_step(gates_x: torch.Tensor, w_hh: torch.Tensor,
                    b_hh: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """Cell step from a precomputed input projection (x @ w_ih.T + b_ih)."""
    gates = gates_x + h @ w_hh.T + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell_step(w_ih, w_hh, b_ih, b_hh, x, h, c):
    """One torch-ordered LSTM cell step. x: (B, in), h/c: (B, H)."""
    return lstm_gates_step(x @ w_ih.T + b_ih, w_hh, b_hh, h, c)


class LSTM(nn.Module):
    """Multi-layer unidirectional LSTM over (B, T, in) sequences.

    Matches torch `nn.LSTM(batch_first=True)`; returns (outputs (B, T, H),
    (h, c) each (num_layers, B, H)). Dropout acts between layers (not
    after the last), only when `num_layers > 1` and only in training
    (`train`, which defaults to the module's mode), with masks drawn from
    the `generator` passed to `forward`. The recurrence rebinds its
    per-layer state and writes no tensor in place, so autograd runs
    through it.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        bound = 1.0 / math.sqrt(hidden_size)
        in_dim = input_size
        for layer in range(num_layers):
            for name, shape in (("weight_ih", (4 * hidden_size, in_dim)),
                                ("weight_hh", (4 * hidden_size, hidden_size)),
                                ("bias_ih", (4 * hidden_size,)),
                                ("bias_hh", (4 * hidden_size,))):
                self.register_parameter(
                    f"{name}_l{layer}",
                    nn.Parameter(torch.empty(shape).uniform_(-bound, bound)))
            in_dim = hidden_size

    def layer_params(self, layer: int):
        return tuple(getattr(self, f"{n}_l{layer}") for n in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def forward(self, xs: torch.Tensor, state: Optional[LSTMState] = None,
                generator: Optional[torch.Generator] = None,
                train: Optional[bool] = None):
        b, t, _ = xs.shape
        if state is None:
            zeros = xs.new_zeros((self.num_layers, b, self.hidden_size))
            state = (zeros, zeros)
        train = self.training if train is None else train
        use_drop = train and self.dropout > 0 and self.num_layers > 1
        keep = 1.0 - self.dropout
        params = [self.layer_params(layer) for layer in range(self.num_layers)]

        # layer 0's input projection has no carry dependence: one
        # (B·T, in) × (in, 4H) GEMM hoisted out of the recurrence
        w_ih0, _, b_ih0, _ = params[0]
        pre0 = xs @ w_ih0.T + b_ih0                           # (B, T, 4H)

        hs, cs = list(state[0].unbind(0)), list(state[1].unbind(0))
        ys = []
        for step in range(t):
            inp = None
            for layer, (w_ih, w_hh, b_ih, b_hh) in enumerate(params):
                if layer == 0:
                    hs[0], cs[0] = lstm_gates_step(pre0[:, step], w_hh, b_hh,
                                                   hs[0], cs[0])
                else:
                    hs[layer], cs[layer] = lstm_cell_step(
                        w_ih, w_hh, b_ih, b_hh, inp, hs[layer], cs[layer])
                inp = hs[layer]
                if use_drop and layer < self.num_layers - 1:
                    mask = torch.bernoulli(torch.full_like(inp, keep),
                                           generator=generator)
                    inp = inp * mask / keep
            ys.append(inp)
        return torch.stack(ys, dim=1), (torch.stack(hs), torch.stack(cs))
