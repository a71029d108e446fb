"""The reference's hand-written optimizer updates — port of
`imagecaptioning_tpu/train/optim_updates.py` (after
`DenseCap/densecap/optim_updates.py:1-57`), on dicts of tensors: each
update is `(params, grads, state, lr, ...) -> (params, state)` and
returns new tensors. No driver calls them, in the reference, the JAX
package or here: the drivers use torch's Adam (`train/optim.py`,
`train/dense_driver.py`).

- sgd:     x -= lr * dx
- sgdm:    v = a*v + lr*dx;          x -= v
- sgdmom:  m' = a*m - lr*dx;         x += -a*m + (1+a)*m'   (Nesterov)
- adagrad: G += dx^2;                x -= lr * dx / (sqrt(G) + eps)
- rmsprop: G = a*G + (1-a)*dx^2;     x -= lr * dx / (sqrt(G) + eps)
- adam:    bias-corrected, eps added after the square root (the
  reference's `sqrt().add_(eps)`, torch.optim.Adam's order).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Tensors = Dict[str, torch.Tensor]


def _map(fn: Callable, *trees: Tensors) -> Tensors:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def _zeros_like(tree: Tensors) -> Tensors:
    return _map(torch.zeros_like, tree)


def sgd(params, grads, lr):
    return _map(lambda x, dx: x - lr * dx, params, grads)


def sgdm_init(params):
    return {"v": _zeros_like(params)}


def sgdm(params, grads, state, lr, alpha=0.9):
    v = _map(lambda v, dx: alpha * v + lr * dx, state["v"], grads)
    return _map(lambda x, v: x - v, params, v), {"v": v}


def sgdmom_init(params):
    return {"m": _zeros_like(params)}


def sgdmom(params, grads, state, lr, alpha=0.9):
    """Nesterov momentum: x += -a*m_old + (1+a)*m_new with
    m_new = a*m_old - lr*dx."""
    m_old = state["m"]
    m = _map(lambda m, dx: alpha * m - lr * dx, m_old, grads)
    params = _map(lambda x, mo, mn: x - alpha * mo + (1 + alpha) * mn,
                  params, m_old, m)
    return params, {"m": m}


def adagrad_init(params):
    return {"m": _zeros_like(params)}


def adagrad(params, grads, state, lr, epsilon=1e-10):
    m = _map(lambda m, dx: m + dx * dx, state["m"], grads)
    params = _map(lambda x, dx, m: x - lr * dx / (torch.sqrt(m) + epsilon),
                  params, grads, m)
    return params, {"m": m}


def rmsprop_init(params):
    return {"m": _zeros_like(params)}


def rmsprop(params, grads, state, lr, alpha=0.99, epsilon=1e-8):
    m = _map(lambda m, dx: alpha * m + (1 - alpha) * dx * dx,
             state["m"], grads)
    params = _map(lambda x, dx, m: x - lr * dx / (torch.sqrt(m) + epsilon),
                  params, grads, m)
    return params, {"m": m}


def adam_init(params):
    return {"t": 0, "m": _zeros_like(params), "v": _zeros_like(params)}


def adam(params, grads, state, lr, beta1=0.9, beta2=0.999, epsilon=1e-8):
    t = state["t"] + 1
    m = _map(lambda m, dx: beta1 * m + (1 - beta1) * dx, state["m"], grads)
    v = _map(lambda v, dx: beta2 * v + (1 - beta2) * dx * dx,
             state["v"], grads)
    # the bias corrections in fp32 with a float exponent, as JAX computes
    # them (an integer power rounds otherwise)
    tf = torch.tensor(float(t))
    bc1 = 1 - torch.tensor(beta1) ** tf
    bc2 = 1 - torch.tensor(beta2) ** tf
    step_size = lr * torch.sqrt(bc2) / bc1
    params = _map(lambda x, m, v: x - step_size * m / (torch.sqrt(v)
                                                       + epsilon),
                  params, m, v)
    return params, {"t": t, "m": m, "v": v}
