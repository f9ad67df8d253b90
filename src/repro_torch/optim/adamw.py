"""AdamW for adapter (LoRA) training, over client-stacked trees.

The port of ``repro/optim/adamw.py``.  ``step`` has the shape of the
client axis (``()`` for one client, ``(C,)`` stacked), and the bias
corrections ``1 - b**t`` are taken in float32, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: object
    nu: object


def init(params, n_clients: Optional[int] = None) -> AdamWState:
    z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    shape = () if n_clients is None else (n_clients,)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros(shape, dtype=torch.int32,
                                       device=device),
                      mu=z, nu=tree_map(torch.clone, z))


def update(grads, state: AdamWState, params, *, lr=1e-4, b1=0.9, b2=0.999,
           eps=1e-8, weight_decay=0.0):
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    c2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

    def per_client(c, x):
        return c.reshape(c.shape + (1,) * (x.dim() - c.dim()))

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        u = (m / per_client(c1, m)) / (torch.sqrt(v / per_client(c2, v))
                                       + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
        tree_leaves(params))]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], AdamWState(step=step, mu=new[1], nu=new[2])
