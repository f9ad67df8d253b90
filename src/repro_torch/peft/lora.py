"""LoRA adapters and the federated adapter algebra (paper §II-A, Alg. 1).

The port of ``repro/peft/lora.py``'s ``init_layer_adapters``,
``weighted_average_stacked`` and ``blend_adapters``.  Adapters attach to
the 2-D base weights named in ``cfg.lora.targets``: A ``(d_in, r)``
drawn normal / √d_in, B ``(r, d_out)`` zero, both float32.  QLoRA
(``quantize``/``dequantize``) comes with its ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.tree import tree_map


def init_layer_adapters(key, cfg, layer_params: Dict) -> Dict:
    """Adapters for one layer's base weights, drawn on their device."""
    names = [n for n, p in sorted(layer_params.items())
             if n in cfg.lora.targets and p.dim() == 2]
    out = {}
    if not names:
        return out
    keys = jr.split(key, len(names))
    r = cfg.lora.rank
    for k, n in zip(keys, names):
        d_in, d_out = layer_params[n].shape
        dev = layer_params[n].device
        # true float32 division by the float32 √d_in, as XLA divides
        root = torch.tensor(float(np.sqrt(np.float32(d_in))),
                            dtype=torch.float32, device=dev)
        out[f"{n}_lora_a"] = jr.normal(k, (d_in, r), dev) / root
        out[f"{n}_lora_b"] = torch.zeros((r, d_out), dtype=torch.float32,
                                         device=dev)
    return out


def weighted_average_stacked(stacked, weights: torch.Tensor):
    """FedAvg over a client-stacked adapter tree.

    ``stacked`` holds ``(C, …)`` leaves; ``weights`` is ``(C,)`` and is
    normalized here, so padding clients contribute nothing when their
    weight is 0.
    """
    w = weights.float()
    w = w / torch.sum(w)

    def leaf(x):
        return torch.sum(w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
                         * x, dim=0)

    return tree_map(leaf, stacked)


def blend_adapters(adapters, a_g, rho: float):
    """Distill toward the global teacher: a ← (1−ρ)·a + ρ·a_g (a_g
    broadcasts along a leading client axis)."""
    return tree_map(lambda a, g: (1.0 - rho) * a + rho * g, adapters, a_g)
