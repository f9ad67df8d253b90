"""Carry the JAX package's weights and state across to the port.

The JAX side hands its trees over as numpy arrays (``np.asarray`` of a
``jax.Array``, e.g. through ``jax.tree.map``), so nothing here imports
JAX.

  - ``from_jax`` maps a tree of arrays (dicts, lists and tuples nest;
    ``None`` stays ``None``) to torch tensors on ``device``: θ_g, the
    teacher-probability stacks.
  - ``params_from_jax`` maps a base LLM: JAX stacks the layers of each
    pattern position along a leading group axis (``params["groups"]``, a
    tuple of dicts of ``(n_groups, …)`` arrays); the port keeps one dict
    per layer, layer ``g·P + p`` for group ``g`` and position ``p``.
  - ``adapters_from_jax`` does the same for LoRA adapters, one client's
    (``(n_groups, …)`` leaves) or client-stacked (``(C, n_groups, …)``).
  - ``adamw_from_jax`` maps an ``AdamWState`` (step, mu, nu) alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


def from_jax(tree, device="cpu"):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def _unstack_groups(groups, device, stacked: bool):
    """Per-layer dicts from JAX's tuple of group-stacked dicts."""
    P = len(groups)
    axis = 1 if stacked else 0
    n_groups = next(iter(groups[0].values())).shape[axis]
    return [{name: from_jax(np.take(arr, g, axis=axis), device)
             for name, arr in groups[p].items()}
            for g in range(n_groups) for p in range(P)]


def params_from_jax(params: dict, device="cpu") -> dict:
    out = {k: from_jax(v, device) for k, v in params.items()
           if k != "groups"}
    out["layers"] = _unstack_groups(params["groups"], device, stacked=False)
    return out


def adapters_from_jax(adapters: dict, device="cpu", stacked: bool = False):
    return _unstack_groups(adapters["groups"], device, stacked)


def adamw_from_jax(state, device="cpu", stacked: bool = False) -> AdamWState:
    step, mu, nu = state
    return AdamWState(step=from_jax(step, device),
                      mu=adapters_from_jax(mu, device, stacked),
                      nu=adapters_from_jax(nu, device, stacked))
