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
    per layer, layer ``g·P + p`` for group ``g`` and position ``p``.  A
    MoE layer's expert stacks stay 3-D ``(E, …)`` and its router
    float32; an MLA layer's latent projections and norms carry across
    by name; the float32 leaves of a recurrent layer (Mamba's ``dt_b``,
    ``A_log``, ``D``; the mLSTM's ``w_if``, ``b_if``; the sLSTM's
    ``r_gates``, ``b_gates``) stay float32 under a bfloat16 base.
  - ``adapters_from_jax`` does the same for LoRA adapters, one client's
    (``(n_groups, …)`` leaves) or client-stacked (``(C, n_groups, …)``);
    a pattern position with no adapter target (an sLSTM layer) gives
    ``{}`` a layer.
  - ``adamw_from_jax`` maps an ``AdamWState`` (step, mu, nu) alike.
  - ``cache_from_jax`` maps a decode or prefill cache: JAX's tuple of
    one tuple a pattern position (GQA's ``(k, v)``, each ``(n_groups, B,
    S, KH, D)``; MLA's compressed ``(c_kv, k_rope)``; the recurrent
    states, Mamba's 2, the mLSTM's 3 (prefill) or 4 (decode), the
    sLSTM's 4) becomes the port's list of one tuple a layer.

A bfloat16 array (numpy's ``ml_dtypes`` bfloat16) is carried bit for
bit.
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
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


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


def cache_from_jax(cache, device="cpu") -> list:
    P = len(cache)
    n_groups = np.shape(cache[0][0])[0]
    return [tuple(from_jax(np.take(t, g, axis=0), device)
                  for t in cache[p])
            for g in range(n_groups) for p in range(P)]
