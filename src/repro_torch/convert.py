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
    ``r_gates``, ``b_gates``) stay float32 under a bfloat16 base.  An
    encoder-decoder's ``enc_groups`` become ``"enc_layers"`` alike, and
    ``proj_frontend`` and ``enc_final_norm`` carry across as they are.
  - ``adapters_from_jax`` does the same for LoRA adapters, one client's
    (``(n_groups, …)`` leaves) or client-stacked (``(C, n_groups, …)``);
    a pattern position with no adapter target (an sLSTM layer) gives
    ``{}`` a layer.  An encoder-decoder's (JAX's ``{"groups",
    "enc_groups"}``) become ``{"layers", "enc_layers"}``.
  - ``adamw_from_jax`` maps an ``AdamWState`` (step, mu, nu) alike.
  - ``cache_from_jax`` maps a decode or prefill cache: JAX's tuple of
    one tuple a pattern position (GQA's ``(k, v)``, each ``(n_groups, B,
    S, KH, D)``; MLA's compressed ``(c_kv, k_rope)``; the recurrent
    states, Mamba's 2, the mLSTM's 3 (prefill) or 4 (decode), the
    sLSTM's 4; an encoder-decoder prefill's ``((k, v), (xk, xv))``)
    becomes the port's list of one tuple a layer.  With ``pair=True`` it
    maps an encoder-decoder's decode cache, JAX's ``(self caches, cross
    caches)``, to the port's pair of such lists.

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


def _take(tree, g: int, axis: int, device):
    """Index ``g`` of ``axis`` of every array of a nested tuple or dict."""
    if isinstance(tree, dict):
        return {k: _take(v, g, axis, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, g, axis, device) for v in tree)
    return from_jax(np.take(tree, g, axis=axis), device)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _unstack_groups(groups, device, stacked: bool):
    """Per-layer entries from JAX's tuple of group-stacked entries (one a
    pattern position), layer ``g·P + p``."""
    P = len(groups)
    axis = 1 if stacked else 0
    n_groups = np.shape(_first_leaf(groups))[axis]
    return [_take(groups[p], g, axis, device)
            for g in range(n_groups) for p in range(P)]


def params_from_jax(params: dict, device="cpu") -> dict:
    out = {k: from_jax(v, device) for k, v in params.items()
           if k not in ("groups", "enc_groups")}
    out["layers"] = _unstack_groups(params["groups"], device, stacked=False)
    if "enc_groups" in params:
        out["enc_layers"] = _unstack_groups(params["enc_groups"], device,
                                            stacked=False)
    return out


def adapters_from_jax(adapters: dict, device="cpu", stacked: bool = False):
    layers = _unstack_groups(adapters["groups"], device, stacked)
    if "enc_groups" not in adapters:
        return layers
    return {"layers": layers, "enc_layers": _unstack_groups(
        adapters["enc_groups"], device, stacked)}


def adamw_from_jax(state, device="cpu", stacked: bool = False) -> AdamWState:
    step, mu, nu = state
    return AdamWState(step=from_jax(step, device),
                      mu=adapters_from_jax(mu, device, stacked),
                      nu=adapters_from_jax(nu, device, stacked))


def cache_from_jax(cache, device="cpu", pair: bool = False):
    if pair:
        return tuple(cache_from_jax(c, device) for c in cache)
    return _unstack_groups(cache, device, stacked=False)
