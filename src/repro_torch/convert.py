"""Carry the JAX package's weights and state across to the port.

The JAX side hands its parameters over as numpy arrays (``np.asarray``
of a ``jax.Array``), so nothing here imports JAX.  ``from_jax`` maps a
tree of such arrays — dicts, lists and tuples nest; ``None`` stays
``None`` — to torch tensors on ``device`` with the same dtype and values.
In this slice that is θ_g and the per-client teacher-probability stacks;
later slices carry LoRA adapters and base LLM weights the same way.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax(tree, device="cpu"):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)
