"""Layer construction and application, for ``("attn", "mlp")`` layers.

The port of ``repro/models/layers.py``: full-sequence (train and
prefill) and one-token (decode) application, and the decode cache's
shapes.  Every other mixer and FFN of the JAX package raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import random as jr
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod

_OTHER_FAMILIES = "ROADMAP §1, 'the other model families'"


def _unported(kind: str, name: str):
    return NotImplementedError(f"{kind} {name!r} is not ported yet "
                               f"({_OTHER_FAMILIES}); the port runs "
                               "('attn', 'mlp') layers")


def _dense_only(mixer: str, ffn: str):
    if mixer != "attn":
        raise _unported("mixer", mixer)
    if ffn != "mlp":
        raise _unported("ffn", ffn)


def init_layer_params(key, cfg, mixer: str, ffn: str, dtype,
                      device="cpu") -> Dict:
    k1, k2, _ = jr.split(key, 3)
    _dense_only(mixer, ffn)
    p = attn.gqa_params(k1, cfg, dtype, device)
    p.update(ffn_mod.mlp_params(k2, cfg, dtype, device=device))
    return p


def apply_layer_train(cfg, p: Dict, x, positions, mixer: str, ffn: str):
    """Full-sequence layer.  Returns ``(x, cache)``, the cache the
    attention's ``(k, v)``."""
    _dense_only(mixer, ffn)
    x, cache = attn.attn_train(p, cfg, x, positions)
    return ffn_mod.mlp(p, cfg, x), cache


def apply_layer_decode(cfg, p: Dict, x, pos, cache, mixer: str, ffn: str,
                       *, window: int = 0):
    """One-token layer step.  Returns ``(x, new_cache)``; the cache is
    written in place."""
    _dense_only(mixer, ffn)
    x, cache = attn.attn_decode(p, cfg, x, pos, *cache, window=window)
    return ffn_mod.mlp(p, cfg, x), cache


def cache_struct(cfg, mixer: str, batch: int, seq: int,
                 dtype=torch.bfloat16, device="cpu"):
    """One layer's decode cache, zeros: ``(k, v)``, each ``(batch, seq,
    KH, D)``."""
    if mixer != "attn":
        raise _unported("mixer", mixer)
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
