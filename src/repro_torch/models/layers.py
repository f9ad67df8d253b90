"""Layer construction and application, for ``("attn", "mlp")`` layers.

The port of ``repro/models/layers.py``.  Every other mixer and FFN of the
JAX package raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

from repro_torch import random as jr
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod

_OTHER_FAMILIES = "ROADMAP §1, 'the other model families'"


def _unported(kind: str, name: str):
    return NotImplementedError(f"{kind} {name!r} is not ported yet "
                               f"({_OTHER_FAMILIES}); the port runs "
                               "('attn', 'mlp') layers")


def init_layer_params(key, cfg, mixer: str, ffn: str, dtype,
                      device="cpu") -> Dict:
    k1, k2, _ = jr.split(key, 3)
    if mixer != "attn":
        raise _unported("mixer", mixer)
    if ffn != "mlp":
        raise _unported("ffn", ffn)
    p = attn.gqa_params(k1, cfg, dtype, device)
    p.update(ffn_mod.mlp_params(k2, cfg, dtype, device=device))
    return p


def apply_layer_train(cfg, p: Dict, x, positions, mixer: str, ffn: str):
    """Full-sequence layer."""
    if mixer != "attn":
        raise _unported("mixer", mixer)
    if ffn != "mlp":
        raise _unported("ffn", ffn)
    return ffn_mod.mlp(p, cfg, attn.attn_train(p, cfg, x, positions))
