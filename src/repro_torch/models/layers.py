"""Layer construction and application.

The port of ``repro/models/layers.py`` for the mixers ``"attn"`` (GQA)
and ``"mla"`` (multi-head latent attention) and the feed-forward blocks
``"mlp"`` and ``"moe"``: full-sequence (train and prefill) and one-token
(decode) application, and the decode cache's shapes.  The Mamba and
xLSTM mixers raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import random as jr
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod

MIXERS = ("attn", "mla")
FFNS = ("mlp", "moe")
# mixers of the JAX package still to port, and the ROADMAP item of each
_UNPORTED = {"mamba": "Mamba (jamba)", "mlstm": "xLSTM", "slstm": "xLSTM"}


def _check(mixer: str, ffn: str):
    if mixer in _UNPORTED:
        raise NotImplementedError(
            f"mixer {mixer!r} is not ported yet (ROADMAP §1, 'the other "
            f"model families': {_UNPORTED[mixer]}); the port runs the "
            f"mixers {MIXERS} and the feed-forward blocks {FFNS}")
    if mixer not in MIXERS:
        raise ValueError(mixer)
    if ffn not in FFNS:
        raise ValueError(ffn)


def init_layer_params(key, cfg, mixer: str, ffn: str, dtype,
                      device="cpu") -> Dict:
    k1, k2, _ = jr.split(key, 3)
    _check(mixer, ffn)
    if mixer == "attn":
        p = attn.gqa_params(k1, cfg, dtype, device)
    else:
        p = attn.mla_params(k1, cfg, dtype, device)
    if ffn == "mlp":
        p.update(ffn_mod.mlp_params(k2, cfg, dtype, device=device))
    else:
        p.update(ffn_mod.moe_params(k2, cfg, dtype, device=device))
    return p


def apply_layer_train(cfg, p: Dict, x, positions, mixer: str, ffn: str):
    """Full-sequence layer.  Returns ``(x, cache, balance)``: the cache
    the attention's ``(k, v)`` or MLA's ``(c_kv, k_rope)``; ``balance``
    the MoE block's load-balance loss a client ``(C,)``, else None."""
    _check(mixer, ffn)
    if mixer == "attn":
        x, cache = attn.attn_train(p, cfg, x, positions)
    else:
        x, cache = attn.mla_train(p, cfg, x, positions)
    if ffn == "mlp":
        return ffn_mod.mlp(p, cfg, x), cache, None
    x, balance = ffn_mod.moe(p, cfg, x)
    return x, cache, balance


def apply_layer_decode(cfg, p: Dict, x, pos, cache, mixer: str, ffn: str,
                       *, window: int = 0):
    """One-token layer step.  Returns ``(x, new_cache)``; the cache is
    written in place."""
    _check(mixer, ffn)
    if mixer == "attn":
        x, cache = attn.attn_decode(p, cfg, x, pos, *cache, window=window)
    else:
        x, cache = attn.mla_decode(p, cfg, x, pos, *cache, window=window)
    if ffn == "mlp":
        return ffn_mod.mlp(p, cfg, x), cache
    return ffn_mod.moe(p, cfg, x)[0], cache


def cache_struct(cfg, mixer: str, batch: int, seq: int,
                 dtype=torch.bfloat16, device="cpu"):
    """One layer's decode cache, zeros: GQA's ``(k, v)``, each ``(batch,
    seq, KH, D)``; MLA's ``(c_kv, k_rope)``, ``(batch, seq,
    kv_lora_rank)`` and ``(batch, seq, qk_rope_head_dim)``."""
    _check(mixer, "mlp")
    if mixer == "mla":
        m = cfg.mla
        return (torch.zeros((batch, seq, m.kv_lora_rank), dtype=dtype,
                            device=device),
                torch.zeros((batch, seq, m.qk_rope_head_dim), dtype=dtype,
                            device=device))
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
