"""Layer construction and application.

The port of ``repro/models/layers.py``: every mixer of the JAX package
(``"attn"`` GQA, ``"mla"`` multi-head latent attention, ``"mamba"``,
``"mlstm"``, ``"slstm"``) and feed-forward block (``"mlp"``, ``"moe"``,
``"none"``): full-sequence (train and prefill) and one-token (decode)
application, and the decode cache's shapes.  An encoder-decoder's
decoder layer adds cross-attention (``cross=True``: the ``x``-prefixed
GQA weights) after its mixer, over the encoder's ``(k, v)``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import random as jr
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm, xlstm

MIXERS = ("attn", "mla", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")
_INIT = {"attn": attn.gqa_params, "mla": attn.mla_params,
         "mamba": ssm.mamba_params, "mlstm": xlstm.mlstm_params,
         "slstm": xlstm.slstm_params}


def _mlp_width(cfg) -> int:
    """``d_ff``, or with ``d_ff == 0`` the sLSTM post-FFN width: ``d ·
    slstm_ffn_factor`` rounded up to a multiple of 128."""
    if cfg.d_ff:
        return cfg.d_ff
    return -(-int(cfg.d_model * cfg.xlstm.slstm_ffn_factor) // 128) * 128


def init_layer_params(key, cfg, mixer: str, ffn: str, dtype,
                      device="cpu", cross: bool = False) -> Dict:
    """One layer's weights under the JAX package's ``split(key, 3)``: the
    mixer's from the first key, the feed-forward block's from the second
    and, with ``cross``, cross-attention's from the third."""
    k1, k2, k3 = jr.split(key, 3)
    if mixer not in _INIT:
        raise ValueError(mixer)
    p = _INIT[mixer](k1, cfg, dtype, device=device)
    if cross:
        p.update(attn.gqa_params(k3, cfg, dtype, device=device, cross=True))
    if ffn == "mlp":
        p.update(ffn_mod.mlp_params(k2, cfg, dtype, d_ff=_mlp_width(cfg),
                                    device=device))
    elif ffn == "moe":
        p.update(ffn_mod.moe_params(k2, cfg, dtype, device=device))
    elif ffn != "none":
        raise ValueError(ffn)
    return p


def _ffn(cfg, p, x, ffn: str):
    """The feed-forward block: ``(x, balance)``, balance the MoE block's
    ``(C,)`` loss, else None."""
    if ffn == "mlp":
        return ffn_mod.mlp(p, cfg, x), None
    if ffn == "moe":
        return ffn_mod.moe(p, cfg, x)
    if ffn == "none":
        return x, None
    raise ValueError(ffn)


def apply_layer_train(cfg, p: Dict, x, positions, mixer: str, ffn: str, *,
                      causal: bool = True, enc_kv=None,
                      mlstm_chunkwise: bool = False):
    """Full-sequence layer.  Returns ``(x, cache, balance)``: the cache
    the attention's ``(k, v)``, MLA's ``(c_kv, k_rope)``, or the
    recurrent mixer's state at the last position (``mamba``: ``(h,
    conv)``; ``mlstm``: ``(C, n, m)``; ``slstm``: ``(c, n, h, m)``);
    ``balance`` the MoE block's load-balance loss a client ``(C,)``, else
    None.  ``causal=False`` (the encoder) reaches the GQA mixer only, as
    in the JAX package; ``enc_kv`` (the encoder's ``(k, v)``,
    ``attention.cross_kv``) adds cross-attention after the mixer.
    ``mlstm_chunkwise`` takes the mLSTM's chunkwise form (JAX's
    ``FwdOptions.mlstm_chunkwise``)."""
    if mixer == "attn":
        x, cache = attn.attn_train(p, cfg, x, positions, causal=causal)
    elif mixer == "mla":
        x, cache = attn.mla_train(p, cfg, x, positions)
    elif mixer == "mamba":
        x, cache = ssm.mamba_train(p, cfg, x)
    elif mixer == "mlstm":
        fn = (xlstm.mlstm_train_chunkwise if mlstm_chunkwise
              else xlstm.mlstm_train)
        x, cache = fn(p, cfg, x)
    elif mixer == "slstm":
        x, cache = xlstm.slstm_train(p, cfg, x)
    else:
        raise ValueError(mixer)
    if enc_kv is not None:
        x = attn.cross_attn_train(p, cfg, x, enc_kv)
    x, balance = _ffn(cfg, p, x, ffn)
    return x, cache, balance


def apply_layer_decode(cfg, p: Dict, x, pos, cache, mixer: str, ffn: str,
                       *, window: int = 0, cross_kv=None):
    """One-token layer step.  Returns ``(x, new_cache)``; the cache is
    written in place.  ``window`` reaches the attention mixers only;
    ``cross_kv`` (the layer's cross cache ``(xk, xv)``) adds
    cross-attention after the mixer."""
    if mixer == "attn":
        x, cache = attn.attn_decode(p, cfg, x, pos, *cache, window=window)
    elif mixer == "mla":
        x, cache = attn.mla_decode(p, cfg, x, pos, *cache, window=window)
    elif mixer == "mamba":
        x, cache = ssm.mamba_decode(p, cfg, x, *cache)
    elif mixer == "mlstm":
        x, cache = xlstm.mlstm_decode(p, cfg, x, cache)
    elif mixer == "slstm":
        x, cache = xlstm.slstm_decode(p, cfg, x, cache)
    else:
        raise ValueError(mixer)
    if cross_kv is not None:
        x = attn.cross_attn_decode(p, cfg, x, *cross_kv)
    return _ffn(cfg, p, x, ffn)[0], cache


def cache_struct(cfg, mixer: str, batch: int, seq: int,
                 dtype=torch.bfloat16, device="cpu"):
    """One layer's decode cache, zeros: GQA's ``(k, v)``, each ``(batch,
    seq, KH, D)``; MLA's ``(c_kv, k_rope)``, ``(batch, seq,
    kv_lora_rank)`` and ``(batch, seq, qk_rope_head_dim)``; Mamba's ``(h
    (batch, ed, d_state) float32, conv (batch, d_conv - 1, ed))``; the
    mLSTM's ``(C (batch, H, D, D), n (batch, H, D), m (batch, H))``
    float32 and ``conv (batch, conv_width - 1, ed)``; the sLSTM's four
    ``(batch, d)`` float32.  ``dtype`` is that of the sequence caches and
    the convolution states."""
    d, H = cfg.d_model, cfg.n_heads

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    f32 = torch.float32
    if mixer == "attn":
        shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return (z(shape), z(shape))
    if mixer == "mla":
        m = cfg.mla
        return (z((batch, seq, m.kv_lora_rank)),
                z((batch, seq, m.qk_rope_head_dim)))
    if mixer == "mamba":
        mc = cfg.mamba
        ed = mc.expand * d
        return (z((batch, ed, mc.d_state), f32),
                z((batch, mc.d_conv - 1, ed)))
    if mixer == "mlstm":
        xc = cfg.xlstm
        ed = xc.expand * d
        hd = ed // H
        return (z((batch, H, hd, hd), f32), z((batch, H, hd), f32),
                z((batch, H), f32), z((batch, xc.conv_width - 1, ed)))
    if mixer == "slstm":
        return tuple(z((batch, d), f32) for _ in range(4))
    raise ValueError(mixer)
