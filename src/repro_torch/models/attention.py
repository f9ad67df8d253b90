"""Grouped-query attention (GQA): training, prefill and decode.

The port of ``repro/models/attention.py``'s GQA layer (``gqa_params``,
``gqa_qkv``, ``gqa_out``, ``attn_train``, ``decode_attention``,
``attn_decode``).  The JAX package's chunked jnp flash becomes one
launch of ``kernels.ops.flash_attention`` per layer, which reads q
``(N, S, H, D)`` and the un-expanded k/v ``(N, S, KH, D)`` in place:
q-head ``h = kh·G + g`` reads kv-head ``kh = h // G``, the JAX grouping.
Decode attention is plain torch, as the JAX package's is jnp: one query
row a sequence against the cache, with JAX's rounding points.
Cross-attention and MLA come with the ROADMAP item "the other model
families".

A sequence axis ``N`` is the client and batch axes folded, ``C·B``;
serving runs one adapter set, so there ``N = B``.  The decode cache of a
layer is ``(k, v)``, each ``(N, S, KH, D)`` (bfloat16 by default,
``model.init_cache``), and ``attn_decode`` writes it in place.
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, dense, init_dense,
                                       lora_pair, rms_norm, rope_freqs,
                                       weight)

NEG_INF = -1e30


def gqa_params(key, cfg, dtype, device="cpu"):
    H, KH, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    ks = jr.split(key, 4)
    return {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "wq": init_dense(ks[0], (d, H * D), dtype, device=device),
        "wkv": init_dense(ks[1], (d, 2 * KH * D), dtype, device=device),
        "wo": init_dense(ks[2], (H * D, d), dtype, device=device,
                         scale=0.5 / (d ** 0.5 * cfg.n_layers ** 0.5)),
    }


def gqa_qkv(params, cfg, x, positions):
    """x ``(C, B, S, d)`` → (xn, q ``(C·B, S, H, D)``, k, v
    ``(C·B, S, KH, D)``), rotary embeddings applied."""
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    C, B, S, _ = x.shape
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    q = dense(xn, weight(params, "wq"),
              lora_pair(params, "wq", cfg.lora)).reshape(C * B, S, H, D)
    kv = dense(xn, weight(params, "wkv"),
               lora_pair(params, "wkv", cfg.lora)
               ).reshape(C * B, S, 2, KH, D)
    k, v = kv[:, :, 0], kv[:, :, 1]
    freqs = rope_freqs(D, cfg.rope_theta, x.device)
    return xn, apply_rope(q, positions, freqs), \
        apply_rope(k, positions, freqs), v


def gqa_out(params, cfg, x, attn_out):
    C, B, S, _ = x.shape
    o = dense(attn_out.reshape(C, B, S, -1), weight(params, "wo"),
              lora_pair(params, "wo", cfg.lora))
    return x + o


def attn_train(params, cfg, x, positions):
    """Full-sequence causal GQA layer (sliding window from the config).
    Returns ``(y, (k, v))``: k (rotary applied) and v ``(N, S, KH, D)``
    in the activation dtype, the layer's prefill cache."""
    _, q, k, v = gqa_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True,
                              window=cfg.sliding_window)
    return gqa_out(params, cfg, x, out), (k, v)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0):
    """One query row a sequence against the cache: q ``(N, 1, H, D)``,
    caches ``(N, S, KH, D)`` → ``(N, 1, H, D)`` in q's dtype.

    ``pos`` (an int or a 0-dim int tensor) is the current token's index:
    slots ``> pos`` are masked, and with ``window`` those ``<= pos -
    window`` too.  JAX's rounding points: q·kᵀ in float32, softmax in
    float32, the probabilities rounded to the cache's dtype, P·V
    accumulated in float32."""
    N, _, H, D = q.shape
    S, KH = v_cache.shape[1], v_cache.shape[2]
    G = H // KH
    qr = q.reshape(N, KH, G, D).float()
    s = torch.einsum("nkgd,nskd->nkgs", qr, k_cache.float()) * (D ** -0.5)
    idx = torch.arange(S, device=q.device)
    valid = idx <= pos
    if window:
        valid &= idx > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("nkgs,nskd->nkgd", p.float(), v_cache.float())
    return out.reshape(N, 1, H, D).to(q.dtype)


def attn_decode(params, cfg, x, pos, k_cache, v_cache, *, window: int = 0):
    """One-token GQA step.  x ``(C, B, 1, d)``; ``pos`` an int or a
    0-dim int tensor on x's device (read on the device either way, with
    no copy to or from the host).  Returns ``(y, (k_cache, v_cache))``,
    the caches written in place.

    The new k/v go to slot ``pos % S`` of a rolling cache (``window``
    equal to the cache length ``S``), else to slot ``pos``, clamped to
    ``[0, S - 1]`` as JAX's ``dynamic_update_slice`` clamps a write past
    the end."""
    pos = (pos.reshape(1).long() if torch.is_tensor(pos)
           else torch.arange(pos, pos + 1, device=x.device))
    _, q, k, v = gqa_qkv(params, cfg, x, pos)
    S = k_cache.shape[1]
    rolling = bool(window) and S == window
    slot = pos % S if rolling else torch.clamp(pos, 0, S - 1)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    if rolling:
        # slots wrap; unwritten slots exist only while pos < S, and then
        # "idx <= pos" is exactly the written set
        out = decode_attention(q, k_cache, v_cache,
                               torch.clamp(pos, max=S - 1), window=0)
    else:
        out = decode_attention(q, k_cache, v_cache, pos, window=window)
    return gqa_out(params, cfg, x, out), (k_cache, v_cache)
