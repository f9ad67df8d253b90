"""Grouped-query attention (GQA) for training and evaluation.

The port of ``repro/models/attention.py``'s GQA layer (``gqa_params``,
``gqa_qkv``, ``gqa_out``, ``attn_train``).  The JAX package's chunked
jnp flash becomes one launch of ``kernels.ops.flash_attention`` per
layer, which reads q ``(N, S, H, D)`` and the un-expanded k/v
``(N, S, KH, D)`` in place: q-head ``h = kh·G + g`` reads kv-head
``kh = h // G``, the JAX grouping.  Decode, cross-attention and MLA come
with the ROADMAP items "serving and decode" and "the other model
families".
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, dense, init_dense,
                                       lora_pair, rms_norm, rope_freqs,
                                       weight)


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
    """Full-sequence causal GQA layer (sliding window from the config)."""
    _, q, k, v = gqa_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True,
                              window=cfg.sliding_window)
    return gqa_out(params, cfg, x, out)
