"""Attention mixers: grouped-query attention (GQA) and multi-head latent
attention (MLA), for training, prefill and decode.

The port of ``repro/models/attention.py``'s GQA layer (``gqa_params``,
``gqa_qkv``, ``gqa_out``, ``attn_train``, ``decode_attention``,
``attn_decode``), its cross-attention (``cross_attn_train``,
``cross_kv``, ``cross_attn_decode``) and its MLA layer (``mla_params``,
``mla_train``, ``mla_decode``).  The JAX package's chunked jnp flash
becomes one launch of ``kernels.ops.flash_attention`` per layer, which
reads q ``(N, S, H, D)`` and the un-expanded k/v ``(N, Sk, KH, D)`` in
place: q-head ``h = kh·G + g`` reads kv-head ``kh = h // G``, the JAX
grouping.  Decode attention is plain torch, as the JAX package's is
jnp: one query row a sequence against the cache, with JAX's rounding
points.  Rotary embeddings take ``cfg.mrope_sections`` (M-RoPE).

Cross-attention (the encoder-decoder's decoder layers).  Its weights
carry an ``x`` prefix (``xln``, ``xwq``, ``xwkv``, ``xwo``), which no
LoRA target names, so its projections are plain products
(``common.matmul``), as JAX's ``dense`` takes them.  Its queries come
from the decoder stream with no rotary embedding; its keys and values
are ``cross_kv`` of the encoder's output, ``(N, F, KH, D)`` over the
``F`` frames.  Prefill runs one non-causal ``flash_attention`` launch
over them (``Sq`` prompt rows against ``Sk = F`` keys); decode reads
the same ``(xk, xv)`` from the cross cache, every slot valid.

MLA (DeepSeek-V2 / MiniCPM3).  Queries come through a low-rank latent
(``wq_a``, RMS norm, ``wq_b``); keys and values through a compressed
latent ``c_kv`` (``wkv_a``, RMS norm) expanded per head by ``wkv_b``,
and one rotary key part ``k_rope`` shared by every head, rotated with
its own ``rope_freqs(qk_rope_head_dim)``.  Prefill materialises per-head
K/V and runs ``flash_attention`` at the q/k head dim ``nope + rope``
over a v head dim of ``v_head_dim`` (96 over 64 at minicpm3-4b's
widths); its cache, and the decode cache, is the compressed ``(c_kv,
k_rope)``, ``(N, S, kv_lora_rank)`` and ``(N, S, qk_rope_head_dim)``.
Decode is the absorbed-matrix form in plain torch (JAX's is jnp): the
query is taken into the latent space through ``wkv_b``'s key half, the
scores read the compressed cache, and the context goes back through its
value half.  As in the JAX package, decode uses ``wkv_b``'s base weight
alone: a LoRA adapter of ``wkv_b`` acts in prefill and not in decode.

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


def gqa_params(key, cfg, dtype, device="cpu", cross: bool = False):
    """GQA's weights under the JAX package's ``split(key, 4)``;
    ``cross`` names them with cross-attention's ``x`` prefix."""
    H, KH, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    ks = jr.split(key, 4)
    pre = "x" if cross else ""
    return {
        f"{pre}ln": torch.ones((d,), dtype=dtype, device=device),
        f"{pre}wq": init_dense(ks[0], (d, H * D), dtype, device=device),
        f"{pre}wkv": init_dense(ks[1], (d, 2 * KH * D), dtype,
                                device=device),
        f"{pre}wo": init_dense(ks[2], (H * D, d), dtype, device=device,
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
    freqs = rope_freqs(D, cfg.rope_theta, cfg.mrope_sections,
                       device=x.device)
    return xn, apply_rope(q, positions, freqs), \
        apply_rope(k, positions, freqs), v


def gqa_out(params, cfg, x, attn_out, pre: str = ""):
    """``x`` plus the output projection (``{pre}wo``) of ``attn_out``."""
    C, B, S, _ = x.shape
    o = dense(attn_out.reshape(C, B, S, -1), weight(params, f"{pre}wo"),
              lora_pair(params, f"{pre}wo", cfg.lora))
    return x + o


def attn_train(params, cfg, x, positions, *, causal: bool = True):
    """Full-sequence GQA layer (sliding window from the config; the
    encoder runs it with ``causal=False``).  Returns ``(y, (k, v))``: k
    (rotary applied) and v ``(N, S, KH, D)`` in the activation dtype,
    the layer's prefill cache."""
    _, q, k, v = gqa_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window)
    return gqa_out(params, cfg, x, out), (k, v)


def _cross_q(params, cfg, x):
    """Cross-attention's queries, ``(C·B, S, H, D)``, no rotary."""
    C, B, S, _ = x.shape
    xn = rms_norm(x, params["xln"], cfg.norm_eps)
    return dense(xn, weight(params, "xwq"),
                 lora_pair(params, "xwq", cfg.lora)).reshape(
        C * B, S, cfg.n_heads, cfg.head_dim)


def cross_attn_train(params, cfg, x, enc_kv):
    """Decoder cross-attention over the encoder's ``(k, v)``, each ``(C·B,
    F, KH, D)``: one non-causal ``flash_attention`` launch.  Where the
    encoder's stream is wider than the decoder's (float32 frames under a
    bfloat16 model), the attention runs in the wider dtype and its output
    is rounded to the decoder's, as JAX's einsums promote."""
    q = _cross_q(params, cfg, x)
    k, v = enc_kv
    dt = torch.promote_types(q.dtype, k.dtype)
    out = ops.flash_attention(q.to(dt), k.to(dt), v.to(dt), causal=False)
    return gqa_out(params, cfg, x, out.to(x.dtype), pre="x")


def cross_kv(params, cfg, enc_out):
    """Cross-attention's keys and values from the encoder's output
    ``(C, B, F, d)``: ``(k, v)``, each ``(C·B, F, KH, D)`` in its
    dtype (the prefill's cross cache)."""
    C, B, F, _ = enc_out.shape
    kv = dense(enc_out, weight(params, "xwkv"),
               lora_pair(params, "xwkv", cfg.lora)).reshape(
        C * B, F, 2, cfg.n_kv_heads, cfg.head_dim)
    return kv[:, :, 0], kv[:, :, 1]


def cross_attn_decode(params, cfg, x, xk, xv):
    """One-token cross-attention, x ``(C, B, 1, d)``, over the cross
    cache ``xk``, ``xv`` ``(C·B, F, KH, D)``, every slot valid (``pos =
    F - 1``), in plain torch as ``decode_attention``."""
    q = _cross_q(params, cfg, x)
    out = decode_attention(q, xk, xv, xk.shape[1] - 1)
    return gqa_out(params, cfg, x, out, pre="x")


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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------
def mla_params(key, cfg, dtype, device="cpu"):
    """MLA's weights under the JAX package's ``split(key, 6)``."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    ks = jr.split(key, 6)
    return {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "wq_a": init_dense(ks[0], (d, m.q_lora_rank), dtype, device=device),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=device),
        "wq_b": init_dense(ks[1], (m.q_lora_rank, H * qk_dim), dtype,
                           device=device),
        "wkv_a": init_dense(ks[2], (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype, device=device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
        "wkv_b": init_dense(ks[3], (m.kv_lora_rank,
                                    H * (m.qk_nope_head_dim + m.v_head_dim)),
                            dtype, device=device),
        "wo": init_dense(ks[4], (H * m.v_head_dim, d), dtype, device=device,
                         scale=0.5 / (d ** 0.5 * cfg.n_layers ** 0.5)),
    }


def _mla_q(params, cfg, xn, positions):
    """xn ``(C, B, S, d)`` → (q_nope, q_rope), ``(C·B, S, H, nope)`` and
    ``(C·B, S, H, rope)``, the rotary part rotated."""
    m, H = cfg.mla, cfg.n_heads
    C, B, S, _ = xn.shape
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    cq = dense(xn, weight(params, "wq_a"),
               lora_pair(params, "wq_a", cfg.lora))
    cq = rms_norm(cq, params["q_norm"], cfg.norm_eps)
    q = dense(cq, weight(params, "wq_b"),
              lora_pair(params, "wq_b", cfg.lora)).reshape(C * B, S, H,
                                                           qk_dim)
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        rope_freqs(m.qk_rope_head_dim, cfg.rope_theta,
                                   device=xn.device))
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_ckv(params, cfg, xn, positions):
    """xn ``(C, B, S, d)`` → (c_kv ``(C·B, S, kv_lora_rank)`` normed,
    k_rope ``(C·B, S, rope)`` rotated)."""
    m = cfg.mla
    C, B, S, _ = xn.shape
    ckv_full = dense(xn, weight(params, "wkv_a"),
                     lora_pair(params, "wkv_a", cfg.lora)).reshape(C * B, S,
                                                                   -1)
    c_kv = rms_norm(ckv_full[..., :m.kv_lora_rank], params["kv_norm"],
                    cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., m.kv_lora_rank:], positions,
                        rope_freqs(m.qk_rope_head_dim, cfg.rope_theta,
                                   device=xn.device), heads=False)
    return c_kv, k_rope


def mla_train(params, cfg, x, positions, *, window: int = 0):
    """Full-sequence causal MLA layer, x ``(C, B, S, d)``.  Returns ``(y,
    (c_kv, k_rope))``, the compressed cache in the activation dtype.  The
    JAX package passes MLA the forward's window override (0 by default),
    not ``cfg.sliding_window``."""
    m, H = cfg.mla, cfg.n_heads
    C, B, S, _ = x.shape
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    q_nope, q_rope = _mla_q(params, cfg, xn, positions)
    c_kv, k_rope = _mla_ckv(params, cfg, xn, positions)
    kv = dense(c_kv.reshape(C, B, S, -1), weight(params, "wkv_b"),
               lora_pair(params, "wkv_b", cfg.lora))
    kv = kv.reshape(C * B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        C * B, S, H, m.qk_rope_head_dim)], dim=-1)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    o = dense(out.reshape(C, B, S, H * m.v_head_dim), weight(params, "wo"),
              lora_pair(params, "wo", cfg.lora))
    return x + o, (c_kv, k_rope)


def _rounded_einsum(eq: str, a, b, dtype) -> torch.Tensor:
    """``einsum`` taken in float32 and rounded once to ``dtype``, as XLA
    takes a product of two ``dtype`` operands."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


def mla_decode(params, cfg, x, pos, ckv_cache, krope_cache, *,
               window: int = 0):
    """One-token absorbed-matrix MLA step, x ``(C, B, 1, d)``, ``pos`` an
    int or a 0-dim int tensor on x's device.  The compressed caches
    ``(C·B, S, ·)`` are written at slot ``pos`` (clamped to the cache, as
    ``dynamic_update_slice`` clamps; there is no rolling cache here) in
    place.  JAX's rounding points: the latent query in the activation
    dtype; the scores and softmax in float32; the probabilities rounded
    to the cache dtype, and the context and the per-head output products
    in the cache dtype.  Returns ``(y, (ckv_cache, krope_cache))``."""
    m, H = cfg.mla, cfg.n_heads
    C, B = x.shape[:2]
    pos = (pos.reshape(1).long() if torch.is_tensor(pos)
           else torch.arange(pos, pos + 1, device=x.device))
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    q_nope, q_rope = _mla_q(params, cfg, xn, pos)      # (N, 1, H, ·)
    c_kv, k_rope = _mla_ckv(params, cfg, xn, pos)      # (N, 1, ·)
    S = ckv_cache.shape[1]
    slot = torch.clamp(pos, 0, S - 1)
    ckv_cache.index_copy_(1, slot, c_kv.to(ckv_cache.dtype))
    krope_cache.index_copy_(1, slot, k_rope.to(krope_cache.dtype))

    wkv_b = weight(params, "wkv_b").reshape(
        m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim]             # (r, H, nope)
    w_uv = wkv_b[..., m.qk_nope_head_dim:]             # (r, H, v)
    cdt = ckv_cache.dtype
    q_lat = _rounded_einsum("nihc,rhc->nihr", q_nope, w_uk.to(q_nope.dtype),
                            q_nope.dtype)
    s = (torch.einsum("nihr,nsr->nhis", q_lat.float(), ckv_cache.float())
         + torch.einsum("nihc,nsc->nhis", q_rope.float(),
                        krope_cache.float()))
    s = s * ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    idx = torch.arange(S, device=x.device)
    valid = idx <= pos
    if window:
        valid &= idx > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cdt)
    ctx = _rounded_einsum("nhis,nsr->nihr", p, ckv_cache, cdt)
    out = _rounded_einsum("nihr,rhv->nihv", ctx, w_uv.to(cdt), cdt)
    o = dense(out.reshape(C, B, 1, H * m.v_head_dim).to(x.dtype),
              weight(params, "wo"), lora_pair(params, "wo", cfg.lora))
    return x + o, (ckv_cache, krope_cache)
