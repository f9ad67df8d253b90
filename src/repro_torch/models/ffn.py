"""Feed-forward blocks: the dense SwiGLU MLP and the capacity-based top-k
mixture of experts (MoE).

The port of ``repro/models/ffn.py``: ``mlp_params``, ``mlp``,
``moe_params``, ``_capacity`` and ``moe``.  Activations are ``(C, B, S,
d)``; the JAX package's ``moe`` sees one client's ``(B, S, d)``, so the
port routes each client alone: its ``T = B·S`` tokens, its capacity, its
sort and its balance loss.

MoE, as in the JAX package.  The router takes the normed tokens in
float32 (its weight is float32 whatever the model dtype); each token
takes its top-k experts by probability, ties to the lower index (a
stable descending sort, as ``lax.top_k`` orders them), with its gates
renormalised to sum to one.  A token's position in an expert's buffer
is its rank among the tokens (token-major, then k) that chose that
expert: a stable argsort of the flat choices and a left ``searchsorted``
of each expert's first slot.  Choices ranked at or past the capacity
``C_e`` are dropped.  The kept ones are copied into ``(E, C_e, d)``
buffers, each expert's SwiGLU runs on its buffer (two batched products
over all E experts, as the JAX einsums run), and each token sums its
kept experts' outputs weighted by its gates, in the output dtype, plus
the always-on shared expert.  Every kept ``(expert, slot)`` is unique,
so the dispatch is one indexed copy with no atomic adds: a dropped
choice goes to a spare row past the buffers, which nothing reads (JAX
adds zeros into slot ``C_e - 1`` instead: the same function).  Nothing
here reads back to the host.  The expert weights are 3-D and get no
LoRA adapter; the shared expert is no adapter target.  On a device mesh
(the dry run) the routing metadata is replicated and the expert buffers
ride ``'model'`` on their E axis, as JAX's constraints lay them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch import random as jr
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import (dense, init_dense, lora_pair, matmul,
                                       rms_norm, swiglu, weight)


def mlp_params(key, cfg, dtype, d_ff=None, device="cpu"):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    k1, k2 = jr.split(key)
    return {
        "ln2": torch.ones((d,), dtype=dtype, device=device),
        "w_in": init_dense(k1, (d, 2 * ff), dtype, device=device),
        "w_out": init_dense(k2, (ff, d), dtype, device=device,
                            scale=0.5 / (d ** 0.5 * cfg.n_layers ** 0.5)),
    }


def mlp(params, cfg, x):
    xn = rms_norm(x, params["ln2"], cfg.norm_eps)
    h = swiglu(dense(xn, weight(params, "w_in"),
                     lora_pair(params, "w_in", cfg.lora)))
    return x + dense(h, weight(params, "w_out"),
                     lora_pair(params, "w_out", cfg.lora))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_params(key, cfg, dtype, device="cpu"):
    """Expert, router (float32 always) and shared-expert weights under
    the JAX package's ``split(key, 5)``."""
    m, d = cfg.moe, cfg.d_model
    ks = jr.split(key, 5)
    out_scale = 0.5 / (d ** 0.5 * cfg.n_layers ** 0.5)
    p = {
        "ln2": torch.ones((d,), dtype=dtype, device=device),
        "router": init_dense(ks[0], (d, m.n_experts), torch.float32,
                             device=device),
        "w_in": init_dense(ks[1], (m.n_experts, d, 2 * m.d_ff), dtype,
                           device=device),
        "w_out": init_dense(ks[2], (m.n_experts, m.d_ff, d), dtype,
                            device=device, scale=out_scale),
    }
    if m.n_shared_experts:
        sff = m.d_ff * m.n_shared_experts
        p["shared_w_in"] = init_dense(ks[3], (d, 2 * sff), dtype,
                                      device=device)
        p["shared_w_out"] = init_dense(ks[4], (sff, d), dtype, device=device,
                                       scale=out_scale)
    return p


_ESPEC = shd.P("model", None, None)
_BA = ("pod", "data")


def capacity(n_tokens: int, m) -> int:
    """Slots an expert's buffer holds for ``n_tokens`` tokens: ``top_k ·
    T · capacity_factor / E`` rounded up, then up to a multiple of 8, at
    least 8 (the JAX package's ``_capacity``)."""
    c = int(math.ceil(m.top_k * n_tokens * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One client's routing of ``T`` tokens: ``probs`` ``(T, E)``
    float32; ``gates`` and ``experts`` ``(T, k)`` (float32, int64);
    ``pos`` ``(T·k,)`` each choice's rank in its expert; ``keep`` ``(T·k,)``
    bool, ``pos < capacity``."""
    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def router_logits(params, xn: torch.Tensor) -> torch.Tensor:
    """``(T, d)`` normed tokens → ``(T, E)`` float32 logits, the product
    taken in float32."""
    return xn.float() @ params["router"].float()


def rank_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each flat choice's position among the earlier choices of its
    expert: a stable argsort, then each expert's first slot by a left
    ``searchsorted`` (equal to the one-hot cumsum, minus one)."""
    # routing metadata is tiny: replicated, as JAX constrains it
    flat_e = shd.constrain(flat_e, shd.P(None))
    order = shd.constrain(torch.argsort(flat_e, stable=True), shd.P(None))
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat_e.device))
    pos_sorted = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[sorted_e]
    return torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)


def route(logits: torch.Tensor, m) -> Routing:
    """Top-k routing of ``(T, E)`` float32 logits (see the module
    docstring)."""
    T = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    pos = rank_in_expert(experts.reshape(-1), m.n_experts)
    C = capacity(T, m)
    return Routing(probs, gates, experts, pos, pos < C, C)


def balance_loss(r: Routing, n_experts: int) -> torch.Tensor:
    """Switch-style load balance: ``E · Σ_e density_e · mean prob_e``,
    density the share of tokens whose first choice is ``e``."""
    # exact integer counts of first choices, as JAX's one-hot mean
    first = torch.nn.functional.one_hot(r.experts[:, 0], n_experts)
    density = first.sum(0).float() / r.experts.shape[0]
    return n_experts * torch.sum(density * r.probs.mean(dim=0))


def _experts(params, m, xn: torch.Tensor, r: Routing) -> torch.Tensor:
    """One client's routed experts: dispatch ``xn`` ``(T, d)`` into
    ``(E, C_e, d)`` buffers, the experts' SwiGLU, and the gated combine
    ``(T, d)`` in the output dtype."""
    T, d = xn.shape
    E, k, C = m.n_experts, m.top_k, r.capacity
    flat_e = r.experts.reshape(-1)
    slot = flat_e * C + torch.where(r.keep, r.pos, C - 1)
    # kept choices to their (expert, slot); dropped ones to the spare row
    dest = torch.where(r.keep, slot, E * C)
    tok = torch.arange(T, device=xn.device).repeat_interleave(k)
    buf = torch.zeros((E * C + 1, d), dtype=xn.dtype, device=xn.device)
    buf = buf.index_copy(0, dest, xn[tok])[:E * C].view(E, C, d)
    # expert parallel on a mesh: the buffers' E axis on 'model', as JAX's
    buf = shd.constrain(buf, _ESPEC)
    h = swiglu(shd.constrain(matmul(buf, weight(params, "w_in")), _ESPEC))
    out = shd.constrain(matmul(h, weight(params, "w_out")),
                        _ESPEC).reshape(E * C, d)
    y_k = out[slot] * r.keep[:, None].to(out.dtype)
    y_k = y_k.view(T, k, d) * r.gates[..., None].to(out.dtype)
    return y_k.sum(dim=1)


def moe(params, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(C, B, S, d)`` → ``(x + update, balance)``, balance ``(C,)``
    float32, each client routed alone (``route``)."""
    y, balance = moe_update(params, cfg, x)
    return x + y.to(x.dtype), balance


def moe_update(params, cfg, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's update ``(C, B, S, d)`` before the residual add (the
    routed experts' gated sum plus the shared expert, in the output
    dtype), and the balance loss: ``moe`` without its last add."""
    m = cfg.moe
    C, B, S, d = x.shape
    T = B * S
    # on a mesh the tokens (B, S) fold into T over the batch axes only
    x = shd.constrain(x, shd.P(None, _BA, None, None))
    xn = rms_norm(x, params["ln2"], cfg.norm_eps).reshape(C, T, d)
    ys, balances = [], []
    for c in range(C):
        r = route(router_logits(params, xn[c]), m)
        balances.append(balance_loss(r, m.n_experts))
        ys.append(_experts(params, m, xn[c], r))
    y = torch.stack(ys)
    if m.n_shared_experts:
        sh = swiglu(dense(xn, weight(params, "shared_w_in"),
                          lora_pair(params, "shared_w_in", cfg.lora)))
        y = y + dense(sh, weight(params, "shared_w_out"),
                      lora_pair(params, "shared_w_out", cfg.lora))
    return y.reshape(C, B, S, d), torch.stack(balances)
