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
ride ``'model'`` on their E axis, as JAX's constraints lay them; the
token rows stay on the batch axes: each device dispatches its own rows
into its own experts' buffers, the devices' shares are summed over the
batch axes, and each device combines its own rows from its own experts
(``distributed/parallel.py``, ``moe_dispatch`` / ``moe_combine``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch import random as jr
from repro_torch.distributed import parallel
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


def _router_local(x, w, *_):
    return x.float() @ w.float()


def router_logits(params, xn: torch.Tensor) -> torch.Tensor:
    """``(T, d)`` normed tokens → ``(T, E)`` float32 logits, the product
    taken in float32.  On a mesh it runs on each device's token rows with
    the router gathered (``parallel.dense``), so the tokens' gradient
    keeps their layout: DTensor's own product rule returned it with T
    split over both 'data' and 'model', which the backward of the
    block's ``(C, B, S, d) → (C, T, d)`` fold could not unfold."""
    if shd.is_dtensor(xn):
        return parallel.dense(_router_local, xn[None], params["router"],
                              None, None, None, None)[0]
    return _router_local(xn, params["router"])


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


def dispatch_rows(xn: torch.Tensor, row0: int, flat_e: torch.Tensor,
                  pos: torch.Tensor, keep: torch.Tensor, top_k: int,
                  capacity: int, e0: int, e1: int) -> torch.Tensor:
    """One device's share of the dispatch: rows ``[row0, row0 + T_l)`` of
    a client's normed tokens ``xn`` ``(T_l, d)`` copied to their (expert,
    slot) places in the buffers of experts ``[e0, e1)``: ``(e1 - e0,
    C_e, d)``, zero where no kept choice of these rows lands.  The
    routing (``flat_e``, ``pos``, ``keep``, ``(T·k,)``) is the whole
    client's.  Every kept slot is written by one row only, so the
    devices' shares sum to the whole dispatch exactly; with every row and
    expert (``row0 = 0``, ``[0, E)``) it is the whole dispatch."""
    T_l, d = xn.shape
    E_l, C = e1 - e0, capacity
    sel = slice(row0 * top_k, (row0 + T_l) * top_k)
    fe, ps, kp = flat_e[sel], pos[sel], keep[sel]
    mine = kp & (fe >= e0) & (fe < e1)
    # kept choices to their (expert, slot); the others to a spare row
    dest = torch.where(mine, (fe - e0) * C + ps, E_l * C)
    tok = torch.arange(T_l, device=xn.device).repeat_interleave(top_k)
    buf = torch.zeros((E_l * C + 1, d), dtype=xn.dtype, device=xn.device)
    return buf.index_copy(0, dest, xn[tok])[:E_l * C].view(E_l, C, d)


def combine_rows(out: torch.Tensor, row0: int, flat_e: torch.Tensor,
                 pos: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor,
                 capacity: int, e0: int, e1: int) -> torch.Tensor:
    """One device's share of the combine: for rows ``[row0, row0 + T_l)``
    (their gates ``(T_l, k)``), the gated sum over their kept choices
    that went to experts ``[e0, e1)`` of those experts' outputs ``out``
    ``(e1 - e0, C_e, d)``: ``(T_l, d)`` in ``out``'s dtype.  With every
    row and expert it is the whole combine."""
    T_l, k = gates.shape
    E_l, C, d = out.shape
    sel = slice(row0 * k, (row0 + T_l) * k)
    fe, ps, kp = flat_e[sel], pos[sel], keep[sel]
    here = (fe >= e0) & (fe < e1)
    slot = torch.where(here, (fe - e0) * C + torch.where(kp, ps, C - 1), 0)
    y_k = out.reshape(E_l * C, d)[slot] * (kp & here)[:, None].to(out.dtype)
    y_k = y_k.view(T_l, k, d) * gates[..., None].to(out.dtype)
    return y_k.sum(dim=1)


def _experts(params, m, xn: torch.Tensor, r: Routing) -> torch.Tensor:
    """One client's routed experts: dispatch ``xn`` ``(T, d)`` into
    ``(E, C_e, d)`` buffers, the experts' SwiGLU, and the gated combine
    ``(T, d)`` in the output dtype.  On a mesh the dispatch and the
    combine run on each device's token rows and experts
    (``parallel.moe_dispatch`` / ``moe_combine``)."""
    E, k, C = m.n_experts, m.top_k, r.capacity
    flat_e = r.experts.reshape(-1)
    if shd.is_dtensor(xn):
        # the routing metadata replicated, as JAX constrains it
        flat_e = shd.constrain(flat_e, shd.P(None))
        buf = parallel.moe_dispatch(dispatch_rows, xn, flat_e, r.pos,
                                    r.keep, top_k=k, n_experts=E,
                                    capacity=C)
    else:
        buf = dispatch_rows(xn, 0, flat_e, r.pos, r.keep, k, C, 0, E)
    # expert parallel on a mesh: the buffers' E axis on 'model', as JAX's
    h = swiglu(shd.constrain(matmul(buf, weight(params, "w_in")), _ESPEC))
    out = shd.constrain(matmul(h, weight(params, "w_out")), _ESPEC)
    if shd.is_dtensor(out):
        return parallel.moe_combine(combine_rows, out, flat_e, r.pos,
                                    r.keep, r.gates, capacity=C)
    return combine_rows(out, 0, flat_e, r.pos, r.keep, r.gates, C, 0, E)


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
