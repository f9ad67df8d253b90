"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro/models/xlstm.py``: ``_group_norm``, the mLSTM
(``mlstm_params``, ``_mlstm_qkvif``, ``_mlstm_out``, the sequential
``mlstm_train``, the chunkwise-parallel ``mlstm_train_chunkwise`` and
``mlstm_decode``) and the sLSTM (``slstm_params``, ``_slstm_step``,
``_slstm_gx``, ``slstm_train``, ``slstm_decode``), in the stabilised
exponential-gating form of arXiv:2405.04517.  Activations are ``(C, B,
S, d)``; projections run per client through ``common.dense`` (the mLSTM
``wq`` is a LoRA target of xlstm-125m, so it is one ``lora_matmul``
launch), and the recurrences fold the client and batch axes into one
sequence axis ``N = C·B``.

States, all float32: the mLSTM's ``C`` ``(N, H, D, D)``, ``n`` ``(N, H,
D)``, ``m`` ``(N, H)`` (``D = expand·d / H``), plus in decode its
convolution's last inputs ``(N, conv_width - 1, ed)`` in the cache's
dtype; the sLSTM's ``(c, n, h, m)``, each ``(N, d)``.  As in the JAX
package, the mLSTM prefill cache is ``(C, n, m)`` with no convolution
state, so it cannot seed the serve step.  The two mLSTM training forms
compute one function but may carry different stabilisers ``m``; compare
``C·e^m`` and ``n·e^m``.  The sequential scans are Python loops over
positions, about twenty small ops a position; the chunkwise form (JAX's
``FwdOptions.mlstm_chunkwise``) takes chunks of 64.

JAX's rounding points are kept: the mLSTM train path applies SiLU to the
convolution's output after its cast to the activation dtype, decode in
float32 before it.  ``_group_norm`` takes the population variance.
``jax.nn.log_sigmoid`` is ``-softplus(-x)``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.distributed import parallel
from repro_torch.models.common import dense, init_dense, lora_pair, rms_norm
from repro_torch.models.ssm import _causal_conv, softplus


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, heads: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the head feature dim.  x ``(..., ed)``;
    the variance is the population one, ``mean((x - mean)²)``."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], heads, shp[-1] // heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = torch.square(xh - mu).mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_params(key, cfg, dtype, device="cpu"):
    """JAX's ``split(key, 7)``; ``w_if`` and ``b_if`` float32."""
    xc, d, H = cfg.xlstm, cfg.d_model, cfg.n_heads
    ed = xc.expand * d
    ks = jr.split(key, 7)
    return {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "up_proj": init_dense(ks[0], (d, 2 * ed), dtype, device=device),
        "conv_w": init_dense(ks[1], (xc.conv_width, ed), dtype, scale=0.5,
                             device=device),
        "conv_b": torch.zeros((ed,), dtype=dtype, device=device),
        "wq": init_dense(ks[2], (ed, ed), dtype, device=device),
        "wk": init_dense(ks[3], (ed, ed), dtype, device=device),
        "wv": init_dense(ks[4], (ed, ed), dtype, device=device),
        "w_if": init_dense(ks[5], (ed, 2 * H), torch.float32, device=device),
        "b_if": torch.cat([torch.zeros(H), 3.0 * torch.ones(H)]).to(device),
        "gn": torch.ones((ed,), dtype=dtype, device=device),
        "down_proj": init_dense(ks[6], (ed, d), dtype, device=device,
                                scale=0.5 / (d ** 0.5 * cfg.n_layers ** 0.5)),
    }


def _qkvif(params, cfg, x_in, x_c):
    """q, k (scaled by D^-1/2), v ``(N, S, H, D)`` float32 and the log
    input and forget gates ``(N, S, H)`` from the convolved ``x_c`` and
    the unconvolved ``x_in``, both ``(C, B, S, ed)``."""
    H = cfg.n_heads
    C, B, S, ed = x_c.shape
    D = ed // H
    q = dense(x_c, params["wq"], lora_pair(params, "wq", cfg.lora))
    k = dense(x_c, params["wk"], lora_pair(params, "wk", cfg.lora))
    v = dense(x_in, params["wv"], lora_pair(params, "wv", cfg.lora))
    q = q.reshape(C * B, S, H, D).float()
    k = k.reshape(C * B, S, H, D).float() * (D ** -0.5)
    v = v.reshape(C * B, S, H, D).float()
    gif = x_c.reshape(C * B, S, ed).float() @ params["w_if"] + params["b_if"]
    return q, k, v, gif[..., :H], log_sigmoid(gif[..., H:])


def _mlstm_qkvif(params, cfg, x):
    """x ``(C, B, S, d)`` → (z, q, k, v, li, lf), as JAX's."""
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    xu = dense(xn, params["up_proj"], lora_pair(params, "up_proj", cfg.lora))
    x_in, z = xu.chunk(2, dim=-1)
    C, B, S, ed = x_in.shape
    x_c = F.silu(_causal_conv(x_in.reshape(C * B, S, ed), params["conv_w"],
                              params["conv_b"])).reshape(C, B, S, ed)
    return (z,) + _qkvif(params, cfg, x_in, x_c)


def _mlstm_out(params, cfg, x, h, z):
    """h ``(N, S, H, D)`` float32 → ``x + down_proj(gn(h)·silu(z))``."""
    C, B, S, _ = x.shape
    ed = h.shape[-1] * cfg.n_heads
    hflat = _group_norm(h.reshape(C, B, S, ed).to(x.dtype), params["gn"],
                        cfg.n_heads)
    y = hflat * F.silu(z)
    return x + dense(y, params["down_proj"],
                     lora_pair(params, "down_proj", cfg.lora))


def _mlstm_cell(C, n, m, qt, kt, vt, li, lf):
    """One stabilised mLSTM update and its readout: states ``C (N,H,D,D)``,
    ``n (N,H,D)``, ``m (N,H)``; inputs ``(N,H,D)`` and gates ``(N,H)``."""
    lfm = lf + m
    m_new = torch.maximum(lfm, li)
    fp = torch.exp(lfm - m_new)[..., None]
    ip = torch.exp(li - m_new)[..., None]
    C = fp[..., None] * C + ip[..., None] * (kt[..., :, None]
                                             * vt[..., None, :])
    n = fp * n + ip * kt
    num = torch.einsum("bhdk,bhd->bhk", C, qt)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qt)),
                        torch.exp(-m_new))[..., None]
    return C, n, m_new, num / den


def _zero_state(q):
    N, _, H, D = q.shape
    return (torch.zeros((N, H, D, D), dtype=torch.float32, device=q.device),
            torch.zeros((N, H, D), dtype=torch.float32, device=q.device),
            torch.zeros((N, H), dtype=torch.float32, device=q.device))


def mlstm_train(params, cfg, x) -> Tuple[torch.Tensor, Tuple]:
    """Sequential-scan mLSTM (the paper's form).  x ``(C, B, S, d)`` →
    ``(y, (C, n, m))``."""
    z, q, k, v, li, lf = _mlstm_qkvif(params, cfg, x)
    h, state = parallel.per_sequence(_mlstm_scan, 3, q, k, v, li, lf)
    return _mlstm_out(params, cfg, x, h, z), state


def _mlstm_scan(q, k, v, li, lf):
    """The sequential mLSTM over ``(N, S, …)`` inputs: ``(h (N, S, H, D),
    (C, n, m))``."""
    Cs, n, m = _zero_state(q)
    hs = []
    # one unbind a tensor, not a slice a position: fewer ops for the host
    # to dispatch, and one stack in the backward
    for qt, kt, vt, it, ft in zip(*(t.unbind(1) for t in (q, k, v, li, lf))):
        Cs, n, m, h = _mlstm_cell(Cs, n, m, qt, kt, vt, it, ft)
        hs.append(h)
    return torch.stack(hs, dim=1), (Cs, n, m)


def mlstm_train_chunkwise(params, cfg, x, *, chunk: int = 64
                          ) -> Tuple[torch.Tensor, Tuple]:
    """Chunkwise-parallel mLSTM: attention-style products inside a chunk,
    the state carried from chunk to chunk (JAX's
    ``mlstm_train_chunkwise``, op for op)."""
    z, q, k, v, li, lf = _mlstm_qkvif(params, cfg, x)
    q, k, v, li, lf = parallel.whole_sequence(q, k, v, li, lf)
    N, S, H, D = q.shape
    cs = min(chunk, S)
    assert S % cs == 0
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=x.device))
    Cs, n, m = _zero_state(q)
    hs = []
    for i in range(0, S, cs):
        qc, kc, vc = (t[:, i:i + cs].transpose(1, 2) for t in (q, k, v))
        lic, lfc = (t[:, i:i + cs].transpose(1, 2) for t in (li, lf))
        F_ = torch.cumsum(lfc, dim=-1)                       # (N,H,cs)
        bmat = F_[..., :, None] - F_[..., None, :] + lic[..., None, :]
        bmat = torch.where(tri, bmat, -torch.inf)
        a = F_ + m[..., None]
        m_t = torch.maximum(bmat.max(-1).values, a)
        intra = torch.exp(bmat - m_t[..., None])
        inter = torch.exp(a - m_t)
        scores = torch.einsum("bhtd,bhsd->bhts", qc, kc) * intra
        num = (torch.einsum("bhts,bhsd->bhtd", scores, vc)
               + inter[..., None] * torch.einsum("bhtd,bhdk->bhtk", qc, Cs))
        den_vec = (scores.sum(-1)
                   + inter * torch.einsum("bhtd,bhd->bht", qc, n))
        den = torch.maximum(torch.abs(den_vec), torch.exp(-m_t))[..., None]
        hs.append((num / den).transpose(1, 2))               # (N,cs,H,D)
        F_last = F_[..., -1:]
        m_new = torch.maximum(F_last[..., 0] + m,
                              (F_last - F_ + lic).max(-1).values)
        w_in = torch.exp(F_last - F_ + lic - m_new[..., None])
        decay = torch.exp(F_last[..., 0] + m - m_new)
        Cs = (decay[..., None, None] * Cs
              + torch.einsum("bhs,bhsd,bhsk->bhdk", w_in, kc, vc))
        n = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", w_in, kc)
        m = m_new
    return _mlstm_out(params, cfg, x, torch.cat(hs, dim=1), z), (Cs, n, m)


def mlstm_decode(params, cfg, x, state) -> Tuple[torch.Tensor, Tuple]:
    """x ``(C, B, 1, d)``; state ``(C (N,H,D,D), n (N,H,D), m (N,H), conv
    (N, w-1, ed))``, written in place (the conv state keeps its own
    dtype) and returned."""
    Cs, n, m, conv_state = state
    C, B = x.shape[:2]
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    xu = dense(xn, params["up_proj"], lora_pair(params, "up_proj", cfg.lora))
    x_in, z = xu.chunk(2, dim=-1)
    window = torch.cat([conv_state.to(x_in.dtype),
                        x_in.reshape(C * B, 1, -1)], dim=1)
    conv = torch.einsum("bwe,we->be", window.float(),
                        params["conv_w"].float())
    x_c = F.silu(conv + params["conv_b"].float()).to(x.dtype)
    q, k, v, li, lf = _qkvif(params, cfg, x_in, x_c.reshape(C, B, 1, -1))
    C2, n2, m2, h = _mlstm_cell(Cs, n, m, q[:, 0], k[:, 0], v[:, 0],
                                li[:, 0], lf[:, 0])
    y = _mlstm_out(params, cfg, x, h[:, None], z)
    Cs.copy_(C2)
    n.copy_(n2)
    m.copy_(m2)
    conv_state.copy_(window[:, 1:])
    return y, (Cs, n, m, conv_state)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_params(key, cfg, dtype, device="cpu"):
    """JAX's ``split(key, 2)``; ``r_gates`` and ``b_gates`` float32, the
    forget gate's bias +3."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    ks = jr.split(key, 2)
    b = torch.zeros(4 * d, dtype=torch.float32, device=device)
    b[d:2 * d] = 3.0
    return {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "w_gates": init_dense(ks[0], (d, 4 * d), dtype, device=device),
        "r_gates": init_dense(ks[1], (H, hd, 4 * hd), torch.float32,
                              scale=0.5, device=device),
        "b_gates": b,
        "gn": torch.ones((d,), dtype=dtype, device=device),
    }


def _slstm_step(params, cfg, gx_t, carry):
    """One sLSTM cell step.  gx_t ``(N, 4d)`` float32 input-side gate
    pre-activations; carry ``(c, n, h, m)``, each ``(N, d)``."""
    H = cfg.n_heads
    c, n, h, m = carry
    N, d = c.shape
    hd = d // H
    gh = torch.einsum("bhk,hko->bho", h.reshape(N, H, hd),
                      params["r_gates"])                      # (N,H,4hd)
    # per-head [i|f|z|o] blocks to gx's full-d [i|f|z|o] layout
    gh = gh.reshape(N, H, 4, hd).transpose(1, 2).reshape(N, 4 * d)
    gi, gf, gz, go = (gx_t + gh).chunk(4, dim=-1)
    lfm = log_sigmoid(gf) + m
    m_new = torch.maximum(lfm, gi)
    ip = torch.exp(gi - m_new)
    fp = torch.exp(lfm - m_new)
    c_new = fp * c + ip * torch.tanh(gz)
    n_new = fp * n + ip
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_gx(params, cfg, x):
    """x ``(C, B, S, d)`` → gate pre-activations ``(N, S, 4d)`` float32."""
    C, B, S, d = x.shape
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    gx = dense(xn, params["w_gates"], lora_pair(params, "w_gates", cfg.lora))
    return gx.reshape(C * B, S, 4 * d).float() + params["b_gates"]


def slstm_train(params, cfg, x) -> Tuple[torch.Tensor, Tuple]:
    """x ``(C, B, S, d)`` → ``(x + gn(h), (c, n, h, m))``."""
    C, B, S, d = x.shape
    def scan(gx, r_gates):
        z0 = torch.zeros(gx.shape[:1] + (d,), dtype=torch.float32,
                         device=gx.device)
        carry, hs = (z0, z0, z0, z0), []
        for gx_t in gx.unbind(1):
            carry = _slstm_step({"r_gates": r_gates}, cfg, gx_t, carry)
            hs.append(carry[2])
        return torch.stack(hs, dim=1), carry

    h, carry = parallel.per_sequence(scan, 4, _slstm_gx(params, cfg, x),
                                     whole=(params["r_gates"],))
    h = h.reshape(C, B, S, d)
    return x + _group_norm(h.to(x.dtype), params["gn"], cfg.n_heads), carry


def slstm_decode(params, cfg, x, state) -> Tuple[torch.Tensor, Tuple]:
    """x ``(C, B, 1, d)``; state ``(c, n, h, m)``, each ``(N, d)``
    float32, written in place and returned."""
    C, B, _, d = x.shape
    gx = _slstm_gx(params, cfg, x)
    new = _slstm_step(params, cfg, gx[:, 0], state)
    y = _group_norm(new[2].reshape(C, B, 1, d).to(x.dtype), params["gn"],
                    cfg.n_heads)
    for s, t in zip(state, new):
        s.copy_(t)
    return x + y, tuple(state)
