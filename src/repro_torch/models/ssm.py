"""Mamba (S6 selective scan) mixer: jamba's recurrent component.

The port of ``repro/models/ssm.py``: ``mamba_params``, ``_causal_conv``,
``_ssm_inputs``, ``mamba_train`` (prefill and training) and
``mamba_decode`` (one token).  Activations are ``(C, B, S, d)``; the
projections run per client through ``common.dense`` (``in_proj`` and
``out_proj`` are no LoRA target of the assigned configs, so they are
plain products), while the scan folds the client and batch axes into
one sequence axis ``N = C·B``, as the attention mixers do.  The state
is ``h`` ``(N, ed, d_state)`` float32 and the convolution's last
``d_conv - 1`` inputs ``(N, d_conv - 1, ed)`` in the activation dtype.

Training and prefill run JAX's chunked selective scan: chunks of
``SEQ_CHUNK`` positions, the state carried from chunk to chunk, and
inside a chunk the first-order recurrence ``h_t = a_t·h_{t-1} + b_t``
taken by ``associative_scan``, the odd/even recursion of
``jax.lax.associative_scan`` written out in torch (about ``log2(chunk)``
levels of whole-chunk products, not a loop over positions), so the
float32 products round as JAX's do.  Decode is one recurrent update.

The causal depthwise convolution is the sum of ``d_conv`` shifted
products in float32, in the order of the decode path's window sum, with
no library convolution (whose algorithm, TF32 on the card, the port does
not choose).  JAX's rounding points are kept: the train path applies
SiLU to the convolution's output after it is cast to the activation
dtype, the decode path in float32 before the cast, so a bfloat16
prefill and decode differ by design.  ``jax.nn.softplus`` is
``logaddexp(x, 0)`` (``F.softplus`` switches to ``x`` above 20).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.distributed import parallel
from repro_torch.models.common import dense, init_dense, lora_pair, rms_norm

SEQ_CHUNK = 128


def _dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` for every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _dt_init(key, ed: int, device) -> torch.Tensor:
    """``log(expm1(exp(u·(log 0.1 − log 0.001) + log 0.001)))`` of a
    float32 uniform ``u``, each op rounded to float32 once (the affine map
    one fused multiply-add, as XLA contracts it)."""
    f32 = np.float32
    lo, hi = f32(np.log(f32(0.001))), f32(np.log(f32(0.1)))
    u = jr.uniform(key, (ed,))
    t = jr._fma_f32(u, f32(hi - lo), lo)
    t = np.exp(t.astype(np.float64)).astype(f32)
    t = np.expm1(t.astype(np.float64)).astype(f32)
    t = np.log(t.astype(np.float64)).astype(f32)
    return torch.from_numpy(t).to(device)


def mamba_params(key, cfg, dtype, device="cpu"):
    """The layer's weights under JAX's ``split(key, 6)``: ``dt_b``,
    ``A_log`` and ``D`` float32 whatever ``dtype``; ``A_log`` through the
    emulation of XLA's float32 ``log`` (``random._log``), so it is
    bitwise JAX's."""
    mc, d = cfg.mamba, cfg.d_model
    ed = mc.expand * d
    ks = jr.split(key, 6)
    A = torch.arange(1, mc.d_state + 1, dtype=torch.float32)
    return {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "in_proj": init_dense(ks[0], (d, 2 * ed), dtype, device=device),
        "conv_w": init_dense(ks[1], (mc.d_conv, ed), dtype, scale=0.5,
                             device=device),
        "conv_b": torch.zeros((ed,), dtype=dtype, device=device),
        "x_proj": init_dense(ks[2], (ed, _dt_rank(cfg) + 2 * mc.d_state),
                             dtype, device=device),
        "dt_w": init_dense(ks[3], (_dt_rank(cfg), ed), dtype, device=device),
        "dt_b": _dt_init(ks[5], ed, device),
        "A_log": jr._log(A).expand(ed, mc.d_state).contiguous().to(device),
        "D": torch.ones((ed,), dtype=torch.float32, device=device),
        "out_proj": init_dense(ks[4], (ed, d), dtype, device=device,
                               scale=0.5 / (d ** 0.5 * cfg.n_layers ** 0.5)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv.  x ``(N, S, ed)``; w ``(width, ed)``:
    ``out[t] = b + Σ_k x[t - width + 1 + k]·w[k]`` in float32 (zeros
    before the start), cast to x's dtype."""
    width, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for k in range(1, width):
        out = out + xp[:, k:k + S] * wf[k]
    return (out + b.float()).to(x.dtype)


def _ssm_inputs(params, cfg, x_c: torch.Tensor):
    """x_c ``(C, B, S, ed)`` → dt ``(C, B, S, ed)``, B and C ``(C, B, S,
    N)``, all float32, and A ``(ed, N)`` float32."""
    mc, r = cfg.mamba, _dt_rank(cfg)
    xdbc = dense(x_c, params["x_proj"]).float()
    dt_in, Bm, Cm = torch.split(xdbc, [r, mc.d_state, mc.d_state], dim=-1)
    dt = softplus(dt_in @ params["dt_w"].float() + params["dt_b"])
    return dt, Bm, Cm, -torch.exp(params["A_log"])


def _combine(e1, e2):
    """The recurrence's operator, ``e1`` the earlier element."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """Inclusive scan of ``(a, b)`` along ``dim`` under ``_combine``: the
    odd/even recursion of ``jax.lax.associative_scan``, op for op."""
    n = a.shape[dim]
    if n < 2:
        return a, b

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = _combine((sl(a, 0, -1, 2), sl(b, 0, -1, 2)),
                       (sl(a, 1, None, 2), sl(b, 1, None, 2)))
    odd = associative_scan(*reduced, dim=dim)
    later = (sl(a, 2, None, 2), sl(b, 2, None, 2))
    if n % 2 == 0:
        even = _combine((sl(odd[0], 0, -1), sl(odd[1], 0, -1)), later)
    else:
        even = _combine(odd, later)
    out = []
    for first, ev, od in zip((a, b), even, odd):
        ev = torch.cat([sl(first, 0, 1), ev], dim=dim)
        t = torch.empty_like(first)
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(0, None, 2)
        t[tuple(idx)] = ev
        idx[dim] = slice(1, None, 2)
        t[tuple(idx)] = od
        out.append(t)
    return out[0], out[1]


def mamba_train(params, cfg, x: torch.Tensor, *, seq_chunk: int = SEQ_CHUNK
                ) -> Tuple[torch.Tensor, Tuple]:
    """x ``(C, B, S, d)`` → ``(x + out, (h_last (N, ed, d_state) f32,
    conv_state (N, d_conv - 1, ed)))``, the state prefill hands to the
    decode path."""
    mc = cfg.mamba
    C, B, S, d = x.shape
    ed = mc.expand * d
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    xu = dense(xn, params["in_proj"], lora_pair(params, "in_proj", cfg.lora))
    x_in, z = xu.chunk(2, dim=-1)
    x_c = F.silu(_causal_conv(x_in.reshape(C * B, S, ed), params["conv_w"],
                              params["conv_b"])).reshape(C, B, S, ed)
    dt, Bm, Cm, A = _ssm_inputs(params, cfg, x_c)
    dt, Bm, Cm = (t.reshape(C * B, S, -1) for t in (dt, Bm, Cm))
    xf = x_c.reshape(C * B, S, ed).float()
    dt, Bm, Cm, xf = parallel.whole_sequence(dt, Bm, Cm, xf)

    cs = min(seq_chunk, S)
    assert S % cs == 0
    h = torch.zeros((C * B, ed, mc.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for i in range(0, S, cs):
        dt_c, B_c, C_c, x_cc = (t[:, i:i + cs] for t in (dt, Bm, Cm, xf))
        da = torch.exp(dt_c[..., None] * A)                  # (N,cs,ed,N_s)
        db = (dt_c * x_cc)[..., None] * B_c[:, :, None, :]
        a_cum, b_cum = associative_scan(da, db, dim=1)
        del da, db
        h_t = a_cum * h[:, None] + b_cum
        del a_cum, b_cum
        y_c = torch.einsum("bsen,bsn->bse", h_t, C_c)
        ys.append(y_c + params["D"] * x_cc)
        h = h_t[:, -1].contiguous()
        del h_t
    y = torch.cat(ys, dim=1).reshape(C, B, S, ed)
    y = y.to(x.dtype) * F.silu(z)
    out = dense(y, params["out_proj"], lora_pair(params, "out_proj", cfg.lora))
    conv_state = x_in.reshape(C * B, S, ed)[:, S - (mc.d_conv - 1):]
    return x + out, (h, conv_state.contiguous())


def mamba_decode(params, cfg, x: torch.Tensor, ssm_state: torch.Tensor,
                 conv_state: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
    """One-token recurrent step.  x ``(C, B, 1, d)``; ``ssm_state`` ``(N,
    ed, d_state)`` float32 and ``conv_state`` ``(N, d_conv - 1, ed)``,
    both written in place (the conv state keeps its own dtype) and
    returned."""
    C, B = x.shape[:2]
    xn = rms_norm(x, params["ln"], cfg.norm_eps)
    xu = dense(xn, params["in_proj"], lora_pair(params, "in_proj", cfg.lora))
    x_in, z = xu.chunk(2, dim=-1)                              # (C,B,1,ed)
    window = torch.cat([conv_state.to(x_in.dtype),
                        x_in.reshape(C * B, 1, -1)], dim=1)   # (N,w,ed)
    conv = torch.einsum("bwe,we->be", window.float(),
                        params["conv_w"].float())
    x_c = F.silu(conv + params["conv_b"].float()).to(x.dtype)  # (N,ed)
    dt, Bm, Cm, A = _ssm_inputs(params, cfg, x_c.reshape(C, B, 1, -1))
    dt, Bm, Cm = (t.reshape(C * B, -1) for t in (dt, Bm, Cm))
    da = torch.exp(dt[..., None] * A)                          # (N,ed,N_s)
    db = (dt * x_c.float())[..., None] * Bm[:, None, :]
    h = da * ssm_state + db
    y = torch.einsum("ben,bn->be", h, Cm) + params["D"] * x_c.float()
    y = y.reshape(C, B, 1, -1).to(x.dtype) * F.silu(z)
    out = dense(y, params["out_proj"], lora_pair(params, "out_proj", cfg.lora))
    ssm_state.copy_(h)
    conv_state.copy_(window[:, 1:])
    return x + out, (ssm_state, conv_state)
