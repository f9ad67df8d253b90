"""Feed-forward block: the dense SwiGLU MLP.

The port of ``repro/models/ffn.py``'s ``mlp_params`` and ``mlp``; the
mixture-of-experts block comes with the ROADMAP item "the other model
families".
"""
from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.models.common import (dense, init_dense, lora_pair,
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
