"""LoRA / QLoRA adapters and the federated adapter algebra (paper §II-A,
Alg. 1).

The port of ``repro/peft/lora.py``'s ``init_layer_adapters``,
``merge_layer``, ``adapter_param_count``, ``weighted_average_stacked``,
``blend_adapters`` and its QLoRA int4 quantization.  Adapters attach to
the 2-D base weights named in ``cfg.lora.targets``: A ``(d_in, r)``
drawn normal / √d_in, B ``(r, d_out)`` zero, both float32.  A MoE
layer's expert stacks are 3-D and get none (its router and shared
expert are no targets); MLA's targets are its latent projections
(``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b``, ``wo`` in minicpm3-4b).

QLoRA: a target weight ``w`` whose width divides into blocks is stored
as ``w__q`` (packed int4, ``(d_in, d_out/2)`` uint8: the low nibble the
even column, the high nibble the odd one, each offset by 8) and
``w__s`` (blockwise absmax scales, ``(d_in, d_out/block)`` float32).
The bytes and scales are bitwise the JAX package's; the hand-written
``kernels.int4_matmul`` consumes them packed on the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.tree import tree_leaves, tree_map


def init_layer_adapters(key, cfg, layer_params: Dict) -> Dict:
    """Adapters for one layer's base weights, drawn on their device.  A
    QLoRA-packed weight ``w__q`` counts as ``w`` with twice its width, so
    the names, their order and the draws equal the unquantized base's."""
    names = [n for n, p in sorted(layer_params.items())
             if n in cfg.lora.targets and p.dim() == 2]
    packed = [n[:-3] for n in sorted(layer_params)
              if n.endswith("__q") and n[:-3] in cfg.lora.targets]
    names = sorted(set(names) | set(packed))
    out = {}
    if not names:
        return out
    keys = jr.split(key, len(names))
    r = cfg.lora.rank
    for k, n in zip(keys, names):
        if n in layer_params:
            d_in, d_out = layer_params[n].shape
            dev = layer_params[n].device
        else:                         # QLoRA-packed: out dim halved
            d_in, half = layer_params[f"{n}__q"].shape
            d_out = half * 2
            dev = layer_params[f"{n}__q"].device
        # true float32 division by the float32 √d_in, as XLA divides
        root = torch.tensor(float(np.sqrt(np.float32(d_in))),
                            dtype=torch.float32, device=dev)
        out[f"{n}_lora_a"] = jr.normal(k, (d_in, r), dev) / root
        out[f"{n}_lora_b"] = torch.zeros((r, d_out), dtype=torch.float32,
                                         device=dev)
    return out


def merge_layer(cfg, layer_params: Dict, adapters: Dict) -> Dict:
    """Fold one layer's adapters into its base weights (the inference
    deployment path): ``W + scale·A@B`` in float32, rounded once to the
    base weight's dtype."""
    merged = dict(layer_params)
    scale = cfg.lora.alpha / cfg.lora.rank
    for n, w in layer_params.items():
        a = adapters.get(f"{n}_lora_a")
        if a is None:
            continue
        b = adapters[f"{n}_lora_b"]
        merged[n] = (w.float() + scale * (a.float() @ b.float())).to(w.dtype)
    return merged


def adapter_param_count(adapters) -> int:
    return sum(int(x.numel()) for x in tree_leaves(adapters))


def weighted_average_stacked(stacked, weights: torch.Tensor):
    """FedAvg over a client-stacked adapter tree.

    ``stacked`` holds ``(C, …)`` leaves; ``weights`` is ``(C,)`` and is
    normalized here, so padding clients contribute nothing when their
    weight is 0.
    """
    w = weights.float()
    w = w / torch.sum(w)

    def leaf(x):
        return torch.sum(w.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
                         * x, dim=0)

    return tree_map(leaf, stacked)


def blend_adapters(adapters, a_g, rho: float):
    """Distill toward the global teacher: a ← (1−ρ)·a + ρ·a_g (a_g
    broadcasts along a leading client axis)."""
    return tree_map(lambda a, g: (1.0 - rho) * a + rho * g, adapters, a_g)


# ---------------------------------------------------------------------------
# QLoRA int4 blockwise quantization
# ---------------------------------------------------------------------------
QBLOCK = 64


def quantize(w: torch.Tensor, block: int = QBLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax int4.  w ``(in, out)`` → packed ``(in, out//2)``
    uint8 + scales ``(in, out//block)`` float32; values in [-7, 7],
    rounded half to even as ``jnp.round``."""
    d_in, d_out = w.shape
    assert d_out % block == 0 and block % 2 == 0
    wb = w.float().reshape(d_in, d_out // block, block)
    scales = torch.amax(torch.abs(wb), dim=-1, keepdim=True) / 7.0
    scales = torch.clamp(scales, min=1e-12)
    q = torch.clamp(torch.round(wb / scales), -7, 7).to(torch.int8)
    q = q.reshape(d_in, d_out)
    lo = (q[:, 0::2] + 8).to(torch.uint8)
    hi = (q[:, 1::2] + 8).to(torch.uint8)
    return lo | (hi << 4), scales[..., 0]


def dequantize(packed: torch.Tensor, scales: torch.Tensor,
               block: int = QBLOCK, dtype=torch.bfloat16) -> torch.Tensor:
    """The full-width weight ``(in, out)``: ``(nibble - 8) · scale`` in
    float32, then cast to ``dtype`` (round to nearest even for bf16)."""
    d_in, half = packed.shape
    d_out = half * 2
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(d_in, d_out).float()
    w = (q.reshape(d_in, d_out // block, block)
         * scales[..., None]).reshape(d_in, d_out)
    return w.to(dtype)


def quantize_layer_flat(layer: dict, targets, block: int = QBLOCK) -> dict:
    """QLoRA one layer's param dict: each 2-D target weight ``w`` whose
    width divides into blocks is replaced by ``w__q`` (packed int4) and
    ``w__s`` (scales); every other entry is kept as it is."""
    out = {}
    for k, v in layer.items():
        if k in targets and v.dim() == 2 and v.shape[1] % block == 0:
            out[f"{k}__q"], out[f"{k}__s"] = quantize(v, block)
        else:
            out[k] = v
    return out


def quantize_stacked_groups(params: dict, targets,
                            block: int = QBLOCK) -> dict:
    """``quantize_layer_flat`` over every layer of ``params["layers"]``
    and, for an encoder-decoder, ``params["enc_layers"]``: the JAX
    package vmaps the same per-layer function over its group stacks
    (``groups`` and ``enc_groups``), so the bytes are the same."""
    out = dict(params)
    for name in ("layers", "enc_layers"):
        if name in params:
            out[name] = [quantize_layer_flat(lyr, targets, block)
                         for lyr in params[name]]
    return out


def quantize_tree(params, targets, block: int = QBLOCK):
    """Quantize every 2-D leaf named in ``targets``; a quantized leaf
    becomes ``{"q": packed, "s": scales}`` in place of the weight."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if isinstance(v, (dict, tuple, list)):
                out[k] = quantize_tree(v, targets, block)
            elif k in targets and v.dim() == 2:
                q, s = quantize(v, block)
                out[k] = {"q": q, "s": s}
            else:
                out[k] = v
        return out
    if isinstance(params, (tuple, list)):
        return type(params)(quantize_tree(v, targets, block) for v in params)
    return params
