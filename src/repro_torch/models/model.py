"""Model assembly: init, forward, cross-entropy and the LoRA train step.

The port of ``repro/models/model.py`` for the fine-tuning stage:
``init_params``, ``init_adapters``, ``forward`` (no remat, no frontend),
``chunked_ce`` and ``make_train_step`` (one microbatch).

Layouts.  The base is ``{"embed", "final_norm", "lm_head" (untied
only), "layers": [layer dict, ...]}``: the JAX package's group-stacked
``params["groups"]`` unrolled into one dict per layer
(``convert.params_from_jax``).  Adapters are ``[layer dict, ...]`` of
``{name}_lora_a`` / ``{name}_lora_b``; in the batched engine every leaf
carries a leading client axis ``(C, …)``, while the base is shared and
never stacked.  A QLoRA base (``cfg.lora.quantize_base``) holds
``{name}__q``/``{name}__s`` in place of each adapted weight.
Activations are ``(C, B, S, d)``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import init_dense, rms_norm
from repro_torch.optim import adamw
from repro_torch.peft import lora as lora_mod
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg, key, dtype=None, device=None) -> Dict:
    """The frozen base, drawn on ``device`` under the JAX package's key
    tree (``split(key, 8)``; layer ``g·P + p`` from
    ``split(split(keys[3], P)[p], n_groups)[g]``).  ``device=None`` is
    the card, and raises without one (``device.resolve_device``).

    With ``cfg.lora.quantize_base`` (QLoRA) every target weight is stored
    packed (``peft.lora.quantize_layer_flat``), each layer as soon as it
    is drawn, so the full float32 base never sits whole on the device;
    the bytes are those of the JAX package's quantize-after."""
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    keys = jr.split(key, 8)
    params: Dict = {
        "embed": init_dense(keys[0], (cfg.vocab_size, cfg.d_model), dtype,
                            scale=0.02, device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(keys[1], (cfg.d_model, cfg.vocab_size),
                                       dtype, device=device)
    P = len(cfg.pattern)
    layers: List = [None] * cfg.n_layers
    for p, (gk, (mixer, ffn)) in enumerate(
            zip(jr.split(keys[3], P), cfg.pattern)):
        for g, k in enumerate(jr.split(gk, cfg.n_groups)):
            layer = L.init_layer_params(k, cfg, mixer, ffn, dtype, device)
            if cfg.lora.quantize_base:
                layer = lora_mod.quantize_layer_flat(layer, cfg.lora.targets)
            layers[g * P + p] = layer
    params["layers"] = layers
    return params


def init_adapters(cfg, key, params: Dict) -> List:
    """LoRA adapters of one client, layer by layer, under the JAX
    package's key tree (``split(key, P + 1)[1 + p]``, split per group)."""
    P = len(cfg.pattern)
    keys = jr.split(key, P + 1)
    out: List = [None] * cfg.n_layers
    for p in range(P):
        for g, k in enumerate(jr.split(keys[1 + p], cfg.n_groups)):
            out[g * P + p] = lora_mod.init_layer_adapters(
                k, cfg, params["layers"][g * P + p])
    return out


def stack_clients(trees: List):
    """``(C, …)`` leaves from C per-client trees of one structure."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(cfg, params: Dict, adapters: List, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens ``(C, B, S)`` → post-norm hidden ``(C, B, S, d)``."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    P = len(cfg.pattern)
    for i, (base, adp) in enumerate(zip(params["layers"], adapters)):
        mixer, ffn = cfg.pattern[i % P]
        x = L.apply_layer_train(cfg, {**base, **adp}, x, positions, mixer,
                                ffn)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(cfg, params):
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def chunked_ce(cfg, params, hidden, labels, *, chunk: int = 512):
    """Per-client mean next-token CE ``(C,)`` over sequence chunks, so
    ``(C, B, chunk, V)`` logits are the only vocab-sized tensor.  labels
    < 0 are masked; the count is clamped to 1.

    Each client's logits are a product of their own, forward and
    backward: one product over all C clients' rows lets the library
    choose its kernel and reduction split by C, so a client's gradient
    would depend on how many clients share the step."""
    C, B, S, _ = hidden.shape
    head = _head(cfg, params)
    chunk = min(chunk, S)
    assert S % chunk == 0
    tot = torch.zeros(C, dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros(C, dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        h, y = hidden[:, :, i:i + chunk], labels[:, :, i:i + chunk]
        logits = torch.stack([h[c] @ head.to(h.dtype)
                              for c in range(C)]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.clamp(min=0)[..., None])[..., 0]
        mask = (y >= 0).float()
        tot = tot + torch.sum((logz - gold) * mask, dim=(1, 2))
        cnt = cnt + torch.sum(mask, dim=(1, 2))
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# train step (LoRA fine-tuning — the paper's client-side technique)
# ---------------------------------------------------------------------------
def loss_and_grads(cfg, params, adapters, batch, *, loss_chunk: int = 512):
    """Per-client losses ``(C,)`` and the adapter gradients (a tree of
    ``adapters``' structure) of their sum: each client's gradient is its
    own, since clients share only the frozen base."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(adapters)]
    hidden = forward(cfg, params, tree_unflatten(adapters, leaves),
                     batch["tokens"])
    loss = chunked_ce(cfg, params, hidden, batch["labels"], chunk=loss_chunk)
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), tree_unflatten(adapters, list(grads))


def make_train_step(cfg, *, lr: float = 1e-4, loss_chunk: int = 512):
    """``(params, adapters, opt_state, batch) → (adapters, opt_state,
    metrics)`` for client-stacked adapters and batches.

    ``batch`` holds ``tokens``/``labels`` ``(C, B, S)``.  The loss is the
    sum over clients of each client's mean CE; the base is frozen and
    gets no gradient.  ``metrics["loss"]`` and ``metrics["grad_norm"]``
    are ``(C,)``.
    """
    def train_step(params, adapters, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, adapters, batch,
                                     loss_chunk=loss_chunk)
        new_adapters, new_opt = adamw.update(grads, opt_state, adapters,
                                             lr=lr)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2,
                                         dim=tuple(range(1, g.dim())))
                               for g in tree_leaves(grads)))
        return new_adapters, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step
