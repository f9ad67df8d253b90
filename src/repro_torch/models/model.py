"""Model assembly: init, forward, cross-entropy, the LoRA train step,
prefill and the one-token serve step.

The port of ``repro/models/model.py`` for the families the port runs
(every mixer of ``layers.MIXERS``: GQA, MLA, Mamba, mLSTM, sLSTM; MLP,
MoE or no feed-forward block; any layer period): ``init_params``,
``init_adapters``, ``forward`` (no remat, no frontend;
``collect_cache`` and ``mlstm_chunkwise`` as JAX's ``FwdOptions``; the
MoE balance loss summed over layers), ``chunked_ce``, ``make_train_step``
(one microbatch; a MoE config's loss adds ``moe.balance_loss_weight`` ×
the balance, as JAX's does), ``logits_last``, ``make_prefill_step``,
``init_cache`` and ``make_serve_step``.

Layouts.  The base is ``{"embed", "final_norm", "lm_head" (untied
only), "layers": [layer dict, ...]}``: the JAX package's group-stacked
``params["groups"]`` unrolled into one dict per layer
(``convert.params_from_jax``).  Adapters are ``[layer dict, ...]`` of
``{name}_lora_a`` / ``{name}_lora_b`` (``{}`` for a layer with no
target, such as an sLSTM one); in the batched engine every leaf
carries a leading client axis ``(C, …)``, while the base is shared and
never stacked.  A QLoRA base (``cfg.lora.quantize_base``) holds
``{name}__q``/``{name}__s`` in place of each adapted 2-D weight.
Activations are ``(C, B, S, d)``.

Serving runs one adapter set: ``make_prefill_step`` and
``make_serve_step`` take one client's adapters (``init_adapters``' list,
unstacked) and ``(B, S)`` tokens, as the JAX package's steps do, and
run them on the client axis as ``C = 1``.  The decode cache is a list of
one tuple a layer (``layers.cache_struct``): GQA's ``(k, v)``, each
``(B, S, KH, D)``, MLA's ``(c_kv, k_rope)``, or a recurrent mixer's
state (Mamba's 2, the mLSTM's 4, the sLSTM's 4 tensors): JAX's
group-stacked tuple unrolled (``convert.cache_from_jax``).  The serve
step writes it in place, recurrent states included, and returns it.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import init_dense, matmul, rms_norm
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
def forward(cfg, params: Dict, adapters: List, tokens: torch.Tensor, *,
            collect_cache: bool = False, with_balance: bool = False,
            mlstm_chunkwise: bool = False):
    """tokens ``(C, B, S)`` → post-norm hidden ``(C, B, S, d)``; with
    ``collect_cache``, ``(hidden, caches)``, one tuple a layer (GQA's
    ``(k, v)``, each ``(C·B, S, KH, D)``, MLA's ``(c_kv, k_rope)``, in
    the activation dtype; a recurrent mixer's last state,
    ``layers.apply_layer_train``).  ``mlstm_chunkwise`` runs the mLSTM
    layers in their chunkwise form.  With ``with_balance`` the MoE balance loss
    ``(C,)`` float32 (zeros without MoE) comes second, as JAX's
    ``forward`` returns it: ``(hidden, balance[, caches])``.  JAX sums it
    within each layer group, then over the groups; so does this."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    P = len(cfg.pattern)
    caches, groups = [], []
    for i, (base, adp) in enumerate(zip(params["layers"], adapters)):
        mixer, ffn = cfg.pattern[i % P]
        if i % P == 0:
            groups.append(torch.zeros(tokens.shape[0], dtype=torch.float32,
                                      device=tokens.device))
        x, cache, bal = L.apply_layer_train(
            cfg, {**base, **adp}, x, positions, mixer, ffn,
            mlstm_chunkwise=mlstm_chunkwise)
        if bal is not None:
            groups[-1] = groups[-1] + bal
        if collect_cache:
            caches.append(cache)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = (hidden,)
    if with_balance:
        out += (torch.stack(groups).sum(0),)
    if collect_cache:
        out += (caches,)
    return out if len(out) > 1 else hidden


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
    own, since clients share only the frozen base.  A MoE config's loss
    adds ``moe.balance_loss_weight`` × its balance loss, as JAX's does."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(adapters)]
    hidden, balance = forward(cfg, params, tree_unflatten(adapters, leaves),
                              batch["tokens"], with_balance=True)
    loss = chunked_ce(cfg, params, hidden, batch["labels"], chunk=loss_chunk)
    if cfg.moe:
        loss = loss + cfg.moe.balance_loss_weight * balance
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


# ---------------------------------------------------------------------------
# prefill / serve
# ---------------------------------------------------------------------------
def logits_last(cfg, params, hidden: torch.Tensor) -> torch.Tensor:
    """Float32 logits of the last position: hidden ``(..., S, d)`` →
    ``(..., V)``, the product in the activation dtype (rounded there,
    as JAX's einsum is) and then widened."""
    return matmul(hidden[..., -1, :], _head(cfg, params)).float()


def _one_client(adapters: List) -> List:
    """One adapter set as a client stack of one (views, no copy)."""
    return tree_map(lambda t: t[None], adapters)


def make_prefill_step(cfg, *, mlstm_chunkwise: bool = False):
    """``(params, adapters, batch) → (logits (B, V), caches)``: the
    prompt ``batch["tokens"]`` ``(B, S)`` through the full-sequence
    forward (GQA windowed by ``cfg.sliding_window``; the mLSTM layers in
    their chunkwise form with ``mlstm_chunkwise``), its last position's
    float32 logits, and each layer's cache (GQA's ``(k, v)`` ``(B, S, KH,
    D)``, MLA's ``(c_kv, k_rope)``, in the activation dtype; a recurrent
    mixer's last state, as the JAX package's prefill returns it: the
    mLSTM's ``(C, n, m)`` has no convolution state, so it cannot seed
    the serve step)."""
    def prefill(params, adapters, batch):
        with torch.no_grad():
            hidden, caches = forward(cfg, params, _one_client(adapters),
                                     batch["tokens"][None],
                                     collect_cache=True,
                                     mlstm_chunkwise=mlstm_chunkwise)
            return logits_last(cfg, params, hidden)[0], caches
    return prefill


def init_cache(cfg, batch: int, seq: int, *, window: int = 0,
               dtype=torch.bfloat16, device=None) -> List:
    """Zero decode caches, one tuple a layer (``layers.cache_struct``).
    An attention mixer's holds ``s = min(seq, window)`` slots when
    ``window`` is set (a rolling GQA cache when the window fits in
    ``seq``; MLA's clamps its writes at the last slot, as JAX's does),
    else ``seq``; a recurrent mixer's state has no sequence axis.
    ``dtype`` is that of the sequence caches and the convolution states
    (the other recurrent states are float32).  ``device=None`` is the
    card."""
    device = resolve_device(device)
    P = len(cfg.pattern)
    out = []
    for i in range(cfg.n_layers):
        mixer = cfg.pattern[i % P][0]
        s = min(seq, window) if window and mixer in ("attn", "mla") else seq
        out.append(L.cache_struct(cfg, mixer, batch, s, dtype, device))
    return out


def make_serve_step(cfg, *, window: int = 0):
    """One-token decode: ``(params, adapters, cache, token (B, 1), pos)
    → (logits (B, V), cache)``.  ``pos`` is the token's position, an int
    or a 0-dim int tensor on the device; ``window`` masks attention to
    the last ``window`` positions (0: the whole cache) in the attention
    layers; the recurrent layers take none.  As in the JAX package, the
    window is this argument's and ``cfg.sliding_window`` is not read."""
    P = len(cfg.pattern)

    def serve(params, adapters, cache, token, pos):
        with torch.no_grad():
            x = params["embed"][token][None]                # (1, B, 1, d)
            new_cache = []
            for i, (base, adp) in enumerate(zip(params["layers"],
                                                _one_client(adapters))):
                mixer, ffn = cfg.pattern[i % P]
                w = window if mixer in ("attn", "mla") else 0
                x, c = L.apply_layer_decode(cfg, {**base, **adp}, x, pos,
                                            cache[i], mixer, ffn, window=w)
                new_cache.append(c)
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            return logits_last(cfg, params, x)[0], new_cache

    return serve
