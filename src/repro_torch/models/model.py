"""Model assembly: init, forward, cross-entropy, the LoRA train step,
prefill and the one-token serve step.

The port of ``repro/models/model.py`` for every family of the JAX
package (every mixer of ``layers.MIXERS``: GQA, MLA, Mamba, mLSTM, sLSTM;
MLP, MoE or no feed-forward block; any layer period; an encoder-decoder;
a stub audio or vision frontend): ``init_params``, ``init_adapters``,
``FwdOptions`` (JAX's fields and defaults), ``forward`` (each layer
group rematerialised under ``opts.remat``; the MoE balance loss summed
over layers), ``chunked_ce``, ``make_train_step`` (microbatch gradient
accumulation; a MoE config's loss adds ``moe.balance_loss_weight`` × the
balance, as JAX's does), ``get_train_step``, ``logits_last``,
``make_prefill_step``, ``init_cache`` and ``make_serve_step``.

Rematerialisation.  A layer group is one period of ``cfg.pattern``, as
in JAX's ``jax.checkpoint(group_fn)``: under ``opts.remat`` each group
runs in ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
with, inside it, each decoder layer's ``cross_kv`` of the encoder output
and the group's MoE balance term; the encoder stack takes the same
``remat``.  The backward recomputes a group's forward, so each forward
kernel launches twice a step and each backward kernel once.  The port's
kernels and plain versions are deterministic, so a rematerialised step
equals the plain one bit for bit.

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

Frontends.  A config with a ``frontend`` has ``params["proj_frontend"]``
``(d, d)``, and its forward reads the stub frontend's embeddings
``(B, F, d)`` (``batch["frontend"]``), projected in their own dtype.  A
vision model (``qwen2-vl``) prepends the projected patches, cast to the
token stream's dtype, to the prompt: positions run over ``F + S`` rows,
the caches hold all of them, and the hidden state drops the first ``F``
after the final norm.  An encoder-decoder (``whisper``) runs the
projected frames through its encoder stack (non-causal, positions
``arange(F)``, the frames' dtype: bfloat16 frames give a bfloat16
encoder stream) and ``enc_final_norm``; each decoder layer then attends
to its own ``cross_kv`` of that output.  Its base adds ``"enc_layers"``
(``params["enc_groups"]`` unrolled, no cross weights) and
``"enc_final_norm"``, and its decoder layers carry the ``x``-prefixed
cross weights.  Its adapters are ``{"layers": [...], "enc_layers":
[...]}``, one to one with JAX's ``{"groups", "enc_groups"}`` (a
decoder-only model keeps the plain list); the cross weights take none.

Serving runs one adapter set: ``make_prefill_step`` and
``make_serve_step`` take one client's adapters (``init_adapters``' list
or dict, unstacked) and ``(B, S)`` tokens, as the JAX package's steps
do, and run them on the client axis as ``C = 1``.  The decode cache is a
list of one tuple a layer (``layers.cache_struct``): GQA's ``(k, v)``,
each ``(B, S, KH, D)``, MLA's ``(c_kv, k_rope)``, or a recurrent mixer's
state (Mamba's 2, the mLSTM's 4, the sLSTM's 4 tensors): JAX's
group-stacked tuple unrolled (``convert.cache_from_jax``).  An
encoder-decoder's is JAX's pair ``(self caches, cross caches)``, the
cross caches a list of ``(xk, xv)``, each ``(B, F, KH, D)``; its prefill
returns one ``((k, v), (xk, xv))`` a layer.  The serve step writes the
self caches in place, recurrent states included, reads the cross caches,
and returns the cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
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
    tree (``split(key, 8)``; decoder layer ``g·P + p`` from
    ``split(split(keys[3], P)[p], n_groups)[g]``, an encoder layer alike
    from ``keys[4]``, ``proj_frontend`` from ``keys[2]``).
    ``device=None`` is the card, and raises without one
    (``device.resolve_device``).

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
    if cfg.frontend:
        params["proj_frontend"] = init_dense(
            keys[2], (cfg.d_model, cfg.d_model), dtype, device=device)
    params["layers"] = _init_stack(cfg, keys[3], cfg.n_groups, dtype, device,
                                   cross=cfg.encoder_decoder)
    if cfg.encoder_decoder:
        params["enc_layers"] = _init_stack(
            cfg, keys[4], cfg.n_encoder_layers // len(cfg.pattern), dtype,
            device, cross=False)
        params["enc_final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                              device=device)
    return params


def _init_stack(cfg, key, n_groups: int, dtype, device, cross: bool) -> List:
    """``n_groups`` periods of ``cfg.pattern``'s layers, one dict a layer,
    layer ``g·P + p`` from ``split(split(key, P)[p], n_groups)[g]``."""
    P = len(cfg.pattern)
    layers: List = [None] * (P * n_groups)
    for p, (gk, (mixer, ffn)) in enumerate(
            zip(jr.split(key, P), cfg.pattern)):
        for g, k in enumerate(jr.split(gk, n_groups)):
            layer = L.init_layer_params(k, cfg, mixer, ffn, dtype, device,
                                        cross=cross)
            if cfg.lora.quantize_base:
                layer = lora_mod.quantize_layer_flat(layer, cfg.lora.targets)
            layers[g * P + p] = layer
    return layers


def init_adapters(cfg, key, params: Dict):
    """LoRA adapters of one client, layer by layer, under the JAX
    package's key tree (``split(key, P + 1)[1 + p]``, split per group).
    An encoder-decoder's are ``{"layers", "enc_layers"}``, the encoder's
    keys chained off the decoder's as JAX's are: ``split(split(key, P +
    1)[0], P + 1)[1 + p]``."""
    P = len(cfg.pattern)
    out = {}
    for name in ("layers", "enc_layers"):
        if name not in params:
            continue
        keys = jr.split(key, P + 1)
        key = keys[0]
        layers = params[name]
        stack: List = [None] * len(layers)
        for p in range(P):
            for g, k in enumerate(jr.split(keys[1 + p], len(layers) // P)):
                stack[g * P + p] = lora_mod.init_layer_adapters(
                    k, cfg, layers[g * P + p])
        out[name] = stack
    return out if cfg.encoder_decoder else out["layers"]


def _stacks(cfg, adapters) -> tuple:
    """(the decoder's adapters, the encoder's or None)."""
    if cfg.encoder_decoder:
        return adapters["layers"], adapters["enc_layers"]
    return adapters, None


def stack_clients(trees: List):
    """``(C, …)`` leaves from C per-client trees of one structure."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FwdOptions:
    """The forward's options: JAX's ``FwdOptions``, fields and defaults.

    ``window`` overrides the attention window (``None``: GQA takes
    ``cfg.sliding_window``, MLA none); ``remat`` rematerialises each
    layer group (the module docstring); ``mlstm_chunkwise`` runs the
    mLSTM layers in their chunkwise form; ``collect_cache`` returns each
    layer's cache; ``causal`` masks the decoder's attention (the encoder
    is always non-causal).  ``seq_parallel`` shards the residual stream's
    sequence over ``'model'`` between layer groups (and gathers it back
    after the final norm); ``shard_cache`` shards each collected cache
    (``_shard_cache_tree``); ``attn_anchor`` shards attention's batch
    and heads at its kernel (``attention``).  All three act on DTensors
    over a device mesh (the dry run, ``launch/dryrun.py``) and leave a
    plain tensor as it is."""
    window: Optional[int] = None
    remat: bool = True
    mlstm_chunkwise: bool = False
    collect_cache: bool = False
    causal: bool = True
    seq_parallel: bool = False
    shard_cache: bool = False
    attn_anchor: bool = True


_BA = ("pod", "data")


def _shard_cache_tree(tree, batch: int):
    """Prefill-cache sharding: the sequence axis (the first, ``C·B``
    rows) over the data-parallel axes when ``batch`` > 1 rows share it,
    the longest other axis of at least 2048 over 'model'."""
    def leaf(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        spec = [None] * x.ndim
        if batch > 1 and x.shape[0] == batch:
            spec[0] = _BA
        big = [(i, d) for i, d in enumerate(x.shape) if i > 0 and d >= 2048]
        if big:
            i, _ = max(big, key=lambda t: t[1])
            spec[i] = "model"
        return shd.constrain(x, shd.P(*spec))
    return tree_map(leaf, tree)


def forward(cfg, params: Dict, adapters, tokens: torch.Tensor, *,
            frontend=None, opts: FwdOptions = FwdOptions(),
            with_balance: bool = False):
    """tokens ``(C, B, S)`` → post-norm hidden ``(C, B, S, d)``; with
    ``opts.collect_cache``, ``(hidden, caches)``, one tuple a layer
    (GQA's ``(k, v)``, each ``(C·B, S, KH, D)``, MLA's ``(c_kv,
    k_rope)``, in the activation dtype; a recurrent mixer's last state,
    ``layers.apply_layer_train``; an encoder-decoder's ``((k, v), (xk,
    xv))``).  ``frontend`` ``(C, B, F, d)`` is the stub frontend's
    embeddings, which a config with a ``frontend`` or an encoder reads
    (the module docstring).  ``opts`` is JAX's ``FwdOptions``; the
    encoder runs non-causal under ``opts.remat`` alone, as JAX's
    ``eopts``.  With ``with_balance`` the MoE balance loss ``(C,)``
    float32 (zeros without MoE) comes second, as JAX's ``forward``
    returns it: ``(hidden, balance[, caches])``.  JAX sums it within
    each layer group, then over the groups; so does this."""
    dec_adp, enc_adp = _stacks(cfg, adapters)
    if (cfg.frontend or cfg.encoder_decoder) and frontend is None:
        raise ValueError(f"{cfg.name} reads the frontend's embeddings "
                         "(batch['frontend'], (B, F, d_model))")
    x = params["embed"][tokens]
    enc_out, prefix = None, 0
    if cfg.encoder_decoder:
        e = (matmul(frontend, params["proj_frontend"]) if cfg.frontend
             else frontend)
        eopts = FwdOptions(remat=opts.remat, causal=False)
        e = _run_stack(cfg, params["enc_layers"], enc_adp, e, eopts)[0]
        enc_out = rms_norm(e, params["enc_final_norm"], cfg.norm_eps)
    elif cfg.frontend:
        fe = matmul(frontend, params["proj_frontend"]).to(x.dtype)
        prefix = fe.shape[2]
        x = torch.cat([fe, x], dim=2)
    x, balance, caches = _run_stack(cfg, params["layers"], dec_adp, x, opts,
                                    enc_out=enc_out)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if opts.seq_parallel:
        # gather the sequence before the (vocab-sharded) loss head
        hidden = shd.constrain(hidden, shd.P(None, _BA, None, None))
    hidden = hidden[:, :, prefix:]
    out = (hidden,)
    if with_balance:
        out += (balance,)
    if opts.collect_cache:
        out += (caches,)
    return out if len(out) > 1 else hidden


def _run_stack(cfg, layers: List, adapters: List, x, opts: FwdOptions, *,
               enc_out=None):
    """A stack of layers over ``x`` ``(C, B, S, d)`` at positions
    ``arange(S)``, one period of ``cfg.pattern`` a group, each group
    rematerialised under ``opts.remat`` (when autograd records), each
    decoder layer given ``cross_kv`` of ``enc_out`` when there is one:
    ``(x, balance (C,), caches)``."""
    positions = torch.arange(x.shape[2], device=x.device)
    P = len(cfg.pattern)

    def group(x, enc_out, g):
        """Layers ``g … g + P - 1``: ``(x, the group's balance, caches)``."""
        balance = torch.zeros(x.shape[0], dtype=torch.float32,
                              device=x.device)
        caches = []
        for i in range(g, g + P):
            mixer, ffn = cfg.pattern[i % P]
            p = {**layers[i], **adapters[i]}
            enc_kv = (None if enc_out is None
                      else attn.cross_kv(p, cfg, enc_out))
            x, cache, bal = L.apply_layer_train(
                cfg, p, x, positions, mixer, ffn, causal=opts.causal,
                window=opts.window, enc_kv=enc_kv,
                mlstm_chunkwise=opts.mlstm_chunkwise,
                anchor=opts.attn_anchor)
            if bal is not None:
                balance = balance + bal
            if opts.collect_cache:
                if enc_kv is not None:
                    cache = (cache, enc_kv)
                if opts.shard_cache:
                    cache = _shard_cache_tree(cache, x.shape[0] * x.shape[1])
                caches.append(cache)
        return x, balance, caches

    remat = opts.remat and torch.is_grad_enabled()
    caches, balances = [], []
    for g in range(0, len(layers), P):
        if remat:
            x, bal, cs = checkpoint(group, x, enc_out, g, use_reentrant=False)
        else:
            x, bal, cs = group(x, enc_out, g)
        if opts.seq_parallel:
            x = shd.constrain(x, shd.P(None, _BA, "model", None))
        balances.append(bal)
        caches += cs
    return x, torch.stack(balances).sum(0), caches


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
        V = logits.shape[-1]
        gold = torch.gather(logits.reshape(-1, V), -1,
                            y.clamp(min=0).reshape(-1, 1)).reshape(y.shape)
        mask = (y >= 0).float()
        tot = tot + torch.sum((logz - gold) * mask, dim=(1, 2))
        cnt = cnt + torch.sum(mask, dim=(1, 2))
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# train step (LoRA fine-tuning — the paper's client-side technique)
# ---------------------------------------------------------------------------
def loss_and_grads(cfg, params, adapters, batch, *,
                   opts: FwdOptions = FwdOptions(), loss_chunk: int = 512):
    """Per-client losses ``(C,)`` and the adapter gradients (a tree of
    ``adapters``' structure) of their sum: each client's gradient is its
    own, since clients share only the frozen base.  A MoE config's loss
    adds ``moe.balance_loss_weight`` × its balance loss, as JAX's does."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(adapters)]
    hidden, balance = forward(cfg, params, tree_unflatten(adapters, leaves),
                              batch["tokens"], frontend=batch.get("frontend"),
                              opts=opts, with_balance=True)
    loss = chunked_ce(cfg, params, hidden, batch["labels"], chunk=loss_chunk)
    if cfg.moe:
        loss = loss + cfg.moe.balance_loss_weight * balance
    grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), tree_unflatten(adapters, list(grads))


def microbatch(batch: Dict, i: int, n: int) -> Dict:
    """Microbatch ``i`` of ``n``: the contiguous rows ``i·B/n … (i+1)·B/n``
    of each client's ``B`` rows (axis 1), as JAX's ``reshape(n, B // n,
    …)`` cuts its batch; on a mesh each is sharded over the batch axes,
    as JAX constrains it."""
    b = batch["tokens"].shape[1] // n
    return {k: shd.constrain(v[:, i * b:(i + 1) * b],
                             shd.P(None, _BA, *((None,) * (v.dim() - 2))))
            for k, v in batch.items()}


def make_train_step(cfg, *, n_microbatches: int = 1, lr: float = 1e-4,
                    opts: FwdOptions = FwdOptions(), loss_chunk: int = 512):
    """``(params, adapters, opt_state, batch) → (adapters, opt_state,
    metrics)`` for client-stacked adapters and batches.

    ``batch`` holds ``tokens``/``labels`` ``(C, B, S)`` (and, for a
    config with a frontend, ``frontend`` ``(C, B, F, d)``).  The loss is the
    sum over clients of each client's mean CE; the base is frozen and
    gets no gradient.  With ``n_microbatches`` = nm > 1 (nm must divide
    ``B``) the step runs each ``microbatch`` in turn, sums its gradients
    into float32 zeros and divides them, and the losses, by nm, as JAX's
    scan does; the gradient norm is the accumulated gradients'.
    ``metrics["loss"]`` and ``metrics["grad_norm"]`` are ``(C,)``.
    """
    nm = int(n_microbatches)

    def train_step(params, adapters, opt_state, batch):
        B = batch["tokens"].shape[1]
        if nm < 1 or B % nm:
            raise ValueError(f"{nm} microbatches do not divide the batch "
                             f"of {B} rows")
        if nm == 1:
            loss, grads = loss_and_grads(cfg, params, adapters, batch,
                                         opts=opts, loss_chunk=loss_chunk)
        else:
            grads = tree_map(lambda t: torch.zeros_like(
                t, dtype=torch.float32), adapters)
            loss = 0.0
            for i in range(nm):
                l, g = loss_and_grads(cfg, params, adapters,
                                      microbatch(batch, i, nm), opts=opts,
                                      loss_chunk=loss_chunk)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda t: t / nm, grads)
            loss = loss / nm
        new_adapters, new_opt = adamw.update(grads, opt_state, adapters,
                                             lr=lr)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2,
                                         dim=tuple(range(1, g.dim())))
                               for g in tree_leaves(grads)))
        return new_adapters, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


_TRAIN_STEP_CACHE: dict = {}


def get_train_step(cfg, *, n_microbatches: int = 1, lr: float = 1e-4,
                   opts: FwdOptions = FwdOptions(), loss_chunk: int = 512):
    """Module-cached ``make_train_step(...)``, keyed by the whole static
    configuration (``ModelConfig`` and ``FwdOptions`` are frozen, hence
    hashable), as JAX's cache of jitted steps is.  The port compiles
    nothing, so the cache shares only the closure."""
    key = (cfg, int(n_microbatches), float(lr), opts, int(loss_chunk))
    if key not in _TRAIN_STEP_CACHE:
        _TRAIN_STEP_CACHE[key] = make_train_step(
            cfg, n_microbatches=n_microbatches, lr=lr, opts=opts,
            loss_chunk=loss_chunk)
    return _TRAIN_STEP_CACHE[key]


# ---------------------------------------------------------------------------
# prefill / serve
# ---------------------------------------------------------------------------
def logits_last(cfg, params, hidden: torch.Tensor) -> torch.Tensor:
    """Float32 logits of the last position: hidden ``(..., S, d)`` →
    ``(..., V)``, the product in the activation dtype (rounded there,
    as JAX's einsum is) and then widened."""
    return matmul(hidden[..., -1, :], _head(cfg, params)).float()


def _one_client(adapters):
    """One adapter set as a client stack of one (views, no copy)."""
    return tree_map(lambda t: t[None], adapters)


def make_prefill_step(cfg, opts: FwdOptions = FwdOptions(
        remat=False, collect_cache=True)):
    """``(params, adapters, batch) → (logits (B, V), caches)``: the
    prompt ``batch["tokens"]`` ``(B, S)`` (behind ``batch["frontend"]``
    ``(B, F, d)`` for a config with a frontend) through the
    full-sequence forward under ``opts`` (JAX's default: no remat, the
    caches collected; GQA windowed by ``cfg.sliding_window`` unless
    ``opts.window`` is set; the mLSTM layers in their chunkwise form with
    ``opts.mlstm_chunkwise``), its
    last position's float32 logits, and each layer's cache (GQA's ``(k,
    v)`` ``(B, S, KH, D)``, ``F + S`` rows behind a vision frontend; an
    encoder-decoder's ``((k, v), (xk, xv))``, the cross pair ``(B, F,
    KH, D)``; MLA's ``(c_kv, k_rope)``, in the activation dtype; a
    recurrent mixer's last state, as the JAX package's prefill returns
    it: the mLSTM's ``(C, n, m)`` has no convolution state, so it cannot
    seed the serve step)."""
    if not opts.collect_cache:
        raise ValueError("make_prefill_step returns the caches: "
                         "opts.collect_cache must be set")

    def prefill(params, adapters, batch):
        fe = batch.get("frontend")
        with torch.no_grad():
            hidden, caches = forward(cfg, params, _one_client(adapters),
                                     batch["tokens"][None],
                                     frontend=None if fe is None else fe[None],
                                     opts=opts)
            return logits_last(cfg, params, hidden)[0], caches
    return prefill


def init_cache(cfg, batch: int, seq: int, *, window: int = 0,
               dtype=torch.bfloat16, device=None):
    """Zero decode caches, one tuple a layer (``layers.cache_struct``).
    An attention mixer's holds ``s = min(seq, window)`` slots when
    ``window`` is set (a rolling GQA cache when the window fits in
    ``seq``; MLA's clamps its writes at the last slot, as JAX's does),
    else ``seq``; a recurrent mixer's state has no sequence axis.
    ``dtype`` is that of the sequence caches and the convolution states
    (the other recurrent states are float32).  An encoder-decoder's is
    the pair ``(that list, cross caches)``, one ``(xk, xv)`` a layer,
    each ``(batch, n_frontend_tokens, KH, D)`` zeros of ``dtype``.
    ``device=None`` is the card."""
    device = resolve_device(device)
    P = len(cfg.pattern)
    out = []
    for i in range(cfg.n_layers):
        mixer = cfg.pattern[i % P][0]
        s = min(seq, window) if window and mixer in ("attn", "mla") else seq
        out.append(L.cache_struct(cfg, mixer, batch, s, dtype, device))
    if not cfg.encoder_decoder:
        return out
    shape = (batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.head_dim)
    return out, [tuple(torch.zeros(shape, dtype=dtype, device=device)
                       for _ in range(2)) for _ in range(cfg.n_layers)]


def make_serve_step(cfg, *, window: int = 0):
    """One-token decode: ``(params, adapters, cache, token (B, 1), pos)
    → (logits (B, V), cache)``.  ``pos`` is the token's position, an int
    or a 0-dim int tensor on the device; ``window`` masks attention to
    the last ``window`` positions (0: the whole cache) in the attention
    layers; the recurrent layers take none.  As in the JAX package, the
    window is this argument's and ``cfg.sliding_window`` is not read.
    An encoder-decoder's cache is the pair ``(self caches, cross
    caches)`` of ``init_cache``; each decoder layer attends to its cross
    cache after its mixer."""
    P = len(cfg.pattern)

    def serve(params, adapters, cache, token, pos):
        self_caches, cross = cache if cfg.encoder_decoder else (cache, None)
        with torch.no_grad():
            x = params["embed"][token][None]                # (1, B, 1, d)
            new_cache = []
            for i, (base, adp) in enumerate(zip(
                    params["layers"], _one_client(_stacks(cfg, adapters)[0]))):
                mixer, ffn = cfg.pattern[i % P]
                w = window if mixer in ("attn", "mla") else 0
                x, c = L.apply_layer_decode(
                    cfg, {**base, **adp}, x, pos, self_caches[i], mixer, ffn,
                    window=w, cross_kv=None if cross is None else cross[i])
                new_cache.append(c)
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits = logits_last(cfg, params, x)[0]
        if cfg.encoder_decoder:
            return logits, (new_cache, cross)
        return logits, new_cache

    return serve


# ---------------------------------------------------------------------------
# input specs (abstract stand-ins: no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg, shape, *, window: int = 0) -> Dict:
    """Abstract inputs of the dry run: ``meta`` tensors of JAX's shapes
    and dtypes.  Train: ``tokens`` and ``labels`` ``(B, S)`` int32 (and a
    frontend's ``(B, F, d)`` bfloat16); prefill: ``tokens`` (and the
    frontend); decode: ``token`` ``(B, 1)`` int32, ``pos`` a 0-dim int32
    and ``cache``, ``init_cache(cfg, B, S, window=window)``'s tree."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = meta((B, S), torch.int32)
        if cfg.frontend:
            batch["frontend"] = meta((B, cfg.n_frontend_tokens, cfg.d_model),
                                     torch.bfloat16)
        return batch
    if shape.kind == "decode":
        return {"token": meta((B, 1), torch.int32),
                "pos": meta((), torch.int32),
                "cache": init_cache(cfg, B, S, window=window,
                                    device="meta")}
    raise ValueError(shape.kind)
