"""The LLM fine-tuning stage's pure evaluation math and key contract.

The port of ``repro/core/llm_client.py`` (lines 60-160): every client
shares a frozen randomly initialised base LLM and fine-tunes LoRA
adapters on its private shard.  The fine-tuned LLM then provides
``L_LLM`` (``masked_label_nll``) for optimizer regulation, per-example
soft labels for distillation, and macro-F1.  Every function takes the
client axis first, ``(C, …)``.

LLM key-derivation contract (the JAX package's, draw for draw):

    ``llm_key(llm_root(seed), client, step)``
    = ``fold_in(fold_in(fold_in(PRNGKey(seed), LLM_DOMAIN), client), step)``

with ``client`` the client's position ``0..C-1`` (padding clients after
every real one) and ``step`` the global fine-tune step; the minibatch of
step ``s`` is ``sample_minibatch_idx(llm_key(root, c, s), n_c, bs)`` and
the adapter init draws at ``LLM_INIT_STEP``.

The per-client ``LLMClient`` and ``run_sequential_stage`` (the JAX
package's sequential parity reference) come with the ROADMAP item
"engine sequential".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.configs import paper_models
from repro_torch.models import model as M

LLM_DOMAIN = 0x4C4C4D            # "LLM"
LLM_INIT_STEP = 0x7FFFFFFF

_BASES = {"tiny-llm": paper_models.TINY_LLM,
          "llama3.2-1b": paper_models.LLAMA32_1B}


def llm_root(seed: int) -> np.ndarray:
    """Root of the fine-tuning stage's key chain for a run seed."""
    return jr.fold_in(jr.PRNGKey(seed), LLM_DOMAIN)


def llm_key(root: np.ndarray, client: int, step: int) -> np.ndarray:
    return jr.fold_in(jr.fold_in(root, client), step)


def sample_minibatch_idx(key: np.ndarray, n: int, batch_size: int
                         ) -> np.ndarray:
    """With-replacement uniform minibatch indices in ``[0, n)`` (``n``
    clamped to >= 1), bitwise the JAX package's draw."""
    u = jr.uniform(key, (batch_size,))
    n = max(int(n), 1)
    return np.minimum((u * np.float32(n)).astype(np.int32), n - 1)


def task_llm_config(base_name: str, vocab_size: int, seq_len: int):
    """A paper LLM config with the task vocabulary."""
    if base_name not in _BASES:
        raise NotImplementedError(
            f"LLM {base_name!r} is not ported yet (ROADMAP §1, 'the other "
            f"model families'); the port runs {sorted(_BASES)}")
    return dataclasses.replace(_BASES[base_name], vocab_size=vocab_size)


def label_logits(cfg, params: Dict, adapters, tokens: torch.Tensor,
                 labels: torch.Tensor, n_labels: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits over the label-token block at each example's label position.

    tokens/labels ``(C, N, L)``; a padded row has no ``label >= 0``
    position, so its position degenerates to 0 and its gold index is
    clipped (callers mask those rows out).  Returns (logits
    ``(C, N, n_labels)`` float32, gold ``(C, N)``).
    """
    hidden = M.forward(cfg, params, adapters, tokens)
    pos = torch.argmax((labels >= 0).to(torch.int32), dim=-1)        # (C, N)
    d = hidden.shape[-1]
    idx = pos[..., None, None].expand(*pos.shape, 1, d)
    h = torch.gather(hidden, 2, idx)[:, :, 0]
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = h.float() @ head[:, -n_labels:].float()
    gold_tok = torch.gather(labels, 2, pos[..., None])[..., 0]
    gold = torch.clamp(gold_tok - (cfg.vocab_size - n_labels), 0,
                       n_labels - 1)
    return logits, gold


def masked_label_nll(logits: torch.Tensor, gold: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """L_LLM per client ``(C,)``: mask-weighted classification NLL, the
    denominator clamped so an all-padding client stays finite."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, gold[..., None])[..., 0]
    return torch.sum(nll * mask, -1) / torch.clamp(torch.sum(mask, -1),
                                                   min=1.0)


def masked_macro_f1(logits: torch.Tensor, gold: torch.Tensor,
                    mask: torch.Tensor, n_labels: int) -> torch.Tensor:
    """Macro-F1 per client ``(C,)`` over masked rows; the counts are
    integer-valued float32 sums, exact."""
    pred = torch.argmax(logits, dim=-1)
    cls = torch.arange(n_labels, device=logits.device)
    m = mask[..., None]
    is_p = (pred[..., None] == cls).float() * m
    is_g = (gold[..., None] == cls).float() * m
    tp = torch.sum(is_p * is_g, dim=-2)
    fp = torch.sum(is_p, dim=-2) - tp
    fn = torch.sum(is_g, dim=-2) - tp
    zero = torch.zeros_like(tp)
    p = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1.0), zero)
    r = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1.0), zero)
    f1 = torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-30),
                     zero)
    return torch.mean(f1, dim=-1)
