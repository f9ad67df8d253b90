"""The LLM fine-tuning stage's pure evaluation math and key contract.

The port of ``repro/core/llm_client.py``: every client shares a frozen
randomly initialised base LLM and fine-tunes LoRA adapters on its
private shard.  The fine-tuned LLM then provides ``L_LLM``
(``masked_label_nll``) for optimizer regulation, per-example soft labels
for distillation, and macro-F1.  Every function takes the client axis
first, ``(C, …)``.

"Distill LLM using a global model" (Alg. 1 line 8) is adapter blending
toward the weighted FedAvg adapter: a_i ← (1−ρ)·a_i + ρ·a_g.

LLM key-derivation contract (the JAX package's, draw for draw):

    ``llm_key(llm_root(seed), client, step)``
    = ``fold_in(fold_in(fold_in(PRNGKey(seed), LLM_DOMAIN), client), step)``

with ``client`` the client's position ``0..C-1`` (padding clients after
every real one) and ``step`` the global fine-tune step; the minibatch of
step ``s`` is ``sample_minibatch_idx(llm_key(root, c, s), n_c, bs)`` and
the adapter init draws at ``LLM_INIT_STEP``.

``LLMClient`` and ``run_sequential_stage`` are the sequential parity
reference for ``core/batched_llm.BatchedLLMEngine``: one client at a
time, each client's adapters and optimizer state a stack of one
(``C = 1``), through the same client-stacked train step, so each
adapted projection is a ``lora_matmul`` launch and each attention a
``flash_attention`` launch for that client alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.configs import paper_models
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.peft import lora as lora_mod
from repro_torch.tree import tree_map

LLM_DOMAIN = 0x4C4C4D            # "LLM"
LLM_INIT_STEP = 0x7FFFFFFF

_BASES = {"tiny-llm": paper_models.TINY_LLM,
          "llama3.2-1b": paper_models.LLAMA32_1B,
          "gpt2": paper_models.GPT2,
          "deepseek-llm-7b-base": paper_models.DEEPSEEK_7B}


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
    """A paper LLM config with the task vocabulary; an unknown name
    raises ``KeyError``, as the JAX package's lookup does."""
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
    hidden = M.forward(cfg, params, adapters, tokens,
                       opts=M.FwdOptions(remat=False))
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


class LLMClient:
    """One client's local LLM: shared frozen base + private LoRA adapters,
    on the device of the base.

    The sequential wrapper around the functions above, the parity
    reference for ``core/batched_llm.BatchedLLMEngine``: adapters and
    AdamW state are stacks of one client, and every draw follows the
    ``llm_key(root, client, step)`` contract.
    """

    def __init__(self, cfg, base_params, key, *, n_labels: int,
                 lr: float = 3e-3, batch_size: int = 16,
                 client_id: int = 0):
        self.cfg = cfg
        self.base = base_params
        self.n_labels = n_labels
        self.lr = lr
        self.batch_size = batch_size
        self.client_id = client_id
        self.device = base_params["embed"].device
        self._root = key                  # llm_root(seed) in federated runs
        self.adapters = M.stack_clients([M.init_adapters(
            cfg, llm_key(key, client_id, LLM_INIT_STEP), base_params)])
        self.opt_state = adamw.init(self.adapters, n_clients=1)
        self._step = M.get_train_step(cfg, n_microbatches=1, lr=lr,
                                      opts=M.FwdOptions(remat=False))
        self._n_steps = 0                 # global step counter (contract)
        self._on_device = {}

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A shard's token or label array on the client's device, copied
        there once."""
        key = id(a)
        if key not in self._on_device:
            self._on_device[key] = (a, torch.as_tensor(a).to(
                device=self.device, dtype=torch.long))
        return self._on_device[key][1]

    # -- fine-tuning (round 1 / periodic refresh) ---------------------------
    def fine_tune(self, batch, *, steps: int = 30) -> float:
        toks, ys = self._put(batch["tokens"]), self._put(batch["labels"])
        n = toks.shape[0]
        last = float("nan")
        for _ in range(steps):
            k = llm_key(self._root, self.client_id, self._n_steps)
            self._n_steps += 1
            idx = torch.from_numpy(sample_minibatch_idx(
                k, n, self.batch_size).astype(np.int64)).to(self.device)
            mb = {"tokens": toks[idx][None], "labels": ys[idx][None]}
            self.adapters, self.opt_state, metrics = self._step(
                self.base, self.adapters, self.opt_state, mb)
            last = float(metrics["loss"][0])
        return last

    # -- evaluation ----------------------------------------------------------
    def _label_logits(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        toks, ys = self._put(batch["tokens"]), self._put(batch["labels"])
        with torch.no_grad():
            logits, gold = label_logits(self.cfg, self.base, self.adapters,
                                        toks[None], ys[None], self.n_labels)
        return logits, gold

    def eval_loss(self, batch) -> float:
        """Classification NLL on the label positions — L_LLM^t."""
        logits, gold = self._label_logits(batch)
        mask = torch.ones(gold.shape, dtype=torch.float32,
                          device=self.device)
        return float(masked_label_nll(logits, gold, mask)[0])

    def teacher_probs(self, batch) -> torch.Tensor:
        """Soft class labels (B, n_labels) for distillation."""
        logits, _ = self._label_logits(batch)
        return torch.softmax(logits[0], dim=-1)

    def f1(self, batch) -> float:
        logits, gold = self._label_logits(batch)
        mask = torch.ones(gold.shape, dtype=torch.float32,
                          device=self.device)
        return float(masked_macro_f1(logits, gold, mask, self.n_labels)[0])


def fedavg_adapters(adapter_list, weights):
    """Weighted average of client adapter trees (global LLM teacher).

    The weights are normalised in float64 and each rounded to float32,
    as the JAX package's float32 leaves round the numpy scalars they are
    multiplied by; the sum stays a chain of device ops."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    w32 = [float(np.float32(wi)) for wi in w]
    return tree_map(lambda *xs: sum(wi * x for wi, x in zip(w32, xs)),
                    *adapter_list)


def distill_to_global(clients, weights, *, rho: float = 0.25):
    """a_i ← (1−ρ)·a_i + ρ·a_g  (Alg. 1 line 8)."""
    a_g = fedavg_adapters([c.adapters for c in clients], weights)
    for c in clients:
        c.adapters = lora_mod.blend_adapters(c.adapters, a_g, rho)
    return a_g


def run_sequential_stage(task, cfg, base_params, *, seed: int,
                         lr: float = 3e-3, steps: int = 30,
                         batch_size: int = 16, rho: float = 0.25):
    """The whole fine-tuning stage, one client at a time, on the device of
    the base — the parity reference for ``BatchedLLMEngine``, and the
    orchestrator's ``engine="sequential"`` Step 1.

    Returns ``(clients, losses, f1s, teachers)`` with evaluations taken
    *after* the distillation blend, matching Alg. 1's ordering; each
    teacher is a ``(n_i, n_labels)`` tensor on the device.
    """
    root = llm_root(seed)
    clients = []
    for i in range(task.n_clients):
        cl = LLMClient(cfg, base_params, root, client_id=i,
                       n_labels=task.n_classes, lr=lr,
                       batch_size=batch_size)
        cl.fine_tune(task.clients[i].llm_batch, steps=steps)
        clients.append(cl)
    distill_to_global(clients, task.weights, rho=rho)
    losses = [cl.eval_loss(task.clients[i].llm_batch)
              for i, cl in enumerate(clients)]
    f1s = [cl.f1(task.clients[i].llm_batch)
           for i, cl in enumerate(clients)]
    teachers = [cl.teacher_probs(task.clients[i].llm_batch)
                for i, cl in enumerate(clients)]
    return clients, losses, f1s, teachers
