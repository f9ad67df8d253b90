"""Batched LLM fine-tuning engine: Alg. 1 Step 1 for every client at once.

The port of ``repro/core/batched_llm.py``.  All C clients' LoRA adapters
and AdamW states are stacked on a leading ``(C, …)`` axis; the single
frozen base is shared, never stacked.  Each fine-tune step is one
forward and backward over every client's minibatch together, so every
adapted projection is one ``lora_matmul`` launch for all clients and
every attention one ``flash_attention`` launch, forward and backward.
After ``steps`` steps the FedAvg teacher ``a_g = Σ w_i a_i`` and the
distillation blend ``a_i ← (1−ρ)·a_i + ρ·a_g`` run on the device, and
then the label-head evaluations on the blended adapters.

Padding contract (the JAX package's): each client's shard is padded to
``(Nmax, L)`` with PAD tokens and -1 labels, with an explicit
``rowmask``; evaluations are mask-weighted with the denominator clamped
to 1, and minibatches index only rows ``< n_i`` (``nvalid``, clamped to
1).  ``pad_to`` adds inert clients (zero rowmask and weight, PAD shards
whose all-masked CE is 0, so their gradients and updates are exactly
zero), with client ids after every real client.

Key contract: minibatch draws follow ``llm_client.llm_key(root, client,
step)`` with ``step`` the global step counter, which survives a refresh
(a second ``run()``), and adapter inits draw at ``LLM_INIT_STEP``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import llm_client as llmc
from repro_torch.data.tokenizer import PAD
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.peft import lora as lora_mod


@dataclasses.dataclass
class LLMRoundResult:
    """Per-client outputs of the fine-tuning stage (real clients only)."""
    losses: np.ndarray            # (C,)  post-distill eval NLL (L_LLM)
    f1: np.ndarray                # (C,)  post-distill macro-F1
    teacher: np.ndarray           # (C, Nmax, n_labels) soft labels
    final_train_loss: np.ndarray  # (C,)  last fine-tune minibatch loss


class BatchedLLMEngine:
    """Stacks all clients' shards and adapters once; runs the stage on
    the device of the base."""

    def __init__(self, task, cfg, base_params, *, seed: int,
                 lr: float = 3e-3, steps: int = 30, batch_size: int = 16,
                 rho: float = 0.25, n_devices: Optional[int] = None,
                 pad_to: Optional[int] = None):
        if n_devices is not None and int(n_devices) > 1:
            raise NotImplementedError(
                "n_devices > 1 is not ported yet (ROADMAP §1, 'the "
                "multi-GPU clients axis')")
        C = task.n_clients
        n_max = max(cl.n for cl in task.clients)
        L = task.llm_seq_len
        c_pad = max(C, int(pad_to)) if pad_to else C
        tokens = np.full((c_pad, n_max, L), PAD, np.int64)
        labels = np.full((c_pad, n_max, L), -1, np.int64)
        rowmask = np.zeros((c_pad, n_max), np.float32)
        nvalid = np.ones((c_pad,), np.int64)     # clamped: padding → 1
        weights = np.zeros((c_pad,), np.float32)
        for i, cl in enumerate(task.clients):
            tokens[i, :cl.n] = cl.llm_batch["tokens"]
            labels[i, :cl.n] = cl.llm_batch["labels"]
            rowmask[i, :cl.n] = 1.0
            nvalid[i] = cl.n
            weights[i] = task.weights[i]
        self.device = base_params["embed"].device
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        self._tokens, self._labels = to(tokens), to(labels)
        self._rowmask, self._weights = to(rowmask), to(weights)
        self._nvalid = nvalid

        root = llmc.llm_root(seed)
        self._ckeys = [jr.fold_in(root, c) for c in range(c_pad)]
        self._base = base_params
        self.adapters = M.stack_clients([
            M.init_adapters(cfg, llmc.llm_key(root, c, llmc.LLM_INIT_STEP),
                            base_params) for c in range(c_pad)])
        self.opt_state = adamw.init(self.adapters, n_clients=c_pad)
        self.a_g = None
        self._cfg = cfg
        self._n_labels = task.n_classes
        self._n_clients = C
        self._c_pad = c_pad
        self._steps = int(steps)
        self._batch_size = int(batch_size)
        self._rho = float(rho)
        self._step = M.make_train_step(cfg, lr=lr)
        self._n_steps = 0             # global step counter (key contract)

    def _minibatch(self, step: int):
        idx = np.stack([llmc.sample_minibatch_idx(
            jr.fold_in(self._ckeys[c], step), self._nvalid[c],
            self._batch_size) for c in range(self._c_pad)])
        idx = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        rows = torch.arange(self._c_pad, device=self.device)[:, None]
        return {"tokens": self._tokens[rows, idx],
                "labels": self._labels[rows, idx]}

    def run(self) -> LLMRoundResult:
        """Fine-tune all clients, distill toward the FedAvg teacher, and
        evaluate.  Updates the stacked adapter and optimizer state and
        advances the global step counter, so a later refresh continues
        from both."""
        loss = None
        for s in range(self._steps):
            self.adapters, self.opt_state, metrics = self._step(
                self._base, self.adapters, self.opt_state,
                self._minibatch(self._n_steps + s))
            loss = metrics["loss"]
        self._n_steps += self._steps
        # Alg. 1 line 8: FedAvg teacher + distillation blend
        self.a_g = lora_mod.weighted_average_stacked(self.adapters,
                                                     self._weights)
        self.adapters = lora_mod.blend_adapters(self.adapters, self.a_g,
                                                self._rho)
        with torch.no_grad():
            logits, gold = llmc.label_logits(
                self._cfg, self._base, self.adapters, self._tokens,
                self._labels, self._n_labels)
            losses = llmc.masked_label_nll(logits, gold, self._rowmask)
            f1s = llmc.masked_macro_f1(logits, gold, self._rowmask,
                                       self._n_labels)
            teacher = torch.softmax(logits, dim=-1)
        C = self._n_clients
        host = lambda t, dt: t.detach().cpu().numpy().astype(dt)[:C]  # noqa
        last = (host(loss, np.float64) if loss is not None
                else np.full(C, np.nan))
        return LLMRoundResult(losses=host(losses, np.float64),
                              f1=host(f1s, np.float64),
                              teacher=host(teacher, np.float32),
                              final_train_loss=last)

    def teacher_probs_list(self, task, teacher: np.ndarray) -> List:
        """Slice the padded ``(C, Nmax, n_labels)`` teacher stack back into
        the orchestrator's ragged per-client list."""
        return [teacher[i, :cl.n] for i, cl in enumerate(task.clients)]
