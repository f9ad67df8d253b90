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

Clients axis (``n_devices > 1``): the stacks, adapters and AdamW states
are cut into shards along the client axis (padded with inert clients to
a multiple of the shards, ``sharding.pad_client_count``), the frozen
base is placed whole on every shard's device, and each train step and
evaluation runs shard by shard.  The one cross-client step, the FedAvg
teacher ``a_g``, runs on the lead device over the gathered ``(c_pad, …)``
stack in the one-device formula, and ``a_g`` goes back to every shard
for the blend.  A sharded stage is bitwise a one-device stage with
``pad_to=c_pad`` wherever a client's step does not depend on the
clients beside it: on the CPU, and on the card unless a kernel splits a
small grid's reduction by the launch's client count (``lora_matmul``,
and ``int4_matmul`` on a QLoRA base, plan the split from the whole
grid).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import llm_client as llmc
from repro_torch.data.tokenizer import PAD
from repro_torch.distributed import sharding as shd
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
    the device of the base, or over ``n_devices`` shards placed by
    ``sharding.client_devices(n_devices, base device,
    share_devices=share_devices)``, the base's device the lead."""

    def __init__(self, task, cfg, base_params, *, seed: int,
                 lr: float = 3e-3, steps: int = 30, batch_size: int = 16,
                 rho: float = 0.25, n_devices: Optional[int] = None,
                 pad_to: Optional[int] = None, share_devices: bool = False):
        C = task.n_clients
        n_max = max(cl.n for cl in task.clients)
        L = task.llm_seq_len
        c_pad = max(C, int(pad_to)) if pad_to else C
        lead = base_params["embed"].device
        if n_devices is not None and int(n_devices) > 1:
            self.devices = shd.client_devices(int(n_devices), lead,
                                              share_devices=share_devices)
        else:
            self.devices = [lead]
        c_pad = shd.pad_client_count(c_pad, len(self.devices))
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
        self.device = self.devices[0]
        self._stacks = shd.put_client_stacks(
            self.devices, dict(tokens=tokens, labels=labels,
                               rowmask=rowmask), c_pad)
        self._bounds = shd.shard_bounds(c_pad, len(self.devices))
        self._weights = torch.from_numpy(weights).to(self.device)
        self._nvalid = nvalid

        root = llmc.llm_root(seed)
        self._ckeys = [jr.fold_in(root, c) for c in range(c_pad)]
        # the frozen base whole on every shard's device, never cut
        self.base = base_params
        self._bases = shd.put_replicated(self.devices, base_params)
        self._c_pad = c_pad
        adapters = M.stack_clients([
            M.init_adapters(cfg, llmc.llm_key(root, c, llmc.LLM_INIT_STEP),
                            base_params) for c in range(c_pad)])
        self.adapters = adapters
        self.opt_state = adamw.init(adapters, n_clients=c_pad)
        self.a_g = None
        self._cfg = cfg
        self._n_labels = task.n_classes
        self._n_clients = C
        self._steps = int(steps)
        self._batch_size = int(batch_size)
        self._rho = float(rho)
        self._step = M.make_train_step(cfg, n_microbatches=1, lr=lr,
                                       opts=M.FwdOptions(remat=False))
        self._n_steps = 0             # global step counter (key contract)

    # the client-stacked state, cut into shards; read whole on the lead
    @property
    def adapters(self):
        return shd.gather_clients(self._adapters)

    @adapters.setter
    def adapters(self, tree):
        self._adapters = shd.put_client_tree(self.devices, tree, self._c_pad)

    @property
    def opt_state(self):
        return shd.gather_clients(self._opt)

    @opt_state.setter
    def opt_state(self, state):
        self._opt = shd.put_client_tree(self.devices, state, self._c_pad)

    def _minibatch(self, step: int) -> list:
        """Each shard's minibatch of global step ``step``, drawn by
        global client id."""
        idx = np.stack([llmc.sample_minibatch_idx(
            jr.fold_in(self._ckeys[c], step), self._nvalid[c],
            self._batch_size) for c in range(self._c_pad)])
        out = []
        for dev, st, (lo, hi) in zip(self.devices, self._stacks,
                                     self._bounds):
            i = torch.from_numpy(idx[lo:hi].astype(np.int64)).to(dev)
            rows = torch.arange(hi - lo, device=dev)[:, None]
            out.append({"tokens": st["tokens"][rows, i],
                        "labels": st["labels"][rows, i]})
        return out

    def run(self) -> LLMRoundResult:
        """Fine-tune all clients, distill toward the FedAvg teacher, and
        evaluate.  Updates the stacked adapter and optimizer state and
        advances the global step counter, so a later refresh continues
        from both.  Each step is issued shard by shard before the next,
        and nothing is read back before the end."""
        shards = range(len(self.devices))
        loss = [None] * len(self.devices)
        for s in range(self._steps):
            batches = self._minibatch(self._n_steps + s)
            for k in shards:
                with shd.on_device(self.devices[k]):
                    self._adapters[k], self._opt[k], metrics = self._step(
                        self._bases[k], self._adapters[k], self._opt[k],
                        batches[k])
                loss[k] = metrics["loss"]
        self._n_steps += self._steps
        # Alg. 1 line 8: the FedAvg teacher on the lead over every client,
        # then the distillation blend on every shard
        self.a_g = lora_mod.weighted_average_stacked(
            shd.gather_clients(self._adapters), self._weights)
        a_g = shd.put_replicated(self.devices, self.a_g)
        evals = []
        for k in shards:
            st = self._stacks[k]
            with shd.on_device(self.devices[k]), torch.no_grad():
                self._adapters[k] = lora_mod.blend_adapters(
                    self._adapters[k], a_g[k], self._rho)
                logits, gold = llmc.label_logits(
                    self._cfg, self._bases[k], self._adapters[k],
                    st["tokens"], st["labels"], self._n_labels)
                evals.append((
                    llmc.masked_label_nll(logits, gold, st["rowmask"]),
                    llmc.masked_macro_f1(logits, gold, st["rowmask"],
                                         self._n_labels),
                    torch.softmax(logits, dim=-1)))
        C = self._n_clients

        def host(parts, dt):
            return np.concatenate([t.detach().cpu().numpy() for t in parts]
                                  ).astype(dt)[:C]

        last = (host(loss, np.float64) if self._steps
                else np.full(C, np.nan))
        losses, f1s, teacher = zip(*evals)
        return LLMRoundResult(losses=host(losses, np.float64),
                              f1=host(f1s, np.float64),
                              teacher=host(teacher, np.float32),
                              final_train_loss=last)

    def teacher_probs_list(self, task, teacher: np.ndarray) -> List:
        """Slice the padded ``(C, Nmax, n_labels)`` teacher stack back into
        the orchestrator's ragged per-client list."""
        return [teacher[i, :cl.n] for i, cl in enumerate(task.clients)]
