"""Batched federated round engine: every client's local phase at once.

The port of ``repro/core/batched_engine.py``.  One round's local
training — all clients, every regulated iteration, the distillation
objective — runs on the engine's device as one batched computation:

  - the circuit tape (``quantum/tape.py``) replayed over every client's
    every candidate point as one ``(C·K·Bmax, 2**n)`` statevector batch,
  - a masked batched optimizer: Nelder–Mead (``optim/batched_nm.py``,
    speculative ``(C, n+3, P)`` candidates + masked branch selection) or
    SPSA (``optim/batched_spsa.py``, ``(C, 2, P)`` perturbation pairs and
    ``(C, 1, P)`` candidates, host-drawn Rademacher signs),
  - the per-client objective F_i + λ·KL(teacher‖student) + µ·prox,
    term for term the JAX package's ``client_objective``.

Padding/mask contract
---------------------
Client shards have ragged sizes, so the engine stacks them once at
construction into dense ``(C, Bmax, …)`` tensors, ``Bmax = max_i n_i``:

  - ``qX``      (C, Bmax, n_qubits)  zero-padded features,
  - ``qy``      (C, Bmax)            zero-padded labels,
  - ``mask``    (C, Bmax)            1.0 on real rows, 0.0 on padding,
  - ``teacher`` (C, Bmax, n_classes) LLM soft labels, uniform on padding.

Every batch reduction is mask-weighted: NLL and KL average as
``Σ mask·term / Σ mask``, so padded rows are evaluated but contribute
nothing.  The denominator is clamped to 1, so an all-padding client
stays finite; for real clients (Σ mask ≥ 1) the clamp is inert.

Per-client ``maxiter`` budgets are iteration masks.  Every evaluation
call of either optimizer is one tape replay of every client's every
candidate row.

Shot-noise key contract
-----------------------
Finite-shot backends (``backend.shots > 0``) sample every evaluation
under the ``backends.py`` derivation
``eval_key(PRNGKey(seed), round, client, slot)``: ``run_round`` takes the
orchestrator's 1-based round index and folds it with each client id into
a ``(C, 2)`` stack of round keys; the batched optimizers name each
candidate's structural slot, and one evaluation call draws the shots of
all its ``(C, K)`` (client, candidate) blocks in one pass, each block's
``(shots, Bmax)`` uniforms under ``fold_in(ckey_c, slot_k)``: the JAX
engine's draws over the padded shard.  Only F_i is sampled; the KL term
reads the raw probabilities.  The keys are derived on the host from host
integers and copied to the device without a synchronisation; or, in the
fused round loop, every slot's key of the round is already on the device
(``eval_slots`` names the columns) and each call takes a slice of them.

Clients axis (``n_devices > 1``)
--------------------------------
The engine cuts its ``(C, …)`` stacks into ``n_devices`` shards
(``distributed/sharding.py``) and runs the local phase of each shard on
its own device, one host thread issuing them in turn; the outputs come
back to the host in client order.  That is safe because the round keeps
the JAX engine's two invariants:

  1. **Clients are independent until aggregation.**  No op of the local
     phase mixes clients; every op is elementwise or batched along the
     client axis, so a shard computes its clients' bits on its own.  A
     shard bounds its loop by its own largest budget (read from the
     host's budgets, no device read): iterations past a budget are
     masked, so the trip count changes no bit.
  2. **Keys follow client position.**  Client ``c``'s round key is
     ``fold_in(fold_in(base, round), c)`` wherever it lands; real clients
     keep ids ``0..C-1`` and padding clients take ``C..c_pad-1`` after
     them.

A client count that does not divide the shards is padded
(``sharding.pad_client_count``) with inert clients: all-zero masks, zero
budgets, uniform teacher rows and SPSA delta rows of ones (valid signs,
as ``1/δ`` is taken every masked iteration); they are sliced off the
outputs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.distributed import sharding as shd
from repro_torch.optim.batched_nm import batched_nm, best_point
from repro_torch.optim.batched_spsa import batched_spsa, make_deltas
from repro_torch.quantum import tape as tape_mod
from repro_torch.quantum.backends import FINAL_EVAL_SLOT

EPS = 1e-9


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def eval_slots(optimizer: str, n_params: int, max_iter: int) -> np.ndarray:
    """Every contract slot one client's local phase can evaluate, in
    ascending order: Nelder–Mead's init rows and ``max_iter`` iterations'
    ``n+3`` candidates, or SPSA's start, ``max_iter`` iterations' three
    evaluations and the final polish."""
    if optimizer == "spsa":
        return np.append(np.arange(1 + 3 * max_iter), FINAL_EVAL_SLOT)
    return np.arange((n_params + 1) + max_iter * (n_params + 3))


def build_local_phase(spec, backend, *, lam: float, mu: float,
                      use_llm: bool, optimizer: str = "nelder-mead",
                      max_iter: int = 100):
    """The round's local-training phase as a function of its inputs.

    Returns ``local_phase(qX, qy, mask, teacher, theta_g, iters, ckeys,
    deltas=None, active=None, n_steps=None) → (x (C, P) float32, n_evals
    (C,) int32)``; every tensor lies on one device, and the phase runs
    there.  ``ckeys`` is the ``(C, 2)`` numpy stack of the clients' round
    keys, or a ``(C, S, 2)`` stack on the device of every slot's key
    (column ``j`` the key of slot ``eval_slots(...)[j]``); inert when the
    backend does not sample.  ``deltas`` (the perturbation signs,
    ``(C, M, P)``) is required for SPSA and ignored by Nelder–Mead.
    ``active`` is the optional ``(C,)`` participation mask (an inactive
    client keeps ``theta_g`` and spends 0 evaluations) and ``n_steps``
    the optimizer's optional static trip count.
    """
    cq = tape_mod.compile_qnn(spec)
    sampling = backend.shots > 0
    slot_cols = eval_slots(optimizer, spec.n_params, int(max_iter))

    def slot_keys(ckeys, slots):
        """The (client, candidate) keys ``fold_in(ckey_c, slot_k)``: a
        slice of a device stack, or folded on the host."""
        if not torch.is_tensor(ckeys):
            return jr.fold_in(ckeys[:, None, :], slots[None, :])
        lo, hi = np.searchsorted(slot_cols, slots[[0, -1]])
        if not np.array_equal(slot_cols[lo:hi + 1], slots):
            raise ValueError(f"slots {slots} are no run of the staged "
                             "slot keys")
        return ckeys[:, lo:hi + 1]

    def client_objectives(xs, qX, qy, mask, teacher, theta_g, keys):
        """F_i + λ·KL + µ·prox for every client c and candidate k:
        xs (C, K, P) → (C, K); ``keys`` (C, K, 2) when sampling."""
        probs = tape_mod.tape_probs(cq, xs, qX[:, None])  # (C, K, B, cls)
        if sampling:
            noisy = backend.transform_probs(probs, keys)
        else:
            noisy = backend.apply_channel(probs)
        m = mask[:, None, :]                               # (C, 1, B)
        m_sum = torch.clamp(mask.sum(-1), min=1.0)[:, None]
        labels = qy.long()[:, None, :, None].expand(*noisy.shape[:-1], 1)
        p = torch.gather(noisy, -1, labels)[..., 0]        # (C, K, B)
        loss = -torch.sum(torch.log(p + EPS) * m, -1) / m_sum
        if use_llm and lam > 0:
            pt = torch.clamp(teacher, EPS, 1.0)[:, None]   # KL on raw probs
            ps = torch.clamp(probs, EPS, 1.0)
            rows = torch.sum(pt * (torch.log(pt) - torch.log(ps)), -1)
            loss = loss + lam * torch.sum(rows * m, -1) / m_sum
        if use_llm and mu > 0:
            loss = loss + mu * torch.mean((xs - theta_g) ** 2, -1)
        return loss

    if optimizer not in ("nelder-mead", "spsa"):
        raise ValueError(f"unknown batched optimizer {optimizer!r}")

    def local_phase(qX, qy, mask, teacher, theta_g, iters, ckeys,
                    deltas=None, active=None, n_steps=None):
        x0 = theta_g[None, :].expand(qX.shape[0], -1)
        if active is not None:
            active = torch.as_tensor(active, dtype=torch.bool,
                                     device=qX.device)

        def f(xs, slots):
            keys = slot_keys(ckeys, slots) if sampling else None
            return client_objectives(xs, qX, qy, mask, teacher, theta_g,
                                     keys)

        if optimizer == "spsa":
            x, _, n_evals = batched_spsa(f, x0, iters, deltas, keyed=True,
                                         active=active, n_steps=n_steps)
        else:
            simplex, fvals, n_evals, _ = batched_nm(
                f, x0, iters, int(max_iter), keyed=True, active=active,
                n_steps=n_steps)
            x, _ = best_point(simplex, fvals)
        if active is not None:
            # an untouched init simplex's best vertex is an offset row,
            # not x0: an inactive client returns its start
            x = torch.where(active[:, None], x, x0)
        return x, n_evals

    return local_phase


class BatchedRoundEngine:
    """Stacks client data once; runs each round's local phase on device.

    ``seeds`` are the clients' SPSA seeds (``make_deltas``); ``seed`` is
    the root of the shot-noise key chain.  The optimizer defaults to
    Nelder–Mead, the port's first (the JAX engine's default is SPSA; the
    orchestrator always names one).  ``n_devices > 1`` cuts the client
    axis into that many shards, placed by ``sharding.client_devices(
    n_devices, device, share_devices=share_devices)``.
    """

    def __init__(self, task, spec, backend, *, lam: float, mu: float,
                 use_llm: bool, teacher_probs: Optional[List] = None,
                 seeds: Sequence[int] = (), max_iter: int = 100,
                 optimizer: str = "nelder-mead", seed: int = 0,
                 n_devices: Optional[int] = None, device="cuda",
                 share_devices: bool = False):
        C = task.n_clients
        n_cls = task.n_classes
        b_max = max(cl.n for cl in task.clients)
        if n_devices is not None and int(n_devices) > 1:
            self.devices = shd.client_devices(int(n_devices), device,
                                              share_devices=share_devices)
        else:
            self.devices = [torch.device(device)]
        c_pad = shd.pad_client_count(C, len(self.devices))
        qX = np.zeros((c_pad, b_max, spec.n_qubits), np.float32)
        qy = np.zeros((c_pad, b_max), np.int64)
        mask = np.zeros((c_pad, b_max), np.float32)
        teacher = np.full((c_pad, b_max, n_cls), 1.0 / n_cls, np.float32)
        for i, cl in enumerate(task.clients):
            qX[i, :cl.n] = cl.qX
            qy[i, :cl.n] = cl.qy
            mask[i, :cl.n] = 1.0
            if teacher_probs is not None and teacher_probs[i] is not None:
                teacher[i, :cl.n] = _numpy(teacher_probs[i])
        self.device = self.devices[0]
        stacks = dict(qX=qX, qy=qy, mask=mask, teacher=teacher)
        self._deltas = None            # NM is deterministic — no draws
        if optimizer == "spsa":
            # float32 signs on the device; padding clients never update
            # (zero budgets) but their rows are read every masked
            # iteration: valid signs, not zeros (0 ⇒ 1/δ = inf)
            deltas = np.ones((c_pad, max_iter, spec.n_params), np.float64)
            deltas[:C] = make_deltas(seeds, max_iter, spec.n_params)
            self._deltas = torch.from_numpy(deltas.astype(np.float32)).to(
                self.device)
            stacks["deltas"] = self._deltas
        # one dict of stacks a shard, on its device
        self._shards = shd.put_client_stacks(self.devices, stacks, c_pad)
        self._bounds = shd.shard_bounds(c_pad, len(self.devices))
        # sequential-path evals spent before the metered run: spsa_init
        # does 1, nm_init does n+1 (the initial simplex)
        self.init_evals = 1 if optimizer == "spsa" else spec.n_params + 1
        # shot-noise key chain root: fold_in(round)/fold_in(client) happen
        # per run_round, fold_in(slot) a candidate in the optimizers
        self._base_key = jr.PRNGKey(seed)
        self._n_clients = C
        self._c_pad = c_pad
        self._max_iter = int(max_iter)
        self._local = build_local_phase(spec, backend, lam=lam, mu=mu,
                                        use_llm=use_llm, optimizer=optimizer,
                                        max_iter=max_iter)

    def run_round(self, theta_g: np.ndarray, maxiters: Sequence[int],
                  round_idx: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """One local-training phase for all clients.

        ``round_idx`` is the orchestrator's 1-based round counter, the
        ``round`` stage of the key-derivation contract.  Returns
        (thetas (C, P) float64, n_evals (C,) int64): the trained
        per-client parameters and the sequential-equivalent evaluation
        counts (``init_evals`` + the branch-dependent spend).  Every
        shard's phase is issued before any is read back, so shards on
        different cards overlap; padding rows (zero budgets, key ids
        ``C..c_pad-1``) are sliced off.
        """
        theta = np.asarray(_numpy(theta_g), np.float32)
        iters = np.zeros((self._c_pad,), np.int32)
        iters[:self._n_clients] = np.asarray(maxiters, np.int32)
        ckeys = jr.fold_in(jr.fold_in(self._base_key, round_idx),
                           np.arange(self._c_pad))
        outs = []
        for dev, st, (lo, hi) in zip(self.devices, self._shards,
                                     self._bounds):
            with shd.on_device(dev):
                outs.append(self._local(
                    st["qX"], st["qy"], st["mask"], st["teacher"],
                    torch.from_numpy(theta).to(dev),
                    torch.from_numpy(iters[lo:hi]).to(dev), ckeys[lo:hi],
                    deltas=st.get("deltas"),
                    n_steps=min(int(iters[lo:hi].max()), self._max_iter)))
        C = self._n_clients
        x = np.concatenate([_numpy(x) for x, _ in outs])[:C]
        n_evals = np.concatenate([_numpy(n) for _, n in outs])[:C]
        return x.astype(np.float64), n_evals.astype(np.int64)
