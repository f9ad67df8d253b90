"""Algorithm 1 — the LLM-QFL federated orchestrator, on a torch device.

The port of ``repro/core/orchestrator.py``.  Per round (T total):
broadcast θ_g → [regulate maxiter → local gradient-free training on
F_i + λ·KL + µ·prox] per device → alignment selection → weighted
aggregation → server eval → termination check.  Communication time is
accounted through the quantum backend's latency model (Table I).

The port runs ``method="qfl"`` and ``method="llm-qfl"`` with
``engine="sequential"`` (the default) or ``"batched"``,
``optimizer="nelder-mead"`` (the default) or ``"spsa"``, and
``rounds="host"`` (the default) or, on the batched engine,
``rounds="fused"``: every round on the device with no host read until
the run ends (``core/fused_rounds.py``; on the card a captured CUDA
graph a round), with the population options ``c_round`` and
``dropout``.  On the batched engine ``n_devices > 1`` cuts the client
axis into that many shards, one a card (``distributed/sharding.py``;
``share_devices=True`` puts them all on one card, to test the sharded
path there).  For ``llm-qfl``, Step 1 fine-tunes every client's LoRA
adapters on a frozen float32 base in round 1 — one client at a time
(``core/llm_client.run_sequential_stage``) or all at once
(``core/batched_llm.py``); its teacher soft labels feed the quantum
objective's KL term and its losses L_LLM the optimizer regulation, and
the alignment selection picks the clients to aggregate.

The sequential engine trains one client at a time with the host
optimizers of ``optim/gradfree.py`` on the eager circuit
(``quantum/qnn.make_forward``), every objective evaluation read back to
the host; the batched engine runs every client's local phase as one
batched computation on the device (``core/batched_engine.py``) over the
compiled tape.  The round's control laws run on the host exactly as in
the JAX package: θ_g and the aggregation are float64 numpy, cast to
float32 at the device boundary.  Every option of ``RunConfig`` runs;
an invalid combination raises the JAX package's ``ValueError``.

On finite-shot backends (``fake``, ``aersim``, ``real``) every
evaluation (optimizer objectives, the per-round client-loss reports,
the server's loss and accuracies) draws its shots under the
``backends.py`` contract ``eval_key(PRNGKey(seed), round, client,
slot)``: optimizer evaluations use client ids ``0..C-1`` with the slot
schedule of ``gradfree`` (sequential) or the batched optimizers,
reports ``REPORT_EVAL_SLOT`` on the client's stream, and the server the
reserved ``SERVER_CLIENT``.  Both engines share the derivation, as in
the JAX package.

The device is ``"cuda"`` unless the caller asks for another; there is
no silent fallback to the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace as dc_replace
from typing import List, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import distill, regulation, selection
from repro_torch.core.batched_engine import BatchedRoundEngine
from repro_torch.core.batched_llm import BatchedLLMEngine
from repro_torch.core.fused_rounds import FusedRoundDriver
from repro_torch.core.llm_client import run_sequential_stage, task_llm_config
from repro_torch.core.termination import TerminationCriterion
from repro_torch.data.tasks import FederatedTask
from repro_torch.device import resolve_device  # noqa: F401  (re-export)
from repro_torch.models import model as M
from repro_torch.optim.gradfree import GradFreeOptimizer
from repro_torch.quantum import backends as backend_mod
from repro_torch.quantum import qnn
from repro_torch.quantum import tape as tape_mod


@dataclass
class RunConfig:
    method: str = "llm-qfl"            # "qfl" | "llm-qfl"
    select_frac: float = 1.0           # 1.0 = all; 0.1 = top-10% aligned
    regulation: str = "adaptive"       # App. F variant
    maxiter0: int = 10
    maxiter_cap: int = 100
    n_rounds: int = 10
    epsilon: float = 1e-3
    lam: float = 0.1                   # λ distillation weight (Eq. 6)
    mu: float = 0.01                   # µ prox weight (Eq. 6)
    optimizer: str = "nelder-mead"     # | "spsa"
    engine: str = "sequential"         # | "batched"
    rounds: str = "host"               # | "fused"
    c_round: Optional[int] = None      # fused-only: per-round cohort size
    dropout: float = 0.0               # fused-only: client dropout prob.
    n_devices: Optional[int] = None    # 'clients' axis width
    backend: str = "exact"
    shots_override: Optional[int] = None   # replace the backend's shots
    n_qubits: int = 4                  # must match the task's feature dim
    llm_name: str = "tiny-llm"
    llm_steps: int = 30
    llm_lr: float = 3e-3
    distill_rho: float = 0.25
    qnn_kind: str = ""                 # "" → vqc for 2-class, qcnn for 3
    early_stop: bool = True
    seed: int = 0

    @property
    def uses_llm(self) -> bool:
        return self.method == "llm-qfl"


@dataclass
class RoundRecord:
    t: int
    maxiters: List[int]
    ratios: List[float]
    client_losses: List[float]
    selected: List[int]
    server_loss: float
    server_val_acc: float
    server_test_acc: float
    comm_time_s: float
    cum_evals: List[int]
    var_all: float = 0.0
    var_selected: float = 0.0


@dataclass
class RunResult:
    config: RunConfig
    rounds: List[RoundRecord] = field(default_factory=list)
    llm_losses: List[float] = field(default_factory=list)
    llm_f1: List[float] = field(default_factory=list)
    llm_finetune_time_s: float = 0.0
    theta_g: Optional[np.ndarray] = None
    terminated_early: bool = False

    def series(self, attr: str):
        return [getattr(r, attr) for r in self.rounds]


@dataclass
class LLMOutputs:
    """Step 1's outputs, as the quantum rounds consume them: per-client
    L_LLM, macro-F1 and teacher soft labels ``(n_i, n_classes)``."""
    losses: List[float]
    f1: List[float]
    teacher_probs: List[np.ndarray]


class Orchestrator:
    """One federated run.  ``llm_outputs`` installs Step 1's outputs from
    another run (the card's, or the JAX package's) in place of this run's
    fine-tuning, so the quantum rounds can be compared on equal inputs;
    the key stream advances as if the stage had run.  After Step 1,
    ``self.llm_outputs`` holds the outputs the rounds consumed.
    ``share_devices`` puts the ``n_devices`` shards on ``device`` itself
    (``sharding.client_devices``)."""

    def __init__(self, task: FederatedTask, rc: RunConfig, device=None,
                 llm_outputs: Optional[LLMOutputs] = None,
                 share_devices: bool = False):
        self.task = task
        self.rc = rc
        self._llm_outputs = llm_outputs
        self._share_devices = bool(share_devices)
        if rc.engine not in ("sequential", "batched"):
            raise ValueError(f"unknown engine {rc.engine!r}")
        if rc.rounds not in ("host", "fused"):
            raise ValueError(f"unknown rounds mode {rc.rounds!r}; "
                             "'host' or 'fused'")
        if rc.rounds == "fused" and rc.engine != "batched":
            raise ValueError(
                "rounds='fused' runs the whole loop as one device "
                "program and needs the batched local phase; use "
                "engine='batched'")
        if rc.rounds != "fused" and (rc.c_round is not None
                                     or rc.dropout != 0.0):
            raise ValueError(
                "c_round / dropout are population semantics of the "
                "fused round loop; set rounds='fused'")
        if rc.n_devices is not None and rc.n_devices > 1 \
                and rc.engine != "batched":
            raise ValueError(
                "n_devices > 1 shards the batched engine's client axis; "
                "the sequential engine is single-device — use "
                "engine='batched'")
        if rc.method not in ("qfl", "llm-qfl"):
            raise ValueError(f"unknown method {rc.method!r}")
        if rc.optimizer not in ("nelder-mead", "spsa"):
            raise ValueError(f"unknown optimizer {rc.optimizer!r}")
        kind = rc.qnn_kind or ("vqc" if task.n_classes == 2 else "qcnn")
        feat_dim = int(task.clients[0].qX.shape[1])
        if feat_dim != rc.n_qubits:
            raise ValueError(
                f"n_qubits={rc.n_qubits} but the task encodes "
                f"{feat_dim}-dim features (build_task(n_features=...))")
        self.spec = qnn.QNNSpec(kind, n_qubits=rc.n_qubits,
                                n_classes=task.n_classes)
        self.backend = backend_mod.get(rc.backend)
        if rc.shots_override is not None:
            if rc.shots_override < 0:
                raise ValueError("shots_override must be >= 0")
            self.backend = dc_replace(self.backend,
                                      shots=int(rc.shots_override))
        # root of the shot-noise key chain (fold_in round/client/slot);
        # distinct from the split-based init-param stream below
        self._noise_base = jr.PRNGKey(rc.seed)
        self.device = resolve_device(device)
        if rc.engine == "batched":
            # the compiled tape: the same math as the eager circuit (≤1e-6)
            self.fwd = tape_mod.make_tape_forward(self.spec, self.device)
        else:
            self.fwd = qnn.make_forward(self.spec, self.device)
        self._key = jr.PRNGKey(rc.seed)
        self._engine = None
        self._on_device = {}

    # -- helpers -------------------------------------------------------------
    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Task arrays are moved to the device once and reused."""
        key = id(a)
        if key not in self._on_device:
            self._on_device[key] = (a, torch.as_tensor(a).to(self.device))
        return self._on_device[key][1]

    def _measure_probs(self, theta: np.ndarray, X, key) -> torch.Tensor:
        """Forward + the backend's full measurement (channel, keyed
        sampling)."""
        theta = torch.as_tensor(np.asarray(theta, np.float32))
        return self.backend.transform_probs(self.fwd(theta, self._put(X)),
                                            key)

    def _nll(self, theta: np.ndarray, X, y, key=None) -> float:
        return float(qnn.nll_loss(self._measure_probs(theta, X, key),
                                  self._put(y)))

    def _acc(self, theta: np.ndarray, X, y, key=None) -> float:
        # measured through the backend like the loss: the noisy-against-
        # exact accuracy ordering of Table I is observed, not assumed
        return float(qnn.accuracy(self._measure_probs(theta, X, key),
                                  self._put(y)))

    def _mkey(self, t: int, client: int, slot: int):
        """Measurement key of a report or server evaluation; None when
        the backend does not sample."""
        if not self.backend.shots:
            return None
        return backend_mod.eval_key(self._noise_base, t, client, slot)

    def _eval_stream(self, t: int, client: int):
        """slot → key for client ``client``'s optimizer in round ``t``
        (the sequential form of the contract); None when exact."""
        if not self.backend.shots:
            return None
        base = jr.fold_in(jr.fold_in(self._noise_base, t), client)
        return lambda slot: jr.fold_in(base, slot)

    def _client_loss_fn(self, i: int):
        """Client i's objective for the sequential engine: θ (numpy) →
        float, F_i alone for QFL, F_i + λ·KL + µ·prox for LLM-QFL; keyed,
        ``fn(θ, key)``, when the backend samples."""
        c = self.task.clients[i]
        X, y = self._put(c.qX), self._put(c.qy)
        keyed = self.backend.shots > 0
        base = qnn.make_loss_fn(self.spec, X, y, backend=self.backend)
        if not self.rc.uses_llm:
            if keyed:
                return lambda th, key: float(base(th, key))
            return lambda th: float(base(th))
        return distill.make_client_objective(
            base, self.fwd, X, self._put(self._teacher_probs[i]),
            self._theta_g, lam=self.rc.lam, mu=self.rc.mu, keyed=keyed)

    # -- Step 1: LLM fine-tuning (round 1 only) -------------------------------
    def _llm_round(self) -> float:
        """Fine-tune every client's LoRA adapters, distill toward the
        FedAvg teacher, and collect the regulation losses and soft
        labels.  The base is drawn in float32 on the run's device from
        the run key's next split."""
        rc, task = self.rc, self.task
        t0 = time.perf_counter()
        cfg = task_llm_config(rc.llm_name, task.vocab_size, task.llm_seq_len)
        keys = jr.split(self._key)
        self._key, k0 = keys[0], keys[1]
        if self._llm_outputs is not None:
            self.llm_outputs = out = self._llm_outputs
            self._llm_losses = [float(x) for x in out.losses]
            self._llm_f1 = [float(x) for x in out.f1]
            self._teacher_probs = [np.array(t, np.float32)
                                   for t in out.teacher_probs]
            return 0.0
        base = M.init_params(cfg, k0, dtype=torch.float32,
                             device=self.device)
        if rc.engine == "batched":
            self.llm_clients = None     # per-client wrappers exist only
                                        # on the sequential path
            self.llm_engine = BatchedLLMEngine(
                task, cfg, base, seed=rc.seed, lr=rc.llm_lr,
                steps=rc.llm_steps, rho=rc.distill_rho,
                n_devices=rc.n_devices, share_devices=self._share_devices)
            out = self.llm_engine.run()
            self._llm_losses = [float(x) for x in out.losses]
            self._llm_f1 = [float(x) for x in out.f1]
            self._teacher_probs = self.llm_engine.teacher_probs_list(
                task, out.teacher)
        else:
            (self.llm_clients, self._llm_losses, self._llm_f1,
             teachers) = run_sequential_stage(
                task, cfg, base, seed=rc.seed, lr=rc.llm_lr,
                steps=rc.llm_steps, rho=rc.distill_rho)
            self._teacher_probs = [t.cpu().numpy() for t in teachers]
        self.llm_outputs = LLMOutputs(self._llm_losses, self._llm_f1,
                                      self._teacher_probs)
        # the host reads of the stage's outputs synchronise with the device
        return time.perf_counter() - t0

    # -- main loop -------------------------------------------------------------
    def run(self) -> RunResult:
        rc, task = self.rc, self.task
        res = RunResult(config=rc)

        keys = jr.split(self._key)
        self._key, k = keys[0], keys[1]
        self._theta_g = self.spec.init_params(k).numpy().astype(np.float64)

        if rc.uses_llm:
            res.llm_finetune_time_s = self._llm_round()
            res.llm_losses = list(self._llm_losses)
            res.llm_f1 = list(self._llm_f1)
        else:
            self._teacher_probs = None

        if rc.rounds == "fused":
            return self._run_fused(res)

        if rc.engine == "batched":
            self._engine = BatchedRoundEngine(
                task, self.spec, self.backend, lam=rc.lam, mu=rc.mu,
                use_llm=rc.uses_llm, teacher_probs=self._teacher_probs,
                seeds=[rc.seed * 997 + i for i in range(task.n_clients)],
                max_iter=max(rc.maxiter_cap, rc.maxiter0),
                optimizer=rc.optimizer, seed=rc.seed,
                n_devices=rc.n_devices, device=self.device,
                share_devices=self._share_devices)

        maxiters = [rc.maxiter0] * task.n_clients
        last_losses = [float("inf")] * task.n_clients
        cum_evals = [0] * task.n_clients
        term = TerminationCriterion(epsilon=rc.epsilon, t_max=rc.n_rounds)

        self.round_seconds = []          # host wall time of each round
        for t in range(1, rc.n_rounds + 1):
            t0 = time.perf_counter()
            ratios = [1.0] * task.n_clients
            # Step 2: regulation (Alg. 1 lines 11–17; only after round 1)
            if rc.uses_llm and t > 1:
                for i in range(task.n_clients):
                    llm_l = self._llm_losses[i]
                    if np.isfinite(last_losses[i]) and llm_l > 0:
                        ratios[i] = last_losses[i] / llm_l
                    maxiters[i] = regulation.regulate(
                        maxiters[i], last_losses[i], llm_l,
                        variant=rc.regulation, cap=rc.maxiter_cap)

            # local training: one batched program (batched) or the
            # per-client sequential reference
            thetas, losses, comm_t = [], [], 0.0
            if self._engine is not None:
                th_stack, n_evals = self._engine.run_round(self._theta_g,
                                                           maxiters, t)
                for i in range(task.n_clients):
                    cl = task.clients[i]
                    thetas.append(th_stack[i])
                    # report pure F_i (no penalty) as the device loss
                    losses.append(self._nll(
                        th_stack[i], cl.qX, cl.qy,
                        key=self._mkey(t, i, backend_mod.REPORT_EVAL_SLOT)))
                    cum_evals[i] += int(n_evals[i])
                    # metered-run evals only — init is not comm-billed
                    comm_t = max(comm_t, self.backend.eval_time(cl.n)
                                 * (int(n_evals[i])
                                    - self._engine.init_evals))
            else:
                for i in range(task.n_clients):
                    cl = task.clients[i]
                    opt = GradFreeOptimizer(self._client_loss_fn(i),
                                            self._theta_g,
                                            method=rc.optimizer,
                                            seed=rc.seed * 997 + i,
                                            key_stream=self._eval_stream(
                                                t, i))
                    n0 = opt.n_evals
                    th, _ = opt.run(maxiters[i])
                    thetas.append(np.asarray(th, np.float64))
                    # report pure F_i (no penalty) as the device loss
                    losses.append(self._nll(
                        th, cl.qX, cl.qy,
                        key=self._mkey(t, i, backend_mod.REPORT_EVAL_SLOT)))
                    cum_evals[i] += opt.n_evals
                    comm_t = max(comm_t, self.backend.eval_time(cl.n)
                                 * (opt.n_evals - n0))
            last_losses = list(losses)

            # server loss of the current global model (pre-aggregation)
            server_loss_pre = self._nll(
                self._theta_g, task.val_qX, task.val_qy,
                key=self._mkey(t, backend_mod.SERVER_CLIENT,
                               backend_mod.SERVER_SLOT_LOSS_PRE))

            # client selection (Sec. III-B)
            if rc.uses_llm and rc.select_frac < 1.0:
                sel = selection.select_aligned(losses, server_loss_pre,
                                               rc.select_frac)
            else:
                sel = list(range(task.n_clients))
            var = selection.selection_variance(losses, server_loss_pre, sel)

            # aggregation (Eq. 3) over the selected set, float64 on host
            w = np.asarray([task.weights[i] for i in sel])
            w = w / w.sum()
            self._theta_g = sum(wi * thetas[i] for wi, i in zip(w, sel))

            server_loss = self._nll(
                self._theta_g, task.val_qX, task.val_qy,
                key=self._mkey(t, backend_mod.SERVER_CLIENT,
                               backend_mod.SERVER_SLOT_LOSS_POST))
            rec = RoundRecord(
                t=t, maxiters=list(maxiters), ratios=ratios,
                client_losses=losses, selected=sel,
                server_loss=server_loss,
                server_val_acc=self._acc(
                    self._theta_g, task.val_qX, task.val_qy,
                    key=self._mkey(t, backend_mod.SERVER_CLIENT,
                                   backend_mod.SERVER_SLOT_VAL_ACC)),
                server_test_acc=self._acc(
                    self._theta_g, task.test_qX, task.test_qy,
                    key=self._mkey(t, backend_mod.SERVER_CLIENT,
                                   backend_mod.SERVER_SLOT_TEST_ACC)),
                comm_time_s=comm_t, cum_evals=list(cum_evals),
                var_all=var["var_all"], var_selected=var["var_selected"])
            res.rounds.append(rec)
            # the float() reads above synchronise with the device
            self.round_seconds.append(time.perf_counter() - t0)

            if term.update(server_loss, t) and rc.early_stop:
                res.terminated_early = t < rc.n_rounds
                break

        res.theta_g = self._theta_g
        return res

    def _run_fused(self, res: RunResult) -> RunResult:
        """Run the rounds with ``core/fused_rounds.FusedRoundDriver`` and
        unpack its outputs into the ``RoundRecord`` stream of the host
        loop.  Per-client fields are population-sized: in a round a
        client sat out, its loss is NaN and its ratio 1.0, and its budget
        and evaluation count carry forward.  ``self.fused_driver`` keeps
        the driver, ``self.fused_output`` its ``FusedRunOutput`` and
        ``self.fused_seconds`` the run's host wall time (its one
        read-back synchronises with the device)."""
        rc, task = self.rc, self.task
        driver = FusedRoundDriver(
            task, self.spec, self.backend, optimizer=rc.optimizer,
            seed=rc.seed, lam=rc.lam, mu=rc.mu, use_llm=rc.uses_llm,
            teacher_probs=self._teacher_probs if rc.uses_llm else None,
            llm_losses=self._llm_losses if rc.uses_llm else None,
            maxiter0=rc.maxiter0, maxiter_cap=rc.maxiter_cap,
            regulation=rc.regulation, select_frac=rc.select_frac,
            epsilon=rc.epsilon, n_rounds=rc.n_rounds,
            early_stop=rc.early_stop, c_round=rc.c_round,
            dropout=rc.dropout, n_devices=rc.n_devices, device=self.device,
            share_devices=self._share_devices)
        self.fused_driver = driver
        t0 = time.perf_counter()
        self.fused_output = out = driver.run(self._theta_g)
        self.fused_seconds = time.perf_counter() - t0
        C = task.n_clients
        for r in range(rc.n_rounds):
            if not out.active[r]:
                break
            t = r + 1
            cohort = out.cohort[r]
            losses = np.full(C, np.nan)
            losses[cohort] = out.losses[r]
            ratios = np.ones(C)
            ratios[cohort] = out.ratios[r]
            sel = sorted(int(c) for c in cohort[out.selected[r]])
            var = selection.selection_variance(
                losses.tolist(), float(out.server_loss_pre[r]), sel)
            res.rounds.append(RoundRecord(
                t=t, maxiters=out.budgets[r].tolist(),
                ratios=ratios.tolist(), client_losses=losses.tolist(),
                selected=sel, server_loss=float(out.server_loss[r]),
                server_val_acc=float(out.val_acc[r]),
                server_test_acc=float(out.test_acc[r]),
                comm_time_s=float(out.comm_time_s[r]),
                cum_evals=out.cum_evals[r].tolist(),
                var_all=var["var_all"], var_selected=var["var_selected"]))
            if out.stop[r] and rc.early_stop:
                res.terminated_early = t < rc.n_rounds
                break
        self._theta_g = out.theta_g
        res.theta_g = self._theta_g
        return res


def run_experiment(task: FederatedTask, device=None,
                   llm_outputs: Optional[LLMOutputs] = None,
                   share_devices: bool = False, **overrides) -> RunResult:
    return Orchestrator(task, RunConfig(**overrides), device=device,
                        llm_outputs=llm_outputs,
                        share_devices=share_devices).run()
