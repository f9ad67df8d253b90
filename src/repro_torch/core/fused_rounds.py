"""Fused multi-round federation driver: R rounds on the device, read once.

The port of ``repro/core/fused_rounds.py``.  The host orchestrator
(``core/orchestrator.py``) leaves the device every round for FedAvg,
regulation, selection, termination and one loss report a client; at the
quickstart's sizes that round trip, not the circuit, keeps the card idle
most of the time.  Here the whole round, those steps included, is device
work on tensors that never leave the device until the run ends:

    carry = (θ_g, budgets, last_losses, cum_evals,
             prev_server_loss, small_count, done_flag)

with every host step replaced by a twin of the module it mirrors:

  - **FedAvg**: the host loop's formula (``w / Σw``, then a sequential
    sum of ``w_c · θ_c`` over the selected clients), in **float64** on
    the device; θ_g is carried in float64 and cast to float32 where the
    host loop casts it (the local phase and the server evaluations).
    The JAX package's fused program aggregates in float32 and misses its
    own host loop on one pinned seed; the port's fused loop is held to
    the port's host loop at that loop's tolerances, and float64 is how
    it meets them.
  - **Regulation** (``regulate_batched``), the **selection distances**
    and **termination** (``termination_step``) likewise compute in
    float64, as the host's Python floats do, so budgets, selected sets
    and the stopping round equal the host loop's exactly.  The reports
    and server metrics stay float32, as in the JAX package.
  - **Selection**: ``select_topk_mask``, the mask form of
    ``selection.select_aligned`` (stable ties, non-finite distances
    last).
  - **Termination**: the ``done`` flag masks every carry update of the
    rounds after the stop, so an early-terminated run's state is the
    state of a run that stopped there.
  - **Reporting**: the clients' losses at ``REPORT_EVAL_SLOT`` in one
    batched evaluation inside the round (the host loop reads one a
    client).

Nothing in a round depends on a value read back: every key of a run is
a function of ``(seed, round, client, slot)``, and so are the cohorts
and dropout coins of population mode, so the driver derives them all on
the host before the run (``repro_torch.random``; the cohort draw is
``jax.random.choice``'s own, bit for bit) and stages them on the device
once.  The batched optimizers run a static trip count of ``max_iter``
iterations (iterations past a client's budget are masked, so the bits
are those of the host loop's ``max(iters)`` trips); the selection size
with dropout is the JAX program's float32 ``round(frac · n_eligible)``,
computed on the host from the staged coins.

On the card one round's body is captured as a CUDA graph
(``torch.cuda.graph``) that reads the round index from a device scalar
and its keys and cohort from the staged tables, and a run replays it R
times with no synchronisation in between; the outputs come back in one
read.  One round a graph, not the whole run: a Nelder–Mead round at the
LLM-QFL cap of 100 iterations holds about 10,000 nodes, 30,000 on a
finite-shot backend, and R rounds would multiply that.  The kernels are
built and the tape kernel's gate columns checked by one eager round on
the card before the capture; a capture that fails raises.  Captured
programs are cached by the static configuration and the input shapes
(``get_fused_program``), so a second driver of the same shapes replays
the first one's graph on its own data.  On the CPU the same body runs
eagerly, a round a call.

Population semantics: per round ``t`` a cohort of ``c_round`` distinct
client ids is drawn from the reserved ``POP_CLIENT`` stream
(``eval_key(base, t, POP_CLIENT, POP_SLOT_COHORT)``), its rows are
gathered from the ``(C_pop, …)`` stacks, and budgets, last losses and
evaluation counts are scattered back; ``dropout`` drops each cohort
member by a coin on its own stream (``DROPOUT_EVAL_SLOT``).  Dropped and
outside-cohort clients are untouched: their carries keep their values
and they spend 0 evaluations (the batched optimizers' ``active`` mask).
``run_host_reference`` is the per-round host loop of the same semantics,
the oracle the fused run is held to.

Clients axis (``n_devices > 1``, ``distributed/sharding.py``): under
full participation the client stacks are padded with inert clients to a
multiple of the shards (never eligible; the results drop them) and cut
into shards; in population mode every shard's device holds the whole
population, as the JAX package replicates it, and the round's cohort
is what is cut (``c_round`` must divide the shards).  Each shard runs
its local phase and report on its device; the lead (shard 0's device)
does regulation before them and selection, float64 FedAvg, the server
evaluations, termination and the scatter after them, so the carries
live on the lead.  On one device the round stays one graph; across
devices each stage is a graph on its device and the exchanges between
them are copies ordered on the streams (``_FusedProgram``).
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import regulation as regulation_mod
from repro_torch.core.batched_engine import (EPS, _numpy, build_local_phase,
                                             eval_slots)
from repro_torch.core.termination import TerminationCriterion
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import statevector_gates as svg
from repro_torch.kernels import statevector_tape as svt
from repro_torch.optim.batched_spsa import make_deltas
from repro_torch.quantum import backends as backend_mod
from repro_torch.quantum import qnn, tape as tape_mod

_FUSED_CACHE: Dict[tuple, "_FusedProgram"] = {}
_SERVER_SLOTS = (backend_mod.SERVER_SLOT_LOSS_PRE,
                 backend_mod.SERVER_SLOT_LOSS_POST,
                 backend_mod.SERVER_SLOT_VAL_ACC,
                 backend_mod.SERVER_SLOT_TEST_ACC)


# ---------------------------------------------------------------------------
# twins of the host-side round steps
# ---------------------------------------------------------------------------
def regulate_batched(maxiter, qnn_loss, llm_loss, *, variant: str = "adaptive",
                     cap: int = 100, min_iter: int = 1, weight: float = 0.5,
                     increment: int = 2) -> torch.Tensor:
    """``regulation.regulate`` elementwise over ``(C,)`` stacks: the same
    guard ladder, formulas (float64, as the host's Python floats) and
    round-half-to-even, the same ``[min_iter, cap]`` clamp.

    Guard order: ``llm_loss <= 0`` or non-finite → maxiter unchanged (no
    clamp); ``qnn_loss`` non-finite, or not behind (``<= llm_loss``) →
    the clamped maxiter; else the clamped, rounded formula.  Returns
    int64 on the device of ``maxiter``."""
    if variant not in regulation_mod.VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of "
                         f"{regulation_mod.VARIANTS}")
    maxiter = torch.as_tensor(maxiter).long()
    dev = maxiter.device
    q = torch.as_tensor(qnn_loss, device=dev).double()
    llm = torch.as_tensor(llm_loss, device=dev).double()
    m = maxiter.double()
    ratio = q / llm
    if variant == "adaptive":
        new = m * ratio
    elif variant == "incremental":
        new = m + increment * torch.clamp(torch.ceil(ratio), max=5.0)
    elif variant == "logarithmic":
        new = m * (1.0 + torch.log(ratio))
    else:  # dynamic
        new = (1 - weight) * m + weight * m * ratio
    # non-finite formulas are masked below; keep their casts defined
    new = torch.where(torch.isfinite(new), new, 0.0)
    boosted = torch.clamp(torch.round(new), min_iter, cap).long()
    held = torch.clamp(maxiter, min_iter, cap)
    bad_llm = (llm <= 0) | ~torch.isfinite(llm)
    bad_qnn = ~torch.isfinite(q)
    behind = q > llm
    return torch.where(bad_llm, maxiter,
                       torch.where(bad_qnn | ~behind, held, boosted))


def select_topk_mask(dists, k) -> torch.Tensor:
    """The mask form of ``selection.select_aligned``'s index list: True
    on the ``k`` smallest distances.  Non-finite distances count as +inf
    (diverged clients sort last) and the sort is stable, so ties go to
    the lower index.  ``k`` may be a device scalar."""
    d = torch.as_tensor(dists)
    d = torch.where(torch.isfinite(d), d, torch.inf)
    order = torch.argsort(d, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(d.shape[0], device=d.device))
    return ranks < k


def termination_step(prev_loss, small, loss, t, *, epsilon: float,
                     t_max: int, patience: int = 1):
    """One round of ``TerminationCriterion.update`` as a function:
    ``(prev_loss, small) × (loss, t) → (stop, small')``, in float64 as
    the host class.  ``t >= t_max`` stops *before* the patience counter
    updates (the host returns early, leaving it stale); with fewer than
    two losses (``t < 2``) nothing is checked; a zero-loss plateau
    converges, a fresh drop to exactly 0 is progress."""
    loss = torch.as_tensor(loss).double()
    dev = loss.device
    prev = torch.as_tensor(prev_loss, device=dev).double()
    small = torch.as_tensor(small, device=dev).long()
    t = torch.as_tensor(t, device=dev)
    have_two = t >= 2
    nonzero = loss.abs() > 0
    rel = torch.where(
        nonzero, (loss - prev).abs() / torch.where(nonzero, loss.abs(), 1.0),
        torch.where(prev == loss, 0.0, torch.inf))
    small_new = torch.where(have_two,
                            torch.where(rel < epsilon, small + 1, 0), small)
    at_cap = t >= t_max
    stop = at_cap | (have_two & (small_new >= patience))
    return stop, torch.where(at_cap, small, small_new)


# ---------------------------------------------------------------------------
# the fused program: one round's body on static buffers
# ---------------------------------------------------------------------------
def _launch_counts() -> dict:
    return {"statevector_tape": svt.statevector_tape.launches,
            "statevector_gate": svg.statevector_gate.launches,
            "replays": tape_mod.run_tape.replays}


# per-client inputs every shard reads: the stacks (cut to the shard's
# rows under full participation, whole population otherwise) and the
# (R, cohort width, …) tables (cut to the shard's cohort positions)
SHARD_STACKS = ("qX", "qy", "mask", "teacher", "deltas")
SHARD_TABLES = ("eligible", "cohort", "slot_keys", "report_keys")
# the fields of a run's results that carry the client axis last
_CLIENT_FIELDS = ("selected", "losses", "ratios", "n_evals", "budgets",
                  "cum_evals", "budgets_final", "last_losses_final",
                  "cum_evals_final")


class _FusedProgram:
    """The round body over static input, carry, exchange and output
    buffers.

    A round is three stages: the lead's *pre* stage (regulation, the
    round's budgets and float32 θ_g), each shard's local phase and report
    on its device, and the lead's *post* stage (selection, FedAvg, the
    server evaluations, termination, the scatter and the outputs).  The
    lead's exchange buffers hold the whole cohort's budgets, trained
    parameters, evaluation counts and reports; a shard on the lead's
    device reads and writes its slice of them in place, a shard on
    another device has buffers of its own, and copies between them run
    between the stages on the devices' streams (PyTorch orders a copy
    across devices with events; nothing waits on the host).

    On the card, when every shard shares the lead's device, one round is
    captured as one CUDA graph; across devices each stage is a graph on
    its device, and the copies run between their replays.
    ``graph_counts`` holds the kernel launches and tape replays one
    round's replay makes, ``replays`` the rounds replayed so far."""

    def __init__(self, spec, backend, cfg: dict, lead_in: dict,
                 group_in: List[dict], groups):
        self.cfg, self.backend = cfg, backend
        # one group a device, in shard order: the first is the lead's
        self.devices = [dev for dev, _ in groups]
        self.lead = self.devices[0]
        # holds the tape, so its columns cached on the device live as
        # long as the graph that reads them
        self.cq = tape_mod.compile_qnn(spec)
        self.local = build_local_phase(
            spec, backend, lam=cfg["lam"], mu=cfg["mu"],
            use_llm=cfg["use_llm"], optimizer=cfg["optimizer"],
            max_iter=cfg["max_iter"])
        self.buf = {k: torch.empty_like(v, device=self.lead)
                    for k, v in lead_in.items()}
        self.gbuf = [{k: torch.empty_like(v, device=dev)
                      for k, v in gi.items()}
                     for (dev, _), gi in zip(groups, group_in)]
        self.load(lead_in, group_in)
        R, C, W = cfg["n_rounds"], cfg["c_pop"], cfg["c_width"]
        P = spec.n_params

        def z(*shape, dtype=torch.float32, device=self.lead):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.state = dict(theta=z(P, dtype=torch.float64),
                          budgets=z(C, dtype=torch.int64), last=z(C),
                          cum=z(C, dtype=torch.int64), prev=z(),
                          small=z(dtype=torch.int64),
                          done=z(dtype=torch.bool), r=z(dtype=torch.int64))
        self.x = dict(theta32=z(P), gbud=z(W, dtype=torch.int64),
                      ratios=z(W, dtype=torch.float64), th=z(W, P),
                      nev=z(W, dtype=torch.int32), loss=z(W))
        self.shards = []
        for (dev, bounds), gb in zip(groups, self.gbuf):
            base = bounds[0][0]
            for lo, hi in bounds:
                rows = slice(lo - base, hi - base)
                ins = {k: v if cfg["subsample"] else v[rows]
                       for k, v in gb.items() if k in SHARD_STACKS}
                ins.update({k: v[:, rows] for k, v in gb.items()
                            if k in SHARD_TABLES})
                local = dev == self.lead
                sh = dict(device=dev, lo=lo, hi=hi, ins=ins, remote=not local,
                          r=z(dtype=torch.int64, device=dev))
                if local:
                    sh.update(theta32=self.x["theta32"],
                              **{k: self.x[k][lo:hi]
                                 for k in ("gbud", "th", "nev", "loss")})
                else:
                    sh.update(theta32=z(P, device=dev), **{
                        k: torch.empty_like(self.x[k][lo:hi], device=dev)
                        for k in ("gbud", "th", "nev", "loss")})
                self.shards.append(sh)
        self.out = dict(
            active=z(R, dtype=torch.bool), stop=z(R, dtype=torch.bool),
            selected=z(R, W, dtype=torch.bool), losses=z(R, W),
            ratios=z(R, W, dtype=torch.float64),
            n_evals=z(R, W, dtype=torch.int64),
            budgets=z(R, C, dtype=torch.int64),
            cum_evals=z(R, C, dtype=torch.int64), server_loss_pre=z(R),
            server_loss=z(R), val_acc=z(R), test_acc=z(R),
            comm_time_s=z(R, dtype=torch.float64),
            theta=z(R, P, dtype=torch.float64))
        self.graphs, self.graph_counts, self.replays = [], {}, 0
        self._host = None
        if self.lead.type == "cuda":
            self._capture()
            pinned = lambda t: torch.empty(  # noqa: E731
                t.shape, dtype=t.dtype, pin_memory=True)
            self._host = {k: pinned(v) for k, v in self._results().items()}
            self._ready = torch.cuda.Event()

    # -- buffers --------------------------------------------------------------
    def load(self, lead_in: dict, group_in: List[dict]):
        """Copy a driver's inputs into the static buffers (from pinned
        host memory to the card, without a synchronisation)."""
        for buf, inputs in [(self.buf, lead_in), *zip(self.gbuf, group_in)]:
            for k, v in inputs.items():
                buf[k].copy_(v, non_blocking=True)

    def _reset(self):
        s = self.state
        s["theta"].copy_(self.buf["theta0"])
        s["budgets"].copy_(self.buf["budgets0"])
        s["last"].fill_(torch.inf)
        s["cum"].zero_()
        s["prev"].fill_(torch.nan)
        s["small"].zero_()
        s["done"].zero_()
        s["r"].zero_()
        for sh in self.shards:
            sh["r"].zero_()

    def _results(self) -> dict:
        s = self.state
        return dict(self.out, theta_g=s["theta"], budgets_final=s["budgets"],
                    last_losses_final=s["last"], cum_evals_final=s["cum"])

    # -- the round body -------------------------------------------------------
    def _measure(self, probs, key):
        if self.backend.shots:
            return self.backend.transform_probs(probs, key)
        return self.backend.apply_channel(probs)

    @staticmethod
    def _gather(cohort):
        """Row gather of a population stack by this round's cohort (the
        identity under full participation)."""
        if cohort is None:
            return lambda a: a
        return lambda a: a.index_select(0, cohort)

    def _lead_pre(self):
        """Regulation (Alg. 1 lines 11-17; after round 1 only): the
        round's budgets and ratios, and θ_g in float32."""
        cfg, b, s, x = self.cfg, self.buf, self.state, self.x
        ridx = s["r"].view(1)
        t = s["r"] + 1
        eligible = b["eligible"].index_select(0, ridx)[0]
        g = self._gather(b["cohort"].index_select(0, ridx)[0]
                         if cfg["subsample"] else None)
        gbud0 = g(s["budgets"])
        if cfg["use_llm"]:
            glast, gllm = g(s["last"]), g(b["llm"])
            boosted = regulate_batched(gbud0, glast, gllm,
                                       variant=cfg["regulation"],
                                       cap=cfg["maxiter_cap"])
            x["gbud"].copy_(torch.where((t > 1) & eligible, boosted, gbud0))
            x["ratios"].copy_(torch.where(
                (t > 1) & torch.isfinite(glast) & (gllm > 0),
                glast.double() / gllm, 1.0))
        else:
            x["gbud"].copy_(gbud0)
            x["ratios"].fill_(1.0)
        x["theta32"].copy_(s["theta"])

    def _shard_round(self, sh):
        """One shard's local phase, at a static trip count, and its
        clients' F_i at REPORT_EVAL_SLOT in one batched evaluation."""
        cfg, b = self.cfg, sh["ins"]
        sampling = self.backend.shots > 0
        ridx = sh["r"].view(1)

        def pick(table):                   # this round's row of a table
            return table.index_select(0, ridx)[0]

        eligible = pick(b["eligible"])
        g = self._gather(pick(b["cohort"]) if cfg["subsample"] else None)
        gqX, gqy, gmask = g(b["qX"]), g(b["qy"]), g(b["mask"])
        th, n_evals = self.local(
            gqX, gqy, gmask, g(b["teacher"]), sh["theta32"], sh["gbud"],
            pick(b["slot_keys"]) if sampling else None,
            deltas=g(b["deltas"]) if "deltas" in b else None,
            active=eligible, n_steps=cfg["max_iter"])
        noisy = self._measure(tape_mod.tape_probs(self.cq, th, gqX),
                              pick(b["report_keys"]) if sampling else None)
        p = torch.gather(noisy, -1, gqy[..., None])[..., 0]
        glosses = -torch.sum(torch.log(p + EPS) * gmask, -1) \
            / torch.clamp(gmask.sum(-1), min=1.0)
        sh["th"].copy_(th)
        sh["nev"].copy_(n_evals)
        sh["loss"].copy_(torch.where(eligible, glosses, torch.nan))
        sh["r"].add_(1)

    def _send(self, sh):
        """The round's θ_g and a shard's budgets to a shard on another
        device."""
        if sh["remote"]:
            sh["theta32"].copy_(self.x["theta32"], non_blocking=True)
            sh["gbud"].copy_(self.x["gbud"][sh["lo"]:sh["hi"]],
                             non_blocking=True)

    def _receive(self, sh):
        """A shard's trained parameters, counts and reports to the lead."""
        if sh["remote"]:
            for k in ("th", "nev", "loss"):
                self.x[k][sh["lo"]:sh["hi"]].copy_(sh[k], non_blocking=True)

    def _lead_post(self):
        """Selection, FedAvg, the server evaluations, termination, the
        scatter to the population carries and the round's outputs."""
        cfg, b, s, o, x = self.cfg, self.buf, self.state, self.out, self.x
        sampling = self.backend.shots > 0
        ridx = s["r"].view(1)
        t = s["r"] + 1
        run = ~s["done"]

        def pick(table):                   # this round's row of a table
            return table.index_select(0, ridx)[0]

        eligible = pick(b["eligible"])
        cohort = pick(b["cohort"]) if cfg["subsample"] else None
        g = self._gather(cohort)
        gweights, gevaltime = g(b["weights"]), g(b["evaltime"])
        gbud0, glast = g(s["budgets"]), g(s["last"])
        gbud, th, n_evals, glosses = x["gbud"], x["th"], x["nev"], x["loss"]
        skeys = pick(b["server_keys"]) if sampling else None

        def server(fn, theta, X, y, slot):
            probs = tape_mod.tape_probs(self.cq, theta, X)
            return fn(self._measure(probs, skeys[slot] if sampling
                                    else None), y)

        s_pre = server(qnn.nll_loss, x["theta32"], b["val_qX"], b["val_qy"],
                       backend_mod.SERVER_SLOT_LOSS_PRE)

        # alignment selection (Sec. III-B), float64 distances as the host
        if cfg["select_on"]:
            d = (glosses.double() - s_pre.double()).abs()
            d = torch.where(torch.isfinite(d) & eligible, d, torch.inf)
            k = cfg["k_static"] if cfg["k_static"] is not None \
                else pick(b["k"])
            sel = select_topk_mask(d, k) & eligible
        else:
            sel = eligible

        # FedAvg (Eq. 3) in float64: w / Σw, then Σ w_c θ_c in client order
        W = cfg["c_width"]
        w = torch.where(sel, gweights, 0.0)
        wsum = w[0]
        for c in range(1, W):
            wsum = wsum + w[c]
        wn = w / torch.where(wsum > 0, wsum, 1.0)
        th64 = th.double()
        acc = torch.zeros_like(s["theta"])
        for c in range(W):
            acc = acc + torch.where(sel[c], wn[c] * th64[c], 0.0)
        theta_g = torch.where(run & (wsum > 0), acc, s["theta"])
        s["theta"].copy_(theta_g)

        theta32 = theta_g.float()
        s_post = server(qnn.nll_loss, theta32, b["val_qX"], b["val_qy"],
                        backend_mod.SERVER_SLOT_LOSS_POST)
        v_acc = server(qnn.accuracy, theta32, b["val_qX"], b["val_qy"],
                       backend_mod.SERVER_SLOT_VAL_ACC)
        t_acc = server(qnn.accuracy, theta32, b["test_qX"], b["test_qy"],
                       backend_mod.SERVER_SLOT_TEST_ACC)

        # termination
        stop, small_new = termination_step(
            s["prev"], s["small"], s_post, t, epsilon=cfg["epsilon"],
            t_max=cfg["n_rounds"], patience=cfg["patience"])
        s["prev"].copy_(torch.where(run, s_post, s["prev"]))
        s["small"].copy_(torch.where(run, small_new, s["small"]))
        if cfg["early_stop"]:
            s["done"].copy_(s["done"] | (run & stop))

        # scatter the cohort's state back to the population carries
        upd = run & eligible
        evals_add = torch.where(upd, n_evals.long(), 0)
        new_bud = torch.where(upd, gbud, gbud0)
        new_last = torch.where(upd, glosses, glast)
        if cfg["subsample"]:
            s["budgets"].index_copy_(0, cohort, new_bud)
            s["last"].index_copy_(0, cohort, new_last)
            s["cum"].index_add_(0, cohort, evals_add)
        else:
            s["budgets"].copy_(new_bud)
            s["last"].copy_(new_last)
            s["cum"].add_(evals_add)

        spent = (n_evals.long() - cfg["init_evals"]).double()
        comm = torch.where(eligible, gevaltime * spent, 0.0).max()
        comm = torch.where(run, comm, 0.0)

        for name, v in (("active", run), ("stop", run & stop),
                        ("selected", sel), ("losses", glosses),
                        ("ratios", x["ratios"]), ("n_evals", evals_add),
                        ("budgets", s["budgets"]), ("cum_evals", s["cum"]),
                        ("server_loss_pre", s_pre), ("server_loss", s_post),
                        ("val_acc", v_acc), ("test_acc", t_acc),
                        ("comm_time_s", comm), ("theta", theta_g)):
            o[name].index_copy_(0, ridx, v[None])
        s["r"].add_(1)

    def _round(self):
        """One round, every value on the device: the lead's stages, and
        each shard's on its device, issued in turn."""
        with shd.on_device(self.lead):
            self._lead_pre()
        for sh in self.shards:
            self._send(sh)
        for sh in self.shards:
            with shd.on_device(sh["device"]):
                self._shard_round(sh)
        for sh in self.shards:
            self._receive(sh)
        with shd.on_device(self.lead):
            self._lead_post()

    # -- capture and launch ---------------------------------------------------
    def _capture(self):
        """One eager round on side streams (builds the kernels, checks
        the tape's gate columns once, sets up the libraries' handles),
        then the round captured: one graph when every shard shares the
        lead's device, else a graph a stage on its device.  No fallback:
        a capture that fails raises."""
        sides = {d: torch.cuda.Stream(d) for d in self.devices}
        for d, side in sides.items():
            side.wait_stream(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as stack:
            for side in sides.values():
                stack.enter_context(torch.cuda.stream(side))
            self._reset()
            self._round()
        for d, side in sides.items():
            torch.cuda.current_stream(d).wait_stream(side)
        before = _launch_counts()
        if len(self.devices) == 1:
            stages = [(self.lead, self._round)]
        else:
            stages = ([(self.lead, self._lead_pre)]
                      + [(sh["device"], functools.partial(self._shard_round,
                                                          sh))
                         for sh in self.shards]
                      + [(self.lead, self._lead_post)])
        for dev, stage in stages:
            # a capture stream of the stage's own device (PyTorch's
            # default one lies on the device of its first capture)
            graph = torch.cuda.CUDAGraph()
            with shd.on_device(dev), torch.cuda.graph(
                    graph, stream=torch.cuda.Stream(dev)):
                stage()
            self.graphs.append((dev, graph))
        self.graph_counts = {k: v - before[k]
                             for k, v in _launch_counts().items()}

    def _replay(self):
        """One round from the captured graphs, the copies between the
        stages' graphs issued on the streams in between."""
        if len(self.graphs) == 1:
            dev, graph = self.graphs[0]
            with shd.on_device(dev):
                graph.replay()
            return
        (lead, pre), *middle, (_, post) = self.graphs
        with shd.on_device(lead):
            pre.replay()
        for sh in self.shards:
            self._send(sh)
        for dev, graph in middle:
            with shd.on_device(dev):
                graph.replay()
        for sh in self.shards:
            self._receive(sh)
        with shd.on_device(lead):
            post.replay()

    def launch(self, graph: bool = True):
        """Every round of a run from the loaded inputs, and the copy of
        the results to the host, with no synchronisation: replays of the
        captured round on the card (``graph``), else the body op by op."""
        self._reset()
        for _ in range(self.cfg["n_rounds"]):
            if graph and self.graphs:
                self._replay()
                self.replays += 1
            else:
                self._round()
        if self._host is not None:
            for k, v in self._results().items():
                self._host[k].copy_(v, non_blocking=True)
            self._ready.record(torch.cuda.current_stream(self.lead))

    def results(self) -> dict:
        """The run's results on the host, the padding clients sliced off:
        the one read-back."""
        if self._host is None:
            out = {k: v.numpy().copy() for k, v in self._results().items()}
        else:
            self._ready.synchronize()
            out = {k: v.numpy().copy() for k, v in self._host.items()}
        C = self.cfg["c_out"]
        for k in _CLIENT_FIELDS:
            out[k] = np.ascontiguousarray(out[k][..., :C])
        return out


def get_fused_program(spec, backend, cfg: dict, lead_in: dict,
                      group_in: List[dict], groups) -> _FusedProgram:
    """Module-wide cache, as the JAX package's ``_FUSED_CACHE``: drivers
    of the same static configuration, input shapes and shard layout
    share the captured program and load their own data into it."""
    def shapes(inputs):
        return tuple((k, tuple(v.shape), str(v.dtype))
                     for k, v in sorted(inputs.items()))
    layout = tuple((str(dev), tuple(bounds)) for dev, bounds in groups)
    key = (spec, backend, int(backend.shots), tuple(sorted(cfg.items())),
           shapes(lead_in), tuple(shapes(g) for g in group_in), layout)
    if key not in _FUSED_CACHE:
        _FUSED_CACHE[key] = _FusedProgram(spec, backend, cfg, lead_in,
                                          group_in, groups)
    return _FUSED_CACHE[key]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
@dataclass
class FusedRunOutput:
    """Per-round arrays over the R scheduled rounds (rows past the
    termination round have ``active=False`` and frozen or zero payloads)
    and the final population carries.  ``c_width`` is ``c_round`` in
    population mode, else the client count.  θ is float64."""
    active: np.ndarray            # (R,)  bool: round executed
    stop: np.ndarray              # (R,)  bool: termination fired here
    cohort: np.ndarray            # (R, c_width) population ids
    dropped: np.ndarray           # (R, c_width) bool
    selected: np.ndarray          # (R, c_width) bool (cohort positions)
    losses: np.ndarray            # (R, c_width) reported F_i (NaN if out)
    ratios: np.ndarray            # (R, c_width) regulation ratios
    n_evals: np.ndarray           # (R, c_width) this round's eval spend
    budgets: np.ndarray           # (R, C) post-regulation budgets
    cum_evals: np.ndarray         # (R, C)
    server_loss_pre: np.ndarray   # (R,)
    server_loss: np.ndarray       # (R,)
    val_acc: np.ndarray           # (R,)
    test_acc: np.ndarray          # (R,)
    comm_time_s: np.ndarray       # (R,)
    theta: np.ndarray             # (R, P) θ_g after each round
    theta_g: np.ndarray           # (P,)  final global parameters
    budgets_final: np.ndarray     # (C,)
    last_losses_final: np.ndarray  # (C,)
    cum_evals_final: np.ndarray   # (C,)

    @property
    def stop_round(self) -> Optional[int]:
        """1-based round where termination fired, or None."""
        hit = np.nonzero(self.stop & self.active)[0]
        return int(hit[0]) + 1 if hit.size else None

    @property
    def n_active(self) -> int:
        return int(np.sum(self.active))


class FusedRoundDriver:
    """Stacks the population and stages the run's keys once; runs R
    federated rounds a call, on ``device`` (the card unless the caller
    passes another)."""

    def __init__(self, task, spec, backend, *, optimizer: str = "nelder-mead",
                 seed: int = 0, lam: float = 0.1, mu: float = 0.01,
                 use_llm: bool = False, teacher_probs: Optional[List] = None,
                 llm_losses: Optional[Sequence[float]] = None,
                 maxiter0: int = 10, maxiter_cap: int = 100,
                 regulation: str = "adaptive", select_frac: float = 1.0,
                 epsilon: float = 1e-3, n_rounds: int = 10,
                 early_stop: bool = True, patience: int = 1,
                 c_round: Optional[int] = None, dropout: float = 0.0,
                 n_devices: Optional[int] = None, device=None,
                 share_devices: bool = False):
        C = task.n_clients
        if c_round is not None:
            c_round = int(c_round)
            if not 1 <= c_round <= C:
                raise ValueError(
                    f"c_round={c_round} must be in [1, C_pop={C}]")
            if c_round == C:
                c_round = None            # full participation
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        if use_llm and (teacher_probs is None or llm_losses is None):
            raise ValueError("use_llm=True needs teacher_probs and "
                             "llm_losses from the LLM fine-tuning stage")
        if optimizer not in ("nelder-mead", "spsa"):
            raise ValueError(f"unknown batched optimizer {optimizer!r}")
        self.devices = [resolve_device(device)]
        if n_devices is not None and int(n_devices) > 1:
            self.devices = shd.client_devices(int(n_devices), device,
                                              share_devices=share_devices)
            if c_round is not None:
                # the cohort is what is cut into shards each round: it
                # must divide them (no padding inside the round)
                shd.check_client_divisibility(c_round, int(n_devices))
        self.device = self.devices[0]
        subsample = c_round is not None
        W = c_round if subsample else C
        R = int(n_rounds)
        P = spec.n_params
        sampling = backend.shots > 0
        select_on = use_llm and select_frac < 1.0

        n_cls = task.n_classes
        b_max = max(cl.n for cl in task.clients)
        qX = np.zeros((C, b_max, spec.n_qubits), np.float32)
        qy = np.zeros((C, b_max), np.int64)
        mask = np.zeros((C, b_max), np.float32)
        teacher = np.full((C, b_max, n_cls), 1.0 / n_cls, np.float32)
        for i, cl in enumerate(task.clients):
            qX[i, :cl.n] = cl.qX
            qy[i, :cl.n] = cl.qy
            mask[i, :cl.n] = 1.0
            if teacher_probs is not None and teacher_probs[i] is not None:
                teacher[i, :cl.n] = _numpy(teacher_probs[i])
        # the orchestrator's budget-record width: regulation can boost a
        # budget up to the cap; without the LLM it stays at maxiter0
        max_iter = max(maxiter_cap, maxiter0) if use_llm else maxiter0
        inputs = dict(
            qX=qX, qy=qy, mask=mask, teacher=teacher,
            weights=np.asarray(task.weights, np.float64),
            evaltime=np.asarray([backend.eval_time(cl.n)
                                 for cl in task.clients], np.float64),
            llm=(np.asarray(llm_losses, np.float64) if llm_losses is not None
                 else np.zeros(C)),
            budgets0=np.full(C, int(maxiter0), np.int64),
            theta0=np.zeros(P, np.float64),
            val_qX=np.asarray(task.val_qX, np.float32),
            val_qy=np.asarray(task.val_qy, np.int64),
            test_qX=np.asarray(task.test_qX, np.float32),
            test_qy=np.asarray(task.test_qy, np.int64))
        if optimizer == "spsa":
            inputs["deltas"] = make_deltas(
                [seed * 997 + i for i in range(C)], max_iter,
                P).astype(np.float32)

        # every cohort, coin and key of the run: functions of (seed,
        # round, client, slot) only, derived here once
        base = jr.PRNGKey(seed)
        ts = np.arange(1, R + 1)
        if subsample:
            cohort = np.stack([np.sort(jr.choice(
                backend_mod.eval_key(base, t, backend_mod.POP_CLIENT,
                                     backend_mod.POP_SLOT_COHORT),
                C, (W,))) for t in ts]).astype(np.int64)
        else:
            cohort = np.tile(np.arange(C, dtype=np.int64), (R, 1))
        if dropout > 0.0:
            coins = np.asarray([[jr.uniform(backend_mod.eval_key(
                base, t, int(cid), backend_mod.DROPOUT_EVAL_SLOT))
                for cid in row] for t, row in zip(ts, cohort)], np.float32)
            dropped = coins < dropout
        else:
            dropped = np.zeros((R, W), bool)
        eligible = ~dropped
        k_static = None
        if select_on:
            if dropout == 0.0:
                k_static = max(1, int(round(select_frac * W)))
            else:
                # the JAX program's float32 form of frac · n_eligible
                n_el = eligible.sum(1).astype(np.float32)
                inputs["k"] = np.maximum(1, np.round(
                    np.float32(select_frac) * n_el)).astype(np.int64)
        # the unpadded population, for run_host_reference
        self._pop = dict(inputs)

        # full participation over shards: inert clients after the real
        # ones (zero masks, budgets and weights, uniform teacher rows,
        # SPSA signs of ones) pad the client axis to a multiple of them;
        # they are never eligible, and the results drop them
        n_sh = len(self.devices)
        if not subsample and C % n_sh:
            c_pad = shd.pad_client_count(C, n_sh)
            fills = dict(teacher=1.0 / n_cls, deltas=1.0)
            for k in ("qX", "qy", "mask", "teacher", "deltas", "weights",
                      "evaltime", "llm", "budgets0"):
                if k in inputs:
                    v = inputs[k]
                    pad = np.full((c_pad - C,) + v.shape[1:],
                                  fills.get(k, 0), v.dtype)
                    inputs[k] = np.concatenate([v, pad])
            cohort_p = np.tile(np.arange(c_pad, dtype=np.int64), (R, 1))
            eligible = np.concatenate(
                [eligible, np.zeros((R, c_pad - C), bool)], 1)
        else:
            cohort_p = cohort
        inputs["eligible"] = eligible
        if subsample:
            inputs["cohort"] = cohort
        if sampling:
            ckeys = jr.fold_in(jr.fold_in(base, ts)[:, None, :], cohort_p)
            slots = eval_slots(optimizer, P, max_iter)
            inputs["slot_keys"] = jr.fold_in(ckeys[:, :, None, :], slots)
            inputs["report_keys"] = jr.fold_in(
                ckeys, backend_mod.REPORT_EVAL_SLOT)
            inputs["server_keys"] = backend_mod.eval_key(
                base, ts[:, None], backend_mod.SERVER_CLIENT,
                np.asarray(_SERVER_SLOTS))
            for k in ("slot_keys", "report_keys", "server_keys"):
                inputs[k] = np.ascontiguousarray(inputs[k]).view(np.int32)

        # shards cut the cohort positions; consecutive shards on one
        # device form a group, whose inputs sit on that device once
        bounds = shd.shard_bounds(cohort_p.shape[1], n_sh)
        groups = []
        for dev, b in zip(self.devices, bounds):
            if groups and groups[-1][0] == dev:
                groups[-1][1].append(b)
            else:
                groups.append((dev, [b]))
        pin = self.device.type == "cuda"

        def staged(v):
            t = torch.from_numpy(np.ascontiguousarray(v))
            return t.pin_memory() if pin else t

        # the lead keeps the cohort and eligibility tables too: its
        # regulation, selection and scatter read them
        self._lead_in = {k: staged(v) for k, v in inputs.items()
                         if k not in SHARD_STACKS
                         + ("slot_keys", "report_keys")}
        self._group_in = []
        for _, bs in groups:
            rows = slice(bs[0][0], bs[-1][1])
            gi = {k: staged(inputs[k] if subsample else inputs[k][rows])
                  for k in SHARD_STACKS if k in inputs}
            gi.update({k: staged(inputs[k][:, rows])
                       for k in SHARD_TABLES if k in inputs})
            self._group_in.append(gi)
        self._cohort, self._dropped = cohort, dropped
        self.task, self.spec, self.backend = task, spec, backend
        self.c_pop, self.c_round, self.c_width = C, c_round, W
        self.dropout, self.seed = float(dropout), int(seed)
        self.optimizer, self.max_iter = optimizer, max_iter
        self.use_llm, self.n_rounds = use_llm, R
        self.init_evals = 1 if optimizer == "spsa" else P + 1
        self._cfg = dict(
            lam=float(lam), mu=float(mu), use_llm=bool(use_llm),
            optimizer=optimizer, max_iter=int(max_iter),
            regulation=regulation, maxiter_cap=int(maxiter_cap),
            select_frac=float(select_frac), select_on=select_on,
            k_static=k_static, epsilon=float(epsilon),
            patience=int(patience), n_rounds=R, early_stop=bool(early_stop),
            c_pop=len(inputs["budgets0"]), c_width=cohort_p.shape[1],
            c_out=C, subsample=subsample, init_evals=self.init_evals)
        self.program = get_fused_program(spec, backend, self._cfg,
                                         self._lead_in, self._group_in,
                                         groups)


    # -- fused path -----------------------------------------------------------
    def start(self, theta_g, graph: bool = True):
        """Launch every round from ``theta_g`` and the copy of the results
        to the host, with no host synchronisation; ``finish`` reads them.
        ``graph=False`` runs the round body op by op on the card instead
        of replaying its graph (the card tests hold the two bitwise).
        ``self.theta0`` keeps the start."""
        theta = np.asarray(theta_g, np.float64).reshape(-1)
        self.theta0 = theta.copy()
        self._lead_in["theta0"].copy_(torch.from_numpy(theta))
        self.program.load(self._lead_in, self._group_in)
        self.program.launch(graph=graph)

    def finish(self) -> FusedRunOutput:
        """The run's one read-back."""
        out = self.program.results()
        return FusedRunOutput(cohort=self._cohort.copy(),
                              dropped=self._dropped.copy(), **out)

    def run(self, theta_g) -> FusedRunOutput:
        """All R rounds, read back once at the end."""
        self.start(theta_g)
        return self.finish()

    # -- host-reference path (the per-round loop: baseline and oracle) -------
    def run_host_reference(self, theta_g) -> FusedRunOutput:
        """The per-round host loop over the same population semantics:
        the local phase on the device a round (host-read trip count),
        then regulation, selection, float64 FedAvg and termination on the
        host through the reference modules, and one report read a
        client, as the orchestrator does.  The fused run must match it
        round for round."""
        cfg, dev = self._cfg, self.device
        local = build_local_phase(
            self.spec, self.backend, lam=cfg["lam"], mu=cfg["mu"],
            use_llm=self.use_llm, optimizer=self.optimizer,
            max_iter=self.max_iter)
        fwd = tape_mod.make_tape_forward(self.spec, dev)
        sampling = self.backend.shots > 0
        base = jr.PRNGKey(self.seed)
        C, W, R = self.c_pop, self.c_width, self.n_rounds
        host = self._pop
        on_dev = {k: torch.from_numpy(v).to(dev) for k, v in host.items()
                  if k in SHARD_STACKS}
        weights, evaltime, llm = host["weights"], host["evaltime"], \
            host["llm"]
        task = self.task

        theta = np.asarray(theta_g, np.float64).reshape(-1).copy()
        budgets = host["budgets0"].copy()
        last = np.full(C, np.inf, np.float32)
        cum = np.zeros(C, np.int64)
        term = TerminationCriterion(epsilon=cfg["epsilon"], t_max=R,
                                    patience=cfg["patience"])
        out = dict(
            active=np.zeros(R, bool), stop=np.zeros(R, bool),
            selected=np.zeros((R, W), bool),
            losses=np.full((R, W), np.nan, np.float32),
            ratios=np.ones((R, W)), n_evals=np.zeros((R, W), np.int64),
            budgets=np.zeros((R, C), np.int64),
            cum_evals=np.zeros((R, C), np.int64),
            server_loss_pre=np.full(R, np.nan, np.float32),
            server_loss=np.full(R, np.nan, np.float32),
            val_acc=np.full(R, np.nan, np.float32),
            test_acc=np.full(R, np.nan, np.float32),
            comm_time_s=np.zeros(R), theta=np.zeros((R, theta.size)))

        def measure(th, X, t, client, slot):
            probs = fwd(torch.from_numpy(np.asarray(th, np.float32)), X)
            if sampling:
                return self.backend.transform_probs(
                    probs, backend_mod.eval_key(base, t, client, slot))
            return self.backend.apply_channel(probs)

        def put(a):
            return torch.as_tensor(a).to(dev)

        val_qX, val_qy = put(task.val_qX), put(task.val_qy)
        test_qX, test_qy = put(task.test_qX), put(task.test_qy)
        for r in range(R):
            t = r + 1
            cohort = self._cohort[r]
            eligible = ~self._dropped[r]

            gbud = budgets[cohort].copy()
            ratios = np.ones(W)
            if self.use_llm and t > 1:
                for p in np.nonzero(eligible)[0]:
                    cid = int(cohort[p])
                    gbud[p] = regulation_mod.regulate(
                        int(gbud[p]), float(last[cid]), float(llm[cid]),
                        variant=cfg["regulation"], cap=cfg["maxiter_cap"])
                for p, cid in enumerate(cohort):
                    if np.isfinite(last[cid]) and llm[cid] > 0:
                        ratios[p] = float(last[cid]) / float(llm[cid])

            idx = put(cohort)
            ckeys = jr.fold_in(jr.fold_in(base, t), cohort)
            x, n_evals = local(
                on_dev["qX"][idx], on_dev["qy"][idx], on_dev["mask"][idx],
                on_dev["teacher"][idx],
                torch.from_numpy(theta.astype(np.float32)).to(dev),
                put(gbud), ckeys,
                deltas=on_dev["deltas"][idx] if "deltas" in on_dev else None,
                active=put(eligible))
            th_stack = _numpy(x).astype(np.float64)
            n_evals = _numpy(n_evals).astype(np.int64)

            losses = np.full(W, np.nan, np.float32)
            for p in np.nonzero(eligible)[0]:
                cid = int(cohort[p])
                cl = task.clients[cid]
                losses[p] = float(qnn.nll_loss(
                    measure(th_stack[p], put(cl.qX), t, cid,
                            backend_mod.REPORT_EVAL_SLOT), put(cl.qy)))

            s_pre = float(qnn.nll_loss(
                measure(theta, val_qX, t, backend_mod.SERVER_CLIENT,
                        backend_mod.SERVER_SLOT_LOSS_PRE), val_qy))

            if cfg["select_on"]:
                with np.errstate(invalid="ignore"):
                    d = np.abs(losses.astype(np.float64) - s_pre)
                d = np.where(np.isfinite(d) & eligible, d, np.inf)
                if self.dropout > 0.0:
                    # the fused program's float32 form
                    k = int(max(1, np.round(np.float32(cfg["select_frac"])
                                            * np.float32(eligible.sum()))))
                else:
                    k = max(1, int(round(cfg["select_frac"] * W)))
                sel = np.zeros(W, bool)
                sel[np.argsort(d, kind="stable")[:k]] = True
                sel &= eligible
            else:
                sel = eligible.copy()

            # the orchestrator's float64 FedAvg over the selected set
            chosen = np.nonzero(sel)[0]
            w = weights[cohort[chosen]]
            if w.sum() > 0:
                w = w / w.sum()
                theta = sum(wi * th_stack[p] for wi, p in zip(w, chosen))

            s_post = float(qnn.nll_loss(
                measure(theta, val_qX, t, backend_mod.SERVER_CLIENT,
                        backend_mod.SERVER_SLOT_LOSS_POST), val_qy))
            v_acc = float(qnn.accuracy(
                measure(theta, val_qX, t, backend_mod.SERVER_CLIENT,
                        backend_mod.SERVER_SLOT_VAL_ACC), val_qy))
            t_acc = float(qnn.accuracy(
                measure(theta, test_qX, t, backend_mod.SERVER_CLIENT,
                        backend_mod.SERVER_SLOT_TEST_ACC), test_qy))

            budgets[cohort[eligible]] = gbud[eligible]
            last[cohort[eligible]] = losses[eligible]
            cum[cohort[eligible]] += n_evals[eligible]
            comm = float(np.max(np.where(
                eligible, evaltime[cohort] * (n_evals - self.init_evals),
                0.0), initial=0.0))

            for name, v in (("active", True), ("selected", sel),
                            ("losses", losses), ("ratios", ratios),
                            ("n_evals", np.where(eligible, n_evals, 0)),
                            ("budgets", budgets), ("cum_evals", cum),
                            ("server_loss_pre", s_pre),
                            ("server_loss", s_post), ("val_acc", v_acc),
                            ("test_acc", t_acc), ("comm_time_s", comm),
                            ("theta", theta)):
                out[name][r] = v
            if term.update(s_post, t):
                out["stop"][r] = True
                if cfg["early_stop"]:
                    break

        return FusedRunOutput(
            cohort=self._cohort.copy(), dropped=self._dropped.copy(),
            theta_g=np.asarray(theta, np.float64),
            budgets_final=budgets.copy(), last_losses_final=last.copy(),
            cum_evals_final=cum.copy(), **out)
