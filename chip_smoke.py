#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # device busy/idle of the main paths
    python3 chip_smoke.py --attn       # attention kernels only: checks,
                                       # times and the lone-CTA probe
    python3 chip_smoke.py --sharded    # phase 11 only, on card-only
                                       # one-shard references

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``.  It imports nothing of JAX and nothing of the JAX package
``repro``; it drives ``src/repro_torch`` only.  Every phase raises on
failure, and the script then exits non-zero with no result line.

1. Prints the card's name and power limit (``nvidia-smi``), builds the
   hand-written kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and prints the build time and the
   compiler's register and spill report.
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the card over a sweep of shapes (tolerance stated per kernel), the
   backward passes against plain autograd, and times the kernel, the
   plain version and a library call at the shapes the main paths give it.
   The tape kernel ``statevector_tape`` is also held to the chain of
   per-gate ``statevector_gate`` launches it replaces (its bitwise-equal
   share printed) and timed beside that chain.  ``flash_attention`` is
   also held at the edges of its 64-row / 64-key tiles, its backward
   must repeat bit for bit, and a probe times it on a lone CTA and a
   wave of 132.
3. QFL main path at the quickstart width: federated QFL with batched
   Nelder–Mead on the genomic task, 4-qubit VQC (86 gates, 16 params),
   5 clients, 10 rounds, on the card; then the same run on the CPU (the
   plain path), which it must match.  Every tape replay is one
   ``statevector_tape`` launch; the size-rule phase then drives
   ``tape_probs`` above the tape kernel's limit of 14 qubits, where
   ``run_tape`` launches ``statevector_gate`` once a gate.
4. LLM-QFL main path (the README quickstart, Algorithm 1): the same task
   with ``method="llm-qfl"``: Step 1 fine-tunes ``tiny-llm`` LoRA
   adapters (30 steps) on the card, then 10 regulated quantum rounds.
   The card's Step 1 is held to the CPU's (plain path) within the
   batched-LLM tolerances, and the CPU's quantum rounds, run on the
   card's Step 1 outputs, to the card's rounds exactly on the integer
   accounting.
5. Wide phases: a 10-qubit VQC (485 gates, 40 params), 8 clients, one
   round; and the LLM stage alone at ``llama3.2-1b`` widths (16 layers,
   d_model 2048, 4 clients × 16 rows × 64 tokens, 2 steps, float32 base).
6. QLoRA stages (``lora.quantize_base=True``: every adapted projection's
   base packed int4, consumed by ``int4_matmul`` forward and dx): the
   LLM stage of the quickstart (``BatchedLLMEngine``, 5 clients, 30
   steps, ``tiny-llm``) on the card, held to the same stage on the CPU
   (plain path); then the stage at ``llama3.2-1b`` widths as in 5.
7. The sequential engine and SPSA (after phase 4), at the quickstart's
   width with the rounds cut to 3 (the sequential engine reads every
   objective evaluation back to the host): QFL and LLM-QFL with
   Nelder–Mead on ``engine="sequential"``, each held to the batched
   engine on the card (the LLM-QFL rounds on one Step 1) and the QFL one
   to the CPU; the sequential Step 1 (one client a launch, three
   evaluation forwards a client) held to the batched Step 1 on the same
   base, its launches to ``llm_launch_formula(clients=5, evals=3)``;
   SPSA in both engines, QFL and LLM-QFL, batched on the card held to
   sequential on the card and to batched on the CPU.  After phase 5,
   ``run_sequential_stage`` at ``llama3.2-1b`` widths against
   ``BatchedLLMEngine`` on one base, with each client's step time.
8. Finite shots, the training CLI and the paper's LLMs (printed as
   phase 9a–9c, after phase 6): (a) ``backends.sample_counts`` on the
   card bitwise the CPU's on the same probabilities and keys (the
   quickstart's shapes, a batched ``(C, K, B, 2)`` stack, NaN, zero-mass
   and negative rows, 1000 shots, bfloat16), and its time; (b)
   ``repro_torch.launch.train.main(argv)`` with Experiment I's flags
   (``aersim``, Dirichlet 0.5 shards, 5 clients) at 3 rounds: QFL and
   LLM-QFL on the batched engine, QFL on the sequential engine, QFL
   batched on ``fake`` and ``real``, each held to the same command on
   the CPU (run after the card's, so no card time is taken under the
   CPU's load), and LLM-QFL selecting 20 % held to the card's LLM-QFL
   run on Step 1 and the first round; the draws within 1e-6 of a CDF boundary
   number no more than chance allows, and each falls in the same class
   in both runs unless the two runs' boundaries straddle it, no more
   than 1e-6 apart; (c) GPT-2's Step 1 at full width
   (``BatchedLLMEngine``, 5 clients, 2 steps; 1 step held to the CPU on
   one base) and DeepSeek-LLM-7B's at full width
   (``run_sequential_stage``, 2 clients × 2 steps, held to
   ``BatchedLLMEngine`` on one base as the llama3.2-1b one is), with
   their base draw times, step times and peak memory.
9. The fused round loop (``rounds="fused"``, printed as phase 10,
   after phase 4): the QFL quickstart (10 rounds), the LLM-QFL
   quickstart's rounds on phase 4's card Step 1, QFL on ``aersim`` at
   3 rounds (Nelder–Mead and SPSA) and a large-ε early termination,
   each through the entry point with its round captured anew as a CUDA
   graph, held to the card's host-loop run (integers exactly, losses
   within 1e-5, θ_g within 2e-6; the QFL quickstart also to phase 3's
   CPU run), with no host synchronisation from its first launch to its
   one read-back (``torch.cuda.set_sync_debug_mode("error")``) and a
   second replay bitwise equal; then population mode (3 of 5 clients a
   round, dropout 0.25, ``aersim``) held to ``run_host_reference`` on
   the card.  The fused path's ``statevector_tape`` launches are one
   eager round before the capture plus the graph's nodes times its
   replays.
10. The clients axis (``n_devices=2``, printed as phase 11, after phase
   10), with the two shards sharing the card (``share_devices=True``;
   without it, on one card, ``n_devices=2`` must raise): the QFL
   quickstart's host loop (5 clients, c_pad 6, one inert), QFL on
   ``aersim`` (Nelder–Mead, 3 rounds), the fused QFL quickstart (no host
   synchronisation before its read-back), each bitwise its one-shard
   run of phases 3 and 10, and the fused one the sharded host loop;
   population mode (4 of 5 clients, dropout 0.25, ``aersim``, 5 rounds)
   held to ``run_host_reference``; the LLM-QFL quickstart's Step 1
   within 1e-4 (F1 0.05) of one device padded to 6 (``lora_matmul``
   plans a small grid's split from all the launch's clients, so shards
   split it otherwise) and of phase 4's.  Each shard replays its own
   local phase, so the launches are
   the one-shard formulas with the local phase counted once a shard.
   Where two or more cards are visible the same runs go across cards.
11. Prints the phases' wall times, the card line, one
   ``{"kernels": [...]}`` line (``launches_sequential``: the launches of
   phase 7's sequential LLM-QFL Step 1, and for ``statevector_tape`` of
   its batched SPSA QFL run; ``launches_aersim``, ``launches_gpt2``,
   ``launches_deepseek``: phase 9's; ``launches_fused*``: phase 10's;
   ``launches_sharded*``: phase 11's, on one card), and last
   ``{"ok": true, "device": {...}}``.

Each path is driven with every launch counter set to 0 just before it
and read just after, and the counts are held to the formulas stated in
``llm_launch_formula`` and the QFL phases.  ``--profile`` instead traces
a warm 3-round QFL run, a warm LLM-QFL run (Step 1 and 3 rounds), a
warm QLoRA LLM stage, a warm 3-round batched SPSA QFL run and a warm
sequential LLM-QFL run (Step 1 and 1 round) with ``torch.profiler``
and prints the device's busy time, its idle share of the wall time, and
the kernels that take the device time; a warm 3-round batched QFL
run on ``aersim`` with the device time of ``sample_counts``; and warm
3-round runs of the host and the fused loop side by side (QFL, QFL on
``aersim``, the LLM-QFL rounds on one Step 1).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
F32_FLOPS_PER_S = 67e12            # H100 SXM, float32 outside tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM, TF32 tensor cores, dense

QUICKSTART = dict(task=dict(n_clients=5, train_size=250, test_size=100,
                            val_size=60, seed=0),
                  run=dict(n_rounds=10))
WIDE = dict(task=dict(n_clients=8, train_size=400, test_size=100,
                      val_size=60, seed=0, n_features=10),
            run=dict(n_rounds=1, maxiter0=5, n_qubits=10))
LLM_QUICKSTART = dict(task=QUICKSTART["task"],
                      run=dict(n_rounds=10, llm_steps=30))
LLM_WIDE = dict(task=dict(n_clients=4, train_size=64, test_size=16,
                          val_size=16, seed=0),
                steps=2, batch_size=16)
# the batched-LLM tolerances of the JAX package's tests
LLM_LOSS_TOL, LLM_F1_TOL, TEACHER_TOL = 5e-4, 0.05, 5e-4
KERNELS = ("statevector_gate", "statevector_tape", "lora_matmul",
           "flash_attention", "int4_matmul", "distill_kl")
# shared memory of the H100 SXM: 132 SMs × 128 bytes a clock at the
# published 1.98 GHz boost clock
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
# (rows a replay, qubits) of the tape kernel on the main paths: the
# quickstart (5 clients × 50 rows × 19 candidates) and the wide phase
# (8 clients × 50 rows × 43 candidates)
TAPE_SHAPES = ((4750, 4), (17200, 10))
# (rows, qubits, the path that gives it) where statevector_gate is timed:
# the size-rule phase's replay, where it runs, then the tape kernel's two
# shapes, which it ran on before the tape kernel, for comparison
SIZE_RULE_QUBITS, SIZE_RULE_ROWS = 15, 7
GATE_SHAPES = ((SIZE_RULE_ROWS, SIZE_RULE_QUBITS,
                "size rule: run_tape above 14 qubits"),
               (4750, 4, "none: the quickstart's replays use the tape kernel"),
               (17200, 10, "none: the wide replays use the tape kernel"))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn()``: ``iters`` calls captured in one
    CUDA graph and replayed back to back, so the host's launch path
    (ctypes, checks, allocation) drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


# ---------------------------------------------------------------------------
# phase 2: statevector_gate against its plain version
# ---------------------------------------------------------------------------
def _gate_inputs(B: int, n: int, gen):
    import torch
    u = lambda *s: torch.rand(*s, generator=gen, device="cuda") * 2 - 1  # noqa
    return u(B, 1 << n), u(B, 1 << n), u(B, 2, 2), u(B, 2, 2)


def kernel_phase():
    """Max error over the sweep, and times at ``GATE_SHAPES``."""
    import torch
    from repro_torch.kernels import ref, statevector_gates as svg

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err, cases, equal, total = 0.0, 0, 0, 0
    for n in (1, 2, 4, 6, 10, 12, 15):
        for B in (1, 7, 4750, 17200):
            if (B == 17200 and n > 10) or (B > 7 and n > 12):
                continue
            psi_re, psi_im, g_re, g_im = _gate_inputs(B, n, gen)
            for target in range(n):
                for control in [-1] + [c for c in range(n) if c != target]:
                    got = svg.statevector_gate(psi_re, psi_im, g_re, g_im,
                                               target, control, n)
                    want = ref.statevector_gate(psi_re, psi_im, g_re, g_im,
                                                target, control, n)
                    err = max(abs_err(g, w) for g, w in zip(got, want))
                    check(err <= 1e-6, f"statevector_gate n={n} B={B} "
                          f"target={target} control={control}: max abs "
                          f"error {err} > 1e-6")
                    max_err = max(max_err, err)
                    equal += sum(int((g == w).sum())
                                 for g, w in zip(got, want))
                    total += 2 * B << n
                    cases += 1
    torch.cuda.synchronize()
    print(f"kernel phase: statevector_gate == plain on {cases} cases (n up "
          f"to 15), max abs err {max_err:.3g} (tolerance 1e-6; every "
          f"product and sum is rounded alone, as in the plain version, so "
          f"meant to be bitwise), bitwise equal on {equal / total:.6f} of "
          f"{total} values")

    shapes = []
    for B, n, path in GATE_SHAPES:
        psi_re, psi_im, g_re, g_im = _gate_inputs(B, n, gen)
        # a controlled gate (CX-like) on the middle qubit, the common case
        args = (psi_re, psi_im, g_re, g_im, n // 2, 0, n)
        ms = cuda_ms(lambda: svg.statevector_gate(*args), iters=200)
        dev_ms = graph_ms(lambda: svg.statevector_gate(*args))
        plain_ms = cuda_ms(lambda: ref.statevector_gate(*args), iters=50)
        N = 1 << n
        nbytes = 16 * B * N + 32 * B       # planes in + out, gates in
        flops = 14 * B * N                 # 28 per amplitude pair
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       flops / F32_FLOPS_PER_S) * 1e3
        shapes.append(dict(B=B, n_qubits=n, path=path, ms=ms,
                           graph_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bytes=nbytes))
        print(f"  B={B} n={n} ({path}): kernel {ms * 1e3:.2f} us/launch "
              f"({dev_ms * 1e3:.2f} us in a CUDA graph), plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.2f} MB at 3.35 TB/s)")
    return max_err, equal / total, shapes


# ---------------------------------------------------------------------------
# phase 2: statevector_tape against its plain version and the gate chain
# ---------------------------------------------------------------------------
def tape_columns(n: int, kind: str, gen):
    """(gate_id, target, control) int32 on the card: the compiled VQC
    tape of ``n`` qubits, or one gate of a random kind for every (target,
    control) pair."""
    import numpy as np
    import torch
    from repro_torch.quantum import qnn, tape
    if kind == "vqc":
        t = tape.compile_qnn(qnn.QNNSpec("vqc", n_qubits=n)).tape
        cols = (t.gate_id, t.target, t.control)
    else:
        pairs = [(t, c) for t in range(n)
                 for c in [-1] + [c for c in range(n) if c != t]]
        gid = torch.randint(0, 5, (len(pairs),), generator=gen,
                            device="cuda").cpu().numpy()
        cols = (gid, np.array([t for t, _ in pairs]),
                np.array([c for _, c in pairs]))
    return [torch.as_tensor(np.asarray(c, np.int32), device="cuda")
            for c in cols]


def tape_angles_for(n: int, kind: str, B: int, gen):
    """(B, G) angles: the VQC tape's from features in [0, π) and
    parameters in [-π, π), as the quantum rounds make them; a random
    tape's uniform in [-2π, 2π)."""
    import torch
    from repro_torch.quantum import qnn, tape
    if kind == "vqc":
        spec = qnn.QNNSpec("vqc", n_qubits=n)
        X = torch.rand(B, n, generator=gen, device="cuda") * math.pi
        theta = (torch.rand(spec.n_params, generator=gen, device="cuda")
                 * 2 - 1) * math.pi
        return tape.tape_angles(tape.compile_qnn(spec).tape, X, theta)
    G = n * n
    return (torch.rand(B, G, generator=gen, device="cuda") * 4 - 2) * math.pi


def tape_work(B: int, n: int, control) -> dict:
    """What one replay needs: HBM bytes (angles and columns read once,
    the planes written once), flops (28 a pair the gate acts on: all
    2**(n-1) pairs, or the half whose control bit is set) and
    shared-memory bytes (32 a pair, the state set up and read out)."""
    c = control.tolist()
    G, N = len(c), 1 << n
    pairs = B * sum(N // 4 if cq >= 0 else N // 2 for cq in c)
    return dict(hbm_bytes=4 * B * G + 12 * G + 8 * B * N,
                flops=28 * pairs, smem_bytes=32 * pairs + 16 * B * N)


def tape_phase(gate_shapes):
    """statevector_tape over n up to its limit against ``ref`` and the
    per-gate kernel chain; times at the main paths' shapes."""
    import torch
    from repro_torch.kernels import ref, statevector_gates as svg
    from repro_torch.kernels import statevector_tape as svt
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err = chain_err = norm_err = 0.0
    equal = total = cases = 0
    ns = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 13, svt.MAX_QUBITS)
    for n in ns:
        for kind in ("vqc", "random"):
            cols = tape_columns(n, kind, gen)
            for B in (1, 7, 4750, 17200):
                if B == 17200 and n > 10:
                    continue
                ang = tape_angles_for(n, kind, B, gen)
                got = svt.statevector_tape(ang, *cols, n)
                want = ref.statevector_tape(ang, *cols, n)
                chain = ref.statevector_tape(ang, *cols, n,
                                             gate=svg.statevector_gate)
                err = max(abs_err(g, w) for g, w in zip(got, want))
                tol = 1e-6 if n <= 4 else 1e-5
                check(err <= tol, f"statevector_tape n={n} {kind} B={B}: "
                      f"max abs error {err} > {tol}")
                norm = float(((got[0] ** 2 + got[1] ** 2).sum(-1) - 1)
                             .abs().max())
                check(norm <= 1e-5, f"statevector_tape n={n} {kind} B={B}: "
                      f"|norm - 1| = {norm}")
                max_err, norm_err = max(max_err, err), max(norm_err, norm)
                chain_err = max(chain_err, max(abs_err(g, c) for g, c
                                               in zip(got, chain)))
                equal += sum(int((g == c).sum()) for g, c in zip(got, chain))
                total += 2 * B << n
                cases += 1
    torch.cuda.synchronize()
    share = equal / total
    print(f"kernel phase: statevector_tape == plain on {cases} cases (n in "
          f"{list(ns)}, VQC and random tapes, B in 1, 7, 4750 and 17200 up "
          f"to n = 10), max abs err {max_err:.3g} (tolerance 1e-6 up to "
          f"n = 4, 1e-5 above), max |norm-1| {norm_err:.3g}; against the "
          f"per-gate kernel chain max abs err {chain_err:.3g}, bitwise "
          f"equal on {share:.6f} of {total} amplitude planes' values")

    shapes = []
    for B, n in TAPE_SHAPES:
        gate = next(g for g in gate_shapes
                    if (g["B"], g["n_qubits"]) == (B, n))
        cols = tape_columns(n, "vqc", gen)
        host_cols = [c.cpu().numpy() for c in cols[1:]]
        ang = tape_angles_for(n, "vqc", B, gen)
        G = cols[0].shape[0]
        wide = n > 4
        launch = lambda: svt.statevector_tape(ang, *cols, n)  # noqa: E731
        chain = lambda: ref.statevector_tape(  # noqa: E731
            ang, cols[0], *host_cols, n, gate=svg.statevector_gate)
        ms = cuda_ms(launch, iters=20 if wide else 200)
        dev = graph_ms(launch, 5 if wide else 20)
        chain_ms = cuda_ms(chain, iters=3 if wide else 20, warmup=2)
        chain_dev = graph_ms(chain, 1 if wide else 5, replays=3)
        plain = cuda_ms(lambda: ref.statevector_tape(
            ang, cols[0], *host_cols, n), iters=2 if wide else 10,
            warmup=1)
        # one CTA's rows alone: the latency of a row's serial gate chain
        lone = ang[:svt.rows_per_block(n)].contiguous()
        lone_ms = graph_ms(lambda: svt.statevector_tape(lone, *cols, n))
        work = tape_work(B, n, cols[2])
        bms, by = bound_ms(work["flops"], work["hbm_bytes"])
        smem_ms = work["smem_bytes"] / SMEM_BYTES_PER_S * 1e3
        shapes.append(dict(
            B=B, n_qubits=n, gates=G, ms=ms, graph_ms=dev,
            lone_cta_graph_ms=lone_ms, chain_ms=chain_ms,
            chain_graph_ms=chain_dev, plain_ms=plain, bound_ms=bms,
            bound_by=by, smem_bound_ms=smem_ms,
            hbm_ms=work["hbm_bytes"] / HBM_BYTES_PER_S * 1e3,
            ffma_ms=work["flops"] / F32_FLOPS_PER_S * 1e3, **work))
        print(f"  B={B} n={n} G={G}: kernel {ms * 1e3:.2f} us a replay "
              f"(graph {dev * 1e3:.2f} us; one CTA's {lone.shape[0]} rows "
              f"alone {lone_ms * 1e3:.2f} us); per-gate chain {chain_ms * 1e3:.2f}"
              f" us (graph {chain_dev * 1e3:.2f} us; a product, not "
              f"measured: {G} x one timed per-gate launch "
              f"{gate['ms'] * G * 1e3:.2f} us, graph "
              f"{gate['graph_ms'] * G * 1e3:.2f} us); plain "
              f"{plain * 1e3:.2f} us; bound {bms * 1e3:.2f} us ({by}: HBM "
              f"{shapes[-1]['hbm_ms'] * 1e3:.2f} us, FFMA "
              f"{shapes[-1]['ffma_ms'] * 1e3:.2f} us), shared-memory "
              f"traffic {smem_ms * 1e3:.2f} us at "
              f"{SMEM_BYTES_PER_S / 1e12:.1f} TB/s")
    return max_err, share, shapes


# ---------------------------------------------------------------------------
# phase 2: lora_matmul and flash_attention against their plain versions
# ---------------------------------------------------------------------------
def _randn(gen, shape, scale=1.0, dtype=None):
    import torch
    t = torch.randn(*shape, generator=gen, device="cuda") * scale
    return t if dtype is None else t.to(dtype)


def abs_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tc_bound_ms(products: int, flops: float, nbytes: float):
    """The tensor-core bound of a projection taken as ``products`` TF32
    products (3xTF32: 3 for float32 operands, 2 when the weight is exact
    in TF32): products · 2MNK over 495 TFLOP/s, or bytes over 3.35 TB/s,
    whichever is larger."""
    t_ops = products * flops / TF32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# Projection shapes (K, N) of one layer, and the rows M each launch sees:
# tiny-llm for the LLM-QFL quickstart (C=5 clients, 16 × 64 tokens a
# step, 50 × 64 in the evaluation; the sequential Step 1 one client at a
# time, C=1) and llama3.2-1b for the wide phase (C=4, 16 × 64).
def projections(d, H, KH, D, ff):
    return {"wq": (d, H * D), "wkv": (d, 2 * KH * D), "wo": (H * D, d),
            "w_in": (d, 2 * ff), "w_out": (ff, d)}


TINY_PROJ = projections(128, 4, 2, 32, 256)
WIDE_PROJ = projections(2048, 32, 8, 64, 8192)
# the paper's GPT-2 (phase 9: the batched Step 1 of the quickstart's 5
# clients) and DeepSeek-LLM-7B (its sequential Step 1, one client a
# launch)
GPT2_PROJ = projections(768, 12, 12, 64, 3072)
DEEPSEEK_PROJ = projections(4096, 32, 32, 128, 11008)
LORA_SHAPES = (
    [("tiny-" + n, 5, 1024, K, N, 4) for n, (K, N) in TINY_PROJ.items()]
    + [("tiny-eval-w_in", 5, 3200, 128, 512, 4),
       ("seq-w_in", 1, 1024, 128, 512, 4),
       ("seq-eval-w_in", 1, 3200, 128, 512, 4)]
    + [("llama-" + n, 4, 1024, K, N, 8) for n, (K, N) in WIDE_PROJ.items()]
    + [("gpt2-" + n, 5, 1024, K, N, 8) for n, (K, N) in GPT2_PROJ.items()]
    + [("deepseek-" + n, 1, 1024, K, N, 8)
       for n, (K, N) in DEEPSEEK_PROJ.items()])
ATTN_SHAPES = (("tiny", 80, 64, 4, 2, 32), ("tiny-eval", 250, 64, 4, 2, 32),
               ("seq", 16, 64, 4, 2, 32), ("seq-eval", 50, 64, 4, 2, 32),
               ("llama", 64, 64, 32, 8, 64), ("gpt2", 80, 64, 12, 12, 64),
               ("deepseek", 16, 64, 32, 32, 128))


def lora_flops_bytes(C, M, K, N, r, elem=4):
    flops = 2 * C * M * (K * N + K * r + r * N)
    nbytes = elem * (C * M * K + K * N + C * K * r + C * r * N + C * M * N)
    return flops, nbytes


def lora_phase(gen):
    """lora_matmul forward (and dx, the same kernel on transposed views)
    against ``ref.lora_matmul``, gradients against plain autograd."""
    import torch
    from repro_torch.kernels import lora_matmul as lm, ref
    max_err, cases = 0.0, 0
    # the JAX kernel test's sweep, 2-D, both dtypes: its tolerances
    for (M, K, N, r) in ((128, 256, 128, 8), (256, 512, 384, 16),
                         (64, 128, 512, 4), (32, 64, 64, 32)):
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x = _randn(gen, (M, K), dtype=dt)
            w, a, b = (_randn(gen, sh, 0.05, dt)
                       for sh in ((K, N), (K, r), (r, N)))
            got = lm.lora_matmul(x, w, a, b, 2.0)
            want = ref.lora_matmul(x, w, a, b, 2.0)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            if dt == torch.float32:
                max_err = max(max_err, abs_err(got, want))
            cases += 1
    # the main paths' shapes, float32: forward, dx, dA, dB
    for name, C, M, K, N, r in LORA_SHAPES:
        x = _randn(gen, (C, M, K)).requires_grad_()
        w = _randn(gen, (K, N), K ** -0.5)
        a = _randn(gen, (C, K, r), K ** -0.5).requires_grad_()
        b = _randn(gen, (C, r, N), 0.1).requires_grad_()
        dy = _randn(gen, (C, M, N))
        got = lm.lora_matmul(x, w, a, b, 2.0)
        g = torch.autograd.grad(got, (x, a, b), dy)
        want = ref.lora_matmul(x, w, a, b, 2.0)
        gw = torch.autograd.grad(want, (x, a, b), dy)
        for what, u, v in (("y", got, want), ("dx", g[0], gw[0]),
                           ("dA", g[1], gw[1]), ("dB", g[2], gw[2])):
            err = rel_err(u, v)
            check(err <= 2e-5, f"lora_matmul {name} {what}: relative error "
                  f"{err} > 2e-5")
        max_err = max(max_err, abs_err(got, want))
        cases += 1
    torch.cuda.synchronize()
    print(f"kernel phase: lora_matmul == plain on {cases} cases (forward, "
          "and dx/dA/dB at the main paths' shapes), float32 max abs err "
          f"{max_err:.3g} (tolerance: the JAX sweep's 2e-5 float32 / 2e-2 "
          "bfloat16; at the main paths' shapes 2e-5 of the largest "
          "magnitude: float32 sums in another order than cuBLAS's)")

    shapes = []
    with torch.no_grad():
        for name, C, M, K, N, r in LORA_SHAPES:
            x = _randn(gen, (C, M, K))
            w = _randn(gen, (K, N), K ** -0.5)
            a = _randn(gen, (C, K, r), K ** -0.5)
            b = _randn(gen, (C, r, N), 0.1)
            dy = _randn(gen, (C, M, N))
            big = K * N >= 1 << 24
            it = 10 if big else 100
            ms = cuda_ms(lambda: lm._launch(x, w, a, b, 2.0), iters=it)
            dx_ms = cuda_ms(lambda: lm._launch(dy, w.t(), b.transpose(1, 2),
                                               a.transpose(1, 2), 2.0),
                            iters=it)
            plain = cuda_ms(lambda: ref.lora_matmul(x, w, a, b, 2.0),
                            iters=it)
            lib = lambda: torch.baddbmm(  # noqa: E731
                torch.matmul(x, w), torch.bmm(x, a), b, alpha=2.0)
            library = cuda_ms(lib, iters=it)
            n_graph = 3 if big else 20
            dev = graph_ms(lambda: lm._launch(x, w, a, b, 2.0), n_graph)
            lib_dev = graph_ms(lib, n_graph)
            flops, nbytes = lora_flops_bytes(C, M, K, N, r)
            bms, by = bound_ms(flops, nbytes)
            tms, tby = tc_bound_ms(3, 2 * C * M * N * K, nbytes)
            shapes.append(dict(shape=name, C=C, M=M, K=K, N=N, r=r, ms=ms,
                               graph_ms=dev, dx_ms=dx_ms, plain_ms=plain,
                               library_ms=library, library_graph_ms=lib_dev,
                               bound_ms=bms, bound_by=by, tc_bound_ms=tms,
                               tc_bound_by=tby, tc_products=3,
                               tflops=flops / dev / 1e9,
                               gflop=flops / 1e9))
            print(f"  {name} (C={C} M={M} K={K} N={N} r={r}): kernel "
                  f"{ms * 1e3:.1f} us, in a CUDA graph {dev * 1e3:.1f} us "
                  f"({flops / dev / 1e9:.1f} TFLOP/s); dx {dx_ms * 1e3:.1f} "
                  f"us; plain {plain * 1e3:.1f} us; cuBLAS "
                  f"{library * 1e3:.1f} us, in a graph {lib_dev * 1e3:.1f} "
                  f"us; bound {bms * 1e3:.1f} us ({by}, FFMA), tensor-core "
                  f"bound {tms * 1e3:.1f} us ({tby}, 3 TF32 products)")
    return max_err, shapes


def wave_probe(gen):
    """Device time of the projection kernels at the tiny model's reduction
    (K = 128, four steps of 32) on grids of 1, 132 and 264 output tiles of
    128 x 128 (one CTA an SM: a lone CTA, one and two full waves on 132
    SMs), in
    a CUDA graph: the fixed cost of a launch and the time of a wave."""
    import torch
    from repro_torch.kernels import int4_matmul as i4, lora_matmul as lm
    from repro_torch.peft import lora
    rows = []
    with torch.no_grad():
        for tiles in (1, 132, 264):
            M = 128 * tiles
            x = _randn(gen, (1, M, 128))
            w = _randn(gen, (128, 128), 128 ** -0.5)
            a = _randn(gen, (1, 128, 4), 128 ** -0.5)
            b = _randn(gen, (1, 4, 128), 0.1)
            packed, scales = lora.quantize(_randn(gen, (128, 128), 0.1), 64)
            rows.append(dict(
                tiles=tiles,
                lora_graph_ms=graph_ms(lambda: lm._launch(x, w, a, b, 2.0)),
                int4_graph_ms=graph_ms(lambda: i4.int4_matmul(
                    x[0], packed, scales, 64, torch.bfloat16))))
            print(f"  wave probe, {tiles} tiles of 128 x 128, K=128: "
                  f"lora_matmul {rows[-1]['lora_graph_ms'] * 1e3:.2f} us, "
                  f"int4_matmul {rows[-1]['int4_graph_ms'] * 1e3:.2f} us "
                  "(CUDA graph)")
    return rows


def attn_pairs(S: int, causal: bool = True, window: int = 0) -> int:
    """Attendable (query, key) pairs of one head: what the data needs."""
    q = [min(S, i + 1) if causal else S for i in range(S)]
    if window:
        q = [min(n, window) if causal else n for n in q]
    return sum(q)


def attn_flops_bytes(B, S, H, KH, D, backward=False, elem=4):
    pairs = B * H * attn_pairs(S)
    q = B * S * H * D
    kv = 2 * B * S * KH * D
    if not backward:     # S = QK^T and PV, 2 D flops each per pair
        return 4 * D * pairs, elem * (2 * q + kv) + 4 * B * H * S
    # S, dP, dV, dK, dQ: 10 D flops per pair; read q k v o dO lse, write
    # dq dk dv
    return 10 * D * pairs, elem * (4 * q + 2 * kv) + 4 * B * H * S


# tile edges of the 64-row / 64-key tiles: (B, S, H, KH, D, causal,
# window, dtype).  Above 64 keys an odd B·S·H puts the backward's dQ slabs
# 4 bytes off the workspace's rowsum(dO O) area unless it is padded.
ATTN_EDGES = tuple(
    [(2, S, 4, 2, 32, True, 0, "float32") for S in (1, 63, 64, 65, 128, 129)]
    + [(2, 65, 2 * G, 2, 64, True, 0, "float32") for G in (1, 4, 8)]
    + [(2, 129, 4, 2, D, True, 0, "float32") for D in (64, 128)]
    + [(2, 129, 4, 2, 32, True, w, "float32") for w in (16, 64)]
    + [(2, 129, 8, 2, 64, False, 0, "float32"),
       (2, 129, 16, 2, 128, True, 64, "float32")]
    + [(2, S, 4, 2, 64, True, 0, "bfloat16") for S in (63, 129)]
    + [(2, 100, 8, 2, 128, False, 16, "bfloat16")]
    + [(1, S, 1, 1, D, True, 0, "float32") for S in (65, 129)
       for D in (32, 64, 128)]
    + [(3, 129, 3, KH, 64, True, 0, "float32") for KH in (1, 3)]
    + [(1, 129, 1, 1, 64, True, 0, "bfloat16")])


def attn_check(gen, name, B, S, H, KH, D, causal, window, dtype):
    """Forward and dq/dk/dv of one case against ``ref`` and plain
    autograd: 2e-5 (float32) or 2e-2 (bfloat16) of the largest magnitude.
    Returns the float32 max abs errors (forward, backward)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ref
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    q = _randn(gen, (B, S, H, D), dtype=dtype).requires_grad_()
    k = _randn(gen, (B, S, KH, D), dtype=dtype).requires_grad_()
    v = _randn(gen, (B, S, KH, D), dtype=dtype).requires_grad_()
    do = _randn(gen, (B, S, H, D), dtype=dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    g = torch.autograd.grad(got, (q, k, v), do)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    gw = torch.autograd.grad(want, (q, k, v), do)
    err = rel_err(got, want)
    check(err <= tol, f"flash_attention {name}: error {err} > {tol}")
    for what, u, w in zip(("dq", "dk", "dv"), g, gw):
        e = rel_err(u, w)
        check(e <= tol, f"flash_attention_bwd {name} {what}: relative error "
              f"{e} > {tol}")
    if dtype == torch.bfloat16:
        return 0.0, 0.0
    return abs_err(got, want), max(abs_err(u, w) for u, w in zip(g, gw))


def attn_phase(gen):
    """flash_attention forward and backward against ``ref`` and plain
    autograd, the backward's bitwise repeatability; times against SDPA;
    the probe."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    max_err, max_bwd_err, cases = 0.0, 0.0, 0
    # the JAX kernel test's sweep in its (B, H, S, D) layout, read through
    # transposed views, both dtypes: its tolerances
    for (B, H, S, D) in ((1, 2, 128, 64), (2, 4, 256, 64), (1, 1, 512, 128)):
        for window in (0, 64):
            for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                q, k, v = (_randn(gen, (B, H, S, D), dtype=dt).transpose(1, 2)
                           for _ in range(3))
                got = fa.flash_attention(q, k, v, causal=True, window=window)
                want = ref.flash_attention(q, k, v, causal=True,
                                           window=window)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                if dt == torch.float32:
                    max_err = max(max_err, abs_err(got, want))
                cases += 1
    # grouped heads, masks, the main paths' shapes and the tile edges:
    # forward and backward
    for name, B, S, H, KH, D, causal, window, dt in (
            [(n, B, S, H, KH, D, True, 0, "float32")
             for n, B, S, H, KH, D in ATTN_SHAPES]
            + [("non-causal", 2, 128, 4, 2, 32, False, 0, "float32"),
               ("window", 3, 100, 4, 1, 64, True, 16, "float32"),
               ("head-dim-128", 2, 70, 2, 2, 128, False, 24, "float32")]
            + [(f"edge B={B} S={S} H={H} KH={KH} D={D} causal={c} "
                f"window={w} {dt}", B, S, H, KH, D, c, w, dt)
               for B, S, H, KH, D, c, w, dt in ATTN_EDGES]):
        fe, be = attn_check(gen, name, B, S, H, KH, D, causal, window,
                            getattr(torch, dt))
        max_err, max_bwd_err = max(max_err, fe), max(max_bwd_err, be)
        cases += 1
    # the backward twice on the same inputs: bitwise equal (one k-tile at
    # the main paths' shapes; k-tile slabs summed in a fixed order above)
    repeats = 0
    for name, B, S, H, KH, D in ATTN_SHAPES + (
            ("three k-tiles", 2, 160, 8, 2, 64),
            ("three k-tiles, odd B·S·H", 3, 129, 3, 1, 64)):
        q, do = _randn(gen, (B, S, H, D)), _randn(gen, (B, S, H, D))
        k, v = _randn(gen, (B, S, KH, D)), _randn(gen, (B, S, KH, D))
        out, lse = fa._forward(q, k, v, True, 0, D ** -0.5)
        first = fa.flash_attention_bwd(q, k, v, out, lse, do)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"flash_attention_bwd {name}: two runs differ")
        repeats += 1
    torch.cuda.synchronize()
    print(f"kernel phase: flash_attention == plain on {cases} cases "
          f"({len(ATTN_EDGES)} at tile edges), max abs err {max_err:.3g} "
          f"forward, {max_bwd_err:.3g} backward (tolerance: the JAX "
          "sweep's 2e-5 float32 / 2e-2 bfloat16; elsewhere 2e-5 / 2e-2 of "
          "the largest magnitude: online softmax and TF32-split products "
          f"against a full float32 softmax); backward bitwise equal across "
          f"two runs on {repeats} shapes")

    fwd, bwd = [], []
    for name, B, S, H, KH, D in ATTN_SHAPES:
        q = _randn(gen, (B, S, H, D)).requires_grad_()
        k = _randn(gen, (B, S, KH, D)).requires_grad_()
        v = _randn(gen, (B, S, KH, D)).requires_grad_()
        do = _randn(gen, (B, S, H, D))
        with torch.no_grad():
            out, lse = fa._forward(q, k, v, True, 0, D ** -0.5)
            ms = cuda_ms(lambda: fa._forward(q, k, v, True, 0, D ** -0.5),
                         iters=100)
            plain = cuda_ms(lambda: ref.flash_attention(q, k, v), iters=50)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            library = cuda_ms(sdpa, iters=100)
            dev = graph_ms(lambda: fa._forward(q, k, v, True, 0, D ** -0.5))
            lib_dev = graph_ms(sdpa)
            bms, by = bound_ms(*attn_flops_bytes(B, S, H, KH, D))
            # on the tensor cores at float32 accuracy: 3 TF32 products
            tms, tby = tc_bound_ms(3, *attn_flops_bytes(B, S, H, KH, D))
        fwd.append(dict(shape=name, B=B, S=S, H=H, KH=KH, D=D, ms=ms,
                        graph_ms=dev, plain_ms=plain, library_ms=library,
                        library_graph_ms=lib_dev, bound_ms=bms, bound_by=by,
                        tc_bound_ms=tms, tc_bound_by=tby))
        b_ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do),
                       iters=100)
        b_dev = graph_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                        do))
        y = ref.flash_attention(q, k, v)
        b_plain = cuda_ms(lambda: torch.autograd.grad(
            y, (q, k, v), do, retain_graph=True), iters=50)
        ys = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        dos = do.transpose(1, 2)
        b_lib = cuda_ms(lambda: torch.autograd.grad(
            ys, (q, k, v), dos, retain_graph=True), iters=50)
        bbms, bby = bound_ms(*attn_flops_bytes(B, S, H, KH, D, True))
        btms, btby = tc_bound_ms(3, *attn_flops_bytes(B, S, H, KH, D, True))
        bwd.append(dict(shape=name, B=B, S=S, H=H, KH=KH, D=D, ms=b_ms,
                        graph_ms=b_dev, plain_ms=b_plain, library_ms=b_lib,
                        bound_ms=bbms, bound_by=bby, tc_bound_ms=btms,
                        tc_bound_by=btby))
        print(f"  {name} (B={B} S={S} H={H} KH={KH} D={D}): forward "
              f"{ms * 1e3:.2f} us (graph {dev * 1e3:.2f} us), plain "
              f"{plain * 1e3:.1f} us, SDPA {library * 1e3:.1f} us (graph "
              f"{lib_dev * 1e3:.2f} us), bound {bms * 1e3:.2f} us ({by}, "
              f"FFMA), tensor-core {tms * 1e3:.2f} us ({tby}, 3 TF32 "
              f"products); backward {b_ms * 1e3:.2f} us (graph "
              f"{b_dev * 1e3:.2f} us), plain {b_plain * 1e3:.1f} us, SDPA "
              f"{b_lib * 1e3:.1f} us, bound {bbms * 1e3:.2f} us ({bby}, "
              f"FFMA), tensor-core {btms * 1e3:.2f} us ({btby})")
    return max_err, max_bwd_err, fwd, bwd, attn_probe(gen)


# (model, G, D) of the main paths' attention: G q-heads share a kv-head
ATTN_PROBE = (("tiny", 2, 32), ("llama", 4, 64))


def attn_probe(gen):
    """Device time (CUDA graph) of flash_attention forward and backward on
    small grids, at the main paths' head dims and grouping, causal:
    (B=1, S=32, H=KH=1) is a grid of one CTA for every entry point;
    (B=1, S=64, H=G, KH=1) is the work of one (sequence, kv-head) at the
    main paths' length: G forward CTAs and one backward CTA; B=132 is
    that 132 times, a wave of one backward CTA an SM; and the main path's
    own shape."""
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for model, G, D in ATTN_PROBE:
        main = next(s for s in ATTN_SHAPES if s[0] == model)
        for what, B, S, H, KH in (("grid of one", 1, 32, 1, 1),
                                  ("one kv-head", 1, 64, G, 1),
                                  ("wave of 132", 132, 64, G, 1),
                                  ("main path", *main[1:5])):
            q = _randn(gen, (B, S, H, D))
            k, v = _randn(gen, (B, S, KH, D)), _randn(gen, (B, S, KH, D))
            do = _randn(gen, (B, S, H, D))
            out, lse = fa._forward(q, k, v, True, 0, D ** -0.5)
            row = dict(model=model, probe=what, B=B, S=S, H=H, KH=KH, D=D,
                       fwd_graph_ms=graph_ms(
                           lambda: fa._forward(q, k, v, True, 0, D ** -0.5)),
                       bwd_graph_ms=graph_ms(
                           lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                          do)))
            rows.append(row)
            print(f"  attention probe, {model} {what} (B={B} S={S} H={H} "
                  f"KH={KH} D={D}): forward {row['fwd_graph_ms'] * 1e3:.2f} "
                  f"us, backward {row['bwd_graph_ms'] * 1e3:.2f} us "
                  "(CUDA graph)")
    return rows


# ---------------------------------------------------------------------------
# phase 2: int4_matmul (NN and NT) and distill_kl against their plain versions
# ---------------------------------------------------------------------------
# Rows of each int4_matmul launch on the QLoRA paths: the client axis
# folded into the rows (tiny-llm C=5 × 16 × 64 a train step, 5 × 50 × 64
# in the evaluation; llama3.2-1b widths C=4 × 16 × 64), qblock 64.
INT4_SHAPES = (
    [("tiny-" + n, 5120, K, N) for n, (K, N) in TINY_PROJ.items()]
    + [("tiny-eval-w_in", 16000, 128, 512)]
    + [("llama-" + n, 4096, K, N) for n, (K, N) in WIDE_PROJ.items()])
KL_SHAPES = ((64, 2), (256, 3), (512, 7), (100, 10), (4096, 4102))


def int4_flops_bytes(M, K, N, qblock=64):
    """NN and NT alike: 2MKN flops; x (or dy) and the output in float32,
    the packed weight at half a byte and its scales."""
    return 2 * M * K * N, 4 * M * K + K * N // 2 + 4 * K * N // qblock \
        + 4 * M * N


def int4_phase(gen):
    """int4_matmul NN (float32 and bf16 rounding) and NT against
    ``ref.int4_matmul``/``int4_matmul_t``; times at the QLoRA paths'
    shapes against the bound, the plain version and torch's dequantize
    followed by cuBLAS float32."""
    import torch
    from repro_torch.kernels import int4_matmul as i4, ref
    from repro_torch.peft import lora
    max_err, max_t_err, cases = 0.0, 0.0, 0
    # the JAX kernel test's sweep, float32 rounding (the JAX oracle's)
    for (M, K, N) in ((128, 256, 256), (64, 512, 384), (256, 128, 512)):
        for qb in (32, 64):
            x = _randn(gen, (M, K))
            packed, scales = lora.quantize(_randn(gen, (K, N), 0.05), qb)
            got = i4.int4_matmul(x, packed, scales, qb)
            want = ref.int4_matmul(x, packed, scales, qb)
            err = rel_err(got, want)
            check(err <= 2e-5, f"int4_matmul M={M} K={K} N={N} qblock={qb}: "
                  f"relative error {err} > 2e-5")
            max_err = max(max_err, abs_err(got, want))
            cases += 1
    # the paths' shapes with bf16 rounding (the model's), NN and NT
    bf16 = torch.bfloat16
    for name, M, K, N in INT4_SHAPES:
        x = _randn(gen, (M, K))
        dy = _randn(gen, (M, N))
        packed, scales = lora.quantize(_randn(gen, (K, N), K ** -0.5), 64)
        for what, got, want in (
                ("NN", i4.int4_matmul(x, packed, scales, 64, bf16),
                 ref.int4_matmul(x, packed, scales, 64, bf16)),
                ("NT", i4.int4_matmul_t(dy, packed, scales, 64, bf16),
                 ref.int4_matmul_t(dy, packed, scales, 64, bf16))):
            err = rel_err(got, want)
            check(err <= 2e-5, f"int4_matmul {what} {name}: relative error "
                  f"{err} > 2e-5")
            if what == "NN":
                max_err = max(max_err, abs_err(got, want))
            else:
                max_t_err = max(max_t_err, abs_err(got, want))
        cases += 1
    torch.cuda.synchronize()
    print(f"kernel phase: int4_matmul == plain on {cases} cases (NN with "
          "float32 rounding over the JAX sweep; NN and NT with bf16 "
          "rounding at the QLoRA paths' shapes), max abs err "
          f"{max_err:.3g} NN, {max_t_err:.3g} NT (tolerance 2e-5 of the "
          "largest magnitude: float32 sums in another order than cuBLAS's)")

    nn, nt = [], []
    with torch.no_grad():
        for name, M, K, N in INT4_SHAPES:
            x = _randn(gen, (M, K))
            dy = _randn(gen, (M, N))
            packed, scales = lora.quantize(_randn(gen, (K, N), K ** -0.5), 64)
            w = lora.dequantize(packed, scales, 64, dtype=torch.float32)
            big = K * N >= 1 << 24
            it, n_graph = (10, 3) if big else (100, 20)
            flops, nbytes = int4_flops_bytes(M, K, N)
            bms, by = bound_ms(flops, nbytes)
            tms, tby = tc_bound_ms(2, flops, nbytes)
            for rows, fn, plain, lib, cublas in (
                    (nn, lambda: i4.int4_matmul(x, packed, scales, 64,
                                                bf16),
                     lambda: ref.int4_matmul(x, packed, scales, 64, bf16),
                     lambda: x @ lora.dequantize(packed, scales, 64,
                                                 torch.float32),
                     lambda: x @ w),
                    (nt, lambda: i4.int4_matmul_t(dy, packed, scales, 64,
                                                  bf16),
                     lambda: ref.int4_matmul_t(dy, packed, scales, 64, bf16),
                     lambda: dy @ lora.dequantize(packed, scales, 64,
                                                  torch.float32).t(),
                     lambda: dy @ w.t())):
                ms = cuda_ms(fn, iters=it)
                dev = graph_ms(fn, n_graph)
                rows.append(dict(
                    shape=name, M=M, K=K, N=N, qblock=64, ms=ms,
                    graph_ms=dev, plain_ms=cuda_ms(plain, iters=it),
                    library_ms=cuda_ms(lib, iters=it),
                    library_graph_ms=graph_ms(lib, n_graph),
                    cublas_ms=cuda_ms(cublas, iters=it),
                    bound_ms=bms, bound_by=by, tc_bound_ms=tms,
                    tc_bound_by=tby, tc_products=2,
                    tflops=flops / dev / 1e9, gflop=flops / 1e9))
            a, b = nn[-1], nt[-1]
            print(f"  {name} (M={M} K={K} N={N}): NN {a['ms'] * 1e3:.1f} us, "
                  f"graph {a['graph_ms'] * 1e3:.1f} us "
                  f"({flops / a['graph_ms'] / 1e9:.1f} TFLOP/s); NT "
                  f"{b['ms'] * 1e3:.1f} us, graph {b['graph_ms'] * 1e3:.1f} "
                  f"us; plain {a['plain_ms'] * 1e3:.1f} us; dequantize + "
                  f"cuBLAS {a['library_ms'] * 1e3:.1f} us (graph "
                  f"{a['library_graph_ms'] * 1e3:.1f} us), cuBLAS alone "
                  f"{a['cublas_ms'] * 1e3:.1f} us; bound {bms * 1e3:.1f} us "
                  f"({by}, FFMA), tensor-core bound {tms * 1e3:.1f} us "
                  f"({tby}, 2 TF32 products)")
    return max_err, max_t_err, nn, nt


def kl_phase(gen):
    """distill_kl against ``ref.distill_kl`` over the JAX sweep and the
    task vocabulary; times at (4096, 4102)."""
    import torch
    from repro_torch.kernels import distill_kl as dk, ref
    max_err = 0.0
    for B, C in KL_SHAPES:
        t = torch.softmax(_randn(gen, (B, C)), -1)
        z = _randn(gen, (B, C), 3.0)
        got = dk.distill_kl(t, z)
        want = ref.distill_kl(t, z)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        check(bool((got >= -1e-6).all()), f"distill_kl B={B} C={C}: "
              f"negative KL {float(got.min())}")
        max_err = max(max_err, abs_err(got, want))
    torch.cuda.synchronize()
    print(f"kernel phase: distill_kl == plain on {len(KL_SHAPES)} cases, max "
          f"abs err {max_err:.3g} (tolerance rtol 1e-5, atol 1e-6, the JAX "
          "test's; every value >= -1e-6)")
    B, C = KL_SHAPES[-1]
    t = torch.softmax(_randn(gen, (B, C)), -1)
    z = _randn(gen, (B, C), 3.0)
    ms = cuda_ms(lambda: dk.distill_kl(t, z), iters=100)
    dev = graph_ms(lambda: dk.distill_kl(t, z))
    plain = cuda_ms(lambda: ref.distill_kl(t, z), iters=50)
    # 2 transcendentals and ~6 flops an element; bytes: t and z once, (B,)
    bms, by = bound_ms(8 * B * C, 8 * B * C + 4 * B)
    row = dict(shape=f"B={B} C={C}", B=B, C=C, ms=ms, graph_ms=dev,
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None)
    print(f"  B={B} C={C}: kernel {ms * 1e3:.1f} us, graph {dev * 1e3:.1f} "
          f"us, plain {plain * 1e3:.1f} us, bound {bms * 1e3:.1f} us ({by}); "
          "no single PyTorch call computes it")
    return max_err, [row]


# ---------------------------------------------------------------------------
# phases 3 and 4: the port's main path through its entry points
# ---------------------------------------------------------------------------
def run_main_path(device, cfg, method="qfl", llm_outputs=None,
                  engine="batched", optimizer="nelder-mead",
                  backend="exact", share_devices=False, **extra):
    """One federated run; returns (task, result, orchestrator)."""
    from repro_torch.core.orchestrator import Orchestrator, RunConfig
    from repro_torch.data.tasks import build_task
    task = build_task("genomic", **cfg["task"])
    rc = RunConfig(method=method, optimizer=optimizer, engine=engine,
                   backend=backend, **dict(cfg["run"], **extra))
    orch = Orchestrator(task, rc, device=device, llm_outputs=llm_outputs,
                        share_devices=share_devices)
    res = orch.run()
    return task, res, orch


def _counted():
    """(name, counted function) of every launch counter."""
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import statevector_gates as svg
    from repro_torch.kernels import statevector_tape as svt
    from repro_torch.quantum import tape
    return (("statevector_gate", svg.statevector_gate, "launches"),
            ("statevector_tape", svt.statevector_tape, "launches"),
            ("replays", tape.run_tape, "replays"),
            ("lora_matmul", lm.lora_matmul, "launches"),
            ("flash_attention", fa.flash_attention, "launches"),
            ("flash_attention_bwd", fa.flash_attention_bwd, "launches"),
            ("flash_attention_bwd_side", fa.flash_attention_bwd,
             "side_launches"),
            ("int4_matmul", i4.int4_matmul, "launches"),
            ("int4_matmul_t", i4.int4_matmul_t, "launches"),
            ("distill_kl", dk.distill_kl, "launches"))


def zero_counters():
    for _, fn, attr in _counted():
        setattr(fn, attr, 0)


def read_counters() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _counted()}


def llm_launch_formula(steps: int, n_layers: int, n_proj: int = 5,
                       clients: int = 1, evals: int = 1) -> dict:
    """Launches of one run of the LLM stage (Step 1).

    Each train step runs every adapted projection (wq, wkv, wo, w_in,
    w_out) forward, and its dx backward except layer 0's wq and wkv,
    whose input (the normed embedding of frozen tokens) needs no
    gradient: steps × (2 · layers · 5 − 2).  Each evaluation forward then
    runs every projection once: layers · 5.  Attention runs one forward
    per layer and step plus each evaluation's, and one backward per layer
    and step.  The batched engine trains and evaluates every client in
    each launch (``clients=1, evals=1``); the sequential stage runs each
    of its C clients alone and evaluates three times (``eval_loss``,
    ``f1``, ``teacher_probs``, as the JAX package's ``LLMClient``):
    ``clients=C, evals=3``.
    """
    return {"lora_matmul": clients * (steps * (2 * n_layers * n_proj - 2)
                                      + evals * n_layers * n_proj),
            "flash_attention": clients * (steps * n_layers
                                          + evals * n_layers),
            "flash_attention_bwd": clients * steps * n_layers}


def compare_runs(gpu, cpu, loss_tol=1e-5, theta_tol=1e-4, what="cuda/cpu"):
    """One run against another (the card's against the plain path on the
    CPU, or one engine against the other): integer accounting exactly,
    losses within 1e-5 and θ_g within 1e-4 unless stated (the JAX
    package's own engine-parity tolerances)."""
    import numpy as np
    for attr in ("maxiters", "selected", "cum_evals"):
        check(gpu.series(attr) == cpu.series(attr),
              f"{what}: {attr} differ: {gpu.series(attr)} against "
              f"{cpu.series(attr)}")
    check(len(gpu.rounds) == len(cpu.rounds), f"{what}: round counts differ")
    np.testing.assert_allclose(gpu.series("server_loss"),
                               cpu.series("server_loss"), atol=loss_tol,
                               rtol=0, err_msg=what)
    np.testing.assert_allclose(gpu.series("client_losses"),
                               cpu.series("client_losses"), atol=loss_tol,
                               rtol=0, err_msg=what)
    np.testing.assert_allclose(gpu.theta_g, cpu.theta_g, atol=theta_tol,
                               rtol=0, err_msg=what)
    return (float(np.max(np.abs(np.subtract(gpu.series("server_loss"),
                                            cpu.series("server_loss"))))),
            float(np.max(np.abs(gpu.theta_g - cpu.theta_g))))


def check_tape_launches(n: dict, what: str):
    """Up to the tape kernel's limit (14 qubits; every path here) each
    tape replay is one statevector_tape launch and no statevector_gate."""
    check(n["statevector_tape"] == n["replays"] > 0
          and n["statevector_gate"] == 0,
          f"{what}: {n['statevector_tape']} statevector_tape and "
          f"{n['statevector_gate']} statevector_gate launches for "
          f"{n['replays']} tape replays (size rule: one statevector_tape a "
          "replay up to 14 qubits)")


def main_phase():
    zero_counters()
    t0 = time.perf_counter()
    task, gpu, orch = run_main_path("cuda", QUICKSTART)
    wall = time.perf_counter() - t0
    n = read_counters()
    check_tape_launches(n, "qfl quickstart")
    launches, replays = n["statevector_tape"], n["replays"]
    for r, s in zip(gpu.rounds, orch.round_seconds):
        print(f"  round {r.t}: server loss {r.server_loss:.6f} val acc "
              f"{r.server_val_acc:.3f} test acc {r.server_test_acc:.3f} "
              f"cum evals {r.cum_evals} wall {s:.3f} s")
    print(f"main path (cuda): {len(gpu.rounds)} rounds in {wall:.2f} s, "
          f"{replays} tape replays, statevector_tape launches {launches}, "
          f"statevector_gate launches {n['statevector_gate']}")
    t0 = time.perf_counter()
    _, cpu, _ = run_main_path("cpu", QUICKSTART)
    loss_gap, theta_gap = compare_runs(gpu, cpu)
    print(f"main path (cpu, plain) in {time.perf_counter() - t0:.2f} s: "
          f"equal maxiters/selected/cum_evals; max |Δ server loss| "
          f"{loss_gap:.3g}, max |Δ θ_g| {theta_gap:.3g}")
    return dict(counts=n, wall_s=wall, round_s=orch.round_seconds, gpu=gpu,
                cpu=cpu)


def llm_phase() -> dict:
    """The LLM-QFL quickstart on the card, held to the CPU's plain path."""
    import numpy as np
    zero_counters()
    t0 = time.perf_counter()
    task, gpu, orch = run_main_path("cuda", LLM_QUICKSTART, method="llm-qfl")
    wall = time.perf_counter() - t0
    n = read_counters()
    want = llm_launch_formula(LLM_QUICKSTART["run"]["llm_steps"], 2)
    for name, count in want.items():
        check(n[name] == count > 0, f"llm-qfl: {n[name]} {name} launches, "
              f"the formula gives {count}")
    check(n["int4_matmul"] == n["int4_matmul_t"] == 0,
          f"llm-qfl: int4_matmul launched on a float32 base: {n}")
    check_one_k_tile(n, "llm-qfl")
    check_tape_launches(n, "llm-qfl")
    for r, s in zip(gpu.rounds, orch.round_seconds):
        print(f"  round {r.t}: maxiters {r.maxiters} selected {r.selected} "
              f"server loss {r.server_loss:.6f} cum evals {r.cum_evals} "
              f"wall {s:.3f} s")
    print(f"llm-qfl path (cuda): fine-tune {gpu.llm_finetune_time_s:.2f} s "
          f"(30 steps, tiny-llm, 5 clients), {len(gpu.rounds)} rounds, "
          f"{wall:.2f} s in all; L_LLM {np.round(gpu.llm_losses, 4).tolist()}"
          f" F1 {np.round(gpu.llm_f1, 4).tolist()}; launches "
          f"{json.dumps(n)}")

    # Step 1 on the CPU (plain path), against the card's
    t0 = time.perf_counter()
    step1 = dict(LLM_QUICKSTART, run=dict(LLM_QUICKSTART["run"], n_rounds=1))
    _, cpu1, orch1 = run_main_path("cpu", step1, method="llm-qfl")
    d_loss = float(np.max(np.abs(np.subtract(gpu.llm_losses,
                                             cpu1.llm_losses))))
    d_f1 = float(np.max(np.abs(np.subtract(gpu.llm_f1, cpu1.llm_f1))))
    d_teacher = max(float(np.max(np.abs(a - b))) for a, b in zip(
        orch.llm_outputs.teacher_probs, orch1.llm_outputs.teacher_probs))
    check(d_loss <= LLM_LOSS_TOL and d_f1 <= LLM_F1_TOL
          and d_teacher <= TEACHER_TOL,
          f"llm-qfl Step 1, cuda vs cpu: |Δ L_LLM| {d_loss}, |Δ F1| {d_f1}, "
          f"|Δ teacher| {d_teacher} (tolerances {LLM_LOSS_TOL}, "
          f"{LLM_F1_TOL}, {TEACHER_TOL})")
    print(f"llm-qfl Step 1 (cpu, plain) in {cpu1.llm_finetune_time_s:.2f} s: "
          f"max |Δ L_LLM| {d_loss:.3g}, |Δ F1| {d_f1:.3g}, |Δ teacher| "
          f"{d_teacher:.3g}")

    # the quantum rounds on the CPU, fed the card's Step 1
    t0 = time.perf_counter()
    _, cpu2, _ = run_main_path("cpu", LLM_QUICKSTART, method="llm-qfl",
                               llm_outputs=orch.llm_outputs)
    loss_gap, theta_gap = compare_runs(gpu, cpu2)
    print(f"llm-qfl rounds (cpu, plain, on the card's Step 1) in "
          f"{time.perf_counter() - t0:.2f} s: equal maxiters/selected/"
          f"cum_evals; max |Δ server loss| {loss_gap:.3g}, max |Δ θ_g| "
          f"{theta_gap:.3g}")
    return dict(counts=n, wall_s=wall, finetune_s=gpu.llm_finetune_time_s,
                round_s=orch.round_seconds, gpu=gpu,
                llm_outputs=orch.llm_outputs)


def wide_phase():
    import numpy as np
    import torch
    from repro_torch.quantum import qnn, tape
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task, res, _ = run_main_path("cuda", WIDE)
    wall = time.perf_counter() - t0
    n = read_counters()
    check_tape_launches(n, "wide")
    cq = tape.compile_qnn(qnn.QNNSpec("vqc", n_qubits=10))
    check(cq.tape.n_gates == 485, f"10-qubit tape has {cq.tape.n_gates}")
    r = res.rounds[-1]
    check(np.all(np.isfinite(r.client_losses)) and math.isfinite(
        r.server_loss), f"non-finite losses {r.client_losses}")
    X = torch.as_tensor(task.val_qX, device="cuda")
    theta = torch.as_tensor(res.theta_g, dtype=torch.float32, device="cuda")
    re, im = tape.run_tape(cq.tape, tape.tape_angles(cq.tape, X, theta))
    norm_err = float(((re * re + im * im).sum(-1) - 1).abs().max())
    check(norm_err <= 1e-5, f"statevector norms off by {norm_err}")
    print(f"wide phase (10 qubits, 485 gates, 8 clients): {wall:.2f} s, "
          f"server loss {r.server_loss:.6f}, {n['replays']} replays, "
          f"statevector_tape launches {n['statevector_tape']}, "
          f"statevector_gate launches {n['statevector_gate']}, max "
          f"|norm-1| {norm_err:.3g}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return n


def size_rule_phase(n_qubits: int = SIZE_RULE_QUBITS,
                    rows: int = SIZE_RULE_ROWS) -> dict:
    """``tape.tape_probs`` above the tape kernel's limit: a VQC of
    ``n_qubits`` on ``rows`` rows, where ``run_tape`` replays with one
    statevector_gate launch a gate; held to the CPU's plain path."""
    import numpy as np
    import torch
    from repro_torch.kernels import statevector_tape as svt
    from repro_torch.quantum import qnn, tape
    check(n_qubits > svt.MAX_QUBITS, f"{n_qubits} qubits fit the tape kernel")
    spec = qnn.QNNSpec("vqc", n_qubits=n_qubits)
    cq = tape.compile_qnn(spec)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, np.pi, (rows, n_qubits)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, spec.n_params).astype(np.float32)
    zero_counters()
    probs = tape.tape_probs(cq, torch.from_numpy(theta).cuda(),
                            torch.from_numpy(X).cuda())
    torch.cuda.synchronize()
    n = read_counters()
    G = cq.tape.n_gates
    check(n["statevector_gate"] == G * n["replays"] > 0
          and n["statevector_tape"] == 0,
          f"size rule: {n['statevector_gate']} statevector_gate and "
          f"{n['statevector_tape']} statevector_tape launches for "
          f"{n['replays']} replays of {G} gates at {n_qubits} qubits")
    want = tape.tape_probs(cq, torch.from_numpy(theta), torch.from_numpy(X))
    err = float((probs.cpu() - want).abs().max())
    # 1e-5: sin/cos may differ by an ulp between the card and the CPU,
    # over 1065 gates, and a class sums 2**14 probabilities
    check(err <= 1e-5, f"size rule: class probabilities off the CPU's by "
          f"{err}")
    print(f"size-rule phase ({n_qubits}-qubit VQC, {G} gates, {rows} rows, "
          f"above the tape kernel's limit of {svt.MAX_QUBITS}): "
          f"statevector_gate launches {n['statevector_gate']} for "
          f"{n['replays']} replay, statevector_tape launches "
          f"{n['statevector_tape']}; class probabilities within {err:.3g} "
          "of the CPU's")
    return n


def qlora(cfg):
    """The QLoRA variant of an LLM config, as the JAX package enters it."""
    import dataclasses
    return dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, quantize_base=True))


def check_one_k_tile(n: dict, what: str):
    """The main paths' 64 tokens are one k-tile: each backward call is one
    launch, with no rowsum(dO O) or dQ-sum pass beside it."""
    check(n["flash_attention_bwd_side"] == 0,
          f"{what}: {n['flash_attention_bwd_side']} backward side-pass "
          "launches at 64 tokens")


def check_llm_launches(n: dict, want: dict, quantized: bool, what: str):
    """The stage's launches against ``llm_launch_formula``: on a QLoRA
    base every projection is an int4_matmul (forward) or int4_matmul_t
    (dx) launch where a float32 base has a lora_matmul one."""
    for name in ("flash_attention", "flash_attention_bwd"):
        check(n[name] == want[name] > 0, f"{what}: {n[name]} {name} "
              f"launches, the formula gives {want[name]}")
    check_one_k_tile(n, what)
    proj = want["lora_matmul"]
    got = ((n["int4_matmul"] + n["int4_matmul_t"], n["lora_matmul"])
           if quantized else (n["lora_matmul"],
                              n["int4_matmul"] + n["int4_matmul_t"]))
    check(got == (proj, 0), f"{what}: projection launches {n}, the "
          f"formula gives {proj} {'int4' if quantized else 'lora'}_matmul")


def base_bytes(base) -> tuple:
    """(bytes as stored, bytes of the same base in float32)."""
    from repro_torch.tree import tree_leaves
    stored = sum(t.numel() * t.element_size() for t in tree_leaves(base))
    full = sum(t.numel() * 4 for layer in base["layers"]
               for k, t in layer.items() if not k.endswith(("__q", "__s")))
    full += sum(2 * t.numel() * 4 for layer in base["layers"]
                for k, t in layer.items() if k.endswith("__q"))
    full += sum(t.numel() * 4 for k, t in base.items() if k != "layers")
    return stored, full


def time_train_steps(cfg, base, eng, task, bs: int, what: str) -> list:
    """Seconds of 3 further train steps of every client at once through
    the public step function, from the engine's adapters."""
    import torch
    from repro_torch.models import model as M
    step = M.make_train_step(cfg, lr=3e-3)
    rows = torch.arange(bs)
    batch = {k: torch.stack([torch.as_tensor(cl.llm_batch[k][rows])
                             for cl in task.clients]).long().cuda()
             for k in ("tokens", "labels")}
    adapters, opt = eng.adapters, eng.opt_state
    step_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adapters, opt, metrics = step(base, adapters, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(metrics["loss"]).all()), f"{what}: step loss")
    return step_s


def llm_wide_phase(quantized: bool = False) -> dict:
    """The LLM stage alone at llama3.2-1b widths, float32 base (packed
    int4 for every adapted projection if ``quantized``)."""
    import numpy as np
    import torch
    from repro_torch import random as jr
    from repro_torch.core.batched_llm import BatchedLLMEngine
    from repro_torch.core.llm_client import task_llm_config
    from repro_torch.data.tasks import build_task
    from repro_torch.models import model as M
    what = "qlora wide" if quantized else "llm wide"
    task = build_task("genomic", **LLM_WIDE["task"])
    cfg = task_llm_config("llama3.2-1b", task.vocab_size, task.llm_seq_len)
    if quantized:
        cfg = qlora(cfg)
    steps, bs = LLM_WIDE["steps"], LLM_WIDE["batch_size"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stored, full = base_bytes(base)
    n_params = full // 4                  # float32 values the base stands for
    eng = BatchedLLMEngine(task, cfg, base, seed=0, steps=steps,
                           batch_size=bs)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n = read_counters()
    check_llm_launches(n, llm_launch_formula(steps, cfg.n_layers), quantized,
                       what)
    check(np.all(np.isfinite(out.losses)) and np.all(np.isfinite(
        out.final_train_loss)), f"{what}: non-finite losses {out.losses}")
    for i, cl in enumerate(task.clients):
        rows = out.teacher[i, :cl.n].sum(-1)
        check(np.all(np.abs(rows - 1) <= 1e-5),
              f"{what}: teacher rows sum to {rows}")
    step_s = time_train_steps(cfg, base, eng, task, bs, what)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{what} phase (llama3.2-1b widths, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B base values, "
          f"{'int4-packed projections, ' if quantized else ''}"
          f"C={task.n_clients}, {bs} x 64 tokens): base init {init_s:.2f} s, "
          f"base {stored / 2**30:.3f} GiB as stored ({full / 2**30:.3f} GiB "
          f"in float32); run() of {steps} steps + distill + evaluation "
          f"{run_s:.2f} s; train steps "
          f"{', '.join(f'{t:.3f}' for t in step_s)} s; L_LLM "
          f"{np.round(out.losses, 4).tolist()}; launches {json.dumps(n)}; "
          f"peak memory {peak:.2f} GiB")
    return dict(counts=n, step_s=step_s, run_s=run_s, peak_gib=peak,
                n_params=n_params, init_s=init_s, base_bytes=stored,
                base_f32_bytes=full)


def qlora_stage(device, steps: int):
    """The QLoRA LLM stage of the quickstart task (tiny-llm, int4 base,
    5 clients): base draw, engine and ``run()`` on ``device``.  Returns
    (result, wall seconds, base)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.core.batched_llm import BatchedLLMEngine
    from repro_torch.core.llm_client import task_llm_config
    from repro_torch.data.tasks import build_task
    from repro_torch.models import model as M
    task = build_task("genomic", **LLM_QUICKSTART["task"])
    cfg = qlora(task_llm_config("tiny-llm", task.vocab_size,
                                task.llm_seq_len))
    t0 = time.perf_counter()
    base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                         device=device)
    out = BatchedLLMEngine(task, cfg, base, seed=0, steps=steps).run()
    return out, time.perf_counter() - t0, base


def qlora_phase(device="cuda", cpu_device="cpu") -> dict:
    """The QLoRA LLM stage of the quickstart (BatchedLLMEngine, tiny-llm,
    5 clients, 30 steps) on ``device``, held to the same stage on
    ``cpu_device`` (the plain path)."""
    import numpy as np
    steps = LLM_QUICKSTART["run"]["llm_steps"]
    runs = []
    for dev in (device, cpu_device):
        zero_counters()
        out, wall, base = qlora_stage(dev, steps)
        n = read_counters()
        runs.append((out, n, wall, base))
        print(f"qlora stage ({dev}): tiny-llm, int4 base, 5 clients, "
              f"{steps} steps + distill + evaluation in {wall:.2f} s; L_LLM "
              f"{np.round(out.losses, 4).tolist()} F1 "
              f"{np.round(out.f1, 4).tolist()}; launches {json.dumps(n)}")
    (out, n, wall, base), (cpu, _, cpu_wall, cpu_base) = runs
    check_llm_launches(n, llm_launch_formula(steps, 2), True, "qlora")
    equal = total = 0
    for a, b in zip(base["layers"], cpu_base["layers"]):
        for k in a:
            if k.endswith("__q"):
                equal += int((a[k].cpu() == b[k]).sum())
                total += a[k].numel()
    share = equal / total
    check(share >= 0.999, f"qlora: the card packs {share} of the CPU's "
          "base bytes alike")
    d_loss = float(np.max(np.abs(out.losses - cpu.losses)))
    d_f1 = float(np.max(np.abs(out.f1 - cpu.f1)))
    d_teacher = float(np.max(np.abs(out.teacher - cpu.teacher)))
    check(d_loss <= LLM_LOSS_TOL and d_f1 <= LLM_F1_TOL
          and d_teacher <= TEACHER_TOL,
          f"qlora stage, card vs cpu: |Δ L_LLM| {d_loss}, |Δ F1| {d_f1}, "
          f"|Δ teacher| {d_teacher} (tolerances {LLM_LOSS_TOL}, "
          f"{LLM_F1_TOL}, {TEACHER_TOL})")
    print(f"qlora stage: card vs cpu max |Δ L_LLM| {d_loss:.3g}, |Δ F1| "
          f"{d_f1:.3g}, |Δ teacher| {d_teacher:.3g}; packed base bytes "
          f"equal on {share:.6f} of {total}")
    return dict(counts=n, wall_s=wall, cpu_wall_s=cpu_wall)


# ---------------------------------------------------------------------------
# phase 7: the sequential engine and SPSA
# ---------------------------------------------------------------------------
# the quickstart task at full width, its rounds cut to 3: the sequential
# engine reads every objective evaluation back to the host, and 10
# regulated LLM-QFL rounds of it would take minutes
SEQ_QFL = dict(task=QUICKSTART["task"], run=dict(n_rounds=3))
SEQ_LLM = dict(task=QUICKSTART["task"],
               run=dict(n_rounds=3, llm_steps=LLM_QUICKSTART["run"][
                   "llm_steps"]))


def drive(label: str, device: str, cfg, **kw):
    """One run through ``run_experiment``'s path with every launch counter
    set to 0 just before it and read just after; returns (result,
    orchestrator, counts, wall seconds)."""
    import numpy as np
    zero_counters()
    t0 = time.perf_counter()
    _, res, orch = run_main_path(device, cfg, **kw)
    wall = time.perf_counter() - t0
    n = read_counters()
    print(f"  {label} ({device}): {len(res.rounds)} rounds in {wall:.2f} s "
          f"(fine-tune {res.llm_finetune_time_s:.2f} s; rounds "
          f"{', '.join(f'{t:.3f}' for t in orch.round_seconds)} s); "
          f"maxiters {res.series('maxiters')}; cum evals "
          f"{res.series('cum_evals')[-1]}; server loss "
          f"{np.round(res.series('server_loss'), 6).tolist()}; launches "
          f"{json.dumps({k: v for k, v in n.items() if v})}")
    return res, orch, n, wall


def check_no_tape(n: dict, what: str):
    """The sequential engine's forward is the eager circuit: no tape
    replay, no statevector kernel."""
    check(n["replays"] == n["statevector_tape"] == n["statevector_gate"]
          == 0, f"{what}: the sequential engine replayed a tape: {n}")


def sequential_phase() -> dict:
    """The sequential engine (Nelder–Mead and SPSA) and the batched SPSA
    at the quickstart's width, QFL and LLM-QFL, on the card: each held to
    the other engine on the card and to a run on the CPU."""
    import numpy as np
    print("sequential and SPSA phase (genomic, 5 clients x 50 rows, 4-qubit "
          "VQC, tiny-llm 30 Step-1 steps, 3 rounds):")
    wall, counts, gaps = {}, {}, {}

    def run(label, device, cfg, **kw):
        res, orch, n, t = drive(label, device, cfg, **kw)
        if device == "cuda":
            wall[label], counts[label] = t, n
        return res, orch, n

    def hold(name, a, b, loss_tol=1e-5, theta_tol=1e-4):
        compare_runs(a, b, loss_tol, theta_tol, what=name)
        gaps[name] = (
            float(np.max(np.abs(np.subtract(a.series("server_loss"),
                                            b.series("server_loss"))))),
            float(np.max(np.abs(a.theta_g - b.theta_g))))
        print(f"  {name}: equal maxiters/selected/cum_evals; max |Δ server "
              f"loss| {gaps[name][0]:.3g} (tol {loss_tol}), max |Δ θ_g| "
              f"{gaps[name][1]:.3g} (tol {theta_tol})")

    # 1. QFL, Nelder–Mead: sequential against batched, and against the CPU
    seq, _, n = run("qfl nm sequential", "cuda", SEQ_QFL,
                    engine="sequential")
    check_no_tape(n, "qfl nm sequential")
    bat, _, n = run("qfl nm batched", "cuda", SEQ_QFL)
    check_tape_launches(n, "qfl nm batched")
    hold("qfl nm: sequential vs batched (cuda)", seq, bat)
    cpu, _, _ = run("qfl nm sequential", "cpu", SEQ_QFL, engine="sequential")
    hold("qfl nm sequential: cuda vs cpu", seq, cpu)

    # 2. LLM-QFL, Nelder–Mead: the sequential Step 1 and its launches,
    # against the batched Step 1 on the same base; the rounds against the
    # batched rounds on the sequential Step 1
    seq, orch, n = run("llm-qfl nm sequential", "cuda", SEQ_LLM,
                       method="llm-qfl", engine="sequential")
    want = llm_launch_formula(SEQ_LLM["run"]["llm_steps"], 2,
                              clients=SEQ_LLM["task"]["n_clients"], evals=3)
    for name, count in want.items():
        check(n[name] == count > 0, f"llm-qfl sequential: {n[name]} {name} "
              f"launches, the formula gives {count}")
    check(n["int4_matmul"] == n["int4_matmul_t"] == 0,
          f"llm-qfl sequential: int4_matmul launched: {n}")
    check_one_k_tile(n, "llm-qfl sequential")
    check_no_tape(n, "llm-qfl sequential")
    seq_launches = {k: n[k] for k in want}
    print(f"  llm-qfl sequential Step 1 launches {json.dumps(seq_launches)}"
          f" == C·(S·(10L−2) + 3·5L), C·(S·L + 3L), C·S·L (C=5, S=30, L=2)")
    bat, borch, _ = run("llm-qfl nm batched", "cuda", SEQ_LLM,
                        method="llm-qfl")
    d_loss = float(np.max(np.abs(np.subtract(seq.llm_losses,
                                             bat.llm_losses))))
    d_f1 = float(np.max(np.abs(np.subtract(seq.llm_f1, bat.llm_f1))))
    d_teacher = max(float(np.max(np.abs(a - b))) for a, b in zip(
        orch.llm_outputs.teacher_probs, borch.llm_outputs.teacher_probs))
    check(d_loss <= LLM_LOSS_TOL and d_f1 <= LLM_F1_TOL
          and d_teacher <= TEACHER_TOL,
          f"llm-qfl Step 1, sequential vs batched: |Δ L_LLM| {d_loss}, "
          f"|Δ F1| {d_f1}, |Δ teacher| {d_teacher} (tolerances "
          f"{LLM_LOSS_TOL}, {LLM_F1_TOL}, {TEACHER_TOL})")
    gaps["llm-qfl Step 1: sequential vs batched (cuda)"] = (d_loss, d_f1,
                                                            d_teacher)
    print(f"  llm-qfl Step 1, sequential vs batched (cuda, one base): max "
          f"|Δ L_LLM| {d_loss:.3g}, |Δ F1| {d_f1:.3g}, |Δ teacher| "
          f"{d_teacher:.3g}; fine-tune {seq.llm_finetune_time_s:.2f} s "
          f"against {bat.llm_finetune_time_s:.2f} s")
    same = all(seq.series(a) == bat.series(a)
               for a in ("maxiters", "cum_evals", "selected"))
    print(f"  llm-qfl nm rounds, each engine on its own Step 1: integer "
          f"accounting {'equal' if same else 'NOT equal (teacher noise)'}")
    step1 = orch.llm_outputs
    bat2, _, n = run("llm-qfl nm batched, sequential Step 1", "cuda",
                     SEQ_LLM, method="llm-qfl", llm_outputs=step1)
    check_tape_launches(n, "llm-qfl nm batched")
    hold("llm-qfl nm: sequential vs batched (cuda, one Step 1)", seq, bat2,
         loss_tol=1e-4)

    # 3. SPSA: batched against sequential on the card, and against the CPU
    sb, _, n = run("qfl spsa batched", "cuda", SEQ_QFL, optimizer="spsa")
    check_tape_launches(n, "qfl spsa batched")
    tape_launches = n["statevector_tape"]
    ss, _, n = run("qfl spsa sequential", "cuda", SEQ_QFL, optimizer="spsa",
                   engine="sequential")
    check_no_tape(n, "qfl spsa sequential")
    hold("qfl spsa: batched vs sequential (cuda)", sb, ss, 1e-4, 1e-4)
    sc, _, _ = run("qfl spsa batched", "cpu", SEQ_QFL, optimizer="spsa")
    hold("qfl spsa batched: cuda vs cpu", sb, sc, 1e-4, 1e-4)
    lb, _, n = run("llm-qfl spsa batched", "cuda", SEQ_LLM,
                   method="llm-qfl", optimizer="spsa", llm_outputs=step1)
    check_tape_launches(n, "llm-qfl spsa batched")
    tape_launches_llm = n["statevector_tape"]
    ls, _, n = run("llm-qfl spsa sequential", "cuda", SEQ_LLM,
                   method="llm-qfl", optimizer="spsa", engine="sequential",
                   llm_outputs=step1)
    check_no_tape(n, "llm-qfl spsa sequential")
    hold("llm-qfl spsa: batched vs sequential (cuda, one Step 1)", lb, ls,
         1e-4, 1e-3)
    lc, _, _ = run("llm-qfl spsa batched", "cpu", SEQ_LLM, method="llm-qfl",
                   optimizer="spsa", llm_outputs=step1)
    hold("llm-qfl spsa batched: cuda vs cpu (one Step 1)", lb, lc, 1e-4,
         1e-3)
    return dict(wall_s=wall, seq_launches=seq_launches,
                tape_launches=tape_launches,
                tape_launches_llm=tape_launches_llm, gaps=gaps)


def stage_gaps(losses, f1s, teachers, out, task) -> tuple:
    """(|Δ L_LLM|, |Δ F1|, |Δ teacher|) of a stage's per-client outputs
    against a ``BatchedLLMEngine`` result."""
    import numpy as np
    return (float(np.max(np.abs(np.subtract(losses, out.losses)))),
            float(np.max(np.abs(np.subtract(f1s, out.f1)))),
            max(float(np.max(np.abs(np.asarray(t) - out.teacher[
                i, :task.clients[i].n]))) for i, t in enumerate(teachers)))


def llm_wide_sequential_phase(model: str = "llama3.2-1b",
                              task_kw=LLM_WIDE["task"],
                              what: str = "llm wide sequential") -> dict:
    """``run_sequential_stage`` at ``model``'s widths (llama3.2-1b unless
    stated; float32 base, one client a launch) against
    ``BatchedLLMEngine`` on the same base.

    Before any step and after one step the two are held to the
    batched-LLM tolerances.  Each client's head and adapter gradients
    are products of their own in both, so at DeepSeek-LLM-7B's widths a
    client's step is the same arithmetic at C = 1 and C = 2; at
    llama3.2-1b's, ``lora_matmul`` splits the reduction of ``wkv``'s
    small grid at C = 1 alone.  After LLM_WIDE's two steps, AdamW's
    first update of each ``lora_a`` (its step-1 gradient is zero, since
    ``lora_b`` starts at zero) maps every noise-level gradient element to
    ±lr, so such a change of arithmetic order moves L_LLM and the
    teacher by more than 5e-4.  There the sequential stage is held to
    the larger of the tolerance and twice the batched engine's own
    spread (its larger component: one realisation of arithmetic-order
    noise bounding another), measured in the same run: one inert padding
    client in its stack (``pad_to``), or its base's embedding moved by
    one float32 ulp (relative 1.2e-7, seeded), which perturbs every later
    sum where the padding client, computed apart, perturbs none."""
    import numpy as np
    import torch
    from repro_torch import random as jr
    from repro_torch.core.batched_llm import BatchedLLMEngine
    from repro_torch.core.llm_client import (run_sequential_stage,
                                             task_llm_config)
    from repro_torch.data.tasks import build_task
    from repro_torch.models import model as M
    task = build_task("genomic", **task_kw)
    cfg = task_llm_config(model, task.vocab_size, task.llm_seq_len)
    steps, bs = LLM_WIDE["steps"], LLM_WIDE["batch_size"]
    C = task.n_clients
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = base_bytes(base)[1] // 4
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clients, losses, f1s, teachers = run_sequential_stage(
        task, cfg, base, seed=0, steps=steps, batch_size=bs)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    n = read_counters()
    check_llm_launches(n, llm_launch_formula(steps, cfg.n_layers, clients=C,
                                             evals=3), False, what)
    seq_peak = torch.cuda.max_memory_allocated() / 2**30
    teachers = [t.cpu().numpy() for t in teachers]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = BatchedLLMEngine(task, cfg, base, seed=0, steps=steps,
                           batch_size=bs).run()
    bat_s = time.perf_counter() - t0
    gap = stage_gaps(losses, f1s, teachers, out, task)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ulp = dict(base, embed=base["embed"] * (1 + 2.0 ** -23 * torch.randn(
        base["embed"].shape, generator=gen, device="cuda")))

    def batched_gaps(n_steps, ref, params=base, pad_to=None):
        o = BatchedLLMEngine(task, cfg, params, seed=0, steps=n_steps,
                             batch_size=bs, pad_to=pad_to).run()
        return stage_gaps(o.losses, o.f1, [o.teacher[i, :cl.n] for i, cl
                                           in enumerate(task.clients)],
                          ref, task)

    spread = tuple(map(max, batched_gaps(steps, out, pad_to=C + 1),
                       batched_gaps(steps, out, ulp)))
    gaps = {}
    for n_steps in (0, 1):
        _, ls, fs, ts = run_sequential_stage(task, cfg, base, seed=0,
                                             steps=n_steps, batch_size=bs)
        ref = BatchedLLMEngine(task, cfg, base, seed=0, steps=n_steps,
                               batch_size=bs).run()
        gaps[n_steps] = stage_gaps(ls, fs, [t.cpu().numpy() for t in ts],
                                   ref, task)
    gap0, gap1 = gaps[0], gaps[1]
    print(f"{what}: |Δ L_LLM|, |Δ F1|, |Δ teacher| against the batched "
          f"engine before any step {gap0[0]:.3g}, {gap0[1]:.3g}, "
          f"{gap0[2]:.3g}; after 1 step {gap1[0]:.3g}, {gap1[1]:.3g}, "
          f"{gap1[2]:.3g}; after {steps} steps {gap[0]:.3g}, {gap[1]:.3g}, "
          f"{gap[2]:.3g}, the batched engine's own spread (padding client "
          f"or embedding ulp) {spread[0]:.3g}, {spread[1]:.3g}, "
          f"{spread[2]:.3g}; L_LLM sequential "
          f"{np.round(losses, 5).tolist()}, batched "
          f"{np.round(out.losses, 5).tolist()}")
    for n_steps, g in ((0, gap0), (1, gap1)):
        check(g[0] <= LLM_LOSS_TOL and g[1] <= LLM_F1_TOL
              and g[2] <= TEACHER_TOL,
              f"{what} vs batched after {n_steps} steps: {g} (tolerances "
              f"{LLM_LOSS_TOL}, {LLM_F1_TOL}, {TEACHER_TOL})")
    noise = 2 * max(spread[0], spread[2])
    check(gap[0] <= max(LLM_LOSS_TOL, noise) and gap[1] <= LLM_F1_TOL
          and gap[2] <= max(TEACHER_TOL, noise),
          f"{what} vs batched after {steps} steps: {gap}, beyond both the "
          f"tolerances ({LLM_LOSS_TOL}, {LLM_F1_TOL}, {TEACHER_TOL}) and "
          f"twice the batched engine's own spread {spread}")
    # one more train step of each client alone (C = 1), timed
    step_s = []
    for i, cl in enumerate(clients):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = cl.fine_tune(task.clients[i].llm_batch, steps=1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        check(math.isfinite(last), f"{what}: client {i} step loss {last}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{what} phase ({model} widths, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B base values, C={C} one at a time, {bs} x "
          f"64 tokens, {steps} steps): base draw {init_s:.2f} s (peak "
          f"{init_peak:.2f} GiB); stage {seq_s:.2f} s against the batched "
          f"engine's {bat_s:.2f} s; per-client train steps "
          f"{', '.join(f'{t:.3f}' for t in step_s)} s; launches "
          f"{json.dumps({k: v for k, v in n.items() if v})}; peak memory "
          f"{seq_peak:.2f} GiB in the sequential stage, {peak:.2f} GiB in "
          "all")
    return dict(counts=n, stage_s=seq_s, batched_s=bat_s, step_s=step_s,
                peak_gib=peak, seq_peak_gib=seq_peak, gap=gap, gap1=gap1,
                spread=spread, gap0=gap0, init_s=init_s,
                init_peak_gib=init_peak, n_params=n_params)


# ---------------------------------------------------------------------------
# phase 9: finite shots, the training CLI and the paper's LLMs
# ---------------------------------------------------------------------------
# Experiment I's flags (examples/federated_genomic.py) at 3 rounds; the
# CLI's defaults give 5 clients of 50 rows on average
EXP1 = ("--task", "genomic", "--backend", "aersim", "--non-iid-alpha",
        "0.5", "--no-early-stop", "--rounds", "3")
CLI_RUNS = (("qfl batched", ("--method", "qfl", "--engine", "batched")),
            ("llm-qfl batched", ("--method", "llm-qfl", "--engine",
                                 "batched")),
            ("llm-qfl select 0.2 batched", ("--method", "llm-qfl",
                                            "--select-frac", "0.2",
                                            "--engine", "batched")),
            ("qfl sequential", ("--method", "qfl")),
            ("qfl batched fake", ("--method", "qfl", "--engine", "batched",
                                  "--backend", "fake")),
            ("qfl batched real", ("--method", "qfl", "--engine", "batched",
                                  "--backend", "real")))
# held to the card's run of the named label instead of the CPU, for the
# smoke's time (the CPU half of an LLM-QFL CLI run is the smoke's
# costliest comparison, about 100 s of an 8-core H100 host's CPU): the
# two differ only in client selection
CARD_ONLY = {"llm-qfl select 0.2 batched": "llm-qfl batched"}
# DeepSeek-LLM-7B's Step 1: two clients of 16 rows, the sequential stage
# against the batched engine (five clients at once would pass 80 GB)
DEEPSEEK_TASK = dict(n_clients=2, train_size=32, test_size=16, val_size=16,
                     seed=0)


def value_bits(t):
    """A float tensor's bits on the CPU, every NaN as one pattern."""
    import torch
    t = t.cpu()
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return torch.where(torch.isnan(t), -1, bits.to(torch.int32))


def sample_keys(seed: int, lead: tuple):
    """One key a (B, C) block of a ``lead``-shaped stack."""
    import numpy as np
    from repro_torch import random as jr
    n = int(np.prod(lead)) if lead else 1
    keys = jr.fold_in(jr.PRNGKey(seed), np.arange(n))
    return keys.reshape(*lead, 2)


def sample_phase() -> dict:
    """(a) ``sample_counts`` on the card against the CPU, bitwise, on the
    same probabilities and keys; then its time on the quickstart's
    batched stack (one Nelder–Mead iteration: 5 clients × 19 candidates ×
    50 rows, 100 shots)."""
    import numpy as np
    import torch
    from repro_torch.quantum import backends
    rng = np.random.default_rng(9)

    def probs(lead, C):
        return rng.dirichlet(np.ones(C), lead).astype(np.float32)

    nasty = probs(50, 3)
    nasty[1], nasty[2], nasty[3] = np.nan, 0.0, -0.5
    cases = (("quickstart B=50 C=2", probs(50, 2), 100, torch.float32),
             ("batched stack (5, 19, 50, 2)", probs((5, 19, 50), 2), 100,
              torch.float32),
             ("NaN, zero-mass and negative rows", nasty, 100, torch.float32),
             ("1000 shots", probs(250, 2), 1000, torch.float32),
             ("bfloat16", probs(50, 2), 100, torch.bfloat16))
    for i, (name, p, shots, dt) in enumerate(cases):
        keys = sample_keys(i, p.shape[:-2])
        t = torch.from_numpy(p).to(dt)
        got = backends.sample_counts(keys, t.cuda(), shots)
        want = backends.sample_counts(keys, t, shots)
        check(got.dtype == t.dtype and torch.equal(value_bits(got),
                                                   value_bits(want)),
              f"sample_counts {name}: the card's counts differ from the "
              "CPU's")
    p = torch.from_numpy(probs((5, 19, 50), 2)).cuda()
    keys = sample_keys(0, (5, 19))
    ms = cuda_ms(lambda: backends.sample_counts(keys, p, 100), iters=50)
    plain_cpu = p.cpu()
    t0 = time.perf_counter()
    backends.sample_counts(keys, plain_cpu, 100)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    draws = 5 * 19 * 50 * 100
    # each of (5, 19, 50, 2) probabilities read once and counts written once
    b_ms = 2 * p.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"phase 9a: sample_counts card == cpu bitwise on {len(cases)} "
          f"cases ({', '.join(c[0] for c in cases)}); the quickstart's "
          f"batched stack ({draws} draws) {ms * 1e3:.1f} us a call on the "
          f"card (loop), {cpu_ms:.1f} ms on the CPU; bytes bound "
          f"{b_ms * 1e3:.3f} us (the threefry hash of each draw is int32 "
          "integer work in plain PyTorch, many launches)")
    return dict(ms=ms, cpu_ms=cpu_ms, draws=draws, bytes_bound_ms=b_ms)


def cli_run(label: str, argv, device: str):
    """``repro_torch.launch.train.main(argv)`` on ``device`` with every
    launch counter set to 0 just before it and read just after, and the
    draws near a CDF boundary recorded; returns (result, counts, wall
    seconds, tracker)."""
    import contextlib
    import io
    import tempfile
    import torch
    from repro_torch.launch import train
    from repro_torch.quantum import backends
    zero_counters()
    with tempfile.TemporaryDirectory() as out, \
            backends.track_margin(record=True) as m:
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            res = train.main(list(argv) + ["--device", device, "--out", out])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = json.loads((Path(out) / "history.json").read_text())
    n = read_counters()
    check(sorted(hist) == ["config", "llm_f1", "llm_losses", "rounds",
                           "terminated_early", "theta_g"]
          and len(hist["rounds"]) == len(res.rounds)
          and sum(ln.startswith("round") for ln in
                  log.getvalue().splitlines()) == len(res.rounds),
          f"{label}: history.json or the printed rounds are malformed")
    check(m.draws > 0 and m.near <= m.chance_bound(),
          f"{label} ({device}): {m.near} of {m.draws} draws within "
          f"{m.NEAR} of a CDF boundary, more than chance allows "
          f"({m.chance_bound():.1f})")
    print(f"  {label} ({device}): {len(res.rounds)} rounds in {wall:.2f} s "
          f"(fine-tune {res.llm_finetune_time_s:.2f} s); maxiters "
          f"{res.series('maxiters')}; selected {res.series('selected')}; "
          f"server loss {[round(x, 6) for x in res.series('server_loss')]};"
          f" smallest draw-to-boundary distance {m.value:.3g} over "
          f"{m.draws} draws, {m.near} within {m.NEAR} (chance allows "
          f"{m.chance_bound():.1f}); launches "
          f"{json.dumps({k: v for k, v in n.items() if v})}")
    return res, n, wall, m


def cli_phase() -> dict:
    """(b) ``repro_torch.launch.train`` with Experiment I's flags on the
    card, each run then held to the same command on the CPU: QFL and
    LLM-QFL, batched; QFL sequential; QFL batched on ``fake`` and
    ``real``.  Every draw within NEAR of a CDF boundary in either run
    falls in the same class in both, unless the two runs' boundaries
    straddle it no more than NEAR apart.  LLM-QFL selecting 20 % runs on
    the card alone (``CARD_ONLY``)."""
    import numpy as np
    print("phase 9b: the training CLI, Experiment I's flags (aersim, 100 "
          f"shots, Dirichlet 0.5 shards, 5 clients, {EXP1[-1]} rounds):")
    out, cards = {}, {}
    for label, extra in CLI_RUNS:
        gpu, n, wall, margin = cli_run(label, EXP1 + extra, "cuda")
        if "sequential" in label:
            check_no_tape(n, label)
        else:
            check_tape_launches(n, label)
        if label.startswith("llm-qfl"):
            want = llm_launch_formula(30, 2)
            for name, count in want.items():
                check(n[name] == count, f"{label}: {n[name]} {name} "
                      f"launches, the formula gives {count}")
        if label in CARD_ONLY:
            out[label] = same_start(label, gpu, CARD_ONLY[label], cards,
                                    wall, n, margin)
            continue
        cards[label] = gpu
        cpu, _, cpu_wall, cpu_margin = cli_run(label, EXP1 + extra, "cpu")
        loss_gap, theta_gap = compare_runs(gpu, cpu, what=f"cli {label}")
        if label.startswith("llm-qfl"):
            d_loss = float(np.max(np.abs(np.subtract(gpu.llm_losses,
                                                     cpu.llm_losses))))
            check(d_loss <= LLM_LOSS_TOL, f"{label}: Step 1 |Δ L_LLM| "
                  f"{d_loss} > {LLM_LOSS_TOL}")
        near = margin.near_disagreements(cpu_margin)
        check(near.unexplained == 0, f"{label}: {near.unexplained} of the "
              f"{near.checked} draws within {margin.NEAR} of a CDF "
              "boundary are missing from one run, see boundaries more than "
              "that apart, or change class where the boundaries do not "
              f"straddle them ({near})")
        print(f"  {label}: card == cpu on maxiters/selected/cum_evals; of "
              f"the {near.checked} draws within {margin.NEAR} of a "
              f"boundary, {near.flipped} change class, each straddled by "
              f"the two runs' boundaries (largest boundary shift "
              f"{near.shift:.3g}); max |Δ server loss| {loss_gap:.3g}, max "
              f"|Δ θ_g| {theta_gap:.3g}")
        out[label] = dict(wall_s=wall, cpu_wall_s=cpu_wall, counts=n,
                          margin=dict(value=margin.value, near=margin.near,
                                      draws=margin.draws),
                          near=near._asdict(),
                          finetune_s=gpu.llm_finetune_time_s,
                          loss_gap=loss_gap, theta_gap=theta_gap)
    return out


def same_start(label: str, gpu, ref_label: str, cards: dict, wall: float,
               n: dict, margin) -> dict:
    """A card-only CLI run held to the card's run of ``ref_label``, which
    differs from it only in client selection: the same Step 1 (L_LLM and
    F1 bit for bit) and first round (budgets and client losses), and one
    client selected a round."""
    import numpy as np
    ref = cards[ref_label]
    first, ref_first = gpu.rounds[0], ref.rounds[0]
    check(np.array_equal(gpu.llm_losses, ref.llm_losses)
          and np.array_equal(gpu.llm_f1, ref.llm_f1)
          and first.maxiters == ref_first.maxiters
          and np.array_equal(first.client_losses, ref_first.client_losses)
          and all(len(s) == 1 for s in gpu.series("selected")),
          f"{label}: Step 1 or round 1 differs from {ref_label}'s on the "
          f"card, or a round selects other than one client")
    print(f"  {label}: card only; Step 1 and round 1 equal {ref_label}'s "
          "on the card, one client selected a round")
    return dict(wall_s=wall, cpu_wall_s=None, counts=n,
                margin=dict(value=margin.value, near=margin.near,
                            draws=margin.draws),
                near=None, finetune_s=gpu.llm_finetune_time_s,
                loss_gap=None, theta_gap=None)


def gpt2_phase() -> dict:
    """(c) GPT-2's Step 1 at full width: ``BatchedLLMEngine`` on the
    quickstart task's 5 clients, 2 steps on the card, its launches held
    to ``llm_launch_formula``; one step on the card held to one step on
    the CPU on the same base (the batched-LLM tolerances)."""
    import numpy as np
    import torch
    from repro_torch import random as jr
    from repro_torch.core.batched_llm import BatchedLLMEngine
    from repro_torch.core.llm_client import task_llm_config
    from repro_torch.data.tasks import build_task
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    what = "gpt2"
    task = build_task("genomic", **QUICKSTART["task"])
    cfg = task_llm_config("gpt2", task.vocab_size, task.llm_seq_len)
    steps, bs = LLM_WIDE["steps"], LLM_WIDE["batch_size"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = base_bytes(base)[1] // 4
    eng = BatchedLLMEngine(task, cfg, base, seed=0, steps=steps,
                           batch_size=bs)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n = read_counters()
    check_llm_launches(n, llm_launch_formula(steps, cfg.n_layers), False,
                       what)
    step_s = time_train_steps(cfg, base, eng, task, bs, what)
    peak = torch.cuda.max_memory_allocated() / 2**30
    one = BatchedLLMEngine(task, cfg, base, seed=0, steps=1,
                           batch_size=bs).run()
    cpu_base = tree_map(lambda t: t.cpu(), base)
    t0 = time.perf_counter()
    cpu = BatchedLLMEngine(task, cfg, cpu_base, seed=0, steps=1,
                           batch_size=bs).run()
    cpu_s = time.perf_counter() - t0
    gap = (float(np.max(np.abs(one.losses - cpu.losses))),
           float(np.max(np.abs(one.f1 - cpu.f1))),
           float(np.max(np.abs(one.teacher - cpu.teacher))))
    check(gap[0] <= LLM_LOSS_TOL and gap[1] <= LLM_F1_TOL
          and gap[2] <= TEACHER_TOL,
          f"{what} Step 1, card vs cpu after 1 step: {gap} (tolerances "
          f"{LLM_LOSS_TOL}, {LLM_F1_TOL}, {TEACHER_TOL})")
    check(np.all(np.isfinite(out.losses)), f"{what}: L_LLM {out.losses}")
    print(f"phase 9c: gpt2 (full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"{n_params / 1e9:.3f} B base values) Step 1, C={task.n_clients}, "
          f"{bs} x 64 tokens: base draw {init_s:.2f} s; run() of {steps} "
          f"steps + distill + evaluation {run_s:.2f} s; train steps "
          f"{', '.join(f'{t:.3f}' for t in step_s)} s; peak memory "
          f"{peak:.2f} GiB; card vs cpu after 1 step |Δ L_LLM| "
          f"{gap[0]:.3g}, |Δ F1| {gap[1]:.3g}, |Δ teacher| {gap[2]:.3g} "
          f"(cpu {cpu_s:.1f} s); launches {json.dumps(n)}")
    return dict(counts=n, init_s=init_s, run_s=run_s, step_s=step_s,
                peak_gib=peak, gap=gap, n_params=n_params)


# ---------------------------------------------------------------------------
# phase 10: the fused round loop (rounds="fused")
# ---------------------------------------------------------------------------
# the card's fused runs against its host loop: integers exactly, losses
# within 1e-5, θ_g within 2e-6 (tests/test_fused_rounds.py's bounds)
FUSED_LOSS_TOL, FUSED_THETA_TOL = 1e-5, 2e-6
# the quickstart's equal 5 × 50 shards at 3 rounds, on aersim
FUSED_AERSIM = dict(task=QUICKSTART["task"], run=dict(n_rounds=3))
# population mode: cohorts of 3 of the quickstart's 5 clients, dropout
FUSED_POP = dict(c_round=3, dropout=0.25, n_rounds=5, seed=0)


@contextlib.contextmanager
def strict_fused():
    """Every fused run's launches, from its first to the copy of its
    results, under ``torch.cuda.set_sync_debug_mode("error")``: a host
    synchronisation there raises.  The one read-back (``finish``) is
    outside."""
    import torch
    from repro_torch.core import fused_rounds
    plain = fused_rounds.FusedRoundDriver.start

    def start(self, theta_g, graph=True):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return plain(self, theta_g, graph)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    fused_rounds.FusedRoundDriver.start = start
    try:
        yield
    finally:
        fused_rounds.FusedRoundDriver.start = plain


def fused_launches(n: dict, driver, label: str) -> dict:
    """Device launches of a fused run that captured its program: one
    eager round before the capture, then ``replays`` replays of the
    graph, whose kernel nodes the capture counted.  (The wrappers count
    Python calls, so the capture's own count is no launch.)"""
    prog = driver.program
    gc = prog.graph_counts
    check(gc["statevector_tape"] == gc["replays"] > 0
          and gc["statevector_gate"] == 0,
          f"fused {label}: the graph holds {gc['statevector_tape']} "
          f"statevector_tape nodes for {gc['replays']} tape replays")
    eager = {k: n[k] - gc[k] for k in ("statevector_tape", "replays")}
    return dict(statevector_tape=eager["statevector_tape"]
                + prog.replays * gc["statevector_tape"],
                replays=eager["replays"] + prog.replays * gc["replays"],
                graph_nodes=gc["statevector_tape"], graph_replays=prog.replays)


def same_output(a, b, what: str):
    """Two FusedRunOutputs bit for bit (NaN where NaN)."""
    import dataclasses
    import numpy as np
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        check(x.dtype == y.dtype and np.array_equal(
            x, y, equal_nan=x.dtype.kind == "f"),
            f"{what}: {f.name} differs between two replays of one graph")


def fused_drive(label: str, cfg, host, **kw) -> dict:
    """A fused run through ``run_experiment``'s path on the card, its
    program captured anew, held to the card's host-loop run ``host``;
    then the run replayed again, bitwise the same."""
    import numpy as np
    from repro_torch.core import fused_rounds
    fused_rounds._FUSED_CACHE.clear()
    zero_counters()
    t0 = time.perf_counter()
    with strict_fused():
        _, res, orch = run_main_path("cuda", cfg, rounds="fused", **kw)
    wall = time.perf_counter() - t0
    driver = orch.fused_driver
    n = fused_launches(read_counters(), driver, label)
    check(res.terminated_early == host.terminated_early,
          f"fused {label}: terminated_early differs from the host loop")
    loss_gap, theta_gap = compare_runs(
        res, host, loss_tol=FUSED_LOSS_TOL, theta_tol=FUSED_THETA_TOL,
        what=f"fused {label} against the card's host loop")
    with strict_fused():
        again = driver.run(driver.theta0)
    same_output(orch.fused_output, again, f"fused {label}")
    print(f"phase 10 fused {label}: {len(res.rounds)} rounds, "
          f"{wall:.3f} s with the capture, the run {orch.fused_seconds:.4f} "
          f"s; statevector_tape {n['statevector_tape']} launches "
          f"({n['graph_nodes']} a graph × {n['graph_replays']} replays + "
          f"one eager round); against the host loop: equal maxiters/"
          f"selected/cum_evals, max |Δ loss| {loss_gap:.3g}, |Δ θ_g| "
          f"{theta_gap:.3g}; no sync; a second replay bitwise equal")
    return dict(res=res, orch=orch, wall_s=wall, run_s=orch.fused_seconds,
                loss_gap=loss_gap, theta_gap=theta_gap, **n)


def fused_phase(qfl: dict, llm: dict) -> dict:
    """The fused round loop on the card: the QFL quickstart (held to
    phase 3's card and CPU runs), the LLM-QFL quickstart's rounds on
    phase 4's card Step 1, QFL on aersim (NM and SPSA), a large-ε early
    termination, and population mode held to ``run_host_reference``."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch.core import fused_rounds
    from repro_torch.data.tasks import build_task
    from repro_torch.quantum import backends, qnn
    t_phase = time.perf_counter()
    out = {}
    out["qfl"] = fused_drive("qfl quickstart", QUICKSTART, qfl["gpu"])
    gap = compare_runs(out["qfl"]["res"], qfl["cpu"],
                       what="fused qfl quickstart against phase 3's cpu run")
    print(f"  fused qfl quickstart against phase 3's cpu host run: max "
          f"|Δ server loss| {gap[0]:.3g}, |Δ θ_g| {gap[1]:.3g}")
    out["llm-qfl"] = fused_drive("llm-qfl quickstart rounds",
                                 LLM_QUICKSTART, llm["gpu"],
                                 method="llm-qfl",
                                 llm_outputs=llm["llm_outputs"])
    check(out["llm-qfl"]["res"].rounds[-1].maxiters
          != [QUICKSTART["run"].get("maxiter0", 10)] * 5,
          "fused llm-qfl: regulation left every budget at maxiter0")
    for opt in ("nelder-mead", "spsa"):
        t0 = time.perf_counter()
        _, host, _ = run_main_path("cuda", FUSED_AERSIM, backend="aersim",
                                   optimizer=opt)
        host_s = time.perf_counter() - t0
        out[f"aersim {opt}"] = d = fused_drive(
            f"qfl aersim {opt}", FUSED_AERSIM, host, backend="aersim",
            optimizer=opt)
        d.update(host_s=host_s, host=host)
    early = dict(task=QUICKSTART["task"], run=dict(epsilon=10.0))
    _, host, _ = run_main_path("cuda", early)
    check(host.terminated_early and len(host.rounds) == 2,
          f"host loop with ε = 10: {len(host.rounds)} rounds")
    out["early"] = fused_drive("qfl early termination (ε = 10)", early,
                               host)

    # population mode on aersim against the host reference on the card
    task = build_task("genomic", **QUICKSTART["task"])
    spec = qnn.QNNSpec("vqc", n_qubits=4, n_classes=task.n_classes)
    fused_rounds._FUSED_CACHE.clear()
    driver = fused_rounds.FusedRoundDriver(
        task, spec, backends.get("aersim"), maxiter0=10, early_stop=False,
        **FUSED_POP)
    theta0 = spec.init_params(jr.split(jr.PRNGKey(0))[1]).numpy()
    with strict_fused():
        t0 = time.perf_counter()
        got = driver.run(theta0)
        run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = driver.run_host_reference(theta0)
    ref_s = time.perf_counter() - t0
    for f in ("active", "stop", "cohort", "dropped", "selected", "n_evals",
              "budgets", "cum_evals", "budgets_final", "cum_evals_final"):
        check(np.array_equal(getattr(got, f), getattr(ref, f)),
              f"fused population: {f} differs from run_host_reference")
    check(np.array_equal(np.isnan(got.losses), np.isnan(ref.losses))
          and got.dropped.any(), "fused population: the reports or the "
          "dropout differ")
    loss_gap = float(np.nanmax(np.abs(got.losses - ref.losses)))
    theta_gap = float(np.max(np.abs(got.theta_g - ref.theta_g)))
    server_gap = float(np.max(np.abs(got.server_loss - ref.server_loss)))
    check(loss_gap <= FUSED_LOSS_TOL and server_gap <= FUSED_LOSS_TOL
          and theta_gap <= FUSED_THETA_TOL,
          f"fused population against run_host_reference: |Δ loss| "
          f"{loss_gap}, |Δ server loss| {server_gap}, |Δ θ_g| {theta_gap}")
    with strict_fused():
        same_output(got, driver.run(theta0), "fused population")
    print(f"phase 10 fused population (c_round {FUSED_POP['c_round']} of 5, "
          f"dropout {FUSED_POP['dropout']}, aersim, {FUSED_POP['n_rounds']} "
          f"rounds, {int(got.dropped.sum())} dropped): run {run_s:.4f} s, "
          f"host reference {ref_s:.3f} s; cohorts, coins and integers equal;"
          f" max |Δ loss| {loss_gap:.3g}, |Δ server loss| {server_gap:.3g}, "
          f"|Δ θ_g| {theta_gap:.3g}; no sync; a second replay bitwise equal")
    out["population"] = dict(run_s=run_s, host_s=ref_s, loss_gap=loss_gap,
                             theta_gap=theta_gap)
    wall = time.perf_counter() - t_phase
    fused_rounds._FUSED_CACHE.clear()        # the graphs' memory back
    print(f"phase 10 (fused round loop) in {wall:.1f} s")
    out["wall_s"] = wall
    return out


# ---------------------------------------------------------------------------
# phase 11: the clients axis (n_devices > 1)
# ---------------------------------------------------------------------------
SHARDS = 2
# the quickstart's 5 clients over 2 shards: c_pad 6, one inert client
SHARD_PAD = 6
SHARD_POP = dict(c_round=4, dropout=0.25, n_rounds=5, seed=0)


def same_runs(a, b, what: str, reports: bool = True):
    """Two RunResults bit for bit: every series, θ_g, Step 1.  With
    ``reports=False`` the clients' reported losses are held within
    ``FUSED_LOSS_TOL`` instead: a fused round reports every client in
    one masked evaluation over the padded rows, the host loop one
    evaluation a client (phase 10 holds them so)."""
    import numpy as np
    check(len(a.rounds) == len(b.rounds)
          and a.terminated_early == b.terminated_early,
          f"{what}: {len(a.rounds)} against {len(b.rounds)} rounds")
    if not reports:
        gap = float(np.max(np.abs(np.subtract(a.series("client_losses"),
                                              b.series("client_losses")))))
        check(gap <= FUSED_LOSS_TOL, f"{what}: client losses {gap} apart")
    for attr in ("maxiters", "cum_evals", "selected", "server_loss",
                 "client_losses", "server_val_acc", "server_test_acc",
                 "comm_time_s", "ratios"):
        if attr == "client_losses" and not reports:
            continue
        check(a.series(attr) == b.series(attr),
              f"{what}: {attr} differs: {a.series(attr)} against "
              f"{b.series(attr)}")
    check(np.array_equal(a.theta_g, b.theta_g)
          and a.llm_losses == b.llm_losses and a.llm_f1 == b.llm_f1,
          f"{what}: θ_g or Step 1 differs, max |Δ θ_g| "
          f"{float(np.max(np.abs(a.theta_g - b.theta_g)))}")


def host_replays(res, shards: int, clients: int) -> int:
    """Tape replays of a Nelder–Mead QFL host-loop run whose budgets all
    stay at ``maxiter0``: a round is each shard's init simplex and one
    call an iteration, one report a client and 4 server evaluations."""
    per_shard = 1 + res.rounds[0].maxiters[0]
    return len(res.rounds) * (shards * per_shard + clients + 4)


def sharded_refs():
    """Phase 11's one-shard references from card runs alone, for
    ``--sharded``: phase 3's QFL quickstart and its launches, phase 4's
    Step 1, phase 10's fused QFL quickstart and its aersim host run."""
    from repro_torch.core import fused_rounds
    zero_counters()
    _, gpu, orch = run_main_path("cuda", QUICKSTART)
    qfl = dict(gpu=gpu, counts=read_counters(), round_s=orch.round_seconds)
    step1 = dict(LLM_QUICKSTART, run=dict(LLM_QUICKSTART["run"], n_rounds=1))
    _, lgpu, lorch = run_main_path("cuda", step1, method="llm-qfl")
    llm = dict(gpu=lgpu, llm_outputs=lorch.llm_outputs)
    fused_rounds._FUSED_CACHE.clear()
    _, _, forch = run_main_path("cuda", QUICKSTART, rounds="fused")
    _, host, _ = run_main_path("cuda", FUSED_AERSIM, backend="aersim")
    return qfl, llm, {"qfl": dict(orch=forch),
                      "aersim nelder-mead": dict(host=host)}


def sharded_phase(qfl: dict, llm: dict, fused: dict) -> dict:
    """The clients axis on the card: each run over 2 shards held bit for
    bit to its one-shard run, its launches to the one-shard formulas
    with each shard's local phase counted, the fused run with no host
    synchronisation before its read-back.  The shards share the card
    (``share_devices=True``); where two or more cards are visible the
    runs go across the cards too."""
    import numpy as np
    import torch
    from repro_torch.core import fused_rounds
    from repro_torch.core.batched_llm import BatchedLLMEngine
    from repro_torch.core.llm_client import task_llm_config
    from repro_torch.data.tasks import build_task
    from repro_torch.quantum import backends, qnn
    from repro_torch import random as jr
    t_phase = time.perf_counter()
    visible = torch.cuda.device_count()
    C = QUICKSTART["task"]["n_clients"]
    if visible < 2:
        try:
            run_main_path("cuda", QUICKSTART, n_devices=SHARDS)
        except ValueError as e:
            check(f"{visible} is visible" in str(e), f"phase 11: {e}")
        else:
            raise AssertionError("n_devices=2 on one card ran without "
                                 "share_devices=True")
        modes = {"one card": True}
        print(f"phase 11: {visible} card visible, so the runs across cards "
              f"are skipped; n_devices={SHARDS} without share_devices "
              f"raises ValueError, and the shards share the card")
    else:
        modes = {"one card": True, f"{SHARDS} cards": False}
    out = {}
    for mode, share in modes.items():
        kw = dict(n_devices=SHARDS, share_devices=share)
        got = out[mode] = {}

        # the QFL quickstart's host loop, 10 rounds, against phase 3's
        zero_counters()
        t0 = time.perf_counter()
        _, res, orch = run_main_path("cuda", QUICKSTART, **kw)
        wall = time.perf_counter() - t0
        n = read_counters()
        rounds = (float(np.median(orch.round_seconds)),
                  float(np.median(qfl["round_s"])))
        check_tape_launches(n, f"sharded qfl ({mode})")
        want = host_replays(res, SHARDS, C)
        check(n["replays"] == want and host_replays(qfl["gpu"], 1, C)
              == qfl["counts"]["replays"],
              f"sharded qfl ({mode}): {n['replays']} tape replays, the "
              f"formula gives {want}")
        same_runs(res, qfl["gpu"], f"sharded qfl quickstart ({mode}) "
                  "against phase 3")
        got["qfl"] = dict(wall_s=wall, res=res, round_s=rounds, **n)

        # QFL on aersim, Nelder–Mead, 3 rounds, against phase 10's host run
        zero_counters()
        _, res_a, _ = run_main_path("cuda", FUSED_AERSIM, backend="aersim",
                                    **kw)
        n = read_counters()
        check_tape_launches(n, f"sharded aersim ({mode})")
        check(n["replays"] == host_replays(res_a, SHARDS, C),
              f"sharded aersim ({mode}): {n['replays']} tape replays")
        same_runs(res_a, fused["aersim nelder-mead"]["host"],
                  f"sharded qfl aersim ({mode}) against one shard")
        got["aersim"] = n

        # the fused QFL quickstart, against the sharded host loop and
        # phase 10's one-shard fused run
        fused_rounds._FUSED_CACHE.clear()
        zero_counters()
        with strict_fused():
            _, res_f, orch = run_main_path("cuda", QUICKSTART,
                                           rounds="fused", **kw)
        driver = orch.fused_driver
        n = fused_launches(read_counters(), driver, f"sharded ({mode})")
        graphs = len(driver.program.graphs)
        want = SHARDS * (2 + driver.max_iter) + 4
        check(n["graph_nodes"] == want,
              f"sharded fused ({mode}): {n['graph_nodes']} tape replays a "
              f"round's graphs, the formula gives {want}")
        same_runs(res_f, res, f"sharded fused ({mode}) against the sharded "
                  "host loop", reports=False)
        same_output(orch.fused_output, fused["qfl"]["orch"].fused_output,
                    f"sharded fused ({mode}) against phase 10")
        with strict_fused():
            same_output(orch.fused_output, driver.run(driver.theta0),
                        f"sharded fused ({mode})")
        got["fused"] = dict(run_s=orch.fused_seconds, graphs=graphs, **n)

        # population mode on aersim against run_host_reference
        task = build_task("genomic", **QUICKSTART["task"])
        spec = qnn.QNNSpec("vqc", n_qubits=4, n_classes=task.n_classes)
        fused_rounds._FUSED_CACHE.clear()
        zero_counters()
        driver = fused_rounds.FusedRoundDriver(
            task, spec, backends.get("aersim"), maxiter0=10,
            early_stop=False, device="cuda", **kw, **SHARD_POP)
        theta0 = spec.init_params(jr.split(jr.PRNGKey(0))[1]).numpy()
        with strict_fused():
            pop = driver.run(theta0)
        n = fused_launches(read_counters(), driver,
                           f"sharded population ({mode})")
        ref = driver.run_host_reference(theta0)
        for f in ("active", "stop", "cohort", "dropped", "selected",
                  "n_evals", "budgets", "cum_evals", "budgets_final",
                  "cum_evals_final"):
            check(np.array_equal(getattr(pop, f), getattr(ref, f)),
                  f"sharded population ({mode}): {f} differs from "
                  "run_host_reference")
        check(pop.dropped.any() and np.array_equal(np.isnan(pop.losses),
                                                   np.isnan(ref.losses)),
              f"sharded population ({mode}): the dropout or the reports")
        pop_gap = (float(np.nanmax(np.abs(pop.losses - ref.losses))),
                   float(np.max(np.abs(pop.theta_g - ref.theta_g))))
        check(pop_gap[0] <= FUSED_LOSS_TOL and pop_gap[1] <= FUSED_THETA_TOL,
              f"sharded population ({mode}) against run_host_reference: "
              f"|Δ loss| {pop_gap[0]}, |Δ θ_g| {pop_gap[1]}")
        got["population"] = dict(gap=pop_gap, **n)

        # the LLM-QFL quickstart's Step 1: 2 shards against one device
        # padded to 6, and against phase 4's unpadded Step 1
        step1 = dict(LLM_QUICKSTART, run=dict(LLM_QUICKSTART["run"],
                                              n_rounds=1))
        zero_counters()
        task, res_l, orch = run_main_path("cuda", step1, method="llm-qfl",
                                          **kw)
        n = read_counters()
        want = llm_launch_formula(LLM_QUICKSTART["run"]["llm_steps"], 2,
                                  clients=SHARDS)
        for name, count in want.items():
            check(n[name] == count, f"sharded Step 1 ({mode}): {n[name]} "
                  f"{name} launches, the formula gives {count}")
        # against one device padded to 6, on the same base: the same
        # clients, but lora_matmul plans its split reduction from the
        # whole launch's grid (C x tiles), so a shard of 3 clients splits
        # tiny w_in's dx 4 ways where 6 clients split it 2 ways (ROADMAP
        # §3): held within the stage tolerance, the gap printed
        cfg = task_llm_config("tiny-llm", task.vocab_size, task.llm_seq_len)
        pad = BatchedLLMEngine(task, cfg, orch.llm_engine.base, seed=0,
                               steps=LLM_QUICKSTART["run"]["llm_steps"],
                               pad_to=SHARD_PAD).run()
        teachers = orch.llm_outputs.teacher_probs
        pad_gap = stage_gaps(res_l.llm_losses, res_l.llm_f1, teachers, pad,
                             task)
        gap = (float(np.max(np.abs(np.subtract(res_l.llm_losses,
                                               llm["gpu"].llm_losses)))),
               float(np.max(np.abs(np.subtract(res_l.llm_f1,
                                               llm["gpu"].llm_f1)))),
               max(float(np.max(np.abs(a - b))) for a, b in zip(
                   teachers, llm["llm_outputs"].teacher_probs)))
        for what, g in ((f"one device padded to {SHARD_PAD}", pad_gap),
                        ("phase 4", gap)):
            check(g[0] <= 1e-4 and g[1] <= 0.05 and g[2] <= 1e-4,
                  f"sharded Step 1 ({mode}) against {what}: |Δ L_LLM| "
                  f"{g[0]}, |Δ F1| {g[1]}, |Δ teacher| {g[2]}")
        got["llm"] = dict(gap=gap, pad_gap=pad_gap,
                          finetune_s=res_l.llm_finetune_time_s,
                          **{k: n[k] for k in want})
        print(f"phase 11 ({mode}, {SHARDS} shards): qfl quickstart host "
              f"{got['qfl']['wall_s']:.2f} s, a round {rounds[0]:.4f} s "
              f"(median; one shard {rounds[1]:.4f} s), "
              f"{got['qfl']['replays']} replays; aersim "
              f"{got['aersim']['replays']} replays; fused run "
              f"{got['fused']['run_s']:.4f} s, {got['fused']['graphs']} "
              f"graph(s), {got['fused']['graph_nodes']} replays a round; "
              f"population |Δ loss| {pop_gap[0]:.3g}; every QFL run "
              f"bitwise its one-shard run, no sync before a fused "
              f"read-back; Step 1 {res_l.llm_finetune_time_s:.2f} s, "
              f"|Δ L_LLM|, |Δ F1|, |Δ teacher| against one device padded "
              f"to {SHARD_PAD} {pad_gap[0]:.3g}, {pad_gap[1]:.3g}, "
              f"{pad_gap[2]:.3g}, against phase 4 {gap[0]:.3g}, "
              f"{gap[1]:.3g}, {gap[2]:.3g}")
    fused_rounds._FUSED_CACHE.clear()
    wall = time.perf_counter() - t_phase
    print(f"phase 11 (the clients axis) in {wall:.1f} s")
    return dict(modes=out, wall_s=wall)


# profiler ranges the smoke opens itself: on the device they span a
# range's kernels and the gaps between them, so they are no kernels
RANGES = ("sample_counts",)


def print_profile(prof, label: str, wall: float, detail: str):
    import torch
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in RANGES]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, "the profiler saw no device time")
    print(f"profile ({label}): {wall:.3f} s under the profiler ({detail}); "
          f"device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:7d}x  {e.key[:90]}")


def profile_aersim(acts):
    """A warm 3-round batched QFL run on ``aersim`` (the quickstart task,
    100 shots) under the profiler; ``sample_counts`` is wrapped in a
    profiler range so its device time shows beside the idle share."""
    import torch
    from torch.profiler import profile, record_function
    from repro_torch.quantum import backends
    cfg = dict(QUICKSTART, run=dict(n_rounds=3, early_stop=False))
    plain = backends.sample_counts

    def ranged(*args):
        with record_function("sample_counts"):
            return plain(*args)

    backends.sample_counts = ranged
    try:
        run_main_path("cuda", dict(cfg, run=dict(n_rounds=1)),
                      backend="aersim")
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, res, orch = run_main_path("cuda", cfg, backend="aersim")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        backends.sample_counts = plain
    print_profile(prof, "qfl aersim batched", wall, "3 rounds, rounds "
                  f"{', '.join(f'{s:.3f}' for s in orch.round_seconds)} s")
    # the host-side range: its device time is its kernels' own
    rows = [e for e in prof.key_averages() if e.key == "sample_counts"
            and e.device_type == torch.autograd.DeviceType.CPU]
    dev = sum(e.device_time_total for e in rows) / 1e3
    note = ("not measured: the profiler gave the range no device time"
            if dev == 0 else "the device time of the kernels it launched")
    print(f"  sample_counts: {sum(e.count for e in rows)} calls, device time "
          f"{dev:.3f} ms ({note})")


def profile_fused(acts):
    """Warm runs of the host loop and the fused loop side by side (each
    loop run once first: kernels built, the fused graph captured and
    cached): the QFL quickstart at 3 rounds, the same on aersim, and the
    LLM-QFL quickstart's rounds (3) on one card Step 1."""
    import torch
    from torch.profiler import profile
    qfl3 = dict(QUICKSTART, run=dict(n_rounds=3, early_stop=False))
    llm3 = dict(LLM_QUICKSTART, run=dict(LLM_QUICKSTART["run"], n_rounds=3,
                                         early_stop=False))
    _, _, orch = run_main_path("cuda", dict(llm3, run=dict(llm3["run"],
                                                           n_rounds=1)),
                               method="llm-qfl")
    step1 = orch.llm_outputs
    for label, cfg, kw in (
            ("qfl", qfl3, {}), ("qfl aersim", qfl3, dict(backend="aersim")),
            ("llm-qfl rounds", llm3, dict(method="llm-qfl",
                                          llm_outputs=step1))):
        for rounds in ("host", "fused"):
            run_main_path("cuda", cfg, rounds=rounds, **kw)
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                _, res, orch = run_main_path("cuda", cfg, rounds=rounds,
                                             **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            detail = (f"the run {orch.fused_seconds:.4f} s"
                      if rounds == "fused" else "rounds " + ", ".join(
                          f"{s:.3f}" for s in orch.round_seconds) + " s")
            print_profile(prof, f"{label} {rounds} loop", wall,
                          f"3 rounds; {detail}")


def profile_phase():
    """Device busy time and idle share of warm QFL and LLM-QFL runs, and
    of the QLoRA LLM stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for method, cfg, warm in (
            ("qfl", dict(QUICKSTART, run=dict(n_rounds=3, early_stop=False)),
             dict(QUICKSTART, run=dict(n_rounds=1))),
            ("llm-qfl", dict(LLM_QUICKSTART, run=dict(
                LLM_QUICKSTART["run"], n_rounds=3, early_stop=False)),
             dict(LLM_QUICKSTART, run=dict(n_rounds=1, llm_steps=2)))):
        run_main_path("cuda", warm, method=method)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, res, orch = run_main_path("cuda", cfg, method=method)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print_profile(prof, method, wall, f"fine-tune "
                      f"{res.llm_finetune_time_s:.3f} s; rounds "
                      f"{', '.join(f'{s:.3f}' for s in orch.round_seconds)}"
                      " s")
    steps = LLM_QUICKSTART["run"]["llm_steps"]
    qlora_stage("cuda", 2)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        qlora_stage("cuda", steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_profile(prof, "qlora stage", wall, f"tiny-llm, int4 base, 5 "
                  f"clients, {steps} steps + distill + evaluation")
    profile_aersim(acts)
    profile_fused(acts)
    for label, cfg, kw in (
            ("qfl spsa batched", SEQ_QFL, dict(optimizer="spsa")),
            ("llm-qfl nm sequential",
             dict(SEQ_LLM, run=dict(SEQ_LLM["run"], n_rounds=1)),
             dict(method="llm-qfl", engine="sequential"))):
        run_main_path("cuda", dict(cfg, run=dict(cfg["run"], n_rounds=1,
                                                 llm_steps=2)), **kw)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, res, orch = run_main_path("cuda", cfg, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print_profile(prof, label, wall, f"fine-tune "
                      f"{res.llm_finetune_time_s:.3f} s; rounds "
                      f"{', '.join(f'{s:.3f}' for s in orch.round_seconds)}"
                      " s")


def ptxas_entries(log: str) -> list:
    """[{entry, registers, spill_bytes}] from ``nvcc -Xptxas -v`` output."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(entry=m.group(1), registers=None, spill_bytes=0)
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def sass_mma_counts(lib_path) -> dict:
    """{entry: (HGMMA, HMMA) instruction counts} from ``cuobjdump -sass``,
    or {} where the toolkit has no cuobjdump."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = [0, 0]
        elif cur is not None:
            counts[cur][0] += " HGMMA." in line
            counts[cur][1] += " HMMA." in line
    return {k: tuple(v) for k, v in counts.items()}


def demangle(names) -> dict:
    import shutil
    names = list(names)
    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, timeout=60).stdout
    return dict(zip(names, out.splitlines()))


# kernels whose every main entry point runs on the tensor cores: wgmma
# (SASS HGMMA), or mma.sync (HMMA) for flash_attention only
TENSOR_CORE_KERNELS = {"lora_matmul": "hgmma", "int4_matmul": "hgmma",
                       "flash_attention": "hmma"}
# entry points that are elementwise passes beside a tensor-core kernel:
# split-K sums, attention's rowsum(dO O) and dQ slab sum (Sk > 64)
SIDE_PASSES = ("reduce", "delta_kernel", "dq_sum_kernel")


def build_kernels() -> dict:
    """Every kernel source at once; prints the time, and each entry
    point's registers, spills and (for the tensor-core kernels) its
    HGMMA/HMMA count in the SASS.  Returns {name: [entry, ...]}."""
    from repro_torch.kernels import build
    build.build_all(KERNELS)
    report = {}
    for name in KERNELS:
        entries = ptxas_entries(build.build_log(name))
        sass = sass_mma_counts(build.library_path(name))
        pretty = demangle(e["entry"] for e in entries)
        for e in entries:
            e["hgmma"], e["hmma"] = sass.get(e["entry"], (None, None))
        report[name] = entries
        regs = [e["registers"] for e in entries]
        print(f"built {name} in {build.BUILD_SECONDS[name]:.1f} s "
              f"(parallel): {len(entries)} entry points, registers "
              f"{min(regs)}-{max(regs)}, spill up to "
              f"{max(e['spill_bytes'] for e in entries)} bytes")
        for e in entries:
            print(f"  {pretty[e['entry']][:110]}: {e['registers']} registers,"
                  f" {e['spill_bytes']} bytes spill, SASS HGMMA {e['hgmma']}"
                  f" HMMA {e['hmma']}")
        if name in TENSOR_CORE_KERNELS:
            check(all(e["spill_bytes"] == 0 for e in entries),
                  f"{name}: an entry point spills")
            mains = [e for e in entries if "_kernel" in pretty[e["entry"]]
                     and not any(x in pretty[e["entry"]]
                                 for x in SIDE_PASSES)]
            op = TENSOR_CORE_KERNELS[name]
            check(not sass or (mains and all(e[op] for e in mains)),
                  f"{name}: an entry point has no {op.upper()} in its SASS")
    return report


def build_summary(entries) -> dict:
    """Registers, spills and HGMMA / HMMA counts over a kernel's entry
    points."""
    return dict(registers=max(e["registers"] for e in entries),
                spill_bytes=max(e["spill_bytes"] for e in entries),
                sass_hgmma=[e["hgmma"] for e in entries],
                sass_hmma=[e["hmma"] for e in entries])


def headline(rows, shape):
    row = next(r for r in rows if r["shape"] == shape)
    return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "tc_bound_ms", "tc_bound_by")
            if k in row}


def main(argv) -> int:
    check((ROOT / "src" / "repro_torch").is_dir(),
          "src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    if argv == ["--profile"]:
        build_kernels()
        profile_phase()
        return 0
    if argv == ["--attn"]:
        build_kernels()
        attn_phase(torch.Generator(device="cuda").manual_seed(1))
        return 0
    if argv == ["--sharded"]:
        build_kernels()
        sharded_phase(*sharded_refs())
        return 0
    check(not argv, f"unknown arguments {argv}; use --profile, --attn, "
          "--sharded or none")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    builds = build_kernels()

    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import statevector_gates as svg
    from repro_torch.kernels import statevector_tape as svt
    max_err, gate_share, shapes = kernel_phase()
    tape_err, tape_share, tape_shapes = tape_phase(shapes)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lm_err, lm_shapes = lora_phase(gen)
    fa_err, fa_bwd_err, fa_shapes, fa_bwd_shapes, fa_probe = \
        attn_phase(gen)
    i4_err, i4_t_err, i4_shapes, i4_t_shapes = int4_phase(gen)
    waves = wave_probe(gen)
    kl_err, kl_shapes = kl_phase(gen)
    qfl = main_phase()
    size_rule = size_rule_phase()
    llm = llm_phase()
    fused = fused_phase(qfl, llm)
    sharded = sharded_phase(qfl, llm, fused)
    seq = sequential_phase()
    nwq = wide_phase()
    llm_wide = llm_wide_phase()
    seq_wide = llm_wide_sequential_phase()
    ql = qlora_phase()
    ql_wide = llm_wide_phase(quantized=True)
    shots = sample_phase()
    cli = cli_phase()
    gpt2 = gpt2_phase()
    deepseek = llm_wide_sequential_phase("deepseek-llm-7b-base",
                                         DEEPSEEK_TASK, "deepseek sequential")
    gib = 2 ** 30
    print(f"qlora wide against llm wide: base "
          f"{ql_wide['base_bytes'] / gib:.3f} GiB against "
          f"{llm_wide['base_bytes'] / gib:.3f} GiB, peak "
          f"memory {ql_wide['peak_gib']:.2f} GiB against "
          f"{llm_wide['peak_gib']:.2f} GiB, train steps "
          f"{min(ql_wide['step_s']):.3f} s against "
          f"{min(llm_wide['step_s']):.3f} s")

    rule, tquick = shapes[0], tape_shapes[0]
    sh = sharded["modes"]["one card"]
    n, nw, ns = llm["counts"], llm_wide["counts"], seq["seq_launches"]
    nq, nqw = ql["counts"], ql_wide["counts"]
    n0 = qfl["counts"]
    kernels = [
        dict(name=svg.NAME, route="cuda", source=svg.SOURCE,
             replaces=svg.REPLACES, launches=size_rule["statevector_gate"],
             path=f"run_tape above {svt.MAX_QUBITS} qubits (size rule): "
                  "launches from the size-rule phase, times at its shape "
                  f"(B={rule['B']}, n={rule['n_qubits']})",
             max_abs_err=max_err, bitwise_share_vs_plain=gate_share,
             ms=rule["ms"], plain_ms=rule["plain_ms"],
             bound_ms=rule["bound_ms"], bound_by="bytes", library_ms=None,
             launches_qfl=n0["statevector_gate"],
             launches_llm_qfl=n["statevector_gate"],
             launches_wide=nwq["statevector_gate"], shapes=shapes),
        dict(name=svt.NAME, route="cuda", source=svt.SOURCE,
             replaces=svt.REPLACES, launches=n0["statevector_tape"],
             replays=n0["replays"], max_abs_err=tape_err,
             ms=tquick["ms"], plain_ms=tquick["plain_ms"],
             bound_ms=tquick["bound_ms"], bound_by=tquick["bound_by"],
             library_ms=None, launches_llm_qfl=n["statevector_tape"],
             replays_llm_qfl=n["replays"],
             launches_sequential=seq["tape_launches"],
             launches_sequential_llm_qfl=seq["tape_launches_llm"],
             launches_wide=nwq["statevector_tape"],
             launches_aersim=cli["qfl batched"]["counts"]["statevector_tape"],
             replays_aersim=cli["qfl batched"]["counts"]["replays"],
             launches_aersim_llm_qfl=cli["llm-qfl batched"]["counts"][
                 "statevector_tape"],
             launches_fused=fused["qfl"]["statevector_tape"],
             launches_fused_llm_qfl=fused["llm-qfl"]["statevector_tape"],
             launches_fused_aersim_nm=fused["aersim nelder-mead"][
                 "statevector_tape"],
             launches_fused_aersim_spsa=fused["aersim spsa"][
                 "statevector_tape"],
             fused_graph_nodes={k: fused[k]["graph_nodes"] for k in (
                 "qfl", "llm-qfl", "aersim nelder-mead", "aersim spsa",
                 "early")},
             launches_sharded=sh["qfl"]["statevector_tape"],
             launches_sharded_aersim=sh["aersim"]["statevector_tape"],
             launches_sharded_fused=sh["fused"]["statevector_tape"],
             launches_sharded_population=sh["population"][
                 "statevector_tape"],
             bitwise_share_vs_gate_chain=tape_share,
             size_rule=f"n_qubits <= {svt.MAX_QUBITS}; above, run_tape "
                       "launches statevector_gate once a gate",
             shapes=tape_shapes,
             **build_summary(builds["statevector_tape"])),
        dict(name=lm.NAME, route="cuda", source=lm.SOURCE,
             replaces=lm.REPLACES, launches=n["lora_matmul"],
             max_abs_err=lm_err, **headline(lm_shapes, "tiny-w_in"),
             launches_wide=nw["lora_matmul"],
             launches_sequential=ns["lora_matmul"],
             sequential=headline(lm_shapes, "seq-w_in"),
             launches_sequential_wide=seq_wide["counts"]["lora_matmul"],
             launches_sharded=sh["llm"]["lora_matmul"],
             launches_gpt2=gpt2["counts"]["lora_matmul"],
             gpt2=headline(lm_shapes, "gpt2-w_in"),
             launches_deepseek=deepseek["counts"]["lora_matmul"],
             deepseek=headline(lm_shapes, "deepseek-w_in"),
             shapes=lm_shapes,
             waves=[{k: w[k] for k in ("tiles", "lora_graph_ms")}
                    for w in waves],
             **build_summary(builds["lora_matmul"])),
        dict(name=fa.NAME, route="cuda", source=fa.SOURCE,
             replaces=fa.REPLACES, launches=n["flash_attention"],
             max_abs_err=fa_err, **headline(fa_shapes, "tiny"),
             launches_wide=nw["flash_attention"],
             launches_sequential=ns["flash_attention"],
             sequential=headline(fa_shapes, "seq"),
             launches_sequential_wide=seq_wide["counts"]["flash_attention"],
             launches_sharded=sh["llm"]["flash_attention"],
             launches_gpt2=gpt2["counts"]["flash_attention"],
             gpt2=headline(fa_shapes, "gpt2"),
             launches_deepseek=deepseek["counts"]["flash_attention"],
             deepseek=headline(fa_shapes, "deepseek"),
             shapes=fa_shapes,
             probe=fa_probe, **build_summary(builds["flash_attention"])),
        dict(name=fa.NAME + "_bwd", route="cuda", source=fa.SOURCE,
             replaces=fa.REPLACES, launches=n["flash_attention_bwd"],
             max_abs_err=fa_bwd_err, **headline(fa_bwd_shapes, "tiny"),
             launches_wide=nw["flash_attention_bwd"],
             launches_sequential=ns["flash_attention_bwd"],
             sequential=headline(fa_bwd_shapes, "seq"),
             launches_sequential_wide=seq_wide["counts"][
                 "flash_attention_bwd"],
             launches_sharded=sh["llm"]["flash_attention_bwd"],
             launches_gpt2=gpt2["counts"]["flash_attention_bwd"],
             gpt2=headline(fa_bwd_shapes, "gpt2"),
             launches_deepseek=deepseek["counts"]["flash_attention_bwd"],
             deepseek=headline(fa_bwd_shapes, "deepseek"),
             shapes=fa_bwd_shapes,
             **build_summary(builds["flash_attention"])),
        dict(name=i4.NAME, route="cuda", source=i4.SOURCE,
             replaces=i4.REPLACES, launches=nq["int4_matmul"],
             max_abs_err=i4_err, **headline(i4_shapes, "tiny-w_in"),
             launches_wide=nqw["int4_matmul"], shapes=i4_shapes,
             waves=[{k: w[k] for k in ("tiles", "int4_graph_ms")}
                    for w in waves],
             **build_summary(builds["int4_matmul"]),
             library="torch dequantize to float32 + cuBLAS float32 matmul "
                     "(no single PyTorch call takes packed int4)"),
        dict(name=i4.NAME + "_t", route="cuda", source=i4.SOURCE,
             replaces=i4.REPLACES, launches=nq["int4_matmul_t"],
             max_abs_err=i4_t_err, **headline(i4_t_shapes, "tiny-w_in"),
             launches_wide=nqw["int4_matmul_t"], shapes=i4_t_shapes,
             **build_summary(builds["int4_matmul"]),
             library="torch dequantize to float32 + cuBLAS float32 matmul "
                     "(no single PyTorch call takes packed int4)"),
        dict(name=dk.NAME, route="cuda", source=dk.SOURCE,
             replaces=dk.REPLACES, launches=nq["distill_kl"],
             max_abs_err=kl_err, **headline(kl_shapes, "B=4096 C=4102"),
             on_main_path=False, shapes=kl_shapes)]
    print(json.dumps({"qfl": {k: qfl[k] for k in ("wall_s", "round_s")},
                      "llm_qfl": {k: llm[k] for k in ("wall_s", "finetune_s",
                                                      "round_s")},
                      "sequential": seq["wall_s"],
                      "llm_wide": {k: llm_wide[k] for k in (
                          "step_s", "run_s", "peak_gib", "n_params",
                          "init_s", "base_bytes")},
                      "llm_wide_sequential": {k: seq_wide[k] for k in (
                          "stage_s", "batched_s", "step_s", "peak_gib",
                          "seq_peak_gib", "gap", "gap0", "gap1",
                          "spread")},
                      "qlora": {k: ql[k] for k in ("wall_s", "cpu_wall_s")},
                      "qlora_wide": {k: ql_wide[k] for k in (
                          "step_s", "run_s", "peak_gib", "n_params",
                          "init_s", "base_bytes", "base_f32_bytes")},
                      "sample_counts": shots,
                      "fused": {k: ({f: v[f] for f in (
                          "wall_s", "run_s", "loss_gap", "theta_gap")
                          if f in v} if isinstance(v, dict) else v)
                          for k, v in fused.items()},
                      "sharded": dict(wall_s=sharded["wall_s"], **{
                          mode: {k: {f: v[f] for f in (
                              "wall_s", "round_s", "run_s", "gap",
                              "pad_gap", "finetune_s", "graphs") if f in v}
                                 for k, v in m.items()}
                          for mode, m in sharded["modes"].items()}),
                      "cli": {k: {f: v[f] for f in (
                          "wall_s", "cpu_wall_s", "finetune_s", "margin",
                          "near", "loss_gap", "theta_gap")}
                          for k, v in cli.items()},
                      "gpt2": {k: gpt2[k] for k in (
                          "init_s", "run_s", "step_s", "peak_gib", "gap",
                          "n_params")},
                      "deepseek": {k: deepseek[k] for k in (
                          "init_s", "init_peak_gib", "stage_s", "batched_s",
                          "step_s", "peak_gib", "seq_peak_gib", "gap",
                          "gap0", "gap1", "spread", "n_params")}}))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
