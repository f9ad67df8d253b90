#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # device busy/idle of the main paths
    python3 chip_smoke.py --attn       # attention kernels only: checks,
                                       # times and the lone-CTA probe
    python3 chip_smoke.py --sharded    # phase 11 only, on card-only
                                       # one-shard references
    python3 chip_smoke.py --serving    # phase 12 only, with the serving
                                       # shapes' kernel times and a
                                       # profile of 4 serve steps
    python3 chip_smoke.py --families   # phases 13 and 14 only: kimi-k2
                                       # and minicpm3-4b served, and
                                       # stablelm-3b's prefill
    python3 chip_smoke.py --recurrent  # phases 15 and 16 only: jamba
                                       # and xlstm-125m served
    python3 chip_smoke.py --frontends  # phases 17 and 18 only: whisper
                                       # and qwen2-vl served, and
                                       # flash_attention_bwd timed at
                                       # the other families' head dims
    python3 chip_smoke.py --training   # phase 19 only: the six models
                                       # drawn and trained, and the
                                       # train_lm entry point

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
   The tape kernel ``statevector_tape`` is held to its plain version
   bit for bit (the gate angles' sines and cosines are XLA's float32
   ones in both, ``xla_trig``), also on angles where the card's
   ``sinf`` / ``cosf`` and XLA's differ, and to the chain of per-gate
   ``statevector_gate`` launches it replaces (its bitwise-equal share
   printed), and timed beside that chain.  ``flash_attention`` is
   also held at the edges of its 64-row / 64-key tiles, its backward
   must repeat bit for bit, and a probe times it on a lone CTA and a
   wave of 132.  The weight draw ``trunc_normal`` (every base leaf that
   ``init_params`` draws on the card, one launch a leaf) is held to its
   plain version bit for bit, on the card and on the CPU.
3. QFL main path at the quickstart width: federated QFL with batched
   Nelder–Mead on the genomic task, 4-qubit VQC (86 gates, 16 params),
   5 clients, 10 rounds, on the card; the same run on the CPU (the
   plain path), in a process of its own beside the later phases, must
   match it at the end of the run.  Every tape replay is one
   ``statevector_tape`` launch; the size-rule phase then drives
   ``tape_probs`` above the tape kernel's limit of 14 qubits, where
   ``run_tape`` launches ``statevector_gate`` once a gate.
4. LLM-QFL main path (the README quickstart, Algorithm 1): the same task
   with ``method="llm-qfl"``: Step 1 fine-tunes ``tiny-llm`` LoRA
   adapters (30 steps) on the card, then 10 regulated quantum rounds.
   The card's Step 1 is held to the CPU's (plain path) within the
   batched-LLM tolerances, and the CPU's first 5 quantum rounds, run on
   the card's Step 1 outputs, to the card's (a 5-round run on the same
   Step 1, itself the 10-round run's first rounds bit for bit) exactly
   on the integer accounting.  The CPU's Step 1 and its rounds run in processes of
   their own beside the later phases and are held at the end of the
   run.
5. Wide phases: a 10-qubit VQC (485 gates, 40 params), 8 clients, one
   round; and the LLM stage alone at ``llama3.2-1b`` widths (16 layers,
   d_model 2048, 4 clients × 16 rows × 64 tokens, 2 steps, float32 base).
6. QLoRA stages (``lora.quantize_base=True``: every adapted projection's
   base packed int4, consumed by ``int4_matmul`` forward and dx): the
   LLM stage of the quickstart (``BatchedLLMEngine``, 5 clients, 30
   steps, ``tiny-llm``) on the card, held to the same stage on the CPU
   (plain path; run in a process of its own beside the later phases and
   held at the end of the run); then the stage at ``llama3.2-1b``
   widths as in 5.
7. The sequential engine and SPSA (after phase 4), at the quickstart's
   width with the rounds cut to 3, the LLM-QFL runs' to 2 (the
   sequential engine reads every
   objective evaluation back to the host): QFL and LLM-QFL with
   Nelder–Mead on ``engine="sequential"``, each held to the batched
   engine on the card (the LLM-QFL rounds on one Step 1) and the QFL one
   to the CPU; the sequential Step 1 (one client a launch, three
   evaluation forwards a client) held to the batched Step 1 on the same
   base, its launches to ``llm_launch_formula(clients=5, evals=3)``;
   SPSA in both engines, QFL and LLM-QFL, batched on the card held to
   sequential on the card and to batched on the CPU.  The CPU runs go
   in a process of their own beside the card's and are held at the end
   of the run.  After phase 5,
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
   the CPU (run in a process of its own from the build on, beside the
   card's phases), and LLM-QFL selecting 20 % held to the card's LLM-QFL
   run on Step 1 and the first round; the draws within 1e-6 of a CDF boundary
   number no more than chance allows, and each falls in the same class
   in both runs unless the two runs' boundaries straddle it, no more
   than 1e-6 apart; (c) GPT-2's Step 1 at full width
   (``BatchedLLMEngine``, 5 clients, 2 steps; 1 step held to the CPU on
   one base) and DeepSeek-LLM-7B's at full width, 8 of its 30 layers
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
11. Serving and decode (printed as phase 12, after phase 9):
   ``llama3.2-1b`` at its published widths with its bfloat16 base, 4
   requests, ``make_prefill_step`` on prompts of 32 and 512 tokens, then
   16 serve steps sampled at temperature 0.8: prefill time, time a
   serve step beside its byte bound (weights and cache at 3.35 TB/s),
   tokens/s and peak memory.  Held: the launches of a prefill (16
   ``flash_attention``, 80 ``lora_matmul``) and of each serve step (80
   ``lora_matmul``); prefill's last logits against the decode path fed
   the same prompt, within twice the CPU port's own gap at 32 tokens on
   the same weights (at 32 and 512 tokens); prefill and 2 serve steps
   against the CPU port (32 tokens): logits within 3e-2 of the largest,
   caches within twice the CPU port's own prefill-against-decode gap;
   on the same weights in float32 (float32 decode cache) logits and
   caches within 1e-4; the card's prefill without the LoRA term must
   miss the 3e-2 bound.
   ``lora_matmul`` and ``flash_attention`` are timed at the serving
   shapes in bfloat16 against cuBLAS and SDPA.
12. The mixture-of-experts and latent-attention families (printed as
   phases 13 and 14, after phase 12, the earlier phases' tensors freed
   first).  Phase 13: ``kimi-k2-1t-a32b`` at its published widths, its
   depth cut to one ``("attn", "moe")`` layer (printed), the bf16 base
   as ``init_params`` draws it (19.42 B values, each leaf a slice at a
   time), served as phase 12 serves: prefill and serve-step times beside
   the byte bound (every expert's weights read each step), tokens/s,
   peak memory; the 512-token prefill's routing integers against a host
   recount from the read-back router logits, the MoE block's update
   against a float32 per-token reference (``MOE_REF_TOL``), prefill
   against the decode path for the rows that lost no choice to the
   capacity.  Phase 14: ``minicpm3-4b`` at its published widths, its
   depth cut to ``MINICPM_SMOKE_LAYERS`` (all 62 with ``--families``),
   served alike; its first 2 layers on the card against the
   CPU port on the same weights (bf16, and float32 with a float32 decode
   cache), the CPU half in a process of its own beside the card's work;
   the whole model in float32 prefill against the absorbed-matrix decode
   path; then ``stablelm-3b``'s prefill at head dim 80 through the
   kernel against the plain attention.  ``flash_attention`` at head dims
   112, 96 over 64 and 80, and ``lora_matmul`` at kimi's and MLA's
   projections, are held to their plain versions and timed against SDPA
   and cuBLAS.
13. The recurrent families (printed as phases 15 and 16, after phase
   14): ``jamba-1.5-large-398b`` at its published widths, its depth cut
   to a ``("mamba", "mlp")`` and an ``("attn", "mlp")`` layer (2.85 B
   values), and ``xlstm-125m`` at its published widths and all 12
   layers, each served as phase 12 serves (xlstm's serve steps go on
   from the decode path's cache: JAX's mLSTM prefill cache has no
   convolution state): prefill and serve-step times beside the byte
   bound (weights and cache read, recurrent states written), tokens/s,
   peak memory, launches; prefill and 2 serve steps at 32 tokens against
   the CPU port run on host copies of the card's weights in a process
   of its own (bf16 logits within 3e-2, caches within 2e-2 or twice the
   CPU port's own bf16 gap; float32 1e-4); float32 prefill's states
   against the decode path's (1e-4); xlstm's sequential and chunkwise
   mLSTM prefills against each other in float32, and each timed with its
   launches and aten ops; ``lora_matmul`` at jamba's and the mLSTM's
   projections and ``flash_attention`` at head dim 128, timed against
   cuBLAS and SDPA.
14. The encoder-decoder and the vision frontend (printed as phases 17
   and 18; both models drawn while phase 14 waits for its CPU half, and
   run after phase 14, before phases 15-16, whose draws and CPU halves
   start first; ``stamp`` prints each phase's start in seconds from the
   run's start): ``whisper-large-v3``
   at its published widths and all 32 encoder and 32 decoder layers, and
   ``qwen2-vl-72b`` at its published widths with its depth cut from 80
   layers to 1 (3.44 B values), each served behind its stub frontend's
   seeded embeddings (1500 audio frames; 1024 vision patches prepended to
   the prompt) as phase 12 serves: prefill and serve-step times beside
   the byte bound of what a step reads (the decoder's weights, the LM
   head, the self and cross caches), tokens/s, peak memory, launches
   (whisper a prefill 320 ``lora_matmul`` and 96 ``flash_attention``:
   encoder, causal self, cross; qwen2-vl 5 and 1; a serve step every
   adapted projection and no attention); float32 prefill against
   prefill over one token fewer and a serve step (1e-4); prefill and 2
   serve steps at 32 tokens against the CPU port on host copies of the
   card's weights in a process of its own (whisper's first 2 encoder and
   decoder layers, qwen2-vl's one layer, one request each; bf16 logits
   3e-2, caches 2e-2; float32 1e-4); ``lora_matmul`` at both models'
   projections and ``flash_attention`` non-causal over the 1500 frames
   (self, and cross with ``Sq != Sk``) and causal at head dim 128 over
   1024 + P rows, timed against cuBLAS and SDPA.
15. LoRA fine-tuning of every family (printed as phase 19, on each
   model of phases 13-18 before it is freed; xlstm-125m's, drawn anew
   from the same seed, with the train_lm run in a process of its own on
   the card beside phase 7, whose step times are therefore taken under
   contention): ``flash_attention_bwd`` and ``lora_matmul``'s dx at the
   step's shapes (causal, non-causal over 1500 keys, ``Sq != Sk``), in
   bfloat16 and float32, against autograd of their plain versions
   (``TRAIN_KERNEL_TOL``); 4 requests of 128 tokens
   (behind the bfloat16 frames or patches), ``make_train_step(
   n_microbatches=2)`` on the bf16 base with float32 adapters, 2 steps
   under remat and 2 without, which must agree bit for bit (loss,
   gradient norm, adapters, both AdamW moments); peak memory above the
   held model with and without remat (whisper's with remat at most half
   of its without); one step of 1 microbatch against 2 (not kimi-k2:
   the MoE capacity is a microbatch's; not xlstm-125m: its sLSTM
   outgrows a rounding) within ``TRAIN_NM_TOL``; the launches of each
   run against ``train_launch_formula``; the warm step beside
   ``train_bound`` of the remat step and of the function; on the CPU
   halves' float32 models (not kimi-k2's, which has none), one step on
   the card against the CPU port's in the same process as the half
   (loss 1e-5, first moment 1e-5 of its largest; xlstm-125m on 8 tokens
   at ``TRAIN_SLSTM_TOL``, and its bfloat16 step too, within
   ``TRAIN_BF16_TOL``); and ``repro_torch.launch.train_lm`` with
   ``--full --arch xlstm-125m``, its losses and gradient norms finite,
   the first near ln(vocab).
16. Prints the phases' wall times, the card line, one
   ``{"kernels": [...]}`` line (``launches_sequential``: the launches of
   phase 7's sequential LLM-QFL Step 1, and for ``statevector_tape`` of
   its batched SPSA QFL run; ``launches_aersim``, ``launches_gpt2``,
   ``launches_deepseek``: phase 9's; ``launches_fused*``: phase 10's;
   ``launches_sharded*``: phase 11's, on one card; ``launches_serving``
   and ``serving``: phase 12's launches and shapes; ``launches_kimi``,
   ``kimi``, ``launches_minicpm``, ``minicpm``, ``launches_stablelm``,
   ``stablelm``: phases 13 and 14's; ``launches_jamba``, ``jamba``,
   ``launches_xlstm``, ``xlstm``: phases 15 and 16's;
   ``launches_training``, ``training_shapes``: phase 19's, a train step
   under remat a model, and the train_lm run's; ``training_checks``,
   ``training_dx_checks``: phase 19's kernel checks), and last
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
BF16_FLOPS_PER_S = 989e12          # H100 SXM, bf16 tensor cores, dense

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
# torch threads of the process that runs phase 4's quantum rounds on the
# CPU beside the later phases (the costliest CPU comparison of the smoke,
# 230-258 s on 8 threads for 10 rounds, most of it the host's own loop)
CPU_JOB_THREADS = 4
# the rounds of phase 4's LLM-QFL quickstart that the CPU's run holds: the
# first 5 of 10 (all 10 took 412-561 s beside the card's phases and set
# the smoke's pace); the card's 10-round run is held to a card run of 5
# on the same Step 1, round by round, bit for bit
LLM_CPU_ROUNDS = 5
# torch threads of the processes that run a CPU half beside the card's
# phases 4-9 (phase 4's Step 1, phase 6's QLoRA stage, phase 7's runs),
# where phase 4's rounds and phase 19's xlstm-125m run beside them too
SIDE_CPU_THREADS = 2
# the batched-LLM tolerances of the JAX package's tests
LLM_LOSS_TOL, LLM_F1_TOL, TEACHER_TOL = 5e-4, 0.05, 5e-4
KERNELS = ("statevector_gate", "statevector_tape", "lora_matmul",
           "flash_attention", "int4_matmul", "distill_kl", "xla_sincos",
           "trunc_normal")
# (values, dtype, first flat index) of the weight-draw checks: a bfloat16
# slice across the counter's 2**32 boundary, a float32 slice of
# DRAW_SLICE values (the plain version's own slice), a float32 slice of
# no whole number of blocks, and one value
DRAW_CASES = ((1 << 22, "bfloat16", (1 << 32) - (1 << 21)),
              (1 << 25, "float32", 0), ((3 << 20) + 7, "float32", 12345),
              (1, "bfloat16", 7))
# operations a value of the weight draw takes on its shortest path (the
# hash's 20 rounds, the uniform, log1p's rational form and erf_inv's
# polynomial; log's branch, about 40 % of values, left out): the bound is
# a lower one
DRAW_OPS = 170
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


def _run_job(send, fn, args):
    """A spawned process's body: ``fn(*args)`` sent back as (ok, value)."""
    try:
        out = (True, fn(*args))
    except BaseException:
        import traceback
        out = (False, traceback.format_exc())
    send.send(out)
    send.close()


class CpuJob:
    """``fn(*args)`` in a spawned process of its own, beside the card's
    phases.  The process is daemonic, so it ends with the smoke wherever
    that stops; ``result()`` waits for it and fails the smoke if it
    failed."""

    def __init__(self, what: str, fn, *args):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.what = what
        self._recv, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_run_job, args=(send, fn, args),
                                 daemon=True)
        self._proc.start()
        send.close()

    def result(self):
        try:
            ok, value = self._recv.recv()
        except EOFError:
            ok, value = False, "it ended with no result"
        self._proc.join()
        check(ok, f"{self.what}, exit code {self._proc.exitcode}: {value}")
        return value


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


# value counts where the xla_sincos kernel is timed: one gate's angle (a
# trainable rotation), one a row of a client's 50 (the feature map), and
# a wide batch
TRIG_SIZES = (1, 50, 1 << 20)


def trig_phase(gen) -> dict:
    """XLA's float32 sin and cos on the card (``xla_trig``): the
    ``xla_sincos`` kernel against its plain version on the card and on
    the CPU, bitwise, on 2**20 angles; the tape kernel against its plain
    version, bitwise, on the angles where the card's sinf / cosf and
    XLA's differ (P, RY and RZ gates, plain and controlled, 4 qubits);
    the kernel's times at ``TRIG_SIZES``.  Returns the kernels line's
    numbers."""
    import torch
    from repro_torch import xla_trig
    from repro_torch.kernels import ref
    from repro_torch.kernels import statevector_tape as svt
    from repro_torch.kernels import xla_sincos as xs
    cand = torch.rand(1 << 20, generator=gen, device="cuda") * 40 - 20
    s, c = xla_trig.plain_sincos(cand)
    ks, kc = xs.xla_sincos(cand)
    cs, cc = xla_trig.plain_sincos(cand.cpu())
    check(torch.equal(ks, s) and torch.equal(kc, c)
          and torch.equal(s.cpu(), cs) and torch.equal(c.cpu(), cc),
          "xla_sincos: not bitwise its plain version (card or CPU)")
    sh, ch = xla_trig.plain_sincos(cand / 2)
    differ = ((torch.sin(cand) != s) | (torch.cos(cand) != c)
              | (torch.sin(cand / 2) != sh) | (torch.cos(cand / 2) != ch))
    angles = cand[differ]
    check(angles.numel() > 100, f"only {angles.numel()} angles where the "
          "card's sinf/cosf and XLA's differ")
    n, B = 4, 512
    gid = torch.tensor([1, 2, 3] * (2 * n), dtype=torch.int32, device="cuda")
    G = gid.numel()
    target = torch.tensor([q % n for q in range(G)], dtype=torch.int32,
                          device="cuda")
    control = torch.tensor([-1] * (G // 2) + [(q + 1) % n for q in
                                               range(G - G // 2)],
                           dtype=torch.int32, device="cuda")
    ang = angles.repeat(-(-B * G // angles.numel()))[:B * G].reshape(B, G)
    got = svt.statevector_tape(ang.contiguous(), gid, target, control, n)
    want = ref.statevector_tape(ang.contiguous(), gid, target, control, n)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "statevector_tape: not bitwise its plain version on the angles "
          "where sinf and XLA's sin differ")
    rows = []
    for size in TRIG_SIZES:
        x = cand[:size].contiguous()
        ms = cuda_ms(lambda: xs.xla_sincos(x), iters=200)
        dev = graph_ms(lambda: xs.xla_sincos(x))
        plain = cuda_ms(lambda: xla_trig.plain_sincos(x), iters=20)
        # 4 bytes read and 8 written a value (the double-precision
        # operations are not in the published float32 table)
        bms, by = bound_ms(0, 12 * size)
        rows.append(dict(shape=f"n={size}", n=size, ms=ms, graph_ms=dev,
                         plain_ms=plain, bound_ms=bms, bound_by=by,
                         library_ms=None))
    torch.cuda.synchronize()
    print(f"kernel phase: xla_sincos bitwise its plain version on the card "
          f"and on the CPU ({cand.numel()} values); statevector_tape "
          f"bitwise its plain version on {angles.numel()} angles where the "
          f"card's sinf/cosf and XLA's differ; xla_sincos "
          + "; ".join(f"n={r['n']}: {r['ms'] * 1e3:.2f} us (graph "
                      f"{r['graph_ms'] * 1e3:.2f}), plain "
                      f"{r['plain_ms'] * 1e3:.1f} us, bound "
                      f"{r['bound_ms'] * 1e3:.4f} us" for r in rows))
    return dict(differ=int(angles.numel()), shapes=rows)


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
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"statevector_tape n={n} {kind} B={B}: not bitwise "
                      f"its plain version (max abs error {err})")
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
    print(f"kernel phase: statevector_tape bitwise its plain version on "
          f"{cases} cases; == plain on {cases} cases (n in "
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


def rel_err(got, want, floor: float = 1.0) -> float:
    """max |got - want| over max(floor, max |want|), on got's device."""
    got = got.detach().float()
    want = want.detach().float().to(got.device)
    return float((got - want).abs().max()
                 / max(floor, float(want.abs().max())))


def bound_ms(flops: float, nbytes: float, peak: float = F32_FLOPS_PER_S):
    """flops at ``peak`` (FFMA float32 unless stated) or bytes over 3.35
    TB/s, whichever takes longer: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tc_bound_ms(products: int, flops: float, nbytes: float):
    """The tensor-core bound of a projection taken as ``products`` TF32
    products (3xTF32: 3 for float32 operands, 2 when the weight is exact
    in TF32): products · 2MNK over 495 TFLOP/s, or bytes over 3.35 TB/s,
    whichever is larger."""
    return bound_ms(products * flops, nbytes, TF32_FLOPS_PER_S)


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


def time_lora(x, w, a, b, iters: int = 100, replays: int = 20) -> dict:
    """One lora_matmul forward (scale 2) timed: the kernel, its plain
    version and cuBLAS ``x@W`` + ``baddbmm``, in a host loop (``*ms``)
    and the kernel and cuBLAS in a CUDA graph (``*graph_ms``)."""
    import torch
    from repro_torch.kernels import lora_matmul as lm, ref
    kern = lambda: lm._launch(x, w, a, b, 2.0)  # noqa: E731
    lib = lambda: torch.baddbmm(  # noqa: E731
        torch.matmul(x, w), torch.bmm(x, a), b, alpha=2.0)
    return dict(ms=cuda_ms(kern, iters=iters),
                graph_ms=graph_ms(kern, replays),
                plain_ms=cuda_ms(lambda: ref.lora_matmul(x, w, a, b, 2.0),
                                 iters=iters),
                library_ms=cuda_ms(lib, iters=iters),
                library_graph_ms=graph_ms(lib, replays))


def lora_phase(gen):
    """lora_matmul forward (and dx, the same kernel on transposed views)
    against ``ref.lora_matmul``, gradients against plain autograd."""
    import torch
    from repro_torch.kernels import counts, lora_matmul as lm, ref
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
            t = time_lora(x, w, a, b, it, 3 if big else 20)
            ms, dev, plain = t["ms"], t["graph_ms"], t["plain_ms"]
            library, lib_dev = t["library_ms"], t["library_graph_ms"]
            dx_ms = cuda_ms(lambda: lm._launch(dy, w.t(), b.transpose(1, 2),
                                               a.transpose(1, 2), 2.0),
                            iters=it)
            flops, nbytes = counts.lora_flops_bytes(C, M, K, N, r)
            bms, by = bound_ms(flops, nbytes)
            tms, tby = tc_bound_ms(3, 2 * C * M * N * K, nbytes)
            shapes.append(dict(shape=name, C=C, M=M, K=K, N=N, r=r,
                               dx_ms=dx_ms, **t,
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
# the head dims of the other families and stablelm-3b (80; MLA's q/k 96
# over a v of 64, 48 over 32 at -smoke width; kimi-k2's 112), forward
# and backward at the tile
# edges: (B, S, H, KH, D, Dv, causal, window, dtype).  S = 129 over one
# sequence and head is an odd B·S·H above 64 keys.
ATTN_HEAD_DIM_EDGES = tuple(
    [(2, S, 4, 2, D, D, True, 0, dt) for D in (80, 96, 112)
     for S in (64, 129) for dt in ("float32", "bfloat16")]
    + [(1, 129, 1, 1, D, D, True, 0, "float32") for D in (80, 96, 112)]
    + [(2, 100, 8, 2, 112, 112, False, 16, "bfloat16"),
       (2, 129, 4, 4, 96, 64, True, 0, "float32"),
       (2, 129, 4, 4, 96, 64, True, 0, "bfloat16"),
       (3, 33, 4, 4, 96, 64, True, 0, "float32"),
       (1, 129, 1, 1, 96, 64, True, 0, "float32")]
    + [(2, 129, 4, 4, 48, Dv, True, 0, dt) for Dv in (32, 48)
       for dt in ("float32", "bfloat16")])


def attn_check(gen, name, B, S, H, KH, D, causal, window, dtype, Dv=None):
    """Forward and dq/dk/dv of one case against ``ref`` and plain
    autograd: 2e-5 (float32) or 2e-2 (bfloat16) of the largest magnitude.
    ``Dv`` (default ``D``) is v's head dim.  Returns the float32 max abs
    errors (forward, backward)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ref
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    Dv = Dv or D
    q = _randn(gen, (B, S, H, D), dtype=dtype).requires_grad_()
    k = _randn(gen, (B, S, KH, D), dtype=dtype).requires_grad_()
    v = _randn(gen, (B, S, KH, Dv), dtype=dtype).requires_grad_()
    do = _randn(gen, (B, S, H, Dv), dtype=dtype)
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


def time_attn(q, k, v, causal: bool = True, iters: int = 100) -> dict:
    """One flash_attention forward timed (causal unless stated): the
    kernel, its plain version and SDPA with grouped heads, in a host loop
    (``*ms``, ``iters`` calls) and the kernel and SDPA in a CUDA graph
    (``*graph_ms``).  SDPA takes a v narrower than q as it is."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    scale = q.shape[-1] ** -0.5
    if v.shape[-1] == q.shape[-1]:
        kern = lambda: fa._forward(q, k, v, causal, 0, scale)  # noqa: E731
    else:           # a narrower v: the wrapper's zero pad is in the call
        kern = lambda: fa.flash_attention(q, k, v,  # noqa: E731
                                          causal=causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    return dict(ms=cuda_ms(kern, iters=iters), graph_ms=graph_ms(kern),
                plain_ms=cuda_ms(lambda: ref.flash_attention(
                    q, k, v, causal=causal), iters=max(iters // 2, 1)),
                library_ms=cuda_ms(sdpa, iters=iters),
                library_graph_ms=graph_ms(sdpa))


def attn_phase(gen):
    """flash_attention forward and backward against ``ref`` and plain
    autograd, the backward's bitwise repeatability; times against SDPA;
    the probe."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import counts, flash_attention as fa, ref
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
    for B, S, H, KH, D, Dv, c, w, dt in ATTN_HEAD_DIM_EDGES:
        fe, be = attn_check(gen, f"head dims B={B} S={S} H={H} KH={KH} "
                            f"D={D} Dv={Dv} causal={c} window={w} {dt}",
                            B, S, H, KH, D, c, w, getattr(torch, dt), Dv=Dv)
        max_err, max_bwd_err = max(max_err, fe), max(max_bwd_err, be)
        cases += 1
    # the backward twice on the same inputs: bitwise equal (one k-tile at
    # the main paths' shapes; k-tile slabs summed in a fixed order above)
    repeats = 0
    for name, B, S, H, KH, D in ATTN_SHAPES + (
            ("three k-tiles", 2, 160, 8, 2, 64),
            ("three k-tiles, odd B·S·H", 3, 129, 3, 1, 64),
            ("three k-tiles, D=112", 2, 160, 8, 1, 112),
            ("three k-tiles, D=80, odd B·S·H", 3, 129, 3, 1, 80)):
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
          f"({len(ATTN_EDGES)} at tile edges, {len(ATTN_HEAD_DIM_EDGES)} "
          f"at head dims 48 (v 32), 80, 96 (v 64) and 112), max abs err {max_err:.3g} "
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
            t = time_attn(q, k, v)
            ms, dev, plain = t["ms"], t["graph_ms"], t["plain_ms"]
            library, lib_dev = t["library_ms"], t["library_graph_ms"]
            bms, by = bound_ms(*counts.attn_flops_bytes(B, S, H, KH, D))
            # on the tensor cores at float32 accuracy: 3 TF32 products
            tms, tby = tc_bound_ms(
                3, *counts.attn_flops_bytes(B, S, H, KH, D))
        fwd.append(dict(shape=name, B=B, S=S, H=H, KH=KH, D=D, **t,
                        bound_ms=bms, bound_by=by,
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
        bbms, bby = bound_ms(*counts.attn_flops_bytes(B, S, H, KH, D,
                                                      True))
        btms, btby = tc_bound_ms(
            3, *counts.attn_flops_bytes(B, S, H, KH, D, True))
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


def int4_phase(gen):
    """int4_matmul NN (float32 and bf16 rounding) and NT against
    ``ref.int4_matmul``/``int4_matmul_t``; times at the QLoRA paths'
    shapes against the bound, the plain version and torch's dequantize
    followed by cuBLAS float32."""
    import torch
    from repro_torch.kernels import counts, int4_matmul as i4, ref
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
            flops, nbytes = counts.int4_flops_bytes(M, K, N)
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


def draw_phase():
    """The weight draw (``trunc_normal``) against its plain version on
    the card, bitwise, on ``DRAW_CASES`` (phase 13's std, 1/sqrt(7168)),
    and the first 4096 values of each against the CPU's plain version;
    both timed on ``DRAW_SLICE`` bfloat16 values.  Returns the kernels
    line's rows."""
    import torch
    from repro_torch import random as jr
    from repro_torch.kernels import trunc_normal as tn
    key = jr.split(jr.PRNGKey(0), 8)[3]
    std = 1.0 / math.sqrt(7168)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for n, dt, start in DRAW_CASES:
        dtype = getattr(torch, dt)
        got = tn.trunc_normal(key, n, std, dtype, "cuda", start=start)
        want = tn.plain(key, n, std, dtype, "cuda", start=start)
        check(torch.equal(got.view(bits[dtype]), want.view(bits[dtype])),
              f"trunc_normal: not bitwise its plain version at {n} {dt} "
              f"values from {start}")
        m = min(n, 4096)
        cpu = tn.plain(key, m, std, dtype, "cpu", start=start)
        check(torch.equal(got[:m].cpu().view(bits[dtype]),
                          cpu.view(bits[dtype])),
              f"trunc_normal: not bitwise the CPU's plain version at {dt} "
              f"from {start}")
        del got, want
    n = jr.DRAW_SLICE
    ms = cuda_ms(lambda: tn.trunc_normal(key, n, std, torch.bfloat16,
                                         "cuda"), iters=20, warmup=2)
    plain = cuda_ms(lambda: tn.plain(key, n, std, torch.bfloat16, "cuda"),
                    iters=3, warmup=1)
    # no input; 2 bytes written a value
    bms, by = bound_ms(DRAW_OPS * n, 2 * n)
    row = dict(shape=f"n={n} bfloat16", n=n, ms=ms, plain_ms=plain,
               bound_ms=bms, bound_by=by, library_ms=None)
    torch.cuda.synchronize()
    cases = ", ".join(f"{c[0]} {c[1]} from {c[2]}" for c in DRAW_CASES)
    print(f"kernel phase: trunc_normal bitwise its plain version on the "
          f"card ({cases}) and the CPU's (the first 4096 values of each); "
          f"n={n} bfloat16: {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
          f"bound {bms * 1e3:.1f} us ({by}); no PyTorch call draws these "
          "values")
    return [row]


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
    from repro_torch.kernels import trunc_normal as tn
    from repro_torch.kernels import xla_sincos as xs
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
            ("distill_kl", dk.distill_kl, "launches"),
            ("xla_sincos", xs.xla_sincos, "launches"),
            ("trunc_normal", tn.trunc_normal, "launches"))


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
    # the CPU's plain run in a process of its own beside the later phases
    # (main_compare holds it)
    job = CpuJob("main path (cpu, plain)", cpu_main_path)
    return dict(counts=n, wall_s=wall, round_s=orch.round_seconds, gpu=gpu,
                cpu_job=job)


def cpu_main_path() -> tuple:
    """Phase 3's QFL quickstart on the CPU (plain path), in a spawned
    process of ``SIDE_CPU_THREADS`` threads: (result, seconds)."""
    import torch
    torch.set_num_threads(SIDE_CPU_THREADS)
    t0 = time.perf_counter()
    _, cpu, _ = run_main_path("cpu", QUICKSTART)
    return cpu, time.perf_counter() - t0


def main_compare(qfl: dict, fused: dict):
    """Phase 3's CPU run (``cpu_main_path``), collected and held to the
    card's host loop and to phase 10's fused run of the same quickstart,
    as ``compare_runs`` says."""
    t0 = time.perf_counter()
    cpu, seconds = qfl.pop("cpu_job").result()
    waited = time.perf_counter() - t0
    loss_gap, theta_gap = compare_runs(qfl["gpu"], cpu)
    print(f"main path (cpu, plain; a process of {SIDE_CPU_THREADS} threads "
          f"beside phases 4-15, {waited:.2f} s waited for) in {seconds:.2f} "
          f"s: equal maxiters/selected/cum_evals; max |Δ server loss| "
          f"{loss_gap:.3g}, max |Δ θ_g| {theta_gap:.3g}")
    gap = compare_runs(fused["qfl"]["res"], cpu,
                       what="fused qfl quickstart against phase 3's cpu run")
    print(f"  fused qfl quickstart against phase 3's cpu host run: max "
          f"|Δ server loss| {gap[0]:.3g}, |Δ θ_g| {gap[1]:.3g}")


def cpu_step1() -> tuple:
    """The LLM-QFL quickstart's Step 1 on the CPU (plain path), in a
    spawned process of ``SIDE_CPU_THREADS`` threads: (L_LLM, F1, the
    teacher probabilities, fine-tune seconds)."""
    import torch
    torch.set_num_threads(SIDE_CPU_THREADS)
    step1 = dict(LLM_QUICKSTART, run=dict(LLM_QUICKSTART["run"], n_rounds=1))
    _, cpu1, orch1 = run_main_path("cpu", step1, method="llm-qfl")
    return host_tree((cpu1.llm_losses, cpu1.llm_f1,
                      list(orch1.llm_outputs.teacher_probs),
                      cpu1.llm_finetune_time_s))


def llm_phase() -> dict:
    """The LLM-QFL quickstart on the card, held to the CPU's plain path:
    its Step 1 (``cpu_step1``, beside the card's work) and its quantum
    rounds on the card's Step 1 (``cpu_llm_rounds``, beside phases 5-11),
    both held by ``llm_rounds``."""
    import numpy as np
    step1_job = CpuJob("llm-qfl Step 1 (cpu, plain)", cpu_step1)
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
    check(n["trunc_normal"] > 0, "llm-qfl: the base was not drawn by the "
          "trunc_normal kernel")
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

    # the first LLM_CPU_ROUNDS quantum rounds on the CPU, fed the card's
    # Step 1, in a process of their own beside the later phases
    # (llm_rounds holds them to the card's run of as many rounds, which
    # must be the 10-round run's first rounds bit for bit)
    job = CpuJob("llm-qfl rounds (cpu, plain)", cpu_llm_rounds,
                 orch.llm_outputs)
    _, cut, _ = run_main_path("cuda", llm_rounds_cut(), method="llm-qfl",
                              llm_outputs=orch.llm_outputs)
    for attr in ("maxiters", "selected", "cum_evals", "server_loss",
                 "client_losses"):
        check(cut.series(attr) == gpu.series(attr)[:LLM_CPU_ROUNDS],
              f"llm-qfl: the card's {LLM_CPU_ROUNDS}-round run on the same "
              f"Step 1 is not the 10-round run's first rounds: {attr}")
    step1 = (gpu.llm_losses, gpu.llm_f1,
             [np.asarray(t.cpu() if hasattr(t, "cpu") else t)
              for t in orch.llm_outputs.teacher_probs])
    return dict(counts=n, wall_s=wall, finetune_s=gpu.llm_finetune_time_s,
                round_s=orch.round_seconds, gpu=gpu, gpu_cut=cut,
                llm_outputs=orch.llm_outputs, cpu_rounds=job,
                step1=step1, step1_job=step1_job)


def step1_compare(llm: dict):
    """Phase 4's Step 1 on the CPU (``cpu_step1``), collected and held to
    the card's: L_LLM, F1 and the teacher probabilities within
    ``LLM_LOSS_TOL``, ``LLM_F1_TOL`` and ``TEACHER_TOL``."""
    import numpy as np
    t0 = time.perf_counter()
    losses, f1, teacher, seconds = host_tree(llm.pop("step1_job").result(),
                                             False)
    waited = time.perf_counter() - t0
    g_losses, g_f1, g_teacher = llm.pop("step1")
    d_loss = float(np.max(np.abs(np.subtract(g_losses, losses))))
    d_f1 = float(np.max(np.abs(np.subtract(g_f1, f1))))
    d_teacher = max(float(np.max(np.abs(a - np.asarray(b))))
                    for a, b in zip(g_teacher, teacher))
    check(d_loss <= LLM_LOSS_TOL and d_f1 <= LLM_F1_TOL
          and d_teacher <= TEACHER_TOL,
          f"llm-qfl Step 1, cuda vs cpu: |Δ L_LLM| {d_loss}, |Δ F1| {d_f1}, "
          f"|Δ teacher| {d_teacher} (tolerances {LLM_LOSS_TOL}, "
          f"{LLM_F1_TOL}, {TEACHER_TOL})")
    print(f"llm-qfl Step 1 (cpu, plain; a process of {SIDE_CPU_THREADS} "
          f"threads beside phases 4-15, {waited:.2f} s waited for) in "
          f"{seconds:.2f} s: max |Δ L_LLM| {d_loss:.3g}, |Δ F1| "
          f"{d_f1:.3g}, |Δ teacher| {d_teacher:.3g}")


def llm_rounds_cut():
    """``LLM_QUICKSTART`` with its first ``LLM_CPU_ROUNDS`` rounds."""
    return dict(LLM_QUICKSTART, run=dict(LLM_QUICKSTART["run"],
                                         n_rounds=LLM_CPU_ROUNDS))


def cpu_llm_rounds(llm_outputs):
    """The LLM-QFL quickstart's first ``LLM_CPU_ROUNDS`` quantum rounds on
    the CPU (plain path), fed the card's Step 1: (result, seconds)."""
    import torch
    torch.set_num_threads(CPU_JOB_THREADS)
    t0 = time.perf_counter()
    _, res, _ = run_main_path("cpu", llm_rounds_cut(), method="llm-qfl",
                              llm_outputs=llm_outputs)
    return res, time.perf_counter() - t0


def llm_rounds(llm: dict):
    """Phase 4's Step 1 on the CPU (``step1_compare``) and its quantum
    rounds on the CPU, collected and held to the card's: the rounds'
    integer accounting exactly, losses and θ_g as ``compare_runs``
    says."""
    step1_compare(llm)
    t0 = time.perf_counter()
    cpu2, seconds = llm["cpu_rounds"].result()
    loss_gap, theta_gap = compare_runs(llm["gpu_cut"], cpu2)
    print(f"llm-qfl rounds 1-{LLM_CPU_ROUNDS} (cpu, plain, on the card's "
          f"Step 1; a process of {CPU_JOB_THREADS} threads beside phases "
          f"5-15; the card's run of as many rounds is the 10-round run's "
          f"first, bit for bit) in {seconds:.2f} "
          f"s, {time.perf_counter() - t0:.2f} s of it waited for: equal "
          f"maxiters/selected/cum_evals; max |Δ server loss| "
          f"{loss_gap:.3g}, max |Δ θ_g| {theta_gap:.3g}")


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
    step = M.make_train_step(cfg, lr=3e-3, opts=M.FwdOptions(remat=False))
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


def qlora_text(dev: str, out, wall: float, steps: int, n: dict) -> str:
    import numpy as np
    return (f"qlora stage ({dev}): tiny-llm, int4 base, 5 clients, "
            f"{steps} steps + distill + evaluation in {wall:.2f} s; L_LLM "
            f"{np.round(out.losses, 4).tolist()} F1 "
            f"{np.round(out.f1, 4).tolist()}; launches {json.dumps(n)}")


def qlora_cpu(steps: int) -> tuple:
    """``qlora_stage`` on the CPU in a spawned process of
    ``SIDE_CPU_THREADS`` threads: (result, wall seconds, the packed base
    bytes of each layer, printed line)."""
    import torch
    torch.set_num_threads(SIDE_CPU_THREADS)
    zero_counters()
    out, wall, base = qlora_stage("cpu", steps)
    packed = [{k: v for k, v in lyr.items() if k.endswith("__q")}
              for lyr in base["layers"]]
    return host_tree((out, wall, packed, qlora_text(
        "cpu", out, wall, steps, read_counters())))


def qlora_phase(device="cuda") -> dict:
    """The QLoRA LLM stage of the quickstart (BatchedLLMEngine, tiny-llm,
    5 clients, 30 steps) on ``device``, and the same stage on the CPU
    (the plain path, ``qlora_cpu``) beside the card's later work,
    held to it by ``qlora_compare``."""
    steps = LLM_QUICKSTART["run"]["llm_steps"]
    job = CpuJob("qlora stage (cpu, plain)", qlora_cpu, steps)
    zero_counters()
    out, wall, base = qlora_stage(device, steps)
    n = read_counters()
    print(qlora_text(device, out, wall, steps, n))
    check_llm_launches(n, llm_launch_formula(steps, 2), True, "qlora")
    packed = [{k: v.cpu() for k, v in lyr.items() if k.endswith("__q")}
              for lyr in base["layers"]]
    return dict(counts=n, wall_s=wall, card=(out, packed), job=job)


def qlora_compare(ql: dict):
    """Phase 6's QLoRA stage on the CPU, collected and held to the
    card's: the packed base bytes (at least 0.999 of them alike), L_LLM,
    F1 and the teacher probabilities within ``LLM_LOSS_TOL``,
    ``LLM_F1_TOL`` and ``TEACHER_TOL``."""
    import numpy as np
    t0 = time.perf_counter()
    cpu, cpu_wall, cpu_packed, text = host_tree(ql.pop("job").result(),
                                                False)
    waited = time.perf_counter() - t0
    print(text + f" (a process of {SIDE_CPU_THREADS} threads beside "
          f"phases 6-18, {waited:.2f} s waited for)")
    out, packed = ql.pop("card")
    equal = total = 0
    for a, b in zip(packed, cpu_packed):
        for k in a:
            equal += int((a[k] == b[k]).sum())
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
    ql["cpu_wall_s"] = cpu_wall


# ---------------------------------------------------------------------------
# phase 7: the sequential engine and SPSA
# ---------------------------------------------------------------------------
# the quickstart task at full width, its rounds cut to 3: the sequential
# engine reads every objective evaluation back to the host, and 10
# regulated LLM-QFL rounds of it would take minutes
SEQ_QFL = dict(task=QUICKSTART["task"], run=dict(n_rounds=3))
# the LLM-QFL runs keep 2 rounds: the sequential engine's third round
# (every budget near 100, gate by gate on the host) took 45 s of the
# smoke's 1200, and round 2 already runs the budgets' regulation
SEQ_LLM = dict(task=QUICKSTART["task"],
               run=dict(n_rounds=2, llm_steps=LLM_QUICKSTART["run"][
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


def sequential_cpu_runs(step1) -> list:
    """Phase 7's CPU runs, one after another in a spawned process of
    ``SIDE_CPU_THREADS`` threads: QFL Nelder–Mead sequential, QFL SPSA
    batched and LLM-QFL SPSA batched on the card's sequential Step 1
    ``step1``: ``[(label, result, printed lines)]``."""
    import contextlib
    import io
    import torch
    torch.set_num_threads(SIDE_CPU_THREADS)
    out = []
    for label, cfg, kw in (
            ("qfl nm sequential", SEQ_QFL, dict(engine="sequential")),
            ("qfl spsa batched", SEQ_QFL, dict(optimizer="spsa")),
            ("llm-qfl spsa batched", SEQ_LLM, dict(
                method="llm-qfl", optimizer="spsa", llm_outputs=step1))):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res = drive(label, "cpu", cfg, **kw)[0]
        out.append((label, res, text.getvalue()))
    return out


def sequential_phase() -> dict:
    """The sequential engine (Nelder–Mead and SPSA) and the batched SPSA
    at the quickstart's width, QFL and LLM-QFL, on the card: each held to
    the other engine on the card here, and to a run on the CPU
    (``sequential_cpu_runs``, started once the sequential Step 1 is there,
    in a process of its own beside the card's work) by
    ``sequential_compare``."""
    import numpy as np
    print("sequential and SPSA phase (genomic, 5 clients x 50 rows, 4-qubit "
          f"VQC, tiny-llm 30 Step-1 steps, {SEQ_QFL['run']['n_rounds']} "
          f"rounds, LLM-QFL {SEQ_LLM['run']['n_rounds']}):")
    wall, counts, gaps = {}, {}, {}

    def run(label, device, cfg, **kw):
        res, orch, n, t = drive(label, device, cfg, **kw)
        wall[label], counts[label] = t, n
        return res, orch, n

    def hold(name, a, b, loss_tol=1e-5, theta_tol=1e-4):
        gaps[name] = hold_runs(name, a, b, loss_tol, theta_tol)

    # 1. QFL, Nelder–Mead: sequential against batched
    seq, _, n = run("qfl nm sequential", "cuda", SEQ_QFL,
                    engine="sequential")
    check_no_tape(n, "qfl nm sequential")
    # the eager circuit's gates take their sines and cosines from the
    # xla_sincos kernel, one launch a rotation or feature-map gate
    trig_launches = n["xla_sincos"]
    check(trig_launches > 0, "qfl nm sequential: the eager circuit "
          "launched no xla_sincos")
    bat, _, n = run("qfl nm batched", "cuda", SEQ_QFL)
    check_tape_launches(n, "qfl nm batched")
    hold("qfl nm: sequential vs batched (cuda)", seq, bat)
    cards = {"qfl nm sequential": seq}

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
    job = CpuJob("phase 7's CPU runs", sequential_cpu_runs, step1)
    bat2, _, n = run("llm-qfl nm batched, sequential Step 1", "cuda",
                     SEQ_LLM, method="llm-qfl", llm_outputs=step1)
    check_tape_launches(n, "llm-qfl nm batched")
    hold("llm-qfl nm: sequential vs batched (cuda, one Step 1)", seq, bat2,
         loss_tol=1e-4)

    # 3. SPSA: batched against sequential on the card
    sb, _, n = run("qfl spsa batched", "cuda", SEQ_QFL, optimizer="spsa")
    check_tape_launches(n, "qfl spsa batched")
    tape_launches = n["statevector_tape"]
    ss, _, n = run("qfl spsa sequential", "cuda", SEQ_QFL, optimizer="spsa",
                   engine="sequential")
    check_no_tape(n, "qfl spsa sequential")
    hold("qfl spsa: batched vs sequential (cuda)", sb, ss, 1e-4, 1e-4)
    cards["qfl spsa batched"] = sb
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
    cards["llm-qfl spsa batched"] = lb
    return dict(wall_s=wall, seq_launches=seq_launches,
                tape_launches=tape_launches, trig_launches=trig_launches,
                tape_launches_llm=tape_launches_llm, gaps=gaps, cards=cards,
                job=job)


def hold_runs(name, a, b, loss_tol, theta_tol) -> tuple:
    """``compare_runs`` of two runs, printed: (max |Δ server loss|, max
    |Δ θ_g|)."""
    import numpy as np
    compare_runs(a, b, loss_tol, theta_tol, what=name)
    gaps = (float(np.max(np.abs(np.subtract(a.series("server_loss"),
                                            b.series("server_loss"))))),
            float(np.max(np.abs(a.theta_g - b.theta_g))))
    print(f"  {name}: equal maxiters/selected/cum_evals; max |Δ server "
          f"loss| {gaps[0]:.3g} (tol {loss_tol}), max |Δ θ_g| "
          f"{gaps[1]:.3g} (tol {theta_tol})")
    return gaps


def sequential_compare(seq: dict):
    """Phase 7's CPU runs, collected and each held to its card run by
    ``hold_runs`` (server loss / θ_g: Nelder–Mead QFL 1e-5 / 1e-4, SPSA
    QFL 1e-4 / 1e-4, SPSA LLM-QFL on one Step 1 1e-4 / 1e-3)."""
    t0 = time.perf_counter()
    runs = seq.pop("job").result()
    print(f"phase 7's CPU runs ({SIDE_CPU_THREADS} threads, a process of "
          f"their own beside the later phases; {time.perf_counter() - t0:.1f}"
          " s waited for):")
    tols = {"qfl nm sequential": (1e-5, 1e-4),
            "qfl spsa batched": (1e-4, 1e-4),
            "llm-qfl spsa batched": (1e-4, 1e-3)}
    for label, cpu, text in runs:
        print(text, end="")
        seq["gaps"][f"{label}: cuda vs cpu"] = hold_runs(
            f"{label}: cuda vs cpu", seq["cards"][label], cpu, *tols[label])
    seq.pop("cards")


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
                              what: str = "llm wide sequential",
                              n_layers: int = None) -> dict:
    """``run_sequential_stage`` at ``model``'s widths (llama3.2-1b unless
    stated; float32 base, one client a launch; its published depth
    unless ``n_layers`` cuts it) against ``BatchedLLMEngine`` on the
    same base.

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
    depth = cfg.n_layers
    if n_layers is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
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
    print(f"{what} phase ({model} widths, {cfg.n_layers} layers of "
          f"{depth}, "
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
# its depth cut from 30 layers to 8, for the smoke's time: the phase runs
# seven stages (about 70 s at 30 layers on the card)
DEEPSEEK_LAYERS = 8


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


def cli_cpu_runs(runs, threads: int) -> list:
    """The CPU halves of phase 9b, one after another in a spawned
    process: ``[(label, result, wall, margin, printed lines)]``, each
    margin's tensors as ``HostTensor``s (a tensor would be shared through
    the exiting process)."""
    import contextlib
    import io
    import torch
    torch.set_num_threads(threads)
    out = []
    for label, argv in runs:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cpu, _, wall, margin = cli_run(label, argv, "cpu")
        margin.__dict__.update(host_tree(margin.__dict__))
        out.append((label, cpu, wall, margin, text.getvalue()))
    return out


def cli_cpu_job():
    """Phase 9b's CPU runs (``cli_cpu_runs``) in a process of their own,
    started after the build: they need nothing of the card's runs."""
    return CpuJob("phase 9b's CPU runs", cli_cpu_runs,
                  [(label, EXP1 + extra) for label, extra in CLI_RUNS
                   if label not in CARD_ONLY], CPU_JOB_THREADS)


def cli_phase(job) -> dict:
    """(b) ``repro_torch.launch.train`` with Experiment I's flags on the
    card: QFL and LLM-QFL, batched; QFL sequential; QFL batched on
    ``fake`` and ``real``; each is also run on the CPU in a process of
    its own (``job``, from ``cli_cpu_job``: ``CPU_JOB_THREADS`` threads,
    the runs one after another) and held to the card's by
    ``cli_compare``.  LLM-QFL selecting 20 % runs on the card alone
    (``CARD_ONLY``)."""
    print("phase 9b: the training CLI, Experiment I's flags (aersim, 100 "
          f"shots, Dirichlet 0.5 shards, 5 clients, {EXP1[-1]} rounds):")
    out, cards, margins = {}, {}, {}
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
        margins[label] = margin
        out[label] = dict(wall_s=wall, counts=n,
                          margin=dict(value=margin.value, near=margin.near,
                                      draws=margin.draws),
                          finetune_s=gpu.llm_finetune_time_s)
    return dict(out=out, cards=cards, margins=margins, job=job,
                started=time.perf_counter())


def cli_compare(cli: dict) -> dict:
    """Phase 9b's CPU runs, collected and each held to its card run:
    integer accounting exactly, losses and θ_g as ``compare_runs`` says,
    Step 1 within ``LLM_LOSS_TOL``; every draw within NEAR of a CDF
    boundary in either run falls in the same class in both, unless the
    two runs' boundaries straddle it no more than NEAR apart."""
    import numpy as np
    t0 = time.perf_counter()
    runs = cli["job"].result()
    waited = time.perf_counter() - t0
    out = cli["out"]
    print(f"phase 9b's CPU runs ({CPU_JOB_THREADS} threads, a process of "
          f"their own beside phases 2-15; {waited:.1f} s waited for):")
    for label, cpu, cpu_wall, cpu_margin, text in runs:
        print(text, end="")
        cpu_margin.__dict__.update(host_tree(cpu_margin.__dict__, False))
        gpu, margin = cli["cards"][label], cli["margins"][label]
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
        out[label].update(cpu_wall_s=cpu_wall, near=near._asdict(),
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


def gpt2_setup():
    import torch
    from repro_torch.core.llm_client import task_llm_config
    from repro_torch.data.tasks import build_task
    task = build_task("genomic", **QUICKSTART["task"])
    cfg = task_llm_config("gpt2", task.vocab_size, task.llm_seq_len)
    return torch, task, cfg


def gpt2_cpu() -> dict:
    """GPT-2's one-step Step 1 on the CPU (plain path), in a spawned
    process of ``SIDE_CPU_THREADS`` threads beside the card's later
    phases, on the base drawn on the CPU (the port's draw is the same
    bits on any device): its losses, F1, teacher and seconds."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch.core.batched_llm import BatchedLLMEngine
    from repro_torch.models import model as M
    torch, task, cfg = gpt2_setup()
    torch.set_num_threads(SIDE_CPU_THREADS)
    base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                         device="cpu")
    t0 = time.perf_counter()
    cpu = BatchedLLMEngine(task, cfg, base, seed=0, steps=1,
                           batch_size=LLM_WIDE["batch_size"]).run()
    return dict(losses=np.asarray(cpu.losses), f1=np.asarray(cpu.f1),
                teacher=np.asarray(cpu.teacher),
                seconds=time.perf_counter() - t0)


def gpt2_compare(gpt2: dict):
    """Phase 9c's card step held to the CPU's (``gpt2_cpu``, collected
    with the later comparisons)."""
    import numpy as np
    one, cpu = gpt2.pop("one"), gpt2.pop("job").result()
    gap = (float(np.max(np.abs(one["losses"] - cpu["losses"]))),
           float(np.max(np.abs(one["f1"] - cpu["f1"]))),
           float(np.max(np.abs(one["teacher"] - cpu["teacher"]))))
    gpt2["gap"] = gap
    print(f"phase 9c: gpt2 card vs cpu after 1 step |Δ L_LLM| "
          f"{gap[0]:.3g}, |Δ F1| {gap[1]:.3g}, |Δ teacher| {gap[2]:.3g} "
          f"(cpu {cpu['seconds']:.1f} s in a process of "
          f"{SIDE_CPU_THREADS} threads beside phases 12-18)")
    check(gap[0] <= LLM_LOSS_TOL and gap[1] <= LLM_F1_TOL
          and gap[2] <= TEACHER_TOL,
          f"gpt2 Step 1, card vs cpu after 1 step: {gap} (tolerances "
          f"{LLM_LOSS_TOL}, {LLM_F1_TOL}, {TEACHER_TOL})")


def gpt2_phase() -> dict:
    """(c) GPT-2's Step 1 at full width: ``BatchedLLMEngine`` on the
    quickstart task's 5 clients, 2 steps on the card, its launches held
    to ``llm_launch_formula``; one step on the card, held to one step on
    the CPU on the same base (the batched-LLM tolerances) by
    ``gpt2_compare``, the CPU's run in a process of its own
    (``gpt2_cpu``)."""
    import numpy as np
    from repro_torch import random as jr
    from repro_torch.core.batched_llm import BatchedLLMEngine
    from repro_torch.models import model as M
    job = CpuJob("gpt2 Step 1 (cpu, plain)", gpt2_cpu)
    what = "gpt2"
    torch, task, cfg = gpt2_setup()
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
    one = dict(losses=np.asarray(one.losses), f1=np.asarray(one.f1),
               teacher=np.asarray(one.teacher))
    check(np.all(np.isfinite(out.losses)), f"{what}: L_LLM {out.losses}")
    print(f"phase 9c: gpt2 (full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"{n_params / 1e9:.3f} B base values) Step 1, C={task.n_clients}, "
          f"{bs} x 64 tokens: base draw {init_s:.2f} s; run() of {steps} "
          f"steps + distill + evaluation {run_s:.2f} s; train steps "
          f"{', '.join(f'{t:.3f}' for t in step_s)} s; peak memory "
          f"{peak:.2f} GiB; launches {json.dumps(n)}")
    return dict(counts=n, init_s=init_s, run_s=run_s, step_s=step_s,
                peak_gib=peak, n_params=n_params, one=one, job=job)


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
    # held to phase 3's CPU run at the comparisons (main_compare)
    out["qfl"] = fused_drive("qfl quickstart", QUICKSTART, qfl["gpu"])
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


# ---------------------------------------------------------------------------
# phase 12: serving and decode at llama3.2-1b's full width
# ---------------------------------------------------------------------------
# B requests, prompts of the serving example's 32 tokens and of 512 (eight
# 64-key tiles of the attention kernel), then SERVE_STEPS serve steps
SERVE_MODEL, SERVE_B, SERVE_STEPS = "llama3.2-1b", 4, 16
SERVE_PROMPTS = (32, 512)
SERVE_TEMPERATURE = 0.8
# the card against the CPU port on the same weights (32-token prompts),
# of the largest magnitude.  bfloat16 base: logits within 3e-2 (the bound
# of tests/test_torch_decode.py for bfloat16 logits rounded in another
# order); the caches (every layer's k and v) within twice the CPU port's
# own gap between its prefill's caches and those its decode path fills,
# the bfloat16 noise of the residual stream at this depth, as prefill's
# logits are held to the decode path's.  The same weights in float32,
# with a float32 decode cache (a bfloat16 one rounds a float32 model's
# k, v and softmax back to bfloat16), separate the kernels from that
# noise: logits and caches within 1e-4, the float32 bound of
# tests/test_torch_cuda_decode.py.  A control, the card's prefill with
# every lora_b zeroed, must land outside SERVE_CPU_TOL.
SERVE_CPU_TOL, SERVE_F32_TOL = 3e-2, 1e-4


def serving_launches(n_layers: int, n_proj: int = 5) -> dict:
    """Launches of one prefill and of one serve step: every adapted
    projection once a layer; attention once a layer in prefill (the
    decode attention is plain torch, as the JAX package's is jnp)."""
    return {"prefill": {"lora_matmul": n_layers * n_proj,
                        "flash_attention": n_layers},
            "serve_step": {"lora_matmul": n_layers * n_proj,
                           "flash_attention": 0}}


def check_serving_launches(n: dict, want: dict, what: str):
    for name, count in n.items():
        check(count == want.get(name, 0),
              f"{what}: {count} {name} launches, want {want.get(name, 0)}")


def times_text(t: dict, library: str) -> str:
    return (f"kernel {t['ms'] * 1e3:.2f} us (graph {t['graph_ms'] * 1e3:.2f}"
            f" us), plain {t['plain_ms'] * 1e3:.1f} us, {library} "
            f"{t['library_ms'] * 1e3:.2f} us (graph "
            f"{t['library_graph_ms'] * 1e3:.2f} us)")


def serving_kernel_times(gen) -> dict:
    """``lora_matmul`` and ``flash_attention`` at phase 12's serving
    shapes (``llama3.2-1b``'s ``w_in``, rank 8), in bfloat16
    (``kernel_times``)."""
    d, ff, B = 2048, 8192, SERVE_B
    return kernel_times(
        gen, [(name, M_, d, 2 * ff, 8) for name, M_ in (
            ("decode-w_in", B), ("prefill-32-w_in", B * 32),
            ("prefill-512-w_in", B * 512))],
        [(f"prefill-{S}", B, S, 32, 8, 64, 64) for S in SERVE_PROMPTS])


def kernel_times(gen, lora_shapes, attn_shapes, lora_iters=(50, 20),
                 attn_iters: int = 100) -> dict:
    """``lora_matmul`` at ``(name, M, K, N, r)`` (one client) and
    ``flash_attention`` forward at ``(name, B, S, H, KH, D, Dv)`` (causal,
    ``S`` keys) or ``(name, B, S, H, KH, D, Dv, Sk, causal)``, in
    bfloat16 (``lora_iters``: ``time_lora``'s host-loop calls and the
    calls a graph captures, fewer for shapes of tens of ms;
    ``attn_iters``: ``time_attn``'s): each held to its plain version
    (2e-2 of the largest magnitude) and timed by ``time_lora`` /
    ``time_attn``, beside its bound (bf16 tensor cores, 989 TFLOP/s, or
    bytes over 3.35 TB/s).  A v narrower than q goes through the
    wrapper's zero pad, as the model calls it; it is timed padded (the
    pad is part of the call)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, lora_matmul as lm
    from repro_torch.kernels import counts, ref
    bf = torch.bfloat16
    lora, attn = [], []
    with torch.no_grad():
        for name, M_, K, N, r in lora_shapes:
            x = _randn(gen, (1, M_, K), dtype=bf)
            w = _randn(gen, (K, N), K ** -0.5, bf)
            a = _randn(gen, (1, K, r), K ** -0.5, bf)
            b = _randn(gen, (1, r, N), 0.1, bf)
            got = lm._launch(x, w, a, b, 2.0)
            want = ref.lora_matmul(x, w, a, b, 2.0)
            err = rel_err(got, want, floor=0.0)
            check(err <= 2e-2, f"lora_matmul {name}: error {err}")
            t = time_lora(x, w, a, b, *lora_iters)
            bms, by = bound_ms(*counts.lora_flops_bytes(1, M_, K, N, r,
                                                        elem=2),
                               BF16_FLOPS_PER_S)
            lora.append(dict(shape=name, C=1, M=M_, K=K, N=N, r=r,
                             dtype="bfloat16",
                             max_abs_err=abs_err(got, want), **t,
                             bound_ms=bms, bound_by=by))
            print(f"  lora_matmul {name} (M={M_} K={K} N={N} r={r} "
                  f"bf16): {times_text(t, 'cuBLAS')}, bound "
                  f"{bms * 1e3:.2f} us ({by}); rel err {err:.3g}")
        for name, B, S, H, KH, D, Dv, *rest in attn_shapes:
            Sk, causal = rest or (S, True)
            q = _randn(gen, (B, S, H, D), dtype=bf)
            k = _randn(gen, (B, Sk, KH, D), dtype=bf)
            v = _randn(gen, (B, Sk, KH, Dv), dtype=bf)
            got = fa.flash_attention(q, k, v, causal=causal)
            want = ref.flash_attention(q, k, v, causal=causal)
            err = rel_err(got, want, floor=0.0)
            check(err <= 2e-2, f"flash_attention {name}: {err}")
            t = time_attn(q, k, v, causal, attn_iters)
            if Dv < D:      # the kernel alone on a v padded beforehand
                vp = torch.nn.functional.pad(v, (0, D - Dv))
                t["padded_kernel_graph_ms"] = graph_ms(
                    lambda: fa._forward(q, k, vp, causal, 0, D ** -0.5))
            bms, by = bound_ms(*counts.attn_flops_bytes(
                B, S, H, KH, D, elem=2, Dv=Dv, Sk=Sk, causal=causal),
                BF16_FLOPS_PER_S)
            attn.append(dict(shape=name, B=B, S=S, Sk=Sk, causal=causal,
                             H=H, KH=KH, D=D, Dv=Dv, dtype="bfloat16",
                             max_abs_err=abs_err(got, want), **t,
                             bound_ms=bms, bound_by=by))
            pad = (f"; the kernel alone on v padded beforehand (graph) "
                   f"{t['padded_kernel_graph_ms'] * 1e3:.2f} us"
                   if Dv < D else "")
            mask = "causal" if causal else "not causal"
            print(f"  flash_attention {name} (B={B} S={S} Sk={Sk} H={H} "
                  f"KH={KH} D={D} Dv={Dv} {mask} bf16): "
                  f"{times_text(t, 'SDPA')}, bound "
                  f"{bms * 1e3:.2f} us ({by}); rel err {err:.3g}{pad}")
    return dict(lora_matmul=lora, flash_attention=attn)


def decode_path(cfg, model, prompts, device, dtype=None, slots=None):
    """The serve step fed ``prompts`` one token at a time from an empty
    cache of ``slots`` positions (the prompt's length unless given; the
    serving example's prefill; bfloat16 unless ``dtype``): its last
    logits and the cache it filled."""
    import torch
    from repro_torch.models import model as M
    serve = M.make_serve_step(cfg)
    B, P = prompts.shape
    cache = M.init_cache(cfg, B, slots or P, dtype=dtype or torch.bfloat16,
                         device=device)
    for p in range(P):
        logits, cache = serve(*model, cache, prompts[:, p:p + 1], p)
    return logits, cache


def mixers_of(cfg) -> list:
    return [cfg.pattern[i % len(cfg.pattern)][0]
            for i in range(cfg.n_layers)]


def seeds_serve(cfg) -> bool:
    """Whether prefill's caches can seed the serve step: every layer's
    but an mLSTM one's (its prefill cache ``(C, n, m)`` has no
    convolution state, as in the JAX package)."""
    return "mlstm" not in mixers_of(cfg)


def decode_cache(cfg, caches, steps: int, device):
    """A decode cache of ``P + steps`` slots holding prefill's: an
    attention layer's ``P`` rows of k and v (MLA's c_kv and k_rope; ``P``
    counts a vision model's patch rows), a recurrent layer's state as it
    is, in their dtypes (the activations'; Mamba's ``h`` float32); an
    encoder-decoder's cross caches are prefill's ``(xk, xv)``."""
    from repro_torch.models import model as M
    mixers = mixers_of(cfg)
    check(seeds_serve(cfg), "an mLSTM prefill cache cannot seed the serve "
          "step")
    own = [c[0] for c in caches] if cfg.encoder_decoder else caches
    seq = [c for mx, c in zip(mixers, own) if mx in ("attn", "mla")]
    B = own[0][0].shape[0]
    P = seq[0][0].shape[1] if seq else 0
    dtype = seq[0][0].dtype if seq else own[0][-1].dtype
    cache = M.init_cache(cfg, B, P + steps, dtype=dtype, device=device)
    for mx, got, dst in zip(mixers, own,
                            cache[0] if cfg.encoder_decoder else cache):
        for src, d in zip(got, dst):
            if mx in ("attn", "mla"):
                d[:, :P] = src
            else:
                d.copy_(src)
    if cfg.encoder_decoder:
        for got, dst in zip(caches, cache[1]):
            for src, d in zip(got[1], dst):
                d.copy_(src)
    return cache


def patch_rows(cfg) -> int:
    """The rows a vision model's prefill puts before the prompt: its
    projected patches (none for any other model)."""
    return 0 if cfg.encoder_decoder or not cfg.frontend \
        else cfg.n_frontend_tokens


def cache_errs(got, want) -> list:
    """Each layer's larger error of k and v, of the largest magnitude."""
    return [max(rel_err(g, w, floor=0.0) for g, w in zip(gl, wl))
            for gl, wl in zip(got, want)]


def serving_counts(run: dict, name: str) -> dict:
    """A kernel's launches in one prefill and in the serve steps after
    it, for the ``kernels`` line."""
    return {"prefill": run["launches_prefill"][name],
            f"serve_steps_{SERVE_STEPS}": run["launches_steps"][name]}


def serving_phase(profile: bool = False) -> dict:
    """Phase 12: ``llama3.2-1b`` at its published widths (16 layers,
    d_model 2048, 32/8 heads of 64, d_ff 8192, vocab 128256, tied), the
    base in its config's bfloat16, adapters with ``lora_b`` + 0.01, 4
    requests: ``make_prefill_step`` on prompts of 32 and 512 tokens, then
    16 serve steps sampled at temperature 0.8, timed.  Checks, made after
    every number is printed: the launches of a prefill and of the serve
    steps; then, in ``serving_compare`` once the CPU port's half (started
    after the draw, in a process of its own) is in, prefill's last logits
    against the decode path and the card against the CPU port at 32
    tokens.  Peak memory is taken after the base draw (whose own peak is
    printed).  ``profile`` traces 4 warm serve steps after the 512-token
    prefill."""
    import torch
    from repro_torch import random as jr
    from repro_torch.configs.registry import get
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg = get(SERVE_MODEL)
    B, steps = SERVE_B, SERVE_STEPS
    want = serving_launches(cfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    key = jr.PRNGKey(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, key)
    adapters = [{k: v + 0.01 if "lora_b" in k else v for k, v in a.items()}
                for a in M.init_adapters(cfg, key, params)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    model = (params, adapters)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(model))
    prompts = torch.from_numpy(jr.randint(
        key, (B, max(SERVE_PROMPTS)), 4, cfg.vocab_size - 4)).long().cuda()
    P_cpu = min(SERVE_PROMPTS)
    fed = prompts[:, P_cpu:P_cpu + 2]
    job = CpuJob("phase 12's CPU half", family_half_cpu, cfg,
                 *host_tree((model, prompts[:, :P_cpu], fed)),
                 CPU_JOB_THREADS)
    runs = {}
    for P in SERVE_PROMPTS:
        r = runs[P] = serve_timed(cfg, model, prompts[:, :P], steps, key,
                                  weight_bytes)
        dec = decode_path(cfg, model, prompts[:, :P], "cuda")[0]
        r["gap"] = float((dec - r["logits"]).abs().max())
        r["largest_logit"] = float(r["logits"].abs().max())
        prefill_s, decode_s = r["prefill_s"], r["decode_s"]
        n_prefill, n_steps = r["launches_prefill"], r["launches_steps"]
        cache_bytes = r["cache_bytes"]
        print(f"phase 12 (serving {SERVE_MODEL}, bf16, B={B}, prompt {P}): "
              f"prefill {prefill_s * 1e3:.2f} ms; {steps} serve steps "
              f"{decode_s:.4f} s, {r['step_s'] * 1e3:.3f} ms a step (byte "
              f"bound {r['bound_step_ms']:.3f} ms: {weight_bytes / 1e9:.3f} "
              f"GB of weights and {cache_bytes / 1e6:.1f} MB of cache at "
              f"3.35 TB/s), {r['tokens_per_s']:.1f} tokens/s; prefill "
              f"against the decode path {r['gap']:.3g} (largest logit "
              f"{r['largest_logit']:.3g}); launches: prefill "
              f"{json.dumps(n_prefill)}, serve steps {json.dumps(n_steps)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the card's half of the comparison with the CPU port at 32 tokens
    # (whose half runs in a process of its own, started after the draw),
    # and the control
    card = family_half(cfg, model, prompts[:, :P_cpu], fed)
    no_lora = [{k: torch.zeros_like(v) if "lora_b" in k else v
                for k, v in a.items()} for a in adapters]
    control_logits = M.make_prefill_step(cfg)(
        params, no_lora, {"tokens": prompts[:, :P_cpu]})[0].float().cpu()
    del no_lora
    if profile:
        profile_serving(cfg, model, runs[max(SERVE_PROMPTS)])
    for P, r in runs.items():
        check_serving_launches(r["launches_prefill"], want["prefill"],
                               f"prefill {P}")
        check_serving_launches(r["launches_steps"], {
            name: steps * c for name, c in want["serve_step"].items()},
            f"{steps} serve steps after a {P}-token prefill")
        check(r["finite"] and r["logits"].shape == (B, cfg.vocab_size),
              f"prefill {P} or its serve steps: logits not finite")
    big = runs[max(SERVE_PROMPTS)]
    return dict(
        wall_s=time.perf_counter() - t_phase, init_s=init_s, peak_gib=peak,
        draw_peak_gib=draw_peak, weight_bytes=weight_bytes,
        bound_step_ms=big["bound_step_ms"], job=job, card=card,
        control_logits=control_logits,
        runs={P: {k: v for k, v in r.items() if k not in ("logits",
                                                           "caches")}
              for P, r in runs.items()})


def serving_compare(serving: dict) -> dict:
    """Phase 12's checks against the CPU port, once its half is in: at 32
    tokens, prefill and 2 serve steps fed the prompt's next tokens, in
    bfloat16 (logits within ``SERVE_CPU_TOL`` of the largest, every
    layer's caches within twice the CPU port's own prefill-against-decode
    gap) and on the same weights in float32 with a float32 decode cache
    (``SERVE_F32_TOL``); prefill against the decode path on the card, at
    32 and 512 tokens, within twice the CPU port's own gap at 32; the
    control (the card's prefill without the LoRA term) outside
    ``SERVE_CPU_TOL``."""
    t0 = time.perf_counter()
    cpu = host_tree(serving.pop("job").result(), False)
    waited = time.perf_counter() - t0
    card = serving.pop("card")
    P_cpu = min(SERVE_PROMPTS)
    errs = {}
    for label in ("bfloat16", "float32"):
        g, w = card[label], cpu[label]
        errs[label] = dict(
            prefill=rel_err(g["prefill"], w["prefill"], floor=0.0),
            steps=[rel_err(a, b, floor=0.0)
                   for a, b in zip(g["steps"], w["steps"])],
            prefill_caches=cache_errs(g["caches"], w["caches"]),
            step_caches=cache_errs(g["step_caches"], w["step_caches"]),
            seconds=w["seconds"])
    bf, fl = errs["bfloat16"], errs["float32"]
    cpu_gap, cpu_cache_gap = cpu["bfloat16"]["gap"], \
        cpu["bfloat16"]["cache_gap"]
    control = rel_err(serving.pop("control_logits"),
                      cpu["bfloat16"]["prefill"], floor=0.0)
    err_cache = max(bf["prefill_caches"] + bf["step_caches"])
    layers = lambda e: ", ".join(f"{x:.3g}" for x in e)  # noqa: E731
    runs = serving["runs"]
    print(f"phase 12: CPU port ({P_cpu} tokens; a process of "
          f"{CPU_JOB_THREADS} threads beside phases 12-14, "
          f"{cpu['seconds']:.1f} s: bfloat16 {bf['seconds']:.1f} s, "
          f"float32 {fl['seconds']:.1f} s; {waited:.1f} s waited for): card "
          f"against it, of the largest, bfloat16: prefill logits "
          f"{bf['prefill']:.3g}, serve steps {layers(bf['steps'])} "
          f"(tolerance {SERVE_CPU_TOL}); caches {err_cache:.3g} (tolerance "
          f"twice the CPU port's own prefill against decode path "
          f"{cpu_cache_gap:.3g}; prefill's by layer "
          f"{layers(bf['prefill_caches'])}); control without the LoRA term "
          f"{control:.3g} (must exceed {SERVE_CPU_TOL}); float32 weights: "
          f"prefill logits {fl['prefill']:.3g}, serve steps "
          f"{layers(fl['steps'])}, prefill caches "
          f"{max(fl['prefill_caches']):.3g}, decode caches "
          f"{max(fl['step_caches']):.3g} (tolerance {SERVE_F32_TOL}, a "
          f"float32 decode cache); prefill against the decode path "
          f"{runs[P_cpu]['gap']:.3g} on the card, {cpu_gap:.3g} on the CPU; "
          f"base draw {serving['init_s']:.2f} s (peak "
          f"{serving['draw_peak_gib']:.2f} GiB); peak memory after it "
          f"{serving['peak_gib']:.2f} GiB; phase {serving['wall_s']:.1f} s")
    for P, r in runs.items():
        check(r["gap"] <= 2 * cpu_gap,
              f"prefill {P} against the decode path: {r['gap']} on the "
              f"card, over twice the CPU port's {cpu_gap} at {P_cpu} tokens")
    for what, err, tol in (
            [("bfloat16 prefill logits", bf["prefill"], SERVE_CPU_TOL),
             ("bfloat16 caches", err_cache, 2 * cpu_cache_gap),
             ("float32 prefill logits", fl["prefill"], SERVE_F32_TOL),
             ("float32 prefill caches", max(fl["prefill_caches"]),
              SERVE_F32_TOL),
             ("float32 decode caches", max(fl["step_caches"]),
              SERVE_F32_TOL)]
            + [(f"bfloat16 serve step {s}", e, SERVE_CPU_TOL)
               for s, e in enumerate(bf["steps"])]
            + [(f"float32 serve step {s}", e, SERVE_F32_TOL)
               for s, e in enumerate(fl["steps"])]):
        check(err <= tol, f"{what} after a {P_cpu}-token prompt: the card "
              f"against the CPU port {err} of the largest, over {tol}")
    check(control > SERVE_CPU_TOL,
          f"the control (card prefill without the LoRA term) is within "
          f"{SERVE_CPU_TOL} of the CPU port with it ({control}): the bound "
          "cannot see a lost adapter term")
    return dict(serving, cpu_s=cpu["seconds"], bf16_s=bf["seconds"],
                bf16=bf, float32=fl, control=control, cpu_gap=cpu_gap,
                cpu_cache_gap=cpu_cache_gap)


def serve_timed(cfg, model, prompts, steps: int, key, weight_bytes: int,
                frontend=None) -> dict:
    """One warm ``make_prefill_step`` on ``prompts`` ``(B, P)`` (behind
    the stub ``frontend`` ``(B, F, d)`` when given) timed, then ``steps``
    serve steps sampled at ``SERVE_TEMPERATURE`` timed, each with its
    launches counted, from prefill's caches (an mLSTM model's from the
    decode path's over the prompt: its prefill cache cannot seed the
    serve step), at the positions after the cache's rows; the serve
    step's byte bound is ``weight_bytes`` and the cache read once, and
    the recurrent states written once, over 3.35 TB/s."""
    import torch
    from repro_torch import random as jr
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    prefill, serve = M.make_prefill_step(cfg), M.make_serve_step(cfg)
    B, P = prompts.shape
    batch = {"tokens": prompts}
    if frontend is not None:
        batch["frontend"] = frontend
    prefill(*model, batch)                                      # warm
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(*model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_prefill = read_counters()
    if seeds_serve(cfg):
        cache = decode_cache(cfg, caches, steps, "cuda")
    else:           # the cache the decode path fills over the prompt
        cache = decode_path(cfg, model, prompts, "cuda", slots=P + steps)[1]
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(cache))
    # a recurrent layer's state is read and written whole each step
    state_bytes = sum(t.numel() * t.element_size()
                      for mx, c in zip(mixers_of(cfg), cache)
                      if mx not in ("attn", "mla") for t in c)
    rows = patch_rows(cfg) + P
    tok = torch.argmax(logits, -1)[:, None]
    k = jr.fold_in(key, P)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(steps):
        k, sub = jr.split(k)
        step_logits, cache = serve(*model, cache, tok, rows + s)
        tok = jr.categorical(sub, step_logits / SERVE_TEMPERATURE)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return dict(
        prefill_s=prefill_s, decode_s=decode_s, step_s=decode_s / steps,
        tokens_per_s=B * steps / decode_s, cache_bytes=cache_bytes,
        state_bytes=state_bytes,
        bound_step_ms=(weight_bytes + cache_bytes + state_bytes)
        / HBM_BYTES_PER_S * 1e3,
        finite=bool(torch.isfinite(logits).all()
                    and torch.isfinite(step_logits).all()),
        launches_prefill=n_prefill, launches_steps=read_counters(),
        logits=logits, caches=caches)


# ---------------------------------------------------------------------------
# phases 13 and 14: the mixture-of-experts and latent-attention families
# ---------------------------------------------------------------------------
KIMI, MINICPM, STABLELM = "kimi-k2-1t-a32b", "minicpm3-4b", "stablelm-3b"
# phase 14's depth in the whole smoke run, cut from 62 layers to keep the
# run inside its time limit once phases 17-18 came (about 0.8 s a layer:
# its draw, serve steps and the float32 decode path); ``--families`` runs
# all 62
MINICPM_SMOKE_LAYERS = 8
# phase 14's CPU half: minicpm3-4b's first layers at this depth, on the
# card's weights
FAMILY_CPU_DEPTH = 2
# phase 13's per-token reference of the MoE block: at least this many
# tokens of the 512-token prefill (those with a dropped choice first)
MOE_REF_TOKENS = 64
# the block's update (routed experts and the shared expert, bfloat16)
# against that float32 reference, of the reference's largest magnitude.
# Each element of the update is rounded to bfloat16 about ten times on
# its way (each expert's two products, SwiGLU's two ops, the gate
# product, the sum over the top 8, the shared expert's three, the final
# add), each by at most 2**-9 of itself; 2e-2 is the bfloat16 bound the
# smoke holds every kernel to against its plain version.
MOE_REF_TOL = 2e-2
# phase 13's prefill against the decode path: requests of 32 tokens, and
# how many of them must route their last token alike in both (a token
# whose k-th and (k+1)-th router logits lie within the two paths'
# bfloat16 noise of each other may take another expert in each: such a
# flip is reported with its margin and that noise, and not held)
DECODE_CHECK_B, DECODE_CHECK_HELD = 16, 8


# the projections a layer takes through ``common.dense`` with its LoRA
# pair, by mixer and feed-forward block: one ``lora_matmul`` launch each
# that the config's ``lora.targets`` name (the MoE block's 3-D experts
# take none)
ADAPTABLE = {"attn": ("wq", "wkv", "wo"),
             "mla": ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"),
             "mamba": ("in_proj", "out_proj"),
             "mlstm": ("up_proj", "wq", "wk", "wv", "down_proj"),
             "slstm": ("w_gates",), "mlp": ("w_in", "w_out"),
             "moe": ("shared_w_in", "shared_w_out"), "none": ()}


def adapted_launches(cfg, decode: bool) -> int:
    """``lora_matmul`` launches of one pass: every adapted projection a
    layer (``ADAPTABLE`` named in ``cfg.lora.targets``: GQA's wq, wkv,
    wo; MLA's five; the MLP's w_in, w_out; in xlstm-125m the mLSTM's wq
    alone), but MLA's ``wkv_b`` in decode, whose absorbed form reads its
    base weight."""
    n = 0
    for i in range(cfg.n_layers):
        mixer, ffn = cfg.pattern[i % len(cfg.pattern)]
        names = set(ADAPTABLE[mixer] + ADAPTABLE[ffn]) & set(cfg.lora.targets)
        if decode and mixer == "mla":
            names.discard("wkv_b")
        n += len(names)
    return n


def family_launches(cfg) -> dict:
    n_attn = sum(mx in ("attn", "mla") for mx in mixers_of(cfg))
    return {"prefill": {"lora_matmul": adapted_launches(cfg, False),
                        "flash_attention": n_attn},
            "serve_step": {"lora_matmul": adapted_launches(cfg, True),
                           "flash_attention": 0}}


def serve_prompts(cfg):
    """The serving phases' 4 prompts of 512 tokens of ``cfg``'s vocabulary,
    drawn from ``PRNGKey(0)``, on the card."""
    import torch
    from repro_torch import random as jr
    return torch.from_numpy(jr.randint(
        jr.PRNGKey(0), (SERVE_B, max(SERVE_PROMPTS)), 4,
        cfg.vocab_size - 4)).long().cuda()


def draw_family(cfg) -> tuple:
    """The base of ``cfg`` as ``init_params`` draws it on the card (its
    config's bfloat16, each leaf a slice at a time) and its adapters with
    ``lora_b`` + 0.01: ((params, adapters), draw seconds, the draw's peak
    GiB above what the card held before it, the model's bytes)."""
    import torch
    from repro_torch import random as jr
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    key = jr.PRNGKey(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, key)
    adapters = bump_lora_b(M.init_adapters(cfg, key, params))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = (params, adapters)
    return (model, init_s,
            (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
            sum(t.numel() * t.element_size() for t in tree_leaves(model)))


def bump_lora_b(adapters):
    """An adapter set (a list of layer dicts, or an encoder-decoder's
    ``{"layers", "enc_layers"}``) with every ``lora_b`` + 0.01."""
    if isinstance(adapters, dict):
        return {k: bump_lora_b(v) for k, v in adapters.items()}
    return [{k: v + 0.01 if "lora_b" in k else v for k, v in a.items()}
            for a in adapters]


@contextlib.contextmanager
def moe_spy():
    """Every MoE block called inside, recorded: a list that receives, a
    call each, its input ``x``, its parameters, its update ``y``, and
    each client's router logits and ``Routing``."""
    from repro_torch.models import ffn
    calls, update0, route0 = [], ffn.moe_update, ffn.route

    def route(logits, m):
        r = route0(logits, m)
        calls[-1]["logits"].append(logits)
        calls[-1]["routing"].append(r)
        return r

    def update(params, cfg, x):
        calls.append(dict(x=x, params=params, logits=[], routing=[]))
        calls[-1]["y"], balance = update0(params, cfg, x)
        return calls[-1]["y"], balance
    ffn.moe_update, ffn.route = update, route
    try:
        yield calls
    finally:
        ffn.moe_update, ffn.route = update0, route0


def logit_margins(r, k: int):
    """Each token's smallest gap between neighbouring router logits
    (log-probabilities) among its first k choices and the next: how near
    its routing is to a tie."""
    import torch
    top = torch.sort(r.probs, dim=-1, descending=True).values[:, :k + 1]
    lg = torch.log(top)
    return (lg[:, :-1] - lg[:, 1:]).min(dim=-1).values


def host_recount(logits, experts, m) -> dict:
    """The routing recounted on the host from read-back float32 router
    logits ``(T, E)``: each token's top-k experts (a stable descending
    sort of the logits, which order as the probabilities do), and from
    the card's choices ``experts`` ``(T, k)`` each choice's rank in its
    expert by a running count (the one-hot cumsum, not the card's sort),
    the capacity, the kept set and the per-expert counts."""
    import numpy as np
    T, E = logits.shape
    ids = np.argsort(-logits, axis=1, kind="stable")[:, :m.top_k]
    flat = experts.reshape(-1)
    pos, seen = np.empty_like(flat), np.zeros(E, np.int64)
    for i, e in enumerate(flat):
        pos[i] = seen[e]
        seen[e] += 1
    cap = max(8, -(-math.ceil(m.top_k * T * m.capacity_factor
                              / m.n_experts) // 8) * 8)
    return dict(ids=ids, pos=pos, keep=pos < cap, counts=seen, capacity=cap)


def check_routing(call, m, what: str) -> dict:
    """The card's routing integers of one MoE call against
    ``host_recount``: the top-k experts equal (a token may differ only
    where the card's float32 probabilities tie exactly), each choice's
    rank, the kept set, the capacity and the per-expert counts equal."""
    import numpy as np
    r = call["routing"][0]
    logits = call["logits"][0].float().cpu().numpy()
    experts = r.experts.cpu().numpy()
    host = host_recount(logits, experts, m)
    probs = r.probs.float().cpu().numpy()
    diff = np.nonzero((host["ids"] != experts).any(axis=1))[0]
    for t in diff:          # a tie: the same probabilities, other indices
        check(np.array_equal(np.sort(probs[t, host["ids"][t]]),
                             np.sort(probs[t, experts[t]])),
              f"{what}: token {t} takes experts {experts[t].tolist()} on "
              f"the card, {host['ids'][t].tolist()} on the host")
    check(r.capacity == host["capacity"], f"{what}: capacity {r.capacity} "
          f"against the host's {host['capacity']}")
    check(np.array_equal(r.pos.cpu().numpy(), host["pos"]),
          f"{what}: the ranks in the experts differ from the host's count")
    keep = r.keep.cpu().numpy()
    check(np.array_equal(keep, host["keep"]), f"{what}: the kept set "
          "differs from the host's")
    counts = np.bincount(experts.reshape(-1), minlength=m.n_experts)
    check(np.array_equal(counts, host["counts"]), f"{what}: counts")
    return dict(ties=len(diff), capacity=r.capacity,
                dropped=int((~keep).sum()), kept=int(keep.sum()),
                max_count=int(counts.max()),
                over_capacity=int((counts > r.capacity).sum()))


def moe_reference(call, cfg, n_tokens: int) -> dict:
    """The MoE block's update for a sample of tokens from its weights in
    float32 on the card, token by token, sharing no code with its
    dispatch: the sum over each token's kept experts of its gate times
    the expert's SwiGLU (``silu(x W_in[:, :ff]) * (x W_in[:, ff:]) W_out``),
    plus the shared expert, from the block's normed tokens.  The sample:
    the tokens with a dropped choice (up to half), then tokens evenly
    spaced.  Returns the error against the block's update, of the
    reference's largest magnitude, and the sample."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.common import rms_norm
    m, p, r = cfg.moe, call["params"], call["routing"][0]
    x, y = call["x"], call["y"]
    d = x.shape[-1]
    xn = rms_norm(x, p["ln2"], cfg.norm_eps).reshape(-1, d)
    T, k = xn.shape[0], m.top_k
    keep = r.keep.view(T, k)
    dropped = torch.nonzero(~keep.all(dim=1))[:, 0].tolist()
    sample = sorted(set(dropped[:n_tokens // 2])
                    | set(range(0, T, max(1, T // n_tokens))))

    def swiglu_f32(v, w_in, w_out):
        h = v @ w_in.float()
        ff = h.shape[-1] // 2
        return (F.silu(h[..., :ff]) * h[..., ff:]) @ w_out.float()
    ref, got = [], []
    for t in sample:
        v = xn[t].float()
        out = torch.zeros(d, device=x.device)
        for j in range(k):
            if keep[t, j]:
                e = int(r.experts[t, j])
                out += r.gates[t, j] * swiglu_f32(v, p["w_in"][e],
                                                  p["w_out"][e])
        if m.n_shared_experts:
            out += swiglu_f32(v, p["shared_w_in"], p["shared_w_out"])
        ref.append(out)
        got.append(y.reshape(-1, d)[t].float())
    ref, got = torch.stack(ref), torch.stack(got)
    return dict(err=float((got - ref).abs().max() / ref.abs().max()),
                tokens=len(sample), with_drops=len(set(dropped) & set(sample)))


def kimi_cfg():
    """Phase 13's config: kimi-k2-1t-a32b cut to one ``("attn", "moe")``
    group."""
    import dataclasses
    from repro_torch.configs.registry import get
    full = get(KIMI)
    return dataclasses.replace(full, n_layers=len(full.pattern))


def kimi_start() -> dict:
    """Phase 13's config (``kimi_cfg``), its base drawn on the card
    (``draw_family``) and its prompts (``serve_prompts``): its phase has
    no CPU half."""
    cfg = kimi_cfg()
    return dict(cfg=cfg, model=draw_family(cfg)[0],
                prompts=serve_prompts(cfg))


def kimi_phase(gen) -> dict:
    """Phase 13: ``kimi-k2-1t-a32b`` at its published widths (d_model
    7168, 64/8 heads of 112, 384 experts top-8 of d_ff 2048 and one
    shared expert, vocab 163840, untied), its depth cut from 61 layers to
    one ``("attn", "moe")`` group; the bfloat16 base as ``init_params``
    draws it; 4 requests, prompts of 32 and 512 tokens, then 16 serve
    steps at temperature 0.8, timed.  Checks: the launches; the 512-token
    prefill's routing integers against a host recount from the read-back
    router logits; the MoE block's update against a per-token float32
    reference; prefill against the decode path on ``DECODE_CHECK_B``
    prompts of 32 tokens, both with a capacity that drops no choice
    (``capacity_factor = E / k``: the serve step of 4 requests never
    drops, but prefill does, and a dropped choice is a different
    function, not an error): every layer's cache within 2e-2 of its
    largest, and the last logits within ``SERVE_CPU_TOL`` of the largest
    for the rows whose last token took the same experts in both paths
    (at least ``DECODE_CHECK_HELD``); a row whose last token took others
    must have routed within twice the two paths' router-logit gap of a
    tie, and is reported; ``flash_attention`` at head dim 112 and
    ``lora_matmul`` at kimi's projections against their plain versions.
    The card's model is freed at the end."""
    import dataclasses
    import torch
    from repro_torch import random as jr
    from repro_torch.configs.registry import get
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    full = get(KIMI)
    cfg = kimi_cfg()
    m = cfg.moe
    print(f"phase 13: {KIMI} at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, {m.n_experts} experts top-{m.top_k} of d_ff "
          f"{m.d_ff} and {m.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}); depth cut from {full.n_layers} layers to "
          f"{cfg.n_layers} (one {cfg.pattern[0]} group)")
    from repro_torch.kernels import trunc_normal as tn
    drawn = tn.trunc_normal.launches
    model, init_s, draw_peak, weight_bytes = draw_family(cfg)
    drawn = tn.trunc_normal.launches - drawn
    check(drawn > 0, f"{KIMI}: the base was not drawn by trunc_normal")
    B, steps, key = SERVE_B, SERVE_STEPS, jr.PRNGKey(0)
    prompts = serve_prompts(cfg)
    torch.cuda.reset_peak_memory_stats()
    runs = {P: serve_timed(cfg, model, prompts[:, :P], steps, key,
                           weight_bytes) for P in SERVE_PROMPTS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for P, r in runs.items():
        print(f"phase 13 ({KIMI}, bf16, B={B}, prompt {P}): prefill "
              f"{r['prefill_s'] * 1e3:.2f} ms; {steps} serve steps "
              f"{r['decode_s']:.4f} s, {r['step_s'] * 1e3:.3f} ms a step "
              f"(byte bound {r['bound_step_ms']:.3f} ms: "
              f"{weight_bytes / 1e9:.3f} GB of weights, every expert's "
              f"read each step, and {r['cache_bytes'] / 1e6:.1f} MB of "
              f"cache at 3.35 TB/s), {r['tokens_per_s']:.1f} tokens/s; "
              f"launches: prefill {json.dumps(r['launches_prefill'])}, "
              f"serve steps {json.dumps(r['launches_steps'])}")

    prefill = M.make_prefill_step(cfg)
    with torch.no_grad(), moe_spy() as calls:
        prefill(*model, {"tokens": prompts})
    routing = check_routing(calls[0], m, "prefill 512")
    ref = moe_reference(calls[0], cfg, MOE_REF_TOKENS)
    del calls
    P, nb = min(SERVE_PROMPTS), DECODE_CHECK_B
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    check_prompts = torch.from_numpy(jr.randint(
        jr.fold_in(key, 13), (nb, P), 4, cfg.vocab_size - 4)).long().cuda()
    with torch.no_grad(), moe_spy() as calls:
        logits, caches = M.make_prefill_step(nodrop)(
            *model, {"tokens": check_prompts})
    r32 = calls[0]["routing"][0]
    last = torch.arange(nb, device="cuda") * P + P - 1
    lost = int((~r32.keep).sum())
    margin = logit_margins(r32, m.top_k)[last].tolist()
    chose, lg = r32.experts[last], calls[0]["logits"][0][last]
    del calls
    with torch.no_grad(), moe_spy() as calls:
        dec, dec_cache = decode_path(nodrop, model, check_prompts, "cuda")
    same = (torch.sort(chose, dim=1).values == torch.sort(
        calls[-1]["routing"][0].experts, dim=1).values).all(dim=1).tolist()
    noise = (calls[-1]["logits"][0] - lg).abs().max(dim=1).values.tolist()
    del calls
    row_err = ((dec - logits).abs().max(dim=-1).values
               / logits.abs().max()).tolist()
    cache_err = max(cache_errs(dec_cache, caches))
    held = [b for b in range(nb) if same[b]]
    flips = [(b, margin[b], noise[b]) for b in range(nb) if not same[b]]
    times = kernel_times(
        gen, [(f"kimi-{n}-M{M_}", M_, K, N, cfg.lora.rank)
              for n, (K, N) in (("wq", (cfg.d_model, cfg.n_heads
                                       * cfg.head_dim)),
                                ("wkv", (cfg.d_model, 2 * cfg.n_kv_heads
                                         * cfg.head_dim)),
                                ("wo", (cfg.n_heads * cfg.head_dim,
                                        cfg.d_model)))
              for M_ in (B, B * max(SERVE_PROMPTS))],
        [(f"kimi-prefill-{S}", B, S, cfg.n_heads, cfg.n_kv_heads,
          cfg.head_dim, cfg.head_dim) for S in SERVE_PROMPTS])
    wall = time.perf_counter() - t_phase
    print(f"phase 13: routing at the 512-token prefill (T={B * 512}) equal "
          f"to the host's recount: capacity {routing['capacity']}, "
          f"{routing['kept']} choices kept, {routing['dropped']} dropped, "
          f"{routing['over_capacity']} experts over capacity (largest "
          f"count {routing['max_count']}), {routing['ties']} exact ties; "
          f"MoE block against the float32 per-token reference on "
          f"{ref['tokens']} tokens ({ref['with_drops']} with a dropped "
          f"choice): {ref['err']:.3g} of the largest (tolerance "
          f"{MOE_REF_TOL}); prefill against the decode path ({nb} prompts "
          f"of {P} tokens, a capacity that drops none: {lost} dropped), "
          f"caches {cache_err:.3g} (tolerance 2e-2), last logits by row "
          f"{', '.join(f'{e:.3g}' for e in row_err)} (tolerance "
          f"{SERVE_CPU_TOL} on the {len(held)} rows routed alike; flips "
          f"(row, logit margin, the paths' router-logit gap): "
          f"{', '.join(f'({b}, {x:.3g}, {y:.3g})' for b, x, y in flips)}; "
          f"the last tokens' logit margins "
          f"{', '.join(f'{x:.3g}' for x in margin)}); base draw {init_s:.2f} s ({weight_bytes / 1e9:.2f} GB, draw "
          f"peak {draw_peak:.2f} GiB); peak memory after it {peak:.2f} GiB;"
          f" phase {wall:.1f} s")
    want = family_launches(cfg)
    for P_, r in runs.items():
        check_serving_launches(r["launches_prefill"], want["prefill"],
                               f"{KIMI} prefill {P_}")
        check_serving_launches(r["launches_steps"], {
            n: steps * c for n, c in want["serve_step"].items()},
            f"{KIMI} {steps} serve steps after a {P_}-token prefill")
        check(r["finite"] and r["logits"].shape == (B, cfg.vocab_size),
              f"{KIMI} prefill {P_} or its serve steps: logits not finite")
    check(ref["err"] <= MOE_REF_TOL, f"{KIMI} MoE block against the "
          f"per-token reference: {ref['err']} > {MOE_REF_TOL}")
    check(lost == 0, f"{KIMI}: {lost} choices dropped at a capacity of "
          f"{r32.capacity}")
    check(cache_err <= 2e-2, f"{KIMI} prefill against the decode path: "
          f"caches {cache_err} > 2e-2")
    check(len(held) >= DECODE_CHECK_HELD, f"{KIMI}: only rows {held} of "
          f"{nb} routed their last token alike in prefill and decode")
    for b, x, y in flips:
        check(x <= 2 * y, f"{KIMI} row {b}: its last token took other "
              f"experts in prefill and decode at a logit margin of {x}, "
              f"over twice the paths' router-logit gap {y}")
    for b in held:
        check(row_err[b] <= SERVE_CPU_TOL, f"{KIMI} prefill against the "
              f"decode path, row {b}: {row_err[b]} > {SERVE_CPU_TOL}")
    del dec, logits, caches, dec_cache
    training = train_family(KIMI, cfg, model, prompts)
    check_training(KIMI, cfg, training)
    del model, prompts
    return dict(wall_s=wall, init_s=init_s, draw_launches=drawn,
                draw_peak_gib=draw_peak, training=training,
                peak_gib=peak, weight_bytes=weight_bytes, routing=routing,
                moe_ref=ref, decode_gap_rows=row_err, held_rows=held,
                flips=flips, decode_cache_gap=cache_err,
                kernel_times=times,
                runs={P_: {k: v for k, v in r.items()
                           if k not in ("logits", "caches")}
                      for P_, r in runs.items()})


class HostTensor:
    """A tensor as a numpy array on the host (bfloat16 as its bits), so a
    spawned process gets it by value through its pipe: torch would share
    a tensor through /dev/shm, whose size the smoke does not know."""

    def __init__(self, t):
        import torch
        t = t.detach().cpu().contiguous()
        self.bf16 = t.dtype == torch.bfloat16
        self.array = (t.view(torch.int16) if self.bf16 else t).numpy()

    def tensor(self):
        import torch
        t = torch.from_numpy(self.array)
        return t.view(torch.bfloat16) if self.bf16 else t


def host_tree(tree, to_host: bool = True):
    """Every tensor of a tree (dicts, lists, tuples) as a ``HostTensor``,
    or back with ``to_host=False``."""
    import torch
    if isinstance(tree, dict):
        return {k: host_tree(v, to_host) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v, to_host) for v in tree)
    if to_host and torch.is_tensor(tree):
        return HostTensor(tree)
    if not to_host and isinstance(tree, HostTensor):
        return tree.tensor()
    return tree


def family_half_cpu(cfg, model, prompts, fed, threads: int,
                    decode: bool = True, labels=None) -> dict:
    """``family_half`` in a spawned process, on host trees both ways."""
    return host_tree(family_half(cfg, *host_tree((model, prompts, fed),
                                                 False), threads, decode,
                                 host_tree(labels, False)))


def next_tokens(prompts, fed):
    """The labels of ``prompts`` ``(B, P)``: each position's next token,
    the last one the first token fed after the prompt."""
    import torch
    return torch.cat([prompts[:, 1:], fed[:, :1]], dim=1)


def family_half(cfg, model, prompts, fed, threads: int = 0,
                decode: bool = True, labels=None) -> dict:
    """Prefill on ``prompts`` and ``fed.shape[1]`` serve steps fed ``fed``
    from prefill's cache, and (``decode``) the decode path on the
    prompts, in bfloat16 and on the same weights in float32 (a float32
    decode cache): logits and caches on the CPU, and the gaps of the
    decode path's last logits and caches to prefill's (None without
    it), and the cache the serve steps started from.  A model whose
    prefill cache cannot seed the serve step (an mLSTM one, with no
    attention layer) steps on from the decode path's cache.  With
    ``labels``, phase 19's ``train_half`` on the prompts.  Runs on the model's device; phases
    12 and 14-16 run it on the card and, in a process of its own, on the
    CPU."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    if threads:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    dev = prompts.device
    prefill, serve = M.make_prefill_step(cfg), M.make_serve_step(cfg)
    cpu = lambda t: t.float().cpu()  # noqa: E731
    out = {}
    with torch.no_grad():
        for label, m, dt in (("bfloat16", model, torch.bfloat16),
                             ("float32", tree_map(lambda t: t.float(),
                                                  model), torch.float32)):
            t1 = time.perf_counter()
            logits, caches = prefill(*m, {"tokens": prompts})
            dec = dec_cache = None
            if decode or not seeds_serve(cfg):
                dec, dec_cache = decode_path(cfg, m, prompts, dev, dtype=dt)
            if seeds_serve(cfg):
                cache = decode_cache(cfg, caches, fed.shape[1], dev)
            else:
                check(not {"attn", "mla"} & set(mixers_of(cfg)),
                      "a decode path's cache has no slots to step on")
                cache = tree_map(lambda t: t.clone(), dec_cache)
            start = tree_map(lambda t: cpu(t).clone(), cache)
            steps = []
            for s in range(fed.shape[1]):
                lg, cache = serve(*m, cache, fed[:, s:s + 1],
                                  prompts.shape[1] + s)
                steps.append(cpu(lg))
            gaps = None if dec is None else state_errs(dec_cache, caches,
                                                       mixers_of(cfg))
            out[label] = dict(
                prefill=cpu(logits), caches=tree_map(cpu, caches),
                steps=steps, step_caches=tree_map(cpu, cache),
                start_cache=start,
                gap=None if dec is None else float(
                    (dec - logits).abs().max()),
                rel_gap=None if dec is None else rel_err(dec, logits,
                                                         floor=0.0),
                cache_gaps=gaps,
                cache_gap=None if gaps is None else max(gaps),
                seconds=time.perf_counter() - t1)
            if labels is not None:
                out.update(train_half(cfg, m, prompts, labels, dt))
    out["seconds"] = time.perf_counter() - t0
    out["prompt_len"] = prompts.shape[1]
    return out


def minicpm_cfg(n_layers: int = MINICPM_SMOKE_LAYERS):
    """Phase 14's config: minicpm3-4b's first ``n_layers`` layers
    (``MINICPM_SMOKE_LAYERS`` in the whole run)."""
    import dataclasses
    from repro_torch.configs.registry import get
    return dataclasses.replace(get(MINICPM), n_layers=n_layers)


def minicpm_start(cfg) -> dict:
    """Phase 14's model: ``cfg``'s base drawn on the card
    (``draw_family``), its prompts (``serve_prompts``), and its CPU half
    (``family_half`` with phase 19's labels, on host copies of the first
    ``FAMILY_CPU_DEPTH`` layers, prefill at 32 tokens and the 2 tokens
    fed after them) started in a process of its own; ``half`` is the CPU
    half's ``(config, model, tokens, labels, frontend)``."""
    import dataclasses
    model, init_s, draw_peak, weight_bytes = draw_family(cfg)
    prompts = serve_prompts(cfg)
    P = min(SERVE_PROMPTS)
    shallow_cfg = dataclasses.replace(cfg, n_layers=FAMILY_CPU_DEPTH)
    params, adapters = model
    shallow = (dict(params, layers=params["layers"][:FAMILY_CPU_DEPTH]),
               adapters[:FAMILY_CPU_DEPTH])
    fed = prompts[:, P:P + 2]
    labels = next_tokens(prompts[:, :P], fed)
    job = CpuJob(f"{MINICPM} at depth {FAMILY_CPU_DEPTH} (cpu, plain)",
                 family_half_cpu, shallow_cfg, *host_tree(
                     (shallow, prompts[:, :P], fed)), CPU_JOB_THREADS, True,
                 host_tree(labels))
    return dict(cfg=cfg, model=model, prompts=prompts, fed=fed, job=job,
                half=(shallow_cfg, shallow, prompts[:, :P], labels, None),
                init_s=init_s, draw_peak=draw_peak,
                weight_bytes=weight_bytes)


def minicpm_phase(gen, n_layers: int = None, idle=None) -> dict:
    """Phase 14: ``minicpm3-4b`` at its published widths (d_model 2560,
    40 heads, MLA q rank 768, kv rank 256, nope 64, rope 32, v 64, d_ff
    6400, vocab 73448) and all 62 layers, or the first ``n_layers`` (the
    smoke run's ``MINICPM_SMOKE_LAYERS``), the bfloat16 base as
    ``init_params`` draws it; 4 requests, prompts of 32 and 512 tokens,
    16 serve steps, timed.  Checks: the launches; prefill and 2 serve
    steps (fed the prompt's next tokens) of the first ``FAMILY_CPU_DEPTH``
    layers on the card's weights, against the CPU port run on the same in
    a process of its own beside the card's work (bfloat16: logits within
    ``SERVE_CPU_TOL``, caches 2e-2; float32 with a float32 decode cache:
    ``SERVE_F32_TOL``), and prefill against the decode path there within
    twice the CPU port's own gap; the full model in float32 with
    ``wkv_b``'s adapter zeroed (the absorbed decode reads ``wkv_b``'s base
    weight alone), prefill against the decode path within
    ``SERVE_F32_TOL``; ``flash_attention`` at (96, 64) and
    ``lora_matmul`` at MLA's five projections against their plain
    versions.  ``idle``, when given, is called once the card's work is
    done and before the CPU half is collected (later phases' draws fill
    the wait).  The card's model is freed at the end."""
    import torch
    from repro_torch import random as jr
    from repro_torch.configs.registry import get
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    full = get(MINICPM)
    cfg = minicpm_cfg(n_layers or full.n_layers)
    ml = cfg.mla
    print(f"phase 14: {MINICPM} at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, MLA q rank {ml.q_lora_rank},"
          f" kv rank {ml.kv_lora_rank}, nope {ml.qk_nope_head_dim}, rope "
          f"{ml.qk_rope_head_dim}, v {ml.v_head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}), {cfg.n_layers} of its {full.n_layers} "
          "layers")
    st = minicpm_start(cfg)
    model, prompts, job = st["model"], st["prompts"], st["job"]
    init_s, draw_peak, weight_bytes = (st[k] for k in (
        "init_s", "draw_peak", "weight_bytes"))
    shallow_cfg, shallow, _, labels, _ = st["half"]
    fed, (params, adapters) = st["fed"], model
    del st
    B, steps, key = SERVE_B, SERVE_STEPS, jr.PRNGKey(0)
    P = min(SERVE_PROMPTS)
    torch.cuda.reset_peak_memory_stats()
    runs = {P_: serve_timed(cfg, model, prompts[:, :P_], steps, key,
                            weight_bytes) for P_ in SERVE_PROMPTS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for P_, r in runs.items():
        print(f"phase 14 ({MINICPM}, bf16, B={B}, prompt {P_}): prefill "
              f"{r['prefill_s'] * 1e3:.2f} ms; {steps} serve steps "
              f"{r['decode_s']:.4f} s, {r['step_s'] * 1e3:.3f} ms a step "
              f"(byte bound {r['bound_step_ms']:.3f} ms: "
              f"{weight_bytes / 1e9:.3f} GB of weights and "
              f"{r['cache_bytes'] / 1e6:.1f} MB of compressed cache at 3.35 "
              f"TB/s), {r['tokens_per_s']:.1f} tokens/s; launches: prefill "
              f"{json.dumps(r['launches_prefill'])}, serve steps "
              f"{json.dumps(r['launches_steps'])}")
    times = kernel_times(
        gen, [(f"minicpm-{n}-M{M_}", M_, K, N, cfg.lora.rank)
              for n, (K, N) in (
                  ("wq_a", (cfg.d_model, ml.q_lora_rank)),
                  ("wq_b", (ml.q_lora_rank, cfg.n_heads * (
                      ml.qk_nope_head_dim + ml.qk_rope_head_dim))),
                  ("wkv_a", (cfg.d_model,
                             ml.kv_lora_rank + ml.qk_rope_head_dim)),
                  ("wkv_b", (ml.kv_lora_rank, cfg.n_heads * (
                      ml.qk_nope_head_dim + ml.v_head_dim))),
                  ("wo", (cfg.n_heads * ml.v_head_dim, cfg.d_model)))
              for M_ in (B, B * max(SERVE_PROMPTS))],
        [(f"minicpm-prefill-{S}", B, S, cfg.n_heads, cfg.n_heads,
          ml.qk_nope_head_dim + ml.qk_rope_head_dim, ml.v_head_dim)
         for S in SERVE_PROMPTS])
    # the whole model in float32, wkv_b's adapter zeroed: prefill and the
    # absorbed decode compute one function
    f32 = (tree_map(lambda t: t.float(), params),
           [{k: torch.zeros_like(v) if k == "wkv_b_lora_b" else v
             for k, v in a.items()} for a in adapters])
    with torch.no_grad():
        f32_logits = M.make_prefill_step(cfg)(
            *f32, {"tokens": prompts[:, :P]})[0]
        f32_dec = decode_path(cfg, f32, prompts[:, :P], "cuda",
                              dtype=torch.float32)[0]
    f32_gap = rel_err(f32_dec, f32_logits, floor=0.0)
    del f32, f32_dec
    card = family_half(shallow_cfg, shallow, prompts[:, :P], fed,
                       labels=labels)
    training = train_family(MINICPM, cfg, model, prompts)
    idle_s = 0.0
    if idle is not None:
        t0 = time.perf_counter()
        idle()
        idle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = host_tree(job.result(), False)
    waited = time.perf_counter() - t0
    errs = {}
    for label, tol, ctol in (("bfloat16", SERVE_CPU_TOL, 2e-2),
                             ("float32", SERVE_F32_TOL, SERVE_F32_TOL)):
        g, w = card[label], cpu[label]
        errs[label] = dict(
            prefill=rel_err(g["prefill"], w["prefill"], floor=0.0),
            steps=[rel_err(a, b, floor=0.0)
                   for a, b in zip(g["steps"], w["steps"])],
            caches=max(cache_errs(g["caches"], w["caches"])
                       + cache_errs(g["step_caches"], w["step_caches"])),
            gap=g["gap"], cpu_gap=w["gap"], tol=tol, cache_tol=ctol)
    wall = time.perf_counter() - t_phase - idle_s
    training["cpu_compare"] = train_half_compare(card, cpu)
    print(training_text(training["cpu_compare"], cfg))
    e16, e32 = errs["bfloat16"], errs["float32"]
    print(f"phase 14: depth {FAMILY_CPU_DEPTH} on the card's weights, card "
          f"against the CPU port (a process of {CPU_JOB_THREADS} threads, "
          f"{cpu['seconds']:.1f} s, {waited:.1f} s of it waited for), of "
          f"the largest: bfloat16 prefill logits {e16['prefill']:.3g}, 2 "
          f"serve steps {', '.join(f'{x:.3g}' for x in e16['steps'])}, "
          f"caches {e16['caches']:.3g} (tolerances {SERVE_CPU_TOL}, 2e-2); "
          f"float32 {e32['prefill']:.3g}, "
          f"{', '.join(f'{x:.3g}' for x in e32['steps'])}, caches "
          f"{e32['caches']:.3g} (tolerance {SERVE_F32_TOL}); prefill "
          f"against the decode path {e16['gap']:.3g} on the card, "
          f"{e16['cpu_gap']:.3g} on the CPU (bfloat16; it holds wkv_b's "
          f"adapter, which decode does not read); the {cfg.n_layers} layers"
          f" in float32, wkv_b's adapter zeroed: prefill against the decode"
          f" path {f32_gap:.3g} of the largest (tolerance {SERVE_F32_TOL});"
          f" base draw {init_s:.2f} s ({weight_bytes / 1e9:.2f} GB, draw "
          f"peak {draw_peak:.2f} GiB); peak memory after it {peak:.2f} GiB;"
          f" phase {wall:.1f} s")
    want = family_launches(cfg)
    for P_, r in runs.items():
        check_serving_launches(r["launches_prefill"], want["prefill"],
                               f"{MINICPM} prefill {P_}")
        check_serving_launches(r["launches_steps"], {
            n: steps * c for n, c in want["serve_step"].items()},
            f"{MINICPM} {steps} serve steps after a {P_}-token prefill")
        check(r["finite"] and r["logits"].shape == (B, cfg.vocab_size),
              f"{MINICPM} prefill {P_} or its serve steps: logits not "
              "finite")
    for label, e in errs.items():
        for what, err, tol in ([("prefill logits", e["prefill"], e["tol"]),
                                ("caches", e["caches"], e["cache_tol"])]
                               + [(f"serve step {s}", x, e["tol"])
                                  for s, x in enumerate(e["steps"])]):
            check(err <= tol, f"{MINICPM} depth {FAMILY_CPU_DEPTH} {label} "
                  f"{what}: card against the CPU port {err} > {tol}")
        check(e["gap"] <= 2 * e["cpu_gap"], f"{MINICPM} {label} prefill "
              f"against the decode path: {e['gap']} on the card, over twice "
              f"the CPU port's {e['cpu_gap']}")
    check(f32_gap <= SERVE_F32_TOL, f"{MINICPM} float32 prefill against "
          f"the decode path: {f32_gap} > {SERVE_F32_TOL}")
    check_training(MINICPM, cfg, training, training["cpu_compare"])
    del model, params, adapters, shallow, prompts
    return dict(wall_s=wall, init_s=init_s, draw_peak_gib=draw_peak,
                peak_gib=peak, weight_bytes=weight_bytes, cpu_s=cpu["seconds"],
                cpu_waited_s=waited, depth2=errs, float32_decode_gap=f32_gap,
                kernel_times=times, training=training,
                runs={P_: {k: v for k, v in r.items()
                           if k not in ("logits", "caches")}
                      for P_, r in runs.items()})


def stablelm_phase(gen) -> dict:
    """The repair of phase 14: ``stablelm-3b``'s prefill at its published
    widths (head dim 80; depth cut to 2 layers), 4 prompts of 512 tokens,
    through ``flash_attention`` (one launch a layer), against the same
    prefill with every attention taken by the plain version on the card:
    logits within ``SERVE_CPU_TOL`` of the largest, caches 2e-2 (both
    bfloat16); ``flash_attention`` at head dim 80 timed."""
    import dataclasses
    import torch
    from repro_torch import random as jr
    from repro_torch.configs.registry import get
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get(STABLELM), n_layers=2)
    model, init_s, _, _ = draw_family(cfg)
    S, B = max(SERVE_PROMPTS), SERVE_B
    prompts = torch.from_numpy(jr.randint(
        jr.PRNGKey(0), (B, S), 4, cfg.vocab_size - 4)).long().cuda()
    prefill = M.make_prefill_step(cfg)
    zero_counters()
    logits, caches = prefill(*model, {"tokens": prompts})
    n = read_counters()
    kernel = ops.flash_attention
    ops.flash_attention = ref.flash_attention
    try:
        plain, plain_caches = prefill(*model, {"tokens": prompts})
    finally:
        ops.flash_attention = kernel
    err = rel_err(logits, plain, floor=0.0)
    cerr = max(cache_errs(caches, plain_caches))
    times = kernel_times(gen, [], [(f"stablelm-prefill-{S}", B, S,
                                    cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, cfg.head_dim)])
    print(f"phase 14, the head dim 80 repair: {STABLELM} prefill at its "
          f"published widths (depth cut to {cfg.n_layers} layers, B={B}, "
          f"{S} tokens): {n['flash_attention']} flash_attention launches; "
          f"against the plain attention, logits {err:.3g} of the largest, "
          f"caches {cerr:.3g} (tolerances {SERVE_CPU_TOL}, 2e-2); base "
          f"draw {init_s:.2f} s")
    check(n["flash_attention"] == cfg.n_layers,
          f"{STABLELM} prefill: {n['flash_attention']} attention launches")
    check(err <= SERVE_CPU_TOL and cerr <= 2e-2, f"{STABLELM} prefill "
          f"against the plain attention: logits {err}, caches {cerr}")
    del model
    return dict(logits_err=err, cache_err=cerr,
                launches=n["flash_attention"], kernel_times=times)


# ---------------------------------------------------------------------------
# phases 15 and 16: the recurrent families
# ---------------------------------------------------------------------------
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
# phase 15's depth cut: a Mamba layer and the attention layer with their
# MLPs, from jamba's period of 8 (1:7 attention, MoE every other layer);
# one ("mamba", "moe") layer alone is 9.66 B values, about a minute of
# draw, and the MoE block ran at full width in phase 13
JAMBA_PATTERN = (("mamba", "mlp"), ("attn", "mlp"))


class OpCount:
    """The aten ops dispatched while it is on (``with OpCount() as n:``;
    ``n.ops``): on the card each launches at most one kernel (a view
    launches none), so it counts the host's launches of a plain-torch
    path.  The hand-written kernels' launches are their own counters."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        box = self
        self.ops = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                box.ops += 1
                return func(*args, **(kwargs or {}))
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def state_errs(got, want, mixers) -> list:
    """Each layer's largest error of its cache or state, of its largest
    magnitude; an mLSTM layer's ``(C, n, m)`` as ``C·e^m`` and ``n·e^m``
    (two forms, or two paths, may carry different stabilisers ``m``)."""
    import torch
    out = []
    for mx, g, w in zip(mixers, got, want):
        if mx != "mlstm":
            out.append(max(rel_err(a, b, floor=0.0) for a, b in zip(g, w)))
            continue
        sc = []
        for Cs, n, m in (g[:3], w[:3]):
            e = torch.exp(m.double())
            sc.append((Cs.double() * e[..., None, None],
                       n.double() * e[..., None]))
        out.append(max(rel_err(a, b, floor=0.0) for a, b in zip(*sc)))
    return out


def recurrent_compare(cfg, card: dict, cpu: dict, local: dict) -> dict:
    """The card against the CPU port on the same weights, of the largest
    magnitude: along the trajectory (``family_half`` on both: prefill,
    then the serve steps each from its own caches) and locally
    (``local``: the card's serve steps from the CPU port's own starting
    cache, against the CPU port's steps), with the bounds of
    ``recurrent_bounds``."""
    mixers = mixers_of(cfg)
    errs = {}
    for label in ("bfloat16", "float32"):
        g, w, loc = card[label], cpu[label], local[label]
        errs[label] = dict(
            prefill=rel_err(g["prefill"], w["prefill"], floor=0.0),
            steps=[rel_err(a, b, floor=0.0)
                   for a, b in zip(g["steps"], w["steps"])],
            caches=[max(a, b) for a, b in zip(
                state_errs(g["caches"], w["caches"], mixers),
                state_errs(g["step_caches"], w["step_caches"], mixers))],
            local_steps=[rel_err(a, b, floor=0.0)
                         for a, b in zip(loc["steps"], w["steps"])],
            local_caches=state_errs(loc["step_caches"], w["step_caches"],
                                    mixers),
            seconds=w["seconds"])
    errs["bounds"] = recurrent_bounds(cfg, cpu)
    return errs


def recurrent_local(cfg, model, cpu: dict, fed) -> dict:
    """The card's serve steps fed ``fed``, started from the CPU port's
    own starting cache (its copy on the card), in bfloat16 and on the
    same weights in float32: the step's function compared at one state,
    with no amplification along the prompt."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    serve = M.make_serve_step(cfg)
    out = {}
    with torch.no_grad():
        for label, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            m = model if dt == torch.bfloat16 else tree_map(
                lambda t: t.float(), model)
            start = cpu[label]["start_cache"]
            B = start[0][0].shape[0]
            seq = [c for mx, c in zip(mixers_of(cfg), start)
                   if mx in ("attn", "mla")]
            slots = seq[0][0].shape[1] if seq else 1
            cache = M.init_cache(cfg, B, slots, dtype=dt, device="cuda")
            for got, dst in zip(start, cache):
                for src, d in zip(got, dst):
                    d.copy_(src)
            P = cpu["prompt_len"]
            steps = []
            for s in range(fed.shape[1]):
                lg, cache = serve(*m, cache, fed[:, s:s + 1], P + s)
                steps.append(lg.float().cpu())
            out[label] = dict(steps=steps, step_caches=tree_map(
                lambda t: t.float().cpu(), cache))
            del m
    return out


# a quantity whose float32 value the CPU port itself computes two ways
# (prefill and the decode path) more than this far apart, of its largest
# magnitude, is amplified by the model: a fixed bound cannot tell a fault
# there from the model's own amplification of rounding
AMPLIFIED = SERVE_F32_TOL / 10


def recurrent_bounds(cfg, cpu: dict) -> dict:
    """Which trajectory quantities are held, and to what.  The CPU port's
    own float32 gap between its prefill and its decode path (two orders
    of the same float32 sums), a layer at a time and at the logits,
    tells where the model amplifies rounding: xlstm-125m's sLSTM layers
    at their published widths multiply a difference by about 1.3 a
    position, so after 32 positions float32 results differ in the 4th
    digit however the sums are ordered.  A quantity whose own gap is
    under ``AMPLIFIED`` is held along the trajectory to the fixed bounds
    (bfloat16: logits ``SERVE_CPU_TOL``, caches 2e-2; float32
    ``SERVE_F32_TOL``); one above it is printed with its own gap, and the
    local comparison (one state, no prompt to amplify along) holds the
    card there.  Without the CPU port's decode path every quantity is
    held."""
    f32 = cpu["float32"]
    own = f32["cache_gaps"] or [0.0] * cfg.n_layers
    own_logits = f32["rel_gap"] or 0.0
    return dict(own_f32_caches=own, own_f32_logits=own_logits,
                held_caches=[x < AMPLIFIED for x in own],
                held_logits=own_logits < AMPLIFIED)


def check_recurrent(name: str, errs: dict):
    b = errs["bounds"]
    for label, tol, ctol in (("bfloat16", SERVE_CPU_TOL, 2e-2),
                             ("float32", SERVE_F32_TOL, SERVE_F32_TOL)):
        e = errs[label]
        for what, err in ([(f"local serve step {s}", x)
                           for s, x in enumerate(e["local_steps"])]
                          + ([("prefill logits", e["prefill"])]
                             + [(f"serve step {s}", x)
                                for s, x in enumerate(e["steps"])]
                             if b["held_logits"] else [])):
            check(err <= tol, f"{name} {label} {what}: card against the "
                  f"CPU port {err} > {tol}")
        for i, err in enumerate(e["local_caches"]):
            check(err <= ctol, f"{name} {label} layer {i} caches after the "
                  f"local serve steps: card against the CPU port {err} > "
                  f"{ctol}")
        for i, err in enumerate(e["caches"]):
            if b["held_caches"][i]:
                check(err <= ctol, f"{name} {label} layer {i} caches: card "
                      f"against the CPU port {err} > {ctol}")


def recurrent_decode_gap(cfg, model, prompts) -> dict:
    """Prefill against the decode path fed the same prompts on the card:
    in float32 (the model's weights widened, a float32 decode cache)
    every layer's state (the mLSTM's as ``C·e^m``, ``n·e^m``) and the
    last logits, held by ``check_recurrent_run`` to the float32 bounds of
    ``recurrent_bounds``; in bfloat16 the gaps are printed, not held (the
    train paths apply SiLU after the convolution's cast to the
    activation dtype, the decode paths before it, as JAX's do)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    out = {}
    for label, m, dt in (("bfloat16", model, torch.bfloat16),
                         ("float32", tree_map(lambda t: t.float(), model),
                          torch.float32)):
        with torch.no_grad():
            logits, caches = M.make_prefill_step(cfg)(*m,
                                                      {"tokens": prompts})
            dec, dec_cache = decode_path(cfg, m, prompts, "cuda", dtype=dt)
        out[label] = dict(logits=rel_err(dec, logits, floor=0.0),
                          states=state_errs(dec_cache, caches,
                                            mixers_of(cfg)))
        del m, caches, dec_cache
    return out


def recurrent_start(name, cfg, cpu_decode: bool) -> dict:
    """The base of ``cfg`` drawn on the card (``draw_family``), 4 prompts
    of 512 tokens (``serve_prompts``), and its CPU half (``family_half``
    at 32 tokens on host copies of the card's weights, ``cpu_decode``
    with the decode path, phase 19's labels) started in a process of its
    own; ``half`` as ``minicpm_start``'s."""
    model, init_s, draw_peak, weight_bytes = draw_family(cfg)
    prompts = serve_prompts(cfg)
    P = min(SERVE_PROMPTS)
    fed = prompts[:, P:P + 2]
    labels = next_tokens(prompts[:, :P], fed)
    t0 = time.perf_counter()
    job = CpuJob(f"{name} at {P} tokens (cpu, plain)", family_half_cpu,
                 cfg, *host_tree((model, prompts[:, :P], fed)),
                 CPU_JOB_THREADS, cpu_decode, host_tree(labels))
    return dict(name=name, cfg=cfg, model=model, prompts=prompts, fed=fed,
                labels=labels, half=(cfg, model, prompts[:, :P], labels,
                                     None),
                job=job, init_s=init_s, draw_peak=draw_peak,
                weight_bytes=weight_bytes,
                handoff=time.perf_counter() - t0)


def recurrent_run(started: dict, gen, lora_shapes, attn_shapes,
                  lora_iters=(50, 20), training=None):
    """Phases 15 and 16's shared body, on ``recurrent_start``'s model:
    4 requests served at 32 and 512 tokens (``serve_timed``), prefill
    against the decode path (``recurrent_decode_gap``), the kernels at
    the model's shapes (``kernel_times``), then the CPU half collected
    and compared, along the trajectory and from one state
    (``recurrent_compare``, ``recurrent_local``).  Phase 19's
    ``train_family`` runs here unless ``training`` brings its numbers
    (``side_training``'s).  Returns the model, the prompts and the
    phase's numbers; the checks are the caller's."""
    import torch
    from repro_torch import random as jr
    name, cfg, model = started["name"], started["cfg"], started["model"]
    prompts, fed, job = started["prompts"], started["fed"], started["job"]
    init_s, draw_peak = started["init_s"], started["draw_peak"]
    weight_bytes, handoff = started["weight_bytes"], started["handoff"]
    B, steps, key = SERVE_B, SERVE_STEPS, jr.PRNGKey(0)
    P = min(SERVE_PROMPTS)
    torch.cuda.reset_peak_memory_stats()
    runs = {P_: serve_timed(cfg, model, prompts[:, :P_], SERVE_STEPS, key,
                            weight_bytes) for P_ in SERVE_PROMPTS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for P_, r in runs.items():
        print(f"{name} (bf16, B={B}, prompt {P_}): prefill "
              f"{r['prefill_s'] * 1e3:.2f} ms; {steps} serve steps "
              f"{r['decode_s']:.4f} s, {r['step_s'] * 1e3:.3f} ms a step "
              f"(byte bound {r['bound_step_ms']:.3f} ms: "
              f"{weight_bytes / 1e9:.3f} GB of weights, "
              f"{r['cache_bytes'] / 1e6:.1f} MB of cache read and "
              f"{r['state_bytes'] / 1e6:.1f} MB of recurrent state written "
              f"at 3.35 TB/s), {r['tokens_per_s']:.1f} tokens/s; launches: "
              f"prefill {json.dumps(r['launches_prefill'])}, serve steps "
              f"{json.dumps(r['launches_steps'])}")
    gaps = recurrent_decode_gap(cfg, model, prompts[:, :P])
    card = family_half(cfg, model, prompts[:, :P], fed, decode=False,
                       labels=started["labels"])
    times = kernel_times(gen, lora_shapes, attn_shapes, lora_iters)
    if training is None:
        training = train_family(cfg.name, cfg, model, prompts)
    t0 = time.perf_counter()
    cpu = host_tree(job.result(), False)
    waited = time.perf_counter() - t0
    errs = recurrent_compare(cfg, card, cpu,
                             recurrent_local(cfg, model, cpu, fed))
    training["cpu_compare"] = train_half_compare(card, cpu)
    print(training_text(training["cpu_compare"], cfg))
    return model, prompts, dict(
        init_s=init_s, draw_peak_gib=draw_peak, peak_gib=peak,
        weight_bytes=weight_bytes, cpu_s=cpu["seconds"], cpu_waited_s=waited,
        cpu_handoff_s=handoff, decode_gap=gaps, cpu_compare=errs,
        kernel_times=times, training=training,
        runs={P_: {k: v for k, v in r.items() if k not in ("logits",
                                                            "caches")}
              for P_, r in runs.items()})


def recurrent_text(out: dict) -> str:
    e16, e32 = out["cpu_compare"]["bfloat16"], out["cpu_compare"]["float32"]
    g16, g32 = out["decode_gap"]["bfloat16"], out["decode_gap"]["float32"]
    b = out["cpu_compare"]["bounds"]
    f = lambda xs: ", ".join(f"{x:.3g}" for x in xs)  # noqa: E731
    held = [i for i, h in enumerate(b["held_caches"]) if h]
    return (f"card against the CPU port at {min(SERVE_PROMPTS)} tokens (a "
            f"process of {CPU_JOB_THREADS} threads, {out['cpu_s']:.1f} s, "
            f"{out['cpu_waited_s']:.1f} s of it waited for, "
            f"{out['cpu_handoff_s']:.1f} s to hand it the weights), of the "
            f"largest; from one state (the card's serve steps from the CPU "
            f"port's starting cache): bfloat16 logits "
            f"{f(e16['local_steps'])}, caches by layer "
            f"{f(e16['local_caches'])} (tolerances {SERVE_CPU_TOL}, 2e-2); "
            f"float32 {f(e32['local_steps'])}, caches "
            f"{f(e32['local_caches'])} (tolerance {SERVE_F32_TOL}); along "
            f"the trajectory (prefill, then each side's serve steps from its "
            f"own caches): bfloat16 prefill logits {e16['prefill']:.3g}, "
            f"serve steps {f(e16['steps'])}, caches by layer "
            f"{f(e16['caches'])}; float32 {e32['prefill']:.3g}, "
            f"{f(e32['steps'])}, caches {f(e32['caches'])}; held (the CPU "
            f"port's own float32 prefill-against-decode gap under "
            f"{AMPLIFIED:.3g}: logits {b['own_f32_logits']:.3g}, caches "
            f"{f(b['own_f32_caches'])}): logits "
            f"{'yes' if b['held_logits'] else 'no, amplified'}, caches of "
            f"layers {held} (tolerances {SERVE_CPU_TOL}, 2e-2; "
            f"{SERVE_F32_TOL}); prefill against the decode path on the "
            f"card, float32: logits {g32['logits']:.3g}, states by layer "
            f"{f(g32['states'])} (tolerance {SERVE_F32_TOL} where held); "
            f"bfloat16 (printed: SiLU before and after the cast, as in JAX) "
            f"{g16['logits']:.3g}, {f(g16['states'])}; base draw "
            f"{out['init_s']:.2f} s ({out['weight_bytes'] / 1e9:.2f} GB, "
            f"draw peak {out['draw_peak_gib']:.2f} GiB); peak memory after "
            f"it {out['peak_gib']:.2f} GiB")


def check_recurrent_run(name, cfg, out: dict):
    want = family_launches(cfg)
    for P_, r in out["runs"].items():
        check_serving_launches(r["launches_prefill"], want["prefill"],
                               f"{name} prefill {P_}")
        check_serving_launches(r["launches_steps"], {
            n: SERVE_STEPS * c for n, c in want["serve_step"].items()},
            f"{name} {SERVE_STEPS} serve steps after a {P_}-token prefill")
        check(r["finite"], f"{name} prefill {P_} or its serve steps: "
              "logits not finite")
    check_recurrent(name, out["cpu_compare"])
    g = out["decode_gap"]["float32"]
    b = out["cpu_compare"]["bounds"]
    for what, err, held in ([("logits", g["logits"], b["held_logits"])]
                            + [(f"layer {i} state", x, b["held_caches"][i])
                               for i, x in enumerate(g["states"])]):
        check(not held or err <= SERVE_F32_TOL, f"{name} float32 prefill "
              f"against the decode path, {what}: {err} > {SERVE_F32_TOL}")
    check(any(b["held_caches"]), f"{name}: no layer held along the "
          "trajectory")
    check_training(name, cfg, out["training"],
                   out["training"]["cpu_compare"])


def jamba_start() -> dict:
    """Phase 15's config (``JAMBA_PATTERN``), draw and CPU half
    (``recurrent_start``)."""
    import dataclasses
    from repro_torch.configs.registry import get
    full = get(JAMBA)
    cfg = dataclasses.replace(full, n_layers=len(JAMBA_PATTERN),
                              pattern=JAMBA_PATTERN)
    mc, d = cfg.mamba, cfg.d_model
    print(f"phase 15: {JAMBA} at its published widths (d_model {d}, Mamba "
          f"ed {mc.expand * d}, d_state {mc.d_state}, d_conv {mc.d_conv}, "
          f"dt_rank {mc.dt_rank or -(-d // 16)}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}); depth cut from {full.n_layers} layers "
          f"to {cfg.n_layers}: {list(cfg.pattern)}")
    return recurrent_start(f"phase 15 ({JAMBA})", cfg, cpu_decode=False)


def jamba_phase(gen, started: dict = None) -> dict:
    """Phase 15: ``jamba-1.5-large-398b`` at its published widths (d_model
    8192, Mamba ed 16384, d_state 16, d_conv 4, dt_rank 512, 64/8 heads of
    128, d_ff 24576, vocab 65536, untied), its depth cut from 72 layers to
    ``JAMBA_PATTERN`` (a Mamba layer and the attention layer, each with
    its MLP); the bfloat16 base as ``init_params`` draws it; served as
    phase 12 serves (``recurrent_run``).  Checks: the launches (per
    prefill 7 ``lora_matmul``, one ``flash_attention`` at head dim 128;
    per serve step 7 and none); the card against the CPU port; prefill
    (``mamba_train``'s chunked scan) against the decode path at full
    width; ``lora_matmul`` at jamba's five adapted projections and
    ``flash_attention`` at D = 128, S = 512, against their plain
    versions.  ``started`` is ``jamba_start``'s when the draw ran
    earlier (its time is then in the phase's numbers, not in its wall
    time).  The card's model is freed at the end."""
    t_phase = time.perf_counter()
    started = started or jamba_start()
    cfg = started["cfg"]
    d, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    D, ff = cfg.head_dim, cfg.d_ff
    B, S = SERVE_B, max(SERVE_PROMPTS)
    # tens of ms a call at M = 2048: fewer calls timed (10 in a loop, 4
    # captured in a graph replayed 5 times)
    model, _, out = recurrent_run(
        started, gen,
        [(f"jamba-{n}-M{M_}", M_, K, N, cfg.lora.rank)
         for n, (K, N) in (("wq", (d, H * D)), ("wkv", (d, 2 * KH * D)),
                           ("wo", (H * D, d)), ("w_in", (d, 2 * ff)),
                           ("w_out", (ff, d)))
         for M_ in (B, B * S)],
        [(f"jamba-prefill-{S}", B, S, H, KH, D, D)], lora_iters=(10, 4))
    wall = time.perf_counter() - t_phase
    out["wall_s"] = wall
    print(f"phase 15: {recurrent_text(out)}; phase {wall:.1f} s")
    check_recurrent_run(JAMBA, cfg, out)
    del model
    return out


def xlstm_start() -> dict:
    """Phase 16's draw and CPU half (``recurrent_start``), started before
    phase 15 so the CPU half runs beside it."""
    from repro_torch.configs.registry import get
    return recurrent_start(f"phase 16 ({XLSTM})", get(XLSTM),
                           cpu_decode=True)


def xlstm_phase(gen, started: dict, training=None) -> dict:
    """Phase 16: ``xlstm-125m`` at its published widths and all 12 layers
    (d_model 768, 4 heads, mLSTM ed 1536 of head dim 384, sLSTM FFN 1024,
    vocab 50304, untied), served as phase 12 serves (``recurrent_run``;
    the serve steps go on from the decode path's cache, since JAX's mLSTM
    prefill cache has no convolution state); then the sequential and the
    chunkwise mLSTM prefill at 512 tokens: each timed in bfloat16 with its
    ``lora_matmul`` launches and its aten ops (``OpCount``); in float32
    the first mLSTM layer's two forms on the embedded prompts, output and
    states (as ``C·e^m``, ``n·e^m``) within ``SERVE_F32_TOL``, and the
    whole model's two prefills against each other, printed.
    Checks: the launches (6 ``lora_matmul``, the mLSTM's ``wq``, a pass;
    no attention); the card against the CPU port; prefill against the
    decode path; ``lora_matmul`` at the mLSTM's ``wq`` against its plain
    version.  ``started`` is ``xlstm_start``'s (its draw time is in the
    phase's numbers, not in its wall time); ``training``, phase 19's
    numbers when ``side_training`` took them."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import xlstm
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    cfg = started["cfg"]
    xc, d, H = cfg.xlstm, cfg.d_model, cfg.n_heads
    ed = xc.expand * d
    print(f"phase 16: {XLSTM} at its published widths and all "
          f"{cfg.n_layers} layers (d_model {d}, {H} heads, mLSTM ed {ed} of "
          f"head dim {ed // H}, sLSTM FFN "
          f"{-(-int(d * xc.slstm_ffn_factor) // 128) * 128}, vocab "
          f"{cfg.vocab_size}): {list(cfg.pattern)} × {cfg.n_groups}")
    B, S = SERVE_B, max(SERVE_PROMPTS)
    model, prompts, out = recurrent_run(
        started, gen,
        [(f"xlstm-wq-M{M_}", M_, ed, ed, cfg.lora.rank) for M_ in (B, B * S)],
        [], training=training)
    batch = {"tokens": prompts}
    forms = {}
    for form, chunk in (("sequential", False), ("chunkwise", True)):
        prefill = M.make_prefill_step(cfg, M.FwdOptions(
            remat=False, collect_cache=True, mlstm_chunkwise=chunk))
        if chunk:           # the sequential one ran warm in serve_timed
            prefill(*model, batch)
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(*model, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = read_counters()
        with torch.no_grad(), OpCount() as ops:
            prefill(*model, batch)
        f32 = tree_map(lambda t: t.float(), model)
        logits, caches = prefill(*f32, batch)
        del f32
        forms[form] = dict(ms=ms, lora_matmul=n["lora_matmul"],
                           aten_ops=ops.ops, logits=logits, caches=caches)
    seq, chk = forms["sequential"], forms["chunkwise"]
    form_logits = rel_err(chk.pop("logits"), seq.pop("logits"), floor=0.0)
    form_states = state_errs(chk.pop("caches"), seq.pop("caches"),
                             mixers_of(cfg))
    # the first mLSTM layer alone, both forms on the same input (the
    # embedded prompts), in float32: every later layer's input already
    # carries the other form's rounding, which the sLSTM layers amplify
    params, adapters = model
    layer0 = {k: v.float() for k, v in params["layers"][0].items()}
    layer0.update({k: v[None].float() for k, v in adapters[0].items()})
    with torch.no_grad():
        x = params["embed"][prompts][None].float()
        ys, ss = xlstm.mlstm_train(layer0, cfg, x)
        yc, sc = xlstm.mlstm_train_chunkwise(layer0, cfg, x)
    first = dict(out=rel_err(yc, ys, floor=0.0),
                 states=state_errs([sc], [ss], ["mlstm"])[0])
    del layer0, x, ys, ss, yc, sc
    out["forms"] = dict(forms, logits_gap=form_logits,
                        states_gap=form_states, first_layer=first)
    wall = time.perf_counter() - t_phase
    out["wall_s"] = wall
    print(f"phase 16: {recurrent_text(out)}; the mLSTM prefill at {S} "
          f"tokens (bf16, B={B}): sequential {seq['ms']:.1f} ms, "
          f"{seq['lora_matmul']} lora_matmul launches, {seq['aten_ops']} "
          f"aten ops; chunkwise {chk['ms']:.1f} ms, {chk['lora_matmul']} "
          f"lora_matmul launches, {chk['aten_ops']} aten ops; chunkwise "
          f"against sequential in float32, the first mLSTM layer on the "
          f"embedded prompts: output {first['out']:.3g}, states "
          f"{first['states']:.3g} (tolerance {SERVE_F32_TOL}; as C·e^m, "
          f"n·e^m); the whole model (printed: each later layer's input "
          f"carries the other form's rounding, which the sLSTM layers "
          f"amplify): logits {form_logits:.3g}, states by layer "
          f"{', '.join(f'{x:.3g}' for x in form_states)}; phase "
          f"{wall:.1f} s")
    check_recurrent_run(XLSTM, cfg, out)
    want = adapted_launches(cfg, False)
    for form, f in forms.items():
        check(f["lora_matmul"] == want, f"{XLSTM} {form} prefill: "
              f"{f['lora_matmul']} lora_matmul launches, want {want}")
    for what, err in (("output", first["out"]),
                      ("states", first["states"])):
        check(err <= SERVE_F32_TOL, f"{XLSTM} first mLSTM layer, chunkwise "
              f"against sequential, {what}: {err} > {SERVE_F32_TOL}")
    del model, prompts
    return out


# ---------------------------------------------------------------------------
# phases 17 and 18: the encoder-decoder and the vision frontend
# ---------------------------------------------------------------------------
WHISPER, QWEN_VL = "whisper-large-v3", "qwen2-vl-72b"
# phase 18's depth cut: qwen2-vl-72b's 80 layers to one, its whole period
# (3.44 B values; each further layer is 0.88 B)
QWEN_VL_LAYERS = 1
# requests of the CPU halves (a prompt of min(SERVE_PROMPTS) tokens behind
# every frame or patch): whisper's first FAMILY_CPU_DEPTH encoder and
# decoder layers, qwen2-vl's one layer (1056 rows of 8192, the heaviest
# CPU half of the smoke), one request each
FRONTEND_CPU_B = {WHISPER: 1, QWEN_VL: 1}


def frontend_cfg(name: str):
    """The config a phase serves: the published one, qwen2-vl's depth cut
    to ``QWEN_VL_LAYERS``."""
    import dataclasses
    from repro_torch.configs.registry import get
    cfg = get(name)
    if name == QWEN_VL:
        cfg = dataclasses.replace(cfg, n_layers=QWEN_VL_LAYERS)
    return cfg


def frontend_launches(cfg) -> dict:
    """Launches of one prefill and one serve step: every adapted
    projection of the decoder, and in prefill of the encoder (the cross
    projections and ``proj_frontend`` are no LoRA target, so plain
    products); attention once a decoder layer in prefill, and for an
    encoder-decoder once an encoder layer and once a cross-attention;
    none in a serve step (decode attention, cross included, is plain
    torch, as JAX's is jnp)."""
    import dataclasses
    n = family_launches(cfg)
    if cfg.encoder_decoder:
        enc = dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers)
        n["prefill"]["lora_matmul"] += adapted_launches(enc, False)
        n["prefill"]["flash_attention"] += cfg.n_encoder_layers + cfg.n_layers
    return n


def step_weight_bytes(cfg, model) -> int:
    """The weights a serve step reads: the decoder's layers and their
    adapters, the final norm and the LM head (the embedding table only
    when it is the head); not the encoder, its norm, ``proj_frontend``,
    nor the embedding table's rows."""
    from repro_torch.tree import tree_leaves
    params, adapters = model
    dec = adapters["layers"] if cfg.encoder_decoder else adapters
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return sum(t.numel() * t.element_size() for t in (
        tree_leaves(params["layers"]) + tree_leaves(dec)
        + [params["final_norm"], head]))


def frontend_shallow(cfg, model, tokens):
    """The CPU half's model, and its tokens: whisper's first
    ``FAMILY_CPU_DEPTH`` encoder and decoder layers of the card's weights
    (qwen2-vl's one layer as it is), with the embedding table cut to the
    rows of ``tokens`` (an untied table is read only there) and the tokens
    renumbered into it, so that the CPU process receives a few rows of the
    table, not all of it."""
    import dataclasses
    import torch
    params, adapters = model
    check(not cfg.tie_embeddings, "a tied table is the LM head: keep it")
    ids = torch.unique(tokens)
    params = dict(params, embed=params["embed"][ids])
    tokens = torch.searchsorted(ids, tokens.contiguous())
    if not cfg.encoder_decoder:
        return cfg, (params, adapters), tokens
    d = FAMILY_CPU_DEPTH
    return (dataclasses.replace(cfg, n_layers=d, n_encoder_layers=d),
            (dict(params, layers=params["layers"][:d],
                  enc_layers=params["enc_layers"][:d]),
             {k: v[:d] for k, v in adapters.items()}), tokens)


def frontend_half_cpu(cfg, model, batch, fed, threads: int) -> dict:
    """``frontend_half`` in a spawned process, on host trees both ways."""
    return host_tree(frontend_half(cfg, *host_tree((model, batch, fed),
                                                   False), threads))


def frontend_half(cfg, model, batch, fed, threads: int = 0) -> dict:
    """Prefill on ``batch`` (tokens, and the float32 stub frontend, cast
    to bfloat16 for the bfloat16 run) and ``fed.shape[1]`` serve steps fed
    ``fed`` from prefill's cache, in bfloat16 and on the same weights in
    float32 (a float32 cache): logits and caches on the CPU; with
    ``batch["labels"]``, phase 19's ``train_half``.  Runs on the model's device; phases 17
    and 18 run it on the card and, in a process of its own, on the
    CPU."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    if threads:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    dev = batch["tokens"].device
    prefill, serve = M.make_prefill_step(cfg), M.make_serve_step(cfg)
    rows = patch_rows(cfg) + batch["tokens"].shape[1]
    cpu = lambda t: t.float().cpu()  # noqa: E731
    out = {}
    with torch.no_grad():
        for label, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            t1 = time.perf_counter()
            m = model if dt == torch.bfloat16 else tree_map(
                lambda t: t.float(), model)
            logits, caches = prefill(*m, dict(
                batch, frontend=batch["frontend"].to(dt)))
            cache = decode_cache(cfg, caches, fed.shape[1], dev)
            steps = []
            for s in range(fed.shape[1]):
                lg, cache = serve(*m, cache, fed[:, s:s + 1], rows + s)
                steps.append(cpu(lg))
            out[label] = dict(prefill=cpu(logits),
                              caches=tree_map(cpu, caches), steps=steps,
                              step_caches=tree_map(cpu, cache),
                              seconds=time.perf_counter() - t1)
            if "labels" in batch:
                out.update(train_half(cfg, m, batch["tokens"],
                                      batch["labels"], dt,
                                      batch["frontend"]))
            del m, caches, cache
    out["seconds"] = time.perf_counter() - t0
    return out


def prefill_step_gaps(cfg, model, prompts, frames) -> dict:
    """Prefill over each prompt length of ``SERVE_PROMPTS`` against
    prefill over all but its last token followed by one serve step at the
    last position, seeded from that prefill's cache (an encoder-decoder's
    cross caches too): the logits' gap of the largest, in bfloat16 and on
    the same weights in float32 with a float32 cache."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    prefill, serve = M.make_prefill_step(cfg), M.make_serve_step(cfg)
    out = {}
    for label, dt in (("bfloat16", torch.bfloat16),
                      ("float32", torch.float32)):
        m = model if dt == torch.bfloat16 else tree_map(lambda t: t.float(),
                                                        model)
        out[label] = {}
        for P in SERVE_PROMPTS:
            fe = frames.to(dt)
            with torch.no_grad():
                full = prefill(*m, {"tokens": prompts[:, :P],
                                    "frontend": fe})[0]
                _, caches = prefill(*m, {"tokens": prompts[:, :P - 1],
                                         "frontend": fe})
                cache = decode_cache(cfg, caches, 1, "cuda")
                step = serve(*m, cache, prompts[:, P - 1:P],
                             patch_rows(cfg) + P - 1)[0]
            out[label][P] = rel_err(step, full, floor=0.0)
            del caches, cache
        del m
    return out


FRONTEND_PHASE = {WHISPER: 17, QWEN_VL: 18}


def frontend_start(name: str) -> dict:
    """The base of ``name`` (``frontend_cfg``) drawn on the card
    (``draw_family``), 4 prompts of 512 tokens from the seed, the stub
    frontend's float32 embeddings ``(4, F, d)`` from a card generator
    seeded 0, and the card's and the CPU's halves of the comparison at 32
    tokens on ``frontend_shallow``'s model (``FRONTEND_CPU_B[name]``
    requests and the 2 tokens fed after the prompt, phase 19's labels):
    the CPU's, on host copies, started in a process of its own; ``half``
    as ``minicpm_start``'s."""
    import torch
    from repro_torch.configs.registry import get
    cfg, full = frontend_cfg(name), get(name)
    print(f"phase {FRONTEND_PHASE[name]}: {name} at its published widths "
          f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.n_frontend_tokens} {cfg.frontend} embeddings"
          + (f", M-RoPE sections {cfg.mrope_sections}"
             if cfg.mrope_sections else "")
          + f"), {cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder "
          f"layers (published: {full.n_encoder_layers} and {full.n_layers})")
    model, init_s, draw_peak, weight_bytes = draw_family(cfg)
    prompts = serve_prompts(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randn(SERVE_B, cfg.n_frontend_tokens, cfg.d_model,
                         generator=gen, device="cuda")
    P, b = min(SERVE_PROMPTS), FRONTEND_CPU_B[name]
    cpu_cfg, cpu_model, tokens = frontend_shallow(cfg, model,
                                                  prompts[:b, :P + 2])
    # the labels index the LM head, not the cut embedding table
    batch = {"tokens": tokens[:, :P], "frontend": frames[:b],
             "labels": prompts[:b, 1:P + 1]}
    fed = tokens[:, P:]
    t0 = time.perf_counter()
    job = CpuJob(f"{name} at {P} tokens (cpu, plain)", frontend_half_cpu,
                 cpu_cfg, *host_tree((cpu_model, batch, fed)),
                 CPU_JOB_THREADS)
    return dict(name=name, cfg=cfg, model=model, prompts=prompts,
                frames=frames, cpu_cfg=cpu_cfg, cpu_model=cpu_model,
                batch=batch, fed=fed, job=job, init_s=init_s,
                half=(cpu_cfg, cpu_model, batch["tokens"], batch["labels"],
                      batch["frontend"]),
                draw_peak=draw_peak, weight_bytes=weight_bytes,
                handoff=time.perf_counter() - t0)


def tree_err(got, want) -> float:
    """The largest error of a tree's leaves, each of its largest
    magnitude."""
    from repro_torch.tree import tree_leaves
    gl, wl = tree_leaves(got), tree_leaves(want)
    check(len(gl) == len(wl) and all(g.shape == w.shape
                                     for g, w in zip(gl, wl)),
          "the card's and the CPU's caches differ in layout")
    return max(rel_err(g, w, floor=0.0) for g, w in zip(gl, wl))


def frontend_run(started: dict, gen, lora_shapes, attn_shapes,
                 lora_iters=(50, 20), attn_iters: int = 100) -> dict:
    """Phases 17 and 18's shared body, on ``frontend_start``'s model: 4
    requests served at 32 and 512 tokens behind the bf16 frontend
    (``serve_timed``, the byte bound the weights a step reads,
    ``step_weight_bytes``), prefill against its own serve step
    (``prefill_step_gaps``), the card's half of the CPU comparison, the
    kernels at the model's shapes (``kernel_times``), then the CPU half
    collected and compared.  Returns the phase's numbers; the checks are
    ``check_frontend_run``'s."""
    import torch
    from repro_torch import random as jr
    cfg, model, prompts = started["cfg"], started["model"], started["prompts"]
    name, frames = started["name"], started["frames"]
    B, steps = SERVE_B, SERVE_STEPS
    step_bytes = step_weight_bytes(cfg, model)
    # other phases' models may lie on the card: the peak is this model's
    held = torch.cuda.memory_allocated() - started["weight_bytes"]
    torch.cuda.reset_peak_memory_stats()
    runs = {P_: serve_timed(cfg, model, prompts[:, :P_], steps,
                            jr.PRNGKey(0), step_bytes,
                            frontend=frames.to(torch.bfloat16))
            for P_ in SERVE_PROMPTS}
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    for P_, r in runs.items():
        print(f"{name} (bf16, B={B}, prompt {P_} behind "
              f"{cfg.n_frontend_tokens} {cfg.frontend} embeddings): prefill "
              f"{r['prefill_s'] * 1e3:.2f} ms; {steps} serve steps "
              f"{r['decode_s']:.4f} s, {r['step_s'] * 1e3:.3f} ms a step "
              f"(byte bound {r['bound_step_ms']:.3f} ms: "
              f"{step_bytes / 1e9:.3f} GB of weights read a step and "
              f"{r['cache_bytes'] / 1e6:.1f} MB of cache at 3.35 TB/s), "
              f"{r['tokens_per_s']:.1f} tokens/s; launches: prefill "
              f"{json.dumps(r['launches_prefill'])}, serve steps "
              f"{json.dumps(r['launches_steps'])}")
    marks = [time.perf_counter()]
    gaps = prefill_step_gaps(cfg, model, prompts, frames)
    marks.append(time.perf_counter())
    cpu_cfg = started["cpu_cfg"]
    card = frontend_half(cpu_cfg, started["cpu_model"], started["batch"],
                         started["fed"])
    marks.append(time.perf_counter())
    times = kernel_times(gen, lora_shapes, attn_shapes, lora_iters,
                         attn_iters)
    marks.append(time.perf_counter())
    training = train_family(name, cfg, model, prompts, frames)
    marks.append(time.perf_counter())
    cpu = host_tree(started["job"].result(), False)
    marks.append(time.perf_counter())
    waited = marks[-1] - marks[-2]
    split = dict(zip(("prefill_step_gaps", "card_half", "kernel_times",
                      "training", "cpu_wait"),
                     (b - a for a, b in zip(marks, marks[1:]))))
    training["cpu_compare"] = train_half_compare(card, cpu)
    print(training_text(training["cpu_compare"], cfg))
    errs = {}
    for label in ("bfloat16", "float32"):
        g, w = card[label], cpu[label]
        errs[label] = dict(
            prefill=rel_err(g["prefill"], w["prefill"], floor=0.0),
            steps=[rel_err(a, b, floor=0.0)
                   for a, b in zip(g["steps"], w["steps"])],
            caches=max(tree_err(g["caches"], w["caches"]),
                       tree_err(g["step_caches"], w["step_caches"])),
            seconds=w["seconds"])
    return dict(init_s=started["init_s"], draw_peak_gib=started["draw_peak"],
                peak_gib=peak, weight_bytes=started["weight_bytes"],
                step_weight_bytes=step_bytes, cpu_s=cpu["seconds"],
                cpu_waited_s=waited, cpu_handoff_s=started["handoff"],
                cpu_requests=started["batch"]["tokens"].shape[0],
                cpu_layers=cpu_cfg.n_layers + cpu_cfg.n_encoder_layers,
                prefill_step_gap=gaps, cpu_compare=errs, kernel_times=times,
                seconds=split, training=training,
                runs={P_: {k: v for k, v in r.items()
                           if k not in ("logits", "caches")}
                      for P_, r in runs.items()})


def frontend_text(out: dict) -> str:
    e16, e32 = out["cpu_compare"]["bfloat16"], out["cpu_compare"]["float32"]
    g16, g32 = (out["prefill_step_gap"][k] for k in ("bfloat16", "float32"))
    f = lambda xs: ", ".join(f"{x:.3g}" for x in xs)  # noqa: E731
    return (f"card against the CPU port ({out['cpu_layers']} layers, "
            f"{out['cpu_requests']} request(s) of {min(SERVE_PROMPTS)} "
            f"tokens behind every frame or patch; a process of "
            f"{CPU_JOB_THREADS} threads, {out['cpu_s']:.1f} s: bfloat16 "
            f"{e16['seconds']:.1f} s, float32 {e32['seconds']:.1f} s; "
            f"{out['cpu_waited_s']:.1f} s waited for, "
            f"{out['cpu_handoff_s']:.1f} s to hand it the weights), of the "
            f"largest: bfloat16 prefill logits {e16['prefill']:.3g}, 2 serve "
            f"steps {f(e16['steps'])}, caches {e16['caches']:.3g} "
            f"(tolerances {SERVE_CPU_TOL}, 2e-2); float32 "
            f"{e32['prefill']:.3g}, {f(e32['steps'])}, caches "
            f"{e32['caches']:.3g} (tolerance {SERVE_F32_TOL}); prefill "
            f"against prefill over one token fewer and a serve step, on the "
            f"card: float32 {f(g32.values())} at {list(g32)} tokens "
            f"(tolerance {SERVE_F32_TOL}), bfloat16 {f(g16.values())}; base "
            f"draw {out['init_s']:.2f} s ({out['weight_bytes'] / 1e9:.2f} "
            f"GB, draw peak {out['draw_peak_gib']:.2f} GiB); peak memory "
            f"after it {out['peak_gib']:.2f} GiB; seconds: "
            + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items()))


def check_frontend_run(name: str, cfg, out: dict):
    want = frontend_launches(cfg)
    for P_, r in out["runs"].items():
        check_serving_launches(r["launches_prefill"], want["prefill"],
                               f"{name} prefill {P_}")
        check_serving_launches(r["launches_steps"], {
            n: SERVE_STEPS * c for n, c in want["serve_step"].items()},
            f"{name} {SERVE_STEPS} serve steps after a {P_}-token prefill")
        check(r["finite"], f"{name} prefill {P_} or its serve steps: "
              "logits not finite")
    for P_, gap in out["prefill_step_gap"]["float32"].items():
        check(gap <= SERVE_F32_TOL, f"{name} float32 prefill over {P_} "
              f"tokens against prefill over {P_ - 1} and a serve step: "
              f"{gap} > {SERVE_F32_TOL}")
    for label, tol, ctol in (("bfloat16", SERVE_CPU_TOL, 2e-2),
                             ("float32", SERVE_F32_TOL, SERVE_F32_TOL)):
        e = out["cpu_compare"][label]
        for what, err, t in ([("prefill logits", e["prefill"], tol),
                              ("caches", e["caches"], ctol)]
                             + [(f"serve step {s}", x, tol)
                                for s, x in enumerate(e["steps"])]):
            check(err <= t, f"{name} {label} {what}: card against the CPU "
                  f"port {err} > {t}")
    check_training(name, cfg, out["training"],
                   out["training"]["cpu_compare"])


def whisper_phase(gen, started: dict) -> dict:
    """Phase 17: ``whisper-large-v3`` at its published widths and all 32
    encoder and 32 decoder layers (d_model 1280, 20 heads of 64, d_ff
    5120, vocab 51866, 1500 stub audio frames), the bfloat16 base as
    ``init_params`` draws it (``frontend_start``'s, whose time is in the
    phase's numbers, not in its wall time); served as ``frontend_run``
    serves.  Checks: the launches (per prefill 320 ``lora_matmul`` and 96
    ``flash_attention``: 32 encoder, 32 causal decoder, 32 cross; per
    serve step 160 and none); prefill against its own serve step; the
    first 2 encoder and decoder layers on the card against the CPU port;
    ``lora_matmul`` at the five projections at M = 4, 2048 and 6000 and
    ``flash_attention`` non-causal over the 1500 frames (self and cross)
    and causal at the prompts, against their plain versions."""
    t_phase = time.perf_counter()
    cfg = started["cfg"]
    d, H, KH, D, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.n_frontend_tokens)
    B, S = SERVE_B, max(SERVE_PROMPTS)
    out = frontend_run(
        started, gen,
        [(f"whisper-{n}-M{M_}", M_, K, N, cfg.lora.rank)
         for n, (K, N) in projections(d, H, KH, D, cfg.d_ff).items()
         for M_ in (B, B * S, B * F)],
        [(f"whisper-encoder-{F}", B, F, H, KH, D, D, F, False)]
        + [(f"whisper-self-{P_}", B, P_, H, KH, D, D)
           for P_ in SERVE_PROMPTS]
        + [(f"whisper-cross-{P_}", B, P_, H, KH, D, D, F, False)
           for P_ in SERVE_PROMPTS], lora_iters=(20, 8), attn_iters=20)
    wall = time.perf_counter() - t_phase
    out["wall_s"] = wall
    print(f"phase 17: {frontend_text(out)}; phase {wall:.1f} s")
    check_frontend_run(WHISPER, cfg, out)
    return out


def qwen_vl_phase(gen, started: dict) -> dict:
    """Phase 18: ``qwen2-vl-72b`` at its published widths (d_model 8192,
    64/8 heads of 128, d_ff 29568, vocab 152064, M-RoPE sections (16,
    24, 24), 1024 stub patch embeddings), its depth cut from 80 layers to
    ``QWEN_VL_LAYERS``, the bfloat16 base as ``init_params`` draws it
    (``frontend_start``'s); served as ``frontend_run`` serves.  Checks:
    the launches (per prefill 5 ``lora_matmul`` and 1 ``flash_attention``
    over 1024 + P rows; per serve step 5 and none); prefill against its
    own serve step at position 1024 + P - 1; the card against the CPU
    port (one request); ``lora_matmul`` at the five projections at M = 4
    and 4 × (1024 + P) and ``flash_attention`` causal at D = 128 over
    1024 + P rows."""
    t_phase = time.perf_counter()
    cfg = started["cfg"]
    d, H, KH, D, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.n_frontend_tokens)
    B = SERVE_B
    # 10 to 140 ms a call at M = 4 × (1024 + P): few calls timed
    out = frontend_run(
        started, gen,
        [(f"qwen2-vl-{n}-M{M_}", M_, K, N, cfg.lora.rank)
         for n, (K, N) in projections(d, H, KH, D, cfg.d_ff).items()
         for M_ in (B,) + tuple(B * (F + P_) for P_ in SERVE_PROMPTS)],
        [(f"qwen2-vl-prefill-{F + P_}", B, F + P_, H, KH, D, D)
         for P_ in SERVE_PROMPTS], lora_iters=(2, 1), attn_iters=10)
    wall = time.perf_counter() - t_phase
    out["wall_s"] = wall
    print(f"phase 18: {frontend_text(out)}; phase {wall:.1f} s")
    check_frontend_run(QWEN_VL, cfg, out)
    return out


def frontend_phases(gen) -> tuple:
    """Phases 17 and 18, both models drawn first, so that whisper's CPU
    half runs beside qwen2-vl's draw and qwen2-vl's beside phase 17; each
    model is freed after its phase."""
    started = [frontend_start(n) for n in (WHISPER, QWEN_VL)]
    whisper = whisper_phase(gen, started.pop(0))
    return whisper, qwen_vl_phase(gen, started.pop(0))


# flash_attention_bwd at the other families' head dims, at the forward's
# shapes of phases 13-15: (name, B, S, H, KH, D, Dv)
OTHER_HEAD_DIM_SHAPES = (
    [(f"kimi-{S}", 4, S, 64, 8, 112, 112) for S in SERVE_PROMPTS]
    + [(f"minicpm-{S}", 4, S, 40, 40, 96, 64) for S in SERVE_PROMPTS]
    + [("stablelm-512", 4, 512, 32, 32, 80, 80),
       ("jamba-512", 4, 512, 64, 8, 128, 128)])


def attn_bwd_case(gen, B, S, H, KH, D, Dv, dt, causal=True, Sk=None,
                  window=0) -> dict:
    """One ``flash_attention_bwd`` call as the model's autograd makes it
    (a v narrower than q, and its output gradient, zero-padded to q's
    head dim), on random inputs of ``S`` query rows over ``Sk`` keys
    (``S`` by default), and its plain version, autograd of
    ``ref.flash_attention`` on the unpadded v: the error of the largest
    magnitude of dq, dk and dv (``rel_err``, floored at 0) and the two
    calls, for timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    Sk = Sk or S
    q = _randn(gen, (B, S, H, D), dtype=dt).requires_grad_()
    k = _randn(gen, (B, Sk, KH, D), dtype=dt).requires_grad_()
    v = _randn(gen, (B, Sk, KH, Dv), dtype=dt).requires_grad_()
    do = _randn(gen, (B, S, H, Dv), dtype=dt)
    with torch.no_grad():
        vp, dop = F.pad(v, (0, D - Dv)), F.pad(do, (0, D - Dv))
        out, lse = fa._forward(q, k, vp, causal, window, D ** -0.5)
    kern = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, vp, out, lse, dop, causal=causal, window=window)
    got = kern()
    y = ref.flash_attention(q, k, v, causal=causal, window=window)
    plain = lambda: torch.autograd.grad(  # noqa: E731
        y, (q, k, v), do, retain_graph=True)
    want = plain()
    err = max(rel_err(g[..., :w.shape[-1]], w, floor=0.0)
              for g, w in zip(got, want))
    return dict(err=err, kernel=kern, plain=plain, q=q, k=k, v=v, do=do)


def attn_bwd_times(gen) -> list:
    """``flash_attention_bwd`` at ``OTHER_HEAD_DIM_SHAPES`` (causal), bf16
    and float32 (``attn_bwd_case``): held to plain autograd (2e-2 / 2e-5
    of the largest magnitude) and timed in a host loop and a CUDA graph,
    beside its plain version (autograd of ``ref.flash_attention``),
    SDPA's backward (v as it is) and its bound (the bytes of the function
    at v's head dim, or its operations on the tensor cores at 989 bf16 /
    495 TF32 TFLOP/s with 3 products for float32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import counts
    rows = []
    for name, B, S, H, KH, D, Dv in OTHER_HEAD_DIM_SHAPES:
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            c = attn_bwd_case(gen, B, S, H, KH, D, Dv, dt)
            err = c["err"]
            check(err <= tol, f"flash_attention_bwd {name} {dt}: {err}")
            q, k, v, do = c["q"], c["k"], c["v"], c["do"]
            ys = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
            dos = do.transpose(1, 2)
            elem = 2 if dt == torch.bfloat16 else 4
            flops, nbytes = counts.attn_flops_bytes(B, S, H, KH, D, True,
                                                    elem, Dv=Dv)
            bms, by = (bound_ms(flops, nbytes, BF16_FLOPS_PER_S)
                       if dt == torch.bfloat16
                       else tc_bound_ms(3, flops, nbytes))
            t = dict(ms=cuda_ms(c["kernel"], iters=20),
                     graph_ms=graph_ms(c["kernel"], iters=5, replays=4),
                     plain_ms=cuda_ms(c["plain"], iters=5),
                     library_ms=cuda_ms(lambda: torch.autograd.grad(
                         ys, (q, k, v), dos, retain_graph=True), iters=20))
            rows.append(dict(shape=name, B=B, S=S, H=H, KH=KH, D=D, Dv=Dv,
                             dtype=str(dt).split(".")[1], rel_err=err, **t,
                             bound_ms=bms, bound_by=by))
            print(f"  flash_attention_bwd {name} (B={B} S={S} H={H} KH={KH}"
                  f" D={D} Dv={Dv} {str(dt).split('.')[1]}): loop "
                  f"{t['ms'] * 1e3:.2f} us, graph {t['graph_ms'] * 1e3:.2f} "
                  f"us, plain {t['plain_ms'] * 1e3:.1f} us, SDPA backward "
                  f"{t['library_ms'] * 1e3:.2f} us, bound "
                  f"{bms * 1e3:.2f} us ({by}); rel err {err:.3g}")
            del c, q, k, v, do, ys, dos
    return rows


# ---------------------------------------------------------------------------
# phase 19: LoRA fine-tuning of every family at its published widths
# ---------------------------------------------------------------------------
# the batch each drawn model trains on: B requests of S tokens of its
# serving prompts (the next tokens as labels), behind its frames or
# patches, in NM microbatches; TRAIN_STEPS steps a run
TRAIN_B, TRAIN_S, TRAIN_NM, TRAIN_STEPS = 4, 128, 2, 2
# the card's float32 step against the CPU port's on the CPU halves'
# shallow copies: the loss within 1e-5, AdamW's first moment within 1e-5
# of its largest magnitude (floored at 1), as tests/test_torch_*train*
TRAIN_CPU_TOL = 1e-5
# phase 19's kernel checks at the step's shapes (``train_kernel_checks``):
# the error of the largest magnitude of flash_attention_bwd's dq, dk, dv
# and of lora_matmul's dx against autograd of their plain versions, as
# the kernel phase and ``attn_bwd_times`` hold them (float32: 3xTF32
# sums in another order; bfloat16: the kernels round P, dS and their
# outputs to bfloat16, the plain versions only their outputs)
TRAIN_KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# n_microbatches=2 against 1 in bfloat16: the CPU port's own gap between
# the two on the -smoke families with no MoE (tests/
# test_torch_train_microbatch.py, B = 4, S = 16) is at most 5.9e-3 of the
# first moment's largest magnitude (each microbatch's dA, dB rounded to
# bfloat16 before the float32 sum), 2.6e-4 of the gradient norm and 7e-8
# of the loss.  On the card a microbatch's lora_matmul may also split its
# reduction otherwise than the whole batch's (ROADMAP §3, gap 1), so a
# bfloat16 activation or dx moves by a rounding that the CPU has not,
# and each layer of the backward carries it further: on the card
# (PERF.md, phase 19's runs) qwen2-vl's one layer parts by 2.8e-3 (first
# moment), 1.4e-6 (gradient norm), 0 (loss); jamba's two 5.5e-3, 2.8e-4,
# 2.8e-6; minicpm3-4b's 8 layers 1.95e-2, 1.4e-3, 3.5e-5; whisper's 32 +
# 32 layers 0.137, 2.2e-2, 3.5e-5.  The bounds: about twice whisper's in
# the gradient, 1e-3 relative in the loss.  A batch cut wrongly moves the
# loss by far more.  xlstm-125m is left out as MoE is: its sLSTM
# multiplies a rounding by about 1.3 a position (phase 16), so over 128
# tokens one split-plan rounding outgrows the gradient itself (call 2:
# 3.06 of the largest first moment, 1.2 of the norm, 6.5e-4 of the loss).
TRAIN_NM_TOL = dict(loss=1e-3, mu=0.25, grad_norm=0.05)
# the card-against-CPU step of a model with sLSTM layers takes the CPU
# half's first TRAIN_SLSTM_TOKENS tokens and is held to TRAIN_SLSTM_TOL:
# the sLSTM carries a rounding difference forward (phase 16) and the
# backward carries it back, so xlstm-125m's float32 first moment parted
# by 1.1e-3 at 32 tokens and 1.8e-5 at 8 (PERF.md, phase 19's runs),
# about 1.19 a position, with the loss equal; neither is a fault of
# either side.  The bound is about five times the gap at 8 tokens.
TRAIN_SLSTM_TOKENS, TRAIN_SLSTM_TOL = 8, 1e-4
# the same step of a model with sLSTM layers in bfloat16 (the card's
# base and its CPU half's), held to the CPU port's: the check of the
# bfloat16 training path that n_microbatches=2 against 1 gives the other
# models.  The card's kernels and the CPU's plain versions round their
# bfloat16 outputs alike but sum in other orders, so a logit or a
# gradient parts by a bfloat16 rounding or two (phase 16's bfloat16
# logits part by up to SERVE_CPU_TOL); a wrong gradient parts by its
# own size
TRAIN_BF16_TOL = dict(loss=1e-2, mu=5e-2)
# the train_lm entry point's run on the card
TRAIN_LM_ARGV = ["--full", "--arch", "xlstm-125m", "--steps", "3"]


def nm_comparable(cfg) -> bool:
    """Is ``cfg``'s bfloat16 step with 1 microbatch held to its step with
    2?  Not with a MoE layer (its capacity is a microbatch's) nor an
    sLSTM one (``TRAIN_NM_TOL``)."""
    return not has_moe(cfg) and not has_slstm(cfg)


def has_slstm(cfg) -> bool:
    return "slstm" in {m for m, _ in cfg.pattern}


def has_moe(cfg) -> bool:
    """Does a layer of ``cfg``'s pattern take the MoE block?  (A depth cut
    may leave ``cfg.moe`` set on a pattern without one: jamba's.)"""
    return any(ffn == "moe" for _, ffn in cfg.pattern)


def _layer_launches(cfg, mixer: str, ffn: str, live: bool, cross: bool,
                    cross_live: bool) -> tuple:
    """One layer's share of a pass: ``(adapted projections, those whose
    dx launches, attention forwards, attention backwards, live)``.
    ``live`` says whether the stream entering the layer depends on an
    adapter, and is returned for the stream leaving it.  A mixer's first
    projections read the normed stream, so their dx launches only when it
    is live; a later one reads an earlier one's output.  ``cross`` adds
    cross-attention after the mixer, over keys that depend on an adapter
    when ``cross_live`` (the encoder has adapters)."""
    t = set(cfg.lora.targets)
    firsts = {"attn": ("wq", "wkv"), "mla": ("wq_a", "wkv_a"),
              "mamba": ("in_proj",), "mlstm": ("up_proj",),
              "slstm": ("w_gates",)}[mixer]
    first = any(n in t for n in firsts)
    if mixer == "mla":
        chain = [("wq_a", live), ("wkv_a", live),
                 ("wq_b", live or "wq_a" in t),
                 ("wkv_b", live or "wkv_a" in t)]
        chain.append(("wo", live or any(n in t for n, _ in chain)))
    elif mixer == "mlstm":
        # wq, wk read the convolved up_proj output, wv up_proj's own
        chain = [("up_proj", live)] + [(n, live or first)
                                       for n in ("wq", "wk", "wv")]
        chain.append(("down_proj", live or any(n in t for n, _ in chain)))
    else:
        chain = [(n, live) for n in firsts]
        last = {"attn": "wo", "mamba": "out_proj"}.get(mixer)
        if last:
            chain.append((last, live or first))
    attn = bwd = 0
    if mixer in ("attn", "mla"):
        attn = 1
        bwd = int(live or any(n in t for n, _ in chain[:-1]))
    names = [(n, dx) for n, dx in chain if n in t]
    live = live or bool(names)
    if cross:
        attn += 1
        bwd += int(live or cross_live)
        live = live or cross_live
    pair = {"mlp": ("w_in", "w_out"),
            "moe": ("shared_w_in", "shared_w_out")}.get(ffn)
    if pair:
        ffn_names = [(n, dx) for n, dx in ((pair[0], live),
                                           (pair[1], live or pair[0] in t))
                     if n in t]
        names += ffn_names
        live = live or bool(ffn_names)
    return len(names), sum(dx for _, dx in names), attn, bwd, live


def train_launch_formula(cfg, nm: int, remat: bool = True,
                         keys: int = TRAIN_S) -> dict:
    """Launches of one ``make_train_step`` of ``nm`` microbatches: each
    runs every adapted projection forward, twice under remat (the
    forward, then the backward's recompute of its layer group), and its
    dx once where its input needs a gradient (``_layer_launches``: not
    where the input is the normed embedding or frames, or depends on no
    adapter yet); attention forward once a layer a pass (encoder,
    decoder, cross-attention), backward once where its q, k or v depends
    on an adapter, plus the backward's two side launches when it has
    more than 64 keys (every attention here: ``keys`` ≥ 128)."""
    fwd = 2 if remat else 1
    P = len(cfg.pattern)
    tot = [0, 0, 0, 0]

    def stack(n_layers: int, cross: bool, cross_live: bool) -> bool:
        live = False
        for i in range(n_layers):
            mixer, ffn = cfg.pattern[i % P]
            *n, live = _layer_launches(cfg, mixer, ffn, live, cross,
                                       cross_live)
            tot[:] = [a + b for a, b in zip(tot, n)]
        return live

    enc_live = False
    if cfg.encoder_decoder:
        enc_live = stack(cfg.n_encoder_layers, False, False)
    stack(cfg.n_layers, cfg.encoder_decoder, enc_live)
    proj, dx, attn, bwd = tot
    return {"lora_matmul": nm * (fwd * proj + dx),
            "flash_attention": nm * fwd * attn,
            "flash_attention_bwd": nm * bwd,
            "flash_attention_bwd_side": nm * 2 * bwd if keys > 64 else 0}


def train_bound(cfg, model, B: int, S: int, nm: int,
                expert_reads: int = 0, remat: bool = True) -> tuple:
    """The least time of one train step, ``(ms, "operations" or "bytes",
    flops, bytes)``: the larger of its operations on the bfloat16 tensor
    cores (989 TFLOP/s) and the weight bytes it must read over 3.35
    TB/s.  Operations (``models.counting``): 2 × the active parameters
    of the layers × the rows they see a pass, the decoder's ``B·S`` rows
    (``B·(F + S)`` behind a vision frontend), an encoder's ``B·F``; 4 ×
    the LM head × ``B·S`` (forward and dx, outside the remat groups); 2 ×
    ``proj_frontend`` × ``B·F``; the embedding is a gather, no product.
    Attention's own products are left out (the bound stays a bound).
    Bytes: each of ``nm`` microbatches reads the layers' weights once a
    pass, a MoE layer's routed experts only where its routing sent a
    token (``expert_reads`` expert matrices read in all, counted from
    the run's routing), and the head twice.  The passes: under
    ``remat`` three (forward, recompute, dx: 6 × N a row), the step as
    ``make_train_step`` runs it; without, two (forward and dx: 4 × N,
    the frozen base takes no weight gradient), which with ``nm`` = 1 is
    the bound of the function itself, whatever its implementation."""
    from repro_torch.models import counting
    from repro_torch.tree import tree_leaves
    params, _ = model
    passes = 3 if remat else 2
    d, V, F = cfg.d_model, cfg.vocab_size, cfg.n_frontend_tokens
    table = V * d
    act = counting.count_active_params(cfg) - table * (
        1 if cfg.tie_embeddings else 2)
    enc = 0
    if cfg.encoder_decoder:
        enc = counting._layer_params(cfg, "attn", "mlp")[1] \
            * cfg.n_encoder_layers + d
    front = d * d if cfg.frontend else 0
    dec = act - enc - front
    rows = B * (S + (F if cfg.frontend and not cfg.encoder_decoder
                     else 0))
    flops = (2 * passes * (dec * rows + enc * B * F) + 4 * table * B * S
             + 2 * front * B * F)

    def nbytes(tree, skip=()):
        return sum(t.numel() * t.element_size() for t in tree_leaves(
            [{k: v for k, v in lyr.items() if k not in skip}
             for lyr in tree]))
    experts = ("w_in", "w_out") if has_moe(cfg) else ()
    layer_bytes = nbytes(params["layers"], experts) + nbytes(
        params.get("enc_layers", []))
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    expert_bytes = 0
    if has_moe(cfg):
        w = next(lyr for lyr in params["layers"] if "router" in lyr)
        expert_bytes = sum(w[k][0].numel() * w[k].element_size()
                           for k in experts)
    total = (passes * nm * layer_bytes + 2 * nm * head.numel()
             * head.element_size() + expert_reads * expert_bytes)
    ms_f = flops / BF16_FLOPS_PER_S * 1e3
    ms_b = total / HBM_BYTES_PER_S * 1e3
    return (max(ms_f, ms_b), "operations" if ms_f >= ms_b else "bytes",
            flops, total)


def expert_hits(cfg, model, batch, nm: int) -> tuple:
    """Expert matrices a step of ``nm`` microbatches must read, from the
    run's routing (a no-grad forward of each microbatch, which routes as
    the step does): ``(the step's, the function's)``.  The step reads
    each MoE call's distinct kept experts three times a microbatch
    (forward, recompute, dx); the function reads every expert that any
    token of the batch was kept at twice (forward and dx)."""
    import torch
    from repro_torch.models import model as M
    if not has_moe(cfg):
        return 0, 0
    params, adapters = model
    hits, union = 0, {}
    for i in range(nm):
        mb = M.microbatch(batch, i, nm)
        with torch.no_grad(), moe_spy() as calls:
            M.forward(cfg, params, adapters, mb["tokens"],
                      frontend=mb.get("frontend"),
                      opts=M.FwdOptions(remat=False))
        for c, call in enumerate(calls):
            for j, r in enumerate(call["routing"]):
                kept = set(r.experts.reshape(-1)[r.keep].tolist())
                hits += len(kept)
                union.setdefault((c, j), set()).update(kept)
        del calls
    return 3 * hits, 2 * sum(len(u) for u in union.values())


def train_run(cfg, model, batch, nm: int, remat: bool, steps: int) -> dict:
    """``steps`` train steps from fresh AdamW state on the card: each
    step's seconds (host clock to a synchronise), launches and metrics,
    the first step's first moment, the peak bytes above what the card
    held before the run, and the final adapters and state."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    params, adapters = model
    step = M.make_train_step(cfg, n_microbatches=nm, lr=3e-3,
                             opts=M.FwdOptions(remat=remat))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a, opt = adapters, adamw.init(adapters, n_clients=1)
    out = dict(step_s=[], counts=[], metrics=[])
    for s in range(steps):
        zero_counters()
        t0 = time.perf_counter()
        a, opt, met = step(params, a, opt, batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["counts"].append(read_counters())
        out["metrics"].append(met)
        if s == 0:
            out["mu0"] = tree_map(torch.clone, opt.mu)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - held
    out["state"] = (a, opt)
    return out


def train_attn_shapes(cfg) -> list:
    """The attention calls of one microbatch of phase 19's step, one of
    each kind: ``(label, B, Sq, Sk, H, KH, D, Dv, causal, window)``: the
    decoder's causal self-attention (GQA, or MLA's q/k head dim over its
    v head dim) over the prompt and, behind a vision frontend, its
    patches; an encoder-decoder's non-causal encoder over its frames and
    cross-attention from the decoder's rows to them."""
    b, L = TRAIN_B // TRAIN_NM, TRAIN_S + patch_rows(cfg)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mixers, out = set(mixers_of(cfg)), []
    if "attn" in mixers:
        out.append(("self", b, L, L, H, KH, D, D, True,
                    cfg.sliding_window or 0))
    if "mla" in mixers:
        m = cfg.mla
        out.append(("mla", b, L, L, H, H, m.qk_nope_head_dim
                    + m.qk_rope_head_dim, m.v_head_dim, True, 0))
    if cfg.encoder_decoder:
        F = cfg.n_frontend_tokens
        out += [("encoder", b, F, F, H, KH, D, D, False, 0),
                ("cross", b, L, F, H, KH, D, D, False, 0)]
    return out


def train_lora_shapes(cfg, model) -> list:
    """The adapted projections of one microbatch of phase 19's step, one
    of each (stack, name, shape), from the model's adapters: ``(label,
    M, K, N, r)``, ``M`` the rows of a microbatch in that stack (the
    decoder's prompt, behind a vision frontend's patches; an encoder's
    frames)."""
    _, adapters = model
    b = TRAIN_B // TRAIN_NM
    stacks = ([("", adapters["layers"]), ("enc ", adapters["enc_layers"])]
              if cfg.encoder_decoder else [("", adapters)])
    rows = {"": b * (TRAIN_S + patch_rows(cfg)),
            "enc ": b * cfg.n_frontend_tokens}
    seen = {}
    for stack, layers in stacks:
        for lyr in layers:
            for key, a in lyr.items():
                if key.endswith("_lora_a"):
                    n = key[:-len("_lora_a")]
                    (K, r), N = a.shape[-2:], lyr[n + "_lora_b"].shape[-1]
                    seen.setdefault((stack, n, K, N),
                                    (stack + n, rows[stack], K, N, r))
    return list(seen.values())


def train_kernel_checks(cfg, model) -> list:
    """``flash_attention_bwd`` at each of ``train_attn_shapes`` (as
    ``attn_bwd_case`` calls it) and ``lora_matmul``'s dx at each of
    ``train_lora_shapes`` (through the wrapper's autograd, ``x`` alone
    needing a gradient), in bfloat16 and float32 on random inputs, each
    held to autograd of its plain version (``ref.flash_attention``,
    ``ref.lora_matmul``) by the error of the largest magnitude, and the
    kernel timed in a host loop (5 calls; the dx launch alone).  Returns
    one row a case; ``check_training`` holds them to
    ``TRAIN_KERNEL_TOL``."""
    import torch
    from repro_torch.kernels import counts, lora_matmul as lm, ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[1]
        for label, B, S, Sk, H, KH, D, Dv, causal, window in \
                train_attn_shapes(cfg):
            c = attn_bwd_case(gen, B, S, H, KH, D, Dv, dt, causal, Sk,
                              window)
            elem = 2 if dt == torch.bfloat16 else 4
            work = counts.attn_flops_bytes(B, S, H, KH, D, True, elem, Dv,
                                           Sk, causal, window)
            bms, by = (bound_ms(*work, BF16_FLOPS_PER_S) if elem == 2
                       else tc_bound_ms(3, *work))
            rows.append(dict(kernel="flash_attention_bwd", shape=label,
                             B=B, S=S, Sk=Sk, H=H, KH=KH, D=D, Dv=Dv,
                             causal=causal, dtype=dn, rel_err=c["err"],
                             ms=cuda_ms(c["kernel"], iters=5, warmup=1),
                             bound_ms=bms, bound_by=by,
                             library_ms=sdpa_bwd_ms(c, causal, window),
                             workspace=fa_workspace_check(B, S, Sk, H, D)))
            del c
        for label, M_, K, N, r in train_lora_shapes(cfg, model):
            x = _randn(gen, (1, M_, K), dtype=dt).requires_grad_()
            w = _randn(gen, (K, N), K ** -0.5, dt)
            a = _randn(gen, (1, K, r), K ** -0.5, dt)
            b = _randn(gen, (1, r, N), 0.1, dt)
            dy = _randn(gen, (1, M_, N), dtype=dt)
            got = torch.autograd.grad(lm.lora_matmul(x, w, a, b, 2.0), x,
                                      dy)[0]
            want = torch.autograd.grad(ref.lora_matmul(x, w, a, b, 2.0),
                                       x, dy)[0]
            dx = lambda: lm._launch(  # noqa: E731
                dy, w.t(), b.transpose(1, 2), a.transpose(1, 2), 2.0)
            lib = lambda: torch.baddbmm(  # noqa: E731
                torch.matmul(dy, w.t()), torch.bmm(dy, b.transpose(1, 2)),
                a.transpose(1, 2), alpha=2.0)
            elem = 2 if dt == torch.bfloat16 else 4
            work = counts.lora_flops_bytes(1, M_, N, K, r, elem)
            bms, by = (bound_ms(*work, BF16_FLOPS_PER_S) if elem == 2
                       else tc_bound_ms(3, *work))
            rows.append(dict(kernel="lora_matmul dx", shape=label, M=M_,
                             K=K, N=N, r=r, dtype=dn,
                             rel_err=rel_err(got, want, floor=0.0),
                             ms=cuda_ms(dx, iters=5, warmup=1),
                             bound_ms=bms, bound_by=by,
                             library_ms=cuda_ms(lib, iters=5, warmup=1),
                             workspace=lm_workspace_check(1, M_, K, N, r)))
            del x, w, a, b, dy, got, want
    torch.cuda.synchronize()
    return rows


def sdpa_bwd_ms(case: dict, causal: bool, window: int):
    """The library's time for the same backward: autograd of
    ``scaled_dot_product_attention`` (GQA) at the case's q, k, v and dO,
    v as it is (not padded to q's head dim), the forward taken once
    outside the timing; None for a sliding window (none of phase 19's
    models has one), which SDPA takes only as a dense mask."""
    import torch
    import torch.nn.functional as F
    q, k, v, do = case["q"], case["k"], case["v"], case["do"]
    if window:
        return None
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=5, warmup=1)


def lm_workspace_check(C, M, N, K, r) -> dict:
    """``lora_matmul``'s workspace at a launch (x ``(C, M, K)``, N output
    columns): the library's ``lm_workspace`` and the dry run's Python
    copy (``counts.lm_workspace``) at this card's SM count."""
    import torch
    from repro_torch.kernels import counts, lora_matmul as lm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(library=int(lm._library().lm_workspace(C, M, N, K, r)),
                python=counts.lm_workspace(C, M, N, K, r, sms))


def fa_workspace_check(B, S, Sk, H, D) -> dict:
    from repro_torch.kernels import counts, flash_attention as fa
    return dict(library=int(fa._library().fa_backward_workspace(
        B, S, Sk, H, D)), python=counts.fa_backward_workspace(
        B, S, Sk, H, D))


def i4_workspace_check(M, K, N, trans: bool) -> dict:
    import torch
    from repro_torch.kernels import counts, int4_matmul as i4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(library=int(i4._library().i4_workspace(M, K, N,
                                                       int(trans))),
                python=counts.i4_workspace(M, K, N, trans, sms))


def dryrun_model(name: str):
    """Phase 19's config of ``name`` (the cut depths of phases 13-18)."""
    import dataclasses
    from repro_torch.configs.registry import get
    if name == KIMI:
        return kimi_cfg()
    if name == MINICPM:
        return minicpm_cfg()
    if name == JAMBA:
        return dataclasses.replace(get(JAMBA), n_layers=len(JAMBA_PATTERN),
                                   pattern=JAMBA_PATTERN)
    if name in (WHISPER, QWEN_VL):
        return frontend_cfg(name)
    return get(name)


def dryrun_phase() -> dict:
    """Phase 20, on the CPU (a ``CpuJob``): the dry run's trace of each of
    phase 19's six models at phase 19's own step (bf16 base, float32
    adapters, ``TRAIN_B`` × ``TRAIN_S`` tokens behind any frontend,
    ``TRAIN_NM`` microbatches, remat) on a (1, 1) mesh, abstract: the
    arguments, the step's temporary peak, and the prediction of what
    phase 19 measures.  Phase 19's ``train_run`` counts the bytes above
    the drawn model over two steps from fresh AdamW state; its peak is
    in the second step, which holds beside the model the first step's
    adapters and AdamW state, the clone of the first moment it keeps,
    and the step's own temporaries.  So the prediction is the AdamW
    state (the step's arguments less the model and the batch, which the
    card already held), plus two adapter-sized float32 trees (the first
    step's adapters and the moment's clone), plus the trace's temporary
    peak."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(SIDE_CPU_THREADS)
    out = {}
    for name in (KIMI, MINICPM, JAMBA, XLSTM, WHISPER, QWEN_VL):
        cfg = dryrun_model(name)
        shape = InputShape("phase19", TRAIN_S, TRAIN_B, "train")
        with make_local_mesh() as mesh:
            tr = D.trace_step(cfg, shape, mesh, n_micro=TRAIN_NM)
        params, adapters = D.abstract_model(cfg)
        nbytes = lambda tree: sum(  # noqa: E731
            t.numel() * t.element_size() for t in tree_leaves(tree))
        model, adp = nbytes(params), nbytes(adapters)
        batch = nbytes(M.input_specs(cfg, shape))
        opt = tr["extra"]["argument_bytes"] - model - adp - batch
        out[name] = dict(argument_bytes=tr["extra"]["argument_bytes"],
                         temp_bytes=tr["peak"], model_bytes=model,
                         adapter_bytes=adp, opt_bytes=opt,
                         predicted=opt + 2 * adp + tr["peak"],
                         trace_s=tr["trace_s"])
    return out


def dryrun_compare(pred: dict, trained: dict) -> dict:
    """Phase 20 held to phase 19: each model's predicted peak within 10 %
    or 64 MiB (whichever is larger) of the peak phase 19 measured above
    the model (``torch.cuda.max_memory_allocated`` of its remat step)."""
    gib, out = 2 ** 30, {}
    for name, p in pred.items():
        got = trained[name]["training"]["peak_bytes"]["remat"]
        tol = max(0.10 * got, 64 * 2 ** 20)
        out[name] = dict(predicted=p["predicted"], measured=got,
                         ratio=p["predicted"] / max(1, got),
                         ok=abs(p["predicted"] - got) <= tol,
                         trace_s=p["trace_s"])
        print(f"phase 20 ({name}): predicted peak above the model "
              f"{p['predicted'] / gib:.3f} GiB (AdamW state "
              f"{p['opt_bytes'] / gib:.3f}, 2 x adapters "
              f"{2 * p['adapter_bytes'] / gib:.3f}, step temporaries "
              f"{p['temp_bytes'] / gib:.3f}; traced in "
              f"{p['trace_s']:.1f} s) against phase 19's measured "
              f"{got / gib:.3f} GiB (ratio {out[name]['ratio']:.3f})")
    for name, o in out.items():
        check(o["ok"], f"phase 20: {name}'s predicted peak "
              f"{o['predicted']} bytes is off phase 19's {o['measured']} "
              "by more than 10 % and 64 MiB")
    return out


def dryrun_checks(pred: dict, trained: dict) -> dict:
    """Phase 20's checks once phase 19 has run: ``dryrun_compare`` and
    the workspace planners (phase 19's kernel checks; ``int4_matmul`` NN
    and NT at phase 6's shapes)."""
    out = dryrun_compare(pred, trained)
    extra = [dict(kernel="int4_matmul", shape=f"{lab} {'NT' if t else 'NN'}",
                  workspace=i4_workspace_check(M, K, N, t))
             for lab, M, K, N in INT4_SHAPES for t in (False, True)]
    n = check_workspaces([r for d in trained.values()
                          for r in d["training"]["kernel_checks"]], extra)
    print(f"phase 20: {n} workspace plans (lora_matmul dx and "
          "flash_attention_bwd at phase 19's step shapes, int4_matmul at "
          "phase 6's) equal in the Python copies and the libraries")
    return dict(peaks=out, workspace_plans=n)


def check_workspaces(rows, extra) -> int:
    """Every Python workspace planner equal to its library: the rows of
    ``train_kernel_checks`` and ``extra``; returns how many were held."""
    n = 0
    for r in list(rows) + list(extra):
        w = r["workspace"]
        check(w["library"] == w["python"], f"workspace planner of "
              f"{r.get('kernel')} at {r.get('shape')}: library "
              f"{w['library']}, Python copy {w['python']}")
        n += 1
    return n


def kernel_checks_text(rows) -> str:
    worst = {}
    for r in rows:
        k = (r["kernel"], r["dtype"])
        worst[k] = max(worst.get(k, 0.0), r["rel_err"])
    return (f"{len(rows)} cases at the step's shapes against autograd of "
            "the plain versions, largest error of the largest magnitude: "
            + ", ".join(f"{k} {d} {v:.3g} (tolerance "
                        f"{TRAIN_KERNEL_TOL[d]})"
                        for (k, d), v in sorted(worst.items())))


def train_family(name: str, cfg, model, prompts, frames=None) -> dict:
    """Phase 19 on a drawn model (a bf16 base, float32 adapters with
    ``lora_b`` + 0.01): ``train_kernel_checks`` at the step's shapes;
    ``TRAIN_B`` requests of ``TRAIN_S`` tokens (behind the frames or
    patches, in bfloat16), ``make_train_step(n_microbatches=TRAIN_NM)``
    for ``TRAIN_STEPS`` steps under remat and without;
    ``n_microbatches=1`` for one step (not for a MoE config, whose
    capacity is a microbatch's); the launches of each against
    ``train_launch_formula``; the warm step's time beside ``train_bound``
    of the remat step and of the function.  Returns the numbers;
    ``check_training`` holds them."""
    import torch
    from repro_torch.tree import tree_leaves, tree_map
    t0 = time.perf_counter()
    gc.collect()
    checks = train_kernel_checks(cfg, model)
    for r in checks:
        lib = r["library_ms"]
        print(f"phase 19 ({name}) {r['kernel']} {r['shape']} {r['dtype']}: "
              f"{r['ms'] * 1e3:.1f} us (host loop of 5), bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, library "
              + ("none" if lib is None else f"{lib * 1e3:.1f} us"))
    B, S = TRAIN_B, TRAIN_S
    params, adapters = model
    model1 = (params, tree_map(lambda t: t[None], adapters))
    batch = {"tokens": prompts[None, :B, :S],
             "labels": prompts[None, :B, 1:S + 1]}
    if frames is not None:
        batch["frontend"] = frames[None, :B].to(torch.bfloat16)
    runs = {"remat": train_run(cfg, model1, batch, TRAIN_NM, True,
                               TRAIN_STEPS),
            "plain": train_run(cfg, model1, batch, TRAIN_NM, False,
                               TRAIN_STEPS)}
    if nm_comparable(cfg):
        runs["nm1"] = train_run(cfg, model1, batch, 1, True, 1)
    r, p = runs["remat"], runs["plain"]
    bitwise = all(torch.equal(x[k], y[k]) for x, y in zip(
        r["metrics"], p["metrics"]) for k in ("loss", "grad_norm"))
    ra, ro = r["state"]
    pa, po = p["state"]
    bitwise = bitwise and all(torch.equal(x, y) for x, y in zip(
        tree_leaves((ra, ro.mu, ro.nu)), tree_leaves((pa, po.mu, po.nu))))
    nm_gap = None
    if "nm1" in runs:
        one = runs["nm1"]
        mu2, mu1 = tree_leaves(r["mu0"]), tree_leaves(one["mu0"])
        top = max(float(t.abs().max()) for t in mu1)
        l2 = float(r["metrics"][0]["loss"][0])
        l1 = float(one["metrics"][0]["loss"][0])
        g2 = float(r["metrics"][0]["grad_norm"][0])
        g1 = float(one["metrics"][0]["grad_norm"][0])
        nm_gap = dict(loss=abs(l2 - l1) / abs(l1),
                      mu=max(float((x - y).abs().max())
                             for x, y in zip(mu2, mu1)) / top,
                      grad_norm=abs(g2 - g1) / g1)
    reads, fn_reads = expert_hits(cfg, model1, batch, TRAIN_NM)
    bms, by, flops, nbytes = train_bound(cfg, model, B, S, TRAIN_NM, reads)
    fms, fby, fflops, fbytes = train_bound(cfg, model, B, S, 1, fn_reads,
                                           remat=False)
    want = {k: train_launch_formula(cfg, nm, remat) for k, nm, remat in (
        ("remat", TRAIN_NM, True), ("plain", TRAIN_NM, False),
        ("nm1", 1, True))}
    losses = [float(m["loss"][0]) for m in r["metrics"]]
    warm = r["step_s"][-1] * 1e3
    out = dict(
        B=B, S=S, F=cfg.n_frontend_tokens if frames is not None else 0,
        nm=TRAIN_NM, bitwise_remat=bitwise, nm_gap=nm_gap,
        losses=losses, grad_norms=[float(m["grad_norm"][0])
                                   for m in r["metrics"]],
        finite=all(math.isfinite(x) for x in losses),
        step_s={k: v["step_s"] for k, v in runs.items()},
        peak_bytes={k: v["peak_bytes"] for k, v in runs.items()},
        launches={k: {n: v["counts"][0][n] for n in want[k]}
                  for k, v in runs.items()},
        want={k: want[k] for k in runs},
        bound_ms=bms, bound_by=by, flops=flops, bound_bytes=nbytes,
        expert_reads=reads, ratio=warm / bms,
        function_bound_ms=fms, function_bound_by=fby,
        function_flops=fflops, function_bound_bytes=fbytes,
        function_expert_reads=fn_reads, function_ratio=warm / fms,
        kernel_checks=checks, seconds=time.perf_counter() - t0)
    gib = 2 ** 30
    print(f"phase 19 ({name}, bf16 base, float32 adapters, B={B}, S={S}"
          + (f" behind {cfg.n_frontend_tokens} {cfg.frontend} embeddings"
             if frames is not None else "")
          + f", {TRAIN_NM} microbatches): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step "
          f"{warm:.1f} ms warm under remat, {out['function_ratio']:.1f}x "
          f"the function's bound {fms:.2f} ms (by {fby}: "
          f"{fflops / 1e12:.2f} TFLOP, {fbytes / 1e9:.2f} GB), "
          f"{out['ratio']:.1f}x the remat step's {bms:.2f} ms (by {by}: "
          f"{flops / 1e12:.2f} TFLOP, {nbytes / 1e9:.2f} GB); "
          f"{p['step_s'][-1] * 1e3:.1f} ms plain; peak above the held "
          f"model {r['peak_bytes'] / gib:.3f} GiB under remat, "
          f"{p['peak_bytes'] / gib:.3f} GiB plain (ratio "
          f"{r['peak_bytes'] / max(1, p['peak_bytes']):.3f}); remat "
          f"bitwise the plain step: {bitwise}; n_microbatches=2 against 1 "
          + ("(left out: a MoE capacity is a microbatch's; an sLSTM "
             "outgrows a rounding)" if nm_gap is None
             else ", ".join(f"{k} {v:.3g}" for k, v in nm_gap.items()))
          + "; launches a step under remat "
          + json.dumps(out["launches"]["remat"]) + "; step seconds "
          + json.dumps({k: [round(x, 4) for x in v]
                        for k, v in out["step_s"].items()})
          + f"; kernels: {kernel_checks_text(checks)}"
          + f"; phase {out['seconds']:.1f} s")
    del runs, model1
    return out


def train_half_step(cfg, model, tokens, labels, frontend=None) -> dict:
    """One ``make_train_step`` on ``model``'s weights (float32 here) of
    ``tokens``/``labels`` ``(B, S)`` (behind ``frontend`` ``(B, F, d)``),
    one client, ``n_microbatches`` 2 when ``B`` is even, else 1 (a model
    with sLSTM layers on its first ``TRAIN_SLSTM_TOKENS`` tokens): the loss,
    the gradient norm and AdamW's first moment, on the CPU.  On the card
    it runs under remat; on the CPU without, which
    ``tests/test_torch_train_step.py`` holds bitwise to remat, so the CPU
    half saves a recompute."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    if has_slstm(cfg):
        tokens = tokens[:, :TRAIN_SLSTM_TOKENS]
        labels = labels[:, :TRAIN_SLSTM_TOKENS]
    params, adapters = model
    adp = tree_map(lambda t: t[None], adapters)
    batch = {"tokens": tokens[None], "labels": labels[None]}
    if frontend is not None:
        batch["frontend"] = frontend[None]
    nm = 2 if tokens.shape[0] % 2 == 0 else 1
    step = M.make_train_step(cfg, n_microbatches=nm, lr=3e-3,
                             opts=M.FwdOptions(remat=tokens.is_cuda))
    with torch.enable_grad():
        _, opt, met = step(params, adp, adamw.init(adp, n_clients=1), batch)
    return dict(nm=nm, loss=float(met["loss"][0]),
                grad_norm=float(met["grad_norm"][0]),
                mu=tree_map(lambda t: t[0].float().cpu(), opt.mu),
                seconds=time.perf_counter() - t0)


def train_half(cfg, model, tokens, labels, dtype, frontend=None) -> dict:
    """Phase 19's part of a CPU comparison on ``model`` in ``dtype`` (its
    float32 copy, or its bfloat16 base): ``train_half_step`` as
    ``{"train": ...}`` in float32, ``{"train_bf16": ...}`` in bfloat16
    for a model with sLSTM layers (``TRAIN_BF16_TOL``), else nothing.
    ``family_half`` and ``frontend_half`` call it on the card and, in a
    process of their own, on the CPU."""
    import torch
    if dtype == torch.float32:
        return {"train": train_half_step(cfg, model, tokens, labels,
                                         frontend)}
    if not has_slstm(cfg):
        return {}
    return {"train_bf16": train_half_step(
        cfg, model, tokens, labels,
        None if frontend is None else frontend.to(dtype))}


def train_half_errs(card: dict, cpu: dict) -> dict:
    """The card's ``train_half_step`` against the CPU port's: the loss's
    gap, and the first moment's largest gap over its largest magnitude
    (floored at 1)."""
    from repro_torch.tree import tree_leaves
    g, w = tree_leaves(card["mu"]), tree_leaves(cpu["mu"])
    check(len(g) == len(w), "the card's and the CPU's adapters differ")
    scale = max(1.0, max(float(t.abs().max()) for t in w))
    return dict(nm=card["nm"], loss=abs(card["loss"] - cpu["loss"]),
                mu=max(float((a - b).abs().max()) for a, b in zip(g, w))
                / scale, cpu_s=cpu["seconds"], card_s=card["seconds"])


def train_half_compare(card: dict, cpu: dict) -> dict:
    """The card's float32 ``train_half_step`` against the CPU port's
    (``train_half_errs``), and for a model with sLSTM layers its
    bfloat16 one's under ``"bf16"``."""
    out = train_half_errs(card["train"], cpu["train"])
    if "train_bf16" in card:
        out["bf16"] = train_half_errs(card["train_bf16"], cpu["train_bf16"])
    return out


def check_training(name: str, cfg, out: dict, half: dict = None):
    """Phase 19's checks on ``train_family``'s numbers (and the CPU
    comparison's, ``half``)."""
    check(out["finite"], f"{name} phase 19: a loss is not finite")
    for row in out["kernel_checks"]:
        check(row["rel_err"] <= TRAIN_KERNEL_TOL[row["dtype"]],
              f"{name} phase 19: {row['kernel']} {row['shape']} "
              f"{row['dtype']} against its plain version: {row}")
    check(out["bitwise_remat"], f"{name} phase 19: the rematerialised "
          "step is not bitwise the plain one")
    for k, got in out["launches"].items():
        check(got == out["want"][k], f"{name} phase 19 {k}: launches "
              f"{got}, want {out['want'][k]}")
    if out["nm_gap"] is not None:
        for k, v in out["nm_gap"].items():
            check(v <= TRAIN_NM_TOL[k], f"{name} phase 19: "
                  f"n_microbatches=2 against 1, {k} {v} > "
                  f"{TRAIN_NM_TOL[k]}")
    if cfg.encoder_decoder:
        pk = out["peak_bytes"]
        check(pk["remat"] <= 0.5 * pk["plain"], f"{name} phase 19: peak "
              f"{pk['remat']} bytes under remat, over half of "
              f"{pk['plain']} without")
    if half is not None:
        tol = train_cpu_tol(cfg)
        check(half["loss"] <= tol and half["mu"] <= tol,
              f"{name} phase 19: the card's float32 step against the CPU "
              f"port's: loss {half['loss']}, first moment {half['mu']} "
              f"(tolerance {tol})")
        if "bf16" in half:
            h = half["bf16"]
            check(h["loss"] <= TRAIN_BF16_TOL["loss"]
                  and h["mu"] <= TRAIN_BF16_TOL["mu"],
                  f"{name} phase 19: the card's bfloat16 step against the "
                  f"CPU port's: loss {h['loss']}, first moment {h['mu']} "
                  f"(tolerances {TRAIN_BF16_TOL})")


def train_cpu_tol(cfg) -> float:
    """The card-against-CPU bound of ``cfg``'s float32 step."""
    return TRAIN_SLSTM_TOL if has_slstm(cfg) else TRAIN_CPU_TOL


def training_text(half: dict, cfg) -> str:
    h = half.get("bf16")
    return (f"phase 19: the card's float32 step ({half['nm']} "
            f"microbatch(es)) against the CPU port's on the CPU half's "
            f"model: loss {half['loss']:.3g}, first moment "
            f"{half['mu']:.3g} of its largest (tolerance "
            f"{train_cpu_tol(cfg)}); CPU step {half['cpu_s']:.1f} s"
            + ("" if h is None else
               f"; its bfloat16 step: loss {h['loss']:.3g}, first moment "
               f"{h['mu']:.3g} of its largest (tolerances "
               f"{TRAIN_BF16_TOL}); CPU step {h['cpu_s']:.1f} s"))


def train_lm_phase() -> dict:
    """Phase 19's entry point: ``repro_torch.launch.train_lm.main(
    TRAIN_LM_ARGV)`` on the card: xlstm-125m's 12 layers at its published
    widths, the example's 8 × 128 tokens in 2 microbatches, remat.
    Checks: every loss and gradient norm finite, the first loss within
    one nat of ln(vocab) (an untrained model's).  At these widths the
    example does not memorise its document in a few steps: the sLSTM's
    gradient norms reach 1e5, and the JAX package's own run
    (``examples/train_lm.py --full --steps 8`` on the CPU) ends above
    its first loss (PERF.md); at ``-smoke`` width the port's
    losses fall (``tests/test_torch_train_lm.py``)."""
    import torch
    from repro_torch.configs.registry import get as get_config
    from repro_torch.launch import train_lm
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    res = train_lm.main(TRAIN_LM_ARGV)
    wall = time.perf_counter() - t0
    res.update(peak_gib=(torch.cuda.max_memory_allocated() - held) / 2 ** 30,
               wall_s=wall, counts=read_counters())
    print(f"phase 19 (train_lm {' '.join(TRAIN_LM_ARGV)}): losses "
          f"{', '.join(f'{x:.4f}' for x in res['losses'])}; steps "
          f"{', '.join(f'{x:.3f}' for x in res['step_s'])} s; "
          f"{res['tokens_per_s']:.0f} tokens/s; peak "
          f"{res['peak_gib']:.3f} GiB above what the card held; launches "
          f"{json.dumps({k: v for k, v in res['counts'].items() if v})}; "
          f"{wall:.1f} s with the draw")
    check(all(math.isfinite(x) for x in res["losses"] + res["grad_norms"]),
          "train_lm: a loss or gradient norm is not finite")
    untrained = math.log(get_config(XLSTM).vocab_size)
    check(abs(res["losses"][0] - untrained) <= 1.0, "train_lm: the first "
          f"loss {res['losses'][0]} is not near ln(vocab) = {untrained}")
    return res


def side_training() -> dict:
    """Phase 19's xlstm-125m work, in a process of its own on the card
    beside phase 7 (the whole smoke): ``train_family`` on xlstm-125m drawn
    as phase 16 draws it (``draw_family``, the same seed and prompts;
    0.125 B values), then ``train_lm_phase``.  Its 128-step loops hold
    the host for about a minute in all, which phase 7's host loops can
    share, so its step times are taken under contention with phase 7's
    (``--training`` times them alone); phase 16 compares the card's
    float32 and bfloat16 steps with the CPU port's itself."""
    from repro_torch.configs.registry import get
    cfg = get(XLSTM)
    model, prompts = draw_family(cfg)[0], serve_prompts(cfg)
    xlstm = train_family(XLSTM, cfg, model, prompts)
    del model, prompts
    return {XLSTM: xlstm, "train_lm": train_lm_phase()}


def training_phase() -> dict:
    """Phase 19 alone (``--training``): each of the six models drawn, and
    its CPU half started, by its serving phase's own start function
    (``kimi_start``, ``minicpm_start``, ``jamba_start``, ``xlstm_start``,
    ``frontend_start``: the CPU halves serve as well as train, as in the
    whole run), ``train_family`` on it, then the card's ``train_half`` of
    the CPU half's model against the CPU's (none for kimi-k2, whose
    phase has no CPU half), the model freed; the checks once all six
    have run (so one miss shows every model's numbers); then
    ``train_lm_phase``."""
    import torch
    from repro_torch.tree import tree_map
    dry_job = CpuJob("phase 20's dry run (cpu, abstract)", dryrun_phase)
    out = {}
    for start in (kimi_start, lambda: minicpm_start(minicpm_cfg()),
                  jamba_start, xlstm_start,
                  lambda: frontend_start(WHISPER),
                  lambda: frontend_start(QWEN_VL)):
        st = start()
        cfg = st["cfg"]
        training = train_family(cfg.name, cfg, st["model"], st["prompts"],
                                st.get("frames"))
        if "half" in st:
            hcfg, hmodel, tokens, labels, fe = st["half"]
            card = {}
            for dt, m in ((torch.bfloat16, hmodel),
                          (torch.float32, tree_map(lambda t: t.float(),
                                                   hmodel))):
                card.update(train_half(hcfg, m, tokens, labels, dt, fe))
            training["cpu_compare"] = train_half_compare(
                card, host_tree(st["job"].result(), False))
            print(training_text(training["cpu_compare"], cfg))
            del card, m, hmodel
        out[cfg.name] = (cfg, training)
        del st
        gc.collect()
        torch.cuda.empty_cache()
    for name, (cfg, training) in out.items():
        check_training(name, cfg, training, training.get("cpu_compare"))
    out["dryrun"] = dryrun_checks(dry_job.result(), {
        n: {"training": t} for n, (_, t) in out.items()})
    out["train_lm"] = train_lm_phase()
    return out


def profile_serving(cfg, model, run: dict):
    """Device busy time and idle share of 4 warm serve steps (greedy)
    after a prefill's cache, traced by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    serve = M.make_serve_step(cfg)
    P = run["caches"][0][0].shape[1]
    cache = decode_cache(cfg, run["caches"], 8, "cuda")
    tok = torch.argmax(run["logits"], -1)[:, None]
    logits, cache = serve(*model, cache, tok, P)                 # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, 5):
            logits, cache = serve(*model, cache,
                                  torch.argmax(logits, -1)[:, None], P + s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_profile(prof, "serve steps", wall, f"4 greedy serve steps of "
                  f"{SERVE_MODEL} after a {P}-token prefill, B={SERVE_B}")


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


def stamp(t_start: float, what: str):
    """The smoke's elapsed seconds as ``what`` begins."""
    print(f"[{time.perf_counter() - t_start:.1f} s] {what}")


def main(argv) -> int:
    t_start = time.perf_counter()
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
    if argv == ["--serving"]:
        build_kernels()
        serving_kernel_times(torch.Generator(device="cuda").manual_seed(1))
        serving_compare(serving_phase(profile=True))
        return 0
    if argv == ["--families"]:
        build_kernels()
        gen = torch.Generator(device="cuda").manual_seed(1)
        kimi_phase(gen)
        minicpm_phase(gen)
        stablelm_phase(gen)
        return 0
    if argv == ["--recurrent"]:
        build_kernels()
        gen = torch.Generator(device="cuda").manual_seed(1)
        started = xlstm_start()
        jamba_phase(gen)
        xlstm_phase(gen, started)
        return 0
    if argv == ["--frontends"]:
        build_kernels()
        gen = torch.Generator(device="cuda").manual_seed(1)
        frontend_phases(gen)
        attn_bwd_times(gen)
        return 0
    if argv == ["--training"]:
        build_kernels()
        training_phase()
        return 0
    check(not argv, f"unknown arguments {argv}; use --profile, --attn, "
          "--sharded, --serving, --families, --recurrent, --frontends, "
          "--training or none")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    builds = build_kernels()
    # phase 9b's CPU runs need nothing of the card: they start now, beside
    # every card phase, and are held at the comparisons
    cli_job = cli_cpu_job()

    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import statevector_gates as svg
    from repro_torch.kernels import statevector_tape as svt
    from repro_torch.kernels import trunc_normal as tn
    from repro_torch.kernels import xla_sincos as xs
    stamp(t_start, "the kernel phases")
    max_err, gate_share, shapes = kernel_phase()
    tape_err, tape_share, tape_shapes = tape_phase(shapes)
    trig = trig_phase(torch.Generator(device="cuda").manual_seed(3))
    gen = torch.Generator(device="cuda").manual_seed(1)
    lm_err, lm_shapes = lora_phase(gen)
    fa_err, fa_bwd_err, fa_shapes, fa_bwd_shapes, fa_probe = \
        attn_phase(gen)
    i4_err, i4_t_err, i4_shapes, i4_t_shapes = int4_phase(gen)
    waves = wave_probe(gen)
    kl_err, kl_shapes = kl_phase(gen)
    draw_rows = draw_phase()
    stamp(t_start, "phase 3")
    qfl = main_phase()
    size_rule = size_rule_phase()
    llm = llm_phase()
    stamp(t_start, "phase 10")
    fused = fused_phase(qfl, llm)
    sharded = sharded_phase(qfl, llm, fused)
    # phase 19's xlstm-125m training and its train_lm entry point run on
    # the card in a process of their own beside phase 7, whose host loops
    # leave the card idle
    side_job = CpuJob("phase 19's xlstm-125m and train_lm (on the card, "
                      "beside phase 7)", side_training)
    stamp(t_start, "phase 7")
    seq = sequential_phase()
    stamp(t_start, "phase 5")
    nwq = wide_phase()
    llm_wide = llm_wide_phase()
    seq_wide = llm_wide_sequential_phase()
    stamp(t_start, "phase 6")
    ql = qlora_phase()
    ql_wide = llm_wide_phase(quantized=True)
    stamp(t_start, "phase 9")
    shots = sample_phase()
    cli = cli_phase(cli_job)
    stamp(t_start, "phase 9c")
    gpt2 = gpt2_phase()
    deepseek = llm_wide_sequential_phase("deepseek-llm-7b-base",
                                         DEEPSEEK_TASK, "deepseek sequential",
                                         DEEPSEEK_LAYERS)
    serve_times = serving_kernel_times(gen)
    stamp(t_start, "phase 12")
    serving = serving_phase()
    big = serving["runs"][max(SERVE_PROMPTS)]
    # free what earlier phases hold on the card before the largest models
    # (the runs' results stay for the comparisons)
    llm.pop("llm_outputs", None)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 13: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          "GiB held on the card")
    # phase 20's trace on the CPU, beside kimi-k2's draw on the card (the
    # host loops of phases 4-9 are the critical path, and CPU-bound)
    dry_job = CpuJob("phase 20's dry run (cpu, abstract)", dryrun_phase)
    stamp(t_start, "phase 13")
    kimi = kimi_phase(gen)
    # each later model is drawn, and its CPU half started, while an
    # earlier phase waits for its own CPU half: phases 17-18's during
    # phase 14's wait, phases 15-16's before phase 17
    started = {}

    def draw_frontends():
        started.update((n, frontend_start(n)) for n in (WHISPER, QWEN_VL))
        stamp(t_start, "phases 17-18 drawn")
    stamp(t_start, "phase 14")
    minicpm = minicpm_phase(gen, MINICPM_SMOKE_LAYERS, idle=draw_frontends)
    stablelm = stablelm_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    started[XLSTM], started[JAMBA] = xlstm_start(), jamba_start()
    stamp(t_start, "phase 17")
    whisper = whisper_phase(gen, started.pop(WHISPER))
    qwen_vl = qwen_vl_phase(gen, started.pop(QWEN_VL))
    gc.collect()
    torch.cuda.empty_cache()
    stamp(t_start, "phase 15")
    jamba = jamba_phase(gen, started.pop(JAMBA))
    side = side_job.result()
    xlstm_ = xlstm_phase(gen, started.pop(XLSTM), side[XLSTM])
    train_lm_run = side["train_lm"]
    stamp(t_start, "the comparisons")
    main_compare(qfl, fused)
    llm_rounds(llm)
    gpt2_compare(gpt2)
    sequential_compare(seq)
    qlora_compare(ql)
    cli = cli_compare(cli)
    serving = serving_compare(serving)
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
    trained = {KIMI: kimi, MINICPM: minicpm, JAMBA: jamba, XLSTM: xlstm_,
               WHISPER: whisper, QWEN_VL: qwen_vl}
    stamp(t_start, "phase 20")
    dryrun = dryrun_checks(dry_job.result(), trained)

    def launches_training(kernel: str) -> dict:
        """Phase 19's launches of one train step under remat, a model,
        and of the train_lm run (all its steps)."""
        out = {n: d["training"]["launches"]["remat"][kernel]
               for n, d in trained.items()}
        out["train_lm"] = train_lm_run["counts"][kernel]
        return out

    def training_checks(kernel: str) -> dict:
        """Phase 19's checks of ``kernel`` at each model's step shapes
        (``train_kernel_checks``): their errors and host-loop times."""
        return {n: [{k: v for k, v in r.items() if k != "kernel"}
                    for r in d["training"]["kernel_checks"]
                    if r["kernel"] == kernel]
                for n, d in trained.items()}
    training_shapes = dict(
        B=TRAIN_B, S=TRAIN_S, n_microbatches=TRAIN_NM, steps=TRAIN_STEPS,
        frontend_rows={n: trained[n]["training"]["B"]
                       * trained[n]["training"]["F"]
                       for n in (WHISPER, QWEN_VL)},
        train_lm=" ".join(TRAIN_LM_ARGV))
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
             launches_serving=serving_counts(big, "lora_matmul"),
             serving=serve_times["lora_matmul"],
             launches_kimi=serving_counts(kimi["runs"][max(SERVE_PROMPTS)],
                                          "lora_matmul"),
             kimi=kimi["kernel_times"]["lora_matmul"],
             launches_minicpm=serving_counts(
                 minicpm["runs"][max(SERVE_PROMPTS)], "lora_matmul"),
             minicpm=minicpm["kernel_times"]["lora_matmul"],
             launches_jamba=serving_counts(
                 jamba["runs"][max(SERVE_PROMPTS)], "lora_matmul"),
             jamba=jamba["kernel_times"]["lora_matmul"],
             launches_xlstm=serving_counts(
                 xlstm_["runs"][max(SERVE_PROMPTS)], "lora_matmul"),
             xlstm=xlstm_["kernel_times"]["lora_matmul"],
             launches_whisper=serving_counts(
                 whisper["runs"][max(SERVE_PROMPTS)], "lora_matmul"),
             whisper=whisper["kernel_times"]["lora_matmul"],
             launches_qwen2_vl=serving_counts(
                 qwen_vl["runs"][max(SERVE_PROMPTS)], "lora_matmul"),
             qwen2_vl=qwen_vl["kernel_times"]["lora_matmul"],
             launches_training=launches_training("lora_matmul"),
             training_shapes=training_shapes,
             training_dx_checks=training_checks("lora_matmul dx"),
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
             launches_serving=serving_counts(big, "flash_attention"),
             serving=serve_times["flash_attention"],
             launches_kimi=serving_counts(kimi["runs"][max(SERVE_PROMPTS)],
                                          "flash_attention"),
             kimi=kimi["kernel_times"]["flash_attention"],
             launches_minicpm=serving_counts(
                 minicpm["runs"][max(SERVE_PROMPTS)], "flash_attention"),
             minicpm=minicpm["kernel_times"]["flash_attention"],
             launches_stablelm=stablelm["launches"],
             stablelm=stablelm["kernel_times"]["flash_attention"],
             launches_jamba=serving_counts(
                 jamba["runs"][max(SERVE_PROMPTS)], "flash_attention"),
             jamba=jamba["kernel_times"]["flash_attention"],
             launches_xlstm=serving_counts(
                 xlstm_["runs"][max(SERVE_PROMPTS)], "flash_attention"),
             launches_whisper=serving_counts(
                 whisper["runs"][max(SERVE_PROMPTS)], "flash_attention"),
             whisper=whisper["kernel_times"]["flash_attention"],
             launches_qwen2_vl=serving_counts(
                 qwen_vl["runs"][max(SERVE_PROMPTS)], "flash_attention"),
             qwen2_vl=qwen_vl["kernel_times"]["flash_attention"],
             launches_training=launches_training("flash_attention"),
             training_shapes=training_shapes,
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
             launches_training=launches_training("flash_attention_bwd"),
             side_launches_training=launches_training(
                 "flash_attention_bwd_side"),
             training_shapes=training_shapes,
             training_checks=training_checks("flash_attention_bwd"),
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
             on_main_path=False, shapes=kl_shapes),
        dict(name=xs.NAME, route="cuda", source=xs.SOURCE,
             replaces=xs.REPLACES, launches=seq["trig_launches"],
             path="phase 7's sequential QFL run (the eager circuit's "
                  "gates); the batched tape takes the device function",
             max_abs_err=0.0, **headline(trig["shapes"], "n=50"),
             launches_batched=n0["xla_sincos"],
             on_main_path=seq["trig_launches"] > 0,
             bitwise_tape_angles=trig["differ"], shapes=trig["shapes"],
             **build_summary(builds["xla_sincos"])),
        dict(name=tn.NAME, route="cuda", source=tn.SOURCE,
             replaces=tn.REPLACES, launches=n["trunc_normal"],
             path="init_params on the card, one launch a base leaf: "
                  "launches from phase 4's LLM-QFL run (tiny-llm's base)",
             max_abs_err=0.0, **headline(draw_rows, draw_rows[0]["shape"]),
             launches_kimi=kimi["draw_launches"],
             kimi_draw_s=kimi["init_s"], on_main_path=n["trunc_normal"] > 0,
             bitwise_cases=[dict(n=c[0], dtype=c[1], start=c[2])
                            for c in DRAW_CASES], shapes=draw_rows,
             **build_summary(builds["trunc_normal"]))]
    print(json.dumps({"dryrun": dryrun,
                      "qfl": {k: qfl[k] for k in ("wall_s", "round_s")},
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
                      "serving": {k: serving[k] for k in (
                          "wall_s", "cpu_s", "bf16_s", "init_s",
                          "peak_gib",
                          "draw_peak_gib", "weight_bytes", "bound_step_ms",
                          "bf16", "float32", "control", "cpu_gap",
                          "cpu_cache_gap", "runs")},
                      "kimi": {k: v for k, v in kimi.items()
                               if k != "kernel_times"},
                      "minicpm": {k: v for k, v in minicpm.items()
                                  if k != "kernel_times"},
                      "stablelm": {k: v for k, v in stablelm.items()
                                   if k != "kernel_times"},
                      "jamba": {k: v for k, v in jamba.items()
                                if k != "kernel_times"},
                      "xlstm": {k: v for k, v in xlstm_.items()
                                if k != "kernel_times"},
                      "whisper": {k: v for k, v in whisper.items()
                                  if k != "kernel_times"},
                      "qwen2_vl": {k: v for k, v in qwen_vl.items()
                                   if k != "kernel_times"},
                      "train_lm": {k: train_lm_run[k] for k in (
                          "losses", "grad_norms", "step_s", "seconds",
                          "tokens_per_s", "peak_gib", "wall_s")},
                      "deepseek": {k: deepseek[k] for k in (
                          "init_s", "init_peak_gib", "stage_s", "batched_s",
                          "step_s", "peak_gib", "seq_peak_gib", "gap",
                          "gap0", "gap1", "spread", "n_params")}}))
    print(f"the smoke run took {time.perf_counter() - t_start:.1f} s, the "
          "build included")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
