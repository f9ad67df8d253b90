#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # device busy/idle of the main path

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``.  It imports nothing of JAX and nothing of the JAX package
``repro``; it drives ``src/repro_torch`` only.  Every phase raises on
failure, and the script then exits non-zero with no result line.

1. Prints the card's name and power limit (``nvidia-smi``), builds the
   hand-written kernels from ``src/repro_torch/kernels/csrc`` and prints
   the build time and the compiler's register report.
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the card over a sweep of shapes (tolerance stated per kernel), and
   times both at the shapes the main path gives it.
3. Main path at the quickstart width: federated QFL with batched
   Nelder–Mead on the genomic task, 4-qubit VQC (86 gates, 16 params),
   5 clients, 10 rounds, on the card; then the same run on the CPU (the
   plain path), which it must match.  The kernel's launch counter is set
   to 0 just before the card run and read just after.
4. Wide phase: a 10-qubit VQC (485 gates, 40 params), 8 clients, one
   round; finite losses and unit-norm statevectors.
5. Prints the card line, one ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

``--profile`` instead traces a warm 3-round quickstart run with
``torch.profiler`` and prints the device's busy time, its idle share of
the wall time, and the kernels that take the device time.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
F32_FLOPS_PER_S = 67e12            # H100 SXM, float32 outside tensor cores

QUICKSTART = dict(task=dict(n_clients=5, train_size=250, test_size=100,
                            val_size=60, seed=0),
                  run=dict(n_rounds=10))
WIDE = dict(task=dict(n_clients=8, train_size=400, test_size=100,
                      val_size=60, seed=0, n_features=10),
            run=dict(n_rounds=1, maxiter0=5, n_qubits=10))


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


# ---------------------------------------------------------------------------
# phase 2: statevector_gate against its plain version
# ---------------------------------------------------------------------------
def _gate_inputs(B: int, n: int, gen):
    import torch
    u = lambda *s: torch.rand(*s, generator=gen, device="cuda") * 2 - 1  # noqa
    return u(B, 1 << n), u(B, 1 << n), u(B, 2, 2), u(B, 2, 2)


def kernel_phase():
    """Max error over the sweep, and times at the main path's shapes."""
    import torch
    from repro_torch.kernels import ref, statevector_gates as svg

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err, cases = 0.0, 0
    for n in (1, 2, 4, 6, 10, 12):
        for B in (1, 7, 4750, 17200):
            if B == 17200 and n > 10:
                continue
            psi_re, psi_im, g_re, g_im = _gate_inputs(B, n, gen)
            for target in range(n):
                for control in [-1] + [c for c in range(n) if c != target]:
                    got = svg.statevector_gate(psi_re, psi_im, g_re, g_im,
                                               target, control, n)
                    want = ref.statevector_gate(psi_re, psi_im, g_re, g_im,
                                                target, control, n)
                    err = max(float((got[0] - want[0]).abs().max()),
                              float((got[1] - want[1]).abs().max()))
                    check(err <= 1e-6, f"statevector_gate n={n} B={B} "
                          f"target={target} control={control}: max abs "
                          f"error {err} > 1e-6")
                    max_err = max(max_err, err)
                    cases += 1
    torch.cuda.synchronize()
    print(f"kernel phase: statevector_gate == plain on {cases} cases, "
          f"max abs err {max_err:.3g} (tolerance 1e-6: same f32 formula, "
          "only FMA contraction differs)")

    shapes = []
    for B, n in ((4750, 4), (17200, 10)):
        psi_re, psi_im, g_re, g_im = _gate_inputs(B, n, gen)
        # a controlled gate (CX-like) on the middle qubit, the common case
        args = (psi_re, psi_im, g_re, g_im, n // 2, 0, n)
        ms = cuda_ms(lambda: svg.statevector_gate(*args), iters=200)
        plain_ms = cuda_ms(lambda: ref.statevector_gate(*args), iters=50)
        N = 1 << n
        nbytes = 16 * B * N + 32 * B       # planes in + out, gates in
        flops = 14 * B * N                 # 28 per amplitude pair
        bound_ms = max(nbytes / HBM_BYTES_PER_S,
                       flops / F32_FLOPS_PER_S) * 1e3
        shapes.append(dict(B=B, n_qubits=n, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bytes=nbytes))
        print(f"  B={B} n={n}: kernel {ms * 1e3:.2f} us/launch, plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.2f} MB at 3.35 TB/s)")
    return max_err, shapes


# ---------------------------------------------------------------------------
# phases 3 and 4: the port's main path through its entry points
# ---------------------------------------------------------------------------
def run_main_path(device, cfg):
    """One federated run; returns (task, result, per-round seconds)."""
    from repro_torch.core.orchestrator import Orchestrator, RunConfig
    from repro_torch.data.tasks import build_task
    task = build_task("genomic", **cfg["task"])
    rc = RunConfig(method="qfl", optimizer="nelder-mead", engine="batched",
                   backend="exact", **cfg["run"])
    orch = Orchestrator(task, rc, device=device)
    res = orch.run()
    return task, res, orch.round_seconds


def compare_runs(gpu, cpu):
    """The card run against the plain path on the CPU: integer accounting
    exactly, losses within 1e-5 and θ_g within 1e-4 (the JAX package's
    own engine-parity tolerances)."""
    import numpy as np
    for attr in ("maxiters", "selected", "cum_evals"):
        check(gpu.series(attr) == cpu.series(attr),
              f"{attr} differ: cuda {gpu.series(attr)} cpu {cpu.series(attr)}")
    check(len(gpu.rounds) == len(cpu.rounds), "round counts differ")
    np.testing.assert_allclose(gpu.series("server_loss"),
                               cpu.series("server_loss"), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gpu.series("client_losses"),
                               cpu.series("client_losses"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(gpu.theta_g, cpu.theta_g, atol=1e-4, rtol=0)
    return (float(np.max(np.abs(np.subtract(gpu.series("server_loss"),
                                            cpu.series("server_loss"))))),
            float(np.max(np.abs(gpu.theta_g - cpu.theta_g))))


def main_phase():
    from repro_torch.kernels import statevector_gates as svg
    from repro_torch.quantum import tape
    svg.statevector_gate.launches = 0
    tape.run_tape.replays = 0
    t0 = time.perf_counter()
    task, gpu, secs = run_main_path("cuda", QUICKSTART)
    wall = time.perf_counter() - t0
    launches, replays = svg.statevector_gate.launches, tape.run_tape.replays
    check(launches > 0, "the main path launched no statevector_gate")
    check(launches == 86 * replays,
          f"{launches} launches for {replays} tape replays of 86 gates")
    for r, s in zip(gpu.rounds, secs):
        print(f"  round {r.t}: server loss {r.server_loss:.6f} val acc "
              f"{r.server_val_acc:.3f} test acc {r.server_test_acc:.3f} "
              f"cum evals {r.cum_evals} wall {s:.3f} s")
    print(f"main path (cuda): {len(gpu.rounds)} rounds in {wall:.2f} s, "
          f"{replays} tape replays, statevector_gate launches {launches}")
    t0 = time.perf_counter()
    _, cpu, _ = run_main_path("cpu", QUICKSTART)
    loss_gap, theta_gap = compare_runs(gpu, cpu)
    print(f"main path (cpu, plain) in {time.perf_counter() - t0:.2f} s: "
          f"equal maxiters/selected/cum_evals; max |Δ server loss| "
          f"{loss_gap:.3g}, max |Δ θ_g| {theta_gap:.3g}")
    return launches


def wide_phase():
    import numpy as np
    import torch
    from repro_torch.kernels import statevector_gates as svg
    from repro_torch.quantum import qnn, tape
    svg.statevector_gate.launches = 0
    tape.run_tape.replays = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task, res, _ = run_main_path("cuda", WIDE)
    wall = time.perf_counter() - t0
    launches, replays = svg.statevector_gate.launches, tape.run_tape.replays
    cq = tape.compile_qnn(qnn.QNNSpec("vqc", n_qubits=10))
    check(cq.tape.n_gates == 485, f"10-qubit tape has {cq.tape.n_gates}")
    check(launches > 0 and launches == 485 * replays,
          f"wide: {launches} launches for {replays} replays of 485 gates")
    r = res.rounds[-1]
    check(np.all(np.isfinite(r.client_losses)) and math.isfinite(
        r.server_loss), f"non-finite losses {r.client_losses}")
    X = torch.as_tensor(task.val_qX, device="cuda")
    theta = torch.as_tensor(res.theta_g, dtype=torch.float32, device="cuda")
    re, im = tape.run_tape(cq.tape, tape.tape_angles(cq.tape, X, theta))
    norm_err = float(((re * re + im * im).sum(-1) - 1).abs().max())
    check(norm_err <= 1e-5, f"statevector norms off by {norm_err}")
    print(f"wide phase (10 qubits, 485 gates, 8 clients): {wall:.2f} s, "
          f"server loss {r.server_loss:.6f}, statevector_gate launches "
          f"{launches}, max |norm-1| {norm_err:.3g}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def profile_phase():
    """Device busy time and idle share of a warm quickstart run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    warm = dict(QUICKSTART, run=dict(n_rounds=1))
    run_main_path("cuda", warm)
    cfg = dict(QUICKSTART, run=dict(n_rounds=3, early_stop=False))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, secs = run_main_path("cuda", cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, "the profiler saw no device time")
    print(f"profile: 3 quickstart rounds in {wall:.3f} s under the "
          f"profiler (rounds {', '.join(f'{s:.3f}' for s in secs)} s); "
          f"device busy {busy_us / 1e3:.2f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}")


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
        profile_phase()
        return 0
    check(not argv, f"unknown arguments {argv}; use --profile or none")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from repro_torch.kernels import build, statevector_gates as svg
    svg._library()
    print(f"built {svg.NAME} in {build.BUILD_SECONDS[svg.NAME]:.1f} s")
    for line in build.build_log(svg.NAME).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    max_err, shapes = kernel_phase()
    launches = main_phase()
    wide_launches = wide_phase()

    quick = shapes[0]
    kernels = [dict(
        name=svg.NAME, route="cuda", source=svg.SOURCE,
        replaces=svg.REPLACES, launches=launches, max_abs_err=max_err,
        ms=quick["ms"], plain_ms=quick["plain_ms"],
        bound_ms=quick["bound_ms"], bound_by="bytes", library_ms=None,
        launches_wide=wide_launches, shapes=shapes)]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
