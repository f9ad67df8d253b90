"""Times of the quantum paths whose sines and cosines are XLA's float32
ones, on the tree that ``PYTHONPATH`` puts first: to compare two trees
in one call on a machine with a CUDA card (parent, tree, tree, parent).

    PYTHONPATH=TREE/src:. python3 tools/trig_pairs.py LABEL

The timing functions are this checkout's ``chip_smoke.py``, the package
under test the tree's.  It times:

- ``statevector_tape`` at ``chip_smoke.TAPE_SHAPES`` (the VQC tape, its
  angles drawn from a seeded generator as the smoke's phase 2 draws
  them): the graph time and the host loop's, and the build's registers
  and spill bytes (``nvcc -Xptxas -v``);
- the eager circuit's gates, as the sequential engine applies them to a
  client's 50 rows of 4 qubits: ``sv.ry`` with a shared angle,
  ``circuits._p_phase`` with a per-row angle and ``sv.rz`` with a
  Python float, each a host loop of ``GATE_CALLS`` calls ended by a
  synchronisation (µs a gate, the host's clock);
- phase 7's sequential QFL Nelder-Mead run (``chip_smoke.SEQ_QFL`` on
  the card) ``RUNS`` times: each run's wall seconds and its rounds'.

It prints one JSON line: ``{"tree": LABEL, "tape": [...], "build":
[[entry, registers, spill bytes], ...], "gate_us": {gate: µs},
"sequential": [{"wall_s": s, "round_s": [s, ...]}, ...]}``.
"""
import json
import sys
import time

import torch

import chip_smoke as cs

GATE_CALLS = 2000
RUNS = 2


def _gate_us(fn) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GATE_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / GATE_CALLS * 1e6


def main(label: str):
    from repro_torch.kernels import build
    from repro_torch.kernels import statevector_tape as svt
    from repro_torch.quantum import circuits
    from repro_torch.quantum import statevector as sv
    gen = torch.Generator(device="cuda").manual_seed(2)
    tape = []
    for B, n in cs.TAPE_SHAPES:
        cols = cs.tape_columns(n, "vqc", gen)
        ang = cs.tape_angles_for(n, "vqc", B, gen)
        wide = n > 4
        launch = lambda: svt.statevector_tape(ang, *cols, n)  # noqa: E731
        tape.append(dict(B=B, n_qubits=n,
                         ms=cs.cuda_ms(launch, iters=20 if wide else 200),
                         graph_ms=cs.graph_ms(launch, 5 if wide else 20)))
    regs = [[e["entry"], e["registers"], e["spill_bytes"]]
            for e in cs.ptxas_entries(build.build_log(svt.NAME))]

    psi = sv.zero_state(4, 50, "cuda")
    theta = torch.tensor(0.3, device="cuda")
    x = torch.rand(50, generator=gen, device="cuda") * 3
    gate_us = {"ry shared": _gate_us(lambda: sv.ry(psi, theta, 1)),
               "p per row": _gate_us(lambda: circuits._p_phase(psi, 2.0 * x,
                                                                1)),
               "rz float": _gate_us(lambda: sv.rz(psi, 1.5707963, 1))}

    seq = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        _, _, orch = cs.run_main_path("cuda", cs.SEQ_QFL,
                                      engine="sequential")
        seq.append(dict(wall_s=time.perf_counter() - t0,
                        round_s=list(orch.round_seconds)))
    print(json.dumps({"tree": label, "tape": tape, "build": regs,
                      "gate_us": gate_us, "sequential": seq}))


if __name__ == "__main__":
    main(sys.argv[1])
