"""Graph times of ``lora_matmul`` (forward and dx) and ``int4_matmul``
(NN and NT) on the tree that ``PYTHONPATH`` puts first, at every shape
of ``chip_smoke.py``'s tables where more than one client shares a
launch, and at the main paths' ``w_in`` shapes: the tiny model's
forward (C = 5), llama3.2-1b's (C = 4), and bf16 serving's decode
(M = 4) and 512-token prefill (M = 2048) launches.  Each shape's split
count, and the partial sums its second pass adds, are printed beside
its time, and each entry point's registers and spills from the build
(``nvcc -Xptxas -v``).

To compare two trees, unpack both (``git archive``) and run, in one
call on a machine with a CUDA card, parent, tree, tree, parent:

    PYTHONPATH=PARENT/src:. python3 tools/split_pairs.py parent
    PYTHONPATH=TREE/src:. python3 tools/split_pairs.py tree

Each run builds the two libraries of its copy in that copy's
``kernels/_build``.  It prints one JSON line: ``{"tree": LABEL,
"times": {shape: ms}, "plans": {shape: [splits, partial sums]},
"build": {kernel: [[entry, registers, spill bytes], ...]}}``.
"""
import json
import sys

import torch

import chip_smoke as cs

# (name, C, M, K, N, r, dtype): the main paths' w_in launches
MAIN_SHAPES = (("tiny-w_in main", 5, 1024, 128, 512, 4, torch.float32),
               ("llama-w_in main", 4, 1024, 2048, 16384, 8, torch.float32),
               ("decode-w_in bf16", 1, 4, 2048, 16384, 8, torch.bfloat16),
               ("prefill512-w_in bf16", 1, 2048, 2048, 16384, 8,
                torch.bfloat16))


def _plan(C, M, N, K):
    """[splits, partial sums a row's second pass adds]: one a split."""
    from repro_torch.kernels import counts
    splits = counts.lm_splits(C, M, N, K)
    return [splits, splits]


def main(label: str):
    from repro_torch.kernels import build
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.peft import lora
    gen = torch.Generator(device="cuda").manual_seed(0)
    times, plans = {}, {}
    shapes = [(n, C, M, K, N, r, torch.float32)
              for n, C, M, K, N, r in cs.LORA_SHAPES if C >= 2]
    for name, C, M, K, N, r, dt in shapes + list(MAIN_SHAPES):
        x = cs._randn(gen, (C, M, K), dtype=dt)
        w = cs._randn(gen, (K, N), K ** -0.5, dtype=dt)
        a = cs._randn(gen, (C, K, r), K ** -0.5, dtype=dt)
        b = cs._randn(gen, (C, r, N), 0.1, dtype=dt)
        times[f"lora {name}"] = cs.graph_ms(lambda: lm._launch(
            x, w, a, b, 2.0))
        plans[f"lora {name}"] = _plan(C, M, N, K)
        if " main" not in name and " bf16" not in name:
            dy = cs._randn(gen, (C, M, N), dtype=dt)
            times[f"lora {name} dx"] = cs.graph_ms(lambda: lm._launch(
                dy, w.t(), b.transpose(1, 2), a.transpose(1, 2), 2.0))
            plans[f"lora {name} dx"] = _plan(C, M, K, N)
            del dy
        del x, w, a, b
    for name, M, K, N in cs.INT4_SHAPES:
        packed, scales = lora.quantize(cs._randn(gen, (K, N), 0.05), 64)
        x, dy = cs._randn(gen, (M, K)), cs._randn(gen, (M, N))
        times[f"int4 {name} NN"] = cs.graph_ms(lambda: i4._launch(
            x, packed, scales, 64, torch.float32, False))
        plans[f"int4 {name} NN"] = _plan(1, M, N, K)
        times[f"int4 {name} NT"] = cs.graph_ms(lambda: i4._launch(
            dy, packed, scales, 64, torch.float32, True))
        plans[f"int4 {name} NT"] = _plan(1, M, K, N)
    report = {n: [[e["entry"], e["registers"], e["spill_bytes"]]
                  for e in cs.ptxas_entries(build.build_log(n))]
              for n in ("lora_matmul", "int4_matmul")}
    print(json.dumps({"tree": label, "times": times, "plans": plans,
                      "build": report}))


if __name__ == "__main__":
    main(sys.argv[1])
