#!/usr/bin/env python3
"""Where flash_attention's time goes: variants of
``src/repro_torch/kernels/csrc/flash_attention.cu``, each one edit of the
source, built and timed beside the source as it stands, on one NVIDIA GPU.

    python3 tools/attn_variants.py            # every variant
    python3 tools/attn_variants.py "as is" "backward query halves unrolled"

Run from the root of a checkout on a machine with a CUDA card and
``nvcc``.  Each variant's library is built (one ``nvcc`` each, all at once)
into ``variants/`` under the kernels' build directory, which is
gitignored.  For each it prints the compiler's largest register count and
spill over the float32 entry points, the largest error against
``ref.flash_attention`` and plain autograd over four cases (forward and
dq/dk/dv, relative to the largest magnitude), and CUDA-graph device times
of the forward and the backward at the main paths' shapes (tiny-llm and
llama3.2-1b widths, as ``chip_smoke.py`` times them) and of one
kv-head's backward (B=1, S=64, H=G, KH=1: one CTA).  Variants marked
"wrong on purpose" drop part of the arithmetic: their error says so, and
their time says what that part costs.  An edit that no longer matches the
source raises.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"

MMA3 = """    mma(d[0], ah, bh);
    if (!AX) mma(d[1], al, bh);
    if (!BX) mma(d[2], ah, bl);"""
SPLIT = """        const float h = EXACT ? v[i] : tf32_rna(v[i]);
        hi[i] = __float_as_uint(h);
        lo[i] = EXACT ? 0u : __float_as_uint(tf32_rna(v[i] - h));"""
# name: [(text in the source, its replacement), ...]
VARIANTS = {
    "as is": [],
    "backward query halves unrolled": [
        ("#pragma unroll (EX ? 2 : 1)\n        for (int hf = 0; hf < 2;",
         "#pragma unroll\n        for (int hf = 0; hf < 2;")],
    "backward at D = 32, one CTA an SM": [
        ("TEAMS, D == 32 ? 2 : 1)", "TEAMS, 1)")],
    "no rowsum(dO O) (wrong on purpose)": [
        ("if (qi < p.S && !p.delta) {", "if (false) {")],
    "split, one product (wrong on purpose)": [
        (MMA3, "    mma(d[0], ah, bh);")],
    "no split, one product (wrong on purpose)": [
        (MMA3, "    mma(d[0], ah, bh);"),
        (SPLIT,
         "        hi[i] = __float_as_uint(v[i]);\n        lo[i] = 0u;")],
}
CHECKS = ((80, 64, 4, 2, 32, True, 0), (4, 64, 32, 8, 64, True, 0),
          (2, 129, 8, 2, 64, True, 0), (2, 100, 4, 2, 128, False, 16))


def variant_source(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(
                f"edit does not match the source once: {old!r}")
        text = text.replace(old, new)
    return text


def ptxas_summary(log: str) -> dict:
    """Largest registers and spill bytes over the float32 forward and
    backward entry points."""
    regs, spill, cur = 0, 0, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or "attn_" not in cur or "kernelIf" not in cur:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = max(spill, int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
    return dict(registers=regs, spill_bytes=spill)


def load(path: Path) -> ctypes.CDLL:
    """The variant's library, declared as ``kernels/flash_attention``
    declares its own, and made the one that module's wrappers launch
    (this process times one variant at a time)."""
    from repro_torch.kernels import flash_attention as fa
    lib = fa.declare(ctypes.CDLL(str(path)))
    fa._library = lambda: lib
    return lib


def measure(gen) -> dict:
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import flash_attention as fa, ref
    worst = 0.0
    for B, S, H, KH, D, causal, window in CHECKS:
        q = cs._randn(gen, (B, S, H, D)).requires_grad_()
        k = cs._randn(gen, (B, S, KH, D)).requires_grad_()
        v = cs._randn(gen, (B, S, KH, D)).requires_grad_()
        do = cs._randn(gen, (B, S, H, D))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        g = torch.autograd.grad(got, (q, k, v), do)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        gw = torch.autograd.grad(want, (q, k, v), do)
        worst = max([worst, cs.rel_err(got, want)]
                    + [cs.rel_err(a, b) for a, b in zip(g, gw)])
    row = dict(max_rel_err=worst)
    for name, B, S, H, KH, D in cs.ATTN_SHAPES:
        if name == "tiny-eval":
            continue
        q, do = cs._randn(gen, (B, S, H, D)), cs._randn(gen, (B, S, H, D))
        k, v = cs._randn(gen, (B, S, KH, D)), cs._randn(gen, (B, S, KH, D))
        out, lse = fa._forward(q, k, v, True, 0, D ** -0.5)
        row[f"{name}_fwd_graph_ms"] = cs.graph_ms(
            lambda: fa._forward(q, k, v, True, 0, D ** -0.5))
        row[f"{name}_bwd_graph_ms"] = cs.graph_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do))
        G = H // KH
        q1, do1 = cs._randn(gen, (1, S, G, D)), cs._randn(gen, (1, S, G, D))
        k1, v1 = cs._randn(gen, (1, S, 1, D)), cs._randn(gen, (1, S, 1, D))
        o1, l1 = fa._forward(q1, k1, v1, True, 0, D ** -0.5)
        row[f"{name}_kv_head_bwd_graph_ms"] = cs.graph_ms(
            lambda: fa.flash_attention_bwd(q1, k1, v1, o1, l1, do1))
    return row


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(
            f"unknown variants {unknown}; known: {list(VARIANTS)}")
    print(f"card: {cs.card_line()}")
    out = build.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        src = out / f"v{i}.cu"
        src.write_text(variant_source(VARIANTS[name]))
        cmd = [build.nvcc(), *build.FLAGS, "-I", str(SOURCE.parent), "-o",
               str(out / f"libv{i}.so"), str(src)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, (i, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        load(out / f"libv{i}.so")
        row = dict(ptxas_summary(log), **measure(gen))
        results[name] = row
        print(f"{name}: registers {row['registers']}, spill "
              f"{row['spill_bytes']} B, max rel err {row['max_rel_err']:.2e}; "
              + "; ".join(f"{k[:-3]} {v * 1e3:.2f} us" for k, v in row.items()
                          if k.endswith("_ms")), flush=True)
    print(json.dumps({"attn_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
