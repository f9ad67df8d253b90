"""``python -m repro_torch.launch.serve`` against ``examples/serving.py``:
the same printed lines (timings aside), the same prompts, and on the
same weights the same sampled tokens; ``--device`` defaults to the card
and never falls back to the CPU.  For the mixture-of-experts archs the
sampled tokens are compared up to the first serve step at which request
0 routed a token within ``FLIP_MARGIN`` of a tie (a bfloat16 routing
flip, ``tests/torch_families.py``), which is reported: in kimi-k2 and
maverick the MoE block is the stack's last, so a step's routing moves
that step's logits alone.  In jamba-1.5-large-398b four MoE layers feed
later recurrent states, so a step near a tie moves every later token:
its tokens are compared up to the first step from the prompt's start at
which any of them routed request 0 near a tie (possibly none), and the
number of equal leading tokens is reported.  xlstm-125m, whisper-large-v3
and qwen2-vl-72b have no MoE layer: all their tokens are compared (as in
the example, whisper decodes over the zero cross caches of
``init_cache`` and qwen2-vl sees no patches)."""
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get
from repro_torch.launch import serve
from torch_families import FLIP_MARGIN, routed, token_margins

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TIMED = (re.compile(r"prefill\(\d+ tokens, sequential smoke path\): "
                    r"[\d.]+s"),
         re.compile(r"decoded \d+ tokens × \d+ requests in [\d.]+s "
                    r"\([\d.]+ tok/s\)"))


def _untimed(line: str) -> str:
    """The line with its times and rate (the decimals) blanked."""
    return re.sub(r"\d+\.\d+", "T", line)


def _example(argv, capsys):
    old = sys.argv
    sys.argv = ["serving.py", *argv]
    try:
        runpy.run_path(str(ROOT / "examples" / "serving.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


def _comparable(calls, argv) -> int:
    """How many of request 0's printed tokens depend on no routing near a
    tie: those sampled before the first step (the last prompt step, then
    the decode steps) whose MoE routed request 0 within FLIP_MARGIN."""
    if not calls:
        return 12
    cfg = get(argv[argv.index("--arch") + 1] + "-smoke")
    P = int(argv[argv.index("--prompt-len") + 1]) if "--prompt-len" in \
        argv else 32
    n_moe = sum(f == "moe" for _, f in cfg.pattern) * cfg.n_groups
    margins = [float(token_margins(r, cfg.moe.top_k)[0]) for r in calls]
    steps = [min(margins[i:i + n_moe])
             for i in range(0, len(margins), n_moe)]
    if n_moe > 1:
        for p, m in enumerate(steps):
            if m < FLIP_MARGIN:
                n = max(p - (P - 1), 0)
                print(f"{cfg.name}: request 0 routed within {m:.3g} of a "
                      f"tie at serve step {p} ({P} of them the prompt's); "
                      f"its tokens from {n} on are not compared")
                return n
        return 12
    assert cfg.pattern[-1][1] == "moe" and cfg.n_groups == 1
    for n, m in enumerate(steps[P - 1:]):      # n - 1: the decode step
        if m < FLIP_MARGIN:
            print(f"{cfg.name}: request 0 routed within {m:.3g} of a tie "
                  f"at decode step {n - 1} (-1: the last prompt step); "
                  f"its tokens from {max(n - 1, 0)} on are not compared")
            return max(n - 1, 0)
    return 12


FAMILIES = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "minicpm3-4b",
            "jamba-1.5-large-398b", "xlstm-125m", "whisper-large-v3",
            "qwen2-vl-72b"]


@pytest.mark.parametrize("argv", [[], ["--arch", "starcoder2-7b",
                                       "--batch", "2", "--prompt-len", "8",
                                       "--steps", "6"]]
                         + [["--arch", a] for a in FAMILIES])
def test_prints_the_examples_lines(argv, capsys):
    with routed() as calls:
        out = serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    want = _example(argv, capsys)
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        assert _untimed(g) == _untimed(w)
    n = _comparable(calls, argv)
    ids = [re.findall(r"\d+", line) for line in (got[3], want[3])]
    assert got[3].startswith("sample token ids: [")
    assert len(ids[0]) == len(ids[1]) and ids[0][:n] == ids[1][:n]
    lead = next((i for i, (a, b) in enumerate(zip(*ids)) if a != b),
                len(ids[0]))
    print(f"{argv}: {lead} leading tokens equal to the example's, "
          f"{n} held")
    if sum(f == "moe" for _, f in get(
            (argv[argv.index("--arch") + 1] if argv else "stablelm-3b")
            + "-smoke").pattern) <= 1:
        assert n >= 3
    for line, pattern in zip(got[1:3], TIMED):
        assert pattern.fullmatch(line), line
    B = int(argv[argv.index("--batch") + 1]) if "--batch" in argv else 4
    P = int(argv[argv.index("--prompt-len") + 1]) if "--prompt-len" in \
        argv else 32
    assert out["prompts"].shape == (B, P)


def test_prompts_equal_jax():
    out = serve.main(["--steps", "1", "--prompt-len", "5", "--device",
                      "cpu"])
    cfg_vocab = 512
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (4, 5), 4,
                                         cfg_vocab - 4))
    np.testing.assert_array_equal(out["prompts"], want)


def test_the_card_is_the_default():
    """Without ``--device`` the entry point asks for the card, and
    without one it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--steps", "1"])


def test_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--steps", "2", "--prompt-len", "4"], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "serving stablelm-3b-smoke: 1L d=256 pattern=['attn']"
    assert lines[-1].startswith("sample token ids: [")
