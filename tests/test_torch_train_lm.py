"""The port's LM fine-tuning entry point (``repro_torch.launch.train_lm``, the
port of ``examples/train_lm.py``) against the example's code path run in
the JAX package: ``xlstm-125m-smoke`` in its bfloat16, the base and the
adapters from ``PRNGKey(0)``, the same fixed document, ``make_train_step(
n_microbatches=2, lr=3e-3)`` under remat, 3 steps of 4 × 32 tokens.

Tolerances (bfloat16): each step's loss within 3e-3 of JAX's and its
gradient norm within 2e-2 relative.  The port rounds each adapted
projection once (``lora_matmul``), JAX's ``dense`` at five points, and
the sLSTM layers carry a rounding difference along the sequence; the gap
seen on this run is at most 1.0e-3 in the loss and 8.5e-3 in the
gradient norm.
"""
import jax
import numpy as np
import pytest

from repro.configs.registry import get as jget
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.launch import train_lm

ARGV = ["--arch", "xlstm-125m", "--steps", "3", "--batch", "4", "--seq",
        "32", "--device", "cpu"]


def jax_example(steps: int, batch: int, seq: int) -> tuple:
    """``examples/train_lm.py``'s loop in the JAX package: the per-step
    losses and gradient norms."""
    cfg = jget("xlstm-125m-smoke")
    key = jax.random.PRNGKey(0)
    params = JM.init_params(cfg, key)
    adapters = JM.init_adapters(cfg, key, params)
    opt = jadamw.init(adapters)
    step = jax.jit(JM.make_train_step(cfg, n_microbatches=2, lr=3e-3))
    doc = jax.random.randint(key, (batch, seq + 1), 4, cfg.vocab_size - 4)
    b = {"tokens": doc[:, :-1], "labels": doc[:, 1:]}
    losses, gnorms = [], []
    for _ in range(steps):
        adapters, opt, m = step(params, adapters, opt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms


def test_train_lm_matches_the_jax_example(capsys):
    out = train_lm.main(ARGV)
    printed = capsys.readouterr().out
    assert printed.startswith("fine-tuning xlstm-125m-smoke (2.1M params, "
                              "LoRA r=4)")
    assert "step    0  loss=" in printed and "step    2  loss=" in printed
    assert "3 steps in " in printed and "tok/s CPU)" in printed
    losses, gnorms = jax_example(3, 4, 32)
    assert len(out["losses"]) == len(out["grad_norms"]) == 3
    assert all(np.isfinite(out["losses"])) and out["tokens_per_s"] > 0
    assert out["losses"][-1] < out["losses"][0]
    for s in range(3):
        assert abs(out["losses"][s] - losses[s]) <= 3e-3, s
        assert abs(out["grad_norms"][s] - gnorms[s]) <= 2e-2 * gnorms[s], s


def test_a_frontend_arch_without_frontend_raises():
    """As in the example, whisper reads frames that the entry point feeds
    none of."""
    with pytest.raises(ValueError, match="frontend"):
        train_lm.main(["--arch", "whisper-large-v3", "--steps", "1",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])


def test_microbatches_must_divide_the_batch():
    with pytest.raises(ValueError, match="do not divide"):
        train_lm.main(ARGV[:4] + ["--batch", "3", "--seq", "16",
                                  "--device", "cpu"])
