"""Finite-shot sampling and the paper LLMs' kernel shapes on the card.
This file imports no JAX, so it runs on a machine with a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_shots.py

Without a card every case skips.  ``sample_counts`` and ``uniform_stack``
on the card are bitwise the CPU's on the same inputs and keys (every
step is integer work, an IEEE-rounded float32 op or a comparison); a
short noisy batched run on the card matches the CPU's on every budget,
selection and eval count and launches ``statevector_tape`` once a
replay.  ``lora_matmul`` and ``flash_attention`` at GPT-2's and
DeepSeek-LLM-7B's shapes against their plain versions: 2e-5 of the
largest magnitude, forward and gradients, as
``tests/test_torch_cuda_llm.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import run_experiment
from repro_torch.data.tasks import build_task
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import statevector_gates as svg
from repro_torch.kernels import statevector_tape as svt
from repro_torch.quantum import backends, tape

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    t = t.cpu()
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return torch.where(torch.isnan(t), -1, bits.to(torch.int32))


@pytest.mark.parametrize("lead,B,C,shots,dtype", [
    ((), 50, 2, 100, torch.float32), ((5, 19), 50, 2, 100, torch.float32),
    ((), 50, 3, 100, torch.float32), ((), 4750, 2, 1000, torch.float32),
    ((3,), 50, 2, 100, torch.bfloat16), ((), 50, 3, 1000, torch.bfloat16)])
def test_sample_counts_card_equals_cpu(cuda, lead, B, C, shots, dtype):
    rng = np.random.default_rng(B + C + shots)
    p = rng.dirichlet(np.ones(C), (*lead, B)).astype(np.float32)
    p[..., 1, :], p[..., 2, :], p[..., 3, :] = np.nan, 0.0, -0.5
    n = int(np.prod(lead)) if lead else 1
    keys = jr.fold_in(jr.PRNGKey(7), np.arange(n)).reshape(*lead, 2)
    t = torch.from_numpy(p).to(dtype)
    got = backends.sample_counts(keys, t.to(cuda), shots)
    want = backends.sample_counts(keys, t, shots)
    assert got.device.type == "cuda" and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_uniform_stack_card_equals_cpu(cuda, dtype):
    keys = jr.fold_in(jr.PRNGKey(2), np.arange(95) * 31)
    got = jr.uniform_stack(keys, (100, 50), dtype, cuda)
    want = jr.uniform_stack(keys, (100, 50), dtype)
    assert torch.equal(_bits(got), _bits(want))


def test_noisy_batched_run_card_equals_cpu(cuda):
    task = build_task("genomic", n_clients=3, train_size=90, test_size=45,
                      val_size=30, seed=5)
    kw = dict(method="qfl", optimizer="nelder-mead", engine="batched",
              n_rounds=2, maxiter0=5, early_stop=False, backend="aersim")
    svt.statevector_tape.launches = svg.statevector_gate.launches = 0
    tape.run_tape.replays = 0
    with backends.track_margin(record=True) as m:
        got = run_experiment(task, **kw)
    assert svt.statevector_tape.launches == tape.run_tape.replays > 0
    assert svg.statevector_gate.launches == 0
    with backends.track_margin(record=True) as m_cpu:
        want = run_experiment(task, device="cpu", **kw)
    for attr in ("maxiters", "selected", "cum_evals"):
        assert got.series(attr) == want.series(attr)
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=1e-5)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=1e-4)
    assert m.draws == m_cpu.draws > 0 and m.near <= m.chance_bound()
    near = m.near_disagreements(m_cpu)
    assert near.unexplained == 0, near


def _rel_err(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def _randn(gen, shape, dev, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev) * scale


# (C, M, K, N, r): GPT-2's projections at the quickstart's 5 clients, and
# DeepSeek-LLM-7B's one client at a time
PAPER_PROJ = ([(5, 1024, 768, n, 8) for n in (768, 1536, 6144)]
              + [(5, 1024, 3072, 768, 8)]
              + [(1, 1024, 4096, n, 8) for n in (4096, 8192, 22016)]
              + [(1, 1024, 11008, 4096, 8)])


@pytest.mark.parametrize("C,M,K,N,r", PAPER_PROJ)
def test_lora_matmul_paper_shapes(cuda, C, M, K, N, r):
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    x = _randn(gen, (C, M, K), cuda).requires_grad_()
    w = _randn(gen, (K, N), cuda, K ** -0.5)
    a = _randn(gen, (C, K, r), cuda, K ** -0.5).requires_grad_()
    b = _randn(gen, (C, r, N), cuda, 0.1).requires_grad_()
    dy = _randn(gen, (C, M, N), cuda)
    before = lm.lora_matmul.launches
    got = ops.lora_matmul(x, w, a, b, 2.0)
    g = torch.autograd.grad(got, (x, a, b), dy)
    assert lm.lora_matmul.launches == before + 2       # forward and dx
    want = ref.lora_matmul(x, w, a, b, 2.0)
    gw = torch.autograd.grad(want, (x, a, b), dy)
    assert _rel_err(got, want) <= 2e-5
    for name, u, v in zip(("dx", "dA", "dB"), g, gw):
        assert _rel_err(u, v) <= 2e-5, name


@pytest.mark.parametrize("B,S,H,KH,D", [(80, 64, 12, 12, 64),
                                        (250, 64, 12, 12, 64),
                                        (16, 64, 32, 32, 128),
                                        (32, 64, 32, 32, 128)])
def test_flash_attention_paper_shapes(cuda, B, S, H, KH, D):
    gen = torch.Generator(device=cuda).manual_seed(B * H + D)
    q = _randn(gen, (B, S, H, D), cuda).requires_grad_()
    k = _randn(gen, (B, S, KH, D), cuda).requires_grad_()
    v = _randn(gen, (B, S, KH, D), cuda).requires_grad_()
    do = _randn(gen, (B, S, H, D), cuda)
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    got = ops.flash_attention(q, k, v, causal=True)
    g = torch.autograd.grad(got, (q, k, v), do)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    want = ref.flash_attention(q, k, v, causal=True)
    gw = torch.autograd.grad(want, (q, k, v), do)
    assert _rel_err(got, want) <= 2e-5
    for name, u, w in zip(("dq", "dk", "dv"), g, gw):
        assert _rel_err(u, w) <= 2e-5, name
