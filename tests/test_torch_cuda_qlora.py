"""The QLoRA slice's hand-written CUDA kernels against their plain
versions, on the card: ``int4_matmul`` (NN in both ``round_to`` modes,
NT, and the autograd dx) and ``distill_kl``.  This file imports no JAX,
so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_qlora.py

Without a card every case skips: the kernels have no CPU mode.
Tolerances: the JAX kernel tests' own (``int4_matmul`` rtol = atol =
1e-5; ``distill_kl`` rtol 1e-5, atol 1e-6, and every value >= -1e-6);
at other shapes 2e-5 of the largest magnitude (float32 sums taken in
another order than cuBLAS's).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.configs import paper_models as tpm
from repro_torch.kernels import distill_kl as dk
from repro_torch.kernels import int4_matmul as i4
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.peft import lora

pytestmark = pytest.mark.cuda

SWEEP = [(128, 256, 256), (64, 512, 384), (256, 128, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def _randn(rng, shape, dev, scale=1.0, dtype=torch.float32):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev, dtype)


def _packed(rng, K, N, block, dev):
    return lora.quantize(_randn(rng, (K, N), dev, 0.05), block)


@pytest.mark.parametrize("M_,K,N", SWEEP)
@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("round_to", [torch.float32, torch.bfloat16])
def test_int4_matmul_sweep(cuda, M_, K, N, block, round_to):
    rng = np.random.default_rng(M_ + K + N + block)
    x = _randn(rng, (M_, K), cuda)
    packed, scales = _packed(rng, K, N, block, cuda)
    before = i4.int4_matmul.launches
    got = ops.int4_matmul(x, packed, scales, block, round_to=round_to)
    assert i4.int4_matmul.launches == before + 1
    want = ref.int4_matmul(x, packed, scales, block, round_to=round_to)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M_,K,N,block", [
    (m, k, n, b) for m, k, n in SWEEP + [(5120, 128, 512)]
    for b in (2, 32, 64)] + [(131, 77, 130, 2), (1, 3, 64, 64)])
@pytest.mark.parametrize("round_to", [torch.float32, torch.bfloat16])
def test_int4_matmul_t(cuda, M_, K, N, block, round_to):
    rng = np.random.default_rng(M_ * K + N + block)
    dy = _randn(rng, (M_, N), cuda)
    packed, scales = _packed(rng, K, N, block, cuda)
    before = i4.int4_matmul_t.launches
    got = i4.int4_matmul_t(dy, packed, scales, block, round_to=round_to)
    assert i4.int4_matmul_t.launches == before + 1
    want = ref.int4_matmul_t(dy, packed, scales, block, round_to=round_to)
    assert _rel_err(got, want) <= 2e-5
    # every edge of the NN entry point at the same shape
    x = _randn(rng, (M_, K), cuda)
    got = i4.int4_matmul(x, packed, scales, block, round_to=round_to)
    want = ref.int4_matmul(x, packed, scales, block, round_to=round_to)
    assert _rel_err(got, want) <= 2e-5


def test_int4_matmul_every_nibble(cuda):
    """All 16 nibble values in both halves of a byte, NN and NT."""
    packed = torch.arange(256, dtype=torch.uint8, device=cuda).reshape(8, 32)
    scales = torch.linspace(0.01, 1.0, 8 * 2, device=cuda).reshape(8, 2)
    eye = torch.eye(8, device=cuda)
    w = ref.int4_matmul(eye, packed, scales, 32)
    torch.testing.assert_close(i4.int4_matmul(eye, packed, scales, 32), w,
                               rtol=0, atol=0)
    eye64 = torch.eye(64, device=cuda)
    torch.testing.assert_close(i4.int4_matmul_t(eye64, packed, scales, 32),
                               w.t(), rtol=0, atol=0)


def test_int4_matmul_bf16_activations(cuda):
    rng = np.random.default_rng(3)
    x = _randn(rng, (96, 256), cuda, dtype=torch.bfloat16)
    packed, scales = _packed(rng, 256, 384, 64, cuda)
    got = i4.int4_matmul(x, packed, scales, 64)
    assert got.dtype == torch.bfloat16
    want = ref.int4_matmul(x, packed, scales, 64)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("round_to", [torch.float32, torch.bfloat16])
def test_int4_matmul_autograd_dx(cuda, round_to):
    rng = np.random.default_rng(4)
    x = _randn(rng, (640, 128), cuda).requires_grad_()
    packed, scales = _packed(rng, 128, 512, 64, cuda)
    dy = _randn(rng, (640, 512), cuda)
    before = i4.int4_matmul_t.launches
    (dx,) = torch.autograd.grad(
        ops.int4_matmul(x, packed, scales, 64, round_to=round_to), x, dy)
    assert i4.int4_matmul_t.launches == before + 1
    (want,) = torch.autograd.grad(
        ref.int4_matmul(x, packed, scales, 64, round_to=round_to), x, dy)
    assert _rel_err(dx, want) <= 2e-5
    scales.requires_grad_()
    y = i4.int4_matmul(x, packed, scales, 64)
    with pytest.raises(RuntimeError, match="frozen"):
        torch.autograd.grad(y.sum(), scales)


@pytest.mark.parametrize("B,C", [(64, 2), (256, 3), (512, 7), (100, 10),
                                 (33, 4102), (5, 1)])
def test_distill_kl(cuda, B, C):
    rng = np.random.default_rng(B + C)
    t = torch.softmax(_randn(rng, (B, C), cuda), -1)
    t[0] = 0.0
    t[0, 0] = 1.0                           # zeros below eps: clipped
    z = _randn(rng, (B, C), cuda, 3.0)
    before = dk.distill_kl.launches
    got = ops.distill_kl(t, z)
    assert dk.distill_kl.launches == before + 1
    want = ref.distill_kl(t, z)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert bool((got >= -1e-6).all())


def test_wrappers_reject_bad_operands(cuda):
    packed = torch.zeros(16, 32, dtype=torch.uint8, device=cuda)
    scales = torch.ones(16, 1, device=cuda)
    x = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError):                  # 64 % 48 != 0
        i4.int4_matmul(x, packed, torch.ones(16, 2, device=cuda), 48)
    with pytest.raises(ValueError):                  # K mismatch
        i4.int4_matmul(torch.zeros(4, 8, device=cuda), packed, scales, 64)
    with pytest.raises(TypeError):
        i4.int4_matmul(x.double(), packed, scales, 64)
    with pytest.raises(TypeError):
        dk.distill_kl(x.double(), x.double())
    with pytest.raises(ValueError):
        dk.distill_kl(x, torch.zeros(4, 8, device=cuda))


def test_qlora_train_step_runs_through_the_kernels(cuda):
    """One QLoRA train step of tiny-llm on the card: every projection's
    forward and dx go through int4_matmul, none through lora_matmul, and
    the losses match the same step on the CPU."""
    cfg = dataclasses.replace(tpm.TINY_LLM, vocab_size=600)
    cfg = dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, quantize_base=True))
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(4, 600, (2, 4, 64)))
    labels = torch.from_numpy(rng.integers(4, 600, (2, 4, 64)))
    losses = []
    for dev in ("cpu", cuda):
        base = M.init_params(cfg, jr.PRNGKey(0), dtype=torch.float32,
                             device=dev)
        adp = M.stack_clients([M.init_adapters(cfg, jr.PRNGKey(c), base)
                               for c in range(2)])
        step = M.make_train_step(cfg, lr=3e-3,
                                 opts=M.FwdOptions(remat=False))
        before = (i4.int4_matmul.launches, i4.int4_matmul_t.launches,
                  lm.lora_matmul.launches)
        _, _, metrics = step(base, adp, adamw.init(adp, n_clients=2),
                             {"tokens": tokens.to(dev),
                              "labels": labels.to(dev)})
        after = (i4.int4_matmul.launches, i4.int4_matmul_t.launches,
                 lm.lora_matmul.launches)
        n = [b - a for a, b in zip(before, after)]
        assert n == ([0, 0, 0] if dev == "cpu" else [10, 8, 0]), n
        losses.append(metrics["loss"].cpu())
    torch.testing.assert_close(losses[1], losses[0], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the tensor-core kernel's tiles (128 x 128, reduction steps of 32) and its
# split reduction for small grids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M_,K,N,block", [
    (63, 77, 130, 2), (65, 33, 128, 64), (129, 100, 62, 2),
    (127, 31, 64, 32), (1, 1, 2, 2), (200, 256, 66, 2)])
@pytest.mark.parametrize("round_to", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_ragged_edges(cuda, M_, K, N, block, round_to, dtype):
    rng = np.random.default_rng(M_ + K + N + block)
    packed, scales = _packed(rng, K, N, block, cuda)
    x = _randn(rng, (M_, K), cuda, dtype=dtype)
    dy = _randn(rng, (M_, N), cuda, dtype=dtype)
    for got, want in (
            (i4.int4_matmul(x, packed, scales, block, round_to),
             ref.int4_matmul(x, packed, scales, block, round_to)),
            (i4.int4_matmul_t(dy, packed, scales, block, round_to),
             ref.int4_matmul_t(dy, packed, scales, block, round_to))):
        if dtype == torch.float32:
            assert _rel_err(got, want) <= 2e-5
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)


@pytest.mark.parametrize("M_,K,N,trans", [(5120, 128, 512, True),
                                          (5120, 256, 128, False),
                                          (256, 2048, 128, False),
                                          (100, 77, 4000, True)])
@pytest.mark.parametrize("round_to", [torch.float32, torch.bfloat16])
def test_int4_matmul_split_reduction_is_deterministic(cuda, M_, K, N, trans,
                                                      round_to):
    """A small grid with a long reduction is split; the second pass sums
    the splits in a fixed order, so two launches agree bit for bit, and
    each call counts one launch."""
    rng = np.random.default_rng(M_ + K + N)
    block = 2 if N % 64 else 64
    packed, scales = _packed(rng, K, N, block, cuda)
    a = _randn(rng, (M_, N if trans else K), cuda)
    assert i4._library().i4_workspace(M_, K, N, int(trans)) > 0
    fn = i4.int4_matmul_t if trans else i4.int4_matmul
    plain = ref.int4_matmul_t if trans else ref.int4_matmul
    before = fn.launches
    y1 = fn(a, packed, scales, block, round_to)
    y2 = fn(a, packed, scales, block, round_to)
    assert fn.launches == before + 2
    assert torch.equal(y1, y2)
    assert _rel_err(y1, plain(a, packed, scales, block, round_to)) <= 2e-5
