"""The plain versions of the LLM stage's kernels against the JAX package.

``ref.lora_matmul`` and ``ref.flash_attention`` (what the CUDA kernels
are held to on the card, and what the CPU runs) against the JAX Pallas
kernels in interpret mode and the JAX oracles, over the JAX kernel
tests' sweep and tolerances (float32 2e-5, bfloat16 2e-2); their
autograd gradients against ``jax.vjp`` of the JAX functions, float32
within 1e-5 of the largest magnitude; and the grouped-head mapping
against ``repro/models/attention.py::flash_attention``.  Inputs are
drawn with numpy and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages (bfloat16 rounds alike)."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(t):
    return t.detach().float().numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("M,K,N,r", [
    (128, 256, 128, 8), (256, 512, 384, 16), (64, 128, 512, 4),
    (32, 64, 64, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_plain_matches_jax(M, K, N, r, dtype):
    rng = np.random.default_rng(M + K + N + r)
    arrays = [rng.standard_normal((M, K)).astype(np.float32)] + [
        (rng.standard_normal(s) * 0.05).astype(np.float32)
        for s in ((K, N), (K, r), (r, N))]
    (xj, wj, aj, bj), (xt, wt, at, bt) = zip(*(_pair(a, dtype)
                                               for a in arrays))
    got = _np(ops.lora_matmul(xt, wt, at, bt, 2.0))
    assert ops.lora_matmul(xt, wt, at, bt, 2.0).dtype == xt.dtype
    kern = np.asarray(jops.lora_matmul(xj, wj, aj, bj, scale=2.0)
                      .astype(jnp.float32))
    oracle = np.asarray(jref.lora_matmul(xj, wj, aj, bj, 2.0)
                        .astype(jnp.float32))
    np.testing.assert_allclose(got, kern, **_tol(dtype))
    np.testing.assert_allclose(got, oracle, **_tol(dtype))


def test_lora_matmul_batched_is_per_client():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 40, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((3, 32, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 4, 24)).astype(np.float32))
    y = ref.lora_matmul(x, w, a, b, 0.5)
    for c in range(3):
        torch.testing.assert_close(y[c], ref.lora_matmul(x[c], w, a[c], b[c],
                                                         0.5))


@pytest.mark.parametrize("M,K,N,r", [(64, 128, 96, 4), (128, 64, 256, 8)])
def test_lora_matmul_grads_match_jax(M, K, N, r):
    rng = np.random.default_rng(M * r)
    x, w, a, b, dy = (rng.standard_normal(s).astype(np.float32) * sc
                      for s, sc in (((M, K), 1.0), ((K, N), 0.1),
                                    ((K, r), 0.1), ((r, N), 0.1),
                                    ((M, N), 1.0)))
    _, vjp = jax.vjp(lambda x, a, b: jref.lora_matmul(x, w, a, b, 2.0),
                     x, a, b)
    want = vjp(jnp.asarray(dy))
    xt, at, bt = (torch.from_numpy(v).requires_grad_() for v in (x, a, b))
    y = ops.lora_matmul(xt, torch.from_numpy(w), at, bt, 2.0)
    got = torch.autograd.grad(y, (xt, at, bt), torch.from_numpy(dy))
    for name, g, wv in zip(("dx", "dA", "dB"), got, want):
        assert _rel(_np(g), np.asarray(wv)) <= 1e-5, name


def test_lora_matmul_zero_b_gives_exact_zero_da():
    """lora_b starts at zero, so the first step's dA is exactly 0."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 32, 4)).astype(np.float32)
                         ).requires_grad_()
    b = torch.zeros(2, 4, 8, requires_grad=True)
    da, db = torch.autograd.grad(ops.lora_matmul(x, w, a, b, 2.0).sum(),
                                 (a, b))
    assert bool((da == 0).all()) and bool((db != 0).any())


def _bhsd(rng, B, H, S, D):
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("B,H,S,D", [(1, 2, 128, 64), (2, 4, 256, 64),
                                     (1, 1, 512, 128)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(B, H, S, D, window, dtype):
    """The JAX (B, H, S, D) layout with K/V expanded; the port reads the
    model layout, so it gets transposed views."""
    rng = np.random.default_rng(B * H * S + window)
    (qj, kj, vj), (qt, kt, vt) = zip(*(_pair(a, dtype)
                                       for a in _bhsd(rng, B, H, S, D)))
    got = _np(ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                  vt.transpose(1, 2), causal=True,
                                  window=window).transpose(1, 2))
    kern = np.asarray(jops.flash_attention(qj, kj, vj, causal=True,
                                           window=window)
                      .astype(jnp.float32))
    oracle = np.asarray(jref.flash_attention(qj, kj, vj, causal=True,
                                             window=window)
                        .astype(jnp.float32))
    np.testing.assert_allclose(got, kern, **_tol(dtype))
    np.testing.assert_allclose(got, oracle, **_tol(dtype))


def test_flash_non_causal_matches_jax():
    rng = np.random.default_rng(9)
    q, k, v = _bhsd(rng, 1, 2, 128, 32)
    got = _np(ref.flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                                    for a in (q, k, v)), causal=False)
              .transpose(1, 2))
    np.testing.assert_allclose(
        got, np.asarray(jops.flash_attention(q, k, v, causal=False)),
        rtol=2e-5, atol=2e-5)


def _model_layout(rng, B, S, H, KH, D):
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KH, D)).astype(np.float32),
            rng.standard_normal((B, S, KH, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KH,D,window", [
    (3, 64, 4, 2, 32, 0), (2, 96, 8, 2, 16, 0), (2, 64, 4, 1, 32, 16)])
def test_flash_attention_gqa_matches_model_attention(B, S, H, KH, D, window):
    """q-head h reads kv-head h // G, as the JAX model's chunked flash."""
    rng = np.random.default_rng(B * S * H)
    q, k, v = _model_layout(rng, B, S, H, KH, D)
    want = np.asarray(jattn.flash_attention(q, k, v, causal=True,
                                            window=window, q_chunk=32,
                                            k_chunk=32))
    got = _np(ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,H,KH,D", [(2, 64, 4, 2, 32), (1, 64, 4, 4, 16)])
def test_flash_attention_grads_match_jax(B, S, H, KH, D):
    rng = np.random.default_rng(S + H + KH)
    q, k, v = _model_layout(rng, B, S, H, KH, D)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal=True, q_chunk=32, k_chunk=32), q, k, v)
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=True)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(_np(g), np.asarray(w)) <= 1e-5, name
