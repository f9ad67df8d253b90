"""The LLM stage's hand-written CUDA kernels against their plain
versions, on the card: ``lora_matmul`` and ``flash_attention``, forward
and backward.  This file imports no JAX, so it runs on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_llm.py

Without a card every case skips: the kernels have no CPU mode.
Tolerances: the JAX kernel tests' own for the forward sweep (float32
2e-5, bfloat16 2e-2, rtol and atol); gradients 2e-5 of the largest
magnitude (float32, sums over up to a few thousand terms taken in
another order than cuBLAS's), 2e-2 in bfloat16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def _rel_err(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def _randn(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("M,K,N,r", [
    (128, 256, 128, 8), (256, 512, 384, 16), (64, 128, 512, 4),
    (32, 64, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_sweep(cuda, M, K, N, r, dtype):
    rng = np.random.default_rng(M + K + N + r)
    x = _randn(rng, (M, K), cuda, dtype)
    w, a, b = (_randn(rng, s, cuda, dtype, 0.05)
               for s in ((K, N), (K, r), (r, N)))
    before = lm.lora_matmul.launches
    got = ops.lora_matmul(x, w, a, b, 2.0)
    assert lm.lora_matmul.launches == before + 1
    want = ref.lora_matmul(x, w, a, b, 2.0)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("C,M,K,N,r", [(3, 1024, 128, 512, 4),
                                       (2, 200, 256, 128, 8)])
def test_lora_matmul_batched_and_grads(cuda, C, M, K, N, r):
    rng = np.random.default_rng(C * M)
    x = _randn(rng, (C, M, K), cuda).requires_grad_()
    w = _randn(rng, (K, N), cuda, scale=0.1)
    a = _randn(rng, (C, K, r), cuda, scale=0.1).requires_grad_()
    b = _randn(rng, (C, r, N), cuda, scale=0.1).requires_grad_()
    dy = _randn(rng, (C, M, N), cuda)
    got = ops.lora_matmul(x, w, a, b, 2.0)
    g = torch.autograd.grad(got, (x, a, b), dy)
    want = ref.lora_matmul(x, w, a, b, 2.0)
    gw = torch.autograd.grad(want, (x, a, b), dy)
    assert _rel_err(got, want) <= 2e-5
    for name, u, v in zip(("dx", "dA", "dB"), g, gw):
        assert _rel_err(u, v) <= 2e-5, name


def test_lora_matmul_zero_b_gives_exact_zero_da(cuda):
    rng = np.random.default_rng(0)
    x = _randn(rng, (2, 64, 128), cuda)
    w = _randn(rng, (128, 64), cuda)
    a = _randn(rng, (2, 128, 4), cuda).requires_grad_()
    b = torch.zeros(2, 4, 64, device=cuda, requires_grad=True)
    (da,) = torch.autograd.grad(ops.lora_matmul(x, w, a, b, 2.0).sum(), (a,))
    assert bool((da == 0).all())


def _qkv(rng, B, S, H, KH, D, dev, dtype=torch.float32):
    return (_randn(rng, (B, S, H, D), dev, dtype),
            _randn(rng, (B, S, KH, D), dev, dtype),
            _randn(rng, (B, S, KH, D), dev, dtype))


@pytest.mark.parametrize("B,H,S,D", [(1, 2, 128, 64), (2, 4, 256, 64),
                                     (1, 1, 512, 128)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_sweep(cuda, B, H, S, D, window, dtype):
    """The JAX test's (B, H, S, D) layout, read through a transposed
    view."""
    rng = np.random.default_rng(B * H * S + window)
    q, k, v = (_randn(rng, (B, H, S, D), cuda, dtype).transpose(1, 2)
               for _ in range(3))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert fa.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_flash_non_causal(cuda):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 128, 2, 2, 32, cuda)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=False),
        ref.flash_attention(q, k, v, causal=False), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,H,KH,D,causal,window", [
    (80, 64, 4, 2, 32, True, 0), (4, 64, 32, 8, 64, True, 0),
    (3, 100, 4, 1, 32, True, 16), (2, 96, 4, 2, 64, False, 0),
    (2, 70, 2, 2, 128, False, 24)])
def test_flash_attention_gqa_and_grads(cuda, B, S, H, KH, D, causal, window):
    rng = np.random.default_rng(B * S + H)
    q, k, v = (t.requires_grad_() for t in _qkv(rng, B, S, H, KH, D, cuda))
    do = _randn(rng, (B, S, H, D), cuda)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    before = fa.flash_attention_bwd.launches
    g = torch.autograd.grad(got, (q, k, v), do)
    assert fa.flash_attention_bwd.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    gw = torch.autograd.grad(want, (q, k, v), do)
    assert _rel_err(got, want) <= 2e-5
    for name, u, w in zip(("dq", "dk", "dv"), g, gw):
        assert _rel_err(u, w) <= 2e-5, name


def _grads_close(got, g, want, gw, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert _rel_err(got, want) <= tol
    for name, u, w in zip(("dq", "dk", "dv"), g, gw):
        assert _rel_err(u, w) <= tol, name


# the tensor-core kernels' tiles: 64 q rows of one q-head a forward CTA,
# 64 keys a K/V tile and a backward CTA (three launches above 64 keys),
# whose visits walk the G q-heads of its kv-head
@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 129])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_tile_edges(cuda, S, G, D):
    rng = np.random.default_rng(S * G + D)
    q, k, v = (t.requires_grad_() for t in _qkv(rng, 2, S, 2 * G, 2, D,
                                                cuda))
    do = _randn(rng, (2, S, 2 * G, D), cuda)
    got = ops.flash_attention(q, k, v)
    g = torch.autograd.grad(got, (q, k, v), do)
    want = ref.flash_attention(q, k, v)
    gw = torch.autograd.grad(want, (q, k, v), do)
    _grads_close(got, g, want, gw, torch.float32)


# an odd count B·S·H of (sequence, position, q-head) rows above 64 keys:
# the backward's dQ slabs follow its rowsum(dO O) area in the workspace
# and are read and written as float2, so that area is padded to 16 bytes
@pytest.mark.parametrize("B,S,H,KH", [(1, 65, 1, 1), (1, 129, 1, 1),
                                      (3, 129, 3, 1), (3, 129, 3, 3)])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_odd_row_count(cuda, B, S, H, KH, D):
    rng = np.random.default_rng(B * S * H + KH + D)
    q, k, v = (t.requires_grad_() for t in _qkv(rng, B, S, H, KH, D, cuda))
    do = _randn(rng, (B, S, H, D), cuda)
    got = ops.flash_attention(q, k, v)
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.side_launches)
    g = torch.autograd.grad(got, (q, k, v), do)
    assert (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.side_launches) == (before[0] + 1,
                                                      before[1] + 2)
    want = ref.flash_attention(q, k, v)
    gw = torch.autograd.grad(want, (q, k, v), do)
    _grads_close(got, g, want, gw, torch.float32)


@pytest.mark.parametrize("S", [65, 129])
@pytest.mark.parametrize("causal,window", [(True, 16), (True, 64),
                                           (False, 0), (False, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_masks_and_dtypes(cuda, S, causal, window, dtype):
    rng = np.random.default_rng(S + window + causal)
    q, k, v = (t.requires_grad_() for t in _qkv(rng, 2, S, 4, 2, 64, cuda,
                                                dtype))
    do = _randn(rng, (2, S, 4, 64), cuda, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    g = torch.autograd.grad(got, (q, k, v), do)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    gw = torch.autograd.grad(want, (q, k, v), do)
    _grads_close(got, g, want, gw, dtype)


@pytest.mark.parametrize("S,H,KH", [(64, 8, 2), (129, 8, 2), (300, 8, 2),
                                    (129, 3, 1)])
def test_flash_attention_bwd_is_repeatable_one_launch_a_call(cuda, S, H, KH):
    """One k-tile (S <= 64) finishes dQ in its CTA; above, the k-tiles'
    dQ slabs are summed in a fixed order: two calls agree bit for bit,
    and each call counts one launch (and two side passes above 64
    keys)."""
    rng = np.random.default_rng(S + H)
    q, k, v = _qkv(rng, 3, S, H, KH, 64, cuda)
    do = _randn(rng, (3, S, H, 64), cuda)
    out, lse = fa._forward(q, k, v, True, 0, 64 ** -0.5)
    before = fa.flash_attention_bwd.launches
    side = fa.flash_attention_bwd.side_launches
    first = fa.flash_attention_bwd(q, k, v, out, lse, do)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert fa.flash_attention_bwd.launches == before + 2
    assert fa.flash_attention_bwd.side_launches == side + (4 if S > 64 else 0)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_wrappers_reject_bad_operands(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError):
        lm.lora_matmul(x, torch.zeros(16, 8, device=cuda),
                       torch.zeros(2, 16, 40, device=cuda),
                       torch.zeros(2, 40, 8, device=cuda), 1.0)  # rank 40
    q = torch.zeros(1, 8, 4, 48, device=cuda)                    # D = 48
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])


# ---------------------------------------------------------------------------
# the tensor-core kernel's tiles (128 x 128, reduction steps of 32, rank
# padded to 8, 16 or 32) and its split reduction for small grids
# ---------------------------------------------------------------------------
def _lora_operands(rng, C, M, K, N, r, dev, dtype=torch.float32):
    return (_randn(rng, (C, M, K), dev, dtype),
            _randn(rng, (K, N), dev, dtype, K ** -0.5),
            _randn(rng, (C, K, r), dev, dtype, K ** -0.5),
            _randn(rng, (C, r, N), dev, dtype, 0.1))


@pytest.mark.parametrize("C,M,K,N,r", [
    (1, 63, 77, 65, 4), (2, 65, 33, 127, 8), (1, 127, 100, 129, 16),
    (3, 129, 31, 63, 32), (1, 1, 3, 1, 1), (2, 200, 64, 128, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_ragged_edges(cuda, C, M, K, N, r, dtype):
    rng = np.random.default_rng(C + M + K + N + r)
    x, w, a, b = _lora_operands(rng, C, M, K, N, r, cuda, dtype)
    got = ops.lora_matmul(x, w, a, b, 2.0)
    want = ref.lora_matmul(x, w, a, b, 2.0)
    if dtype == torch.float32:
        assert _rel_err(got, want) <= 2e-5
    else:
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("r", range(1, 33))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_every_rank(cuda, r, dtype):
    rng = np.random.default_rng(r)
    x, w, a, b = _lora_operands(rng, 2, 96, 160, 136, r, cuda, dtype)
    got = ops.lora_matmul(x, w, a, b, 2.0)
    want = ref.lora_matmul(x, w, a, b, 2.0)
    if dtype == torch.float32:
        assert _rel_err(got, want) <= 2e-5
    else:
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("C,M,K,N,r", [(2, 129, 77, 65, 4),
                                       (5, 1024, 128, 512, 4),
                                       (1, 64, 96, 2048, 32)])
def test_lora_matmul_dx_on_transposed_views(cuda, C, M, K, N, r):
    """dx = dy@Wᵀ + s·(dy@Bᵀ)@Aᵀ: the kernel on transposed views, with
    no copies, against the plain version on contiguous copies."""
    rng = np.random.default_rng(C * K + N)
    x, w, a, b = _lora_operands(rng, C, M, K, N, r, cuda)
    dy = _randn(rng, (C, M, N), cuda)
    wt, at, bt = w.t(), b.transpose(1, 2), a.transpose(1, 2)
    assert not wt.is_contiguous()
    got = lm._launch(dy, wt, at, bt, 2.0)
    want = ref.lora_matmul(dy, wt.contiguous(), at.contiguous(),
                           bt.contiguous(), 2.0)
    assert _rel_err(got, want) <= 2e-5


@pytest.mark.parametrize("C,M,K,N,r", [(1, 256, 1024, 128, 8),
                                       (5, 1024, 512, 128, 4),
                                       (2, 100, 4000, 70, 32)])
def test_lora_matmul_split_reduction_is_deterministic(cuda, C, M, K, N, r):
    """A small grid with a long reduction is split; the second pass sums
    the splits in a fixed order, so two launches agree bit for bit, and
    the wrapper counts one launch a call."""
    rng = np.random.default_rng(K + r)
    x, w, a, b = _lora_operands(rng, C, M, K, N, r, cuda)
    assert lm._library().lm_workspace(C, M, N, K, r) > 0
    before = lm.lora_matmul.launches
    y1 = ops.lora_matmul(x, w, a, b, 2.0)
    y2 = ops.lora_matmul(x, w, a, b, 2.0)
    assert lm.lora_matmul.launches == before + 2
    assert torch.equal(y1, y2)
    assert _rel_err(y1, ref.lora_matmul(x, w, a, b, 2.0)) <= 2e-5


def test_a_clients_step_does_not_depend_on_the_clients_beside_it(cuda):
    """A client's projection, its gradients and its CE loss and hidden
    gradient in a step of three clients are bitwise the same client's
    step alone, at a grid the kernel does not split at C = 1 (the
    sequential stage against the batched engine)."""
    from types import SimpleNamespace
    from repro_torch.models import model as M
    C, Mr, K, N, r, V = 3, 1024, 2048, 2048, 8, 4102
    rng = np.random.default_rng(7)
    x, w, a, b = _lora_operands(rng, C, Mr, K, N, r, cuda)
    g = _randn(rng, (C, Mr, N), cuda)
    cfg = SimpleNamespace(tie_embeddings=False)
    params = {"lm_head": _randn(rng, (N, V), cuda, scale=0.02)}
    labels = torch.from_numpy(rng.integers(-1, V, (C, 16, Mr // 16))).to(
        cuda)

    def step(sl):
        xs, as_, bs = (t[sl].detach().clone().requires_grad_()
                       for t in (x, a, b))
        y = ops.lora_matmul(xs, w, as_, bs, 2.0)
        hidden = y.reshape(-1, 16, Mr // 16, N)
        loss = M.chunked_ce(cfg, params, hidden, labels[sl])
        dx, da, db = torch.autograd.grad(
            (y * g[sl]).sum() + loss.sum(), (xs, as_, bs))
        return y, loss, dx, da, db

    together = step(slice(0, C))
    for c in range(C):
        alone = step(slice(c, c + 1))
        for t, u in zip(together, alone):
            assert torch.equal(t[c:c + 1], u)
