"""The encoder-decoder and vision families on the card: ``flash_attention``
in the modes they add (non-causal self-attention over whisper's 1500
frames, cross-attention with ``Sq != Sk`` over a ragged last key tile,
causal at qwen2-vl's head dim 128 and 1024 patches plus a prompt), its
backward there, ``lora_matmul`` at whisper's encoder rows, and
whisper-large-v3-smoke's and qwen2-vl-72b-smoke's prefill and serve
steps against the port's CPU path on the same weights.  This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_frontends.py

Without a card every case skips.  Tolerances: the kernel tests' own
(``tests/test_torch_cuda_llm.py``: float32 2e-5, bfloat16 2e-2, of the
largest magnitude or 1) and ``tests/test_torch_cuda_decode.py``'s for
the models (float32 logits and caches 1e-4 of the largest; bfloat16
logits 3e-2, caches 2e-2).
"""
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

B, P, STEPS = 2, 24, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype) -> float:
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _randn(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev, dtype)


def _attn_case(cuda, Bq, Sq, Sk, H, KH, D, causal, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (Bq, Sq, H, D), cuda, dtype)
    k = _randn(rng, (Bq, Sk, KH, D), cuda, dtype)
    v = _randn(rng, (Bq, Sk, KH, D), cuda, dtype)
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal)
    assert got.shape == (Bq, Sq, H, D) and got.dtype == dtype
    assert _rel_err(got, want) <= _tol(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_self_attention_over_1500_frames(cuda, dtype):
    """Whisper's encoder: non-causal, S = Sk = 1500 (23 full 64-key tiles
    and 28 keys), H = KH = 20, D = 64."""
    _attn_case(cuda, 2, 1500, 1500, 20, 20, 64, False, dtype, 1)


@pytest.mark.parametrize("Sq", [1, 32, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_over_1500_frames(cuda, Sq, dtype):
    """Whisper's cross-attention: Sq prompt rows against Sk = 1500 frame
    keys, non-causal."""
    _attn_case(cuda, 2, Sq, 1500, 20, 20, 64, False, dtype, Sq)


@pytest.mark.parametrize("S", [1056, 1536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_attention_at_qwen2_vl_widths(cuda, S, dtype):
    """qwen2-vl's prefill: 1024 patches and a prompt of 32 or 512
    tokens, causal, 64 q-heads over 8 kv-heads of 128."""
    _attn_case(cuda, 1, S, S, 64, 8, 128, True, dtype, S)


@pytest.mark.parametrize("Sq", [32, 512])
def test_cross_attention_backward_over_1500_frames(cuda, Sq):
    """The backward at non-causal Sq != Sk = 1500 (its three-launch path,
    above 64 keys): within the float32 bound of plain autograd, and two
    calls bitwise equal, each one call and two side launches."""
    rng = np.random.default_rng(Sq + 7)
    q = _randn(rng, (2, Sq, 4, 64), cuda)
    k = _randn(rng, (2, 1500, 4, 64), cuda)
    v = _randn(rng, (2, 1500, 4, 64), cuda)
    do = _randn(rng, (2, Sq, 4, 64), cuda)
    out, lse = fa._forward(q, k, v, False, 0, 64 ** -0.5)
    n, side = fa.flash_attention_bwd.launches, \
        fa.flash_attention_bwd.side_launches
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    assert fa.flash_attention_bwd.launches == n + 2
    assert fa.flash_attention_bwd.side_launches == side + 4
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    want = ref.flash_attention(qr, kr, vr, causal=False)
    gw = torch.autograd.grad(want, (qr, kr, vr), do)
    assert _rel_err(out, want) <= 2e-5
    for name, g, w in zip(("dq", "dk", "dv"), first, gw):
        assert _rel_err(g, w) <= 2e-5, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_matmul_at_the_encoder_rows(cuda, dtype):
    """Whisper's encoder ``w_out`` over 4 × 1500 frames: M = 6000, K =
    5120, N = 1280, rank 16."""
    rng = np.random.default_rng(6000)
    x = _randn(rng, (1, 6000, 5120), cuda, dtype)
    w = _randn(rng, (5120, 1280), cuda, dtype, 5120 ** -0.5)
    a = _randn(rng, (1, 5120, 16), cuda, dtype, 5120 ** -0.5)
    b = _randn(rng, (1, 16, 1280), cuda, dtype, 0.1)
    before = lm.lora_matmul.launches
    got = ops.lora_matmul(x, w, a, b, 2.0)
    assert lm.lora_matmul.launches == before + 1
    assert _rel_err(got, ref.lora_matmul(x, w, a, b, 2.0)) <= _tol(dtype)


def _bumped(tree):
    """An adapter set (a list of layer dicts, or an encoder-decoder's
    ``{"layers", "enc_layers"}``) with ``lora_b`` + 0.01."""
    if isinstance(tree, list):
        return [_bumped(t) for t in tree]
    if all(isinstance(v, list) for v in tree.values()):
        return {k: _bumped(v) for k, v in tree.items()}
    return {k: v + 0.01 if "lora_b" in k else v for k, v in tree.items()}


def _model(cfg, dtype, device):
    """((params, adapters) on the CPU, the same on ``device``): drawn on
    the card and copied, ``lora_b`` + 0.01."""
    key = jr.PRNGKey(0)
    params = M.init_params(cfg, key, dtype=dtype, device=device)
    adapters = _bumped(M.init_adapters(cfg, key, params))
    cpu = lambda t: t.cpu()  # noqa: E731
    return ((tree_map(cpu, params), tree_map(cpu, adapters)),
            (params, adapters))


def _serve(cfg, model, batch, dtype, device):
    """Prefill on ``batch`` and STEPS serve steps from its cache, fed the
    prompt again: (prefill logits, caches, [(step logits, cache copy)],
    launches)."""
    prefill, serve = M.make_prefill_step(cfg), M.make_serve_step(cfg)
    batch = {k: v.to(device) for k, v in batch.items()}
    n_lm, n_fa = lm.lora_matmul.launches, fa.flash_attention.launches
    pl, pc = prefill(*model, batch)
    launches = {"prefill": (lm.lora_matmul.launches - n_lm,
                            fa.flash_attention.launches - n_fa)}
    rows = pc[0][0][0].shape[1] if cfg.encoder_decoder else pc[0][0].shape[1]
    cache = M.init_cache(cfg, B, rows + STEPS, dtype=dtype, device=device)
    own = cache[0] if cfg.encoder_decoder else cache
    for i, layer in enumerate(pc):
        for c, p in zip(own[i], layer[0] if cfg.encoder_decoder else layer):
            c[:, :rows] = p
        if cfg.encoder_decoder:
            for c, p in zip(cache[1][i], layer[1]):
                c.copy_(p)
    steps = []
    n_lm, n_fa = lm.lora_matmul.launches, fa.flash_attention.launches
    toks = batch["tokens"]
    for s in range(STEPS):
        sl, cache = serve(*model, cache, toks[:, s:s + 1], rows + s)
        steps.append((sl, tree_map(torch.clone, cache)))
    launches["steps"] = (lm.lora_matmul.launches - n_lm,
                         fa.flash_attention.launches - n_fa)
    return pl, pc, steps, launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["whisper-large-v3", "qwen2-vl-72b"])
def test_prefill_and_serve_steps_match_the_cpu(cuda, name, dtype):
    """Prefill with the stub frontend and 12 serve steps from its cache,
    the card against the CPU on the same weights, and the launches:
    whisper-smoke's prefill 5 ``lora_matmul`` a layer of each stack and
    3 ``flash_attention`` (the encoder's, the decoder's causal and its
    cross-attention), a serve step 5 and none; qwen2-vl-smoke's 5 and 1,
    then 5 and 0."""
    cfg = get(name + "-smoke")
    cpu_model, card_model = _model(cfg, dtype, cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        4, cfg.vocab_size - 4, (B, P))),
             "frontend": torch.from_numpy(rng.standard_normal(
                 (B, cfg.n_frontend_tokens, cfg.d_model)).astype(
                 np.float32)).to(dtype)}
    gl, gc, gsteps, n = _serve(cfg, card_model, batch, dtype, cuda)
    wl, wc, wsteps, _ = _serve(cfg, cpu_model, batch, dtype, "cpu")
    want = ((10, 3), (STEPS * 5, 0)) if cfg.encoder_decoder else \
        ((5, 1), (STEPS * 5, 0))
    assert (n["prefill"], n["steps"]) == want
    lt, ct = (3e-2, 2e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    for what, (g, w) in [("prefill", ((gl, gc), (wl, wc)))] + [
            (f"step {s}", pair) for s, pair in enumerate(zip(gsteps,
                                                           wsteps))]:
        assert bool(torch.isfinite(g[0]).all())
        assert _rel(g[0], w[0]) <= lt, what
        for i, (a, b) in enumerate(zip(tree_leaves(g[1]),
                                       tree_leaves(w[1]))):
            assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
            assert _rel(a, b) <= ct, (what, i, _rel(a, b))
