"""The mixture-of-experts and latent-attention families on the card: the
kernels at the head dims and projection shapes they bring, and each
``-smoke`` config's prefill and serve steps against the port's CPU path.
This file imports no JAX, so it runs on a machine with a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_families.py

Without a card every case skips.  Tolerances: ``flash_attention``
forward and dq/dk/dv within 2e-5 (float32) or 2e-2 (bfloat16) of the
largest magnitude of the plain version and plain autograd
(``chip_smoke.py``'s attention bounds); ``lora_matmul`` within 1e-5
(float32) or 2e-2 (bfloat16) of the largest magnitude of its plain
version; the models at ``tests/test_torch_cuda_decode.py``'s bounds
(float32: logits 1e-4 of the largest, caches, a decode cache in the
model's dtype, 1e-4; bfloat16: 3e-2 and 2e-2), a bfloat16 row of logits
over its bound only as a routing flip: a token of that row routed within
1e-2 of a tie in probability on the card (``tests/torch_families.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ref
from repro_torch.models import ffn
from repro_torch.models import model as M
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

FAMILIES = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "minicpm3-4b"]
B, P, STEPS = 2, 24, 12
FLIP_MARGIN = 1e-2
# (K, N) of every adapted projection the families bring, rank 16:
# minicpm3-4b's MLA (wq_a, wq_b, wkv_a, wkv_b, wo) and kimi-k2's GQA
# (wq, wkv, wo)
PROJECTIONS = ((2560, 768), (768, 3840), (2560, 288), (256, 5120),
               (2560, 2560), (7168, 7168), (7168, 1792))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv", [(48, 32), (48, 48), (80, 80), (96, 64),
                                  (96, 96), (112, 112)])
@pytest.mark.parametrize("B_,S,H,KH,window", [(2, 64, 4, 2, 0),
                                              (1, 129, 1, 1, 0),
                                              (2, 130, 8, 2, 16),
                                              (3, 33, 4, 4, 0)])
def test_flash_attention_at_new_head_dims(cuda, D, Dv, dtype, B_, S, H, KH,
                                          window):
    """Forward and backward at stablelm's 80, MLA's 96 over a v of 64
    (zero-padded to 96 by the wrapper; 48 over 32 at -smoke width) and
    kimi-k2's 112, at one and three key tiles, an odd B·S·H above 64
    keys, and a window."""
    gen = torch.Generator(device=cuda).manual_seed(D + Dv + S)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    q = rand(B_, S, H, D).requires_grad_()
    k = rand(B_, S, KH, D).requires_grad_()
    v = rand(B_, S, KH, Dv).requires_grad_()
    do = rand(B_, S, H, Dv)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    assert fa.flash_attention.launches == n + 1
    assert got.shape == (B_, S, H, Dv) and got.is_contiguous()
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    assert _rel(got, want) <= tol
    grads = torch.autograd.grad(got, (q, k, v), do)
    wants = torch.autograd.grad(want, (q, k, v), do)
    for what, g, w in zip(("dq", "dk", "dv"), grads, wants):
        assert g.shape == w.shape
        assert _rel(g, w) <= tol, what


def test_flash_attention_rejects_a_wider_v_and_other_head_dims(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        fa.flash_attention(q, q, torch.zeros(1, 8, 2, 80, device=cuda))
    q = torch.zeros(1, 8, 2, 72, device=cuda)
    with pytest.raises(ValueError, match="head dim 72"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", PROJECTIONS)
@pytest.mark.parametrize("M_", [4, 128])
def test_lora_matmul_at_the_families_projections(cuda, K, N, M_, dtype):
    """One client, rank 16: a serve step's M = 4 rows and a prefill's
    128; ``wkv_a``'s N = 288 is no multiple of 128."""
    gen = torch.Generator(device=cuda).manual_seed(K + N + M_)
    r = 16

    def rand(shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * scale).to(dtype)

    x, w = rand((1, M_, K)), rand((K, N), K ** -0.5)
    a, b = rand((1, K, r), K ** -0.5), rand((1, r, N), 0.1)
    n = lm.lora_matmul.launches
    got = lm.lora_matmul(x, w, a, b, 2.0)
    assert lm.lora_matmul.launches == n + 1
    want = ref.lora_matmul(x, w, a, b, 2.0)
    assert _rel(got, want) <= (2e-2 if dtype == torch.bfloat16 else 1e-5)


def _model(cfg, dtype, device):
    """((params, adapters) on the CPU, the same on ``device``): drawn on
    the card and copied, ``lora_b`` + 0.01."""
    key = jr.PRNGKey(0)
    params = M.init_params(cfg, key, dtype=dtype, device=device)
    adapters = [{k: v + 0.01 if "lora_b" in k else v for k, v in a.items()}
                for a in M.init_adapters(cfg, key, params)]
    cpu = lambda t: t.cpu()  # noqa: E731
    return ((tree_map(cpu, params), tree_map(cpu, adapters)),
            (params, adapters))


def _routed(fn, *args):
    """``fn(*args)`` with each row's smallest routing margin (near a tie)
    over its ``ffn.route`` calls; None when nothing was routed."""
    calls, orig = [], ffn.route

    def spy(logits, m):
        r = orig(logits, m)
        top = torch.sort(r.probs, -1, descending=True).values[:, :m.top_k + 1]
        calls.append((top[:, :-1] - top[:, 1:]).min(-1).values.cpu())
        return r
    ffn.route = spy
    try:
        out = fn(*args)
    finally:
        ffn.route = orig
    if not calls:
        return out, None
    return out, torch.stack([c.reshape(B, -1).min(-1).values
                             for c in calls]).min(0).values


def _check_logits(got, want, dtype, margins, what):
    bound = 3e-2 if dtype == torch.bfloat16 else 1e-4
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max(-1).values / want.abs().max()
    for row, e in enumerate(err.tolist()):
        if e <= bound:
            continue
        m = float(margins[row]) if (margins is not None
                                    and dtype == torch.bfloat16) else 1.0
        assert m < FLIP_MARGIN, f"{what} row {row}: {e:.3g} over {bound}"
        print(f"{what} row {row}: {e:.3g}, a routing flip at a margin "
              f"of {m:.3g}")


def _adapted(cfg, decode: bool) -> int:
    """lora_matmul launches of one pass: every adapted projection a
    layer, but MLA's ``wkv_b`` in decode (the absorbed form reads its
    base weight)."""
    n = 0
    for i in range(cfg.n_layers):
        mixer, ffn_ = cfg.pattern[i % len(cfg.pattern)]
        n += 3 if mixer == "attn" else (4 if decode else 5)
        n += 2 if ffn_ == "mlp" else 0
    return n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_serve_steps_match_the_cpu(cuda, name, dtype):
    cfg = get(name + "-smoke")
    cpu_model, card_model = _model(cfg, dtype, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab_size - 4, (B, P)))
    prefill = M.make_prefill_step(cfg)
    n_lm, n_fa = lm.lora_matmul.launches, fa.flash_attention.launches
    (gl, gc), marg = _routed(prefill, *card_model, {"tokens": toks.to(cuda)})
    assert lm.lora_matmul.launches - n_lm == _adapted(cfg, False)
    assert fa.flash_attention.launches - n_fa == cfg.n_layers
    wl, wc = prefill(*cpu_model, {"tokens": toks})
    _check_logits(gl, wl, dtype, marg, f"{name} prefill")
    bound = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for gp, wp in zip(gc, wc):
        for g, w in zip(gp, wp):
            assert g.shape == w.shape and _rel(g, w) <= bound
    serve = M.make_serve_step(cfg)
    # the decode cache in the model's dtype: a bfloat16 one rounds a
    # float32 model's k, v and softmax, and a flip of that rounding
    # between two devices' float32 values moves a logit by 1e-4 (seen at
    # kimi-k2-smoke)
    caches = {dev: M.init_cache(cfg, B, STEPS, dtype=dtype, device=dev)
              for dev in ("cuda", "cpu")}
    for p in range(STEPS):
        tok = toks[:, p:p + 1]
        n_lm = lm.lora_matmul.launches
        (g, caches["cuda"]), marg = _routed(serve, *card_model,
                                            caches["cuda"], tok.to(cuda), p)
        assert lm.lora_matmul.launches - n_lm == _adapted(cfg, True)
        w, caches["cpu"] = serve(*cpu_model, caches["cpu"], tok, p)
        assert bool(torch.isfinite(g).all())
        _check_logits(g, w, dtype, marg, f"{name} step {p}")
        for gp, wp in zip(caches["cuda"], caches["cpu"]):
            for gt, wt in zip(gp, wp):
                assert _rel(gt, wt) <= bound, f"{name} step {p} cache"
