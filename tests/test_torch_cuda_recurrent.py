"""The recurrent families on the card: the Mamba and xLSTM mixers, and
jamba-1.5-large-398b-smoke's and xlstm-125m-smoke's prefill and serve
steps, against the port's CPU path on the same weights.  The mixers are
plain torch (the JAX package's are jnp, outside any Pallas kernel); the
paths run ``lora_matmul`` on every adapted projection and jamba's
attention prefill through ``flash_attention``, whose launches are
counted.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_recurrent.py

Without a card every case skips.  Tolerances: ``tests/test_torch_cuda_
decode.py``'s.  Float32: outputs, logits and states within 1e-4 of the
largest magnitude.  bfloat16: logits within 3e-2, states within 2e-2 or
twice the CPU port's own bfloat16 gap at that layer (its bfloat16 run
against its float32 run on the same weights) if larger, row by row; a
row over its bound only as a routing flip, a token of that row routed
within 1e-2 of a tie in that call or an earlier one on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.models import ffn
from repro_torch.models import model as M
from repro_torch.models import ssm, xlstm
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

NAMES = ["jamba-1.5-large-398b", "xlstm-125m"]
B, P, STEPS = 2, 24, 12
FLIP_MARGIN = 1e-2
# the projections a layer runs through ``common.dense`` with its LoRA
# pair, by mixer and feed-forward block
ADAPTABLE = {"attn": ("wq", "wkv", "wo"), "mamba": ("in_proj", "out_proj"),
             "mlstm": ("up_proj", "wq", "wk", "wv", "down_proj"),
             "slstm": ("w_gates",), "mlp": ("w_in", "w_out"),
             "moe": ("shared_w_in", "shared_w_out"), "none": ()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _row_errs(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().reshape(got.shape[0], -1).max(-1).values
            / want.abs().max()).tolist()


def _adapted(cfg) -> int:
    n = 0
    for i in range(cfg.n_layers):
        mixer, ffn_ = cfg.pattern[i % len(cfg.pattern)]
        n += len(set(ADAPTABLE[mixer] + ADAPTABLE[ffn_])
                 & set(cfg.lora.targets))
    return n


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
    """``fn(*args)`` and each row's smallest routing margin over its
    ``ffn.route`` calls (None when nothing was routed)."""
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


def _check_rows(got, want, bound, margins, what):
    for row, e in enumerate(_row_errs(got, want)):
        if e <= bound:
            continue
        m = float(margins[row]) if margins is not None else 1.0
        assert m < FLIP_MARGIN, f"{what} row {row}: {e:.3g} over {bound}"
        print(f"{what} row {row}: {e:.3g}, a routing flip at a margin "
              f"of {m:.3g}")


def _layer(mixer, dtype, device):
    cfg = get(("jamba-1.5-large-398b" if mixer == "mamba" else "xlstm-125m")
              + "-smoke")
    key = jr.PRNGKey(3)
    init = {"mamba": ssm.mamba_params, "mlstm": xlstm.mlstm_params,
            "slstm": xlstm.slstm_params}[mixer]
    p = init(key, cfg, dtype, device=device)
    return cfg, p, tree_map(lambda t: t.cpu(), p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["mamba_train", "mlstm_train",
                                  "mlstm_train_chunkwise", "slstm_train"])
def test_mixer_train_and_decode_match_the_cpu(cuda, form, dtype):
    """Each train form over 128 tokens, then 4 decode steps from its
    state (the mLSTM's from zeros: its prefill state has no conv), the
    card against the CPU."""
    mixer = form.split("_")[0]
    cfg, p_card, p_cpu = _layer(mixer, dtype, cuda)
    mod = ssm if mixer == "mamba" else xlstm
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, B, 128, cfg.d_model, generator=gen).to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    gy, gs = getattr(mod, form)(p_card, cfg, x.to(cuda))
    wy, ws = getattr(mod, form)(p_cpu, cfg, x)
    assert _rel(gy, wy) <= tol
    for g, w in zip(gs, ws):
        assert g.dtype == w.dtype and _rel(g, w) <= tol
    from repro_torch.models import layers
    states = [tuple(t.clone() for t in s) if mixer != "mlstm" else
              layers.cache_struct(cfg, "mlstm", B, 1, dtype, dev)
              for dev, s in ((cuda, gs), ("cpu", ws))]
    dec = getattr(mod, f"{mixer}_decode")
    for t in range(4):
        xt = x[:, :, t:t + 1]
        if mixer == "mamba":
            gy, _ = dec(p_card, cfg, xt.to(cuda), *states[0])
            wy, _ = dec(p_cpu, cfg, xt, *states[1])
        else:
            gy, _ = dec(p_card, cfg, xt.to(cuda), states[0])
            wy, _ = dec(p_cpu, cfg, xt, states[1])
        assert _rel(gy, wy) <= tol
        for g, w in zip(*states):
            assert _rel(g, w) <= tol


def _serve(cfg, model, toks, dtype, device):
    """Prefill on ``toks`` and STEPS serve steps fed ``toks`` from an
    empty cache in ``dtype``: ((prefill logits, caches, margins), [(step
    logits, cache copy, running margins), ...], launches)."""
    prefill, serve = M.make_prefill_step(cfg), M.make_serve_step(cfg)
    n_lm, n_fa = lm.lora_matmul.launches, fa.flash_attention.launches
    (pl, pc), pm = _routed(prefill, *model, {"tokens": toks.to(device)})
    launches = {"prefill": (lm.lora_matmul.launches - n_lm,
                            fa.flash_attention.launches - n_fa)}
    cache = M.init_cache(cfg, B, STEPS, dtype=dtype, device=device)
    steps, low = [], None
    n_lm = lm.lora_matmul.launches
    for p in range(STEPS):
        (sl, cache), m = _routed(serve, *model, cache,
                                 toks[:, p:p + 1].to(device), p)
        low = m if low is None or m is None else torch.minimum(low, m)
        steps.append((sl, [tuple(t.clone() for t in c) for c in cache],
                      low))
    launches["steps"] = lm.lora_matmul.launches - n_lm
    return (pl, pc, pm), steps, launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_serve_steps_match_the_cpu(cuda, name, dtype):
    """Prefill and 12 serve steps, the card against the CPU on the same
    weights; the launches of ``lora_matmul`` (every adapted projection)
    and ``flash_attention`` (every attention layer in prefill, none in a
    serve step)."""
    cfg = get(name + "-smoke")
    cpu_model, card_model = _model(cfg, dtype, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab_size - 4, (B, P)))
    card, card_steps, n = _serve(cfg, card_model, toks, dtype, cuda)
    cpu, cpu_steps, _ = _serve(cfg, cpu_model, toks, dtype, "cpu")
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)][0] == "attn"
                 for i in range(cfg.n_layers))
    assert n["prefill"] == (_adapted(cfg), n_attn)
    assert n["steps"] == STEPS * _adapted(cfg)
    own = [0.0] * cfg.n_layers
    if dtype == torch.bfloat16:
        f32 = tree_map(lambda t: t.float(), cpu_model)
        ref, ref_steps, _ = _serve(cfg, f32, toks, torch.float32, "cpu")
        for got, want in [(cpu[1], ref[1])] + [
                (a[1], b[1]) for a, b in zip(cpu_steps, ref_steps)]:
            own = [max(o, max(_rel(g, w) for g, w in zip(gl, wl)))
                   for o, gl, wl in zip(own, got, want)]
    lt = 3e-2 if dtype == torch.bfloat16 else 1e-4
    for what, (gl, gc, gm), (wl, wc, _) in (
            [("prefill", card, cpu)]
            + [(f"step {p}", g, w)
               for p, (g, w) in enumerate(zip(card_steps, cpu_steps))]):
        assert bool(torch.isfinite(gl).all())
        _check_rows(gl, wl, lt, gm if dtype == torch.bfloat16 else None,
                    f"{name} {what} logits")
        for i, (gp, wp) in enumerate(zip(gc, wc)):
            for j, (g, w) in enumerate(zip(gp, wp)):
                assert g.shape == w.shape and g.dtype == w.dtype
                if dtype == torch.bfloat16:
                    _check_rows(g, w, max(2e-2, 2 * own[i]), gm,
                                f"{name} {what} layer {i} state {j}")
                else:
                    assert _rel(g, w) <= 1e-4, (what, i, j)
