"""The vision-language family served and trained by the port against the
JAX package: ``qwen2-vl-72b-smoke`` (one layer, d_model 256, 4/1 heads
of 64, M-RoPE sections (8, 12, 12), 16 stub patch embeddings prepended
to the prompt), on the JAX package's weights carried across by
``convert`` (``lora_b`` + 0.01), float32 and bfloat16 base.

Held: ``rope_freqs`` with sections and the GQA projections that use
them; the base draw (``proj_frontend``); prefill's logits and its cache
over the patch prefix and the prompt; 12 serve steps from prefill's
cache at positions after both; 100 patches, no multiple of 64; one
train step; prefill against prefill over one token fewer plus a serve
step.  Tolerances: ``tests/torch_frontends.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs.registry import get as tget
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map
from torch_families import KEY, draw_gaps, np_tree, smoke_model
from torch_frontends import (B, CACHE_TOL, LOGITS_TOL, STEPS, check_tree,
                             draw_inputs, jax_prefill, jax_seeded,
                             port_seeded, rel, steps_both)

torch.set_num_threads(1)

NAME = "qwen2-vl-72b"
DTYPES = ["float32", "bfloat16"]
S = 12


@pytest.fixture(scope="module")
def models():
    cache = {}

    def build(dtype, patches=None):
        if (dtype, patches) not in cache:
            m = smoke_model(NAME, dtype)
            if patches:
                m = dict(m, jcfg=dataclasses.replace(
                    m["jcfg"], n_frontend_tokens=patches),
                    tcfg=dataclasses.replace(m["tcfg"],
                                             n_frontend_tokens=patches))
            cache[dtype, patches] = m
        return cache[dtype, patches]
    return build


@pytest.mark.parametrize("head_dim,sections", [
    (128, (16, 24, 24)), (64, (8, 12, 12)), (64, (32,)), (96, (10, 14, 24)),
    (128, ())])
def test_rope_freqs_match_jax(head_dim, sections):
    """The concatenated per-section ladders ``1/θ^(i·2/(2·sec))`` (or the
    plain ladder without sections), float32, within 1 ulp of JAX's."""
    for theta in (1e6, 1e4):
        got = tcommon.rope_freqs(head_dim, theta, sections)
        want = np.asarray(jcommon.rope_freqs(head_dim, theta, sections))
        assert got.dtype == torch.float32 and got.shape == (head_dim // 2,)
        np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23, atol=0)
    with pytest.raises(AssertionError):
        tcommon.rope_freqs(64, 1e6, (8, 8))


def test_reduced_rescales_the_sections():
    assert tget(NAME).mrope_sections == (16, 24, 24)
    assert tget(NAME + "-smoke").mrope_sections == (8, 12, 12) == \
        jget(NAME + "-smoke").mrope_sections
    assert sum(tget(NAME + "-smoke").mrope_sections) == \
        tget(NAME + "-smoke").head_dim // 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_gqa_qkv_with_mrope_matches_jax(models, dtype):
    """The layer's q, k (rotated over the sectioned ladders) and v at
    positions past the patch prefix."""
    m = models(dtype)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jl = jax.tree.map(lambda x: x[0], m["jp"]["groups"][0])
    ja = jax.tree.map(lambda x: x[0], m["ja"]["groups"][0])
    tl = {**m["tp"]["layers"][0],
          **{k: v[None] for k, v in m["ta"][0].items()}}
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)), jnp.dtype(dtype))
    pos = np.arange(40, 40 + S)
    _, jq, jk, jv = jattn.gqa_qkv({**jl, **ja}, jcfg, x,
                                  jnp.broadcast_to(jnp.asarray(pos), (B, S)))
    with torch.no_grad():
        _, tq, tk, tv = tattn.gqa_qkv(tl, tcfg,
                                      convert.from_jax(np.asarray(x))[None],
                                      torch.from_numpy(pos))
    for g, w in ((tq, jq), (tk, jk), (tv, jv)):
        assert rel(g, w) <= CACHE_TOL[dtype]


def test_init_params_follow_jax_key_tree():
    """The port's own draw: the JAX package's leaves by name and shape,
    ``proj_frontend`` ``(d, d)`` from ``keys[2]`` among them, values to
    the draw's contract; a decoder-only model's adapters stay a list."""
    jcfg, tcfg = jget(NAME + "-smoke"), tget(NAME + "-smoke")
    jp = JM.init_params(jcfg, KEY)
    tp = M.init_params(tcfg, np.asarray(KEY), device="cpu")
    want = convert.params_from_jax(np_tree(jp))
    assert "proj_frontend" in tp and "enc_layers" not in tp
    n = same = 0
    for gl, wl in zip(tp["layers"] + [
            {k: v for k, v in tp.items() if k != "layers"}],
            want["layers"] + [
                {k: v for k, v in want.items() if k != "layers"}]):
        a, b = draw_gaps(gl, wl)
        n, same = n + a, same + b
    assert same >= 0.999 * n
    ta = M.init_adapters(tcfg, np.asarray(KEY), tp)
    wa = convert.adapters_from_jax(np_tree(JM.init_adapters(jcfg, KEY, jp)))
    assert isinstance(ta, list) and len(ta) == len(wa) == 1
    draw_gaps(ta[0], wa[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_jax(models, dtype):
    """Prefill's last logits and its cache: k and v over the 16 projected
    patches and the 12 prompt tokens, 28 rows."""
    m = models(dtype)
    cfg = m["tcfg"]
    jb, tb = draw_inputs(cfg, S, dtype, seed=3)
    wl, wc = jax_prefill(m, jb)
    gl, gc = M.make_prefill_step(cfg)(m["tp"], m["ta"], tb)
    assert gl.dtype == torch.float32 and gl.shape == (B, cfg.vocab_size)
    assert rel(gl, wl) <= LOGITS_TOL[dtype]
    assert gc[0][0].shape == (B, cfg.n_frontend_tokens + S, cfg.n_kv_heads,
                              cfg.head_dim)
    check_tree(gc, convert.cache_from_jax(np_tree(wc)), CACHE_TOL[dtype],
               f"{dtype} prefill cache")


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_steps_from_prefill_match_jax(models, dtype):
    """12 serve steps from prefill's cache, at positions ``F + S + s``,
    on the same fed tokens: logits and cache after each against JAX's."""
    m = models(dtype)
    cfg = m["tcfg"]
    rows = cfg.n_frontend_tokens + S
    jb, tb = draw_inputs(cfg, S, dtype, seed=4)
    _, wc = jax_prefill(m, jb)
    _, gc = M.make_prefill_step(cfg)(m["tp"], m["ta"], tb)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    fed = np.random.default_rng(5).integers(
        4, cfg.vocab_size - 4, (B, STEPS)).astype(np.int32)
    out = steps_both(m, jax_seeded(m["jcfg"], wc, rows, STEPS, jdt),
                     port_seeded(cfg, gc, rows, STEPS, tdt), fed, rows)
    for s, (tl, jl, tcache, jcache) in enumerate(out):
        assert bool(torch.isfinite(tl).all())
        assert rel(tl, jl) <= LOGITS_TOL[dtype], (s, rel(tl, jl))
        check_tree(tcache, jcache, CACHE_TOL[dtype], f"{dtype} step {s}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_100_patches_match_jax(models, dtype):
    """100 patches (112 rows with the prompt, no multiple of 64): prefill
    and 3 serve steps from its cache."""
    m = models(dtype, patches=100)
    cfg = m["tcfg"]
    jb, tb = draw_inputs(cfg, S, dtype, seed=6)
    wl, wc = jax_prefill(m, jb)
    gl, gc = M.make_prefill_step(cfg)(m["tp"], m["ta"], tb)
    assert rel(gl, wl) <= LOGITS_TOL[dtype]
    assert gc[0][0].shape[1] == 100 + S
    check_tree(gc, convert.cache_from_jax(np_tree(wc)), CACHE_TOL[dtype],
               "100-patch prefill cache")
    fed = np.random.default_rng(7).integers(
        4, cfg.vocab_size - 4, (B, 3)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for tl, jl, tcache, jcache in steps_both(
            m, jax_seeded(m["jcfg"], wc, 100 + S, 3, jdt),
            port_seeded(cfg, gc, 100 + S, 3, tdt), fed, 100 + S):
        assert rel(tl, jl) <= LOGITS_TOL[dtype]
        check_tree(tcache, jcache, CACHE_TOL[dtype], "100-patch step")


def test_train_step_matches_jax(models):
    """One ``make_train_step`` (float32) with the patches: the loss (over
    the prompt's positions only) and AdamW's first moment of every
    adapter within 1e-5 of the largest magnitude."""
    m = models("float32")
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(10)
    jb, tb = draw_inputs(jcfg, 16, "float32", seed=11)
    labels = rng.integers(4, tcfg.vocab_size - 4, (B, 16)).astype(np.int32)
    batch = {"tokens": tb["tokens"][None], "frontend": tb["frontend"][None],
             "labels": torch.from_numpy(labels).long()[None]}
    tadp = tree_map(lambda t: t[None], m["ta"])
    _, new_opt, metrics = M.make_train_step(tcfg, lr=3e-3)(
        m["tp"], tadp, adamw.init(tadp, n_clients=1), batch)
    jstep = jax.jit(JM.make_train_step(jcfg, lr=3e-3,
                                       opts=JM.FwdOptions(remat=False)))
    _, jo, jmet = jstep(m["jp"], m["ja"], jadamw.init(m["ja"]),
                        dict(jb, labels=jnp.asarray(labels)))
    assert abs(float(metrics["loss"][0]) - float(jmet["loss"])) <= 1e-5
    want = tree_leaves(convert.adapters_from_jax(np_tree(jo.mu)))
    got = tree_leaves(new_opt.mu)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        g, w = g[0].numpy(), w.numpy()
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


def test_prefill_against_prefill_and_a_serve_step(models):
    """Float32 with a float32 cache: prefill over the patches and 12
    tokens against prefill over the patches and 11 tokens, then one
    serve step at position ``F + 11`` from its cache, within 1e-4 of the
    largest logit."""
    m = models("float32")
    cfg = m["tcfg"]
    F = cfg.n_frontend_tokens
    jb, tb = draw_inputs(cfg, S, "float32", seed=12)
    full, _ = M.make_prefill_step(cfg)(m["tp"], m["ta"], tb)
    short = dict(tb, tokens=tb["tokens"][:, :-1])
    _, cache = M.make_prefill_step(cfg)(m["tp"], m["ta"], short)
    cache = port_seeded(cfg, cache, F + S - 1, 1, torch.float32)
    step, _ = M.make_serve_step(cfg)(m["tp"], m["ta"], cache,
                                     tb["tokens"][:, -1:], F + S - 1)
    assert rel(step, full) <= 1e-4


def test_the_patches_are_required(models):
    m = models("float32")
    _, tb = draw_inputs(m["tcfg"], S, "float32")
    with pytest.raises(ValueError, match="frontend"):
        M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"],
                                       {"tokens": tb["tokens"]})
