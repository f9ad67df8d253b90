"""The encoder-decoder served and trained by the port against the JAX
package: ``whisper-large-v3-smoke`` (one encoder and one decoder layer,
d_model 256, 4 heads of 64, 16 stub audio frames), on the JAX package's
weights carried across by ``convert`` (``lora_b`` + 0.01), float32 and
bfloat16 base.

Held: the base draw and the adapters' chained key tree; the encoder
stack (non-causal, frames projected by ``proj_frontend`` in their own
dtype); ``cross_kv``, ``cross_attn_train`` and ``cross_attn_decode`` on
one layer; prefill's logits and its ``((k, v), (xk, xv))`` cache; 12
serve steps from prefill's cache (self and cross); 100 frames, no
multiple of 64; ``convert`` of both cache layouts; one train step;
prefill against prefill over one token fewer plus a serve step.
Tolerances: ``tests/torch_frontends.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models.common import rms_norm as jrms_norm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs.registry import get as tget
from repro_torch.models import attention as tattn
from repro_torch.models import model as M
from repro_torch.models.common import matmul, rms_norm
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map
from torch_families import KEY, draw_gaps, np_tree, smoke_model
from torch_frontends import (B, CACHE_TOL, LOGITS_TOL, STEPS, check_tree,
                             draw_inputs, jax_prefill, jax_seeded,
                             port_seeded, rel, steps_both)

torch.set_num_threads(1)

NAME = "whisper-large-v3"
DTYPES = ["float32", "bfloat16"]
S = 12


@pytest.fixture(scope="module")
def models():
    cache = {}

    def build(dtype, frames=None):
        if (dtype, frames) not in cache:
            m = smoke_model(NAME, dtype)
            if frames:
                m = dict(m, jcfg=dataclasses.replace(
                    m["jcfg"], n_frontend_tokens=frames),
                    tcfg=dataclasses.replace(m["tcfg"],
                                             n_frontend_tokens=frames))
            cache[dtype, frames] = m
        return cache[dtype, frames]
    return build


def _merged(m, i=0):
    """Decoder layer ``i``'s base and adapters merged, on both sides."""
    jl = jax.tree.map(lambda x: x[i // len(m["jcfg"].pattern)],
                      m["jp"]["groups"][i % len(m["jcfg"].pattern)])
    ja = jax.tree.map(lambda x: x[i // len(m["jcfg"].pattern)],
                      m["ja"]["groups"][i % len(m["jcfg"].pattern)])
    tl = {**m["tp"]["layers"][i],
          **{k: v[None] for k, v in m["ta"]["layers"][i].items()}}
    return {**jl, **ja}, tl


def _encoder_both(m, jb, tb):
    """The encoder's normed output on both sides."""
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    e = jnp.einsum("bfd,de->bfe", jb["frontend"],
                   m["jp"]["proj_frontend"].astype(jb["frontend"].dtype))
    pos = jnp.broadcast_to(jnp.arange(e.shape[1])[None], e.shape[:2])
    e, _, _ = JM._run_stack(jcfg, m["jp"]["enc_groups"],
                            m["ja"]["enc_groups"], e, pos,
                            JM.FwdOptions(remat=False, causal=False))
    want = jrms_norm(e, m["jp"]["enc_final_norm"], jcfg.norm_eps)
    with torch.no_grad():
        x = matmul(tb["frontend"][None], m["tp"]["proj_frontend"])
        x = M._run_stack(tcfg, m["tp"]["enc_layers"],
                         [{k: v[None] for k, v in a.items()}
                          for a in m["ta"]["enc_layers"]], x,
                         M.FwdOptions(remat=False, causal=False))[0]
        got = rms_norm(x, m["tp"]["enc_final_norm"], tcfg.norm_eps)
    return got, want


def test_init_params_follow_jax_key_tree():
    """The port's own draw: every leaf of the JAX package's, by name and
    shape (``proj_frontend`` from ``keys[2]``, the decoder layers' cross
    weights from the third key of each layer, ``enc_layers`` without
    them from ``keys[4]``, ``enc_final_norm``), values to the draw's
    contract; adapters ``{"layers", "enc_layers"}`` with the encoder's
    keys chained off the decoder's, as JAX's are, and none on the cross
    weights."""
    jcfg, tcfg = jget(NAME + "-smoke"), tget(NAME + "-smoke")
    jp = JM.init_params(jcfg, KEY)
    tp = M.init_params(tcfg, np.asarray(KEY), device="cpu")
    want = convert.params_from_jax(np_tree(jp))
    assert sorted(tp) == sorted(want) == sorted(
        ["embed", "final_norm", "lm_head", "proj_frontend", "layers",
         "enc_layers", "enc_final_norm"])
    n = same = 0
    for gl, wl in zip(tp["layers"] + tp["enc_layers"] + [
            {k: v for k, v in tp.items() if "layers" not in k}],
            want["layers"] + want["enc_layers"] + [
                {k: v for k, v in want.items() if "layers" not in k}]):
        a, b = draw_gaps(gl, wl)
        n, same = n + a, same + b
    assert {"xln", "xwq", "xwkv", "xwo"} <= set(tp["layers"][0])
    assert not {"xln", "xwq", "xwkv", "xwo"} & set(tp["enc_layers"][0])
    assert same >= 0.999 * n
    ja = JM.init_adapters(jcfg, KEY, jp)
    ta = M.init_adapters(tcfg, np.asarray(KEY), tp)
    wa = convert.adapters_from_jax(np_tree(ja))
    assert sorted(ta) == sorted(wa) == ["enc_layers", "layers"]
    for name in ("layers", "enc_layers"):
        for g, w in zip(ta[name], wa[name]):
            assert sorted(g) == sorted(w) and not any(
                k.startswith("x") for k in g)
            draw_gaps(g, w)
    # the chain: the encoder's keys come from split(key, P + 1)[0]
    k0 = jr.split(np.asarray(KEY), 2)[0]
    enc = M.init_adapters(tcfg, k0, {"layers": tp["enc_layers"]})["layers"]
    for g, w in zip(enc, ta["enc_layers"]):
        for k in g:
            assert torch.equal(g[k], w[k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches_jax(models, dtype):
    """The encoder stack and ``enc_final_norm`` over the projected frames,
    in the frames' dtype."""
    m = models(dtype)
    jb, tb = draw_inputs(m["jcfg"], S, dtype)
    got, want = _encoder_both(m, jb, tb)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (1, B, m["tcfg"].n_frontend_tokens,
                         m["tcfg"].d_model)
    assert rel(got[0], want) <= CACHE_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(models, dtype):
    """``cross_kv`` of the encoder's output, then ``cross_attn_train`` of a
    decoder stream over it (Sq = 12 against 16 keys, non-causal) and
    ``cross_attn_decode`` of one of its rows, on layer 0's merged
    weights."""
    m = models(dtype)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jb, tb = draw_inputs(jcfg, S, dtype, seed=1)
    got_enc, want_enc = _encoder_both(m, jb, tb)
    jp, tp = _merged(m)
    jk, jv = jattn.cross_kv(jp, jcfg, want_enc)
    with torch.no_grad():
        tk, tv = tattn.cross_kv(tp, tcfg, convert.from_jax(
            np.asarray(want_enc))[None])
    tol = CACHE_TOL[dtype]
    assert rel(tk, jk) <= tol and rel(tv, jv) <= tol
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)), jnp.dtype(dtype))
    tx = convert.from_jax(np.asarray(x))[None]
    want = jattn.cross_attn_train(jp, jcfg, x, (jk, jv))
    kv = (convert.from_jax(np.asarray(jk)), convert.from_jax(np.asarray(jv)))
    with torch.no_grad():
        got = tattn.cross_attn_train(tp, tcfg, tx, kv)
        dec = tattn.cross_attn_decode(tp, tcfg, tx[:, :, -1:], *kv)
    assert got.dtype == tx.dtype and rel(got[0], want) <= tol
    want_dec = jattn.cross_attn_decode(jp, jcfg, x[:, -1:], jk, jv)
    assert rel(dec[0], want_dec) <= tol
    # one row decoded equals that row of the full-sequence form
    assert rel(dec[0], want[:, -1:]) <= tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_matches_jax(models, dtype):
    """Prefill's last logits and its cache, one ``((k, v), (xk, xv))`` a
    layer: k and v ``(B, S, KH, D)``, the cross pair ``(B, F, KH, D)``,
    in the activation dtype."""
    m = models(dtype)
    jb, tb = draw_inputs(m["jcfg"], S, dtype, seed=3)
    wl, wc = jax_prefill(m, jb)
    gl, gc = M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"], tb)
    assert gl.dtype == torch.float32 and gl.shape == (
        B, m["tcfg"].vocab_size)
    assert rel(gl, wl) <= LOGITS_TOL[dtype]
    cfg = m["tcfg"]
    assert len(gc) == cfg.n_layers
    (k, v), (xk, xv) = gc[0]
    assert k.shape == v.shape == (B, S, cfg.n_kv_heads, cfg.head_dim)
    assert xk.shape == xv.shape == (B, cfg.n_frontend_tokens,
                                    cfg.n_kv_heads, cfg.head_dim)
    check_tree(gc, convert.cache_from_jax(np_tree(wc)), CACHE_TOL[dtype],
               f"{dtype} prefill cache")


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_steps_from_prefill_match_jax(models, dtype):
    """12 serve steps from prefill's cache (its k and v in the first 12
    slots of 24, its cross pair as the cross cache), on the same fed
    tokens: each step's logits and the whole cache against JAX's."""
    m = models(dtype)
    jb, tb = draw_inputs(m["jcfg"], S, dtype, seed=4)
    _, wc = jax_prefill(m, jb)
    _, gc = M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"], tb)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    fed = np.random.default_rng(5).integers(
        4, m["tcfg"].vocab_size - 4, (B, STEPS)).astype(np.int32)
    out = steps_both(m, jax_seeded(m["jcfg"], wc, S, STEPS, jdt),
                     port_seeded(m["tcfg"], gc, S, STEPS, tdt), fed, S)
    for s, (tl, jl, tcache, jcache) in enumerate(out):
        assert bool(torch.isfinite(tl).all())
        assert rel(tl, jl) <= LOGITS_TOL[dtype], (s, rel(tl, jl))
        check_tree(tcache, jcache, CACHE_TOL[dtype], f"{dtype} step {s}")
    assert isinstance(out[-1][2], tuple) and len(out[-1][2]) == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_100_frames_match_jax(models, dtype):
    """100 frames, no multiple of 64 (the kernel's key tile) nor of JAX's
    chunk: prefill and 3 serve steps from its cache."""
    m = models(dtype, frames=100)
    jb, tb = draw_inputs(m["jcfg"], S, dtype, seed=6)
    assert tb["frontend"].shape[1] == 100
    wl, wc = jax_prefill(m, jb)
    gl, gc = M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"], tb)
    assert rel(gl, wl) <= LOGITS_TOL[dtype]
    assert gc[0][1][0].shape[1] == 100
    check_tree(gc, convert.cache_from_jax(np_tree(wc)), CACHE_TOL[dtype],
               "100-frame prefill cache")
    fed = np.random.default_rng(7).integers(
        4, m["tcfg"].vocab_size - 4, (B, 3)).astype(np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for tl, jl, tcache, jcache in steps_both(
            m, jax_seeded(m["jcfg"], wc, S, 3, jdt),
            port_seeded(m["tcfg"], gc, S, 3, tdt), fed, S):
        assert rel(tl, jl) <= LOGITS_TOL[dtype]
        check_tree(tcache, jcache, CACHE_TOL[dtype], "100-frame step")


def test_float32_frames_under_a_bfloat16_base_match_jax(models):
    """The encoder stream's dtype follows the frames': float32 frames
    under a bfloat16 base give a float32 encoder and cross caches, and
    cross-attention runs in float32 with its output rounded to the
    decoder's bfloat16, as JAX's einsums promote."""
    m = models("bfloat16")
    jb, tb = draw_inputs(m["jcfg"], S, "float32", seed=8)
    wl, wc = jax_prefill(m, jb)
    gl, gc = M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"], tb)
    (k, _), (xk, _) = gc[0]
    assert k.dtype == torch.bfloat16 and xk.dtype == torch.float32
    assert rel(gl, wl) <= LOGITS_TOL["bfloat16"]
    check_tree(gc, convert.cache_from_jax(np_tree(wc)),
               CACHE_TOL["bfloat16"], "mixed-dtype prefill cache")


def test_cache_from_jax_carries_both_layouts(models):
    """``convert.cache_from_jax``: JAX's prefill cache (one ``((k, v), (xk,
    xv))`` a pattern position) to one a layer, and its decode cache, the
    pair ``(self, cross)`` of ``init_cache``, with ``pair=True`` to the
    port's pair; bit for bit, at the port's own shapes."""
    m = models("bfloat16")
    cfg = m["jcfg"]
    jb, _ = draw_inputs(cfg, S, "bfloat16", seed=9)
    _, wc = jax_prefill(m, jb)
    got = convert.cache_from_jax(np_tree(wc))
    assert len(got) == cfg.n_layers
    for (kv, xkv), ((jk, jv), (jxk, jxv)) in zip(got, wc):
        for g, w in zip(kv + xkv, (jk[0], jv[0], jxk[0], jxv[0])):
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.float().numpy(),
                                  np.asarray(w.astype(jnp.float32)))
    jcache = JM.init_cache(cfg, B, 20)
    jcache = (jcache[0], tuple((xk + 1, xv + 2) for xk, xv in jcache[1]))
    got = convert.cache_from_jax(np_tree(jcache), pair=True)
    want = M.init_cache(m["tcfg"], B, 20, device="cpu")
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert g.shape == w.shape and g.dtype == w.dtype
    for (xk, xv), (wk, wv) in zip(got[1], want[1]):
        assert xk.shape == wk.shape and bool((xk == 1).all())
        assert bool((xv == 2).all())


def test_train_step_matches_jax(models):
    """One ``make_train_step`` (float32) with the frames: the loss and
    AdamW's first moment (0.1 × the gradient) of every adapter, the
    encoder's included, within 1e-5 of the largest magnitude."""
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
    want = convert.adapters_from_jax(np_tree(jo.mu))
    assert sorted(new_opt.mu) == ["enc_layers", "layers"]
    leaves = list(zip(tree_leaves(new_opt.mu), tree_leaves(want)))
    assert len(leaves) == 20
    for g, w in leaves:
        g, w = g[0].numpy(), w.numpy()
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())
    enc = tree_leaves(new_opt.mu["enc_layers"])
    assert any(float(t.abs().max()) > 0 for t in enc)


def test_prefill_against_prefill_and_a_serve_step(models):
    """Float32 with a float32 cache: prefill over 12 tokens against
    prefill over 11 and one serve step at the last position from its
    cache (cross caches from that prefill), within 1e-4 of the largest
    logit."""
    m = models("float32")
    jb, tb = draw_inputs(m["jcfg"], S, "float32", seed=12)
    full, _ = M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"], tb)
    short = dict(tb, tokens=tb["tokens"][:, :-1])
    _, cache = M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"], short)
    cache = port_seeded(m["tcfg"], cache, S - 1, 1, torch.float32)
    step, _ = M.make_serve_step(m["tcfg"])(m["tp"], m["ta"], cache,
                                           tb["tokens"][:, -1:], S - 1)
    assert rel(step, full) <= 1e-4


def test_the_frontend_is_required(models):
    m = models("float32")
    _, tb = draw_inputs(m["jcfg"], S, "float32")
    with pytest.raises(ValueError, match="frontend"):
        M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"],
                                       {"tokens": tb["tokens"]})
