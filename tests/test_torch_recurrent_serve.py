"""The recurrent families served by the port against the JAX package:
``jamba-1.5-large-398b`` (Mamba layers with GQA and MoE, a period of 8
layers: 7 Mamba, 4 of them with MoE, and one attention layer) and
``xlstm-125m`` (an mLSTM layer with no feed-forward block, then an sLSTM
layer with its MLP), each ``-smoke``, on the JAX package's weights
carried across by ``convert``: prefill and 12 serve steps in float32 and
bfloat16, the mLSTM's chunkwise prefill, and prefill's states against
the decode path's.  ``tests/test_torch_recurrent_train.py`` holds their
train step, base draw, carried caches and QLoRA packing.

Tolerances: ``tests/test_torch_decode.py``'s.  Float32 base (with a
float32 decode cache on both sides: JAX's serve step returns the
convolution states in the activations' dtype whatever the cache's, the
port writes them in place in the cache's): logits within 1e-4 of the
largest, every state within 1e-4 of its largest magnitude.  bfloat16
base: logits within 3e-2, caches within 2e-2, or twice JAX's own
bfloat16 gap at that layer if larger (JAX's bfloat16 run against its
float32 run on the same weights): the recurrent states carry the
rounding noise of every earlier position, and jamba's bfloat16 routing
flips as JAX's own does.  In bfloat16 a row of logits over its bound
must have routed a token within ``FLIP_MARGIN`` of a tie in that call or
an earlier one (``tests/torch_families.py``): in jamba a flip moves the
recurrent states of every later position.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch import convert
from repro_torch.models import model as M
from torch_families import (as_f32, check_rows, np_tree, routed, row_margins,
                            smoke_model)

torch.set_num_threads(1)

NAMES = ["jamba-1.5-large-398b", "xlstm-125m"]
DTYPES = ["float32", "bfloat16"]
B, STEPS = 2, 12


@pytest.fixture(scope="module")
def models():
    cache = {}

    def build(name, dtype):
        if (name, dtype) not in cache:
            cache[name, dtype] = smoke_model(name, dtype)
        return cache[name, dtype]
    return build


def _tokens(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(4, cfg.vocab_size - 4, (B, n)).astype(np.int32)


def _rel(got, want) -> float:
    return float(np.abs(as_f32(got) - as_f32(want)).max()
                 / max(1e-30, np.abs(as_f32(want)).max()))


def _margins(cfg, calls):
    return row_margins(calls, B, cfg.moe.top_k) if cfg.moe else None


def _jax_decode(m, tokens, S, cache_dtype):
    serve = jax.jit(JM.make_serve_step(m["jcfg"]))
    cache = JM.init_cache(m["jcfg"], B, S, dtype=cache_dtype)
    out = []
    for p in range(tokens.shape[1]):
        logits, cache = serve(m["jp"], m["ja"], cache,
                              jnp.asarray(tokens[:, p:p + 1]),
                              jnp.asarray(p))
        out.append((logits, convert.cache_from_jax(np_tree(cache))))
    return out


def _port_decode(m, tokens, S, cache_dtype):
    """The port's serve steps, each with the smallest routing margin of
    each row over this step and every earlier one (None without MoE)."""
    serve = M.make_serve_step(m["tcfg"])
    cache = M.init_cache(m["tcfg"], B, S, dtype=cache_dtype, device="cpu")
    out, low = [], None
    for p in range(tokens.shape[1]):
        with routed() as calls:
            logits, cache = serve(m["tp"], m["ta"], cache,
                                  torch.from_numpy(tokens[:, p:p + 1]).long(),
                                  p)
        marg = _margins(m["tcfg"], calls)
        low = marg if low is None or marg is None else np.minimum(low, marg)
        out.append((logits, [tuple(t.clone() for t in c) for c in cache],
                    low))
    return out


def _f32_weights(m):
    return dict(m, jp=jax.tree.map(lambda t: t.astype(jnp.float32), m["jp"]))


def _cache_dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _layer_gaps(got, want) -> list:
    return [max(_rel(g, w) for g, w in zip(gl, wl))
            for gl, wl in zip(got, want)]


def _check_caches(got, want, dtype, own, what, margins=None):
    """Every layer's states against JAX's; in bfloat16 row by row (a
    request's states), a row over its bound excused only by a routing
    near a tie (``margins``, the running smallest of each row)."""
    assert len(got) == len(want)
    for i, (gl, wl) in enumerate(zip(got, want)):
        assert len(gl) == len(wl)
        for j, (g, w) in enumerate(zip(gl, wl)):
            assert g.dtype == w.dtype and g.shape == w.shape, (what, i, j)
            if dtype == "bfloat16":
                check_rows(g, w, max(2e-2, 2 * own[i]), margins,
                           f"{what} layer {i} state {j}")
                continue
            assert _rel(g, w) <= 1e-4, (
                f"{what} layer {i} state {j}: {_rel(g, w):.3g} of the "
                f"largest, over 1e-4")


def _check_logits(got, want, dtype, margins, what):
    bound = 3e-2 if dtype == "bfloat16" else 1e-4
    return check_rows(got, want, bound,
                      margins if dtype == "bfloat16" else None, what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_serve_steps_match_jax(models, name, dtype):
    """12 serve steps on the same fed tokens: logits and every layer's
    cache (the recurrent states, the attention's k and v) after each,
    against JAX's."""
    m = models(name, dtype)
    jdt, tdt = _cache_dtypes(dtype)
    toks = _tokens(m["jcfg"], STEPS)
    want = _jax_decode(m, toks, 16, jdt)
    got = _port_decode(m, toks, 16, tdt)
    own = [0.0] * m["tcfg"].n_layers
    if dtype == "bfloat16":
        ref = _jax_decode(_f32_weights(m), toks, 16, jnp.float32)
        for (_, wc), (_, fc) in zip(want, ref):
            own = np.maximum(own, _layer_gaps(wc, fc)).tolist()
        print(f"{name}: JAX's own bfloat16 cache gap by layer "
              f"{[f'{g:.3g}' for g in own]}")
    for p, ((gl, gc, marg), (wl, wc)) in enumerate(zip(got, want)):
        assert gl.dtype == torch.float32
        assert gl.shape == (B, m["tcfg"].vocab_size)
        assert bool(torch.isfinite(gl).all())
        _check_logits(gl, wl, dtype, marg, f"{name} {dtype} step {p}")
        _check_caches(gc, wc, dtype, own, f"{name} {dtype} step {p}", marg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_jax(models, name, dtype):
    """Prefill's last logits and every layer's cache (Mamba's ``(h,
    conv)``, the mLSTM's ``(C, n, m)``, the sLSTM's four states, the
    attention's ``(k, v)``), shapes and dtypes as JAX's."""
    m = models(name, dtype)
    cfg = m["tcfg"]
    toks = _tokens(m["jcfg"], 24, seed=1)
    step = jax.jit(JM.make_prefill_step(m["jcfg"]))
    wl, wc = step(m["jp"], m["ja"], {"tokens": jnp.asarray(toks)})
    with routed() as calls:
        gl, gc = M.make_prefill_step(cfg)(
            m["tp"], m["ta"], {"tokens": torch.from_numpy(toks).long()})
    assert gl.dtype == torch.float32 and gl.shape == (B, cfg.vocab_size)
    marg = _margins(cfg, calls)
    _check_logits(gl, wl, dtype, marg, f"{name} prefill")
    want = convert.cache_from_jax(np_tree(wc))
    own = [0.0] * cfg.n_layers
    if dtype == "bfloat16":
        _, wc32 = step(_f32_weights(m)["jp"], m["ja"],
                       {"tokens": jnp.asarray(toks)})
        own = _layer_gaps(want, convert.cache_from_jax(np_tree(wc32)))
    _check_caches(gc, want, dtype, own, f"{name} prefill", marg)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_states_against_own_decode(models, name):
    """Float32: prefill's states, caches and last logits against the
    port's decode path fed the same 40-token prompt (a float32 cache),
    within 1e-4 of their largest magnitude.  The mLSTM prefill cache
    ``(C, n, m)`` is held to the decode path's first three states; jamba's
    MoE gets a capacity that drops no choice in prefill (decode drops
    none), so both paths compute one function."""
    m = models(name, "float32")
    cfg = m["tcfg"]
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    toks = _tokens(cfg, 40, seed=2)
    pl, pc = M.make_prefill_step(cfg)(
        m["tp"], m["ta"], {"tokens": torch.from_numpy(toks).long()})
    serve = M.make_serve_step(cfg)
    cache = M.init_cache(cfg, B, 40, dtype=torch.float32, device="cpu")
    for p in range(40):
        dl, cache = serve(m["tp"], m["ta"], cache,
                          torch.from_numpy(toks[:, p:p + 1]).long(), p)
    gaps = [[_rel(d, s) for s, d in zip(sl, dl_)]
            for sl, dl_ in zip(pc, cache)]
    print(f"{name}: prefill against decode, logits {_rel(dl, pl):.3g}, "
          f"states by layer {[[f'{g:.3g}' for g in l] for l in gaps]}")
    assert _rel(dl, pl) <= 1e-4
    for i, (sl, g) in enumerate(zip(pc, gaps)):
        mixer = cfg.pattern[i % len(cfg.pattern)][0]
        assert len(sl) == {"mamba": 2, "mlstm": 3, "slstm": 4,
                           "attn": 2}[mixer]
        assert max(g) <= 1e-4, (i, mixer, g)


def test_mlstm_chunkwise_prefill_matches_jax(models):
    """xlstm-125m-smoke's prefill with the mLSTM in its chunkwise form
    (128 tokens, two chunks) against JAX's ``FwdOptions(mlstm_chunkwise=
    True)``: logits within 1e-4, states within 1e-4; and against the
    sequential prefill, logits within 1e-4 and the mLSTM states as
    ``C·e^m``, ``n·e^m``."""
    m = models("xlstm-125m", "float32")
    toks = _tokens(m["tcfg"], 128, seed=3)
    opts = JM.FwdOptions(remat=False, collect_cache=True,
                         mlstm_chunkwise=True)
    wl, wc = jax.jit(JM.make_prefill_step(m["jcfg"], opts))(
        m["jp"], m["ja"], {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks).long()}
    gl, gc = M.make_prefill_step(m["tcfg"], mlstm_chunkwise=True)(
        m["tp"], m["ta"], batch)
    sl, sc = M.make_prefill_step(m["tcfg"])(m["tp"], m["ta"], batch)
    assert _rel(gl, wl) <= 1e-4 and _rel(gl, sl) <= 1e-4
    want = convert.cache_from_jax(np_tree(wc))
    for gl_, wl_ in zip(gc, want):
        for g, w in zip(gl_, wl_):
            assert _rel(g, w) <= 1e-4
    Cc, nc, mc = (t.double() for t in gc[0])
    Cs, ns, ms = (t.double() for t in sc[0])
    assert _rel(Cc * mc.exp()[..., None, None],
                Cs * ms.exp()[..., None, None]) <= 1e-4
    assert _rel(nc * mc.exp()[..., None], ns * ms.exp()[..., None]) <= 1e-4
