"""The port's prefill and one-token serve step against the JAX package's.

Every dense ``-smoke`` config (``stablelm-3b``, ``starcoder2-7b``,
``llama3-405b`` and the four paper LLMs), on the JAX package's weights
and adapters carried across by ``convert`` (``lora_b`` + 0.01, as
``tests/test_peft.py`` gives the adapters signal), with a float32 base
and with the config's bfloat16 base.

Tolerances.  Float32 base: logits within 1e-4 of the largest logit; the
decode caches (bfloat16 whatever the model dtype) equal except for
elements one bfloat16 ulp apart, at most 1e-3 of them; prefill's caches
(the activation dtype) within 1e-4 of their largest magnitude.
bfloat16 base: caches within 2e-2 of their largest magnitude (the
bfloat16 tolerance of ``tests/test_torch_llm_kernels.py``), logits
within 3e-2 of the largest logit.  The logits' bound is looser because
``lora_matmul`` rounds its result once, where JAX's ``dense`` rounds
``x@W``, ``x@A``, ``(x@A)@B``, its scaling and the sum to bfloat16 one
by one: 2.3e-2 measured at most (starcoder2-7b-smoke, 12 steps), and
1.1e-2 when the plain path is made to round at JAX's points.  Logits
come out of a bfloat16 product, so 1e-2 is about one bfloat16 ulp of
the largest.  The port's own decode path against
its prefill: within twice JAX's own gap on the same weights (the decode
cache is bfloat16 and decode attention rounds its probabilities to it,
so even a float32 model is only bfloat16-accurate there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.models import model as JM
from repro.models.common import dense as jdense
from repro.models.common import lora_pair as jlora_pair
from repro.peft import lora as jlora
from repro_torch import convert
from repro_torch.configs.registry import get as tget
from repro_torch.models import attention as tattn
from repro_torch.models import model as M
from repro_torch.models.common import dense, lora_pair
from repro_torch.peft import lora as tlora

torch.set_num_threads(1)

DENSE = ["stablelm-3b", "starcoder2-7b", "llama3-405b", "llama3.2-1b",
         "gpt2", "deepseek-llm-7b-base", "tiny-llm"]
DTYPES = ["float32", "bfloat16"]
KEY = jax.random.PRNGKey(0)
B, STEPS = 2, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f(t) -> np.ndarray:
    """A tensor or array as float32 numpy."""
    if torch.is_tensor(t):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def models():
    cache = {}

    def build(name, dtype):
        if (name, dtype) not in cache:
            jcfg, tcfg = jget(name + "-smoke"), tget(name + "-smoke")
            jp = JM.init_params(jcfg, KEY, dtype=jnp.dtype(dtype))
            ja = jax.tree.map(lambda x: x + 0.01,
                              JM.init_adapters(jcfg, KEY, jp))
            cache[name, dtype] = dict(
                jcfg=jcfg, tcfg=tcfg, jp=jp, ja=ja,
                tp=convert.params_from_jax(_np(jp)),
                ta=convert.adapters_from_jax(_np(ja)))
        return cache[name, dtype]
    return build


def _tokens(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(4, cfg.vocab_size - 4, (B, n)).astype(np.int32)


def _check_logits(got, want, dtype, what):
    got, want = _f(got), _f(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    bound = 3e-2 if dtype == "bfloat16" else 1e-4
    assert err <= bound, f"{what}: {err:.3g} of the largest logit"


def _check_bf16(got, want, what=""):
    err = np.abs(_f(got) - _f(want)).max() / np.abs(_f(want)).max()
    assert err <= 2e-2, f"{what}: {err:.3g} of the largest magnitude"


def _check_decode_caches(got, want_jax, dtype, what):
    want = convert.cache_from_jax(_np(want_jax))
    assert len(got) == len(want)
    n = odd = 0
    for (gk, gv), (wk, wv) in zip(got, want):
        for g, w in ((gk, wk), (gv, wv)):
            assert g.dtype == w.dtype == torch.bfloat16
            assert g.shape == w.shape
            if dtype == "bfloat16":
                _check_bf16(g, w, what)
                continue
            bits_g = g.view(torch.int16).int()
            bits_w = w.view(torch.int16).int()
            ulps = (bits_g - bits_w).abs()
            assert int(ulps.max()) <= 1, what
            n += g.numel()
            odd += int((ulps == 1).sum())
    if dtype == "float32":
        print(f"{what}: caches differ in {odd} of {n} elements "
              f"(share {odd / n:.2e}), each by one bfloat16 ulp")
        assert odd <= 1e-3 * n, what


def _jax_decode(m, tokens, S, window=0, start=0):
    serve = jax.jit(JM.make_serve_step(m["jcfg"], window=window))
    cache = JM.init_cache(m["jcfg"], B, S, window=window)
    out = []
    for p in range(tokens.shape[1]):
        logits, cache = serve(m["jp"], m["ja"], cache,
                              jnp.asarray(tokens[:, p:p + 1]),
                              jnp.asarray(start + p))
        out.append((logits, cache))
    return out


def _port_decode(m, tokens, S, window=0, start=0):
    serve = M.make_serve_step(m["tcfg"], window=window)
    cache = M.init_cache(m["tcfg"], B, S, window=window, device="cpu")
    out = []
    for p in range(tokens.shape[1]):
        logits, cache = serve(m["tp"], m["ta"], cache,
                              torch.from_numpy(tokens[:, p:p + 1]).long(),
                              start + p)
        out.append((logits, [(k.clone(), v.clone()) for k, v in cache]))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_serve_steps_match_jax(models, name, dtype):
    """``test_models_smoke.py::test_decode_step`` ported and held to JAX
    step by step: the same fed tokens, 12 steps, logits and caches
    after each."""
    m = models(name, dtype)
    toks = _tokens(m["jcfg"], STEPS)
    want = _jax_decode(m, toks, 16)
    got = _port_decode(m, toks, 16)
    for p, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        assert gl.dtype == torch.float32
        assert gl.shape == (B, m["tcfg"].vocab_size)
        assert bool(torch.isfinite(gl).all())
        _check_logits(gl, wl, dtype, f"{name} step {p}")
        _check_decode_caches(gc, wc, dtype, f"{name} step {p}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches_jax(models, name, dtype):
    m = models(name, dtype)
    toks = _tokens(m["jcfg"], 24, seed=1)
    wl, wc = jax.jit(JM.make_prefill_step(m["jcfg"]))(
        m["jp"], m["ja"], {"tokens": jnp.asarray(toks)})
    gl, gc = M.make_prefill_step(m["tcfg"])(
        m["tp"], m["ta"], {"tokens": torch.from_numpy(toks).long()})
    assert gl.dtype == torch.float32 and gl.shape == (B,
                                                       m["tcfg"].vocab_size)
    _check_logits(gl, wl, dtype, f"{name} prefill")
    want = convert.cache_from_jax(_np(wc))
    assert len(gc) == len(want) == m["tcfg"].n_layers
    for (gk, gv), (wk, wv) in zip(gc, want):
        for g, w in ((gk, wk), (gv, wv)):
            assert g.dtype == w.dtype == getattr(torch, dtype)
            assert g.shape == (B, 24, m["tcfg"].n_kv_heads,
                               m["tcfg"].head_dim)
            if dtype == "bfloat16":
                _check_bf16(g, w, f"{name} prefill cache")
            else:
                err = np.abs(_f(g) - _f(w)).max() / np.abs(_f(w)).max()
                assert err <= 1e-4, err


def _gap(a, b) -> float:
    return float(np.abs(_f(a) - _f(b)).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,window", [("llama3.2-1b", 0),
                                         ("starcoder2-7b", 64),
                                         ("gpt2", 0)])
def test_prefill_against_own_decode(models, name, window, dtype):
    """Prefill's last logits against the port's decode path fed the same
    80-token prompt, within twice JAX's own gap on the same weights.
    ``starcoder2-7b`` (window 64) passes its window to both
    ``init_cache`` and the serve step: the rolling 64-slot cache."""
    m = models(name, dtype)
    toks = _tokens(m["jcfg"], 80, seed=2)
    jl, _ = jax.jit(JM.make_prefill_step(m["jcfg"]))(
        m["jp"], m["ja"], {"tokens": jnp.asarray(toks)})
    jax_gap = _gap(jl, _jax_decode(m, toks, 80, window)[-1][0])
    tl, _ = M.make_prefill_step(m["tcfg"])(
        m["tp"], m["ta"], {"tokens": torch.from_numpy(toks).long()})
    port_gap = _gap(tl, _port_decode(m, toks, 80, window)[-1][0])
    print(f"{name} {dtype}: prefill against decode, port {port_gap:.3g}, "
          f"JAX {jax_gap:.3g}")
    assert port_gap <= 2 * jax_gap


@pytest.mark.parametrize("dtype", DTYPES)
def test_rolling_cache_matches_jax(models, dtype):
    """starcoder2-7b-smoke's window of 64 over 80 steps: the cache is the
    rolling 64-slot one, written at ``pos % 64``."""
    m = models("starcoder2-7b", dtype)
    toks = _tokens(m["jcfg"], 80, seed=3)
    want = _jax_decode(m, toks, 80, window=64)
    got = _port_decode(m, toks, 80, window=64)
    assert got[-1][1][0][0].shape[1] == 64
    for p in (0, 40, 63, 64, 65, 79):
        _check_logits(got[p][0], want[p][0], dtype, f"step {p}")
        _check_decode_caches(got[p][1], want[p][1], dtype, f"step {p}")


def test_serve_window_is_the_argument_not_the_config(models):
    """``make_serve_step(cfg)`` ignores ``cfg.sliding_window`` (64) as
    JAX's does, so past 64 tokens it leaves prefill (which windows)
    far behind, in both packages alike; with ``window=64`` both close
    the gap."""
    m = models("starcoder2-7b", "float32")
    assert m["tcfg"].sliding_window == 64
    toks = _tokens(m["jcfg"], 80, seed=4)
    tl, _ = M.make_prefill_step(m["tcfg"])(
        m["tp"], m["ta"], {"tokens": torch.from_numpy(toks).long()})
    full = _port_decode(m, toks, 80, window=0)
    jfull = _jax_decode(m, toks, 80, window=0)
    _check_logits(full[-1][0], jfull[-1][0], "float32", "window 0")
    windowed = _port_decode(m, toks, 80, window=64)
    gap_full, gap_win = _gap(tl, full[-1][0]), _gap(tl, windowed[-1][0])
    print(f"prefill against decode: window 0 {gap_full:.3g}, "
          f"window 64 {gap_win:.3g}")
    assert gap_full > 0.5 and gap_win < 0.05


@pytest.mark.parametrize("dtype", DTYPES)
def test_write_past_the_cache_end_clamps(models, dtype):
    """A position past a (non-rolling) cache's end writes its last slot,
    as JAX's ``dynamic_update_slice`` clamps; the attention mask then
    admits every slot."""
    m = models("llama3.2-1b", dtype)
    toks = _tokens(m["jcfg"], 6, seed=5)
    want = _jax_decode(m, toks, 4, start=0)
    got = _port_decode(m, toks, 4, start=0)
    for p in (3, 4, 5):
        _check_logits(got[p][0], want[p][0], dtype, f"pos {p}")
        _check_decode_caches(got[p][1], want[p][1], dtype, f"pos {p}")
    # slot 3 holds the last position's k/v: rewriting it changed it
    assert not torch.equal(got[3][1][0][0][:, 3], got[5][1][0][0][:, 3])
    assert torch.equal(got[3][1][0][0][:, :3], got[5][1][0][0][:, :3])


def test_position_as_a_device_tensor_equals_an_int(models):
    """``pos`` as a 0-dim int tensor (no read to the host) gives the
    int path's logits and caches bit for bit, the rolling cache and the
    clamp included."""
    m = models("starcoder2-7b", "bfloat16")
    toks = _tokens(m["jcfg"], 70, seed=6)
    for S, window in ((64, 64), (8, 0)):
        serve = M.make_serve_step(m["tcfg"], window=window)
        c_int = M.init_cache(m["tcfg"], B, S, window=window, device="cpu")
        c_t = M.init_cache(m["tcfg"], B, S, window=window, device="cpu")
        for p in range(toks.shape[1]):
            tok = torch.from_numpy(toks[:, p:p + 1]).long()
            li, c_int = serve(m["tp"], m["ta"], c_int, tok, p)
            lt, c_t = serve(m["tp"], m["ta"], c_t, tok, torch.tensor(p))
            assert torch.equal(li, lt)
        for (a, b), (c, d) in zip(c_int, c_t):
            assert torch.equal(a, c) and torch.equal(b, d)


def test_decode_attention_masks_like_jax():
    """``decode_attention`` alone, bfloat16 cache, GQA 8 q-heads over 2,
    with and without a window, against JAX's on the same inputs."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, 1, 8, 64)).astype(np.float32)
    k = rng.standard_normal((3, 20, 2, 64)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 64)).astype(np.float32)
    jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    tk, tv = convert.from_jax(np.asarray(jk)), convert.from_jax(
        np.asarray(jv))
    for pos, window in ((0, 0), (11, 0), (19, 0), (15, 6)):
        want = jattn.decode_attention(jnp.asarray(q), jk, jv,
                                      jnp.asarray(pos), window=window)
        got = tattn.decode_attention(torch.from_numpy(q), tk, tv, pos,
                                     window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_cache_from_jax_unrolls_groups():
    """JAX's group-stacked cache tuple → one (k, v) a layer, layer
    ``g·P + p``, bit for bit (bfloat16 carried as its bits)."""
    jcfg = dataclasses.replace(jget("llama3.2-1b-smoke"), n_layers=3)
    jc = JM.init_cache(jcfg, 2, 5)
    rng = np.random.default_rng(8)
    jc = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), x.dtype), jc)
    got = convert.cache_from_jax(_np(jc))
    assert len(got) == 3
    for g in range(3):
        for i in range(2):
            assert got[g][i].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[g][i].view(torch.int16).numpy(),
                np.asarray(jc[0][i][g]).view(np.int16))


def test_init_cache_shapes():
    cfg = tget("starcoder2-7b-smoke")
    for window, s in ((0, 100), (64, 64), (200, 100)):
        cache = M.init_cache(cfg, 3, 100, window=window, device="cpu")
        assert len(cache) == cfg.n_layers
        for k, v in cache:
            assert k.shape == v.shape == (3, s, cfg.n_kv_heads, cfg.head_dim)
            assert k.dtype == torch.bfloat16 and not k.any()
    c32 = M.init_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
    assert c32[0][0].dtype == torch.float32


# ---------------------------------------------------------------------------
# PEFT: the inference deployment path
# ---------------------------------------------------------------------------
def test_lora_merge_equivalence():
    """``tests/test_peft.py::test_lora_merge_equivalence`` ported: the
    merged-weights product equals the adapter path (bf16 re-rounding of
    the merged weight: rtol 2e-2, atol 1e-2, the JAX test's), and the
    merged weight equals JAX's, bit for bit or one bfloat16 ulp apart."""
    jcfg, tcfg = jget("stablelm-3b-smoke"), tget("stablelm-3b-smoke")
    key = jax.random.PRNGKey(11)
    jp = JM.init_params(jcfg, key)
    ja = jax.tree.map(lambda x: x + 0.01, JM.init_adapters(jcfg, key, jp))
    layer0 = jax.tree.map(lambda x: x[0], jp["groups"][0])
    adp0 = jax.tree.map(lambda x: x[0], ja["groups"][0])
    tl = convert.from_jax(_np(layer0))
    ta = convert.from_jax(_np(adp0))
    x = np.asarray(jax.random.normal(key, (2, 8, jcfg.d_model)))
    tx = torch.from_numpy(x)
    merged = tlora.merge_layer(tcfg, tl, ta)
    y_adapter = dense(tx[None], tl["wq"].float(),
                      lora_pair({**tl, **ta}, "wq", tcfg.lora))[0]
    y_merged = dense(tx, merged["wq"].float())
    np.testing.assert_allclose(y_adapter.numpy(), y_merged.numpy(),
                               rtol=2e-2, atol=1e-2)
    jmerged = jlora.merge_layer(jcfg, layer0, adp0)
    for name, w in jmerged.items():
        got = merged[name]
        assert got.dtype == tl[name].dtype
        ulps = (got.view(torch.int16).int() - convert.from_jax(
            np.asarray(w)).view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1, name
    # the JAX adapter path, for the same inputs
    jy = jdense(jnp.asarray(x), layer0["wq"],
                jlora_pair({**layer0, **adp0}, "wq", jcfg.lora))
    np.testing.assert_allclose(y_adapter.numpy(), np.asarray(jy),
                               rtol=2e-2, atol=2e-2)


def test_adapter_param_count():
    """``tests/test_peft.py::test_adapter_count_is_small`` ported, and
    the count equal to JAX's."""
    jcfg, tcfg = jget("llama3-405b-smoke"), tget("llama3-405b-smoke")
    jp = JM.init_params(jcfg, KEY)
    ja = JM.init_adapters(jcfg, KEY, jp)
    tp = M.init_params(tcfg, np.asarray(KEY), device="cpu")
    ta = M.init_adapters(tcfg, np.asarray(KEY), tp)
    n_base = sum(int(t.numel()) for t in [tp["embed"], tp["final_norm"],
                                          tp["lm_head"]]
                 + [w for lyr in tp["layers"] for w in lyr.values()])
    n_adp = tlora.adapter_param_count(ta)
    assert n_adp == jlora.adapter_param_count(ja)
    assert n_adp < 0.2 * n_base
