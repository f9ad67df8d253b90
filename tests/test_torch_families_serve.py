"""The mixture-of-experts and latent-attention families served by the port
against the JAX package: ``kimi-k2-1t-a32b`` (GQA with MoE, top-2 of 4
experts and a shared one at ``-smoke`` width), ``llama4-maverick-400b-a17b``
(a period of two layers, dense then MoE, top-1) and ``minicpm3-4b``
(MLA), each ``-smoke``, on the JAX package's weights carried across by
``convert``; one train step of kimi-k2-smoke with its balance loss; the
base draw of each family against JAX's key tree; and the weight draw
taken a slice of its flat index at a time.

Tolerances: ``tests/test_torch_decode.py``'s.  Float32 base: logits
within 1e-4 of the largest; prefill caches within 1e-4 of their largest
magnitude; the bfloat16 decode caches equal but for elements one ulp
apart, at most 1e-3 of them.  bfloat16 base: logits within 3e-2, caches
within 2e-2, or twice JAX's own bfloat16 gap at that layer if larger:
the 2e-2 was set on configs of one layer, and the rounding noise grows
with depth.  maverick-smoke has two (its period), and at its second
layer JAX's own bfloat16 caches are that far from JAX's float32 run on
the same weights (``_own_gaps``).  In bfloat16 a row of logits over its
bound must be a routing flip near a tie (``tests/torch_families.py``),
reported with its margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs.registry import get as tget
from repro_torch.models import common
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves
from torch_families import (KEY, as_f32, check_rows, np_tree, routed,
                            row_margins, smoke_model)

torch.set_num_threads(1)

FAMILIES = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "minicpm3-4b"]
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


def _k(cfg) -> int:
    return cfg.moe.top_k if cfg.moe else 0


def _margins(cfg, calls, rows=B):
    return row_margins(calls, rows, _k(cfg)) if cfg.moe else None


def _check_bf16(got, want, what):
    err = np.abs(as_f32(got) - as_f32(want)).max() / np.abs(
        as_f32(want)).max()
    assert err <= 2e-2, f"{what}: {err:.3g} of the largest magnitude"


def _rel(got, want) -> float:
    return float(np.abs(as_f32(got) - as_f32(want)).max()
                 / np.abs(as_f32(want)).max())


def _own_gaps(m, toks, S: int) -> list:
    """JAX's own bfloat16 gap, layer by layer: its decode caches after
    each of ``toks``' steps against its float32 run on the same (bf16)
    weights, the largest over the steps, of the largest magnitude."""
    f32 = lambda t: t.astype(jnp.float32)  # noqa: E731
    bf = _jax_decode(m, toks, S)
    fl = _jax_decode(dict(m, jp=jax.tree.map(f32, m["jp"])), toks, S)
    gaps = np.zeros(m["tcfg"].n_layers)
    for (_, cb), (_, cf) in zip(bf, fl):
        wb = convert.cache_from_jax(np_tree(cb))
        wf = convert.cache_from_jax(np_tree(cf))
        gaps = np.maximum(gaps, [max(_rel(b, f) for b, f in zip(lb, lf))
                                 for lb, lf in zip(wb, wf)])
    return gaps.tolist()


def _check_decode_caches(got, want_jax, dtype, what, own=None):
    want = convert.cache_from_jax(np_tree(want_jax))
    assert len(got) == len(want)
    n = odd = 0
    for i, (gl, wl) in enumerate(zip(got, want)):
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype == torch.bfloat16
            assert g.shape == w.shape
            if dtype == "bfloat16":
                bound = max(2e-2, 2 * own[i])
                assert _rel(g, w) <= bound, f"{what} layer {i}: " \
                    f"{_rel(g, w):.3g} of the largest, over {bound:.3g}"
                continue
            ulps = (g.view(torch.int16).int()
                    - w.view(torch.int16).int()).abs()
            assert int(ulps.max()) <= 1, what
            n += g.numel()
            odd += int((ulps == 1).sum())
    if dtype == "float32":
        assert odd <= 1e-3 * n, what


def _jax_decode(m, tokens, S, window=0):
    serve = jax.jit(JM.make_serve_step(m["jcfg"], window=window))
    cache = JM.init_cache(m["jcfg"], B, S, window=window)
    out = []
    for p in range(tokens.shape[1]):
        logits, cache = serve(m["jp"], m["ja"], cache,
                              jnp.asarray(tokens[:, p:p + 1]),
                              jnp.asarray(p))
        out.append((logits, cache))
    return out


def _port_decode(m, tokens, S, window=0):
    """The port's serve steps; each with the routing margins of its rows
    (None without MoE)."""
    serve = M.make_serve_step(m["tcfg"], window=window)
    cache = M.init_cache(m["tcfg"], B, S, window=window, device="cpu")
    out = []
    for p in range(tokens.shape[1]):
        with routed() as calls:
            logits, cache = serve(m["tp"], m["ta"], cache,
                                  torch.from_numpy(tokens[:, p:p + 1]).long(),
                                  p)
        out.append((logits, [tuple(t.clone() for t in c) for c in cache],
                    _margins(m["tcfg"], calls)))
    return out


def _check_logits(got, want, dtype, margins, what):
    bound = 3e-2 if dtype == "bfloat16" else 1e-4
    return check_rows(got, want, bound,
                      margins if dtype == "bfloat16" else None, what)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_serve_steps_match_jax(models, name, dtype):
    """12 serve steps on the same fed tokens: logits and every layer's
    decode cache after each, against JAX's."""
    m = models(name, dtype)
    toks = _tokens(m["jcfg"], STEPS)
    want = _jax_decode(m, toks, 16)
    got = _port_decode(m, toks, 16)
    own = _own_gaps(m, toks, 16) if dtype == "bfloat16" else None
    if own:
        print(f"{name}: JAX's own bfloat16 cache gap by layer "
              f"{[f'{g:.3g}' for g in own]}")
    flips = 0
    for p, ((gl, gc, marg), (wl, wc)) in enumerate(zip(got, want)):
        assert gl.dtype == torch.float32
        assert gl.shape == (B, m["tcfg"].vocab_size)
        assert bool(torch.isfinite(gl).all())
        flips += len(_check_logits(gl, wl, dtype, marg,
                                   f"{name} {dtype} step {p}"))
        _check_decode_caches(gc, wc, dtype, f"{name} step {p}", own)
    assert flips <= 2, f"{flips} routing flips in {STEPS} steps"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_jax(models, name, dtype):
    """Prefill's last logits and every layer's cache (GQA's (k, v),
    MLA's (c_kv, k_rope)) in the activation dtype."""
    m = models(name, dtype)
    cfg = m["tcfg"]
    toks = _tokens(m["jcfg"], 24, seed=1)
    wl, wc = jax.jit(JM.make_prefill_step(m["jcfg"]))(
        m["jp"], m["ja"], {"tokens": jnp.asarray(toks)})
    with routed() as calls:
        gl, gc = M.make_prefill_step(cfg)(
            m["tp"], m["ta"], {"tokens": torch.from_numpy(toks).long()})
    assert gl.dtype == torch.float32 and gl.shape == (B, cfg.vocab_size)
    _check_logits(gl, wl, dtype, _margins(cfg, calls), f"{name} prefill")
    want = convert.cache_from_jax(np_tree(wc))
    assert len(gc) == len(want) == cfg.n_layers
    if dtype == "bfloat16":
        # JAX's own bfloat16 gap by layer, against its float32 run on the
        # same weights
        f32 = lambda t: t.astype(jnp.float32)  # noqa: E731
        _, wc32 = jax.jit(JM.make_prefill_step(m["jcfg"]))(
            jax.tree.map(f32, m["jp"]), m["ja"],
            {"tokens": jnp.asarray(toks)})
        own = [max(_rel(b, f) for b, f in zip(lb, lf)) for lb, lf in zip(
            want, convert.cache_from_jax(np_tree(wc32)))]
    for i, (gcl, wcl) in enumerate(zip(gc, want)):
        mixer = cfg.pattern[i % len(cfg.pattern)][0]
        shapes = ([(B, 24, cfg.mla.kv_lora_rank),
                   (B, 24, cfg.mla.qk_rope_head_dim)] if mixer == "mla"
                  else [(B, 24, cfg.n_kv_heads, cfg.head_dim)] * 2)
        for g, w, shape in zip(gcl, wcl, shapes):
            assert g.dtype == w.dtype == getattr(torch, dtype)
            assert g.shape == shape
            if dtype == "bfloat16":
                bound = max(2e-2, 2 * own[i])
                assert _rel(g, w) <= bound, (
                    f"{name} prefill cache layer {i}: {_rel(g, w):.3g}, "
                    f"over {bound:.3g}")
            else:
                err = np.abs(as_f32(g) - as_f32(w)).max() / np.abs(
                    as_f32(w)).max()
                assert err <= 1e-4, err


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_against_own_decode(models, name):
    """Prefill's last logits against the port's decode path fed the same
    40-token prompt, within twice JAX's own gap on the same weights (for
    MLA that gap holds ``wkv_b``'s adapter, which decode does not use,
    as in JAX)."""
    m = models(name, "float32")
    toks = _tokens(m["jcfg"], 40, seed=2)
    jl, _ = jax.jit(JM.make_prefill_step(m["jcfg"]))(
        m["jp"], m["ja"], {"tokens": jnp.asarray(toks)})
    jax_gap = float(np.abs(as_f32(jl) - as_f32(
        _jax_decode(m, toks, 40)[-1][0])).max())
    tl, _ = M.make_prefill_step(m["tcfg"])(
        m["tp"], m["ta"], {"tokens": torch.from_numpy(toks).long()})
    port_gap = float(np.abs(as_f32(tl) - as_f32(
        _port_decode(m, toks, 40)[-1][0])).max())
    print(f"{name}: prefill against decode, port {port_gap:.3g}, JAX "
          f"{jax_gap:.3g}")
    assert port_gap <= 2 * jax_gap


def test_mla_decode_window_and_clamp_match_jax(models):
    """minicpm3-4b-smoke decoded with a window of 6 over a cache of 6
    slots (MLA clamps its writes at the last slot; no rolling cache) for
    10 steps, as JAX's."""
    m = models("minicpm3-4b", "float32")
    toks = _tokens(m["jcfg"], 10, seed=3)
    want = _jax_decode(m, toks, 10, window=6)
    got = _port_decode(m, toks, 10, window=6)
    assert got[-1][1][0][0].shape == (B, 6, m["tcfg"].mla.kv_lora_rank)
    for p in range(10):
        _check_logits(got[p][0], want[p][0], "float32", None, f"step {p}")
        _check_decode_caches(got[p][1], want[p][1], "float32", f"step {p}")


@pytest.mark.parametrize("name", FAMILIES)
def test_position_as_a_device_tensor_equals_an_int(models, name):
    m = models(name, "bfloat16")
    toks = _tokens(m["jcfg"], 6, seed=4)
    serve = M.make_serve_step(m["tcfg"])
    c_int = M.init_cache(m["tcfg"], B, 6, device="cpu")
    c_t = M.init_cache(m["tcfg"], B, 6, device="cpu")
    for p in range(6):
        tok = torch.from_numpy(toks[:, p:p + 1]).long()
        li, c_int = serve(m["tp"], m["ta"], c_int, tok, p)
        lt, c_t = serve(m["tp"], m["ta"], c_t, tok, torch.tensor(p))
        assert torch.equal(li, lt)
    for a, b in zip(c_int, c_t):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_kimi_train_step_with_balance_matches_jax(models):
    """One ``make_train_step`` of kimi-k2-smoke, two clients stacked
    against JAX's step of each: the loss (cross-entropy plus
    ``balance_loss_weight`` × the balance), the adapter gradients and
    AdamW's first moment (0.1 × the gradient) within 1e-5 of the
    largest magnitude.  The updated adapters are not compared: AdamW's
    first step maps a gradient near its eps to about ±lr."""
    m = models("kimi-k2-1t-a32b", "float32")
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(5)
    C, S = 2, 16
    jadp = [jax.tree.map(lambda x: x + 0.01 * c, m["ja"]) for c in range(2)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jadp)
    tadp = convert.adapters_from_jax(np_tree(stacked), stacked=True)
    tokens = rng.integers(4, tcfg.vocab_size - 4, (C, B, S)).astype(np.int32)
    labels = rng.integers(4, tcfg.vocab_size - 4, (C, B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    step = M.make_train_step(tcfg, lr=3e-3)
    new_adp, new_opt, metrics = step(m["tp"], tadp,
                                     adamw.init(tadp, n_clients=C), batch)
    _, balance = M.forward(tcfg, m["tp"], tadp, batch["tokens"],
                           with_balance=True)
    assert balance.shape == (C,) and bool((balance > 0).all())
    jstep = jax.jit(JM.make_train_step(jcfg, lr=3e-3,
                                       opts=JM.FwdOptions(remat=False)))
    for c in range(C):
        ja, jo, jmet = jstep(m["jp"], jadp[c], jadamw.init(jadp[c]),
                             {"tokens": jnp.asarray(tokens[c]),
                              "labels": jnp.asarray(labels[c])})
        _, jbal, _ = JM.forward(jcfg, m["jp"], jadp[c],
                                {"tokens": jnp.asarray(tokens[c])})
        assert abs(float(balance[c]) - float(jbal)) <= 1e-5
        assert abs(float(metrics["loss"][c]) - float(jmet["loss"])) <= 1e-5
        for got_t, want_t in ((new_opt.mu, jo.mu),):
            want_l = tree_leaves(convert.adapters_from_jax(np_tree(want_t)))
            for g, w in zip(tree_leaves(got_t), want_l):
                g, w = g[c].numpy(), w.numpy()
                assert np.abs(g - w).max() <= 1e-5 * max(1.0,
                                                         np.abs(w).max())


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_follow_jax_key_tree(name):
    """The port's own base draw of each family: the JAX package's leaf
    names and shapes (3-D expert stacks, the float32 router, MLA's
    latent projections), its values to the draw's contract (within 2
    ulp, bitwise on at least 99.9 %), and adapters on the 2-D targets
    only."""
    jcfg, tcfg = jget(name + "-smoke"), tget(name + "-smoke")
    jp = JM.init_params(jcfg, KEY)
    tp = M.init_params(tcfg, np.asarray(KEY), device="cpu")
    want = convert.params_from_jax(np_tree(jp))
    n = same = 0
    for gl, wl in zip(tp["layers"] + [tp], want["layers"] + [want]):
        keys = [k for k in wl if k != "layers"]
        assert sorted(k for k in gl if k != "layers") == sorted(keys)
        for k in keys:
            g, w = gl[k], wl[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            gf, wf = g.float(), w.float()
            ulp = torch.abs(torch.nextafter(wf, torch.full_like(wf, np.inf))
                            - wf)
            assert bool(((gf - wf).abs() <= 2 * ulp).all()), k
            n += g.numel()
            same += int((gf == wf).sum())
    assert same >= 0.999 * n
    if tcfg.moe:
        moe = next(l for l in tp["layers"] if "router" in l)
        assert moe["router"].dtype == torch.float32
        assert moe["w_in"].shape == (tcfg.moe.n_experts, tcfg.d_model,
                                     2 * tcfg.moe.d_ff)
    ta = M.init_adapters(tcfg, np.asarray(KEY), tp)
    ja = convert.adapters_from_jax(np_tree(JM.init_adapters(jcfg, KEY, jp)))
    for gl, wl in zip(ta, ja):
        assert sorted(gl) == sorted(wl)
        assert all(gl[k].dim() == 2 for k in gl)
    if tcfg.mla:
        assert {"wq_a_lora_a", "wq_b_lora_a", "wkv_a_lora_a",
                "wkv_b_lora_a", "wo_lora_a"} <= set(ta[0])


def test_sliced_draw_is_bitwise_the_whole_draw(monkeypatch):
    """``init_dense`` over more than ``DRAW_SLICE`` values draws a slice of
    the flat index at a time into a tensor of the final dtype: bitwise
    the whole draw, in float32 and bfloat16, for a slice that does not
    divide the leaf."""
    shape = (3, 37, 29)
    key = jr.fold_in(np.asarray(KEY), 7)
    for dtype in (torch.float32, torch.bfloat16):
        whole = common.init_dense(key, shape, dtype)
        monkeypatch.setattr(jr, "DRAW_SLICE", 1000)
        sliced = common.init_dense(key, shape, dtype)
        monkeypatch.setattr(jr, "DRAW_SLICE", 1 << 25)
        assert sliced.dtype == dtype and sliced.shape == shape
        assert torch.equal(whole.view(-1).view(torch.uint8),
                           sliced.view(-1).view(torch.uint8))
    want = jax.random.truncated_normal(jax.random.PRNGKey(0), -2.0, 2.0,
                                       (3000,), jnp.float32)
    got = torch.cat([jr.truncated_normal(np.asarray(KEY), -2.0, 2.0, (n,),
                                         start=s)
                     for s, n in ((0, 1000), (1000, 1500), (2500, 500))])
    ulp = np.spacing(np.abs(np.asarray(want)))
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 2 * ulp)


def test_draw_counters_past_2_to_the_32_equal_jax_threefry():
    """Counters at and above 2**32, where the high word is non-zero (a
    leaf of kimi-k2's experts reaches 11.27 B values): the port's hash on
    its (high, low) words equals JAX's own ``threefry_2x32`` on the
    same words, and a slice drawn there equals the uniform JAX derives
    from those bits."""
    from jax._src import prng as jprng
    key = np.asarray(jax.random.PRNGKey(42))
    start = (1 << 32) - 5
    hi, lo = jr._counters(16, "cpu", start)
    assert hi.tolist() == [0] * 5 + [1] * 11
    b0, b1 = jr._threefry_torch(key, hi, lo)
    k = jnp.asarray(key, jnp.uint32)
    w0, w1 = jprng.threefry2x32_p.bind(
        k[0], k[1], jnp.asarray(hi.numpy().view(np.uint32)),
        jnp.asarray(lo.numpy().view(np.uint32)))
    np.testing.assert_array_equal(b0.numpy().view(np.uint32), np.asarray(w0))
    np.testing.assert_array_equal(b1.numpy().view(np.uint32), np.asarray(w1))
    bits = np.asarray(w0) ^ np.asarray(w1)
    floats = ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - 1.0
    u = jr._uniform_torch(key, (16,), np.float32(0), np.float32(1), "cpu",
                          start)
    np.testing.assert_array_equal(u.numpy(), floats)


@pytest.mark.parametrize("name", FAMILIES)
def test_cache_from_jax_carries_the_family_caches(name):
    """JAX's group-stacked cache → one pair a layer, bit for bit: MLA's
    compressed ``(c_kv, k_rope)`` and maverick's period of two."""
    jcfg = jget(name + "-smoke")
    jc = JM.init_cache(jcfg, 2, 5)
    rng = np.random.default_rng(8)
    jc = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape),
                                            x.dtype), jc)
    got = convert.cache_from_jax(np_tree(jc))
    P = len(jcfg.pattern)
    assert len(got) == jcfg.n_layers
    for i, pair in enumerate(got):
        for j, t in enumerate(pair):
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(jc[i % P][j][i // P]).view(np.int16))
