"""The port's mixture-of-experts block (``models/ffn.py``) against the JAX
package's ``moe``: on kimi-k2-smoke's and maverick-smoke's MoE layer
weights carried across by ``convert``, two clients of random tokens
(numpy seed), each routed alone as JAX routes one client's batch.

Float32: the output and the balance loss within 1e-5 of the largest
magnitude (``tests/test_torch_models.py``'s bound), and every routing
integer equal: the top-k experts, each choice's rank in its expert, the
kept set, the capacity and the per-expert counts, against the JAX
package's own routing ops (``lax.top_k``, the stable argsort and
``searchsorted``) on the same inputs.  bfloat16: the output within 2e-2
of the largest magnitude, a token over it only as a routing flip near a
tie (``tests/torch_families.py``), reported with its margin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as jffn
from repro.models.common import rms_norm as jrms_norm
from repro_torch import convert
from repro_torch.models import ffn
from torch_families import (FLIP_MARGIN, as_f32, np_tree, routed,
                            smoke_model, token_margins)

torch.set_num_threads(1)

MOE = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]
C, B, S = 2, 3, 16
_moe = jax.jit(jffn.moe, static_argnums=(1,))


def _layer(m):
    """The first MoE layer of the JAX base, and the port's copy."""
    g = next(i for i, (_, f) in enumerate(m["jcfg"].pattern) if f == "moe")
    jl = jax.tree.map(lambda x: x[0], m["jp"]["groups"][g])
    return jl, convert.from_jax(np_tree(jl))


def _x(cfg, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((C, B, S, cfg.d_model)).astype(np.float32), \
        getattr(jnp, dtype)


def _jax_routing(jl, cfg, x):
    """The JAX package's routing ops on one client's ``(B, S, d)``, as
    ``repro/models/ffn.py::moe`` runs them."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    xn = jrms_norm(x, jl["ln2"], cfg.norm_eps).reshape(T, -1)
    logits = jnp.einsum("td,de->te", xn.astype(jnp.float32), jl["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gates, ids = jax.lax.top_k(probs, m.top_k)
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(m.n_experts))
    pos_sorted = jnp.arange(flat_e.shape[0]) - starts[sorted_e]
    pos = jnp.zeros(flat_e.shape, jnp.int32).at[order].set(pos_sorted)
    cap = jffn._capacity(T, m)
    return dict(experts=np.asarray(ids), pos=np.asarray(pos),
                keep=np.asarray(pos < cap), capacity=cap)


def _run(tcfg, tl, x, dtype):
    """The port's block on ``x``, and each client's ``Routing``."""
    with routed() as routing:
        y, bal = ffn.moe(tl, tcfg,
                         torch.from_numpy(x).to(getattr(torch, dtype)))
    return y, bal, routing


@pytest.mark.parametrize("name", MOE)
def test_moe_float32_matches_jax_and_every_routing_integer(name):
    m = smoke_model(name, "float32")
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jl, tl = _layer(m)
    x, _ = _x(tcfg, "float32")
    y, bal, routing = _run(tcfg, tl, x, "float32")
    assert y.shape == x.shape and bal.shape == (C,)
    for c in range(C):
        wy, wb = _moe(jl, jcfg, jnp.asarray(x[c]))
        err = np.abs(y[c].numpy() - np.asarray(wy)).max()
        assert err <= 1e-5 * max(1.0, np.abs(np.asarray(wy)).max())
        assert abs(float(bal[c]) - float(wb)) <= 1e-5
        want = _jax_routing(jl, jcfg, jnp.asarray(x[c]))
        r = routing[c]
        assert r.capacity == want["capacity"] == ffn.capacity(B * S,
                                                              tcfg.moe)
        np.testing.assert_array_equal(r.experts.numpy(), want["experts"])
        np.testing.assert_array_equal(r.pos.numpy(), want["pos"])
        np.testing.assert_array_equal(r.keep.numpy(), want["keep"])
        counts = np.bincount(want["experts"].reshape(-1),
                             minlength=tcfg.moe.n_experts)
        np.testing.assert_array_equal(
            torch.bincount(r.experts.reshape(-1),
                           minlength=tcfg.moe.n_experts).numpy(), counts)


@pytest.mark.parametrize("name", MOE)
def test_moe_bfloat16_matches_jax(name):
    m = smoke_model(name, "bfloat16")
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jl, tl = _layer(m)
    x, jdt = _x(tcfg, "bfloat16", seed=1)
    y, bal, calls = _run(tcfg, tl, x, "bfloat16")
    assert y.dtype == torch.bfloat16
    for c in range(C):
        wy, wb = _moe(jl, jcfg, jnp.asarray(x[c], jdt))
        got, want = as_f32(y[c]).reshape(B * S, -1), as_f32(wy).reshape(
            B * S, -1)
        err = np.abs(got - want).max(-1) / np.abs(want).max()
        marg = token_margins(calls[c], tcfg.moe.top_k).numpy()
        for t in np.nonzero(err > 2e-2)[0]:
            assert marg[t] < FLIP_MARGIN, (t, err[t], marg[t])
            print(f"{name} client {c} token {t}: {err[t]:.3g} of the "
                  f"largest, a routing flip at a margin of {marg[t]:.3g}")
        assert abs(float(bal[c]) - float(wb)) <= 2e-2 * float(wb)


def test_forced_overflow_drops_exactly():
    """A router of zeros: every probability ties, so every token takes
    experts 0 and 1 (the lower index first, as ``lax.top_k``), each
    expert keeps the first ``capacity`` tokens, and ``2·(T - capacity)``
    choices are dropped; the output equals JAX's."""
    m = smoke_model("kimi-k2-1t-a32b", "float32")
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jl, tl = _layer(m)
    jl = dict(jl, router=jnp.zeros_like(jl["router"]))
    tl = dict(tl, router=torch.zeros_like(tl["router"]))
    x, _ = _x(tcfg, "float32", seed=2)
    y, _, routing = _run(tcfg, tl, x, "float32")
    T, cap = B * S, ffn.capacity(B * S, tcfg.moe)
    assert cap < T
    for c in range(C):
        r = routing[c]
        assert (r.experts.numpy() == np.array([0, 1])).all()
        assert int((~r.keep).sum()) == 2 * (T - cap)
        np.testing.assert_array_equal(r.pos.view(T, 2).numpy(),
                                      np.stack([np.arange(T)] * 2, 1))
        wy, _ = _moe(jl, jcfg, jnp.asarray(x[c]))
        np.testing.assert_allclose(y[c].numpy(), np.asarray(wy), atol=1e-5,
                                   rtol=0)
    # a dropped token gets the shared expert alone
    with_shared = ffn.moe(tl, tcfg, torch.from_numpy(x))[0]
    no_routed = dataclasses.replace(tcfg.moe, n_shared_experts=0)
    routed_only = ffn.moe(tl, dataclasses.replace(tcfg, moe=no_routed),
                          torch.from_numpy(x))[0]
    xt = torch.from_numpy(x)
    dropped = (routed_only - xt).reshape(C, T, -1)[:, cap:]
    assert float(dropped.abs().max()) == 0.0
    assert float((with_shared - xt).reshape(C, T, -1)[:, cap:].abs()
                 .max()) > 0


def test_sort_ranking_matches_one_hot_cumsum():
    """``tests/test_qlora_moe.py::test_moe_sort_ranking_matches_cumsum``
    for the port: the rank of each choice in its expert by the stable
    argsort and left ``searchsorted`` equals the one-hot cumsum minus
    one."""
    rng = np.random.default_rng(0)
    for E, TK in ((7, 200), (384, 4096), (4, 1)):
        flat_e = rng.integers(0, E, TK)
        onehot = np.eye(E, dtype=np.int64)[flat_e]
        want = np.take_along_axis(np.cumsum(onehot, 0) - 1,
                                  flat_e[:, None], 1)[:, 0]
        got = ffn.rank_in_expert(torch.from_numpy(flat_e), E)
        np.testing.assert_array_equal(got.numpy(), want)


def test_capacity_equals_jax():
    base = smoke_model("kimi-k2-1t-a32b", "float32")["tcfg"].moe
    for n_experts, top_k, cf in ((384, 8, 1.25), (128, 1, 1.25), (4, 2, 1.0),
                                 (16, 2, 2.0)):
        mc = dataclasses.replace(base, n_experts=n_experts, top_k=top_k,
                                 capacity_factor=cf)
        for T in (1, 4, 128, 2048, 4097):
            assert ffn.capacity(T, mc) == jffn._capacity(T, mc)
    full = dataclasses.replace(base, n_experts=384, top_k=8)
    assert ffn.capacity(2048, full) == 56 and ffn.capacity(4, full) == 8
