"""The port's multi-head latent attention (``models/attention.py``) against
the JAX package's ``mla_train`` and ``mla_decode``, on minicpm3-4b-smoke's
first layer carried across by ``convert`` (``lora_b`` + 0.01, so every
adapted projection carries signal), two clients of random inputs
(numpy seed); and the plain ``flash_attention`` at the head dims the
configs use, against JAX's jnp chunked flash.

Float32: within 1e-5 of the largest magnitude (the bound of
``tests/test_torch_models.py``); the decode caches, bfloat16, equal but
for elements one ulp apart.
bfloat16: within 2e-2 of the largest magnitude (``tests/test_torch_decode.py``'s
bfloat16 cache bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch import convert
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from torch_families import as_f32, np_tree, smoke_model

torch.set_num_threads(1)

C, B, S = 2, 2, 20
_mla_train = jax.jit(jattn.mla_train, static_argnums=(1,))
_mla_decode = jax.jit(jattn.mla_decode, static_argnums=(1,),
                      static_argnames=("window",))


def _layer(m):
    jl = {**jax.tree.map(lambda x: x[0], m["jp"]["groups"][0]),
          **jax.tree.map(lambda x: x[0], m["ja"]["groups"][0])}
    return jl, convert.from_jax(np_tree(jl))


def _client(tl, c):
    """The port's layer with its adapters stacked for C clients (client
    c's the JAX layer's, the other scaled)."""
    out = {}
    for k, v in tl.items():
        if "_lora_" in k:
            out[k] = torch.stack([v * (1.0 + 0.5 * i) for i in range(C)])
        else:
            out[k] = v
    return out


def _jax_client(jl, c):
    return {k: (v * (1.0 + 0.5 * c) if "_lora_" in k else v)
            for k, v in jl.items()}


def _rel(got, want) -> float:
    got, want = as_f32(got), as_f32(want)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_train_matches_jax(dtype):
    m = smoke_model("minicpm3-4b", dtype)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jl, tl = _layer(m)
    tl = _client(tl, 0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((C, B, S, tcfg.d_model)).astype(np.float32)
    tdt = getattr(torch, dtype)
    y, (c_kv, k_rope) = tattn.mla_train(
        tl, tcfg, torch.from_numpy(x).to(tdt), torch.arange(S))
    assert c_kv.shape == (C * B, S, tcfg.mla.kv_lora_rank)
    assert k_rope.shape == (C * B, S, tcfg.mla.qk_rope_head_dim)
    bound = 2e-2 if dtype == "bfloat16" else 1e-5
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    for c in range(C):
        wy, (wc, wk) = _mla_train(_jax_client(jl, c), jcfg,
                                       jnp.asarray(x[c], jnp.dtype(dtype)),
                                       pos)
        assert _rel(y[c], wy) <= bound
        assert _rel(c_kv[c * B:(c + 1) * B], wc) <= bound
        assert _rel(k_rope[c * B:(c + 1) * B], wk) <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype):
    """Six absorbed-matrix steps over a compressed cache of 8 slots from
    position 3 on (positions 3..8: the last writes clamp to slot 7), the
    position an int and a 0-dim tensor, with and without a window."""
    m = smoke_model("minicpm3-4b", dtype)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    jl, tl = _layer(m)
    rng = np.random.default_rng(1)
    r, rope = tcfg.mla.kv_lora_rank, tcfg.mla.qk_rope_head_dim
    for window in (0, 4):
        ckv0 = rng.standard_normal((B, 8, r)).astype(np.float32)
        kr0 = rng.standard_normal((B, 8, rope)).astype(np.float32)
        jc, jk = (jnp.asarray(a, jnp.bfloat16) for a in (ckv0, kr0))
        tc = convert.from_jax(np.asarray(jc))
        tk = convert.from_jax(np.asarray(jk))
        bound = 2e-2 if dtype == "bfloat16" else 1e-5
        for step, p in enumerate(range(3, 9)):
            x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
            wy, (jc, jk) = _mla_decode(
                jl, jcfg, jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(p),
                jc, jk, window=window)
            pos = torch.tensor(p) if step % 2 else p
            y, (tc, tk) = tattn.mla_decode(
                {k: v[None] if "_lora_" in k else v for k, v in tl.items()},
                tcfg, torch.from_numpy(x)[None].to(getattr(torch, dtype)),
                pos, tc, tk, window=window)
            assert _rel(y[0], wy) <= bound, (window, p)
            for g, w in ((tc, jc), (tk, jk)):
                got = g.view(torch.int16).numpy()
                want = np.asarray(w).view(np.int16)
                if dtype == "float32":
                    # one bfloat16 rounding of float32 values that agree to
                    # an ulp or two: equal, or one ulp apart
                    ulps = np.abs(got.astype(np.int32) - want)
                    assert ulps.max() <= 1 and (ulps > 0).mean() <= 1e-2
                else:
                    assert _rel(g, w) <= bound


@pytest.mark.parametrize("D,Dv", [(80, 80), (96, 64), (112, 112)])
def test_plain_flash_attention_at_new_head_dims_matches_jax(D, Dv):
    """``ref.flash_attention`` (the kernel's plain version) at stablelm's
    80, MLA's 96 over a v of 64, and kimi-k2's 112, against the JAX
    model's jnp chunked flash, causal with and without a window, grouped
    heads: within 1e-5 of the largest magnitude; the output's head dim
    is v's and the scale is q's ``D ** -0.5``."""
    rng = np.random.default_rng(D)
    Bq, Sq, H, KH = 2, 40, 4, 2
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KH, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KH, Dv)).astype(np.float32)
    for window in (0, 7):
        want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     window=window, q_chunk=16, k_chunk=8)
        got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  window=window)
        assert got.shape == (Bq, Sq, H, Dv)
        assert _rel(got, want) <= 1e-5
