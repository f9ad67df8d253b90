"""The port's xLSTM mixers (``models/xlstm.py``) against the JAX package's
``repro/models/xlstm.py``, on layers drawn at xlstm-125m-smoke's widths
(d_model 256, 4 heads, ed 512, mLSTM head dim 128, conv width 4) and
carried across by ``convert``, with LoRA adapters on the mLSTM's ``wq``
(xlstm-125m's one target there) and the sLSTM's ``w_gates``, and two
clients of random inputs (numpy seed): ``_group_norm``, the sequential
and chunkwise mLSTM against both JAX forms, ``mlstm_decode``,
``slstm_train``, ``slstm_decode``, each train form's state against a loop
of decode steps, and the draws against JAX's key tree.

The two mLSTM forms may carry different stabilisers ``m``, so their
states are compared as ``C·e^m`` and ``n·e^m``.  Tolerances: float32
within 1e-5 of the largest magnitude (``tests/test_torch_models.py``'s
bound), across the two forms and against a decode loop 1e-4
(``tests/test_torch_decode.py``'s state bound); bfloat16 within 2e-2
(``tests/test_torch_decode.py``'s bfloat16 cache bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.models import xlstm as jx
from repro_torch import convert
from repro_torch.configs.registry import get as tget
from repro_torch.models import xlstm
from torch_families import DRAW_SAME, KEY, as_f32, draw_gaps, np_tree

torch.set_num_threads(1)

NAME = "xlstm-125m-smoke"
C, B = 2, 2
_jit = {n: jax.jit(getattr(jx, n), static_argnums=(1,)) for n in (
    "mlstm_train", "mlstm_train_chunkwise", "mlstm_decode", "slstm_train",
    "slstm_decode")}
_TARGET = {"mlstm": "wq", "slstm": "w_gates"}


def _rel(got, want) -> float:
    got, want = as_f32(got), as_f32(want)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


def _layer(mixer: str, dtype: str, rank: int = 4):
    """One ``mixer`` layer of the JAX package with an adapter on its
    target, for each client: JAX's dicts and the port's (adapters
    stacked)."""
    jcfg = jget(NAME)
    jp = getattr(jx, f"{mixer}_params")(KEY, jcfg, jnp.dtype(dtype))
    rng = np.random.default_rng(11)
    n = _TARGET[mixer]
    clients = []
    for _ in range(C):
        d_in, d_out = jp[n].shape
        clients.append({**jp, f"{n}_lora_a": jnp.asarray(
            rng.standard_normal((d_in, rank)).astype(np.float32)
            / np.sqrt(d_in)), f"{n}_lora_b": jnp.asarray(
            0.05 * rng.standard_normal((rank, d_out)).astype(np.float32))})
    tp = convert.from_jax(np_tree(jp))
    for k in (f"{n}_lora_a", f"{n}_lora_b"):
        tp[k] = torch.stack([convert.from_jax(np.asarray(cl[k]))
                             for cl in clients])
    return jcfg, tget(NAME), clients, tp


def _x(S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((C, B, S, 256)).astype(np.float32)


def _scaled(state):
    """An mLSTM state as ``(C·e^m, n·e^m)`` in float64."""
    Cs, n, m = (as_f32(t).astype(np.float64) for t in state[:3])
    e = np.exp(m)
    return Cs * e[..., None, None], n * e[..., None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (3.0 + rng.standard_normal((2, 5, 64))).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jx._group_norm(jnp.asarray(x, jd), jnp.asarray(s, jd), 4)
    got = xlstm._group_norm(torch.from_numpy(x).to(td),
                            torch.from_numpy(s).to(td), 4)
    assert got.dtype == td
    assert _rel(got, want) <= (2e-2 if dtype == "bfloat16" else 1e-6)


@pytest.mark.parametrize("S", [16, 128])
def test_mlstm_forms_match_both_jax_forms(S):
    """The port's sequential and chunkwise mLSTM (128: two chunks of 64)
    against JAX's of the same form (outputs and states within 1e-5) and
    of the other (1e-4, states as C·e^m and n·e^m)."""
    jcfg, tcfg, jl, tl = _layer("mlstm", "float32")
    x = _x(S)
    port = {"seq": xlstm.mlstm_train(tl, tcfg, torch.from_numpy(x)),
            "chunk": xlstm.mlstm_train_chunkwise(tl, tcfg,
                                                 torch.from_numpy(x))}
    H, D = tcfg.n_heads, 512 // tcfg.n_heads
    for form, (y, st) in port.items():
        assert y.shape == x.shape
        assert [tuple(t.shape) for t in st] == [(C * B, H, D, D),
                                                (C * B, H, D), (C * B, H)]
        assert all(t.dtype == torch.float32 for t in st)
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        jax_out = {"seq": _jit["mlstm_train"](jl[c], jcfg, jnp.asarray(x[c])),
                   "chunk": _jit["mlstm_train_chunkwise"](jl[c], jcfg,
                                                          jnp.asarray(x[c]))}
        for pf, (y, st) in port.items():
            for jf, (wy, wst) in jax_out.items():
                bound = 1e-5 if pf == jf else 1e-4
                assert _rel(y[c], wy) <= bound, (pf, jf)
                if pf == jf:
                    for g, w in zip(st, wst):
                        assert _rel(g[sl], w) <= bound, (pf, jf)
                gs = _scaled([t[sl] for t in st])
                for g, w in zip(gs, _scaled(wst)):
                    assert _rel(g, w) <= 1e-4, (pf, jf)


@pytest.mark.parametrize("chunkwise", [False, True])
def test_mlstm_bf16_matches_jax(chunkwise):
    jcfg, tcfg, jl, tl = _layer("mlstm", "bfloat16")
    x = _x(64, seed=2)
    fn = "mlstm_train_chunkwise" if chunkwise else "mlstm_train"
    y, st = getattr(xlstm, fn)(tl, tcfg,
                               torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    for c in range(C):
        wy, wst = _jit[fn](jl[c], jcfg, jnp.asarray(x[c], jnp.bfloat16))
        assert _rel(y[c], wy) <= 2e-2
        for g, w in zip(st, wst):
            assert _rel(g[c * B:(c + 1) * B], w) <= 2e-2


def _state(mixer, tcfg, rng, dtype):
    if mixer == "slstm":
        return [rng.standard_normal((C * B, 256)).astype(np.float32)
                for _ in range(4)]
    H, D = tcfg.n_heads, 512 // tcfg.n_heads
    return [rng.standard_normal((C * B, H, D, D)).astype(np.float32) * 0.1,
            rng.standard_normal((C * B, H, D)).astype(np.float32),
            rng.standard_normal((C * B, H)).astype(np.float32),
            rng.standard_normal((C * B, 3, 512)).astype(np.float32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_decode_matches_jax_in_place(mixer, dtype):
    """One step from a random state: the output and every state against
    JAX's, written into the tensors passed in (the mLSTM's conv state in
    the activation dtype, the rest float32)."""
    jcfg, tcfg, jl, tl = _layer(mixer, dtype)
    rng = np.random.default_rng(3)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = _x(1, seed=4)
    st0 = _state(mixer, tcfg, rng, dtype)
    conv = mixer == "mlstm"
    st = [torch.from_numpy(s.copy()).to(td if conv and i == 3 else
                                        torch.float32)
          for i, s in enumerate(st0)]
    y, new = getattr(xlstm, f"{mixer}_decode")(
        tl, tcfg, torch.from_numpy(x).to(td), tuple(st))
    assert all(a is b for a, b in zip(new, st))
    bound = 2e-2 if dtype == "bfloat16" else 1e-5
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        jst = tuple(jnp.asarray(s[sl], jd if conv and i == 3 else
                                jnp.float32) for i, s in enumerate(st0))
        wy, wst = _jit[f"{mixer}_decode"](jl[c], jcfg,
                                          jnp.asarray(x[c], jd), jst)
        assert _rel(y[c], wy) <= bound
        for i, (g, w) in enumerate(zip(st, wst)):
            assert g.dtype == (td if conv and i == 3 else torch.float32)
            assert _rel(g[sl], w) <= bound, i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_train_matches_jax(dtype):
    jcfg, tcfg, jl, tl = _layer("slstm", dtype)
    x = _x(48, seed=5)
    td = getattr(torch, dtype)
    y, st = xlstm.slstm_train(tl, tcfg, torch.from_numpy(x).to(td))
    assert y.dtype == td and len(st) == 4
    assert all(t.dtype == torch.float32 and t.shape == (C * B, 256)
               for t in st)
    bound = 2e-2 if dtype == "bfloat16" else 1e-5
    for c in range(C):
        wy, wst = _jit["slstm_train"](jl[c], jcfg,
                                      jnp.asarray(x[c], jnp.dtype(dtype)))
        assert _rel(y[c], wy) <= bound
        for g, w in zip(st, wst):
            assert _rel(g[c * B:(c + 1) * B], w) <= bound


@pytest.mark.parametrize("form", ["mlstm_train", "mlstm_train_chunkwise",
                                  "slstm_train"])
def test_train_state_equals_decode_loop(form):
    """Each train form's state after 128 tokens against 128 decode steps
    from zeros, and the outputs position by position (1e-4)."""
    mixer = form[:5]
    _, tcfg, _, tl = _layer(mixer, "float32")
    S = 128
    x = torch.from_numpy(_x(S, seed=6))
    y, st = getattr(xlstm, form)(tl, tcfg, x)
    dec = [torch.zeros_like(t) for t in _cache(mixer, tcfg)]
    ys = []
    for t in range(S):
        yt, _ = getattr(xlstm, f"{mixer}_decode")(tl, tcfg, x[:, :, t:t + 1],
                                                 tuple(dec))
        ys.append(yt)
    assert _rel(torch.cat(ys, dim=2), y) <= 1e-4
    if mixer == "slstm":
        for g, w in zip(dec, st):
            assert _rel(g, w) <= 1e-4
    else:
        for g, w in zip(_scaled(dec), _scaled(st)):
            assert _rel(g, w) <= 1e-4


def _cache(mixer, tcfg):
    from repro_torch.models import layers
    return layers.cache_struct(tcfg, mixer, C * B, 1, torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_xlstm_params_follow_jax_key_tree(mixer, dtype):
    """Names, shapes and dtypes (the mLSTM's ``w_if``, ``b_if``, the
    sLSTM's ``r_gates``, ``b_gates`` float32 under a bfloat16 base) and
    values to the draw's contract (``tests/test_torch_mamba.py``)."""
    jcfg, tcfg = jget(NAME), tget(NAME)
    want = convert.from_jax(np_tree(getattr(jx, f"{mixer}_params")(
        KEY, jcfg, jnp.dtype(dtype))))
    got = getattr(xlstm, f"{mixer}_params")(np.asarray(KEY), tcfg,
                                            getattr(torch, dtype))
    n, same = draw_gaps(got, want)
    assert same >= DRAW_SAME * n
    for k in (("w_if", "b_if") if mixer == "mlstm" else ("r_gates",
                                                          "b_gates")):
        assert got[k].dtype == torch.float32
