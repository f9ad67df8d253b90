"""The port's Mamba mixer (``models/ssm.py``) against the JAX package's
``repro/models/ssm.py``, on one layer drawn at jamba-1.5-large-398b-smoke's
widths (d_model 256, ed 512, d_state 16, d_conv 4, dt_rank 16) and carried
across by ``convert``, with LoRA adapters on ``in_proj`` and ``out_proj``
so the adapted product runs too, and two clients of random inputs (numpy
seed): ``_causal_conv``, ``_ssm_inputs``, the associative scan,
``mamba_train`` over one chunk and several, ``mamba_decode``, and the
state the train path hands to decode against a loop of decode steps.

Tolerances: float32 outputs and states within 1e-5 of their largest
magnitude (``tests/test_torch_models.py``'s bound); the train-against-
decode-loop states within 1e-4 (``tests/test_torch_decode.py``'s state
bound); bfloat16 within 2e-2 of the largest magnitude
(``tests/test_torch_decode.py``'s bfloat16 cache bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs.registry import get as tget
from repro_torch.models import ssm
from torch_families import DRAW_SAME, KEY, as_f32, draw_gaps, np_tree

torch.set_num_threads(1)

NAME = "jamba-1.5-large-398b-smoke"
C, B = 2, 2
_train = jax.jit(jssm.mamba_train, static_argnums=(1,))
_decode = jax.jit(jssm.mamba_decode, static_argnums=(1,))


def _rel(got, want) -> float:
    got, want = as_f32(got), as_f32(want)
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


def _layer(dtype: str, rank: int = 4):
    """One Mamba layer of the JAX package, with adapters on ``in_proj``
    and ``out_proj`` (``lora_b`` non-zero), for each client: JAX's dicts
    and the port's, the adapters stacked ``(C, ...)``."""
    jcfg = jget(NAME)
    jp = jssm.mamba_params(KEY, jcfg, jnp.dtype(dtype))
    rng = np.random.default_rng(7)
    clients = []
    for c in range(C):
        extra = {}
        for n in ("in_proj", "out_proj"):
            d_in, d_out = jp[n].shape
            extra[f"{n}_lora_a"] = jnp.asarray(rng.standard_normal(
                (d_in, rank)).astype(np.float32) / np.sqrt(d_in))
            extra[f"{n}_lora_b"] = jnp.asarray(0.05 * rng.standard_normal(
                (rank, d_out)).astype(np.float32))
        clients.append({**jp, **extra})
    tp = convert.from_jax(np_tree(jp))
    for k in clients[0]:
        if "_lora_" in k:
            tp[k] = torch.stack([convert.from_jax(np.asarray(cl[k]))
                                 for cl in clients])
    return jcfg, tget(NAME), clients, tp


def _x(cfg, S, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((C, B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 21, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jssm._causal_conv(jnp.asarray(x, jd), jnp.asarray(w, jd),
                             jnp.asarray(b, jd))
    got = ssm._causal_conv(torch.from_numpy(x).to(td),
                           torch.from_numpy(w).to(td),
                           torch.from_numpy(b).to(td))
    assert got.dtype == td and got.shape == (3, 21, 40)
    assert _rel(got, want) <= (2e-2 if dtype == "bfloat16" else 1e-6)


def test_ssm_inputs_match_jax():
    jcfg, tcfg, jl, tl = _layer("float32")
    rng = np.random.default_rng(2)
    x_c = rng.standard_normal((B, 12, 2 * tcfg.d_model)).astype(np.float32)
    want = jssm._ssm_inputs(jl[0], jcfg, jnp.asarray(x_c))
    got = ssm._ssm_inputs(tl, tcfg, torch.from_numpy(x_c)[None])
    for g, w, what in zip(got, want, ("dt", "B", "C", "A")):
        g = g[0] if what != "A" else g
        assert g.dtype == torch.float32 and g.shape == w.shape, what
        assert _rel(g, w) <= 1e-6, what
    assert bool((got[0] > 0).all())


def test_softplus_is_logaddexp_past_torch_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 21.0, 40.0])
    want = jax.nn.softplus(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(ssm.softplus(x).numpy(), np.asarray(want),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 24, 128])
def test_associative_scan_matches_jax(n):
    """The odd/even recursion against ``jax.lax.associative_scan`` with
    the same operator, and against the sequential recurrence."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 5, 3)).astype(np.float32)

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]
    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ga, gb = ssm.associative_scan(torch.from_numpy(a), torch.from_numpy(b),
                                  dim=1)
    assert _rel(ga, wa) <= 1e-6 and _rel(gb, wb) <= 1e-6
    h = np.zeros((2, 5, 3), np.float64)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
    assert _rel(gb[:, -1], h) <= 1e-5


@pytest.mark.parametrize("S", [32, 128, 256])
def test_mamba_train_matches_jax(S):
    """One chunk (32, 128) and two (256): the output, the last state and
    the conv state of each client against JAX's."""
    jcfg, tcfg, jl, tl = _layer("float32")
    x = _x(tcfg, S, "float32")
    y, (h, conv) = ssm.mamba_train(tl, tcfg, torch.from_numpy(x))
    ed = 2 * tcfg.d_model
    assert y.shape == x.shape and h.shape == (C * B, ed, 16)
    assert conv.shape == (C * B, 3, ed) and h.dtype == torch.float32
    for c in range(C):
        wy, (wh, wconv) = _train(jl[c], jcfg, jnp.asarray(x[c]))
        assert _rel(y[c], wy) <= 1e-5
        assert _rel(h[c * B:(c + 1) * B], wh) <= 1e-5
        assert _rel(conv[c * B:(c + 1) * B], wconv) <= 1e-6


def test_mamba_train_bf16_matches_jax():
    jcfg, tcfg, jl, tl = _layer("bfloat16")
    x = _x(tcfg, 32, "bfloat16", seed=3)
    y, (h, conv) = ssm.mamba_train(tl, tcfg,
                                   torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == conv.dtype == torch.bfloat16
    assert h.dtype == torch.float32
    for c in range(C):
        wy, (wh, wconv) = _train(jl[c], jcfg,
                                 jnp.asarray(x[c], jnp.bfloat16))
        assert _rel(y[c], wy) <= 2e-2
        assert _rel(h[c * B:(c + 1) * B], wh) <= 2e-2
        assert _rel(conv[c * B:(c + 1) * B], wconv) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax_in_place(dtype):
    """One step from a random state: the output and both states against
    JAX's, the states written into the tensors passed in."""
    jcfg, tcfg, jl, tl = _layer(dtype)
    rng = np.random.default_rng(4)
    ed, td = 2 * tcfg.d_model, getattr(torch, dtype)
    x = _x(tcfg, 1, dtype, seed=5)
    h0 = rng.standard_normal((C * B, ed, 16)).astype(np.float32)
    cv0 = rng.standard_normal((C * B, 3, ed)).astype(np.float32)
    h, cv = torch.from_numpy(h0.copy()), torch.from_numpy(cv0.copy()).to(td)
    y, (h2, cv2) = ssm.mamba_decode(tl, tcfg, torch.from_numpy(x).to(td),
                                    h, cv)
    assert h2 is h and cv2 is cv and cv.dtype == td
    bound = 2e-2 if dtype == "bfloat16" else 1e-5
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        wy, (wh, wcv) = _decode(jl[c], jcfg,
                                jnp.asarray(x[c], jnp.dtype(dtype)),
                                jnp.asarray(h0[sl]),
                                jnp.asarray(cv0[sl], jnp.dtype(dtype)))
        assert _rel(y[c], wy) <= bound
        assert _rel(h[sl], wh) <= bound
        assert _rel(cv[sl], wcv) <= bound


def test_train_state_equals_decode_loop():
    """mamba_train's state after 256 tokens (two chunks) against 256
    decode steps from zeros, in the port and, for scale, in JAX."""
    jcfg, tcfg, jl, tl = _layer("float32")
    S, ed = 256, 2 * tcfg.d_model
    x = torch.from_numpy(_x(tcfg, S, "float32", seed=6))
    y, (h, conv) = ssm.mamba_train(tl, tcfg, x)
    hd = torch.zeros((C * B, ed, 16))
    cd = torch.zeros((C * B, 3, ed))
    ys = []
    for t in range(S):
        yt, _ = ssm.mamba_decode(tl, tcfg, x[:, :, t:t + 1], hd, cd)
        ys.append(yt)
    assert _rel(hd, h) <= 1e-4
    assert _rel(cd, conv) <= 1e-4
    assert _rel(torch.cat(ys, dim=2), y) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_params_follow_jax_key_tree(dtype):
    """Names, shapes and dtypes (``dt_b``, ``A_log``, ``D`` float32 under
    a bfloat16 base) of JAX's draw, its values to the draw's contract
    (``dt_b``'s exp, expm1 and log chain is rounded once an op here, and
    lands within 2 ulp of XLA's, bitwise on about 70 % of its values)."""
    jcfg, tcfg = jget(NAME), tget(NAME)
    want = convert.from_jax(np_tree(jssm.mamba_params(
        KEY, jcfg, jnp.dtype(dtype))))
    got = ssm.mamba_params(np.asarray(KEY), tcfg, getattr(torch, dtype))
    n, same = draw_gaps(got, want)
    for k in ("dt_b", "A_log", "D"):
        assert got[k].dtype == torch.float32
    dt = (got["dt_b"] - want["dt_b"]).abs()
    ulp = torch.abs(torch.nextafter(want["dt_b"], torch.full_like(
        want["dt_b"], np.inf)) - want["dt_b"])
    assert bool((dt <= 2 * ulp).all())
    assert same >= DRAW_SAME * n
