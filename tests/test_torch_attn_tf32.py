"""The tensor-core arithmetic of the port's attention kernels
(``kernels/csrc/flash_attention.cu``), emulated on the CPU.

The kernels take every product on the card as TF32 ``mma.sync`` products
of split operands: ``x = hi + lo`` with ``hi = rna(x)`` and ``lo =
rna(x - hi)`` (``cvt.rna.tf32.f32``: 10 mantissa bits, round to
nearest, ties away), and ``a·b`` as ``a_hi·b_hi + a_lo·b_hi +
a_hi·b_lo``; a bf16 operand is exact in TF32, so its ``lo`` products
are skipped.  The tensor cores' accumulation is modelled as rounding
toward zero; each of the three products is summed over a reduction step
from zero in an accumulator of its own, and the step's sum is added to
the result in float32 (round to nearest), as the kernels do: one k8
slice a step for Q Kᵀ, K Qᵀ and V dOᵀ, 32 keys or queries a step for
P V, Pᵀ dO, dSᵀ Q and dS K.  The emulation follows the kernels'
steps: the online softmax over 32 keys a step in the forward; k-tiles
of 64 walking q-tiles of 64 in halves of 32 in the backward, dQ summed
over k-tiles in order.  These tests check:

  (a) at the main paths' shapes (S = 64; D = 32 and 64; G = 2 and 4)
      and the JAX kernel sweep's (S = 512, D = 128, windows 0 and 64),
      the output and dq, dk, dv stay within 2e-5 (the card tests'
      float32 tolerance, of the largest magnitude) of float64
      attention, while a single TF32 product a term does not;
  (b) bf16 operands split with ``lo == 0``;
  (c) the plain version ``ref.flash_attention`` (what the kernels are
      held to on the card) and the emulation agree with the JAX Pallas
      kernel in interpret mode, so the emulation is anchored to JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

torch.set_num_threads(1)

TOL = 2e-5          # chip_smoke.py's and the card tests' float32 tolerance
TILE = 64
NEG_INF = np.float32(-1e30)


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on float32 values: keep 10 mantissa bits,
    round half away from zero (on the sign-magnitude bits)."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def round_to_zero(s):
    """float64 → float32, rounded toward zero."""
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc(a, b, step, products=3):
    """a @ b, (M, K) × (K, N) float32, as the kernels take it: K in steps
    of ``step`` (a multiple of 8), each of the TF32 products (``products``
    = 3: hi·hi, lo·hi, hi·lo; 1: hi·hi alone) summed over the step's k8
    slices from zero in a truncating accumulator of its own; the step's
    sum, hh + (lh + hl), is added to the result in float32.  An operand
    exact in TF32 has lo = 0, so its products add nothing, as the kernels
    skip them."""
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = [(ah, bh), (al, bh), (ah, bl)][:products]
    K = a.shape[1]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for s0 in range(0, K, step):
        parts = []
        for x, y in pairs:
            part = np.zeros_like(out)
            for k0 in range(s0, min(s0 + step, K), 8):
                blk = x[:, k0:k0 + 8].astype(np.float64) \
                    @ y[k0:k0 + 8].astype(np.float64)
                part = round_to_zero(part.astype(np.float64) + blk)
            parts.append(part)
        small = sum(parts[1:], np.zeros_like(out)).astype(np.float32)
        out = (out + (parts[0] + small).astype(np.float32)).astype(np.float32)
    return out


def mask(S, Sk, causal, window):
    q = np.arange(S)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((S, Sk), bool)
    if causal:
        ok &= k <= q
    if window:
        ok &= q - k < window
    return ok


def emu_forward(q, k, v, causal, window, products=3):
    """One head: q (S, D), k/v (Sk, D) float32 → (out, lse) as the
    forward kernel computes them."""
    S, D = q.shape
    Sk = k.shape[0]
    scale = np.float32(D ** -0.5)
    ok = mask(S, Sk, causal, window)
    m = np.full(S, NEG_INF, np.float32)
    l = np.zeros(S, np.float32)
    o = np.zeros((S, D), np.float32)
    for k0 in range(0, Sk, 32):                   # 32 keys a step
        kk = slice(k0, min(k0 + 32, Sk))
        s = tc(q, k[kk].T, 8, products) * scale
        s = np.where(ok[:, kk], s, -np.inf).astype(np.float32)
        mn = np.maximum(m, s.max(axis=1))
        alpha = np.exp(m - mn).astype(np.float32)
        p = np.exp(s - mn[:, None]).astype(np.float32)
        l = (l * alpha + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        o = (o * alpha[:, None]).astype(np.float32)
        o = (o + tc(p, v[kk], 32, products)).astype(np.float32)
        m = mn
    out = o / np.maximum(l, np.float32(1e-30))[:, None]
    lse = np.where(l > 0, m + np.log(l), -np.inf).astype(np.float32)
    return out.astype(np.float32), lse


def emu_backward(q, k, v, out, lse, do, causal, window, products=3):
    """One kv-head with G q-heads: q/out/do (G, S, D), k/v (Sk, D) →
    (dq, dk, dv) as the backward kernel computes them."""
    G, S, D = q.shape
    Sk = k.shape[0]
    scale = np.float32(D ** -0.5)
    ok = mask(S, Sk, causal, window)
    delta = (do * out).sum(axis=-1, dtype=np.float32)
    dq = np.zeros((G, S, D), np.float32)
    dk = np.zeros((Sk, D), np.float32)
    dv = np.zeros((Sk, D), np.float32)
    for k0 in range(0, Sk, TILE):
        kk = slice(k0, min(k0 + TILE, Sk))
        kt, vt = k[kk], v[kk]
        dkt = np.zeros_like(kt)
        dvt = np.zeros_like(vt)
        for g in range(G):
            for q0 in range(0, S, TILE):
                qq = slice(q0, min(q0 + TILE, S))
                ds = np.zeros((qq.stop - q0, kt.shape[0]), np.float32)
                for h0 in range(0, qq.stop - q0, 32):   # halves of 32
                    hh = slice(q0 + h0, min(q0 + h0 + 32, S))
                    st = tc(kt, q[g, hh].T, 8, products)
                    pt = np.exp(st * scale - lse[g, hh][None, :])
                    pt = np.where(ok[hh, kk].T, pt, 0).astype(np.float32)
                    dpt = tc(vt, do[g, hh].T, 8, products)
                    dst = (pt * (dpt - delta[g, hh][None, :])).astype(
                        np.float32)
                    dvt = (dvt + tc(pt, do[g, hh], 32, products)).astype(
                        np.float32)
                    dkt = (dkt + tc(dst, q[g, hh], 32, products)).astype(
                        np.float32)
                    ds[h0:h0 + hh.stop - hh.start] = dst.T
                part = np.zeros((qq.stop - q0, D), np.float32)
                for c0 in range(0, kt.shape[0], 32):    # dQ = dS K
                    part = (part + tc(ds[:, c0:c0 + 32], kt[c0:c0 + 32], 32,
                                      products)).astype(np.float32)
                dq[g, qq] = (dq[g, qq] + part).astype(np.float32)
        dk[kk] = dkt * scale
        dv[kk] = dvt
    return (dq * scale).astype(np.float32), dk, dv


def exact(q, k, v, do, causal, window):
    """float64 attention of one kv-head's G heads and its gradients."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    G, S, D = q.shape
    scale = D ** -0.5
    ok = mask(S, k.shape[0], causal, window)
    s = np.where(ok, q @ k.T * scale, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    out = p @ v
    dp = do @ v.T
    ds = p * (dp - (dp * p).sum(axis=-1, keepdims=True))
    dq = ds @ k * scale
    dk = np.einsum("gqk,gqd->kd", ds, q) * scale
    dv = np.einsum("gqk,gqd->kd", p, do)
    return out, dq, dk, dv


def rel_err(got, want):
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


# (S, D, G, window): the main paths' (tiny-llm, llama3.2-1b widths) and
# the JAX kernel sweep's head dim and length; causal throughout
SHAPES = [(64, 32, 2, 0), (64, 64, 4, 0), (512, 128, 1, 0),
          (512, 128, 1, 64)]


def inputs(S, D, G, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((G, S, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((S, D)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def emulate(q, k, v, do, window, products=3):
    fw = [emu_forward(q[g], k, v, True, window, products)
          for g in range(q.shape[0])]
    out = np.stack([f[0] for f in fw])
    lse = np.stack([f[1] for f in fw])
    return (out,) + emu_backward(q, k, v, out, lse, do, True, window,
                                 products)


@pytest.mark.parametrize("S,D,G,window", SHAPES)
def test_split_products_meet_the_tolerance(S, D, G, window):
    q, k, v, do = inputs(S, D, G, S + D + G + window)
    want = exact(q, k, v, do, True, window)
    got = emulate(q, k, v, do, window)
    for name, u, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert rel_err(u, w) <= TOL, name


@pytest.mark.parametrize("S,D,G,window", SHAPES[:2])
def test_a_single_tf32_product_does_not(S, D, G, window):
    q, k, v, do = inputs(S, D, G, S + D + G + window)
    want = exact(q, k, v, do, True, window)
    got = emulate(q, k, v, do, window, products=1)
    for name, u, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert rel_err(u, w) > TOL, name


def test_bf16_operands_split_with_zero_lo():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(50_000)
         * 10.0 ** rng.uniform(-6, 6, 50_000)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    hi, lo = split(xb)
    np.testing.assert_array_equal(hi, xb)
    assert not np.any(lo)
    assert np.count_nonzero(split(x)[1]) > 0.9 * x.size


@pytest.mark.parametrize("S,D,G,window", SHAPES)
def test_plain_version_and_emulation_match_the_jax_kernel(S, D, G, window):
    """The JAX Pallas kernel in interpret mode (its own tests' mode) takes
    K/V expanded to every head, (B, H, S, D); the port's plain version
    the model's (B, S, H, D) with grouped kv-heads."""
    q, k, v, do = inputs(S, D, G, 7 * S + D + G + window)
    kx, vx = (np.broadcast_to(x, (G, S, D)) for x in (k, v))
    jax_out = np.asarray(jops.flash_attention(
        jnp.asarray(q[None]), jnp.asarray(kx[None]), jnp.asarray(vx[None]),
        causal=True, window=window))[0]
    plain = ref.flash_attention(
        torch.from_numpy(q).permute(1, 0, 2)[None],
        torch.from_numpy(k)[None, :, None], torch.from_numpy(v)[None, :, None],
        causal=True, window=window)[0].permute(1, 0, 2).numpy()
    np.testing.assert_allclose(plain, jax_out, rtol=TOL, atol=TOL)
    emu = emulate(q, k, v, do, window)[0]
    np.testing.assert_allclose(emu, jax_out, rtol=TOL, atol=TOL)
