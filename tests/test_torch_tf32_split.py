"""The numeric scheme of the port's tensor-core projections
(``kernels/csrc/tf32x3.cuh``), emulated on the CPU.

``lora_matmul`` and ``int4_matmul`` take each float32 product on the
card as a sum of TF32 products: ``x = hi + lo`` with ``hi = rna(x)`` and
``lo = rna(x - hi)``, where ``rna`` is ``cvt.rna.tf32.f32`` (10 mantissa
bits, round to nearest, ties away from zero), and ``a·b`` as
``a_hi·b_hi + a_lo·b_hi + a_hi·b_lo``, summed in float32.  These tests
emulate that with integer operations on float32 bits and check:

  (a) at the paths' reduction lengths the three-product sum stays within
      the card tests' 2e-5 of the largest magnitude of a float64 product,
      while a single TF32 product does not, with the tensor cores'
      accumulation modelled as rounding toward zero and each reduction
      step's partial sum added in float32 as the kernels do; one
      accumulator over a long reduction misses the tolerance in that
      model, as the card showed at N = 16384;
  (b) every bf16-rounded dequantized int4 weight, ``(nibble - 8)·scale``,
      is exact in TF32 (``lo == 0``), so the QLoRA path's two products
      lose nothing, while float32-rounded weights are not.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = 2e-5          # chip_smoke.py's and the card tests' float32 tolerance


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


def tc_sum(pairs, promote=4, block=8):
    """Σ_k Σ_pairs a[:, k]·b[k, :] as the kernels take it on the tensor
    cores.  Products of TF32 values are exact; each k8 block's sum is
    added to a float32 wgmma accumulator that rounds toward zero (a model
    of the tensor cores' accumulation, which does not round to nearest);
    every ``promote`` blocks (one reduction step of 32) that partial sum
    is added to the result in float32, rounding to nearest (the kernels'
    FADD), and starts again from zero.  ``promote=None``: one accumulator
    over the whole reduction."""
    a0, b0 = pairs[0]
    K = a0.shape[1]
    total = np.zeros((a0.shape[0], b0.shape[1]), dtype=np.float32)
    part = total.copy()
    for i, k0 in enumerate(range(0, K, block)):
        for a, b in pairs:
            blk = a[:, k0:k0 + block].astype(np.float64) @ \
                b[k0:k0 + block].astype(np.float64)
            part = round_to_zero(part.astype(np.float64) + blk)
        if promote and (i + 1) % promote == 0:
            total = (total + part).astype(np.float32)
            part[:] = 0
    return (total + part).astype(np.float32) if promote else part


def rel_err(got, want):
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


def test_rna_rounds_half_away_and_keeps_ten_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                  1 + 3 * 2 ** -11, 1.0, 0.0], dtype=np.float32)
    want = np.array([one + ulp, one, -(one + ulp), one + 2 * ulp, one, 0.0],
                    dtype=np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    r = tf32_rna(np.random.default_rng(0).standard_normal(10_000))
    assert not np.any(r.view(np.uint32) & np.uint32(0x1FFF))


def test_split_recovers_the_value_to_2_pow_minus_22():
    x = (np.random.default_rng(1).standard_normal(100_000)
         * 10.0 ** np.random.default_rng(2).uniform(-6, 6, 100_000)
         ).astype(np.float32)
    hi, lo = split(x)
    assert np.all(hi.astype(np.float64) + (x - hi) == x)    # x - hi exact
    resid = np.abs(x.astype(np.float64) - hi - lo)
    assert np.all(resid <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


# (K, rows): forward K up to 8192 (w_out), dx reductions up to 16384
# (w_in's N); a few rows each, 8 output columns
@pytest.mark.parametrize("K", [128, 2048, 8192, 16384])
def test_three_products_meet_the_tolerance(K):
    rng = np.random.default_rng(K)
    a = rng.standard_normal((4, K)).astype(np.float32)
    b = (rng.standard_normal((K, 8)) * K ** -0.5).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    (ah, al), (bh, bl) = split(a), split(b)
    three = tc_sum([(ah, bh), (al, bh), (ah, bl)])
    one = tc_sum([(ah, bh)])
    assert rel_err(three, want) <= TOL / 4
    assert rel_err(one, want) > TOL


@pytest.mark.parametrize("K", [8192, 16384])
def test_one_accumulator_over_a_long_reduction_misses(K):
    """Why the kernels add each step's partial sum with FADD: without it
    the truncating accumulator's error grows with the reduction."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((4, K)).astype(np.float32)
    b = (rng.standard_normal((K, 8)) * K ** -0.5).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    (ah, al), (bh, bl) = split(a), split(b)
    pairs = [(ah, bh), (al, bh), (ah, bl)]
    assert rel_err(tc_sum(pairs, promote=None), want) > TOL
    assert rel_err(tc_sum(pairs), want) <= TOL / 4


@pytest.mark.parametrize("K", [128, 2048, 16384])
def test_two_products_suffice_for_an_exact_weight(K):
    """A TF32-exact B (the bf16-rounded weight): a_hi·b + a_lo·b."""
    rng = np.random.default_rng(K + 1)
    a = rng.standard_normal((4, K)).astype(np.float32)
    b = torch.from_numpy(rng.standard_normal((K, 8)) * K ** -0.5).to(
        torch.bfloat16).float().numpy()
    want = a.astype(np.float64) @ b.astype(np.float64)
    ah, al = split(a)
    assert rel_err(tc_sum([(ah, b), (al, b)]), want) <= TOL / 4
    assert rel_err(tc_sum([(ah, b)]), want) > TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_dequantized_weights_are_exact_in_tf32(seed):
    rng = np.random.default_rng(seed)
    scales = (np.abs(rng.standard_normal(20_000))
              * 10.0 ** rng.uniform(-6, 2, 20_000)).astype(np.float32)
    nib = np.arange(16, dtype=np.float32)[:, None] - 8
    w32 = (nib * scales[None, :]).astype(np.float32)   # one f32 multiply
    wbf = torch.from_numpy(w32).to(torch.bfloat16).float().numpy()
    hi, lo = split(wbf)
    np.testing.assert_array_equal(hi, wbf)
    assert not np.any(lo)
    # float32-rounded weights are not: they take the third product
    assert np.count_nonzero(split(w32)[1]) > 0.9 * np.count_nonzero(w32)
