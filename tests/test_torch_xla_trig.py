"""XLA's float32 ``sin`` and ``cos`` on the CPU, emulated in torch
(``repro_torch.xla_trig``), against ``jnp.sin`` / ``jnp.cos`` bit for bit:

- 10**6 angles spanning the tape's range (features times 2, the ZZ
  map's 2(π - x_i)(π - x_j) up to 2π², parameters; [-64, 64) holds them
  all with room), 2·10**5 beyond 120 (glibc's large reduction), and the
  edge values (zeros, the 2**-12 and 120 thresholds, infinities, NaN);
- the 5160 values of ``tools/xla_transcendentals.py``: the round-0 gate
  angles of the Nelder-Mead ``qfl-nm`` configuration and their halves;
- ``exp(1j·θ)`` and ``exp(-0.5j·θ)`` of complex64, as the tapes' P and
  RZ matrices take them, and every gate matrix of ``ref.gate_planes``
  against the JAX tape's ``_MAT_FNS``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.orchestrator import Orchestrator as JaxOrchestrator
from repro.core.orchestrator import RunConfig as JaxRunConfig
from repro.data.tasks import build_task as jax_build_task
from repro.quantum import tape as jtape
from repro_torch import xla_trig
from repro_torch.kernels import ref

_SIN, _COS = jax.jit(jnp.sin), jax.jit(jnp.cos)


def _assert_bitwise(x: np.ndarray):
    s, c = xla_trig.sincos(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(_SIN(x)))
    np.testing.assert_array_equal(c.numpy(), np.asarray(_COS(x)))


@pytest.mark.parametrize("lo,hi,n", [(-64.0, 64.0, 10 ** 6),
                                     (-1e5, 1e5, 2 * 10 ** 5)])
def test_sincos_bitwise_on_a_range(lo, hi, n):
    torch.set_num_threads(1)
    x = np.random.default_rng(7).uniform(lo, hi, n).astype(np.float32)
    _assert_bitwise(x)


def test_the_cards_fully_fused_path_on_the_cpu():
    """``plain_sincos``, the one path the card's kernel is held to (its
    polynomial fused on every value), on the CPU across the 120
    threshold between the two reductions."""
    x = np.random.default_rng(9).uniform(-200, 200, 10 ** 5).astype(
        np.float32)
    s, c = xla_trig.plain_sincos(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(_SIN(x)))
    np.testing.assert_array_equal(c.numpy(), np.asarray(_COS(x)))


def test_sincos_edges():
    f = np.float32
    x = np.array([0.0, -0.0, 1e-30, -1e-30, 2 ** -12, -(2 ** -12),
                  np.nextafter(f(2 ** -12), f(0)), 0.75,
                  np.nextafter(f(0.75), f(0)), 120.0, -120.0,
                  np.nextafter(f(120), f(0)), np.pi / 4, np.pi / 2, np.pi,
                  3e38, -3e38, np.inf, -np.inf, np.nan], np.float32)
    _assert_bitwise(x)


def test_sincos_bitwise_on_the_gap_angles():
    """The 5160 values ``tools/xla_transcendentals.py`` counts: at round
    0 of ``qfl-nm`` (seed 3), torch's ``sin`` differed from XLA's on 128
    of them and ``cos`` on 50."""
    task = jax_build_task("genomic", n_clients=3, train_size=90,
                          test_size=45, val_size=30, seed=5)
    jo = JaxOrchestrator(task, JaxRunConfig(
        method="qfl", optimizer="nelder-mead", maxiter0=3,
        early_stop=False, seed=3, n_rounds=1, engine="batched",
        rounds="host"))
    jo.run()
    qX = np.asarray(jo._engine._qX)
    theta = np.random.default_rng(0).standard_normal(
        (qX.shape[0], jo.spec.n_params)).astype(np.float32)
    cq = jtape.compile_qnn(jo.spec)
    a = np.asarray(jtape.tape_angles(cq.tape, jnp.asarray(qX[0]),
                                     jnp.asarray(theta[0]))).ravel()
    x = np.concatenate([a, a / 2]).astype(np.float32)
    assert x.size == 5160
    t = torch.from_numpy(x)
    assert int((torch.sin(t).numpy() != np.asarray(_SIN(x))).sum()) > 0
    _assert_bitwise(x)


def test_expi_matches_complex_exp():
    x = np.random.default_rng(3).uniform(-64, 64, 10 ** 5).astype(np.float32)
    t = torch.from_numpy(x)
    for k, arg in ((1.0, t), (-0.5, t * -0.5)):
        want = np.asarray(jax.jit(
            lambda v: jnp.exp(k * 1j * v.astype(jnp.complex64)))(x))
        got = xla_trig.expi(arg).numpy()
        np.testing.assert_array_equal(got.real, want.real)
        np.testing.assert_array_equal(got.imag, want.imag)


def test_gate_planes_match_the_jax_tape_matrices():
    rng = np.random.default_rng(11)
    B = 257
    gid = np.arange(5, dtype=np.int32).repeat(3)
    ang = rng.uniform(-20, 20, (B, gid.size)).astype(np.float32)
    g_re, g_im = ref.gate_planes(torch.from_numpy(gid), torch.from_numpy(ang))
    for i, g in enumerate(gid):
        want = np.asarray(jax.jit(
            lambda a, g=int(g): jax.lax.switch(g, jtape._MAT_FNS, a))(
                jnp.asarray(ang[:, i])))
        np.testing.assert_array_equal(g_re[i].numpy(), want.real)
        np.testing.assert_array_equal(g_im[i].numpy(), want.imag)
