"""The port's ``statevector_gate``: plain version against the JAX oracle
and the Pallas kernel (interpret mode).  The CUDA kernel is held to the
plain version on the card by ``test_torch_cuda.py``.

Tolerance 1e-6 (max abs) on amplitudes in [-1, 1): both sides run the
same float32 products; only the order of rounding (FMA contraction,
XLA's complex multiply) may differ, a few ulps at most.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.quantum import tape as jax_tape
from repro_torch.kernels import ops, ref
from repro_torch.kernels import statevector_gates as svg

# small shapes: one intra-op thread per test worker, or the workers
# oversubscribe the cores
torch.set_num_threads(1)

TOL = 1e-6


def _inputs(B, n, seed=0):
    rng = np.random.default_rng(seed + 100 * n + B)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    return u(B, 1 << n), u(B, 1 << n), u(B, 2, 2), u(B, 2, 2)


def _gates(n):
    return [(t, c) for t in range(n) for c in [-1] + [c for c in range(n)
                                                      if c != t]]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_pair_indices_match_jax(n):
    for t, c in _gates(n):
        i0, i1, m = ref.pair_indices(t, c, n)
        j0, j1, jm = jax_tape.pair_indices(t, c, n)
        np.testing.assert_array_equal(i0.numpy(), np.asarray(j0))
        np.testing.assert_array_equal(i1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(m.numpy(),
                                      np.asarray(jm, np.float32))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("B", [1, 5, 64])
def test_plain_matches_jax_oracle_and_pallas(n, B):
    pr, pi, gr, gi = _inputs(B, n)
    tp = [torch.from_numpy(a) for a in (pr, pi, gr, gi)]
    for t, c in _gates(n):
        got = ref.statevector_gate(*tp, t, c, n)
        j0, j1, jm = jax_tape.pair_indices(t, c, n)
        jm = jm.astype(jnp.float32)
        jp = [jnp.asarray(a) for a in (pr, pi, gr, gi)]
        want = jax_ref.statevector_gate(*jp, j0, j1, jm)
        pallas = jax_ops.statevector_gate(*jp, j0, j1, jm)
        for g, w, p in zip(got, want, pallas):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                       rtol=0)
            np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=TOL,
                                       rtol=0)


def test_cpu_dispatch_takes_the_plain_version():
    tp = [torch.from_numpy(a) for a in _inputs(7, 3)]
    before = svg.statevector_gate.launches
    got = ops.statevector_gate(*tp, 1, 0, 3)
    want = ref.statevector_gate(*tp, 1, 0, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert svg.statevector_gate.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: a CPU tensor is an
    error there, before anything is built."""
    tp = [torch.from_numpy(a) for a in _inputs(4, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        svg.statevector_gate(*tp, 0, -1, 2)
