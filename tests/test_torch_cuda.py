"""The hand-written CUDA kernels against their plain versions, on the
card.  This file imports no JAX, so it runs on a machine with a card
and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every case skips: the kernels have no CPU mode.
Tolerance for ``statevector_gate``: 1e-6 max abs on amplitudes in
[-1, 1) — the same float32 formula, only FMA contraction differs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import statevector_gates as svg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 2, 4, 6, 10])
def test_statevector_gate_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    for B in (1, 7, 4750):
        planes = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
                  .to(cuda) for s in ((B, 1 << n),) * 2 + ((B, 2, 2),) * 2]
        for t in range(n):
            for c in [-1] + [c for c in range(n) if c != t]:
                before = svg.statevector_gate.launches
                got = ops.statevector_gate(*planes, t, c, n)
                assert svg.statevector_gate.launches == before + 1
                want = ref.statevector_gate(*planes, t, c, n)
                for g, w in zip(got, want):
                    assert float((g - w).abs().max()) <= 1e-6


def test_statevector_gate_rejects_bad_gates(cuda):
    planes = [torch.zeros(s, device=cuda)
              for s in ((3, 4),) * 2 + ((3, 2, 2),) * 2]
    with pytest.raises(ValueError):
        svg.statevector_gate(*planes, 1, 1, 2)        # control == target
    with pytest.raises(ValueError):
        svg.statevector_gate(*planes, 0, -1, 3)       # wrong plane width
