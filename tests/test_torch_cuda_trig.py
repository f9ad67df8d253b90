"""The tape kernel's gate angles on the card: their sines and cosines
are XLA's float32 ones on the CPU (``repro_torch.xla_trig``, in double),
as the JAX package takes them.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_trig.py

Without a card every case skips: the kernel has no CPU mode.

- The ``xla_sincos`` kernel (``xla_trig.sincos`` on a CUDA tensor, one
  launch) is bitwise its plain version (``xla_trig.plain_sincos``) on
  the card and on the CPU.
- The tape kernel is bitwise its plain version on angles where the
  card's ``sinf`` / ``cosf`` and XLA's differ.
"""
import pytest
import torch

from repro_torch import xla_trig
from repro_torch.kernels import ref
from repro_torch.kernels import statevector_tape as svt
from repro_torch.kernels import xla_sincos as xs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_sincos_kernel_is_bitwise_its_plain_version(cuda):
    x = (torch.rand(1 << 20, generator=torch.Generator().manual_seed(5))
         * 80 - 40)
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1e-30, 119.99, 120.0, -3e5,
                                    float("inf"), float("nan")])])
    before = xs.xla_sincos.launches
    got = xla_trig.sincos(x.to(cuda))
    assert xs.xla_sincos.launches == before + 1
    plain_dev = xla_trig.plain_sincos(x.to(cuda))
    plain_cpu = xla_trig.sincos(x)
    for g, d, c in zip(got, plain_dev, plain_cpu):
        for t in (g.cpu(), d.cpu()):
            assert torch.equal(t.isnan(), c.isnan())
            assert torch.equal(t.nan_to_num(), c.nan_to_num())
    s, c = xla_trig.sincos(x[:7].reshape(7, 1).to(cuda))
    assert s.shape == (7, 1) and c.shape == (7, 1)


def test_tape_kernel_is_bitwise_its_plain_version_where_sinf_differs(cuda):
    g = torch.Generator(device="cuda").manual_seed(6)
    cand = (torch.rand(1 << 20, generator=g, device="cuda") * 40 - 20)
    s, c = xla_trig.plain_sincos(cand)
    differ = (torch.sin(cand) != s) | (torch.cos(cand) != c)
    differ |= (torch.sin(cand / 2) != xla_trig.plain_sincos(cand / 2)[0])
    angles = cand[differ]
    assert angles.numel() > 100
    n, B = 4, 64
    # P, RY, RZ on every qubit, then controlled ones: each gate one angle
    gid = torch.tensor([1, 2, 3] * (2 * n), dtype=torch.int32, device=cuda)
    G = gid.numel()
    target = torch.tensor([q % n for q in range(G)], dtype=torch.int32,
                          device=cuda)
    control = torch.tensor([-1] * (G // 2) + [(q + 1) % n
                                              for q in range(G - G // 2)],
                           dtype=torch.int32, device=cuda)
    reps = -(-B * G // angles.numel())
    ang = angles.repeat(reps)[:B * G].reshape(B, G).contiguous()
    got = svt.statevector_tape(ang, gid, target, control, n)
    want = ref.statevector_tape(ang, gid, target, control, n)
    for gp, wp in zip(got, want):
        assert torch.equal(gp, wp)
