"""The weight draw on the card: the ``trunc_normal`` kernel is bitwise
its plain version (``trunc_normal.plain``, ``random.truncated_normal``
times the scale in the weight's dtype), which the CPU tests hold to
``jax.random.truncated_normal``.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_draw.py

Without a card every case skips: the kernel has no CPU mode.
"""
import math

import pytest
import torch

from repro_torch import random as jr
from repro_torch.kernels import trunc_normal as tn
from repro_torch.models import common

pytestmark = pytest.mark.cuda

_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start", [0, 12345, (1 << 32) - 70000])
def test_draw_is_bitwise_its_plain_version(cuda, dtype, start):
    key = jr.split(jr.PRNGKey(3), 8)[3]
    n, std = 1 << 18, 1.0 / math.sqrt(2048)
    before = tn.trunc_normal.launches
    got = tn.trunc_normal(key, n, std, dtype, cuda, start=start)
    assert tn.trunc_normal.launches == before + 1
    want = tn.plain(key, n, std, dtype, cuda, start=start)
    assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))
    cpu = tn.plain(key, 4096, std, dtype, "cpu", start=start)
    assert torch.equal(got[:4096].cpu().view(_BITS[dtype]),
                       cpu.view(_BITS[dtype]))


def test_init_dense_draws_a_leaf_in_one_launch(cuda, monkeypatch):
    """A leaf over ``DRAW_SLICE`` values: one launch on the card, bitwise
    the CPU's slice-by-slice draw."""
    monkeypatch.setattr(jr, "DRAW_SLICE", 1000)
    key = jr.split(jr.PRNGKey(0))[1]
    before = tn.trunc_normal.launches
    got = common.init_dense(key, (96, 64), torch.bfloat16, device=cuda)
    assert tn.trunc_normal.launches == before + 1
    want = common.init_dense(key, (96, 64), torch.bfloat16, device="cpu")
    assert got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
