"""The weight draw's wrapper on the CPU (``kernels.trunc_normal``): the
kernel draws on a card only, and the CPU's ``init_dense`` keeps the
plain version it is held to.  The kernel itself is held to the plain
version on the card by ``tests/test_torch_cuda_draw.py``."""
import math

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.kernels import trunc_normal as tn
from repro_torch.models import common


def test_the_kernel_draws_on_a_card_only():
    key = jr.PRNGKey(0)
    with pytest.raises(ValueError, match="CUDA"):
        tn.trunc_normal(key, 8, 0.1, torch.float32, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_dense_on_the_cpu_is_the_plain_version(dtype):
    key = jr.split(jr.PRNGKey(1))[1]
    before = tn.trunc_normal.launches
    got = common.init_dense(key, (48, 32), dtype, device="cpu")
    assert tn.trunc_normal.launches == before
    want = tn.plain(key, 48 * 32, 1.0 / math.sqrt(48), dtype, "cpu")
    assert torch.equal(got.reshape(-1), want)


def test_bounds_are_the_plain_draws():
    """The kernel's uniform range and clamps are those the plain
    ``truncated_normal`` draws with: its values lie in the clamps, and
    reach within an ulp of them."""
    a, span, lo, hi = tn.bounds(-2.0, 2.0)
    assert np.float32(a) == np.float32(math.erf(-2 / math.sqrt(2)))
    assert np.float32(a + span) == np.float32(math.erf(2 / math.sqrt(2)))
    v = jr.truncated_normal(jr.PRNGKey(2), -2.0, 2.0, (1 << 16,))
    assert lo <= float(v.min()) and float(v.max()) <= hi
    assert lo == float(np.nextafter(np.float32(-2), np.float32(0)))
    assert hi == float(np.nextafter(np.float32(2), np.float32(0)))
