"""Shared by the port's tests of the mixture-of-experts and latent-attention
families: the JAX package's weights carried across, and the routing
margins that tell a bfloat16 routing flip from a fault.

A flip.  The router takes the normed tokens in float32, but in a
bfloat16 model those tokens are rounded, and the port rounds its
projections at other points than JAX (``lora_matmul`` once, JAX's
``dense`` five times), so a token whose k-th and (k+1)-th expert
probabilities lie within rounding of each other may take another
expert in each package.  Its output then differs by a whole expert's.
The checks below hold every row to the bound of
``tests/test_torch_decode.py``; a row over it must have routed some
token within ``FLIP_MARGIN`` of a tie in that call, and is reported
with that margin, as ``DrawMargin`` reports a near draw.  No bound is
widened: a row with no near tie is held as strictly as any other.
``FLIP_MARGIN`` is about five times the largest shift of a probability
that one bfloat16 rounding of the normed tokens gives at ``-smoke``
width (a flip was seen at a margin of 2.6e-3).
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get as jget
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.registry import get as tget
from repro_torch.models import ffn

FLIP_MARGIN = 1e-2
KEY = jax.random.PRNGKey(0)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def as_f32(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def smoke_model(name: str, dtype: str, key=KEY):
    """The JAX package's ``-smoke`` base and adapters (``lora_b`` + 0.01)
    of ``name`` in ``dtype``, and the port's copies."""
    jcfg, tcfg = jget(name + "-smoke"), tget(name + "-smoke")
    jp = JM.init_params(jcfg, key, dtype=jnp.dtype(dtype))
    ja = jax.tree.map(lambda x: x + 0.01, JM.init_adapters(jcfg, key, jp))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, ja=ja,
                tp=convert.params_from_jax(np_tree(jp)),
                ta=convert.adapters_from_jax(np_tree(ja)))


def token_margins(r: "ffn.Routing", k: int) -> torch.Tensor:
    """Each token's smallest gap between neighbouring probabilities among
    its k first choices and the next: how near its routing is to a
    tie."""
    top = torch.sort(r.probs, dim=-1, descending=True).values[:, :k + 1]
    return (top[:, :-1] - top[:, 1:]).min(dim=-1).values


@contextlib.contextmanager
def routed():
    """Every ``ffn.route`` call inside, recorded: yields a list that
    receives each call's ``Routing``."""
    calls, orig = [], ffn.route

    def spy(logits, m):
        r = orig(logits, m)
        calls.append(r)
        return r
    ffn.route = spy
    try:
        yield calls
    finally:
        ffn.route = orig


def row_margins(calls, rows: int, k: int) -> np.ndarray:
    """The smallest token margin of each of ``rows`` rows over the
    recorded routings of one call of the model (each routing's tokens
    are row-major, ``rows`` rows of equal length)."""
    out = np.full(rows, np.inf)
    for r in calls:
        m = token_margins(r, k).reshape(rows, -1).min(dim=-1).values
        out = np.minimum(out, m.numpy())
    return out


def check_rows(got, want, bound: float, margins, what: str) -> list:
    """Each row of ``got`` within ``bound`` of the largest magnitude of
    ``want``, except rows whose routing came within ``FLIP_MARGIN`` of a
    tie (``margins``, one a row; None: no MoE).  Returns the excused
    rows as ``(row, error, margin)`` and prints them."""
    got, want = as_f32(got), as_f32(want)
    err = np.abs(got - want).reshape(got.shape[0], -1).max(-1) \
        / np.abs(want).max()
    flips = []
    for row, e in enumerate(err):
        if e <= bound:
            continue
        m = np.inf if margins is None else float(margins[row])
        assert m < FLIP_MARGIN, (
            f"{what}, row {row}: {e:.3g} of the largest, over {bound}, "
            f"with no routing near a tie (smallest margin {m:.3g})")
        flips.append((row, float(e), m))
        print(f"{what}: row {row} {e:.3g} of the largest, a routing "
              f"flip at a probability margin of {m:.3g}")
    return flips


# The draw's contract.  ``random.truncated_normal`` emulates XLA's float32
# ``erf_inv``, whose ``log`` it matches bitwise on all but about 0.04 % of
# inputs (1 ulp there), so ``erf_inv`` is within 2 ulp of JAX's; times
# sqrt(2), rounded, a unit draw can land 3 ulp away (one value of
# in_proj's 262144 at this key).  Every value is held to that, and at
# least 99.9 % of all values bitwise.
DRAW_ULPS, DRAW_SAME = 3, 0.999


def draw_gaps(got: dict, want: dict) -> tuple:
    """(values, values bitwise equal); every leaf of ``got`` of ``want``'s
    name, dtype and shape, within ``DRAW_ULPS`` ulp of it."""
    assert sorted(got) == sorted(want)
    n = same = 0
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        gf, wf = g.float(), w.float()
        ulp = torch.abs(torch.nextafter(wf, torch.full_like(wf, np.inf)) - wf)
        assert bool(((gf - wf).abs() <= DRAW_ULPS * ulp).all()), k
        n += g.numel()
        same += int((gf == wf).sum())
    return n, same
