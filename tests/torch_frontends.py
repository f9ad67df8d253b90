"""Shared by the port's tests of the encoder-decoder (``whisper-large-v3``)
and vision (``qwen2-vl-72b``) families: the stub frontend's embeddings
and prompts drawn from a seed with numpy, handed to both packages in
the model's dtype (bit for bit), and a decode cache seeded from a
prefill's on each side.

Tolerances: ``tests/test_torch_decode.py``'s.  Float32 base: logits
within 1e-4 of the largest, caches within 1e-4 of their largest
magnitude.  bfloat16 base: logits within 3e-2, caches within 2e-2.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model as JM
from repro_torch import convert
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map
from torch_families import as_f32, np_tree

B, STEPS = 2, 12
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CACHE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def rel(got, want) -> float:
    return float(np.abs(as_f32(got) - as_f32(want)).max()
                 / max(1e-30, np.abs(as_f32(want)).max()))


def draw_inputs(cfg, S: int, dtype: str, seed: int = 0, frames: int = None):
    """Prompts ``(B, S)`` and frontend embeddings ``(B, F, d)`` (``F`` the
    config's unless given), the latter rounded to ``dtype``: as JAX
    arrays and as the port's tensors, bit for bit the same."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab_size - 4, (B, S)).astype(np.int32)
    F = frames or cfg.n_frontend_tokens
    fe = jnp.asarray(rng.standard_normal((B, F, cfg.d_model)),
                     jnp.dtype(dtype))
    return ({"tokens": jnp.asarray(toks), "frontend": fe},
            {"tokens": torch.from_numpy(toks).long(),
             "frontend": convert.from_jax(np.asarray(fe))})


def jax_prefill(m, jbatch):
    return jax.jit(JM.make_prefill_step(m["jcfg"]))(m["jp"], m["ja"], jbatch)


def jax_seeded(cfg, prefill_cache, rows: int, steps: int, dtype):
    """JAX's decode cache of ``rows + steps`` slots holding its prefill's
    ``rows`` self-attention rows and, for an encoder-decoder, its cross
    pair, in ``dtype``."""
    cache = JM.init_cache(cfg, B, rows + steps, dtype=dtype)
    if not cfg.encoder_decoder:
        return tuple(tuple(c.at[:, :, :rows].set(p.astype(dtype))
                           for c, p in zip(cl, pl))
                     for cl, pl in zip(cache, prefill_cache))
    self_c = tuple(tuple(c.at[:, :, :rows].set(p.astype(dtype))
                         for c, p in zip(cl, pl[0]))
                   for cl, pl in zip(cache[0], prefill_cache))
    cross = tuple(tuple(p.astype(dtype) for p in pl[1])
                  for pl in prefill_cache)
    return self_c, cross


def port_seeded(cfg, prefill_cache, rows: int, steps: int, dtype):
    """The port's counterpart of ``jax_seeded``."""
    cache = M.init_cache(cfg, B, rows + steps, dtype=dtype, device="cpu")
    self_c = cache[0] if cfg.encoder_decoder else cache
    for i, pl in enumerate(prefill_cache):
        for c, p in zip(self_c[i],
                        pl[0] if cfg.encoder_decoder else pl):
            c[:, :rows] = p
        if cfg.encoder_decoder:
            for c, p in zip(cache[1][i], pl[1]):
                c.copy_(p)
    return cache


def steps_both(m, jcache, tcache, toks: np.ndarray, start: int):
    """The serve step of both packages fed ``toks`` ``(B, n)`` from
    position ``start``: each step's (port logits, JAX logits, a copy of
    the port's cache, which the step writes in place, JAX's cache in the
    port's layout)."""
    cfg = m["jcfg"]
    jserve = jax.jit(JM.make_serve_step(cfg))
    tserve = M.make_serve_step(m["tcfg"])
    out = []
    for s in range(toks.shape[1]):
        jl, jcache = jserve(m["jp"], m["ja"], jcache,
                            jnp.asarray(toks[:, s:s + 1]),
                            jnp.asarray(start + s))
        tl, tcache = tserve(m["tp"], m["ta"], tcache,
                            torch.from_numpy(toks[:, s:s + 1]).long(),
                            start + s)
        jc = convert.cache_from_jax(np_tree(jcache), pair=cfg.encoder_decoder)
        out.append((tl, jl, tree_map(torch.clone, tcache), jc))
    return out


def check_tree(got, want, tol: float, what: str):
    """Every leaf of ``got`` of ``want``'s shape and dtype and within
    ``tol`` of its largest magnitude."""
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        assert rel(g, w) <= tol, f"{what} leaf {i}: {rel(g, w):.3g} > {tol}"
