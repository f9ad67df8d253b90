"""Prefill and the serve step on the card against the port's CPU path, at
``-smoke`` width, and ``stablelm-3b``'s full-width head dim of 80 (its
prefill through the kernel).  This
file imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_decode.py

Without a card every case skips.  Tolerances: those of
``tests/test_torch_decode.py`` (the CPU port against JAX), but for the
decode caches of a float32 model: within one bfloat16 ulp of their
largest magnitude (2**-7 of it), with at most 1e-3 of the elements
apart.  Per element, as there, they need not be within one ulp: the
card's projections are float32-accurate relative to a row's largest
terms, so a value that comes out of cancellation can round several
ulps of its own away (5 seen at ``stablelm-3b-smoke``).  Float32 base:
logits within 1e-4 of the largest logit.  bfloat16 base: logits within
3e-2 of the largest logit, caches within 2e-2 of their largest
magnitude.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as M
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

DENSE = ["stablelm-3b", "starcoder2-7b", "llama3-405b", "llama3.2-1b",
         "gpt2", "deepseek-llm-7b-base", "tiny-llm"]
B, P, STEPS = 2, 24, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(cfg, dtype, device):
    """((params, adapters) on the CPU, the same on ``device``): drawn on
    the card and copied, ``lora_b`` + 0.01."""
    key = jr.PRNGKey(0)
    params = M.init_params(cfg, key, dtype=dtype, device=device)
    adapters = M.init_adapters(cfg, key, params)
    adapters = [{k: v + 0.01 if "lora_b" in k else v for k, v in a.items()}
                for a in adapters]
    cpu = lambda t: t.cpu()  # noqa: E731
    return ((tree_map(cpu, params), tree_map(cpu, adapters)),
            (params, adapters))


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _check_logits(got, want, dtype, what):
    bound = 3e-2 if dtype == torch.bfloat16 else 1e-4
    err = _rel(got, want)
    assert err <= bound, f"{what}: {err:.3g} of the largest logit"


def _check_caches(got, want, dtype, what):
    n = odd = 0
    for (gk, gv), (wk, wv) in zip(got, want):
        for g, w in ((gk, wk), (gv, wv)):
            g = g.cpu()
            assert g.dtype == w.dtype and g.shape == w.shape
            if dtype == torch.bfloat16:
                assert _rel(g, w) <= 2e-2, what
                continue
            assert _rel(g, w) <= 2 ** -7, what
            n += g.numel()
            odd += int((g != w).sum())
    assert odd <= 1e-3 * max(n, 1), what


def _decode(cfg, model, tokens, device, pos_tensor=False):
    params, adapters = model
    serve = M.make_serve_step(cfg)
    cache = M.init_cache(cfg, B, tokens.shape[1], device=device)
    out = []
    for p in range(tokens.shape[1]):
        pos = torch.tensor(p, device=device) if pos_tensor else p
        logits, cache = serve(params, adapters, cache,
                              tokens[:, p:p + 1].to(device), pos)
        out.append((logits, [(k.clone(), v.clone()) for k, v in cache]))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_serve_steps_match_the_cpu(cuda, name, dtype):
    cfg = get(name + "-smoke")
    cpu_model, card_model = _model(cfg, dtype, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab_size - 4, (B, P)))
    prefill = M.make_prefill_step(cfg)
    n_lm, n_fa = lm.lora_matmul.launches, fa.flash_attention.launches
    gl, gc = prefill(*card_model, {"tokens": toks.to(cuda)})
    assert lm.lora_matmul.launches - n_lm == 5 * cfg.n_layers
    assert fa.flash_attention.launches - n_fa == cfg.n_layers
    wl, wc = prefill(*cpu_model, {"tokens": toks})
    _check_logits(gl, wl, dtype, "prefill")
    for (gk, gv), (wk, wv) in zip(gc, wc):
        bound = 2e-2 if dtype == torch.bfloat16 else 1e-4
        assert _rel(gk, wk) <= bound and _rel(gv, wv) <= bound
    n_lm, n_fa = lm.lora_matmul.launches, fa.flash_attention.launches
    got = _decode(cfg, card_model, toks[:, :STEPS], cuda)
    assert lm.lora_matmul.launches - n_lm == 5 * cfg.n_layers * STEPS
    assert fa.flash_attention.launches == n_fa
    want = _decode(cfg, cpu_model, toks[:, :STEPS], "cpu")
    for p, ((g, gcache), (w, wcache)) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all())
        _check_logits(g, w, dtype, f"step {p}")
        _check_caches(gcache, wcache, dtype, f"step {p}")


def test_position_as_a_device_tensor_equals_an_int(cuda):
    cfg = get("starcoder2-7b-smoke")
    _, card_model = _model(cfg, torch.bfloat16, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        4, cfg.vocab_size - 4, (B, 10)))
    a = _decode(cfg, card_model, toks, cuda)
    b = _decode(cfg, card_model, toks, cuda, pos_tensor=True)
    for (la, ca), (lb, cb) in zip(a, b):
        assert torch.equal(la, lb)
        assert all(torch.equal(x, y) for (x, _), (y, _) in zip(ca, cb))


def test_stablelm_full_width_prefill_raises_and_decode_runs(cuda):
    """Head dim 80 (stablelm-3b at its published widths, depth cut to 2
    layers).  Prefill raised here until ``flash_attention`` took head
    dim 80; it now runs through the kernel (one launch a layer) and
    matches the CPU port (logits 3e-2 of the largest, caches 2e-2); the
    serve step (plain torch attention) runs and matches the CPU port."""
    cfg = dataclasses.replace(get("stablelm-3b"), n_layers=2)
    assert cfg.head_dim == 80
    cpu_model, card_model = _model(cfg, torch.bfloat16, cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        4, cfg.vocab_size - 4, (B, 4)))
    n_fa = fa.flash_attention.launches
    gl, gc = M.make_prefill_step(cfg)(*card_model,
                                      {"tokens": toks.to(cuda)})
    assert fa.flash_attention.launches == n_fa + cfg.n_layers
    wl, wc = M.make_prefill_step(cfg)(*cpu_model, {"tokens": toks})
    _check_logits(gl, wl, torch.bfloat16, "prefill")
    for (gk, gv), (wk, wv) in zip(gc, wc):
        assert _rel(gk, wk) <= 2e-2 and _rel(gv, wv) <= 2e-2
    got = _decode(cfg, card_model, toks, cuda)
    want = _decode(cfg, cpu_model, toks, "cpu")
    for p, ((g, gcache), (w, wcache)) in enumerate(zip(got, want)):
        assert g.shape == (B, cfg.vocab_size)
        _check_logits(g, w, torch.bfloat16, f"step {p}")
        _check_caches(gcache, wcache, torch.bfloat16, f"step {p}")


def test_serve_cli_runs_on_the_card_by_default(cuda, capsys):
    argv = ["--steps", "4", "--prompt-len", "8"]
    card = serve_cli.main(argv)
    lines = capsys.readouterr().out.splitlines()
    cpu = serve_cli.main(argv + ["--device", "cpu"])
    assert lines[0] == "serving stablelm-3b-smoke: 1L d=256 pattern=['attn']"
    assert len(lines) == 4
    np.testing.assert_array_equal(card["prompts"], cpu["prompts"])
    assert card["tokens"].shape == cpu["tokens"].shape == (4, 4)
