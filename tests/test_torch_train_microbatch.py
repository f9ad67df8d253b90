"""The train step's microbatches and its launch counts on the CPU, for the
numbers the smoke run's phase 19 holds the card to (``chip_smoke.py``):

- ``chip_smoke.train_launch_formula`` against the calls one
  ``make_train_step`` makes on each family's ``-smoke`` config, counted
  by wrapping ``kernels.ops.lora_matmul`` and ``flash_attention`` (the
  plain versions here) in autograd functions that count each forward
  and each backward that computes dx (or dq, dk, dv): two microbatches
  under remat and without, one microbatch under remat;
- ``n_microbatches=2`` against 1 in bfloat16, on the families with no
  MoE (a MoE layer's capacity is a microbatch's, so its routing may
  drop other choices): the CPU port's own gap, printed, within
  ``CPU_GAP`` (1e-2 of the first moment's largest magnitude, 1e-3 of
  the gradient norm, 1e-6 of the loss; seen: 5.9e-3, 2.6e-4, 7e-8), the
  gap ``chip_smoke.TRAIN_NM_TOL`` starts from (on the card,
  ``lora_matmul``'s split plan and depth add to it);
- phase 19's CPU half (``train_half_step``, ``train_half_errs``) runs
  here, and ``train_bound`` counts as stated (``tests/
  test_torch_train_checks.py`` holds phase 19's other helpers).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.kernels import ops, ref
from repro_torch.models import counting
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

FAMILIES = ["stablelm-3b", "kimi-k2-1t-a32b", "minicpm3-4b",
            "jamba-1.5-large-398b", "xlstm-125m", "whisper-large-v3",
            "qwen2-vl-72b"]
B, S = 4, 16
CPU_GAP = dict(loss=1e-6, mu=1e-2, grad_norm=1e-3)


def draw(name: str, dtype=None):
    cfg = get(name + "-smoke")
    key = jr.PRNGKey(0)
    params = M.init_params(cfg, key, dtype=dtype, device="cpu")
    adapters = tree_map(lambda t: t[None] + 0.01,
                        M.init_adapters(cfg, key, params))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab_size - 4,
                                         (1, B, S + 1)))
    batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    if cfg.frontend or cfg.encoder_decoder:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (1, B, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32)).to(params["embed"].dtype)
    return cfg, params, adapters, batch


class _CountedLoRA(torch.autograd.Function):
    counts = {}

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        _CountedLoRA.counts["lora_matmul"] += 1
        with torch.no_grad():
            return ref.lora_matmul(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            _CountedLoRA.counts["lora_matmul"] += 1
        with torch.enable_grad():
            xs, as_, bs = (t.detach().requires_grad_() for t in (x, a, b))
            y = ref.lora_matmul(xs, w, as_, bs, ctx.scale)
            gx, ga, gb = torch.autograd.grad(y, (xs, as_, bs), dy)
        return (gx if ctx.needs_input_grad[0] else None), None, ga, gb, None


class _CountedAttention(torch.autograd.Function):
    counts = _CountedLoRA.counts

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window)
        _CountedAttention.counts["flash_attention"] += 1
        with torch.no_grad():
            return ref.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        _CountedAttention.counts["flash_attention_bwd"] += 1
        causal, window = ctx.args
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = ref.flash_attention(*qkv, causal=causal, window=window)
            grads = torch.autograd.grad(y, qkv, do)
        return (*grads, None, None)


@pytest.fixture
def counted(monkeypatch):
    counts = _CountedLoRA.counts
    monkeypatch.setattr(ops, "lora_matmul",
                        lambda x, w, a, b, scale: _CountedLoRA.apply(
                            x, w, a, b, scale))
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, causal=True, window=0, scale=None:
                        _CountedAttention.apply(q, k, v, causal, window))
    return counts


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_formula_counts_the_step(counted, name):
    cfg, params, adapters, batch = draw(name, torch.float32)
    for nm, remat in ((2, True), (2, False), (1, True)):
        counted.update(lora_matmul=0, flash_attention=0,
                       flash_attention_bwd=0)
        step = M.make_train_step(cfg, n_microbatches=nm, lr=3e-3,
                                 opts=M.FwdOptions(remat=remat))
        step(params, adapters, adamw.init(adapters, n_clients=1), batch)
        want = smoke.train_launch_formula(cfg, nm, remat, keys=S)
        assert want["flash_attention_bwd_side"] == 0
        assert counted == {k: want[k] for k in counted}, (nm, remat)


@pytest.mark.parametrize("name", [n for n in FAMILIES
                                  if not get(n + "-smoke").moe])
def test_bf16_microbatch_gap_within_the_smoke_bound(name):
    cfg, params, adapters, batch = draw(name)
    assert params["embed"].dtype == torch.bfloat16
    res = {}
    for nm in (1, 2):
        step = M.make_train_step(cfg, n_microbatches=nm, lr=3e-3)
        _, opt, met = step(params, adapters,
                           adamw.init(adapters, n_clients=1), batch)
        res[nm] = (tree_leaves(opt.mu), float(met["loss"][0]),
                   float(met["grad_norm"][0]))
    (mu1, l1, g1), (mu2, l2, g2) = res[1], res[2]
    top = max(float(t.abs().max()) for t in mu1)
    gap = dict(loss=abs(l2 - l1) / l1,
               mu=max(float((a - b).abs().max())
                      for a, b in zip(mu2, mu1)) / top,
               grad_norm=abs(g2 - g1) / g1)
    print(name, gap)
    for k, v in gap.items():
        assert v <= CPU_GAP[k] <= smoke.TRAIN_NM_TOL[k], k


def test_phase_19_cpu_half_and_bound():
    """``train_half_step`` on two copies of one float32 model agree
    exactly (``train_half_errs`` reads 0); ``train_bound`` counts 6 × the
    layers' active parameters a row, 4 × the head a label, and reads
    the weights three times a microbatch under remat; the function's
    bound (one microbatch, no remat) 4 × and once a pass."""
    cfg, params, adapters, batch = draw("minicpm3-4b", torch.float32)
    one = tree_map(lambda t: t[0], adapters)
    tok, lab = batch["tokens"][0], batch["labels"][0]
    a = smoke.train_half_step(cfg, (params, one), tok, lab)
    b = smoke.train_half_step(cfg, (params, one), tok, lab)
    errs = smoke.train_half_errs(a, b)
    assert a["nm"] == 2 and errs["loss"] == 0 and errs["mu"] == 0
    ms, by, flops, nbytes = smoke.train_bound(cfg, (params, one), B, S, 2)
    table = cfg.vocab_size * cfg.d_model
    layers = counting.count_active_params(cfg) - 2 * table
    assert flops == 6 * layers * B * S + 4 * table * B * S
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params["layers"]))
    assert nbytes == 6 * weights + 4 * table * 4
    assert ms > 0 and by in ("operations", "bytes")
    # the function's bound: one microbatch, forward and dx (4 × N a row),
    # the weights and the head read once a pass
    ms1, _, flops1, nbytes1 = smoke.train_bound(cfg, (params, one), B, S,
                                                1, remat=False)
    assert flops1 == 4 * layers * B * S + 4 * table * B * S
    assert nbytes1 == 2 * weights + 2 * table * 4
    assert 0 < ms1 < ms

