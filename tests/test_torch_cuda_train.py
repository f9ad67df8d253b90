"""The microbatched, rematerialised train step on the card.  This file
imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Without a card every case skips.  Checks: remat against the plain step
bit for bit on the card (loss, gradient norm, the adapters and both AdamW
moments after two steps), for a dense config in float32 and bfloat16 and
for whisper-large-v3-smoke behind 1500 frames (the published count) in
bfloat16; the card's ``n_microbatches=2`` step against the CPU port's in
float32 on one ``-smoke`` config of each family (the loss within 1e-5,
AdamW's first moment within 1e-5 of its largest magnitude floored at
1); and phase 19's launch formula
(``chip_smoke.train_launch_formula``) on a two-layer config at 128
tokens, side launches of the backward included.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["stablelm-3b", "kimi-k2-1t-a32b", "minicpm3-4b",
            "jamba-1.5-large-398b", "xlstm-125m", "whisper-large-v3",
            "qwen2-vl-72b"]
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draw(cfg, dtype, device, B=4, S=16, seed=0):
    key = jr.PRNGKey(0)
    params = M.init_params(cfg, key, dtype=dtype, device=device)
    adapters = tree_map(lambda t: t[None] + 0.01,
                        M.init_adapters(cfg, key, params))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab_size - 4,
                                         (1, B, S + 1))).to(device)
    batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    if cfg.frontend or cfg.encoder_decoder:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (1, B, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32)).to(device=device, dtype=dtype)
    return params, adapters, batch


def steps(cfg, params, adapters, batch, n: int, **kw):
    step = M.make_train_step(cfg, lr=3e-3, **kw)
    opt, mets = adamw.init(adapters, n_clients=1), []
    for _ in range(n):
        adapters, opt, met = step(params, adapters, opt, batch)
        mets.append(met)
    return adapters, opt, mets


@pytest.mark.parametrize("name,dtype,frames", [
    ("stablelm-3b", torch.float32, 0), ("stablelm-3b", torch.bfloat16, 0),
    ("whisper-large-v3", torch.bfloat16, 1500)])
def test_remat_bitwise_on_the_card(cuda, name, dtype, frames):
    cfg = get(name + "-smoke")
    if frames:
        cfg = dataclasses.replace(cfg, n_frontend_tokens=frames)
    params, adapters, batch = draw(cfg, dtype, cuda, S=128)
    runs = [steps(cfg, params, adapters, batch, 2, n_microbatches=2,
                  opts=M.FwdOptions(remat=remat)) for remat in (True, False)]
    (a0, o0, m0), (a1, o1, m1) = runs
    for x, y in zip(m0, m1):
        assert torch.equal(x["loss"], y["loss"])
        assert torch.equal(x["grad_norm"], y["grad_norm"])
    for x, y in zip(tree_leaves((a0, o0.mu, o0.nu)),
                    tree_leaves((a1, o1.mu, o1.nu))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", FAMILIES)
def test_card_step_matches_the_cpu_port(cuda, name):
    cfg = get(name + "-smoke")
    got, want = [], []
    for dev, out in ((cuda, got), (torch.device("cpu"), want)):
        params, adapters, batch = draw(cfg, torch.float32, dev)
        _, opt, mets = steps(cfg, params, adapters, batch, 1,
                             n_microbatches=2)
        out += [float(mets[0]["loss"][0]),
                [t[0].cpu() for t in tree_leaves(opt.mu)]]
    assert abs(got[0] - want[0]) <= TOL
    top = max(float(t.abs().max()) for t in want[1])
    for g, w in zip(got[1], want[1]):
        assert float((g - w).abs().max()) <= TOL * max(1.0, top)


@pytest.mark.parametrize("remat,nm", [(True, 2), (False, 2), (True, 1)])
def test_phase_19_launch_formula(cuda, remat, nm):
    smoke = smoke_module()
    cfg = dataclasses.replace(get("stablelm-3b-smoke"), n_layers=2)
    params, adapters, batch = draw(cfg, torch.bfloat16, cuda, S=128)
    step = M.make_train_step(cfg, n_microbatches=nm, lr=3e-3,
                             opts=M.FwdOptions(remat=remat))
    smoke.zero_counters()
    step(params, adapters, adamw.init(adapters, n_clients=1), batch)
    torch.cuda.synchronize()
    got = smoke.read_counters()
    want = smoke.train_launch_formula(cfg, nm, remat, keys=128)
    assert {k: got[k] for k in want} == want
    assert want["flash_attention_bwd_side"] == 2 * want[
        "flash_attention_bwd"]
