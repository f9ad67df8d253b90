"""Phase 19's helpers in the smoke run (``chip_smoke.py``) on the CPU:

- the shapes it checks ``flash_attention_bwd`` and ``lora_matmul``'s dx
  at (``train_attn_shapes``, ``train_lora_shapes``) are exactly those
  of the calls one ``make_train_step`` of two microbatches makes, on
  each family's ``-smoke`` config;
- ``train_half`` gives the float32 step of every model and the
  bfloat16 one of a model with sLSTM layers, and ``train_half_compare``
  holds both.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map
from test_torch_train_microbatch import FAMILIES, S, draw, smoke

torch.set_num_threads(1)


@pytest.mark.parametrize("name", FAMILIES)
def test_phase_19_kernel_check_shapes_are_the_steps(monkeypatch, name):
    """``train_attn_shapes`` and ``train_lora_shapes`` (the shapes phase
    19 checks ``flash_attention_bwd`` and ``lora_matmul``'s dx at) are
    exactly those of the attention and adapted-projection calls one
    step of ``n_microbatches=2`` makes (``TRAIN_S`` cut to this test's
    sequence)."""
    cfg, params, adapters, batch = draw(name, torch.float32)
    monkeypatch.setattr(smoke, "TRAIN_S", S)
    seen = {"attn": set(), "lora": set()}
    attn, lora = ops.flash_attention, ops.lora_matmul

    def spy_attn(q, k, v, causal=True, window=0, scale=None):
        seen["attn"].add((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                          k.shape[2], q.shape[3], v.shape[3], causal,
                          window))
        return attn(q, k, v, causal=causal, window=window, scale=scale)

    def spy_lora(x, w, a, b, scale):
        seen["lora"].add((x[0].numel() // x.shape[-1], *w.shape,
                          a.shape[-1]))
        return lora(x, w, a, b, scale)
    monkeypatch.setattr(ops, "flash_attention", spy_attn)
    monkeypatch.setattr(ops, "lora_matmul", spy_lora)
    step = M.make_train_step(cfg, n_microbatches=2, lr=3e-3)
    step(params, adapters, adamw.init(adapters, n_clients=1), batch)
    one = tree_map(lambda t: t[0], adapters)
    assert seen["attn"] == {tuple(s[1:]) for s in
                            smoke.train_attn_shapes(cfg)}
    assert seen["lora"] == {tuple(s[1:]) for s in
                            smoke.train_lora_shapes(cfg, (params, one))}


def test_phase_19_bf16_half_of_an_slstm_model():
    """``train_half``: the float32 step for every model, the bfloat16 one
    only for a model with sLSTM layers; ``train_half_compare`` holds
    both (0 between two runs of one model)."""
    for name, bf16 in (("xlstm-125m", True), ("stablelm-3b", False)):
        cfg, params, adapters, batch = draw(name)
        one = tree_map(lambda t: t[0], adapters)
        tok, lab = batch["tokens"][0], batch["labels"][0]
        halves = {}
        for dt, m in ((torch.bfloat16, (params, one)),
                      (torch.float32, tree_map(lambda t: t.float(),
                                               (params, one)))):
            halves.update(smoke.train_half(cfg, m, tok, lab, dt))
        assert sorted(halves) == (["train", "train_bf16"] if bf16
                                  else ["train"])
        errs = smoke.train_half_compare(halves, halves)
        assert errs["loss"] == errs["mu"] == 0
        assert ("bf16" in errs) == bf16
        if bf16:
            assert errs["bf16"]["loss"] == errs["bf16"]["mu"] == 0
            assert all(t.dtype == torch.float32 for t in
                       tree_leaves(halves["train_bf16"]["mu"]))
