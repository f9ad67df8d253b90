"""QLoRA on the encoder-decoder: ``whisper-large-v3-smoke`` with
``lora.quantize_base=True`` in the port against the JAX package, in
float32 on the CPU.  The packed bytes of every adapted weight, the
encoder's included, are bitwise JAX's ``quantize_stacked_groups``; one
``make_train_step`` (two microbatches, remat) with the frames: the loss
within 1e-5 and AdamW's first moment within 1e-5 of its largest
magnitude (floored at 1, ``tests/test_torch_recurrent_train.py``'s
bounds).  The step reaches ``int4_matmul``'s plain version in every
adapted projection of both stacks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get as jget
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.peft import lora as jlora
from repro_torch import convert
from repro_torch.configs.registry import get as tget
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.peft import lora
from repro_torch.tree import tree_leaves
from torch_families import KEY, np_tree

torch.set_num_threads(1)

NAME = "whisper-large-v3-smoke"
B, S = 2, 16


def qlora(cfg):
    return dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, quantize_base=True))


def test_qlora_whisper_packs_and_trains_as_jax(monkeypatch):
    jcfg, tcfg = qlora(jget(NAME)), qlora(tget(NAME))
    jplain = JM.init_params(jget(NAME), KEY, dtype=jnp.float32)
    jq = jlora.quantize_stacked_groups(jplain, jcfg.lora.targets)
    got = lora.quantize_stacked_groups(
        convert.params_from_jax(np_tree(jplain)), tcfg.lora.targets)
    want = convert.params_from_jax(np_tree(jq))
    packed = 0
    for name in ("layers", "enc_layers"):
        for gl, wl in zip(got[name], want[name]):
            assert sorted(gl) == sorted(wl)
            for k, w in wl.items():
                assert torch.equal(gl[k], w), (name, k)
                packed += k.endswith("__q")
    assert packed == 5 * (tcfg.n_layers + tcfg.n_encoder_layers)
    ja = jax.tree.map(lambda x: x + 0.01, JM.init_adapters(jcfg, KEY, jq))
    tadp = convert.adapters_from_jax(
        np_tree(jax.tree.map(lambda x: x[None], ja)), stacked=True)
    rng = np.random.default_rng(12)
    toks, labels = (rng.integers(4, tcfg.vocab_size - 4, (B, S)).astype(
        np.int32) for _ in range(2))
    frames = rng.standard_normal(
        (B, tcfg.n_frontend_tokens, tcfg.d_model)).astype(np.float32)
    calls = []
    orig = ref.int4_matmul
    monkeypatch.setattr(ref, "int4_matmul", lambda *a, **k: (
        calls.append(1), orig(*a, **k))[1])
    step = M.make_train_step(tcfg, n_microbatches=2, lr=3e-3)
    _, opt, met = step(got, tadp, adamw.init(tadp, n_clients=1), {
        "tokens": torch.from_numpy(toks).long()[None],
        "labels": torch.from_numpy(labels).long()[None],
        "frontend": torch.from_numpy(frames)[None]})
    assert calls
    jstep = jax.jit(JM.make_train_step(jcfg, n_microbatches=2, lr=3e-3))
    _, jo, jmet = jstep(jq, ja, jadamw.init(ja), {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "frontend": jnp.asarray(frames)})
    assert abs(float(met["loss"][0]) - float(jmet["loss"])) <= 1e-5
    wmu = tree_leaves(convert.adapters_from_jax(np_tree(jo.mu)))
    gmu = tree_leaves(opt.mu)
    assert len(gmu) == len(wmu) == 10 * (tcfg.n_layers
                                         + tcfg.n_encoder_layers)
    scale = max(1.0, max(float(w.abs().max()) for w in wmu))
    for g, w in zip(gmu, wmu):
        assert float((g[0] - w).abs().max()) <= 1e-5 * scale
