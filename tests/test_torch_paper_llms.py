"""The paper's GPT-2 and DeepSeek-LLM-7B in the port, against the JAX
package's.

``GPT2`` and ``DEEPSEEK_7B`` equal JAX's field for field (the port keeps
no LoRA dropout, which the JAX package never applies, and none of its
long-decode fields), and ``task_llm_config`` accepts both.  Then each at
a reduced size, its shape features kept: GPT-2 at full width with one
layer (d_model 768, 12 heads of 64, tied head); DeepSeek with its head
dim 128, ``n_kv_heads == n_heads`` and an untied ``lm_head`` at d_model
512 and d_ff 1376 (two layers; the 4096 width does not fit the test
workers).  The port's draw of DeepSeek's base is within 3 ulp of JAX's
and bitwise on 99.9 % of values, its untied head included; on JAX's base
carried across, the forward matches within 1e-5 and one train step's loss and
AdamW moments within 1e-5 of the largest magnitude, as
``tests/test_torch_models.py`` holds ``tiny-llm``, the updated adapters
within 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.core import llm_client as jllmc
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs import paper_models as tpm
from repro_torch.core import llm_client as llmc
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

V, C, B, S, N_LABELS = 4102, 2, 2, 64, 2
FWD = JM.FwdOptions(remat=False)
REDUCED = {
    "gpt2": dict(n_layers=1),
    "deepseek-llm-7b-base": dict(n_layers=2, d_model=512, n_heads=4,
                                 n_kv_heads=4, d_ff=1376),
}
NAMES = {"gpt2": "GPT2", "deepseek-llm-7b-base": "DEEPSEEK_7B"}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_configs_equal_jax_field_for_field(name):
    got, want = getattr(tpm, NAMES[name]), getattr(jpm, NAMES[name])
    for f in dataclasses.fields(got):
        if f.name == "lora":
            for g in dataclasses.fields(got.lora):
                assert getattr(got.lora, g.name) == \
                    getattr(want.lora, g.name), g.name
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in dataclasses.fields(want):     # the fields the port leaves out
        if not hasattr(got, f.name):
            assert f.name in ("mrope_sections", "moe", "mla", "mamba",
                              "xlstm", "encoder_decoder", "n_encoder_layers",
                              "n_frontend_tokens", "frontend",
                              "supports_long_decode", "long_decode_window")
    cfg = llmc.task_llm_config(name, V, 64)
    assert cfg == dataclasses.replace(got, vocab_size=V)
    assert dataclasses.asdict(cfg)["head_dim"] == \
        jllmc.task_llm_config(name, V, 64).head_dim
    with pytest.raises(KeyError):
        llmc.task_llm_config("gpt-5", V, 64)


def _tolist(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.fixture(scope="module", params=sorted(REDUCED))
def setup(request):
    name = request.param
    jcfg = dataclasses.replace(jllmc.task_llm_config(name, V, S),
                               **REDUCED[name])
    tcfg = dataclasses.replace(llmc.task_llm_config(name, V, S),
                               **REDUCED[name])
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    jadp = []
    for c in range(C):
        a = JM.init_adapters(jcfg, jax.random.PRNGKey(10 + c), jparams)
        a = jax.tree_util.tree_map_with_path(
            lambda path, x: (jnp.asarray(rng.standard_normal(x.shape)
                                         .astype(np.float32) * 0.05)
                             if "lora_b" in jax.tree_util.keystr(path)
                             else x), a)
        jadp.append(a)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jadp)
    tokens = rng.integers(4, V - N_LABELS, (C, B, S)).astype(np.int32)
    labels = np.full((C, B, S), -1, np.int32)
    for c in range(C):
        for b in range(B):
            pos = int(rng.integers(10, S - 1))
            tokens[c, b, pos + 1:] = 0
            labels[c, b, pos] = V - N_LABELS + int(rng.integers(0, 2))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                jadp=jadp, tparams=convert.params_from_jax(_tolist(jparams)),
                tadp=convert.adapters_from_jax(_tolist(stacked),
                                               stacked=True),
                tokens=tokens, labels=labels)


def test_untied_head_base_draw_matches_jax():
    """DeepSeek's base (its untied ``lm_head`` included) drawn by the port
    from the run key, against JAX's draw; at d_model 256 (head dim 128)
    to keep the CPU emulation of the normal short."""
    shape = dict(n_layers=1, d_model=256, n_heads=2, n_kv_heads=2, d_ff=688)
    name = "deepseek-llm-7b-base"
    cfg = dataclasses.replace(llmc.task_llm_config(name, V, S), **shape)
    jcfg = dataclasses.replace(jllmc.task_llm_config(name, V, S), **shape)
    got = M.init_params(cfg, jr.PRNGKey(3), dtype=torch.float32,
                        device="cpu")
    want = convert.params_from_jax(_tolist(
        JM.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)))
    assert "lm_head" in got and sorted(got) == sorted(want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        # 2 ulp on the normal (``random.py``), plus the fan-in scale's
        # rounding; bitwise on at least 99.9 % of values
        g, w = g.numpy(), w.numpy()
        assert g.shape == w.shape and _ulps(g, w) <= 3
        assert np.mean(g == w) >= 0.999


def test_forward_and_train_step_match_jax(setup):
    s = setup
    tokens = torch.from_numpy(s["tokens"]).long()
    labels = torch.from_numpy(s["labels"]).long()
    got = M.forward(s["tcfg"], s["tparams"], s["tadp"], tokens)
    opt = adamw.init(s["tadp"], n_clients=C)
    step = M.make_train_step(s["tcfg"], lr=3e-3)
    new_adp, new_opt, metrics = step(s["tparams"], s["tadp"], opt,
                                     {"tokens": tokens, "labels": labels})
    jstep = jax.jit(JM.make_train_step(s["jcfg"], lr=3e-3, opts=FWD))
    for c in range(C):
        want, _, _ = JM.forward(s["jcfg"], s["jparams"], s["jadp"][c],
                                {"tokens": jnp.asarray(s["tokens"][c])}, FWD)
        np.testing.assert_allclose(got[c].detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
        ja, jo, jm = jstep(s["jparams"], s["jadp"][c],
                           jadamw.init(s["jadp"][c]),
                           {"tokens": jnp.asarray(s["tokens"][c]),
                            "labels": jnp.asarray(s["labels"][c])})
        assert abs(float(metrics["loss"][c]) - float(jm["loss"])) <= 1e-5
        # the moments (gradients) within 1e-5; the updated adapters within
        # 1e-3, the JAX package's own tolerance (Adam's m/√v amplifies
        # float32 noise in near-zero gradients)
        for got_t, want_t, tol in ((new_opt.mu, jo.mu, 1e-5),
                                   (new_opt.nu, jo.nu, 1e-5),
                                   (new_adp, ja, 1e-3)):
            want_l = tree_leaves(convert.adapters_from_jax(_tolist(want_t)))
            for g, w in zip(tree_leaves(got_t), want_l):
                g, w = g[c].detach().numpy(), w.numpy()
                scale = max(1.0, float(np.abs(w).max()))
                assert float(np.abs(g - w).max()) / scale <= tol
