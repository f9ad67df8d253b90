"""The port's model against the JAX package's, on the same weights.

``tiny-llm`` with the genomic task's vocabulary; the JAX base and
adapters are carried across by ``repro_torch.convert``, and ``lora_b``
is set to a nonzero draw so every adapter path carries signal.  Two
clients are stacked on the port's client axis; the JAX side runs each
client on its own.  ``forward``, ``chunked_ce`` and ``label_logits``
match within 1e-5; one train step's adapter gradients and its AdamW
update within 1e-5 of the largest magnitude.
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
from repro_torch.configs import paper_models as tpm
from repro_torch.core import llm_client as llmc
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

V, C, B, S, N_LABELS = 4102, 2, 4, 64, 2
FWD = JM.FwdOptions(remat=False)


def _tolist(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jpm.TINY_LLM, vocab_size=V)
    tcfg = dataclasses.replace(tpm.TINY_LLM, vocab_size=V)
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
    tparams = convert.params_from_jax(_tolist(jparams))
    tadp = convert.adapters_from_jax(_tolist(stacked), stacked=True)
    tokens = rng.integers(4, V - N_LABELS, (C, B, S)).astype(np.int32)
    labels = np.full((C, B, S), -1, np.int32)
    for c in range(C):
        for b in range(B):
            pos = int(rng.integers(10, S - 1))
            tokens[c, b, pos + 1:] = 0
            labels[c, b, pos] = V - N_LABELS + int(rng.integers(0, 2))
    labels[1, 3] = -1                        # a padded row: no label
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jadp=jadp,
                tparams=tparams, tadp=tadp, tokens=tokens, labels=labels)


def test_params_carried_across_layer_by_layer(setup):
    jp, tp = setup["jparams"], setup["tparams"]
    assert len(tp["layers"]) == setup["tcfg"].n_layers
    for g in range(setup["tcfg"].n_layers):
        for name, arr in jp["groups"][0].items():
            np.testing.assert_array_equal(tp["layers"][g][name].numpy(),
                                          np.asarray(arr[g]))


def test_forward_matches_jax(setup):
    got = M.forward(setup["tcfg"], setup["tparams"], setup["tadp"],
                    torch.from_numpy(setup["tokens"]).long())
    for c in range(C):
        want, _, _ = JM.forward(setup["jcfg"], setup["jparams"],
                                setup["jadp"][c],
                                {"tokens": jnp.asarray(setup["tokens"][c])},
                                FWD)
        np.testing.assert_allclose(got[c].detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_chunked_ce_matches_jax(setup):
    hidden = M.forward(setup["tcfg"], setup["tparams"], setup["tadp"],
                       torch.from_numpy(setup["tokens"]).long())
    got = M.chunked_ce(setup["tcfg"], setup["tparams"], hidden,
                       torch.from_numpy(setup["labels"]).long())
    for c in range(C):
        h, _, _ = JM.forward(setup["jcfg"], setup["jparams"],
                             setup["jadp"][c],
                             {"tokens": jnp.asarray(setup["tokens"][c])}, FWD)
        want = JM.chunked_ce(setup["jcfg"], setup["jparams"], h,
                             jnp.asarray(setup["labels"][c]))
        assert abs(float(got[c]) - float(want)) <= 1e-5


def test_label_logits_matches_jax(setup):
    logits, gold = llmc.label_logits(
        setup["tcfg"], setup["tparams"], setup["tadp"],
        torch.from_numpy(setup["tokens"]).long(),
        torch.from_numpy(setup["labels"]).long(), N_LABELS)
    for c in range(C):
        wl, wg = jllmc.label_logits(setup["jcfg"], setup["jparams"],
                                    setup["jadp"][c],
                                    jnp.asarray(setup["tokens"][c]),
                                    jnp.asarray(setup["labels"][c]),
                                    N_LABELS)
        np.testing.assert_allclose(logits[c].detach().numpy(),
                                   np.asarray(wl), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(gold[c].numpy(), np.asarray(wg))
    mask = torch.ones(C, B)
    nll = llmc.masked_label_nll(logits, gold, mask)
    f1 = llmc.masked_macro_f1(logits, gold, mask, N_LABELS)
    for c in range(C):
        wl, wg = jllmc.label_logits(setup["jcfg"], setup["jparams"],
                                    setup["jadp"][c],
                                    jnp.asarray(setup["tokens"][c]),
                                    jnp.asarray(setup["labels"][c]),
                                    N_LABELS)
        m = jnp.ones(B)
        assert abs(float(nll[c]) - float(jllmc.masked_label_nll(wl, wg, m))
                   ) <= 1e-5
        assert float(f1[c]) == pytest.approx(
            float(jllmc.masked_macro_f1(wl, wg, m, N_LABELS)), abs=1e-6)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def test_train_step_grads_and_adamw_match_jax(setup):
    batch = {"tokens": torch.from_numpy(setup["tokens"]).long(),
             "labels": torch.from_numpy(setup["labels"]).long()}
    loss, grads = M.loss_and_grads(setup["tcfg"], setup["tparams"],
                                   setup["tadp"], batch)
    opt = adamw.init(setup["tadp"], n_clients=C)
    step = M.make_train_step(setup["tcfg"], lr=3e-3)
    new_adp, new_opt, metrics = step(setup["tparams"], setup["tadp"], opt,
                                     batch)
    assert new_opt.step.tolist() == [1] * C
    jstep = jax.jit(JM.make_train_step(setup["jcfg"], lr=3e-3, opts=FWD))

    @jax.jit
    def jloss(adp, tokens, labels):
        h, _, _ = JM.forward(setup["jcfg"], setup["jparams"], adp,
                             {"tokens": tokens}, FWD)
        return JM.chunked_ce(setup["jcfg"], setup["jparams"], h, labels)

    for c in range(C):
        wl, wg = jax.jit(jax.value_and_grad(jloss))(
            setup["jadp"][c], jnp.asarray(setup["tokens"][c]),
            jnp.asarray(setup["labels"][c]))
        assert abs(float(loss[c]) - float(wl)) <= 1e-5
        assert abs(float(metrics["loss"][c]) - float(wl)) <= 1e-5
        wg_t = convert.adapters_from_jax(_tolist(wg))
        for g, w in zip(tree_leaves(grads), tree_leaves(wg_t)):
            assert _rel(g[c].numpy(), w.numpy()) <= 1e-5
        ja, jo, _ = jstep(setup["jparams"], setup["jadp"][c],
                          jadamw.init(setup["jadp"][c]),
                          {"tokens": jnp.asarray(setup["tokens"][c]),
                           "labels": jnp.asarray(setup["labels"][c])})
        for got_t, want_t in ((new_adp, ja), (new_opt.mu, jo.mu),
                              (new_opt.nu, jo.nu)):
            want_l = tree_leaves(convert.adapters_from_jax(_tolist(want_t)))
            for g, w in zip(tree_leaves(got_t), want_l):
                assert _rel(g[c].numpy(), w.numpy()) <= 1e-5


def test_adamw_state_carried_across(setup):
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *setup["jadp"])
    jst = jax.vmap(jadamw.init)(stacked)
    st = convert.adamw_from_jax(_tolist(jst), stacked=True)
    assert st.step.shape == (C,)
    assert [tuple(t.shape) for t in tree_leaves(st.mu)] == \
        [tuple(t.shape) for t in tree_leaves(setup["tadp"])]


def test_unported_mixers_raise():
    from repro_torch.models import layers
    cfg = tpm.TINY_LLM
    with pytest.raises(NotImplementedError, match="other model families"):
        layers.init_layer_params(np.zeros(2, np.uint32), cfg, "mla", "mlp",
                                 torch.float32)
    with pytest.raises(NotImplementedError, match="other model families"):
        layers.init_layer_params(np.zeros(2, np.uint32), cfg, "attn", "moe",
                                 torch.float32)
