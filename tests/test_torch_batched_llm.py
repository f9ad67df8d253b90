"""The port's batched LLM fine-tuning engine against the JAX package's.

Key contract: minibatch draws are bitwise the JAX draws; adapter inits
drawn by the port are within 2 ulp of JAX's (the ``erf_inv`` port), and
carried across they are bitwise JAX's.  Stage parity, with the JAX base
carried across: losses and teacher within 5e-4, F1 within 0.05 and final
adapters within 1e-3, the tolerances of ``tests/test_batched_llm.py``
(Adam's ``m/√v`` amplifies float32 noise in near-zero gradients).
Padding clients are inert, and a second ``run()`` continues the global
step stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import llm_client as jllmc
from repro.core.batched_llm import BatchedLLMEngine as JEngine
from repro.data.tasks import build_task as jbuild_task
from repro.models import model as JM
from repro.peft import lora as jlora
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.core import llm_client as llmc
from repro_torch.core.batched_llm import BatchedLLMEngine
from repro_torch.data.tasks import build_task
from repro_torch.models import model as M
from repro_torch.peft import lora
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

STEPS, SEED = 4, 11


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread, whatever a module collected or run
    before it in the same worker set: with more, the CPU's batched
    products split their sums by the batch's shape, and the sharded stage
    is no longer bitwise the padded one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TASK = dict(n_clients=3, train_size=61, test_size=16, val_size=16, seed=3)


def _tolist(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jtask = jbuild_task("genomic", **TASK)
    task = build_task("genomic", **TASK)
    jcfg = jllmc.task_llm_config("tiny-llm", jtask.vocab_size,
                                 jtask.llm_seq_len)
    cfg = llmc.task_llm_config("tiny-llm", task.vocab_size,
                               task.llm_seq_len)
    jbase = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    base = convert.params_from_jax(_tolist(jbase))
    return dict(jtask=jtask, task=task, jcfg=jcfg, cfg=cfg, jbase=jbase,
                base=base)


@pytest.fixture(scope="module")
def runs(setup):
    s = setup
    jeng = JEngine(s["jtask"], s["jcfg"], s["jbase"], seed=SEED, steps=STEPS)
    jout = jeng.run()
    eng = BatchedLLMEngine(s["task"], s["cfg"], s["base"], seed=SEED,
                           steps=STEPS)
    eng.adapters = convert.adapters_from_jax(
        _tolist(jax.vmap(lambda k: JM.init_adapters(s["jcfg"], k, s["jbase"]))(
            jax.vmap(jllmc.llm_key, in_axes=(None, 0, None))(
                jllmc.llm_root(SEED), jnp.arange(3), jllmc.LLM_INIT_STEP))),
        stacked=True)
    out = eng.run()
    return jeng, jout, eng, out


def test_task_shards_are_ragged(setup):
    assert [cl.n for cl in setup["task"].clients] == [21, 20, 20]


@pytest.mark.parametrize("seed", [5, 11])
def test_minibatch_draws_bitwise(seed):
    root, jroot = llmc.llm_root(seed), jllmc.llm_root(seed)
    np.testing.assert_array_equal(root, np.asarray(jroot))
    for c, n in enumerate([17, 16, 3, 1]):
        for step in (0, 4, 29):
            got = llmc.sample_minibatch_idx(llmc.llm_key(root, c, step), n, 16)
            want = jllmc.sample_minibatch_idx(
                jllmc.llm_key(jroot, c, step), n, 16)
            np.testing.assert_array_equal(got, np.asarray(want))
            assert got.max() < n


def test_adapter_init_within_2ulp(setup):
    s = setup
    root = llmc.llm_root(SEED)
    for c in range(3):
        k = llmc.llm_key(root, c, llmc.LLM_INIT_STEP)
        got = M.init_adapters(s["cfg"], k, s["base"])
        want = convert.adapters_from_jax(_tolist(JM.init_adapters(
            s["jcfg"], jllmc.llm_key(jllmc.llm_root(SEED), c,
                                     jllmc.LLM_INIT_STEP), s["jbase"])))
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            ulps = np.abs(g.numpy().view(np.int32).astype(np.int64)
                          - w.numpy().view(np.int32).astype(np.int64))
            assert ulps.max() <= 2


def test_base_init_within_2ulp():
    """init_params (truncated normals scaled by fan-in) against JAX."""
    jcfg = jllmc.task_llm_config("tiny-llm", 600, 64)
    cfg = llmc.task_llm_config("tiny-llm", 600, 64)
    want = convert.params_from_jax(_tolist(
        JM.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)))
    got = M.init_params(cfg, jr.PRNGKey(4), dtype=torch.float32,
                        device="cpu")
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        ulps = np.abs(g.numpy().view(np.int32).astype(np.int64)
                      - w.numpy().view(np.int32).astype(np.int64))
        assert ulps.max() <= 2


def test_engine_init_draws_follow_the_contract(setup, runs):
    """The engine's own init is the JAX engine's within 2 ulp; carried
    across (as ``runs`` does) it is bitwise JAX's."""
    s = setup
    eng = BatchedLLMEngine(s["task"], s["cfg"], s["base"], seed=SEED,
                           steps=STEPS)
    jinit = jax.vmap(lambda k: JM.init_adapters(s["jcfg"], k, s["jbase"]))(
        jax.vmap(jllmc.llm_key, in_axes=(None, 0, None))(
            jllmc.llm_root(SEED), jnp.arange(3), jllmc.LLM_INIT_STEP))
    carried = convert.adapters_from_jax(_tolist(jinit), stacked=True)
    for g, w in zip(tree_leaves(eng.adapters), tree_leaves(carried)):
        ulps = np.abs(g.numpy().view(np.int32).astype(np.int64)
                      - w.numpy().view(np.int32).astype(np.int64))
        assert ulps.max() <= 2
    for g, layer in enumerate(carried):
        for name, t in layer.items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jinit["groups"][0][name][:, g]))


def test_stage_parity_losses_f1_teacher(setup, runs):
    _, jout, _, out = runs
    np.testing.assert_allclose(out.losses, jout.losses, atol=5e-4)
    np.testing.assert_allclose(out.f1, jout.f1, atol=0.05)
    np.testing.assert_allclose(out.teacher, np.asarray(jout.teacher),
                               atol=5e-4)
    np.testing.assert_allclose(out.final_train_loss, jout.final_train_loss,
                               atol=5e-4)
    for i, cl in enumerate(setup["task"].clients):
        np.testing.assert_allclose(out.teacher[i, :cl.n].sum(1), 1.0,
                                   atol=1e-5)


def test_stage_parity_final_adapters(runs):
    jeng, _, eng, _ = runs
    want = convert.adapters_from_jax(_tolist(jeng.adapters), stacked=True)
    for g, w in zip(tree_leaves(eng.adapters), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-3)
    want_g = convert.adapters_from_jax(_tolist(jeng.a_g))
    for g, w in zip(tree_leaves(eng.a_g), tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-3)


def test_refresh_continues_global_step_stream(setup):
    """Two runs equal the JAX engine's two runs: the step counter
    survives a refresh, so no draw is replayed."""
    s = setup
    jeng = JEngine(s["jtask"], s["jcfg"], s["jbase"], seed=7, steps=STEPS)
    eng = BatchedLLMEngine(s["task"], s["cfg"], s["base"], seed=7,
                           steps=STEPS)
    jeng.run(), eng.run()
    jout, out = jeng.run(), eng.run()
    assert eng._n_steps == 2 * STEPS
    np.testing.assert_allclose(out.losses, jout.losses, atol=5e-4)


def test_client_padding_rows_inert(setup):
    """pad_to adds inert clients: real clients' outputs are unchanged and
    the padding adapters move only by the distill blend toward a_g."""
    s = setup
    plain = BatchedLLMEngine(s["task"], s["cfg"], s["base"], seed=SEED,
                             steps=2)
    padded = BatchedLLMEngine(s["task"], s["cfg"], s["base"], seed=SEED,
                              steps=2, pad_to=5)
    init_pad = [t[3:].clone() for t in tree_leaves(padded.adapters)]
    a, b = plain.run(), padded.run()
    np.testing.assert_allclose(b.losses, a.losses, atol=1e-5)
    np.testing.assert_allclose(b.f1, a.f1, atol=0.05)
    np.testing.assert_allclose(b.teacher, a.teacher, atol=1e-5)
    for g, p0, pf in zip(tree_leaves(padded.a_g), init_pad,
                         tree_leaves(padded.adapters)):
        want = 0.75 * p0 + 0.25 * g[None]
        torch.testing.assert_close(pf[3:], want, atol=1e-6, rtol=0)


def test_fedavg_and_blend_match_jax():
    rng = np.random.default_rng(0)
    stacked = [{"a": rng.standard_normal((4, 3, 2)).astype(np.float32)}]
    w = np.asarray([3.0, 1.0, 2.0, 0.0], np.float32)
    got = lora.weighted_average_stacked(convert.from_jax(stacked),
                                        torch.from_numpy(w))
    want = jlora.weighted_average_stacked(stacked, jnp.asarray(w))
    np.testing.assert_allclose(got[0]["a"].numpy(), np.asarray(want[0]["a"]),
                               atol=1e-6)
    blended = lora.blend_adapters(convert.from_jax(stacked), got, 0.25)
    jb = jlora.blend_adapters(stacked, want, 0.25)
    np.testing.assert_allclose(blended[0]["a"].numpy(),
                               np.asarray(jb[0]["a"]), atol=1e-6)




def _carried_adapters(s, n):
    """JAX's adapter inits of clients ``0..n-1``, carried across."""
    return convert.adapters_from_jax(
        _tolist(jax.vmap(lambda k: JM.init_adapters(s["jcfg"], k,
                                                    s["jbase"]))(
            jax.vmap(jllmc.llm_key, in_axes=(None, 0, None))(
                jllmc.llm_root(SEED), jnp.arange(n), jllmc.LLM_INIT_STEP))),
        stacked=True)


def test_stage_over_eight_shards(setup, runs):
    """The clients axis: C=3 over 8 CPU shards (5 inert clients) is
    bitwise the one-device stage padded to 8, adapters, AdamW state and
    teacher ``a_g`` included, and holds to the JAX stage at the stage
    tolerances."""
    s = setup
    _, jout, _, _ = runs
    outs, engines = [], []
    for kw in (dict(n_devices=8), dict(pad_to=8)):
        eng = BatchedLLMEngine(s["task"], s["cfg"], s["base"], seed=SEED,
                               steps=STEPS, **kw)
        eng.adapters = _carried_adapters(s, 8)
        outs.append(eng.run())
        engines.append(eng)
    (shard, pad), (shard_eng, pad_eng) = outs, engines
    assert len(shard_eng.devices) == 8 and len(pad_eng.devices) == 1
    for f in ("losses", "f1", "teacher", "final_train_loss"):
        np.testing.assert_array_equal(getattr(shard, f), getattr(pad, f),
                                      err_msg=f)
    for tree_a, tree_b in ((shard_eng.adapters, pad_eng.adapters),
                           (shard_eng.opt_state, pad_eng.opt_state),
                           (shard_eng.a_g, pad_eng.a_g)):
        for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            assert torch.equal(a, b)
    np.testing.assert_allclose(shard.losses, jout.losses, atol=5e-4)
    np.testing.assert_allclose(shard.f1, jout.f1, atol=0.05)
    np.testing.assert_allclose(shard.teacher, np.asarray(jout.teacher),
                               atol=5e-4)
