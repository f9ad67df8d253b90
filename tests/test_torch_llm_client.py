"""The port's sequential LLM stage (``LLMClient``, ``fedavg_adapters``,
``distill_to_global``, ``run_sequential_stage``) against the JAX
package's, and against the port's own ``BatchedLLMEngine``.

With the base and the initial adapters carried across by ``convert``,
one ``LLMClient`` (a stack of one client) fine-tunes, evaluates and
produces teacher probabilities within 1e-5 of JAX's ``LLMClient``;
FedAvg and the distillation blend agree within 1e-6.  The whole
sequential stage agrees with the batched engine on the same base within
the batched-LLM tolerances of ``tests/test_batched_llm.py`` (losses and
teacher 5e-4, F1 0.05, adapters 1e-3): the same draws, the same math,
one client a launch instead of all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import llm_client as jllmc
from repro.data.tasks import build_task as jbuild_task
from repro.models import model as JM
from repro_torch import convert
from repro_torch.core import llm_client as llmc
from repro_torch.core.batched_llm import BatchedLLMEngine
from repro_torch.data.tasks import build_task
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

STEPS, SEED = 4, 11
TASK = dict(n_clients=3, train_size=61, test_size=16, val_size=16, seed=3)


def _np(tree):
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
    base = convert.params_from_jax(_np(jbase))
    return dict(jtask=jtask, task=task, jcfg=jcfg, cfg=cfg, jbase=jbase,
                base=base)


def _client_pair(s, i):
    """JAX's and the port's LLMClient for client i, the port's carrying
    JAX's initial adapters."""
    jcl = jllmc.LLMClient(s["jcfg"], s["jbase"], jllmc.llm_root(SEED),
                          client_id=i, n_labels=s["jtask"].n_classes)
    cl = llmc.LLMClient(s["cfg"], s["base"], llmc.llm_root(SEED),
                        client_id=i, n_labels=s["task"].n_classes)
    own = cl.adapters
    cl.adapters = M.stack_clients([convert.adapters_from_jax(
        _np(jcl.adapters))])
    return jcl, cl, own


def _stacked_leaves(cl):
    return [t[0].numpy() for t in tree_leaves(cl.adapters)]


def _jax_leaves(adapters):
    return [t.numpy() for t in tree_leaves(convert.adapters_from_jax(
        _np(adapters)))]


@pytest.mark.parametrize("i", [0, 2])
def test_llm_client_matches_jax(setup, i):
    s = setup
    jcl, cl, own = _client_pair(s, i)
    for g, w in zip(tree_leaves(own), tree_leaves(cl.adapters)):
        ulps = np.abs(g.numpy().view(np.int32).astype(np.int64)
                      - w.numpy().view(np.int32).astype(np.int64))
        assert ulps.max() <= 2          # the port's own draw
    batch = s["task"].clients[i].llm_batch
    jbatch = s["jtask"].clients[i].llm_batch
    last = cl.fine_tune(batch, steps=STEPS)
    jlast = jcl.fine_tune(jbatch, steps=STEPS)
    assert cl._n_steps == jcl._n_steps == STEPS
    assert abs(last - jlast) <= 1e-5
    for g, w in zip(_stacked_leaves(cl), _jax_leaves(jcl.adapters)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert abs(cl.eval_loss(batch) - jcl.eval_loss(jbatch)) <= 1e-5
    assert cl.f1(batch) == pytest.approx(jcl.f1(jbatch), abs=1e-5)
    tp = cl.teacher_probs(batch)
    assert tp.shape == (s["task"].clients[i].n, s["task"].n_classes)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jcl.teacher_probs(
        jbatch)), atol=1e-5, rtol=0)


def test_fedavg_and_distill_to_global_match_jax(setup):
    s = setup
    rng = np.random.default_rng(0)
    pairs = [_client_pair(s, i)[:2] for i in range(3)]
    for jcl, cl in pairs:             # distinct random adapters
        noise = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), _np(jcl.adapters))
        jcl.adapters = jax.tree.map(jnp.asarray, noise)
        cl.adapters = M.stack_clients([convert.adapters_from_jax(noise)])
    w = [0.5, 0.2, 0.3000000001]
    a_g = llmc.fedavg_adapters([cl.adapters for _, cl in pairs], w)
    ja_g = jllmc.fedavg_adapters([jcl.adapters for jcl, _ in pairs], w)
    for g, want in zip([t[0].numpy() for t in tree_leaves(a_g)],
                       _jax_leaves(ja_g)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, want, atol=1e-6, rtol=0)
    a_g = llmc.distill_to_global([cl for _, cl in pairs], w, rho=0.25)
    jllmc.distill_to_global([jcl for jcl, _ in pairs], w, rho=0.25)
    for jcl, cl in pairs:
        for g, want in zip(_stacked_leaves(cl), _jax_leaves(jcl.adapters)):
            np.testing.assert_allclose(g, want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def stages(setup):
    s = setup
    seq = llmc.run_sequential_stage(s["task"], s["cfg"], s["base"],
                                    seed=SEED, steps=STEPS)
    eng = BatchedLLMEngine(s["task"], s["cfg"], s["base"], seed=SEED,
                           steps=STEPS)
    return seq, eng, eng.run()


def test_sequential_stage_matches_batched_engine(setup, stages):
    (clients, losses, f1s, teachers), eng, out = stages
    assert len(clients) == len(losses) == len(f1s) == len(teachers) == 3
    np.testing.assert_allclose(losses, out.losses, atol=5e-4)
    np.testing.assert_allclose(f1s, out.f1, atol=0.05)
    for i, t in enumerate(teachers):
        n = setup["task"].clients[i].n
        assert t.shape == (n, setup["task"].n_classes)
        np.testing.assert_allclose(t.numpy(), out.teacher[i, :n], atol=5e-4)
        np.testing.assert_allclose(t.sum(-1).numpy(), 1.0, atol=1e-5)
    for i, cl in enumerate(clients):
        assert cl._n_steps == STEPS
        for g, w in zip(tree_leaves(cl.adapters),
                        tree_leaves(eng.adapters)):
            np.testing.assert_allclose(g[0].numpy(), w[i].numpy(),
                                       atol=1e-3)


def test_sequential_stage_matches_jax_stage(setup, stages):
    """Each package drawing its own adapters on the same base: the JAX
    stage within the batched-LLM tolerances."""
    s = setup
    (_, losses, f1s, teachers), _, _ = stages
    _, jlosses, jf1s, jteachers = jllmc.run_sequential_stage(
        s["jtask"], s["jcfg"], s["jbase"], seed=SEED, steps=STEPS)
    np.testing.assert_allclose(losses, jlosses, atol=5e-4)
    np.testing.assert_allclose(f1s, jf1s, atol=0.05)
    for t, jt in zip(teachers, jteachers):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=5e-4)
