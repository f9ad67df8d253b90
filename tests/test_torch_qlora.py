"""The port's QLoRA path against the JAX package's, on the CPU.

Same seeded numpy inputs through both packages:

  - ``quantize``'s packed bytes and scales are bitwise JAX's, and so is
    ``dequantize`` in float32 and bf16 (the nibble layout, the
    half-to-even rounding and the clip included);
  - the plain versions ``ref.int4_matmul`` / ``int4_matmul_t`` /
    ``distill_kl`` against the JAX kernels (interpret mode, as
    ``tests/test_kernels.py`` runs them) at the JAX sweep's tolerances;
  - ``init_params`` of a QLoRA ``tiny-llm``: packed structure, carried
    across bitwise, and the port's own draw against JAX's (the share of
    equal packed bytes measured at 1.0 for both keys below; the test
    requires 0.999, since the port's draws are within 2 ulp of JAX's);
  - QLoRA adapters equal LoRA adapters of the same key;
  - ``forward`` within 1e-5, one train step's losses, gradients and
    AdamW update within the tolerances of ``tests/test_torch_models.py``;
  - ``BatchedLLMEngine`` on 3 clients × 3 steps: L_LLM and teacher
    within 5e-4, F1 within 0.05 (``tests/test_batched_llm.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.core import llm_client as jllmc
from repro.core.batched_llm import BatchedLLMEngine as JEngine
from repro.data.tasks import build_task as jbuild_task
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.peft import lora as jlora
from repro_torch import convert
from repro_torch import random as jr
from repro_torch.configs import paper_models as tpm
from repro_torch.core import llm_client as llmc
from repro_torch.core.batched_llm import BatchedLLMEngine
from repro_torch.data.tasks import build_task
from repro_torch.kernels import ops, ref
from repro_torch.models import common
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.peft import lora
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

V, C, B, S = 4102, 2, 3, 64
FWD = JM.FwdOptions(remat=False)
TARGETS = ("wq", "wkv", "wo", "w_in", "w_out")
# the JAX kernel sweep's (K, N) and the tiny-llm projections'
QSHAPES = [(256, 256), (512, 384), (128, 512), (128, 128), (128, 256),
           (256, 128)]


def _tolist(tree):
    return jax.tree.map(np.asarray, tree)


def _qlora(cfg):
    return dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, quantize_base=True))


def _weights(shape, seed, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("K,N", QSHAPES)
@pytest.mark.parametrize("block", [32, 64])
def test_quantize_bitwise(K, N, block):
    w = _weights((K, N), K + N + block)
    w[0, :block] = 0.0                     # an all-zero block: clamped scale
    w[1, 0] = w[1, 1:block].max() * 3.5    # a tie at the absmax
    jq, js = jlora.quantize(jnp.asarray(w), block)
    q, s = lora.quantize(torch.from_numpy(w), block)
    assert q.dtype == torch.uint8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_bitwise(dtype):
    """Every one of the 16 nibble values in both halves of a byte."""
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    packed[0, :16] = np.arange(16) * 17            # lo == hi, 0..15
    packed[1, :16] = np.arange(16) | (15 - np.arange(16)) << 4
    scales = rng.uniform(1e-3, 1.0, (64, 6)).astype(np.float32)
    want = jlora.dequantize(jnp.asarray(packed), jnp.asarray(scales), 32,
                            dtype=getattr(jnp, dtype))
    got = lora.dequantize(torch.from_numpy(packed), torch.from_numpy(scales),
                          32, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    bits = np.int16 if dtype == "bfloat16" else np.int32
    np.testing.assert_array_equal(
        got.view(getattr(torch, bits.__name__)).numpy(),
        np.asarray(want).view(bits))


def test_dequantize_default_is_bf16():
    q, s = lora.quantize(torch.from_numpy(_weights((8, 64), 0)))
    assert lora.dequantize(q, s).dtype == torch.bfloat16


def test_quantize_layer_flat_and_tree():
    rng = np.random.default_rng(2)
    layer = {"wq": _weights((128, 128), 3), "w_odd": _weights((4, 96), 4),
             "wo": _weights((128, 96), 5), "ln": np.ones(128, np.float32)}
    targets = ("wq", "wo", "w_odd")
    want = jlora.quantize_layer_flat(
        {k: jnp.asarray(v) for k, v in layer.items()}, targets)
    got = lora.quantize_layer_flat(
        {k: torch.from_numpy(v) for k, v in layer.items()}, targets)
    assert list(got) == list(want)     # wo (96 wide) stays float32
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    tree = {"a": [{"wq": torch.from_numpy(layer["wq"])}],
            "b": torch.from_numpy(rng.standard_normal(3).astype(np.float32))}
    jtree = jlora.quantize_tree(
        {"a": [{"wq": jnp.asarray(layer["wq"])}],
         "b": jnp.asarray(tree["b"].numpy())}, ("wq",))
    qt = lora.quantize_tree(tree, ("wq",))
    for k in ("q", "s"):
        np.testing.assert_array_equal(qt["a"][0]["wq"][k].numpy(),
                                      np.asarray(jtree["a"][0]["wq"][k]))
    assert qt["b"] is tree["b"]


@pytest.mark.parametrize("M_,K,N", [(128, 256, 256), (64, 512, 384),
                                    (256, 128, 512)])
@pytest.mark.parametrize("block", [32, 64])
def test_ref_int4_matmul_matches_jax_kernel(M_, K, N, block):
    x = _weights((M_, K), 7, 1.0)
    packed, scales = jlora.quantize(jnp.asarray(_weights((K, N), 8)), block)
    want = jops.int4_matmul(jnp.asarray(x), packed, scales, qblock=block)
    got = ref.int4_matmul(torch.from_numpy(x),
                          torch.from_numpy(np.array(packed)),
                          torch.from_numpy(np.array(scales)), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the dispatch takes the plain version for a CPU tensor
    via_ops = ops.int4_matmul(torch.from_numpy(x),
                              torch.from_numpy(np.array(packed)),
                              torch.from_numpy(np.array(scales)), block)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


@pytest.mark.parametrize("M_,K,N", [(128, 256, 256), (64, 512, 384),
                                    (5, 128, 512)])
@pytest.mark.parametrize("block", [32, 64])
def test_ref_int4_matmul_t_matches_jax(M_, K, N, block):
    """dy @ dequant(W)ᵀ against JAX, and against autograd of the plain
    forward (the contract of the card's NT entry point)."""
    dy = _weights((M_, N), 9, 1.0)
    packed, scales = jlora.quantize(jnp.asarray(_weights((K, N), 10)), block)
    tp, ts = (torch.from_numpy(np.array(a)) for a in (packed, scales))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        w = jlora.dequantize(packed, scales, block, dtype=jdt)
        want = jnp.asarray(dy) @ w.astype(jnp.float32).T
        got = ref.int4_matmul_t(torch.from_numpy(dy), tp, ts, block,
                                round_to=tdt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        x = torch.zeros((M_, K), requires_grad=True)
        y = ref.int4_matmul(x, tp, ts, block, round_to=tdt)
        (dx,) = torch.autograd.grad(y, x, torch.from_numpy(dy))
        np.testing.assert_allclose(dx.numpy(), got.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_ref_int4_matmul_bf16_matches_jax_model_weight():
    """round_to=bf16 is the JAX model's ``dense(x, weight(...))``."""
    from repro.models.common import dense as jdense, weight as jweight
    x = _weights((40, 128), 11, 1.0)
    packed, scales = jlora.quantize(jnp.asarray(_weights((128, 256), 12)))
    want = jdense(jnp.asarray(x), jweight({"w__q": packed, "w__s": scales},
                                          "w"))
    got = ref.int4_matmul(torch.from_numpy(x),
                          torch.from_numpy(np.array(packed)),
                          torch.from_numpy(np.array(scales)), 64,
                          round_to=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B_,C_", [(64, 2), (256, 3), (512, 7), (100, 10),
                                   (12, 4102)])
def test_ref_distill_kl_matches_jax_kernel(B_, C_):
    rng = np.random.default_rng(B_ + C_)
    t = jax.nn.softmax(jnp.asarray(rng.standard_normal((B_, C_))
                                   .astype(np.float32)), -1)
    t = t.at[0].set(jax.nn.one_hot(0, C_))  # zeros below eps: clipped
    z = (rng.standard_normal((B_, C_)) * 3.0).astype(np.float32)
    want = jops.distill_kl(t, jnp.asarray(z))
    got = ref.distill_kl(torch.from_numpy(np.array(t)), torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (B_,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert (got.numpy() >= -1e-6).all()
    mean = ops.distill_kl_mean(torch.from_numpy(np.array(t)),
                               torch.from_numpy(z))
    assert float(mean) == pytest.approx(
        float(jops.distill_kl_mean(t, jnp.asarray(z))), rel=1e-5, abs=1e-6)


# ---------------------------------------------------------------------------
# the QLoRA model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    jcfg = _qlora(dataclasses.replace(jpm.TINY_LLM, vocab_size=V))
    tcfg = _qlora(dataclasses.replace(tpm.TINY_LLM, vocab_size=V))
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
    # the task's layout, as in tests/test_torch_models.py: one label
    # token per row, PAD after it
    tokens = rng.integers(4, V - 2, (C, B, S)).astype(np.int32)
    labels = np.full((C, B, S), -1, np.int32)
    for c in range(C):
        for b in range(B):
            pos = int(rng.integers(10, S - 1))
            tokens[c, b, pos + 1:] = 0
            labels[c, b, pos] = V - 2 + int(rng.integers(0, 2))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jadp=jadp,
                tparams=tparams, tadp=tadp, tokens=tokens, labels=labels)


def test_init_params_is_packed(setup):
    tp = M.init_params(setup["tcfg"], jr.PRNGKey(3), dtype=torch.float32,
                       device="cpu")
    for layer in tp["layers"]:
        assert not set(TARGETS) & set(layer)
        for n in TARGETS:
            q, s = layer[f"{n}__q"], layer[f"{n}__s"]
            assert q.dtype == torch.uint8 and s.dtype == torch.float32
            assert s.shape == (q.shape[0], 2 * q.shape[1] // lora.QBLOCK)
        assert layer["ln"].dtype == torch.float32
    assert tp["embed"].dtype == torch.float32


def test_params_carried_across_bitwise(setup):
    """``params_from_jax`` passes the packed uint8 leaves through."""
    jp, tp = setup["jparams"], setup["tparams"]
    for g in range(setup["tcfg"].n_layers):
        for name, arr in jp["groups"][0].items():
            got = tp["layers"][g][name]
            assert str(got.dtype).split(".")[1] == str(arr.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(arr[g]))


@pytest.mark.parametrize("seed", [3, 4])
def test_own_draw_packs_like_jax(setup, seed):
    """The port's own base draw (within 2 ulp of JAX's) quantizes to
    JAX's bytes on at least 99.9 % of packed bytes (1.0 measured)."""
    got = M.init_params(setup["tcfg"], jr.PRNGKey(seed), dtype=torch.float32,
                        device="cpu")
    want = convert.params_from_jax(_tolist(JM.init_params(
        setup["jcfg"], jax.random.PRNGKey(seed), dtype=jnp.float32)))
    equal = total = 0
    for gl, wl in zip(got["layers"], want["layers"]):
        assert sorted(gl) == sorted(wl)
        for n in TARGETS:
            a, b = gl[f"{n}__q"].numpy(), wl[f"{n}__q"].numpy()
            equal += int((a == b).sum())
            total += a.size
            np.testing.assert_allclose(gl[f"{n}__s"].numpy(),
                                       wl[f"{n}__s"].numpy(), rtol=3e-7)
    assert total > 0 and equal / total >= 0.999, equal / total


def test_quantize_per_layer_equals_quantize_after(setup):
    """``init_params`` packs each layer as it is drawn; that equals
    ``quantize_stacked_groups`` of the float32 base (the JAX package's
    quantize-after), which equals JAX's on a carried-across base."""
    cfg = dataclasses.replace(tpm.TINY_LLM, vocab_size=V)
    jbase = JM.init_params(dataclasses.replace(jpm.TINY_LLM, vocab_size=V),
                           jax.random.PRNGKey(3), dtype=jnp.float32)
    pairs = [
        (M.init_params(setup["tcfg"], jr.PRNGKey(3), dtype=torch.float32,
                       device="cpu"),
         lora.quantize_stacked_groups(
             M.init_params(cfg, jr.PRNGKey(3), dtype=torch.float32,
                           device="cpu"),
             TARGETS)),
        (convert.params_from_jax(_tolist(
            jlora.quantize_stacked_groups(jbase, TARGETS))),
         lora.quantize_stacked_groups(
             convert.params_from_jax(_tolist(jbase)), TARGETS))]
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for gl, wl in zip(got["layers"], want["layers"]):
            assert sorted(gl) == sorted(wl)
            for k in wl:
                torch.testing.assert_close(gl[k], wl[k], rtol=0, atol=0)


def test_qlora_adapters_equal_lora_adapters(setup):
    cfg = dataclasses.replace(tpm.TINY_LLM, vocab_size=V)
    base = M.init_params(cfg, jr.PRNGKey(5), dtype=torch.float32,
                         device="cpu")
    qbase = M.init_params(setup["tcfg"], jr.PRNGKey(5), dtype=torch.float32,
                          device="cpu")
    want = M.init_adapters(cfg, jr.PRNGKey(6), base)
    got = M.init_adapters(setup["tcfg"], jr.PRNGKey(6), qbase)
    assert [sorted(a) for a in got] == [sorted(a) for a in want]
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_weight_resolves_packed_and_dense_keeps_it_packed(setup):
    layer = setup["tparams"]["layers"][0]
    w = common.weight(layer, "w_in")
    assert isinstance(w, common.QWeight) and w.shape == (128, 512)
    assert w.packed is layer["w_in__q"] and w.block == lora.QBLOCK
    assert common.weight(layer, "ln") is layer["ln"]
    x = torch.from_numpy(_weights((2, 3, 128), 13, 1.0))
    y = common.dense(x, w)
    want = ref.int4_matmul(x.reshape(6, 128), w.packed, w.scales, 64,
                           round_to=torch.bfloat16).reshape(2, 3, 512)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert layer["w_in__q"].dtype == torch.uint8


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


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def test_train_step_matches_jax(setup):
    batch = {"tokens": torch.from_numpy(setup["tokens"]).long(),
             "labels": torch.from_numpy(setup["labels"]).long()}
    loss, grads = M.loss_and_grads(setup["tcfg"], setup["tparams"],
                                   setup["tadp"], batch)
    step = M.make_train_step(setup["tcfg"], lr=3e-3)
    new_adp, new_opt, metrics = step(setup["tparams"], setup["tadp"],
                                     adamw.init(setup["tadp"], n_clients=C),
                                     batch)
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
        for g, w in zip(tree_leaves(grads),
                        tree_leaves(convert.adapters_from_jax(_tolist(wg)))):
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


# ---------------------------------------------------------------------------
# the QLoRA fine-tuning stage
# ---------------------------------------------------------------------------
ENGINE_TASK = dict(n_clients=3, train_size=61, test_size=16, val_size=16,
                   seed=3)
ENGINE_STEPS, ENGINE_SEED = 3, 11


def test_engine_matches_jax():
    """The JAX base carried across, each engine drawing its own adapter
    init (within 2 ulp of each other)."""
    jtask = jbuild_task("genomic", **ENGINE_TASK)
    task = build_task("genomic", **ENGINE_TASK)
    jcfg = _qlora(jllmc.task_llm_config("tiny-llm", jtask.vocab_size,
                                        jtask.llm_seq_len))
    cfg = _qlora(llmc.task_llm_config("tiny-llm", task.vocab_size,
                                      task.llm_seq_len))
    jbase = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    base = convert.params_from_jax(_tolist(jbase))
    assert base["layers"][0]["wq__q"].dtype == torch.uint8
    jout = JEngine(jtask, jcfg, jbase, seed=ENGINE_SEED,
                   steps=ENGINE_STEPS).run()
    out = BatchedLLMEngine(task, cfg, base, seed=ENGINE_SEED,
                           steps=ENGINE_STEPS).run()
    np.testing.assert_allclose(out.losses, jout.losses, atol=5e-4)
    np.testing.assert_allclose(out.f1, jout.f1, atol=0.05)
    np.testing.assert_allclose(out.teacher, np.asarray(jout.teacher),
                               atol=5e-4)
    np.testing.assert_allclose(out.final_train_loss, jout.final_train_loss,
                               atol=5e-4)
    assert np.all(np.isfinite(out.losses))
