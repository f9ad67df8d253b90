"""The recurrent families' train step, base draw, caches and QLoRA base
in the port against the JAX package: ``jamba-1.5-large-398b`` and
``xlstm-125m``, each ``-smoke`` (``tests/test_torch_recurrent_serve.py``
serves them): one ``make_train_step`` of two clients against JAX's step
of each in float32 (the loss within 1e-5, AdamW's first moment within
1e-5 of its largest magnitude, ``tests/test_torch_families_serve.py``'s
bounds), the base drawn under JAX's key tree (the draw's contract of
``tests/torch_families.py``), the decode caches carried across bit for
bit, and QLoRA packing jamba's 2-D targets alone, bitwise JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.peft import lora as jlora
from repro_torch import convert
from repro_torch.configs.registry import get as tget
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.peft import lora
from repro_torch.tree import tree_leaves
from torch_families import DRAW_SAME, KEY, draw_gaps, np_tree, smoke_model

torch.set_num_threads(1)

NAMES = ["jamba-1.5-large-398b", "xlstm-125m"]
B = 2


@pytest.fixture(scope="module")
def models():
    """Each name's float32 ``-smoke`` model (``smoke_model``), drawn once."""
    cache = {}

    def build(name):
        if name not in cache:
            cache[name] = smoke_model(name, "float32")
        return cache[name]
    return build


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(models, name):
    """One ``make_train_step`` of two clients stacked against JAX's step
    of each (float32): the loss (jamba's with its MoE balance term), the
    adapter gradients' AdamW first moment (0.1 × the gradient) within
    1e-5 of the largest magnitude; sLSTM layers hold no adapter."""
    m = models(name)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(5)
    C, S = 2, 16
    jadp = [jax.tree.map(lambda x: x + 0.01 * c, m["ja"]) for c in range(C)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jadp)
    tadp = convert.adapters_from_jax(np_tree(stacked), stacked=True)
    if tcfg.xlstm:
        assert tadp[1] == {} and sorted(tadp[0]) == ["wq_lora_a",
                                                     "wq_lora_b"]
    tokens = rng.integers(4, tcfg.vocab_size - 4, (C, B, S)).astype(np.int32)
    labels = rng.integers(4, tcfg.vocab_size - 4, (C, B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    _, new_opt, metrics = M.make_train_step(tcfg, lr=3e-3)(
        m["tp"], tadp, adamw.init(tadp, n_clients=C), batch)
    jstep = jax.jit(JM.make_train_step(jcfg, lr=3e-3,
                                       opts=JM.FwdOptions(remat=False)))
    for c in range(C):
        _, jo, jmet = jstep(m["jp"], jadp[c], jadamw.init(jadp[c]),
                            {"tokens": jnp.asarray(tokens[c]),
                             "labels": jnp.asarray(labels[c])})
        assert abs(float(metrics["loss"][c]) - float(jmet["loss"])) <= 1e-5
        want = tree_leaves(convert.adapters_from_jax(np_tree(jo.mu)))
        got = tree_leaves(new_opt.mu)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = g[c].numpy(), w.numpy()
            assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("name", NAMES)
def test_init_params_follow_jax_key_tree(name):
    """The port's own base draw: JAX's leaf names, shapes and dtypes
    (float32 recurrent leaves under the bfloat16 base), its values to the
    draw's contract (``tests/torch_families.py``), and adapters on the
    2-D targets only (none on an sLSTM layer)."""
    jcfg, tcfg = jget(name + "-smoke"), tget(name + "-smoke")
    jp = JM.init_params(jcfg, KEY)
    tp = M.init_params(tcfg, np.asarray(KEY), device="cpu")
    want = convert.params_from_jax(np_tree(jp))
    n = same = 0
    for gl, wl in zip(tp["layers"] + [tp], want["layers"] + [want]):
        a, b = draw_gaps({k: v for k, v in gl.items() if k != "layers"},
                         {k: v for k, v in wl.items() if k != "layers"})
        n, same = n + a, same + b
    assert same >= DRAW_SAME * n
    for layer in tp["layers"]:
        for k in ("dt_b", "A_log", "D", "w_if", "b_if", "r_gates",
                  "b_gates"):
            if k in layer:
                assert layer[k].dtype == torch.float32, k
    ta = M.init_adapters(tcfg, np.asarray(KEY), tp)
    ja = convert.adapters_from_jax(np_tree(JM.init_adapters(jcfg, KEY, jp)))
    for gl, wl in zip(ta, ja):
        assert sorted(gl) == sorted(wl)
        assert all(gl[k].dim() == 2 for k in gl)
    if tcfg.xlstm:
        assert ta[1] == {}


@pytest.mark.parametrize("name", NAMES)
def test_cache_from_jax_carries_the_recurrent_states(name):
    """JAX's group-stacked decode cache (tuples of 2 and 4) → one tuple a
    layer, bit for bit."""
    jcfg = jget(name + "-smoke")
    jc = JM.init_cache(jcfg, 2, 5)
    rng = np.random.default_rng(8)
    jc = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape),
                                            x.dtype), jc)
    got = convert.cache_from_jax(np_tree(jc))
    P = len(jcfg.pattern)
    assert len(got) == jcfg.n_layers
    want = M.init_cache(tget(name + "-smoke"), 2, 5, device="cpu")
    for i, tup in enumerate(got):
        assert len(tup) == len(jc[i % P]) == len(want[i])
        for j, t in enumerate(tup):
            assert t.dtype == want[i][j].dtype
            assert t.shape == want[i][j].shape
            w = np.asarray(jc[i % P][j][i // P])
            np.testing.assert_array_equal(
                t.view(torch.int16 if t.dtype == torch.bfloat16
                       else torch.int32).numpy(),
                w.view(np.int16 if w.dtype.itemsize == 2 else np.int32))


def test_qlora_packs_only_the_2d_targets_of_jamba(models):
    """QLoRA on jamba-smoke: the 2-D targets (attention's wq, wkv, wo,
    the MLPs' w_in, w_out) are packed, bitwise JAX's packing of the same
    weights; the Mamba leaves and the 3-D expert stacks stay as they
    are, as in JAX's ``quantize_stacked_groups``."""
    m = models("jamba-1.5-large-398b")
    jcfg, jp = m["jcfg"], m["jp"]
    jq = jlora.quantize_stacked_groups(jp, jcfg.lora.targets)
    tp = convert.params_from_jax(np_tree(jp))
    want = convert.params_from_jax(np_tree(jq))
    got = lora.quantize_stacked_groups(tp, jcfg.lora.targets)
    for gl, wl in zip(got["layers"], want["layers"]):
        assert sorted(gl) == sorted(wl)
        for k, w in wl.items():
            assert torch.equal(gl[k], w), k
        if "in_proj" in gl:
            assert "in_proj__q" not in gl and "x_proj" in gl
        if "router" in gl:
            assert gl["w_in"].dim() == 3 and "w_in__q" not in gl
        elif "w_in__q" in gl:
            assert "w_in" not in gl and "w_out__q" in gl
