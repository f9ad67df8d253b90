"""The dry run's sharding specs in the port against the JAX package's.

``repro_torch.distributed.sharding``'s model-parallel half is compared
with ``repro.distributed.sharding`` as tuples of axis names: its
``param_specs`` on the port's unrolled layout (layer ``g·P + p`` against
JAX's ``groups[p]`` less its leading group entry) for the base, the
adapters and AdamW's moments of every registry config (the 10 assigned
and the 4 paper ones) at full width, at the ``single`` (16, 16) and
``multi`` (2, 16, 16) axis sizes, and for a QLoRA base; ``batch_specs``
and ``cache_specs`` of every shape's ``input_specs``.  JAX's trees come
from ``jax.eval_shape``, as its dry run takes them; the port's are
``meta`` tensors.  Also ``pairs()``, ``input_specs``' shapes and dtypes,
and the cases of ``tests/test_sharding.py``, mirrored.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.distributed import sharding as jshd
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import random as jr
from repro_torch.configs import registry as treg
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models import model as M
from repro_torch.optim import adamw

MESHES = {"single": (("data", "model"), {"data": 16, "model": 16}),
          "multi": (("pod", "data", "model"),
                    {"pod": 2, "data": 16, "model": 16})}
NAMES = treg.all_names()
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}


def jspecs_of(tree, names, sizes):
    return jshd.param_specs(tree, names, sizes)


def jax_trees(cfg):
    def init(k):
        p = JM.init_params(cfg, k)
        return p, JM.init_adapters(cfg, k, p)
    p, a = jax.eval_shape(init, jax.random.PRNGKey(0))
    return p, a, jax.eval_shape(jadamw.init, a)


def port_trees(cfg):
    p = M.init_params(cfg, jr.PRNGKey(0), device="meta")
    a = M.init_adapters(cfg, jr.PRNGKey(1), p)
    return p, a, adamw.init(a)


def as_tuple(spec):
    return tuple(spec)


def compare_layers(port, jax_groups, period: int, what: str):
    """Port layer ``g·P + p``'s specs against JAX's ``groups[p]`` less the
    leading group entry."""
    assert len(port) % period == 0
    for i, layer in enumerate(port):
        jl = jax_groups[i % period]
        assert set(layer) == set(jl), (what, i)
        for k, s in layer.items():
            want = tuple(jl[k])[1:]
            assert as_tuple(s) == want, (what, i, k, s, jl[k])


def compare_params(port, jtree, period: int, what: str):
    for k, v in jtree.items():
        if k in ("groups", "enc_groups"):
            pk = "layers" if k == "groups" else "enc_layers"
            compare_layers(port[pk], v, period, what + "." + k)
        else:
            assert as_tuple(port[k]) == tuple(v), (what, k, port[k], v)


def adapter_layers(cfg, a):
    """The port's adapters as ``{"layers", "enc_layers"}``."""
    return a if cfg.encoder_decoder else {"layers": a}


@pytest.fixture(scope="module")
def trees():
    cache = {}

    def build(name, qlora=False):
        key = (name, qlora)
        if key not in cache:
            jcfg, tcfg = jreg.get(name), treg.get(name)
            if qlora:
                jcfg = dataclasses.replace(jcfg, lora=dataclasses.replace(
                    jcfg.lora, quantize_base=True))
                tcfg = dataclasses.replace(tcfg, lora=dataclasses.replace(
                    tcfg.lora, quantize_base=True))
            cache[key] = (jcfg, tcfg, jax_trees(jcfg), port_trees(tcfg))
        return cache[key]
    return build


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_jax(trees, name):
    """Base, adapters and AdamW's first and second moments, at both mesh
    sizes: every leaf's spec equals JAX's."""
    jcfg, tcfg, (jp, ja, jo), (tp, ta, to) = trees(name)
    period = len(tcfg.pattern)
    for mesh, (names, sizes) in MESHES.items():
        compare_params(shd.param_specs(tp, names, sizes),
                       jspecs_of(jp, names, sizes), period, f"{mesh} base")
        for what, port, jt in (("adapters", ta, ja), ("mu", to.mu, jo.mu),
                               ("nu", to.nu, jo.nu)):
            compare_params(adapter_layers(tcfg, shd.param_specs(
                port, names, sizes)), jspecs_of(jt, names, sizes), period,
                f"{mesh} {what}")


@pytest.mark.parametrize("name", ["llama3-405b", "whisper-large-v3"])
def test_qlora_param_specs_match_jax(trees, name):
    """A QLoRA base (``__q`` packed bytes, ``__s`` scales) and its
    adapters: every spec equals JAX's at both mesh sizes."""
    jcfg, tcfg, (jp, ja, _), (tp, ta, _) = trees(name, qlora=True)
    assert any(k.endswith("__q") for k in tp["layers"][0])
    period = len(tcfg.pattern)
    for mesh, (names, sizes) in MESHES.items():
        compare_params(shd.param_specs(tp, names, sizes),
                       jspecs_of(jp, names, sizes), period, f"{mesh} qlora")
        compare_params(adapter_layers(tcfg, shd.param_specs(ta, names,
                                                            sizes)),
                       jspecs_of(ja, names, sizes), period,
                       f"{mesh} qlora adapters")


@pytest.mark.parametrize("name", treg.assigned_names())
def test_input_specs_batch_and_cache_specs_match_jax(name):
    """Every shape's ``input_specs``: shapes and dtypes as JAX's; the
    batch's and (decode) the cache's specs as JAX's at both mesh sizes,
    the cache's group entry dropped."""
    jcfg, tcfg = jreg.get(name), treg.get(name)
    for sname, shape in INPUT_SHAPES.items():
        js, ts = JM.input_specs(jcfg, J_SHAPES[sname]), \
            M.input_specs(tcfg, shape)
        if shape.kind != "decode":
            assert list(js) == list(ts)
            for k in js:
                assert tuple(ts[k].shape) == js[k].shape
                assert ts[k].dtype == DTYPES[js[k].dtype.type]
            for names, _ in MESHES.values():
                tb, jb = shd.batch_specs(ts, names), \
                    jshd.batch_specs(js, names)
                assert {k: tuple(v) for k, v in tb.items()} == \
                    {k: tuple(v) for k, v in jb.items()}
            continue
        assert tuple(ts["token"].shape) == js["token"].shape
        assert ts["pos"].dim() == 0 and ts["pos"].dtype == torch.int32
        for names, sizes in MESHES.values():
            jt = jshd.batch_specs({"token": js["token"]}, names)["token"]
            tt = shd.batch_specs({"token": ts["token"]}, names)["token"]
            assert tuple(tt) == tuple(jt)
            jc = jshd.cache_specs(js["cache"], names, shape.global_batch,
                                  sizes)
            tc = shd.cache_specs(ts["cache"], names, shape.global_batch,
                                 sizes, n_groups=tcfg.n_groups)
            compare_cache(tcfg, tc, jc, ts["cache"], js["cache"])


def compare_cache(cfg, port, jspec, pcache, jcache):
    """The port's unrolled cache specs (and shapes) against JAX's stacked
    ones: layer ``g·P + p``'s leaf against ``groups[p]``'s less its
    group entry."""
    P_ = len(cfg.pattern)
    if cfg.encoder_decoder:
        pairs = [(port[0], jspec[0], pcache[0], jcache[0]),
                 (port[1], jspec[1], pcache[1], jcache[1])]
    else:
        pairs = [(port, jspec, pcache, jcache)]
    for ps, js, pc, jc in pairs:
        for i, (layer, clayer) in enumerate(zip(ps, pc)):
            jl, jcl = js[i % P_], jc[i % P_]
            jl = jl if isinstance(jl, tuple) else (jl,)
            jcl = jcl if isinstance(jcl, tuple) else (jcl,)
            assert len(layer) == len(jl)
            for s, t, want, wt in zip(layer, clayer, jl, jcl):
                assert tuple(t.shape) == wt.shape[1:]
                assert tuple(s) == tuple(want)[1:], (i, s, want)


def test_pairs_match_jax():
    assert treg.pairs() == jreg.pairs()
    assert treg.pairs(include_skipped=True) == jreg.pairs(
        include_skipped=True)
    assert len(treg.pairs()) == 39
    assert treg.assigned_names() == jreg.assigned_names()


# -- tests/test_sharding.py's cases, mirrored ---------------------------
def test_fit_divisibility_drops_bad_axes():
    spec = shd._fit_divisibility(P("model", "data"), (51866, 1280),
                                 {"model": 16, "data": 16})
    assert spec == P(None, "data")


def test_fit_divisibility_tuple_axes():
    spec = shd._fit_divisibility(P(("pod", "data")), (64,),
                                 {"pod": 2, "data": 16})
    assert spec == P(("pod", "data"))
    spec = shd._fit_divisibility(P(("pod", "data")), (48,),
                                 {"pod": 2, "data": 16})
    assert spec == P("pod")


def test_filter_axes_removes_missing():
    assert shd._filter_axes(P("pod", "model"), ("data", "model")) == \
        P(None, "model")


def test_param_specs_cover_tree():
    cfg = treg.get("stablelm-3b-smoke")
    p = M.init_params(cfg, jr.PRNGKey(0), device="meta")
    specs = shd.param_specs(p, ("data", "model"))
    flat = []
    shd.map_specs(lambda s, x: flat.append((s, x)), specs, p)
    assert len(flat) == len(jax.tree.leaves(
        JM.init_params(jreg.get("stablelm-3b-smoke"),
                       jax.random.PRNGKey(0))))
    for s, x in flat:
        assert isinstance(s, P) and len(s) <= x.dim()


def test_param_specs_embed_rule():
    cfg = treg.get("stablelm-3b-smoke")
    p = M.init_params(cfg, jr.PRNGKey(0), device="meta")
    specs = shd.param_specs(p, ("data", "model"), {"data": 2, "model": 2})
    assert specs["embed"] == P("model", "data")


def test_lora_specs_follow_targets():
    assert shd._leaf_spec("wq_lora_a", (512, 16), False) == P("data", None)
    assert shd._leaf_spec("wq_lora_b", (16, 512), False) == P(None, "model")


def test_batch_specs():
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "pos": torch.zeros((), dtype=torch.int32)}
    specs = shd.batch_specs(batch, ("pod", "data", "model"))
    assert specs["tokens"] == P(("pod", "data"), None)
    assert specs["pos"] == P()


def test_cache_specs_divisibility():
    """JAX's stacked ``(G, B, S, KH, D)`` case as the port's unrolled
    leaves with ``n_groups=4``."""
    cache = (torch.empty((128, 32768, 8, 64), device="meta"),
             torch.empty((128, 1500, 8, 64), device="meta"))
    specs = shd.cache_specs(cache, ("data", "model"), 128,
                            {"data": 16, "model": 16}, n_groups=4)
    assert specs[0] == P("data", "model", None, None)
    assert specs[1] == P("data", None, None, None)


def test_constrain_noop_outside_mesh():
    x = torch.ones((4, 4))
    assert shd.constrain(x, P("data", None)) is x


def test_spec_prints_and_compares_as_jax():
    assert repr(P("data", None)) == "P('data', None)"
    assert tuple(P(("pod", "data"), "model")) == \
        tuple(JP(("pod", "data"), "model"))
    assert shd._scalar_axis(("data",)) == "data"
