"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

- Exact integers: ``model_flops``, ``default_n_micro`` (at the single
  and multi meshes' data-parallel sizes) and ``decode_window`` equal the
  JAX package's for all 39 pairs.  JAX's values, and JAX's FLOPs below,
  come from ONE subprocess: importing ``repro.launch.dryrun`` forces 512
  host devices through ``XLA_FLAGS``, which must not reach this process.
- FLOP parity on one device: on a (1, 1) mesh the port's per-device
  FLOPs of a smoke train step (B = 4, S = 64, nm = 2, remat) equal
  JAX's ``weighted_hlo_cost(...)["flops"]`` of the same compiled step
  within 1 %, once attention is counted as each side computes it.  JAX
  counts only ``dot`` ops; its chunked jnp flash multiplies every
  (query, key) pair of its 512-row chunks (here one chunk: all S² pairs),
  2 dots forward (QKᵀ over D, PV over Dv), recomputed once under remat,
  and 4 backward (dP and dV over Dv, dQ and dK over D): 8·S²·(D + Dv)
  a head and sequence.  The port's flash kernel is counted by
  ``kernels/counts.py`` over the causal pairs S(S+1)/2 only:
  2·(D + Dv) a pair forward, twice under remat, and (6D + 4Dv) a pair
  backward (it recomputes S = QKᵀ).  The test swaps the port's kernel
  attention term for JAX's; what remains (every projection, the LoRA
  terms, their gradients, the loss head) must agree to 1 %.
- The trace on small fake meshes: stablelm-3b-smoke's train, prefill
  and decode on (1, 1) and (2, 2), minicpm3-4b-smoke's (MLA) train on
  (2, 2): ``status`` ok; the argument bytes equal the local shards'
  bytes computed from the specs; a whole nm = 2 step
  (``make_train_step``) has exactly twice one microbatch's FLOPs and
  collective bytes plus the update's (less the loss metric's 4-byte
  all-reduces, which DTensor places where a partial scalar is first
  read); one column-parallel projection's
  all-gathers equal a hand count; the kernels' abstract branch gives the
  plain versions' shapes and dtypes; the workspace planners give
  hand-computed sizes; a recurrence extrapolated from its first steps
  counts what tracing every step counts.  Each fake process group is set up and torn down
  inside its test.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get, pairs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import counts, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int4_matmul as i4
from repro_torch.kernels import lora_matmul as lm
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_mesh, make_local_mesh

ROOT = Path(__file__).resolve().parent.parent
FLOP_NAMES = ("stablelm-3b-smoke", "minicpm3-4b-smoke")
B, S, NM = 4, 64, 2
TRAIN = InputShape("t", S, B, "train")

JAX_SIDE = r"""
import json, sys
import repro.launch.dryrun as D            # forces 512 host devices
import jax
from repro.configs.base import INPUT_SHAPES, InputShape
from repro.configs.registry import get, pairs
from repro.launch import hlo_analysis as hlo
out = {"pairs": [], "flops": {}}
for a, s in pairs():
    cfg, shape = get(a), INPUT_SHAPES[s]
    out["pairs"].append([a, s, D.model_flops(cfg, shape),
                         D.default_n_micro(a, 16, shape.global_batch),
                         D.default_n_micro(a, 32, shape.global_batch),
                         D.decode_window(cfg, s)])
B, S, NM = map(int, sys.argv[1:4])
mesh = jax.make_mesh((1, 1), ("data", "model"))
for name in sys.argv[4:]:
    cfg = get(name)
    with jax.set_mesh(mesh):
        fn, args, _ = D.build_step(cfg, InputShape("t", S, B, "train"), mesh,
                                   n_micro=NM)
        txt = fn.lower(*args).compile().as_text()
    out["flops"][name] = hlo.weighted_hlo_cost(
        txt, inner_mult_cutoff=cfg.n_groups * NM)["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(B), str(S), str(NM),
         *FLOP_NAMES], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_integers_match_jax(jax_side):
    assert len(jax_side["pairs"]) == 39
    for a, s, mf, nm16, nm32, win in jax_side["pairs"]:
        cfg, shape = get(a), INPUT_SHAPES[s]
        assert (a, s) in pairs()
        assert D.model_flops(cfg, shape) == mf, (a, s)
        assert D.default_n_micro(a, 16, shape.global_batch) == nm16
        assert D.default_n_micro(a, 32, shape.global_batch) == nm32
        assert D.decode_window(cfg, s) == win, (a, s)


def attention_shapes(cfg):
    """(H, D, Dv) of each layer's self-attention."""
    if cfg.mla:
        m = cfg.mla
        return cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim, \
            m.v_head_dim
    return cfg.n_heads, cfg.head_dim, cfg.head_dim


@pytest.mark.parametrize("name", FLOP_NAMES)
def test_flops_match_jax_on_one_device(jax_side, name):
    cfg = get(name)
    with make_local_mesh() as mesh:
        rec = D.run_traced(cfg, TRAIN, mesh, n_micro=NM)
    kern = rec["cost"]["kernels"]
    H, Dq, Dv = attention_shapes(cfg)
    b = B // NM
    port_attn = NM * (kern["flash_attention"]["flops"]
                      + kern["flash_attention_bwd"]["flops"])
    pairs_c = counts.attn_pairs(S)
    # the kernel's causal counts, as the tally has them (a v head dim
    # under q's is zero-padded to it for the kernel: MLA's 32 under 48)
    assert kern["flash_attention"]["flops"] == \
        2 * cfg.n_layers * b * H * 2 * (2 * Dq) * pairs_c
    jax_attn = NM * cfg.n_layers * b * H * 8 * S * S * (Dq + Dv)
    port = rec["cost"]["flops_per_device"] - port_attn + jax_attn
    port -= NM * (recomputed_w_out(cfg, b * S) + lora_reuse(cfg, b * S))
    want = jax_side["flops"][name]
    assert abs(port - want) <= 0.01 * want, (port, want)


def projections(cfg):
    """(K, N, takes dx) of each adapted projection of a one-layer
    ``-smoke`` model, from its adapters' shapes: the attention's first
    projections read the embedding's norm, which needs no gradient."""
    p, a = D.abstract_model(cfg)
    first = {"wq", "wkv", "wq_a", "wkv_a"}
    out = []
    for layer in a:
        for k, t in layer.items():
            if k.endswith("_lora_a"):
                n = k[:-len("_lora_a")]
                out.append((t.shape[0], layer[n + "_lora_b"].shape[1],
                            n not in first))
    return out


def recomputed_w_out(cfg, M):
    """The remat recompute of the group's last projection, ``w_out``:
    its output feeds no gradient, so XLA drops it and the port's
    ``checkpoint`` runs it (one ``lora_matmul`` launch)."""
    K, N = cfg.d_ff, cfg.d_model
    return counts.lora_flops_bytes(1, M, K, N, cfg.lora.rank)[0]


def lora_reuse(cfg, M):
    """Products XLA takes once where the port takes them twice: ``x@A``
    (the forward's, again in dB) for every adapted projection and
    ``dy@Bᵀ`` (inside the dx launch, again in dA) where dx is taken."""
    r = cfg.lora.rank
    return sum(2 * M * K * r + (2 * M * N * r if dx else 0)
               for K, N, dx in projections(cfg))


def local_bytes(tree, specs, sizes):
    total = []
    shd.map_specs(lambda s, x: total.append(
        math.prod(x.shape) // math.prod(
            sizes.get(a, 1) for e in s if e is not None
            for a in (e if isinstance(e, tuple) else (e,)))
        * x.element_size()), specs, tree)
    return sum(total)


def argument_bytes(cfg, shape, mesh_shape):
    """The arguments' local bytes from the specs, computed here."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    names = ("data", "model")
    sizes = dict(zip(names, mesh_shape))
    p, a = D.abstract_model(cfg)
    a = tree_map(lambda t: t[None], a)
    n = local_bytes(p, shd.param_specs(p, names, sizes), sizes)
    aspecs = shd.param_specs(a, names, sizes, lead=1)
    n += local_bytes(a, aspecs, sizes)
    spec = M.input_specs(cfg, shape)
    if shape.kind == "train":
        n += 2 * local_bytes(a, aspecs, sizes) + 4      # mu, nu, step
    if shape.kind == "decode":
        cache = spec["cache"]
        n += local_bytes(cache, shd.cache_specs(
            cache, names, shape.global_batch, sizes, n_groups=cfg.n_groups),
            sizes)
        spec = {"token": spec["token"]}
        n += 4                                          # pos
    for k, x in spec.items():
        s = shd.batch_specs({k: x}, names)[k]
        s = shd._fit_divisibility(s, x.shape, sizes)
        n += local_bytes(x, s, sizes)
    return n


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_trace_on_small_meshes(mesh_shape, kind):
    cfg = get("stablelm-3b-smoke")
    shape = InputShape("t", S, B, kind)
    with fake_mesh(mesh_shape, ("data", "model")) as mesh:
        rec = D.run_traced(cfg, shape, mesh, n_micro=NM)
    assert not dist.is_initialized()
    assert rec["memory"]["argument_bytes"] == argument_bytes(
        cfg, shape, mesh_shape)
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    coll = sum(v["bytes"] for v in rec["collectives"].values())
    assert (coll > 0) == (mesh_shape != (1, 1))


def test_run_one_records_status():
    """``run_one`` on a (2, 2) mesh: MLA's train step traces, status ok;
    a failure is recorded, not raised."""
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        rec = D.run_one("minicpm3-4b-smoke", "train_4k", "test", save=False,
                        mesh=mesh, n_micro=64, batch=128)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_micro"] == 64
        bad = D.run_one("minicpm3-4b-smoke", "train_4k", "test", save=False,
                        mesh=mesh, n_micro=64, batch=128, loss_chunk=7)
    assert bad["status"] == "fail" and "traceback" in bad


def test_full_step_is_nm_microbatches_and_the_update():
    cfg = get("stablelm-3b-smoke")
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        one = D.trace_step(cfg, TRAIN, mesh, n_micro=NM)
        whole, tally, _ = D.trace_nm(cfg, TRAIN, mesh, n_micro=NM)
    micro, update = one["windows"]
    assert whole["flops"] == NM * micro["flops"] + update["flops"]

    def moved(w):     # bytes of the step's tensors, not the loss scalar's
        return sum(n for _, n in w["collectives"] if n > 4)
    got = moved(whole)
    assert got == NM * moved(micro) + moved(update) and got > 0
    # the loss metric's 4-byte all-reduces: DTensor reduces a partial
    # scalar where it is first read, so they fall per microbatch in one
    # pass and fewer times in the whole loop
    assert 0 < len(whole["collectives"]) - len(
        [1 for _, n in whole["collectives"] if n > 4]) <= 3 * NM + 3
    assert tally.flops == NM * one["tally"].flops


def test_column_parallel_gather_bytes():
    """``wq`` ``(K, N)`` over (data=2, model=2), its LoRA A ``(1, K, r)``
    over data: the projection gathers W's data shard (K·N/2 bf16 values
    a device) and A's (K·r float32), and nothing else."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import dense
    K, N, r = 256, 512, 4
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        with D.tracing() as (trace, _):
            def dt(shape, spec, dtype):
                loc = D._local_shape(shape, spec, {"data": 2, "model": 2})
                return DTensor.from_local(
                    torch.empty(loc, dtype=dtype), mesh,
                    shd.placements(mesh, spec), run_check=False)
            x = dt((1, 4, 16, K), shd.P(None, "data", None, None),
                   torch.bfloat16)
            w = dt((K, N), shd.P("data", "model"), torch.bfloat16)
            a = dt((1, K, r), shd.P(None, "data", None), torch.float32)
            b = dt((1, r, N), shd.P(None, None, "model"), torch.float32)
            with trace.window() as win:
                y = dense(x, w, (a, b, 2.0))
            assert tuple(y.shape) == (1, 4, 16, N)
    gathers = sorted(n for k, n in win["collectives"])
    assert all(k == "all-gather" for k, _ in win["collectives"])
    assert gathers == sorted([K * (N // 2) * 2, K * r * 4])


def test_kernel_branch_matches_plain_shapes():
    """Each kernel's wrapper on fake tensors returns the plain version's
    shapes and dtypes and counts one launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.peft import lora
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s, dt=torch.float32: torch.randn(  # noqa: E731
        *s, generator=g).to(dt)
    x, w, a, b = rnd(2, 40, 64), rnd(64, 96), rnd(2, 64, 4), rnd(2, 4, 96)
    q, k, v = rnd(2, 70, 4, 32), rnd(2, 70, 2, 32), rnd(2, 70, 2, 32)
    packed, scales = lora.quantize(rnd(64, 128), 64)
    xi = rnd(40, 64)
    want = [ref.lora_matmul(x, w, a, b, 2.0),
            ref.flash_attention(q, k, v, causal=True),
            ref.int4_matmul(xi, packed, scales, 64)]
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with counts.tally() as t, mode:
        fx, fw, fa_, fb = (mode.from_tensor(z) for z in (x, w, a, b))
        fq, fk, fv = (mode.from_tensor(z).requires_grad_()
                      for z in (q, k, v))
        got = [lm._launch(fx, fw, fa_, fb, 2.0),
               fa.flash_attention(fq, fk, fv, causal=True),
               i4._launch(mode.from_tensor(xi), mode.from_tensor(packed),
                          mode.from_tensor(scales), 64, torch.float32,
                          trans=False)]
        got[1].sum().backward()
        grads = (fq.grad, fk.grad, fv.grad)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape and gt.dtype == wt.dtype
    assert [tuple(t_.shape) for t_ in grads] == \
        [tuple(q.shape), tuple(k.shape), tuple(v.shape)]
    assert {n: c["calls"] for n, c in t.kernels.items()} == {
        "lora_matmul": 1, "flash_attention": 1, "flash_attention_bwd": 1,
        "int4_matmul": 1}
    assert lm.lora_matmul.launches == 0 and fa.flash_attention.launches == 0


def test_workspace_planners_by_hand():
    """The Python planners at a few shapes, worked by hand (132 SMs)."""
    # 1 tile of 128×128, K = 4096: 128 steps of 32; s = min(132, 32, 8)
    # = 8 splits of 16 steps; workspace 8 · C·M · (N + rank pad 8)
    assert counts.lm_splits(1, 128, 128, 4096) == 8
    assert counts.lm_workspace(1, 128, 128, 4096, 8) == 8 * 128 * 136
    # a full wave (4·ctas >= 3·132) never splits
    assert counts.lm_workspace(1, 1024, 2048, 4096, 8) == 0
    # 12 tiles, K = 256: 8 steps, s = min(11, 2, 8) = 2 splits of 4
    assert counts.lm_splits(3, 256, 256, 256) == 2
    assert counts.lm_workspace(3, 256, 256, 256, 16) == 2 * 3 * 256 * 272
    # int4: NT of M = 64 into K = 256 columns over N = 2048
    assert counts.i4_workspace(64, 256, 2048, True) == 8 * 64 * 256
    assert counts.i4_workspace(4096, 2048, 8192, False) == 0
    # the plan reads the whole grid: the tiny dx (8 tiles a client, 16
    # steps) splits 4 ways at C = 3 and 2 ways at C = 6, and so does the
    # NT with 1 and 6 clients folded into its rows
    assert counts.lm_splits(3, 1024, 128, 512) == 4
    assert counts.lm_splits(6, 1024, 128, 512) == 2
    assert counts.i4_workspace(1024, 128, 512, True) == 4 * 1024 * 128
    assert counts.i4_workspace(6 * 1024, 128, 512, True) == \
        2 * 6 * 1024 * 128
    # attention backward: one key tile needs none; 65 keys need two slabs
    assert counts.fa_backward_workspace(2, 64, 64, 4, 32) == 0
    assert counts.fa_backward_workspace(1, 65, 65, 3, 32) == \
        4 * (196 + 2 * 65 * 3 * 32)


def test_recurrence_extrapolation_matches_its_full_trace(monkeypatch):
    """A recurrence traced at ``SCAN_STEPS`` and extrapolated to S gives
    the FLOPs of tracing all S steps exactly and the peak within 0.1 %
    (xlstm-125m-smoke's mLSTM and sLSTM, a train step at S = 32)."""
    cfg, shape = get("xlstm-125m-smoke"), InputShape("t", 32, B, "train")
    cut = D.run_traced(cfg, shape, None, n_micro=NM)
    monkeypatch.setattr(D, "SCAN_STEPS", (10 ** 9, 10 ** 9 + 1))
    full = D.run_traced(cfg, shape, None, n_micro=NM)
    assert cut["cost"]["flops_per_device"] == \
        full["cost"]["flops_per_device"]
    assert abs(cut["memory"]["temp_bytes"] - full["memory"]["temp_bytes"]) \
        <= 1e-3 * full["memory"]["temp_bytes"]


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
def test_trace_runs_the_recurrences(monkeypatch, mesh_shape):
    """Under the trace, each mLSTM and sLSTM layer's recurrence goes to
    ``Trace.run_scan`` (off a mesh and inside ``local_map`` on one), and
    outside it the same call runs the scan itself."""
    from repro_torch.distributed import parallel
    calls = []
    run_scan = D.Trace.run_scan

    def counted(self, *a):
        calls.append(a[0])
        return run_scan(self, *a)

    monkeypatch.setattr(D.Trace, "run_scan", counted)
    cfg = get("xlstm-125m-smoke")
    shape = InputShape("p", 8, 2, "prefill")
    if mesh_shape is None:
        rec = D.run_traced(cfg, shape, None)
    else:
        with fake_mesh(mesh_shape, ("data", "model")) as mesh:
            rec = D.run_traced(cfg, shape, mesh)
    assert rec["cost"]["flops_per_device"] > 0
    assert len(calls) == cfg.n_layers
    seq = torch.ones(1, 3, 2)
    h, state = parallel._scan(lambda x: (x + 1, (x,)), 1, 1, seq)
    assert torch.equal(h, seq + 1) and len(calls) == cfg.n_layers


def test_mesh_is_torn_down():
    with make_local_mesh() as mesh:
        assert dist.is_initialized() and mesh.mesh.numel() == 1
    assert not dist.is_initialized()
