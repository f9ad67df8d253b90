"""Dry run: trace every (arch × shape × mesh) abstractly and read off
each device's memory, FLOPs and collectives, priced with H100 constants.

The port of ``repro/launch/dryrun.py``.  The JAX dry run lowers and
compiles each step on 512 forced host devices and reads XLA's analyses.
Here the port's card path is traced once on fake tensors: the base,
adapters, optimizer state and inputs are DTensors over a fake process
group (``launch/mesh.py``) whose local shards are ``FakeTensor``s, laid
out by ``distributed/sharding.py``'s specs, and the model runs as it
would on the card (``distributed/parallel.py`` maps each kernel call to
one device's shards; each kernel's wrapper allocates what it would and
counts its work, ``kernels/counts.py``).  Nothing is computed and
nothing is allocated on any device.  ``Trace``, a ``FakeTensorMode``,
counts what rank 0 does on its own shards: every local op's FLOPs
(torch's FLOP formulas, ``torch.utils.flop_counter``) and the bytes it
writes, each collective's output bytes (those issued inside its
``label`` block, the MoE dispatch's, also under that label: the
record's ``labelled_collectives``), and the bytes of the
local storages alive after each op, whose maximum above the arguments
is the step's temporary peak.  The numbers are predictions under the H100 SXM5
(700 W) published peaks (``launch/mesh.py``), not measurements.

A train step traces one microbatch and the update: the microbatch's
FLOPs, bytes and collectives are weighted by the microbatch count nm
(the counterpart of XLA's ``known_trip_count``).  For memory that is
exact: the gradient accumulators persist across microbatches and one
microbatch's activations are freed before the next.  ``build_step``'s
train function is ``models.model.make_train_step``'s body with its loop
cut to that one pass (``trace_nm`` traces the whole loop instead, to
check it).

Usage (on the CPU, no card; records under ``experiments/dryrun_torch/``,
beside the JAX package's ``experiments/dryrun/``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every pair
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import random as jr
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get, pairs
from repro_torch.distributed import parallel
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import counts
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
PEAK_SLACK = 1 << 20    # bytes the traced peak may fall short by (or 0.1 %)


def default_n_micro(arch: str, dp: int, global_batch: int) -> int:
    """1 example per device per microstep for ≥10B-class; fewer microsteps
    for small models (no memory pressure)."""
    small = {"xlstm-125m", "stablelm-3b", "whisper-large-v3",
             "minicpm3-4b", "starcoder2-7b"}
    per_dev = max(1, global_batch // dp)
    if arch in small:
        return max(1, per_dev // 4)
    return per_dev


def decode_window(cfg, shape_name: str) -> int:
    if shape_name == "long_500k":
        return cfg.long_decode_window
    return cfg.sliding_window


def total_chips(mesh) -> int:
    return int(mesh.mesh.numel())


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------
def _flat(x) -> List:
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    if isinstance(x, dict):
        return [y for v in x.values() for y in _flat(v)]
    return [x]


class Trace(FakeTensorMode):
    """A ``FakeTensorMode`` that counts what rank 0 does on its shards.

    Counted: each outermost op on local fake tensors (not an op on
    DTensors, whose local ops are counted in its place, and not DTensor's
    own shape propagation): its FLOPs (``torch.utils.flop_counter``'s
    formulas), the bytes of each new storage it writes (read once later:
    2× the output, XLA's HBM proxy), its collective (kind and output
    bytes) and the live local storages after it.  ``window()`` opens a
    counting window; ``peak`` is the most local bytes alive at once
    beyond those alive when tracking began, exact to ``PEAK_SLACK`` or
    0.1 % of it."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self._depth = 0
        self._prop = 0
        self.tracking = False
        self._live: Dict[int, tuple] = {}
        self._live_bytes = 0
        self.peak = 0
        self.slack = PEAK_SLACK
        self.replicated = set()
        self._labels = []
        self._win = self._new_window()

    @staticmethod
    def _new_window():
        return dict(flops=0.0, bytes=0.0, collectives=[], labelled={})

    @contextlib.contextmanager
    def window(self):
        """Counts (FLOPs, bytes, collectives) of the ops in the block."""
        outer, self._win = self._win, self._new_window()
        try:
            yield self._win
        finally:
            self._win = outer

    @contextlib.contextmanager
    def label(self, name: str):
        """Name the collectives issued in the block (``distributed.
        parallel.moe_dispatch`` asks the current mode for this method)."""
        self._labels.append(name)
        try:
            yield
        finally:
            self._labels.pop()

    @contextlib.contextmanager
    def _propagating(self):
        self._prop += 1
        try:
            yield
        finally:
            self._prop -= 1

    def run_scan(self, scan, n_state: int, n_seq: int, *inputs):
        """A recurrence (``distributed.parallel.per_sequence``'s ``scan``,
        ``n_seq`` sequence inputs first) on this trace's fake inputs, run
        on meta tensors and extrapolated (``_MetaScan``): ``(h, state)``."""
        outs = _MetaScan.apply(self, scan, n_state, n_seq, *inputs)
        return outs[0], tuple(outs[1:])

    def _sweep(self):
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    def dispatch(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat = _flat(args) + _flat(kwargs)
        if any(isinstance(a, DTensor) for a in flat):
            name = str(func)
            if name in parallel.replicated_ops():
                self.replicated.add(name)
            return super().dispatch(func, types, args, kwargs)
        if self._depth or self._prop:
            return super().dispatch(func, types, args, kwargs)
        self._depth += 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._depth -= 1
        self.record(func, args, kwargs, flat, out)
        return out

    def record(self, func, args, kwargs, flat, out, flops: bool = True):
        """Count one op: its FLOPs (with ``flops``), the storages it
        writes, its collective, and the live bytes after it."""
        from torch.multiprocessing.reductions import StorageWeakRef
        pkt = func._overloadpacket
        if flops and pkt in self._flops_of:
            self._win["flops"] += self._flops_of[pkt](*args, **kwargs,
                                                       out_val=out)
        ns, op = func.namespace, func._opname
        if ns == "_c10d_functional" and op in hlo.KINDS:
            event = (hlo.KINDS[op], sum(o.untyped_storage().nbytes()
                                        for o in _flat(out)
                                        if isinstance(o, torch.Tensor)))
            self._win["collectives"].append(event)
            if self._labels:
                self._win["labelled"].setdefault(self._labels[-1],
                                                 []).append(event)
        seen = {a.untyped_storage()._cdata for a in flat
                if isinstance(a, torch.Tensor)}
        new = 0
        for o in _flat(out):
            if not isinstance(o, torch.Tensor):
                continue
            st = o.untyped_storage()
            held = self._live.get(st._cdata)
            if st._cdata in seen or (held and not held[0].expired()):
                continue
            if held:                # a dead storage's address, reused
                self._live_bytes -= self._live.pop(st._cdata)[1]
            nbytes = st.nbytes()
            new += nbytes
            if self.tracking:
                self._live[st._cdata] = (StorageWeakRef(st), nbytes)
                self._live_bytes += nbytes
        self._win["bytes"] += 2 * new
        # sweep the dead storages only when the count (dead ones included)
        # passes the peak by the slack: the peak is exact to the slack,
        # and a run of small allocations costs no sweep each
        if self.tracking and self._live_bytes > self.peak + max(
                self.slack, self.peak // 1000 if self.slack else 0):
            self._sweep()
            self.peak = max(self.peak, self._live_bytes)


def _singleton_views():
    """DTensor's view rule with size-1 input dims dropped from each
    flattened or split group, so folding the client axis (``C = 1``) into
    a sharded batch axis, ``(1, B, …) → (B, …)``, and unfolding it keep
    the batch's shards (the same memory layout; DTensor's own rule would
    refuse a flatten whose first dim is not the sharded one)."""
    from torch.distributed.tensor._ops import _view_ops as V
    orig = V.view_groups

    def fix(spec, size):
        if isinstance(spec, V.Flatten):
            dims = [fix(d, size) for d in spec.input_dims
                    if not (isinstance(d, V.InputDim)
                            and size[d.input_dim] == 1)]
            return V.Flatten.new(dims)
        if isinstance(spec, V.Split):
            if spec.group_shape[spec.split_id] == 1:
                return V.Singleton()
            keep = [i for i, g in enumerate(spec.group_shape) if g != 1]
            inner = fix(spec.input_dim, size)
            if len(keep) == 1:
                return inner
            return V.Split(inner, tuple(spec.group_shape[i] for i in keep),
                           keep.index(spec.split_id))
        return spec

    def view_groups(from_size, to_size):
        return tuple(fix(s, list(from_size))
                     for s in orig(from_size, to_size))

    return V, orig, view_groups


def _lenient_views():
    """DTensor's view propagation with ``strict_view`` off: a view that
    would cut a sharded dim (a column-parallel ``wkv``'s ``2·KH·D``
    columns split into ``(2, KH, D)``) gathers its input over that mesh
    dim first, as ``reshape`` does, where DTensor's ``view`` would refuse.
    The gather is a collective the trace counts (GSPMD would reshard by
    an all-to-all, which moves less)."""
    from torch.distributed.tensor._ops import _view_ops as V
    orig = V.propagate_shape_and_sharding

    def lenient(placements, shape, rule, mesh_sizes, strict_view=False):
        return orig(placements, shape, rule, mesh_sizes, False)

    return V, orig, lenient


class _MetaCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Ops on ``meta`` tensors counted into a ``Trace``: a recurrence's
    steps, run on meta tensors outside the fake mode (``_MetaScan``),
    dispatch tens of times faster than fake ones and count the same."""

    def __init__(self, trace, flops: bool):
        super().__init__()
        self.trace, self.flops = trace, flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.trace.record(func, args, kwargs, _flat(args) + _flat(kwargs),
                          out, flops=self.flops)
        return out


SCAN_STEPS = (8, 16)     # steps a recurrence is traced at, to extrapolate


def _sub_trace():
    t = Trace()
    t.tracking, t.slack = True, 0       # exact: its peak is extrapolated
    return t


class _MetaScan(torch.autograd.Function):
    """A recurrence (``distributed.parallel.per_sequence``'s ``scan``) on
    fake inputs ``(N, S, …)``, measured on meta copies cut to
    ``SCAN_STEPS`` steps and extrapolated to S: a step's FLOPs and the
    bytes it keeps are the same at every step, so both are linear in S.
    Each measure runs in a trace of its own (``_MetaCount``); the main
    trace is given the FLOPs and, for the length of the pass, an
    allocation of the extrapolated peak.  The train step is
    rematerialised, so the forward measures the scan with no graph and
    the backward measures it with its graph and differentiates it, as
    the recompute of a rematerialised group holds the steps' saved
    tensors only then; that second forward's FLOPs are not counted,
    since the forward counted them where remat counts them (the pass and
    its recompute)."""

    @staticmethod
    def forward(ctx, trace, scan, n_state, n_seq, *inputs):
        ctx.trace, ctx.scan, ctx.n_seq = trace, scan, n_seq
        ctx.specs = [(tuple(t.shape), t.dtype) for t in inputs]
        outs = _MetaScan._measure(ctx, trace, False, None)
        return tuple(torch.empty(sh, dtype=dt) for sh, dt in outs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[4:]
        _MetaScan._measure(ctx, ctx.trace, True, (need, grads))
        return (None,) * 4 + tuple(
            torch.empty(sh, dtype=dt) if n and dt.is_floating_point
            else None for (sh, dt), n in zip(ctx.specs, need))

    @staticmethod
    def _measure(ctx, trace, backward: bool, bw):
        """Run the scan (and with ``backward`` its gradient) at each of
        ``SCAN_STEPS`` steps on meta tensors; give ``trace`` the FLOPs and
        peak extrapolated to the full length; return the full outputs'
        (shape, dtype)."""
        from torch.utils._python_dispatch import _disable_current_modes
        S = ctx.specs[0][0][1]
        steps = [k for k in SCAN_STEPS if k < S] or [S]
        got = []
        with _disable_current_modes():
            for k in (steps if len(steps) == 2 else [S]):
                sub = _sub_trace()
                specs = [((sh[0], k) + sh[2:], dt) if i < ctx.n_seq
                         else (sh, dt) for i, (sh, dt) in
                         enumerate(ctx.specs)]
                with sub.window() as w:
                    outs = _MetaScan._run(ctx, sub, specs, backward, bw)
                got.append((k, w["flops"], w["bytes"], sub.peak, outs))
        if len(got) == 1:
            k, flops, nbytes, peak, outs = got[0]
        else:
            (k1, f1, b1, p1, _), (k2, f2, b2, p2, outs) = got

            def at(v1, v2):
                return v1 + (v2 - v1) * (S - k1) // (k2 - k1)
            flops, nbytes, peak = at(f1, f2), at(b1, b2), at(p1, p2)
        trace._win["flops"] += flops
        trace._win["bytes"] += nbytes
        # the pass's peak, held for one op: counted, then freed
        torch.empty(max(int(peak), 1), dtype=torch.uint8)
        # full-length outputs: a sequence output's step axis is S
        return [((sh[0], S) + sh[2:], dt) if i == 0 else (sh, dt)
                for i, (sh, dt) in enumerate(outs)]

    @staticmethod
    def _run(ctx, sub, specs, backward: bool, bw):
        metas = [torch.empty(sh, dtype=dt, device="meta") for sh, dt in specs]
        if not backward:
            with torch.no_grad(), _MetaCount(sub, True):
                h, state = ctx.scan(*metas)
            return [(tuple(t.shape), t.dtype) for t in (h, *state)]
        need, grads = bw
        for m, n in zip(metas, need):
            m.requires_grad_(bool(n) and m.dtype.is_floating_point)
        with torch.enable_grad():
            with _MetaCount(sub, False):
                h, state = ctx.scan(*metas)
            outs = [o for o, g in zip((h, *state), grads)
                    if g is not None and o.requires_grad]
            with _MetaCount(sub, True):
                gs = [torch.empty(o.shape, dtype=o.dtype, device="meta")
                      for o in outs]
                torch.autograd.grad(outs, [m for m in metas
                                           if m.requires_grad], gs,
                                    allow_unused=True)
        return []


@contextlib.contextmanager
def tracing():
    """A ``Trace`` made current (it runs a recurrence's steps on meta
    tensors, ``Trace.run_scan``), DTensor's shape propagation marked as
    such, its view rule taking singleton dims (``_singleton_views``) and
    gathering where a view would cut a shard (``_lenient_views``), the
    unsharded ops replicated (``parallel``), plain tensors mixed with
    DTensors taken as replicated, and the kernels' abstract launches
    tallied: yields ``(trace, tally)``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.experimental import implicit_replication
    parallel.replicate_unsharded_ops()
    mode = Trace()
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *a, **k):
        with mode._propagating():
            return orig(self, *a, **k)

    V, orig_views, views = _singleton_views()
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes
    orig_strided = _StridedShard.local_shard_size_and_offset

    def strided(self, *a, **k):
        # DTensor's index arithmetic on small real tensors, not traced
        with _disable_current_modes():
            return orig_strided(self, *a, **k)

    _, orig_prop, lenient = _lenient_views()
    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    V.view_groups = views
    V.propagate_shape_and_sharding = lenient
    _StridedShard.local_shard_size_and_offset = strided
    try:
        with mode, implicit_replication(), counts.tally() as t:
            yield mode, t
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig
        V.view_groups = orig_views
        V.propagate_shape_and_sharding = orig_prop
        _StridedShard.local_shard_size_and_offset = orig_strided


# ---------------------------------------------------------------------------
# abstract arguments
# ---------------------------------------------------------------------------
def _local_shape(shape, spec, sizes) -> tuple:
    out = list(shape)
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out[i] //= sizes[a]
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each meta leaf of ``tree`` as a DTensor on ``mesh`` whose local
    shard (rank 0's) is a fake tensor of its spec's local shape, under
    the current ``Trace``; a ``mesh`` of None gives the fake tensors
    whole.  Returns ``(tree, local bytes)``."""
    from torch.distributed.tensor import DTensor
    total = [0]

    def one(spec, x):
        if mesh is None:
            local = torch.empty(x.shape, dtype=x.dtype)
            total[0] += local.numel() * local.element_size()
            return local
        sizes = shd.axis_sizes_of(mesh)
        local = torch.empty(_local_shape(x.shape, spec, sizes),
                            dtype=x.dtype)
        total[0] += local.numel() * local.element_size()
        return DTensor.from_local(local, mesh, shd.placements(mesh, spec),
                                  run_check=False, shape=x.shape,
                                  stride=torch.empty(x.shape,
                                                     device="meta").stride())

    return shd.map_specs(one, specs, tree), total[0]


def _lead(spec):
    return shd.P(None, *spec)


def abstract_model(cfg, key=0):
    """Meta trees of the base and one client's adapters (nothing drawn)."""
    params = M.init_params(cfg, jr.PRNGKey(key), device="meta")
    return params, M.init_adapters(cfg, jr.PRNGKey(key + 1), params)


# ---------------------------------------------------------------------------
# the three steps
# ---------------------------------------------------------------------------
def build_step(cfg, shape, mesh, *, n_micro=None, seq_parallel=True,
               loss_chunk=512, mlstm_chunkwise=False, window=None,
               attn_anchor=True, batch=None):
    """``(fn, abstract args, extra)``: ``fn(*args)`` runs the step of
    ``shape.kind`` on client-stacked ``C = 1`` inputs laid out on
    ``mesh`` (None: no mesh, the fake tensors whole) under the current
    ``Trace``; ``extra`` holds ``n_micro`` or ``window`` and the argument
    bytes.  ``batch`` overrides the shape's global batch.

    - train: remat, ``seq_parallel``, nm microbatches (one traced, see
      the module docstring) and AdamW state; ``fn`` returns the counting
      windows ``(microbatch, update)``.
    - prefill: ``collect_cache`` and ``shard_cache``.
    - decode: one serve step at ``decode_window``.
    """
    names = mesh.mesh_dim_names if mesh is not None else ()
    sizes = shd.axis_sizes_of(mesh) if mesh is not None else {}
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    B = batch or shape.global_batch
    shape = dataclasses.replace(shape, global_batch=B)
    mparams, madapters = abstract_model(cfg)
    madapters = tree_map(lambda t: t[None], madapters)         # C = 1
    pspecs = shd.param_specs(mparams, names, sizes)
    aspecs = shd.param_specs(madapters, names, sizes, lead=1)
    params, pbytes = distribute(mparams, pspecs, mesh)
    adapters, abytes = distribute(madapters, aspecs, mesh)
    win = window if window is not None else (cfg.sliding_window or None)

    if shape.kind == "train":
        nm = n_micro or default_n_micro(cfg.name, dp, B)
        if B % nm:
            raise ValueError(f"{nm} microbatches do not divide the batch "
                             f"of {B} rows")
        opts = M.FwdOptions(remat=True, seq_parallel=seq_parallel,
                            mlstm_chunkwise=mlstm_chunkwise,
                            attn_anchor=attn_anchor, window=win)
        mopt = adamw.init(madapters, n_clients=1)
        ospecs = adamw.AdamWState(step=shd.P(None), mu=aspecs, nu=aspecs)
        opt, obytes = distribute(mopt, ospecs, mesh)
        mbatch = {k: v[None] for k, v in M.input_specs(cfg, shape).items()}
        bspecs = shd.map_specs(_lead, shd.batch_specs(
            M.input_specs(cfg, shape), names))
        bspecs = {k: shd.fitted(mesh, s, mbatch[k].shape)
                  if mesh is not None else s for k, s in bspecs.items()}
        batch_t, bbytes = distribute(mbatch, bspecs, mesh)

        def fn(trace, params, adapters, opt, batch):
            with trace.window() as micro:
                if nm == 1:
                    loss, grads = M.loss_and_grads(
                        cfg, params, adapters, batch, opts=opts,
                        loss_chunk=loss_chunk)
                else:
                    grads = tree_map(lambda t: torch.zeros_like(
                        t, dtype=torch.float32), adapters)
                    mb = M.microbatch(batch, 0, nm)
                    l, g = M.loss_and_grads(cfg, params, adapters, mb,
                                            opts=opts, loss_chunk=loss_chunk)
                    del mb
                    grads = tree_map(torch.add, grads, g)
                    loss = 0.0 + l
                    del g, l
            with trace.window() as update:
                if nm > 1:
                    grads = tree_map(lambda t: t / nm, grads)
                    loss = loss / nm
                new_adapters, new_opt = adamw.update(grads, opt, adapters,
                                                     lr=3e-3)
                gnorm = torch.sqrt(sum(torch.sum(
                    g.float() ** 2, dim=tuple(range(1, g.dim())))
                    for g in tree_leaves(grads)))
            return (micro, update), (new_adapters, new_opt, loss, gnorm)

        return fn, (params, adapters, opt, batch_t), dict(
            n_micro=nm, argument_bytes=pbytes + abytes + obytes + bbytes)

    if shape.kind == "prefill":
        opts = M.FwdOptions(remat=False, collect_cache=True, shard_cache=True,
                            seq_parallel=seq_parallel,
                            mlstm_chunkwise=mlstm_chunkwise,
                            attn_anchor=attn_anchor, window=win)
        mbatch = M.input_specs(cfg, shape)
        bspecs = shd.batch_specs(mbatch, names)
        bspecs = {k: shd.fitted(mesh, s, mbatch[k].shape)
                  if mesh is not None else s for k, s in bspecs.items()}
        batch_t, bbytes = distribute(mbatch, bspecs, mesh)
        step = M.make_prefill_step(cfg, opts)

        def fn(trace, params, adapters, batch):
            with trace.window() as w:
                out = step(params, tree_map(lambda t: t[0], adapters), batch)
            return (w,), out

        return fn, (params, adapters, batch_t), dict(
            argument_bytes=pbytes + abytes + bbytes)

    if shape.kind == "decode":
        w = window if window is not None else decode_window(cfg, shape.name)
        spec = M.input_specs(cfg, shape, window=w)
        cspecs = shd.cache_specs(spec["cache"], names, B, sizes,
                                 n_groups=cfg.n_groups)
        cache, cbytes = distribute(spec["cache"], cspecs, mesh)
        tspec = shd.batch_specs({"token": spec["token"]}, names)["token"]
        if mesh is not None:
            tspec = shd.fitted(mesh, tspec, spec["token"].shape)
        token, tbytes = distribute(spec["token"], tspec, mesh)
        pos = torch.empty((), dtype=torch.int32)
        step = M.make_serve_step(cfg, window=w)

        def fn(trace, params, adapters, cache, token, pos):
            with trace.window() as win_:
                out = step(params, tree_map(lambda t: t[0], adapters), cache,
                           token, pos)
            return (win_,), out

        return fn, (params, adapters, cache, token, pos), dict(
            window=w, argument_bytes=pbytes + abytes + cbytes + tbytes + 4)

    raise ValueError(shape.kind)


def _program_mesh(mesh):
    """The mesh to lay DTensors on: none for a one-device mesh, whose
    program is the plain one (every placement ``Replicate``, no
    collective), so it traces the same on any torch's DTensor."""
    return None if mesh is None or mesh.mesh.numel() == 1 else mesh


def trace_step(cfg, shape, mesh, **knobs) -> dict:
    """Trace one step (``build_step``) under a fresh ``Trace``: the
    counting windows, the kernels' tally, the argument and peak bytes,
    the ops DTensor replicated and the seconds."""
    t0 = time.time()
    mesh = _program_mesh(mesh)
    with tracing() as (trace, tally):
        with shd.use_mesh(mesh) if mesh is not None \
                else contextlib.nullcontext():
            fn, args, extra = build_step(cfg, shape, mesh, **knobs)
            trace.tracking = True
            windows, out = fn(trace, *args)
            del out
        peak = trace.peak
    return dict(windows=windows, tally=tally, extra=extra, peak=peak,
                replicated=sorted(trace.replicated),
                trace_s=time.time() - t0)


def trace_nm(cfg, shape, mesh, *, n_micro: int, batch=None, **knobs):
    """``models.model.make_train_step``'s whole step, every microbatch,
    traced in one counting window (the check of ``build_step``'s one
    microbatch weighted by nm): ``(window, tally, peak)``."""
    mesh = _program_mesh(mesh)
    with tracing() as (trace, tally):
        with shd.use_mesh(mesh) if mesh is not None \
                else contextlib.nullcontext():
            _, (params, adapters, opt, batch_t), extra = build_step(
                cfg, shape, mesh, n_micro=n_micro, batch=batch, **knobs)
            opts = M.FwdOptions(
                remat=True, seq_parallel=knobs.get("seq_parallel", True),
                window=cfg.sliding_window or None)
            step = M.make_train_step(cfg, n_microbatches=n_micro, lr=3e-3,
                                     opts=opts)
            trace.tracking = True
            with trace.window() as w:
                out = step(params, adapters, opt, batch_t)
            del out
    return w, tally, trace.peak


def run_traced(cfg, shape, mesh, **knobs) -> dict:
    """One pair's record fields from ``trace_step``: memory, cost,
    collectives, roofline and the microbatch weighting."""
    tr = trace_step(cfg, shape, mesh, **knobs)
    extra, tally = tr["extra"], tr["tally"]
    nm = int(extra.get("n_micro", 1))
    weights = (nm, 1) if shape.kind == "train" else (1,)
    flops = sum(w["flops"] * k for w, k in zip(tr["windows"], weights))
    nbytes = sum(w["bytes"] * k for w, k in zip(tr["windows"], weights))
    coll = hlo.merge_stats(*(hlo.collective_stats(w["collectives"], k)
                             for w, k in zip(tr["windows"], weights)))
    labels = sorted({n for w in tr["windows"] for n in w["labelled"]})
    labelled = {n: hlo.merge_stats(*(hlo.collective_stats(
        w["labelled"].get(n, ()), k) for w, k in zip(tr["windows"], weights)))
        for n in labels}
    # the kernels' work: the microbatch's launches nm times
    kflops = tally.flops * (nm if shape.kind == "train" else 1)
    kbytes = tally.bytes * (nm if shape.kind == "train" else 1)
    cbytes = sum(v["bytes"] for v in coll.values())
    rec = dict(extra)
    rec["memory"] = {
        "argument_bytes": extra["argument_bytes"],
        "temp_bytes": tr["peak"],
        "peak_bytes_per_device": extra["argument_bytes"] + tr["peak"],
    }
    rec["cost"] = {"flops_per_device": flops + kflops,
                   "kernel_flops_per_device": kflops,
                   "bytes_per_device": nbytes + kbytes,
                   "kernels": tally.kernels}
    rec["collectives"] = coll
    # the collectives of a labelled exchange (the MoE dispatch), those
    # kinds it issued only: part of ``collectives`` above
    rec["labelled_collectives"] = {
        n: {k: v for k, v in st.items() if v["count"]}
        for n, st in labelled.items()}
    rec["roofline"] = hlo.roofline_terms(
        flops_per_chip=flops + kflops, hbm_bytes_per_chip=nbytes + kbytes,
        collective_bytes_per_chip=cbytes)
    rec["replicated_ops"] = tr["replicated"]
    rec["trace_s"] = round(tr["trace_s"], 2)
    return rec


def run_one(arch: str, shape_name: str, mesh_kind: str, *, tag="baseline",
            save=True, qlora=False, mesh=None, **knobs):
    """JAX's ``run_one``: one pair's record, failures recorded, not
    raised.  ``mesh`` (a ``DeviceMesh``) overrides ``mesh_kind``'s
    production mesh."""
    cfg = get(arch)
    if qlora:
        cfg = dataclasses.replace(
            cfg, lora=dataclasses.replace(cfg.lora, quantize_base=True))
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "knobs": knobs, "status": "ok"}
    try:
        with (contextlib.nullcontext(mesh) if mesh is not None
              else make_production_mesh(multi_pod=(mesh_kind == "multi"))
              ) as m:
            rec.update(run_traced(cfg, shape, m, **knobs))
            rec["model_flops"] = model_flops(cfg, shape)
            hw = rec["cost"]["flops_per_device"] * total_chips(m)
            rec["useful_flops_ratio"] = (rec["model_flops"] / hw) if hw \
                else 0.0
    except Exception as e:  # noqa: BLE001 — record failures, don't die
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        name = f"{arch}_{shape_name}_{mesh_kind}_{tag}.json"
        (OUT_DIR / name).write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--mlstm-chunkwise", action="store_true")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--no-attn-anchor", action="store_true")
    ap.add_argument("--qlora", action="store_true")
    args = ap.parse_args(argv)

    knobs = dict(n_micro=args.n_micro, loss_chunk=args.loss_chunk,
                 seq_parallel=not args.no_seq_parallel,
                 mlstm_chunkwise=args.mlstm_chunkwise, window=args.window,
                 attn_anchor=not args.no_attn_anchor)

    if args.all:
        todo = [(a, s, m) for (a, s) in pairs()
                for m in ("single", "multi")]
    else:
        todo = [(args.arch, args.shape, args.mesh)]

    recs = []
    for (a, s, m) in todo:
        t0 = time.time()
        rec = run_one(a, s, m, tag=args.tag, qlora=args.qlora, **knobs)
        status = rec["status"]
        if status == "ok":
            mem = rec["memory"]["peak_bytes_per_device"] / 2**30
            dom = rec["roofline"]["dominant"]
            extra = f"peak={mem:.2f}GiB/dev dominant={dom}"
        else:
            extra = rec["error"][:160]
        print(f"[{time.time()-t0:7.1f}s] {a} × {s} × {m}: {status} {extra}",
              flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
