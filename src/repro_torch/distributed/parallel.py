"""The kernels' boundary on a device mesh: each kernel call on DTensors
runs through ``local_map`` with the placements that the JAX package's
einsums partition to, so the kernel sees one device's shards.

- ``dense``: a projection ``x@W (+ s·(x@A)@B)`` whose weight is laid out
  by ``sharding.param_specs``.  A ``(FSDP, TP)`` weight is
  column-parallel: W is gathered over ``'data'`` and keeps its output
  columns on ``'model'``, B likewise, A whole; the output's last dim
  rides ``'model'``.  A ``(TP, FSDP)`` weight is row-parallel: x's
  last dim (K) and W's and A's K rows ride ``'model'``, and the output is
  ``Partial`` over ``'model'``, exact because ``x@W + s·(x@A)@B`` is linear
  in each K slice.  A weight with no ``'model'`` shard is gathered whole.
  Rows (dim 1 of x, the batch) ride the batch axes ``('pod', 'data')``
  where they divide.  A QLoRA weight's packed bytes and scales keep their
  ``'model'`` shard and are gathered over ``'data'`` packed
  (``sharding.packed_gather_spec``), as JAX's ``weight`` constrains them.
- ``attention``: q ``(N, S, H, D)``, k and v ``(N, Sk, KH, ·)``; the
  sequences ``N`` over the batch axes, the heads as JAX's anchors at
  ``repro/models/attention.py:56-96`` shard them
  (``sharding.head_axis_choice``): whole kv-head groups on ``'model'``
  when ``KH`` divides, else the ``G`` q-heads of each group (k and v
  whole), else the query rows (context parallel, k and v whole).

- ``decode_attention``: one query row a sequence against a cache laid
  out by ``sharding.cache_specs`` (sequences over the batch axes, the
  slots over ``'model'`` where they divide).  Each device writes the new
  key and value into its own slots (the owner of the slot writes, the
  others rewrite what they hold) and attends over them; the devices'
  partial softmax statistics (row max, sum and unnormalised output, the
  flash-decoding split) are gathered over ``'model'`` and combined.

- ``moe_dispatch`` and ``moe_combine``: the MoE block's token exchange
  (``models/ffn.py``), laid out as JAX's constraints lay it
  (``repro/models/ffn.py:102-140``).  The routing metadata (each choice's
  expert, rank and kept flag, ``T·k`` integers) is replicated; the
  tokens ``(T, d)`` stay on the batch axes; the ``(E, C_e, d)`` expert
  buffers ride ``'model'`` on E.  Each device copies its own token rows
  into its own experts' slots (``ffn.dispatch_rows``); the devices'
  shares are ``Partial`` over the batch axes, exact because every kept
  slot is written by one row only, and are all-reduced there into the
  buffer (GSPMD partitions JAX's scatter the same way: a partial buffer a
  device, reduced over the axes that split the updates).  The combine
  gathers, for each device's own rows, the outputs of its own experts
  (``ffn.combine_rows``): ``Partial`` over ``'model'``, reduced where the
  block's update meets the residual.  Under the dry run's trace the
  dispatch's reduction runs under its ``label`` ``MOE_DISPATCH``, which
  the trace's record reports.

``replicate_unsharded_ops`` registers DTensor's replicate-everything
strategy for the ops it has no sharding rule for (``REPLICATED_OPS``:
the MoE ranking's ``searchsorted``, on the replicated routing metadata,
as JAX replicates it); the dry run names each one a pair ran.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, TP

_FAKE = torch._C._TorchDispatchModeKey.FAKE

REPLICATED_OPS = ("aten.searchsorted.Tensor",)
_REGISTERED = []
MOE_DISPATCH = "moe dispatch"


def replicate_unsharded_ops():
    """Register the replicate strategy for those of ``REPLICATED_OPS``
    that this torch's DTensor has no rule for (once)."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops.utils import (register_op_strategy,
                                                     replicate_op_strategy)
    prop = DTensor._op_dispatcher.sharding_propagator
    known = set()
    for table in ("op_strategy_funcs", "op_to_rules",
                  "op_single_dim_strategy_funcs"):
        known |= set(getattr(prop, table, {}))
    for name in REPLICATED_OPS:
        pkt, overload = name.split(".")[1:]
        op = getattr(getattr(torch.ops.aten, pkt), overload)
        if op not in known:
            register_op_strategy(op)(replicate_op_strategy)
            _REGISTERED.append(name)
    _REGISTERED.append(None)


def replicated_ops() -> set:
    """The ops ``replicate_unsharded_ops`` registered here."""
    return {n for n in _REGISTERED if n}


def _batch_entry(mesh):
    return shd._scalar_axis(shd.batch_axes(mesh.mesh_dim_names)) or None


def _pl(mesh, spec, shape):
    return tuple(shd.placements(mesh, shd.fitted(mesh, spec, shape)))


def tp_kind(w):
    """``"column"``, ``"row"`` or None: where ``w`` ``(K, N)`` keeps its
    ``'model'`` shard (on N, on K, or none)."""
    from torch.distributed.tensor import Shard
    names = list(w.device_mesh.mesh_dim_names)
    if TP not in names:
        return None
    pl = w.placements[names.index(TP)]
    if isinstance(pl, Shard):
        return "column" if pl.dim == 1 else "row"
    return None


def dense(local_fn, x, w, scales, a, b, scale):
    """``local_fn(x, w, scales, a, b, scale)`` on each device's shards
    (``scales`` None unless ``w`` is a QLoRA weight's packed bytes; ``a``
    and ``b`` None without LoRA): a DTensor ``x.shape[:-1] + (N,)``."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    kind = tp_kind(w)
    row, col = kind == "row", kind == "column"
    nd = x.dim()
    lead = [None, _batch_entry(mesh)] + [None] * (nd - 2)
    x_spec = P(*lead[:-1], TP if row else None)
    w_spec = P(TP if row else None, TP if col else None)
    N = 2 * w.shape[1] if scales is not None else w.shape[1]
    out_shape = tuple(x.shape[:-1]) + (N,)
    out_pl = list(_pl(mesh, P(*lead[:-1], TP if col else None), out_shape))
    if row:
        out_pl[list(mesh.mesh_dim_names).index(TP)] = Partial()
    args = [x, w, scales, a, b, scale]
    specs = [x_spec, w_spec, w_spec if scales is not None else None,
             P(None, TP if row else None, None) if a is not None else None,
             P(None, None, TP if col else None) if b is not None else None,
             None]
    in_pl = [None if s is None else _pl(mesh, s, t.shape)
             for s, t in zip(specs, args)]
    return local_map(local_fn, out_placements=(tuple(out_pl),),
                     in_placements=tuple(in_pl),
                     redistribute_inputs=True)(*args)


def attention(local_fn, q, k, v, *, anchor: bool = True):
    """``local_fn(q, k, v)`` (one attention launch) on each device's
    shards, laid out as the module docstring says: a DTensor ``(N, S, H,
    Dv)``."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    N, S, H, D = q.shape
    KH, Dv = k.shape[2], v.shape[3]
    G = H // KH
    with shd.use_mesh(mesh):
        kh_ax, g_ax = shd.head_axis_choice(KH, G) if anchor else (None,
                                                                   None)
        tp = shd.mesh_axis_size(TP)
    qc_ax = TP if (anchor and kh_ax is None and g_ax is None and tp > 1
                   and S % tp == 0) else None
    ba = _batch_entry(mesh)
    kv_spec = P(ba, None, kh_ax, None)
    if g_ax is None:
        q_spec = P(ba, qc_ax, kh_ax, None)
        return local_map(
            local_fn, out_placements=(_pl(mesh, q_spec, (N, S, H, Dv)),),
            in_placements=(_pl(mesh, q_spec, q.shape),
                           _pl(mesh, kv_spec, k.shape),
                           _pl(mesh, kv_spec, v.shape)),
            redistribute_inputs=True)(q, k, v)
    # the G q-heads of each group on 'model': (N, S, KH, G, D), k/v whole
    q5 = q.reshape(N, S, KH, G, D)
    q_spec = P(ba, None, None, g_ax, None)

    def grouped(q5, k, v):
        n, s, kh, g, d = q5.shape
        o = local_fn(q5.reshape(n, s, kh * g, d), k, v)
        return o.reshape(n, s, kh, g, o.shape[-1])

    out = local_map(grouped,
                    out_placements=(_pl(mesh, q_spec, (N, S, KH, G, Dv)),),
                    in_placements=(_pl(mesh, q_spec, q5.shape),
                                   _pl(mesh, kv_spec, k.shape),
                                   _pl(mesh, kv_spec, v.shape)),
                    redistribute_inputs=True)(q5, k, v)
    return out.reshape(N, S, H, Dv)


def decode_attention(attend, q, k, v, k_cache, v_cache, slot, pos, *,
                     window: int = 0):
    """The mesh form of ``attention.attn_decode``'s cache write and
    ``decode_attention`` (``attend``'s masking and rounding, on each
    device's slots): q ``(N, 1, H, D)``, the new k and v ``(N, 1, KH,
    D)``, the caches ``(N, S, KH, D)`` written in place; returns a DTensor
    ``(N, 1, H, D)``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    N, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    ba = _batch_entry(mesh)
    row = _pl(mesh, P(ba, None, None, None), q.shape)
    cache_pl = tuple(k_cache.placements)
    split = TP in names and cache_pl[names.index(TP)] == Shard(1)
    part = list(_pl(mesh, P(None, ba, None, None), (1, N, KH, G)))
    if split:
        part[names.index(TP)] = Shard(0)
    part = tuple(part)

    def local(q, k, v, kc, vc, slot, pos):
        s_l = kc.shape[1]
        off = mesh.get_local_rank(TP) * s_l if split else 0
        here = torch.clamp(slot - off, 0, s_l - 1)
        own = ((slot >= off) & (slot < off + s_l)).reshape(1, 1, 1, 1)
        for c, new in ((kc, k), (vc, v)):
            c.index_copy_(1, here, torch.where(own, new.to(c.dtype),
                                               c.index_select(1, here)))
        n = q.shape[0]
        qr = q.reshape(n, KH, G, D).float()
        sc = torch.einsum("nkgd,nskd->nkgs", qr, kc.float()) * (D ** -0.5)
        idx = torch.arange(off, off + s_l, device=q.device)
        valid = idx <= pos
        if window:
            valid &= idx > pos - window
        sc = torch.where(valid, sc, -1e30)
        m = sc.max(dim=-1).values
        p = torch.exp(sc - m[..., None])
        o = torch.einsum("nkgs,nskd->nkgd", p.to(vc.dtype).float(),
                         vc.float())
        return m[None], p.sum(-1)[None], o[None]

    m, l, o = local_map(
        local, out_placements=(part, part, part),
        in_placements=(row, row, row, cache_pl, cache_pl, None, None),
        redistribute_inputs=True)(q, k, v, k_cache, v_cache, slot, pos)
    full = tuple(Replicate() for _ in names)
    m, l, o = (t.redistribute(mesh, full) for t in (m, l, o))
    top = m.max(dim=0).values
    w = torch.exp(m - top)
    out = (w[..., None] * o).sum(0) / (w * l).sum(0)[..., None]
    return out.reshape(N, 1, H, D).to(q.dtype)


def _moe_layout(mesh, n_tokens: int, n_experts: int):
    """``(token axes, expert parallel)``: the batch axes that split a
    client's ``n_tokens`` rows (those that divide them, outer first), and
    whether the ``n_experts`` buffers ride ``'model'`` (``TP`` divides
    them), as ``sharding.fitted`` fits JAX's specs."""
    tok = shd.fitted(mesh, P(_batch_entry(mesh), None), (n_tokens, 1))[0]
    tok = () if tok is None else (tok if isinstance(tok, tuple) else (tok,))
    ep = shd.fitted(mesh, P(TP, None, None), (n_experts, 1, 1))[0] == TP
    sizes = shd.axis_sizes_of(mesh)
    tok = tuple(a for a in tok if sizes[a] > 1)
    return tok, ep and sizes.get(TP, 1) > 1


def _rank_along(mesh, axes) -> int:
    """This device's index along ``axes`` (outer first) of ``mesh``."""
    sizes = shd.axis_sizes_of(mesh)
    r = 0
    for a in axes:
        r = r * sizes[a] + mesh.get_local_rank(a)
    return r


def _moe_pl(mesh, dims: dict):
    """Placements: ``dims`` maps a mesh axis to its placement, the rest
    ``Replicate``."""
    from torch.distributed.tensor import Replicate
    return tuple(dims.get(a, Replicate()) for a in mesh.mesh_dim_names)


def moe_dispatch(rows_fn, xn, flat_e, pos, keep, *, top_k: int,
                 n_experts: int, capacity: int):
    """One client's dispatch on a mesh: ``xn`` ``(T, d)`` (a DTensor; its
    rows on the batch axes), the replicated routing ``(T·k,)`` →
    the buffers ``(E, C_e, d)``, E on ``'model'``, replicated elsewhere.
    ``rows_fn`` is ``ffn.dispatch_rows``."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xn.device_mesh
    tok, ep = _moe_layout(mesh, xn.shape[0], n_experts)
    E_l = n_experts // shd.axis_sizes_of(mesh)[TP] if ep else n_experts
    rows = {a: Shard(0) for a in tok}
    rep = _moe_pl(mesh, {})
    e_dim = {TP: Shard(0)} if ep else {}
    # a model rank takes only the rows bound for its experts, so the
    # tokens' gradient is partial over 'model'
    x_grad = _moe_pl(mesh, {**rows, **({TP: Partial()} if ep else {})})

    def local(x, fe, ps, kp):
        row0 = _rank_along(mesh, tok) * x.shape[0]
        e0 = mesh.get_local_rank(TP) * E_l if ep else 0
        return rows_fn(x, row0, fe, ps, kp, top_k, capacity, e0, e0 + E_l)

    buf = local_map(
        local,
        out_placements=(_moe_pl(mesh, {**{a: Partial() for a in tok},
                                       **e_dim}),),
        in_placements=(_moe_pl(mesh, rows), rep, rep, rep),
        in_grad_placements=(x_grad, rep, rep, rep),
        redistribute_inputs=True)(xn, flat_e, pos, keep)
    # a fake-tensor mode that names collectives (the dry run's trace has
    # a ``label`` method) records the reduction's under MOE_DISPATCH
    label = getattr(torch._C._get_dispatch_mode(_FAKE), "label", None)
    with label(MOE_DISPATCH) if label else contextlib.nullcontext():
        return buf.redistribute(mesh, _moe_pl(mesh, e_dim))


def moe_combine(rows_fn, out, flat_e, pos, keep, gates, *, capacity: int):
    """One client's combine on a mesh: the experts' outputs ``(E, C_e,
    d)`` (E on ``'model'``), the replicated routing, the gates ``(T, k)``
    (rows on the batch axes) → ``(T, d)``, rows on the batch axes,
    ``Partial`` over ``'model'`` (each device sums its own experts'
    share).  ``rows_fn`` is ``ffn.combine_rows``."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = out.device_mesh
    n_experts = out.shape[0]
    tok, ep = _moe_layout(mesh, gates.shape[0], n_experts)
    E_l = n_experts // shd.axis_sizes_of(mesh)[TP] if ep else n_experts
    rows = {a: Shard(0) for a in tok}
    rep = _moe_pl(mesh, {})
    e_dim = {TP: Shard(0)} if ep else {}
    model_part = {TP: Partial()} if ep else {}
    # each batch rank reads the buffers for its own rows, each model rank
    # the gates of its own experts' choices: both gradients are partial
    out_grad = _moe_pl(mesh, {**{a: Partial() for a in tok}, **e_dim})
    g_grad = _moe_pl(mesh, {**rows, **model_part})

    def local(o, fe, ps, kp, g):
        row0 = _rank_along(mesh, tok) * g.shape[0]
        e0 = mesh.get_local_rank(TP) * E_l if ep else 0
        return rows_fn(o, row0, fe, ps, kp, g, capacity, e0, e0 + E_l)

    return local_map(
        local, out_placements=(_moe_pl(mesh, {**rows, **model_part}),),
        in_placements=(_moe_pl(mesh, e_dim), rep, rep, rep,
                       _moe_pl(mesh, rows)),
        in_grad_placements=(out_grad, rep, rep, rep, g_grad),
        redistribute_inputs=True)(out, flat_e, pos, keep, gates)


def whole_sequence(*ts):
    """Sequence-major tensors ``(N, S, …)`` with their sequences (dim 0)
    over the batch axes and every step of S on each device, as a
    recurrence walks them; plain tensors as they are."""
    return tuple(shd.constrain(t, P(("pod", "data"),
                                    *((None,) * (t.dim() - 1))))
                 for t in ts)


def _scan(scan, n_state: int, n_seq: int, *inputs):
    """``scan(*inputs)``, or, under a fake-tensor mode that runs
    recurrences its own way (a ``run_scan`` method, as the dry run's
    trace has), that mode's ``run_scan(scan, n_state, n_seq, *inputs)``."""
    run = getattr(torch._C._get_dispatch_mode(_FAKE), "run_scan", None)
    if run is not None:
        return run(scan, n_state, n_seq, *inputs)
    return scan(*inputs)


def per_sequence(scan, n_state: int, *seqs, whole=()):
    """``scan(*seqs, *whole)`` → ``(h, state tuple of n_state)``, a
    recurrence over sequence-major ``seqs`` ``(N, S, …)``.  On DTensors it
    runs on each device's sequences (dim 0 over the batch axes, every
    step of S local: ``local_map``), ``whole`` (weights) gathered whole,
    so its thousands of steps dispatch as local ops; else as it is.  Under
    the dry run's trace the trace runs it its own way (``_scan``)."""
    if not seqs or not shd.is_dtensor(seqs[0]):
        return _scan(scan, n_state, len(seqs), *seqs, *whole)
    from torch.distributed.tensor.experimental import local_map
    mesh = seqs[0].device_mesh
    ba = _batch_entry(mesh)
    seqs = whole_sequence(*seqs)
    row = _pl(mesh, P(ba), seqs[0].shape[:1])
    rep = _pl(mesh, P(), ())
    h, state = local_map(
        lambda *a: _scan(scan, n_state, len(seqs), *a),
        out_placements=(row,) * (1 + n_state),
        in_placements=tuple(row for _ in seqs) + tuple(rep for _ in whole),
        redistribute_inputs=True)(*seqs, *whole)
    return h, state
