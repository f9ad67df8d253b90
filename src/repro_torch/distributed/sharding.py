"""Sharding: the model-parallel specs of the dry run, and the
``'clients'`` axis of the batched engines over several devices.

Model parallelism (the first half of ``repro/distributed/sharding.py``):
FSDP along ``'data'``, tensor parallelism along ``'model'``, pure data
parallelism along ``'pod'``, keyed by a weight's leaf name.  A spec is a
``P``: a tuple of axis names, ``None`` or tuples of names, one entry a
tensor dimension, printed and compared as JAX's ``PartitionSpec`` is.
``_DENSE_RULES``, ``_MOE_RULES``, ``_SPECIAL``, ``_leaf_spec``,
``_filter_axes``, ``_fit_divisibility``, ``batch_axes``, ``batch_specs``,
``packed_gather_spec`` and ``head_axis_choice`` are the JAX package's.
``param_specs`` walks the port's unrolled layout (a ``layers`` list where
JAX stacks ``groups``), so port layer ``g·P + p`` takes JAX's spec of
``groups[p]``'s leaf less its leading ``None``; ``lead`` leading
replicated dimensions (the client axis) may be prepended.
``cache_specs`` applies JAX's rule to each leaf's stacked shape
``(n_groups, *shape)`` and drops the first entry.  ``named`` maps a spec
to DTensor placements on a ``DeviceMesh`` (a tuple entry such as
``("pod", "data")`` shards one dimension over both mesh dimensions, pod
major); ``constrain`` redistributes a DTensor to its filtered and fitted
spec and returns any other tensor as it is, as JAX's does outside a
mesh.  ``use_mesh`` sets the mesh that ``mesh_axis_size`` and
``head_axis_choice`` read (JAX's ``set_mesh``).

The clients axis (the second half).
The JAX package lays a ``(C, …)`` client stack over a 1-D device mesh
and lets one jitted program partition it; here one host program drives
the devices itself.  The padded client axis is cut into ``n`` equal
shards, shard ``s`` holds rows ``[s·w, (s+1)·w)`` on ``devices[s]``, and
one host thread issues every shard's work in turn.  CUDA launches are
asynchronous, so shards on different cards overlap; shard 0's device is
the lead, where the cross-client steps run.

The batched engines' per-client work never mixes clients (see
``core/batched_engine.py``), so a shard computes its clients' bits on
its own.  Client counts that do not divide the shards are padded
explicitly (``pad_client_count``) with inert clients after every real
one; placement refuses a ragged axis rather than cutting unequal shards.

Stacks travel as trees (dicts, lists, tuples) of tensors or numpy
arrays.  ``client_specs`` marks a leaf whose leading dimension equals
the client count with ``CLIENTS`` (it is cut into shards) and any other
leaf with ``None`` (every shard gets all of it); ``client_tree_specs``
is the strict form for client-stacked trees (adapters, optimizer
states), where a leaf without the client axis is an error.
"""
from __future__ import annotations

import contextlib
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CLIENTS = "clients"


def client_devices(n_devices: int, device=None, *,
                   share_devices: bool = False) -> List[torch.device]:
    """The devices of ``n_devices`` shards, the counterpart of the JAX
    package's ``client_mesh``.

    On the card (``device`` a CUDA device, or ``None``) shard ``s`` lies
    on ``cuda:s``, and asking for more shards than cards are visible
    raises.  ``share_devices=True`` instead puts every shard on
    ``device`` itself, as forced host devices do for JAX: it exists to
    test the sharded path on one card, and must be asked for.  On the
    CPU every shard is the CPU.
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * n
    if share_devices:
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return [torch.device("cuda", index)] * n
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(
            f"n_devices={n} wants {n} CUDA devices but {visible} "
            f"{'is' if visible == 1 else 'are'} visible; lower n_devices, "
            f"or pass share_devices=True to put the shards on one card "
            f"(a test of the sharded path, not a speed-up)")
    return [torch.device("cuda", i) for i in range(n)]


def pad_client_count(n_clients: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` that is >= ``n_clients``: the
    padded leading dimension of the client stacks.  Padding clients are
    inert (all-zero masks, zero budgets and weights), so they never
    contribute to losses or aggregation."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return -(-int(n_clients) // int(n_shards)) * int(n_shards)


def check_client_divisibility(n_clients: int, n_shards: int) -> None:
    """A ragged client axis is an error, not an implicit reshard: pad
    first with ``pad_client_count`` (the engines do this at
    construction) or use fewer shards."""
    if n_clients % n_shards != 0:
        raise ValueError(
            f"client axis of size {n_clients} does not divide across "
            f"{n_shards} shards; pad to "
            f"{pad_client_count(n_clients, n_shards)} with inert clients "
            f"(pad_client_count) or use a shard count that divides "
            f"{n_clients}")


def shard_bounds(n_clients: int, n_shards: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` client rows of each shard of an evenly divided axis."""
    check_client_divisibility(n_clients, n_shards)
    w = n_clients // n_shards
    return [(s * w, (s + 1) * w) for s in range(n_shards)]


def client_specs(arrays, n_clients: int):
    """Spec tree for a tree of engine inputs: ``CLIENTS`` on leaves whose
    leading dimension equals ``n_clients`` (they are cut into shards),
    ``None`` on everything else (θ_g, scalars: every shard gets it)."""
    def leaf(x):
        shape = tuple(getattr(x, "shape", ()))
        return CLIENTS if shape and shape[0] == n_clients else None
    return tree_map(leaf, arrays)


def client_tree_specs(tree, n_clients: int):
    """Spec tree for a client-stacked tree (LoRA adapter stacks, AdamW
    states): every leaf must carry the client axis leading, and one that
    does not is an error, not a silent replication."""
    def leaf(x):
        shape = tuple(getattr(x, "shape", ()))
        if not shape or shape[0] != n_clients:
            raise ValueError(
                f"client-stacked tree leaf has shape {shape}, expected "
                f"leading dim {n_clients}; stack per-client state along "
                f"the client axis before placement")
        return CLIENTS
    return tree_map(leaf, tree)


def _to(x, device):
    return torch.as_tensor(x).to(device)


def _place(devices: Sequence[torch.device], tree, specs, n_clients: int):
    bounds = shard_bounds(n_clients, len(devices))
    flat, marks = tree_leaves(tree), tree_leaves(specs)
    out = []
    for dev, (lo, hi) in zip(devices, bounds):
        out.append(tree_unflatten(tree, [
            _to(x[lo:hi] if m == CLIENTS else x, dev)
            for x, m in zip(flat, marks)]))
    return out


def put_client_stacks(devices: Sequence[torch.device], arrays,
                      n_clients: int) -> list:
    """One tree a shard: client-stacked leaves cut to the shard's rows,
    the rest whole, each on the shard's device.  Raises on a client count
    the shards do not divide."""
    check_client_divisibility(n_clients, len(devices))
    return _place(devices, arrays, client_specs(arrays, n_clients),
                  n_clients)


def put_client_tree(devices: Sequence[torch.device], tree,
                    n_clients: int) -> list:
    """One client-stacked tree (adapters, optimizer states) a shard, cut
    along the leading client axis of every leaf (strict:
    ``client_tree_specs``)."""
    check_client_divisibility(n_clients, len(devices))
    return _place(devices, tree, client_tree_specs(tree, n_clients),
                  n_clients)


def put_replicated(devices: Sequence[torch.device], x) -> list:
    """``x`` (a tensor or a tree: θ_g, the frozen base) whole on every
    shard's device, whatever its leading dimension: a leaf that happens
    to be as long as the client axis is never cut.  A leaf already on a
    device is not copied there."""
    return [tree_map(lambda v, d=dev: _to(v, d), x) for dev in devices]


def gather_clients(shards: Sequence, device: Optional[torch.device] = None):
    """The shards' trees concatenated along the client axis, in client
    order, on ``device`` (shard 0's when ``None``).  One shard comes back
    as it is."""
    if len(shards) == 1 and device is None:
        return shards[0]
    if device is None:
        device = tree_leaves(shards[0])[0].device
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]),
                    *shards)


def on_device(device: torch.device):
    """A context in which ``device`` is CUDA's current device (the
    kernels launch on the current device), or nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# model parallelism: 'pod' × 'data' (FSDP) × 'model' (TP)
# ---------------------------------------------------------------------------
FSDP = "data"
TP = "model"


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``, a
    mesh axis name, or a tuple of names (sharded over their product,
    the first major)."""

    def __new__(cls, *entries):
        return super().__new__(
            cls, tuple(tuple(e) if isinstance(e, list) else e
                       for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


# leaf name -> (in_axis, out_axis) for 2D weights.  None = replicated.
_DENSE_RULES = {
    "wq": (FSDP, TP), "wkv": (FSDP, TP), "xwq": (FSDP, TP), "xwkv": (FSDP, TP),
    "wo": (TP, FSDP), "xwo": (TP, FSDP),
    "w_in": (FSDP, TP), "w_out": (TP, FSDP),
    "shared_w_in": (FSDP, TP), "shared_w_out": (TP, FSDP),
    "up_proj": (FSDP, TP), "down_proj": (TP, FSDP),
    "in_proj": (FSDP, TP), "out_proj": (TP, FSDP),
    "w_gates": (FSDP, TP),
    "wq_a": (FSDP, None), "wq_b": (None, TP),
    "wkv_a": (FSDP, None), "wkv_b": (None, TP),
    "router": (FSDP, None),
    "x_proj": (TP, None), "dt_w": (None, TP),
    "wk": (FSDP, TP), "wv": (FSDP, TP),
    "w_if": (TP, None),
    "embed": (TP, FSDP),          # vocab on model, d on data
    "lm_head": (FSDP, TP),        # d on data, vocab on model
    "proj_frontend": (FSDP, TP),
}

# 3D expert weights: (E, in, out)
_MOE_RULES = {"w_in": (TP, FSDP, None), "w_out": (TP, None, FSDP)}

_SPECIAL = {
    "conv_w": (None, TP),
    "A_log": (TP, None),
    "r_gates": (None, None, None),
}


def _leaf_spec(name: str, shape: Tuple[int, ...], stacked: bool) -> P:
    nd = len(shape) - (1 if stacked else 0)
    if name.endswith("__q"):
        # QLoRA packed int4: the base weight's layout (out dim halved)
        base = _DENSE_RULES.get(name[:-3], (None, None))
    elif name.endswith("__s"):
        # blockwise scales: the in dim sharded like the weight's
        base = (_DENSE_RULES.get(name[:-3], (None, None))[0], None)
    elif name.endswith("_lora_a"):
        base = (_DENSE_RULES.get(name[:-len("_lora_a")], (None, None))[0],
                None)
    elif name.endswith("_lora_b"):
        base = (None,
                _DENSE_RULES.get(name[:-len("_lora_b")], (None, None))[1])
    elif name in _SPECIAL and nd == len(_SPECIAL[name]):
        base = _SPECIAL[name]
    elif nd == 3 and name in _MOE_RULES:
        base = _MOE_RULES[name]
    elif nd == 2 and name in _DENSE_RULES:
        base = _DENSE_RULES[name]
    else:
        base = (None,) * nd       # norms, biases, scalars: replicated
    if stacked:
        base = (None,) + tuple(base)
    return P(*base)


def _filter_axes(spec: P, axis_names) -> P:
    """Drop mesh axes that do not exist on the current mesh."""
    def ok(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a in axis_names)
            return kept if kept else None
        return e if e in axis_names else None
    return P(*(ok(e) for e in spec))


def _fit_divisibility(spec: P, shape, axis_sizes) -> P:
    """Drop sharding on dims the mesh axes do not divide evenly (e.g. a
    51866-entry vocab over a 16-way 'model' axis).  Axes are dropped from
    the right of a tuple entry until the product divides the dim."""
    if not axis_sizes:
        return spec
    out = []
    for i, e in enumerate(spec):
        if e is None:
            out.append(None)
            continue
        axes = list(e) if isinstance(e, (tuple, list)) else [e]
        while axes:
            prod = 1
            for a in axes:
                prod *= axis_sizes.get(a, 1)
            if shape[i] % prod == 0:
                break
            axes.pop()
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def _is_tensor_like(v) -> bool:
    return hasattr(v, "shape") and not isinstance(v, (dict, list, tuple))


def map_specs(fn, tree, *rest):
    """``fn`` applied leaf by leaf over a tree whose leaves are ``P``s
    (and over trees of the same structure beside it)."""
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_specs(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def param_specs(params, axis_names=("data", "model"), axis_sizes=None, *,
                lead: int = 0):
    """The spec tree of a base, adapter or optimizer-moment tree in the
    port's layout: each tensor leaf by its name (the nearest dict key),
    ``lead`` leading replicated dimensions (a client axis) before the
    rules' dims.  ``axis_sizes`` (the mesh's sizes) enables divisibility
    fitting."""
    def one(name, shape):
        core = tuple(shape[lead:])
        s = _filter_axes(_leaf_spec(name, core, False), axis_names)
        return P(*((None,) * lead), *_fit_divisibility(s, core, axis_sizes))

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            items = [walk(v, name) for v in tree]
            return type(tree)(*items) if hasattr(tree, "_fields") \
                else type(tree)(items)
        return one(name, tuple(tree.shape))

    return walk(params, None)


def batch_axes(axis_names) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names)


def _scalar_axis(e):
    """P(('data',)) and P('data') mean the same sharding: canonicalize
    1-tuples to the bare axis name, as JAX's comparison needs."""
    if isinstance(e, (tuple, list)) and len(e) == 1:
        return e[0]
    return e


def batch_specs(batch, axis_names, *, batch_sharded=True):
    """Spec tree for an input batch: leading dim over ('pod','data')."""
    ba = batch_axes(axis_names) if batch_sharded else ()

    def leaf(x):
        if len(x.shape) == 0:
            return P()
        if x.shape[0] == 1 or not ba:
            return P(*((None,) * len(x.shape)))
        return P(_scalar_axis(ba), *((None,) * (len(x.shape) - 1)))

    return tree_map(leaf, batch)


def cache_specs(cache, axis_names, batch: int, axis_sizes=None, *,
                n_groups: int = 1):
    """Decode caches: batch over ('pod','data') when divisible, the
    longest axis of at least 1024 over 'model' when divisible.  JAX's
    rule reads ``ndim >= 3`` of a group-stacked leaf as "a group axis
    comes first", so each unrolled leaf is ruled as ``(n_groups,
    *shape)`` and the group entry dropped."""
    ba = batch_axes(axis_names)
    tp = TP if TP in axis_names else None

    def divides(axes, dim):
        if not axis_sizes:
            return True
        prod = 1
        for a in (axes if isinstance(axes, (tuple, list)) else [axes]):
            prod *= axis_sizes.get(a, 1)
        return dim % prod == 0

    def leaf(x):
        dims = [n_groups] + list(x.shape)
        spec = [None] * len(dims)
        gdim = 1 if len(dims) >= 3 else 0
        if (batch > 1 and ba and len(dims) > gdim and dims[gdim] == batch
                and divides(ba, batch)):
            spec[gdim] = _scalar_axis(ba)
        rest = [(i, d) for i, d in enumerate(dims)
                if i > gdim and d >= 1024 and divides(tp, d)]
        if rest and tp:
            i, _ = max(rest, key=lambda t: t[1])
            spec[i] = tp
        return P(*spec[1:])

    return tree_map(leaf, cache)


def packed_gather_spec(name: str) -> P:
    """Sharding for a QLoRA-packed weight at its use site: keep the
    'model' (TP) shard, drop the 'data' (FSDP) shard, so the FSDP
    all-gather moves the PACKED int4 bytes."""
    in_ax, out_ax = _DENSE_RULES.get(name, (None, None))
    keep = lambda ax: ax if ax == TP else None  # noqa: E731
    return P(keep(in_ax), keep(out_ax))


_MESH: List = []


@contextlib.contextmanager
def use_mesh(mesh):
    """The mesh that ``mesh_axis_size`` and ``head_axis_choice`` read
    inside the block (JAX's ``set_mesh``)."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh():
    return _MESH[-1] if _MESH else None


def axis_sizes_of(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_size(name: str) -> int:
    """Size of a mesh axis under the current mesh (1 if absent)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return int(axis_sizes_of(mesh).get(name, 1))


def head_axis_choice(KH: int, G: int) -> tuple:
    """For grouped-attention tensors laid out (..., KH, G, ...): which of
    the two head dims can carry the 'model' axis?  Returns (kh_axis,
    g_axis) — exactly one is 'model' when divisible, favoring KH."""
    tp = mesh_axis_size(TP)
    if tp <= 1:
        return (None, None)
    if KH % tp == 0:
        return (TP, None)
    if G % tp == 0:
        return (None, TP)
    return (None, None)


def placements(mesh, spec: P) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dimension an entry ``i`` names, ``Replicate()`` elsewhere (and
    on a mesh dimension of size 1, where the two are one layout)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes_of(mesh)
    out = [Replicate()] * len(names)
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and sizes[a] > 1:
                out[names.index(a)] = Shard(i)
    return out


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as its DTensor placements on ``mesh``
    (JAX's ``NamedSharding`` tree)."""
    return map_specs(lambda s: placements(mesh, s), spec_tree)


def fitted(mesh, spec: P, shape) -> P:
    """``spec`` less the axes ``mesh`` lacks or that do not divide."""
    return _fit_divisibility(_filter_axes(spec, mesh.mesh_dim_names),
                             shape, axis_sizes_of(mesh))


def is_dtensor(x) -> bool:
    # no DTensor exists until its module is imported, and the card path
    # off a mesh never imports it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x, spec: P):
    """``x`` redistributed to ``spec`` (filtered and fitted to its mesh)
    when it is a DTensor; any other tensor as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(mesh, fitted(mesh, spec, x.shape))
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)
