"""The ``'clients'`` axis of the batched engines, over several devices.

The port of the clients-axis half of ``repro/distributed/sharding.py``.
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
