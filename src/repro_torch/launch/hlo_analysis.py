"""Collective statistics and roofline terms of a dry-run trace.

The counterpart of ``repro/launch/hlo_analysis.py``, under its name so a
reader finds it.  The port compiles no HLO and reads none: the dry run
(``launch/dryrun.py``) counts each device's work while it traces the
step on fake tensors, and this module turns those counts into the JAX
record's fields.

- ``roofline_terms`` is JAX's, copied, priced with the H100 constants of
  ``launch/mesh.py`` (the collective term over ``COLLECTIVE_BW``).
- ``collective_stats``: per kind, the count and the per-device output
  bytes of the collectives the trace issued (DTensor's
  ``_c10d_functional`` ops), under JAX's kind names.

Not ported, each with its reason:

- ``_computation_spans`` and ``loop_multipliers`` parse HLO's loop nest;
  the trace has none.  The one loop it folds, the train step's
  microbatch loop, ``run_one`` weights by the microbatch count.
- ``collective_stats_weighted``: its counterpart is ``collective_stats``
  under that same weighting.
- ``weighted_hlo_cost``: its counterpart is the kernels' tally
  (``kernels/counts.py``) plus torch's FLOP formulas
  (``torch.utils.flop_counter``) applied to each device's shards.
- ``remat_duplication`` reads fusion signatures, which the trace does
  not have; a rematerialised layer group shows as its forward counted
  twice.
- ``total_collective_bytes`` is the sum of ``collective_stats``' bytes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from repro_torch.launch import mesh as mesh_mod

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op name -> JAX's collective kind
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_stats(events: Iterable[Tuple[str, int]],
                     weight: int = 1) -> Dict[str, Dict[str, int]]:
    """Per collective kind: {count, bytes} (per-device output bytes) of
    ``events``, ``(kind, bytes)`` pairs, each counted ``weight`` times."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for kind, nbytes in events:
        out[kind]["count"] += weight
        out[kind]["bytes"] += nbytes * weight
    return out


def merge_stats(*stats) -> Dict[str, Dict[str, int]]:
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for st in stats:
        for k, v in st.items():
            out[k]["count"] += v["count"]
            out[k]["bytes"] += v["bytes"]
    return out


def roofline_terms(*, flops_per_chip: float, hbm_bytes_per_chip: float,
                   collective_bytes_per_chip: float) -> Dict[str, float]:
    """Three-term roofline (seconds).  Inputs are per-chip quantities of
    the partitioned step, so no further division by chip count."""
    compute = flops_per_chip / mesh_mod.PEAK_FLOPS_BF16
    memory = hbm_bytes_per_chip / mesh_mod.HBM_BW
    collective = collective_bytes_per_chip / mesh_mod.COLLECTIVE_BW
    dom = max((("compute", compute), ("memory", memory),
               ("collective", collective)), key=lambda t: t[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dom}
