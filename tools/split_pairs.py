"""Graph times of ``lora_matmul`` (forward and dx) and ``int4_matmul``
(NN and NT) at every shape of ``chip_smoke.py``'s tables where more than
one client shares a launch, on the tree that ``PYTHONPATH`` puts first:
the shapes where planning the reduction's split from one client's tiles
(a grid under one wave) can change a launch.

The kernels plan their split from the whole grid.  The per-client plan
is kept as an experiment, ``tools/per_client_split.patch``: it adds
``per_client`` to ``lora_matmul._launch`` and ``client_rows`` to the
``int4_matmul`` entry points.  To compare the two plans, unpack the tree
twice and apply the patch to one copy (``git apply``), then run

    PYTHONPATH=TREE/src:. python3 tools/split_pairs.py LABEL

from the root of a checkout on a machine with a CUDA card, once for each
copy (plain, patched, patched, plain), in one call.  It prints one JSON
line: ``{"tree": LABEL, "per_client": bool, "times": {shape: ms}}``.  A
tree without the patch is timed with the whole grid's plan.
"""
import inspect
import json
import sys

import torch

import chip_smoke as cs


def main(label: str):
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.peft import lora
    gen = torch.Generator(device="cuda").manual_seed(0)
    patched = "per_client" in inspect.signature(lm._launch).parameters
    lm_kw = {"per_client": True} if patched else {}
    out = {}
    for name, C, M, K, N, r in cs.LORA_SHAPES:
        if C < 2:
            continue
        x = cs._randn(gen, (C, M, K))
        w = cs._randn(gen, (K, N), K ** -0.5)
        a = cs._randn(gen, (C, K, r), K ** -0.5)
        b = cs._randn(gen, (C, r, N), 0.1)
        dy = cs._randn(gen, (C, M, N))
        out[f"lora {name}"] = cs.graph_ms(lambda: lm._launch(
            x, w, a, b, 2.0, **lm_kw))
        out[f"lora {name} dx"] = cs.graph_ms(lambda: lm._launch(
            dy, w.t(), b.transpose(1, 2), a.transpose(1, 2), 2.0, **lm_kw))
        del x, w, a, b, dy
    for name, M, K, N in cs.INT4_SHAPES:
        C = 5 if name.startswith("tiny") else 4
        packed, scales = lora.quantize(cs._randn(gen, (K, N), 0.05), 64)
        x, dy = cs._randn(gen, (M, K)), cs._randn(gen, (M, N))
        kw = {"client_rows": M // C} if patched else {}
        out[f"int4 {name} NN"] = cs.graph_ms(lambda: i4._launch(
            x, packed, scales, 64, torch.float32, False, **kw))
        out[f"int4 {name} NT"] = cs.graph_ms(lambda: i4._launch(
            dy, packed, scales, 64, torch.float32, True, **kw))
    print(json.dumps({"tree": label, "per_client": patched,
                      "times": out}))


if __name__ == "__main__":
    main(sys.argv[1])
