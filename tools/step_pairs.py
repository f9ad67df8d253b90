"""Host-clock times of the port's serve and train steps, as
``chip_smoke.py`` times them, on the tree that ``PYTHONPATH`` puts first:
to compare two trees' per-call overhead on the model path.

    PYTHONPATH=TREE/src:. python3 tools/step_pairs.py LABEL

Run it from the root of a checkout on a machine with a CUDA card, once
for each tree to compare (parent, this, this, parent), in one call; the
timing functions are this checkout's ``chip_smoke.py`` (``serve_timed``,
``train_run``), the package under test the tree's.  Models, drawn from
``PRNGKey(0)`` as the smoke draws them: llama3.2-1b (phase 12's), the
first 8 layers of minicpm3-4b (phase 14's) and xlstm-125m (phase 16's).
Each is served (a 32-token prompt, 16 steps, 4 requests) twice, and the
last two are also trained as phase 19 trains them (4 requests of 128
tokens, 2 microbatches, remat) for 4 steps.  It prints one JSON line:
``{"tree": LABEL, "serve_step_ms": {model: [ms, ms]},
"train_step_ms": {model: [ms of steps 2-4]}}``.
"""
import json
import sys

import torch

import chip_smoke as cs


def main(label: str):
    from repro_torch import random as jr
    from repro_torch.configs.registry import get
    from repro_torch.tree import tree_map
    serve, train = {}, {}
    for cfg in (get(cs.SERVE_MODEL), cs.minicpm_cfg(), get(cs.XLSTM)):
        model, _, _, weight_bytes = cs.draw_family(cfg)
        prompts = cs.serve_prompts(cfg)
        serve[cfg.name] = [1e3 * cs.serve_timed(
            cfg, model, prompts[:, :min(cs.SERVE_PROMPTS)], cs.SERVE_STEPS,
            jr.PRNGKey(0), weight_bytes)["step_s"] for _ in range(2)]
        if cfg.name != cs.SERVE_MODEL:
            params, adapters = model
            model1 = (params, tree_map(lambda t: t[None], adapters))
            B, S = cs.TRAIN_B, cs.TRAIN_S
            batch = {"tokens": prompts[None, :B, :S],
                     "labels": prompts[None, :B, 1:S + 1]}
            run = cs.train_run(cfg, model1, batch, cs.TRAIN_NM, True, 4)
            train[cfg.name] = [1e3 * s for s in run["step_s"][1:]]
            del run, model1
        del model, prompts
        torch.cuda.empty_cache()
    print(json.dumps({"tree": label, "serve_step_ms": serve,
                      "train_step_ms": train}))


if __name__ == "__main__":
    main(sys.argv[1])
