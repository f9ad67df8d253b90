"""Why ``tests/test_torch_train_step.py`` holds jamba-1.5-large-398b-smoke
to ``JAMBA_TOL`` (3e-4 of the largest magnitude) and not 1e-5: a float64
witness.

The JAX package's own train step in float64 (``jax_enable_x64``, the
model modules' float32 casts lifted in memory by a stand-in for their
``jnp`` whose ``float32`` is ``float64``; no file changes) is the
function both float32 steps approximate.  On jamba-smoke's batch
(seed 3, one microbatch, remat), AdamW's first moment after one step of
each client parts from it by up to 2.5e-4 of the largest magnitude in
JAX's float32 step, and by up to 1.8e-4 in the port's: the random
weights give a loss of sharp curvature (a gradient norm of 43), so
float32 rounding alone is past 1e-5 in either package, and the port is
as near the float64 step as JAX is.  The witness runs in a process of
its own, since ``jax_enable_x64`` is global.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = "jamba-1.5-large-398b"


def witness() -> dict:
    """Each client's first moment after one step, as its largest gap to
    JAX's float64 step over that step's largest magnitude: JAX's float32
    step's (``jax``) and the port's (``port``)."""
    import importlib

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_train_step as T
    from repro_torch import convert
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    torch.set_num_threads(1)
    m = T.smoke_model(NAME, "float32")
    raw = T.draw_batch(m["tcfg"], seed=3)
    jadp, tadp = T.client_adapters(m)

    def f64(tree):
        return jax.tree.map(lambda x: x.astype(jnp.float64)
                            if jnp.issubdtype(x.dtype, jnp.floating)
                            else x, tree)

    def jax_mu(params, adp, batch) -> list:
        step = jax.jit(T.JM.make_train_step(m["jcfg"], n_microbatches=1,
                                            lr=T.LR))
        _, opt, _ = step(params, adp, T.jadamw.init(adp), batch)
        return [t.double().numpy() for t in tree_leaves(
            convert.adapters_from_jax(jax.tree.map(
                lambda x: np.asarray(x, np.float64), opt.mu)))]
    batches = [{k: jnp.asarray(v[c]) for k, v in raw.items()}
               for c in range(T.C)]
    j32 = [jax_mu(m["jp"], jadp[c], batches[c]) for c in range(T.C)]
    step = T.M.make_train_step(m["tcfg"], n_microbatches=1, lr=T.LR)
    _, opt, _ = step(m["tp"], tadp, adamw.init(tadp, n_clients=T.C),
                     T.port_batch(raw))
    port = [[t[c].double().numpy() for t in tree_leaves(opt.mu)]
            for c in range(T.C)]

    class Float64Jnp:
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)
    for mod in ("ssm", "model", "layers", "ffn", "attention", "common"):
        mod = importlib.import_module("repro.models." + mod)
        if hasattr(mod, "jnp"):
            mod.jnp = Float64Jnp()
    j64 = [jax_mu(f64(m["jp"]), f64(jadp[c]), f64(batches[c]))
           for c in range(T.C)]
    out = {"jax": [], "port": []}
    for c in range(T.C):
        top = max(float(np.abs(t).max()) for t in j64[c])
        for k, mu in (("jax", j32[c]), ("port", port[c])):
            out[k].append(max(float(np.abs(a - b).max())
                              for a, b in zip(mu, j64[c])) / top)
    return out


def test_jamba_float32_gap_is_rounding():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, __file__], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    gaps = json.loads(res.stdout.strip().splitlines()[-1])
    print(gaps)
    import test_torch_train_step as T
    jax_gap, port_gap = max(gaps["jax"]), max(gaps["port"])
    assert jax_gap > T.TOL            # beyond 1e-5 in JAX's float32 itself
    assert port_gap <= 2 * jax_gap    # the port as near the float64 step
    assert port_gap <= T.JAMBA_TOL


if __name__ == "__main__":
    print(json.dumps(witness()))
