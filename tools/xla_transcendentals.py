"""Where the port's host loop parts from the JAX package's on the
Nelder–Mead ``qfl-nm`` configuration of ``tests/test_torch_fused_rounds.py``
(seed 3): both packages' round-0 inputs on the CPU, the tape's gate
angles, the class probabilities of both tapes at the same parameters,
and how often XLA's float32 ``sin``, ``cos``, ``exp`` and ``log`` differ
from torch's on those angles; then the whole 6-round θ_g gap with the
port's objective taking XLA's ``log`` (``repro_torch.random._log``) in
place of ``torch.log``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_transcendentals.py

It imports both packages (a comparison, like the tests); prints one
JSON line.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.orchestrator import Orchestrator as JaxOrchestrator
from repro.core.orchestrator import RunConfig as JaxRunConfig
from repro.data.tasks import build_task as jax_build_task
from repro.quantum import tape as jtape
from repro_torch import random as jr
from repro_torch.core import batched_engine
from repro_torch.core.orchestrator import Orchestrator, RunConfig
from repro_torch.data.tasks import build_task
from repro_torch.quantum import tape as ttape

TASK = dict(n_clients=3, train_size=90, test_size=45, val_size=30, seed=5)
RUN = dict(method="qfl", optimizer="nelder-mead", maxiter0=3,
           early_stop=False, seed=3)


def runs(n_rounds: int):
    kw = dict(RUN, n_rounds=n_rounds, engine="batched", rounds="host")
    jo = JaxOrchestrator(jax_build_task("genomic", **TASK),
                         JaxRunConfig(**kw))
    to = Orchestrator(build_task("genomic", **TASK), RunConfig(**kw),
                      device="cpu")
    return jo, jo.run(), to, to.run()


def main():
    torch.set_num_threads(1)
    jo, _, to, _ = runs(1)
    qX = np.asarray(jo._engine._qX)
    theta = np.random.default_rng(0).standard_normal(
        (qX.shape[0], jo.spec.n_params)).astype(np.float32)
    jcq, tcq = jtape.compile_qnn(jo.spec), ttape.compile_qnn(to.spec)
    fwd = jax.jit(lambda t, x: jtape.tape_probs(jcq, t, x))
    jp = np.stack([np.asarray(fwd(jnp.asarray(t), jnp.asarray(x)))
                   for t, x in zip(theta, qX)])
    tp = ttape.tape_probs(tcq, torch.from_numpy(theta)[:, None],
                          torch.from_numpy(qX)[:, None]).numpy()[:, 0]
    ja = np.asarray(jtape.tape_angles(jcq.tape, jnp.asarray(qX[0]),
                                      jnp.asarray(theta[0])))
    ta = ttape.tape_angles(tcq.tape, torch.from_numpy(qX[0]),
                           torch.from_numpy(theta[0])).numpy()
    a = np.concatenate([ja.ravel(), ja.ravel() / 2]).astype(np.float32)
    out = dict(angles_max_diff=float(np.abs(ja - ta).max()),
               probs_max_diff=float(np.abs(jp - tp).max()), values=a.size)
    for fn in ("sin", "cos", "exp", "log"):
        x = a if fn != "log" else np.abs(a) + np.float32(1e-3)
        j = np.asarray(jax.jit(getattr(jnp, fn))(jnp.asarray(x)))
        t = getattr(torch, fn)(torch.from_numpy(x)).numpy()
        out[f"{fn}_mismatches"] = int((j != t).sum())
    gaps = {}
    for label in ("torch.log", "XLA log"):
        if label == "XLA log":
            class XlaLog:
                log = staticmethod(jr._log)

                def __getattr__(self, k):
                    return getattr(torch, k)
            batched_engine.torch = XlaLog()
        _, jres, _, tres = runs(6)
        gaps[label] = float(np.abs(np.asarray(jres.theta_g)
                                   - np.asarray(tres.theta_g)).max())
    batched_engine.torch = torch
    out["theta_g_gap"] = gaps
    print(json.dumps(out))


if __name__ == "__main__":
    main()
