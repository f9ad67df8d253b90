"""Where the port's host loop parts from the JAX package's on the
Nelder–Mead ``qfl-nm`` configuration of ``tests/test_torch_fused_rounds.py``
(seed 3), stage by stage at round 0, then over the whole run:

- the tape's gate angles (both packages' round-0 inputs on the CPU);
- how often XLA's float32 ``sin``, ``cos``, ``exp`` and ``log`` differ
  from torch's on those angles, and from the port's emulations
  (``repro_torch.xla_trig`` for ``sin``/``cos``, ``random._log``);
- the gate matrices (``ref.gate_planes`` against the JAX tape's
  ``_MAT_FNS``), then the statevector gate by gate: the first gate whose
  output differs from JAX's jitted ``jnp_gate_apply``, with the port's
  pair update as it is and with its complex products fused as XLA's CPU
  code fuses them (``re = fma(g_r, a_r, -(g_i·a_i))``, ``im = fma(g_i,
  a_r, g_r·a_i)``: its object code holds vfmadd/vfmsub);
- ``|ψ|²`` (JAX: ``jnp.abs(psi) ** 2``, XLA's complex abs, then a
  square; the port: ``re² + im²``) and the parity readout's product, on
  the same inputs;
- the θ_g gap after 6 rounds, with the port as it is and with the fused
  pair update in its tape.

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
from repro.quantum import qnn as jqnn
from repro.quantum import tape as jtape
from repro_torch import random as jr
from repro_torch import xla_trig
from repro_torch.core.orchestrator import Orchestrator, RunConfig
from repro_torch.data.tasks import build_task
from repro_torch.kernels import ref
from repro_torch.quantum import qnn as tqnn
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


def fused_gate(psi_re, psi_im, g_re, g_im, target, control, n_qubits):
    """``ref.statevector_gate`` with each complex product's multiply-adds
    fused as XLA's CPU code fuses them (float32 FMA: ``random._fma_torch``)."""
    fma = jr._fma_torch
    idx0, idx1, cmask = ref.pair_indices(target, control, n_qubits,
                                         psi_re.device)
    a = [(psi_re[:, i], psi_im[:, i]) for i in (idx0, idx1)]

    def prod(i, j):
        gr, gi = g_re[:, i, j, None], g_im[:, i, j, None]
        ar, ai = a[j]
        return (fma(gr.expand_as(ar), ar, -(gi * ai)),
                fma(gi.expand_as(ar), ar, gr * ai))

    m = cmask[None, :]
    out_re, out_im = psi_re.clone(), psi_im.clone()
    for i, idx in ((0, idx0), (1, idx1)):
        p, q = prod(i, 0), prod(i, 1)
        out_re[:, idx] = m * (p[0] + q[0]) + (1.0 - m) * a[i][0]
        out_im[:, idx] = m * (p[1] + q[1]) + (1.0 - m) * a[i][1]
    return out_re, out_im


def first_gate_apart(cq, ja, gate):
    """The first gate whose output differs from JAX's, or -1."""
    tp = cq.tape
    n, B = tp.n_qubits, ja.shape[0]
    mats = ref.gate_planes(torch.as_tensor(tp.gate_id), torch.from_numpy(ja))
    apply = jax.jit(jtape.jnp_gate_apply, static_argnums=(2, 3, 4))
    psi = jnp.zeros((B, 1 << n), jnp.complex64).at[:, 0].set(1.0)
    re = torch.zeros((B, 1 << n))
    re[:, 0] = 1.0
    im = torch.zeros_like(re)
    for i, (t, c) in enumerate(zip(tp.target.tolist(), tp.control.tolist())):
        g = jnp.asarray(mats[0][i].numpy() + 1j * mats[1][i].numpy())
        psi = apply(psi, g, int(t), int(c), n)
        re, im = gate(re, im, mats[0][i], mats[1][i], int(t), int(c), n)
        p = np.asarray(psi)
        if not (np.array_equal(p.real, re.numpy())
                and np.array_equal(p.imag, im.numpy())):
            return i, None
    return -1, np.asarray(psi)


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
    emulated = dict(sin=xla_trig.sin, cos=xla_trig.cos, log=jr._log)
    for fn in ("sin", "cos", "exp", "log"):
        x = a if fn != "log" else np.abs(a) + np.float32(1e-3)
        j = np.asarray(jax.jit(getattr(jnp, fn))(jnp.asarray(x)))
        t = getattr(torch, fn)(torch.from_numpy(x)).numpy()
        out[f"{fn}_mismatches"] = int((j != t).sum())
        if fn in emulated:
            e = emulated[fn](torch.from_numpy(x)).numpy()
            out[f"{fn}_mismatches_emulated"] = int((j != e).sum())
    g_re, g_im = ref.gate_planes(torch.as_tensor(jcq.tape.gate_id),
                                 torch.from_numpy(ja))
    mats = [np.asarray(jax.jit(lambda v, g=int(g): jax.lax.switch(
        g, jtape._MAT_FNS, v))(jnp.asarray(ja[:, i])))
        for i, g in enumerate(jcq.tape.gate_id)]
    out["gate_matrices_bitwise"] = all(
        np.array_equal(m.real, g_re[i].numpy())
        and np.array_equal(m.imag, g_im[i].numpy())
        for i, m in enumerate(mats))
    out["first_gate_apart"], _ = first_gate_apart(jcq, ja,
                                                  ref.statevector_gate)
    out["first_gate_apart_fused"], psi = first_gate_apart(jcq, ja,
                                                          fused_gate)
    if psi is not None:
        jpr = np.asarray(jax.jit(lambda p: jnp.abs(p) ** 2)(psi))
        tpr = (torch.from_numpy(psi.real) ** 2
               + torch.from_numpy(psi.imag) ** 2).numpy()
        out["abs2_mismatches"] = [int((jpr != tpr).sum()), jpr.size]
        n = jcq.tape.n_qubits
        jc = np.asarray(jax.jit(lambda p: jqnn.parity_interpret(p, n, 2))(
            jnp.asarray(jpr)))
        tc = tqnn.parity_interpret(torch.from_numpy(jpr.copy()), n,
                                   2).numpy()
        out["parity_mismatches"] = [int((jc != tc).sum()), jc.size]
    gaps = {}
    for label in ("as it is", "fused pair update"):
        if label != "as it is":
            ref.statevector_tape.__defaults__ = (fused_gate,)
        _, jres, _, tres = runs(6)
        gaps[label] = float(np.abs(np.asarray(jres.theta_g)
                                   - np.asarray(tres.theta_g)).max())
    ref.statevector_tape.__defaults__ = (ref.statevector_gate,)
    out["theta_g_gap"] = gaps
    print(json.dumps(out))


if __name__ == "__main__":
    main()
