"""Shared configurations and checks of the noisy whole-run parity tests
(``tests/test_torch_noisy_*.py``, ``tests/test_torch_cli*.py``): the port's ``run_experiment`` against
the JAX package's on the JAX package's own finite-shot parity
configurations (``tests/test_batched_engine.py``, ``tests/test_noise.py``),
engine for engine.

Each run is held to JAX's: ``maxiters``, ``selected`` and ``cum_evals``
exactly, server and client losses within 1e-5, θ_g within 1e-4.  The
smallest distance between a draw and a CDF boundary over the port's run
(``backends.track_margin``) is printed with the number of draws within
1e-6 of one.  Over a whole run, millions of draws on the 2**-23 grid
put a few within 1e-6 of a boundary by chance alone (about 2e-6 of
them), so the margin cannot be held above 1e-6 here.  The number of
near draws is held to its chance rate instead (``chance_bound``): a
count above it means the draws cluster at the boundaries, where the
pinned seed no longer makes the run safe.
"""
import json

import numpy as np

from repro.core.orchestrator import run_experiment as jax_run
from repro.data.tasks import build_task as jax_build_task
from repro.launch import train as jax_train
from repro_torch.core import run_experiment
from repro_torch.data.tasks import build_task
from repro_torch.launch import train
from repro_torch.quantum import backends

# JAX's small_task: 3 equal shards of 30 rows (equal shards, so the two
# engines' draw shapes agree too)
TASK = dict(n_clients=3, train_size=90, test_size=45, val_size=30, seed=5)
CONFIGS = {
    # tests/test_batched_engine.py
    "spsa-fake": dict(method="qfl", optimizer="spsa", n_rounds=2,
                      maxiter0=4, early_stop=False, backend="fake", seed=4),
    "nm-fake": dict(method="qfl", optimizer="nelder-mead", n_rounds=3,
                    maxiter0=5, early_stop=False, backend="fake"),
    "nm-aersim": dict(method="qfl", optimizer="nelder-mead", n_rounds=3,
                      maxiter0=5, early_stop=False, backend="aersim"),
    "llm-fake": dict(method="llm-qfl", optimizer="nelder-mead", n_rounds=3,
                     maxiter0=5, llm_steps=8, early_stop=False, seed=2,
                     backend="fake"),
    # tests/test_noise.py
    "noise-spsa": dict(method="qfl", optimizer="spsa", n_rounds=2,
                       maxiter0=3, early_stop=False, backend="fake", seed=4),
    "shots10": dict(method="qfl", optimizer="spsa", n_rounds=1, maxiter0=2,
                    early_stop=False, backend="fake", seed=4,
                    shots_override=10),
    "shots1000": dict(method="qfl", optimizer="spsa", n_rounds=1,
                      maxiter0=2, early_stop=False, backend="fake", seed=4,
                      shots_override=1000),
}


def tasks():
    return (build_task("genomic", **TASK),
            jax_build_task("genomic", **TASK))


def run_pair(name: str, engine: str, task, jtask):
    """The port's run on the CPU (margin tracked) and JAX's."""
    kw = dict(CONFIGS[name], engine=engine)
    with backends.track_margin() as m:
        got = run_experiment(task, device="cpu", **kw)
    return got, jax_run(jtask, **kw), m


def assert_runs_match(got, want, m, what: str):
    for attr in ("maxiters", "selected", "cum_evals"):
        assert got.series(attr) == want.series(attr), (what, attr)
    np.testing.assert_allclose(got.series("server_loss"),
                               want.series("server_loss"), atol=1e-5,
                               rtol=0, err_msg=what)
    np.testing.assert_allclose(got.series("client_losses"),
                               want.series("client_losses"), atol=1e-5,
                               rtol=0, err_msg=what)
    np.testing.assert_allclose(got.theta_g, want.theta_g, atol=1e-4,
                               rtol=0, err_msg=what)
    print(f"{what}: smallest draw-to-boundary distance {m.value:.3g} over "
          f"{m.draws} draws, {m.near} within {m.NEAR} (chance allows "
          f"{m.chance_bound():.1f})")
    assert m.draws > 0 and m.near <= m.chance_bound(), what


# the training CLIs: Experiment I's flags on a small task
COMMON = ["--task", "genomic", "--backend", "aersim", "--non-iid-alpha",
          "0.5", "--no-early-stop", "--clients", "3", "--train-size", "60",
          "--rounds", "2"]


def _run(main, argv, out, capsys):
    main(argv + ["--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round")]
    return json.loads((out / "history.json").read_text()), lines


def history_matches_jax(tmp_path, capsys, extra):
    """Both CLIs with ``COMMON + extra``: ``history.json`` and the printed
    round lines held to JAX's."""
    got, got_lines = _run(train.main, COMMON + extra + ["--device", "cpu"],
                          tmp_path / "port", capsys)
    want, want_lines = _run(jax_train.main, COMMON + extra,
                            tmp_path / "jax", capsys)
    assert got.keys() == want.keys()
    assert got["config"] == want["config"]
    assert got["terminated_early"] == want["terminated_early"]
    assert got_lines == want_lines and len(got_lines) == 2
    for r, w in zip(got["rounds"], want["rounds"]):
        assert r.keys() == w.keys()
        for k in ("t", "maxiters", "selected", "cum_evals"):
            assert r[k] == w[k], k
        for k in ("server_loss", "client_losses", "ratios", "var_all",
                  "var_selected", "server_val_acc", "server_test_acc",
                  "comm_time_s"):
            np.testing.assert_allclose(r[k], w[k], atol=1e-5, rtol=0,
                                       err_msg=k)
    np.testing.assert_allclose(got["theta_g"], want["theta_g"], atol=1e-4)
    np.testing.assert_allclose(got["llm_losses"], want["llm_losses"],
                               atol=5e-4)
    np.testing.assert_allclose(got["llm_f1"], want["llm_f1"], atol=0.05)
