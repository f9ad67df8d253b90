"""The sequential engine on finite-shot backends against the JAX
package's sequential engine, on its noisy SPSA parity configurations
(see ``tests/torch_noisy.py``), and the sampling's own properties: a
run is deterministic by seed, and ``shots_override=0`` (channel only)
changes the trajectory."""
import pytest
import torch
from torch_noisy import CONFIGS, assert_runs_match, run_pair, tasks

from repro_torch.core import run_experiment

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both_tasks():
    return tasks()


@pytest.mark.parametrize("name", ["spsa-fake", "shots10", "shots1000"])
def test_sequential_noisy_run_matches_jax(both_tasks, name):
    got, want, m = run_pair(name, "sequential", *both_tasks)
    assert_runs_match(got, want, m, f"sequential {name}")


def test_noisy_run_is_deterministic_and_samples(both_tasks):
    task = both_tasks[0]
    kw = dict(CONFIGS["noise-spsa"], device="cpu")
    a, b = run_experiment(task, **kw), run_experiment(task, **kw)
    assert a.series("server_loss") == b.series("server_loss")
    assert a.series("server_val_acc") == b.series("server_val_acc")
    assert (a.theta_g == b.theta_g).all()
    noshot = run_experiment(task, **dict(kw, shots_override=0))
    assert noshot.series("server_loss") != a.series("server_loss")
