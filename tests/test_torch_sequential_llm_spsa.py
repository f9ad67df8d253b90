"""The port's sequential LLM-QFL with SPSA against the JAX package's, on
the JAX run's Step 1; the tolerances of ``test_torch_sequential_llm.py``.
"""
import pytest
import torch

from test_torch_sequential_llm import check_rounds_match_jax, jax_run

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_runs():
    return {"spsa": jax_run("spsa")}


def test_llm_qfl_sequential_spsa_rounds_match_jax(jax_runs):
    check_rounds_match_jax(jax_runs, "spsa")
