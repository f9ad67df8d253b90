"""The port's training CLI (``python -m repro_torch.launch.train``)
against the JAX package's (``repro.launch.train``): the same flags and
defaults plus ``--device``, the same printed round lines, and the same
``history.json``: its config and integers equal, its floats within the
noisy-parity tolerances (losses 1e-5, θ_g 1e-4, L_LLM and F1 5e-4 and
0.05, as ``tests/test_batched_llm.py``).  Experiment I's flags on a
small task: ``aersim`` (100 shots), Dirichlet 0.5 shards.
``tests/test_torch_cli_llm.py`` runs ``llm-qfl`` through both."""
import re

import pytest
import torch
from torch_noisy import history_matches_jax

from repro.launch import train as jax_train
from repro_torch.launch import train

torch.set_num_threads(1)


def test_flags_match(capsys):
    """JAX's options in its order, then ``--device``; the defaults are
    held by the runs' configs below."""
    opts = []
    for main in (train.main, jax_train.main):
        with pytest.raises(SystemExit):
            main(["--help"])
        text = capsys.readouterr().out.split("options:")[1]
        opts.append(re.findall(r"^  (--[a-z-]+(?: [A-Z_]+)?)", text, re.M))
    assert opts[0] == opts[1] + ["--device DEVICE"]
    assert len(opts[1]) == 19


def test_qfl_history_matches_jax(tmp_path, capsys):
    """The CLI's default engine (sequential) and optimizer."""
    history_matches_jax(tmp_path, capsys, ["--method", "qfl"])
