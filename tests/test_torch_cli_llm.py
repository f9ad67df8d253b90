"""Both training CLIs on ``llm-qfl`` (Step 1 of 2 steps, the batched
engine, half the clients selected): ``history.json`` held as in
``tests/test_torch_cli.py``."""
import torch
from torch_noisy import history_matches_jax

torch.set_num_threads(1)


def test_llm_qfl_history_matches_jax(tmp_path, capsys):
    history_matches_jax(tmp_path, capsys, [
        "--method", "llm-qfl", "--llm-steps", "2", "--engine", "batched",
        "--select-frac", "0.5"])
