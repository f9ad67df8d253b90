"""LLM-QFL core (Alg. 1 + Sec. III): the orchestrator, the batched round
engine, and the control laws (regulation, selection, termination)."""
from repro_torch.core import regulation, selection, termination  # noqa: F401
from repro_torch.core.orchestrator import (  # noqa: F401
    LLMOutputs, Orchestrator, RunConfig, RunResult, run_experiment)
