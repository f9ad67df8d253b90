"""Architecture registry: ``get(name)`` resolves ``--arch`` ids.

The port of ``repro/configs/registry.py`` for the families the port
runs: the assigned dense configs (``stablelm-3b``, ``starcoder2-7b``,
``llama3-405b``), the mixture-of-experts ones (``kimi-k2-1t-a32b``,
``llama4-maverick-400b-a17b``), the latent-attention ``minicpm3-4b``,
the Mamba hybrid ``jamba-1.5-large-398b``, the recurrent
``xlstm-125m``, the paper's LLMs, and the ``-smoke`` form of each
(``base.reduced``).  The other assigned architectures need the
encoder-decoder or the vision frontend, which the port does not have
yet, and raise ``NotImplementedError`` naming what they wait on; an
unknown name raises ``KeyError``, as in the JAX package.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs import paper_models
from repro_torch.configs.base import ModelConfig, reduced

_ASSIGNED = {
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

# assigned architectures of the model families still to port, and what
# each waits on
OTHER_FAMILIES = {
    "qwen2-vl-72b": "the vision frontend and mrope_sections",
    "whisper-large-v3": "the encoder-decoder and the audio frontend",
}

_PAPER = {
    "llama3.2-1b": paper_models.LLAMA32_1B,
    "gpt2": paper_models.GPT2,
    "deepseek-llm-7b-base": paper_models.DEEPSEEK_7B,
    "tiny-llm": paper_models.TINY_LLM,
}


def ported_names() -> List[str]:
    return list(_ASSIGNED) + list(_PAPER)


def get(name: str) -> ModelConfig:
    if name in _ASSIGNED:
        return importlib.import_module(_ASSIGNED[name]).CONFIG
    if name in _PAPER:
        return _PAPER[name]
    if name in OTHER_FAMILIES:
        raise NotImplementedError(
            f"{name!r} is not ported yet: it needs "
            f"{OTHER_FAMILIES[name]} (ROADMAP §1, 'the other model "
            f"families'); the port runs {ported_names()}")
    if name.endswith("-smoke"):
        return reduced(get(name[: -len("-smoke")]))
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{ported_names() + list(OTHER_FAMILIES)}")
