"""Architecture registry: ``get(name)`` resolves ``--arch`` ids.

The port of ``repro/configs/registry.py``: every name of the JAX
package resolves, with the ``-smoke`` form of each (``base.reduced``).
The assigned configs are the dense ``stablelm-3b``, ``starcoder2-7b``
and ``llama3-405b``, the mixture-of-experts ``kimi-k2-1t-a32b`` and
``llama4-maverick-400b-a17b``, the latent-attention ``minicpm3-4b``, the
Mamba hybrid ``jamba-1.5-large-398b``, the recurrent ``xlstm-125m``, the
encoder-decoder ``whisper-large-v3`` (audio frontend) and the
vision-language ``qwen2-vl-72b`` (vision frontend, M-RoPE); then the
paper's LLMs.  An unknown name raises ``KeyError``, as in the JAX
package.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs import paper_models
from repro_torch.configs.base import ModelConfig, reduced

_ASSIGNED = {
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

_PAPER = {
    "llama3.2-1b": paper_models.LLAMA32_1B,
    "gpt2": paper_models.GPT2,
    "deepseek-llm-7b-base": paper_models.DEEPSEEK_7B,
    "tiny-llm": paper_models.TINY_LLM,
}


def all_names() -> List[str]:
    return list(_ASSIGNED) + list(_PAPER)


def get(name: str) -> ModelConfig:
    if name in _ASSIGNED:
        return importlib.import_module(_ASSIGNED[name]).CONFIG
    if name in _PAPER:
        return _PAPER[name]
    if name.endswith("-smoke"):
        return reduced(get(name[: -len("-smoke")]))
    raise KeyError(f"unknown arch {name!r}; known: {all_names()}")
