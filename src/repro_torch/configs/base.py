"""Model configuration: the dense fields of ``repro/configs/base.py``.

The port runs dense decoder LLMs only (``pattern == (("attn", "mlp"),)``),
so ``ModelConfig`` keeps the fields those use; the mixture-of-experts,
latent-attention, state-space and encoder-decoder fields come with the
ROADMAP item "the other model families".  ``LoRAConfig.quantize_base``
selects QLoRA: ``models.model.init_params`` then stores every adapted
base weight as packed int4 plus scales (``peft.lora.quantize``).  LoRA
dropout is left out: the JAX package never applies it.
Field names, defaults and ``head_dim`` inference are the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

LayerSpec = Tuple[str, str]


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # which weight families receive adapters
    targets: Tuple[str, ...] = ("wq", "wkv", "wo", "w_in", "w_out")
    quantize_base: bool = False    # QLoRA: int4 base weights


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # "dense" in the port
    source: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    pattern: Tuple[LayerSpec, ...] = (("attn", "mlp"),)
    rope_theta: float = 500000.0
    sliding_window: int = 0                # 0 = full attention
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {len(self.pattern)}")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)
