"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period-8 pattern with one attention layer per period (1:7) and MoE every
other layer (Jamba paper layout).  [arXiv:2403.19887]
"""
from repro_torch.configs.base import (LoRAConfig, MambaConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=(
        ("mamba", "mlp"), ("mamba", "moe"),
        ("mamba", "mlp"), ("mamba", "moe"),
        ("attn",  "mlp"), ("mamba", "moe"),
        ("mamba", "mlp"), ("mamba", "moe"),
    ),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=10000.0,
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=True,    # Mamba state + sparse attention layers
    long_decode_window=0,         # attention layers keep full cache (9 layers)
)
