"""llama3-405b [dense] — GQA, 128k vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
[arXiv:2407.21783]
"""
from repro_torch.configs.base import ModelConfig, LoRAConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    source="arXiv:2407.21783",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    pattern=(("attn", "mlp"),),
    rope_theta=500000.0,
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=True,    # SWA variant for long_500k (beyond-paper)
    long_decode_window=8192,
)
