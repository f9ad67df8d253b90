"""stablelm-3b [dense] — MHA dense.

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import ModelConfig, LoRAConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    pattern=(("attn", "mlp"),),
    rope_theta=10000.0,
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=True,    # SWA variant for long_500k (beyond-paper)
    long_decode_window=8192,
)
