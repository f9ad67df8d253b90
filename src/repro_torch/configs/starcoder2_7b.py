"""starcoder2-7b [dense] — GQA + RoPE + native sliding window (4096).

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.  [arXiv:2402.19173]
"""
from repro_torch.configs.base import ModelConfig, LoRAConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    source="arXiv:2402.19173",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    pattern=(("attn", "mlp"),),
    rope_theta=100000.0,
    sliding_window=4096,          # native SWA → legitimate long_500k
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=True,
    long_decode_window=4096,
)
