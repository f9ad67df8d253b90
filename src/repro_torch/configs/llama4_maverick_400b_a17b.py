"""llama4-maverick-400b-a17b [moe] — Llama-4 Maverick-class MoE.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1,
interleaved dense/MoE layers + shared expert (early-fusion family).
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, LoRAConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    # Maverick interleaves dense and MoE layers 1:1.
    pattern=(("attn", "mlp"), ("attn", "moe")),
    moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, n_shared_experts=1),
    rope_theta=500000.0,
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=True,       # chunked-attention family; SWA variant
    long_decode_window=8192,
)
