"""kimi-k2-1t-a32b [moe] — trillion-param MoE (DeepSeek-V3 family).

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840,
MoE 384e top-8 + 1 shared expert.  [arXiv:2501.kimi2]
(Simplification noted in DESIGN.md: first-dense-layer of DSv3 folded into
the uniform MoE pattern for scan homogeneity.)
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, LoRAConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    source="arXiv:2501.kimi2",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared_experts=1),
    rope_theta=50000.0,
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=True,    # SWA variant for long_500k (beyond-paper)
    long_decode_window=8192,
)
