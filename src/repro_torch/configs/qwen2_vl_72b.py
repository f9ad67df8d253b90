"""qwen2-vl-72b [vlm] — Qwen2-VL 72B language backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE, dynamic
resolution.  Vision encoder (ViT) is a STUB: the caller gives precomputed
patch embeddings (``batch["frontend"]``), which the model prepends to
the prompt.
[arXiv:2409.12191]
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(("attn", "mlp"),),
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),     # temporal/height/width rotary sections
    frontend="vision",
    n_frontend_tokens=1024,          # stub patch embeddings per example
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=True,       # SWA variant for long_500k (beyond-paper)
    long_decode_window=8192,
)
