"""The paper's LLMs (Sec. IV / App. J), as ``ModelConfig``s.

Copies of ``repro/configs/paper_models.py``: the base models the paper
LoRA fine-tunes on each quantum client, Meta-LLaMA-3.2-1B, GPT-2 (the
124M "gpt2" layout) and DeepSeek-LLM-7B-Base, and ``TINY_LLM``, the
reduced member of the llama family that the federated driver
fine-tunes by default.  Weights are drawn at random from a seed.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

LLAMA32_1B = ModelConfig(
    name="llama3.2-1b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    pattern=(("attn", "mlp"),),
    rope_theta=500000.0,
    tie_embeddings=True,
    lora=LoRAConfig(rank=8, alpha=16.0),
)

GPT2 = ModelConfig(
    name="gpt2",
    arch_type="dense",
    source="Radford et al. 2019",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50304,            # padded 50257 → multiple of 128
    pattern=(("attn", "mlp"),),
    rope_theta=10000.0,          # rotary stand-in for learned positions
    tie_embeddings=True,
    lora=LoRAConfig(rank=8, alpha=16.0),
)

DEEPSEEK_7B = ModelConfig(
    name="deepseek-llm-7b-base",
    arch_type="dense",
    source="hf:deepseek-ai/deepseek-llm-7b-base",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    pattern=(("attn", "mlp"),),
    rope_theta=10000.0,
    lora=LoRAConfig(rank=8, alpha=16.0),
)

# Tiny proxy used by the federated driver: same family as llama3.2-1b,
# small enough to fine-tune from scratch in-process.
TINY_LLM = ModelConfig(
    name="tiny-llm",
    arch_type="dense",
    source="reduced llama family (CPU federated driver)",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    pattern=(("attn", "mlp"),),
    rope_theta=10000.0,
    lora=LoRAConfig(rank=4, alpha=8.0),
)
