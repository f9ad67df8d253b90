"""minicpm3-4b [dense] — MLA (multi-head latent attention).

62L d_model=2560 40H (kv=40 — MLA shares a compressed latent) d_ff=6400
vocab=73448.  [hf:openbmb/MiniCPM3-4B]
"""
from repro_torch.configs.base import ModelConfig, MLAConfig, LoRAConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    source="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    pattern=(("mla", "mlp"),),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0,
    lora=LoRAConfig(rank=16, alpha=32.0,
                    targets=("wq_a", "wq_b", "wkv_a", "wkv_b", "wo",
                             "w_in", "w_out")),
    supports_long_decode=True,    # SWA variant for long_500k (beyond-paper)
    long_decode_window=8192,
)
