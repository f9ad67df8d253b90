"""whisper-large-v3 [audio] — enc-dec speech backbone.

32L d_model=1280 20H (kv=20, i.e. MHA) d_ff=5120 vocab=51866.
Mel-spectrogram + conv frontend is a STUB: the caller gives precomputed
frame embeddings (1500 frames, ``batch["frontend"]``).  True
whisper-large-v3 is 32 encoder + 32 decoder layers; both stacks are
built.  Full attention in the encoder and in cross-attention, so no
long-context decode.  [arXiv:2212.04356]
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=32,                  # decoder layers
    n_encoder_layers=32,
    encoder_decoder=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    pattern=(("attn", "mlp"),),
    rope_theta=10000.0,           # we use rotary in place of learned-abs pos
    frontend="audio",
    n_frontend_tokens=1500,       # conv-downsampled mel frames
    lora=LoRAConfig(rank=16, alpha=32.0),
    supports_long_decode=False,   # skip long_500k (documented)
)
