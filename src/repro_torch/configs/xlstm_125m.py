"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.

12L d_model=768 4H (kv=4) d_ff=0 (block-internal projections) vocab=50304.
Pattern alternates mLSTM (matrix memory, linear-attention-like, no post-FFN)
and sLSTM (scalar memory + gated FFN).  [arXiv:2405.04517]
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    pattern=(("mlstm", "none"), ("slstm", "mlp")),
    xlstm=XLSTMConfig(expand=2, slstm_ffn_factor=4 / 3, conv_width=4),
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("wq", "wkv", "wo")),
    supports_long_decode=True,    # recurrent state: O(1) decode
)
