"""Model configuration: ``repro/configs/base.py`` for the families the
port runs.

The port runs LLMs whose layers mix ``"attn"`` (grouped-query), ``"mla"``
(multi-head latent attention, ``MLAConfig``), ``"mamba"`` (the selective
state-space mixer, ``MambaConfig``) or ``"mlstm"`` / ``"slstm"`` (the
xLSTM mixers, ``XLSTMConfig``) with an ``"mlp"``, ``"moe"`` (mixture of
experts, ``MoEConfig``) or ``"none"`` feed-forward block; a decoder may
sit behind an encoder stack (``encoder_decoder``, ``n_encoder_layers``:
whisper) and read stub frontend embeddings (``frontend`` ``"audio"`` or
``"vision"``, ``n_frontend_tokens`` of them a request), and its rotary
embeddings may be sectioned (``mrope_sections``: qwen2-vl's M-RoPE).
So ``ModelConfig`` keeps every field of the JAX package's, and
``reduced`` derives the ``-smoke`` variant of a config as the JAX
package does (it leaves ``mamba`` and ``xlstm`` as they are; an
encoder-decoder's encoder gets the decoder's depth, a frontend 16
tokens, and M-RoPE sections are rescaled to the reduced head dim).
``LoRAConfig.quantize_base`` selects QLoRA: ``models.model.init_params``
then stores every adapted base weight as packed int4 plus scales
(``peft.lora.quantize``).  LoRA dropout is left out: the JAX package
never applies it.  Field names, defaults and ``head_dim`` inference are
the JAX package's.  ``InputShape`` and ``INPUT_SHAPES`` are the dry
run's four shapes, copied.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

LayerSpec = Tuple[str, str]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared_experts: int = 0      # DeepSeek/Kimi-style always-on experts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    balance_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    expand: int = 2                # mLSTM inner expansion
    slstm_ffn_factor: float = 4 / 3
    conv_width: int = 4


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # which weight families receive adapters
    targets: Tuple[str, ...] = ("wq", "wkv", "wo", "w_in", "w_out")
    quantize_base: bool = False    # QLoRA: int4 base weights


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense|moe|ssm|hybrid|vlm|audio
    source: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    pattern: Tuple[LayerSpec, ...] = (("attn", "mlp"),)
    rope_theta: float = 500000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl sectioned rotary
    sliding_window: int = 0                # 0 = full attention
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    # enc-dec (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frontend_tokens: int = 0     # frames/patches of the stub frontend
    frontend: str = ""             # ""|"audio"|"vision"
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # long-context policy
    supports_long_decode: bool = False     # sub-quadratic decode path exists
    long_decode_window: int = 8192         # SWA window used for long_500k

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {len(self.pattern)}")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        from repro_torch.models.counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_active_params
        return count_active_params(self)


# ---------------------------------------------------------------------------
# Input shapes (the dry run's assignment table)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def reduced(cfg: ModelConfig, *, d_model: int = 256, n_groups: int = 1,
            vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests, field for field
    the JAX package's ``reduced`` over the fields the port has (at most
    4 experts, top-2, one shared expert; MLA at ranks 64 and 32; the
    encoder as deep as the decoder, 16 frontend tokens, M-RoPE sections
    rescaled in proportion to the reduced head dim)."""
    period = len(cfg.pattern)
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = 1 if cfg.n_kv_heads < cfg.n_heads else n_heads
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=period * n_groups,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=d_model * 2 if cfg.d_ff else 0,
        vocab_size=vocab,
        n_encoder_layers=period * n_groups if cfg.encoder_decoder else 0,
        n_frontend_tokens=16 if cfg.frontend else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else 0,
        long_decode_window=64,
        lora=dataclasses.replace(cfg.lora, rank=4))
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff=d_model * 2,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1))
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
    if cfg.mrope_sections:
        half = (d_model // n_heads) // 2
        tot = sum(cfg.mrope_sections)
        secs = [max(1, s * half // tot) for s in cfg.mrope_sections]
        secs[-1] += half - sum(secs)
        kw["mrope_sections"] = tuple(secs)
    return dataclasses.replace(cfg, **kw)
