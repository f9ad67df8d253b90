"""Analytic parameter counts (total and active) for the 6·N·D roofline
terms.

The port of ``repro/models/counting.py``: plain integer arithmetic over a
``ModelConfig``, kept as the port's own copy.  ``count_params`` counts
every weight of the base (the embedding table, the LM head when untied,
each layer, an encoder stack and its cross-attention add-on, the
frontend's projector); ``count_active_params`` counts a MoE layer's
router, its ``top_k`` routed experts and its shared ones in place of all
its experts.  ``ModelConfig.param_count`` and ``active_param_count``
return them.
"""
from __future__ import annotations


def _layer_params(cfg, mixer: str, ffn: str, cross: bool = False) -> tuple:
    """Returns (total, active) params of one layer."""
    d, H, KH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tot = 0
    if mixer == "attn":
        tot += d + d * H * D + d * 2 * KH * D + H * D * d
    elif mixer == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        tot += (d + d * m.q_lora_rank + m.q_lora_rank
                + m.q_lora_rank * H * qk
                + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * d)
    elif mixer == "mamba":
        mc = cfg.mamba
        ed = mc.expand * d
        dt_rank = mc.dt_rank or -(-d // 16)
        tot += (d + d * 2 * ed + mc.d_conv * ed + 2 * ed
                + ed * (dt_rank + 2 * mc.d_state) + dt_rank * ed
                + ed * mc.d_state + ed + ed * d)
    elif mixer == "mlstm":
        xc = cfg.xlstm
        ed = xc.expand * d
        tot += (d + d * 2 * ed + xc.conv_width * ed + ed
                + 3 * ed * ed + ed * 2 * H + 2 * H + ed + ed * d)
    elif mixer == "slstm":
        hd = d // H
        tot += d + d * 4 * d + H * hd * 4 * hd + 4 * d + d
    if cross:
        tot += d + d * H * D + d * 2 * KH * D + H * D * d
    act = tot
    if ffn == "mlp":
        ffd = cfg.d_ff
        if not ffd:
            ffd = int(d * (cfg.xlstm.slstm_ffn_factor if cfg.xlstm else 4))
            ffd = -(-ffd // 128) * 128
        w = d + d * 2 * ffd + ffd * d
        tot += w
        act += w
    elif ffn == "moe":
        m = cfg.moe
        expert = d * 2 * m.d_ff + m.d_ff * d
        tot += d + d * m.n_experts + m.n_experts * expert
        act += d + d * m.n_experts + m.top_k * expert
        if m.n_shared_experts:
            sh = (d * 2 * m.d_ff * m.n_shared_experts
                  + m.d_ff * m.n_shared_experts * d)
            tot += sh
            act += sh
    return tot, act


def count_params(cfg) -> int:
    tot = cfg.vocab_size * cfg.d_model                   # embed
    if not cfg.tie_embeddings:
        tot += cfg.d_model * cfg.vocab_size              # lm head
    tot += cfg.d_model                                   # final norm
    for (mixer, ffn) in cfg.pattern:
        t, _ = _layer_params(cfg, mixer, ffn)
        tot += t * cfg.n_groups
    if cfg.encoder_decoder:
        # decoder layers gain cross-attention; encoder stack mirrors pattern
        t, _ = _layer_params(cfg, "attn", "mlp", cross=True)
        t0, _ = _layer_params(cfg, "attn", "mlp")
        tot += (t - t0) * cfg.n_layers                   # cross-attn add-on
        tot += t0 * cfg.n_encoder_layers + cfg.d_model
    if cfg.frontend:
        tot += cfg.d_model * cfg.d_model                 # projector stub
    return int(tot)


def count_active_params(cfg) -> int:
    act = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        act += cfg.d_model * cfg.vocab_size
    act += cfg.d_model
    for (mixer, ffn) in cfg.pattern:
        _, a = _layer_params(cfg, mixer, ffn)
        act += a * cfg.n_groups
    if cfg.encoder_decoder:
        t, _ = _layer_params(cfg, "attn", "mlp", cross=True)
        t0, _ = _layer_params(cfg, "attn", "mlp")
        act += (t - t0) * cfg.n_layers
        act += t0 * cfg.n_encoder_layers + cfg.d_model
    if cfg.frontend:
        act += cfg.d_model * cfg.d_model
    return int(act)
