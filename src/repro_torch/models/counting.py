"""Analytic parameter counting per config, for sizing a configuration and
checking the initialised parameters (the parameter counts of
``repro.models.counting``: pure arithmetic on the config)."""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2,
                                      MLSTM, SHARED_ATTN, SLSTM)


def _attn_params(cfg, kind):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if kind == ATTN_MLA:
        m = cfg.mla
        qd = m.nope_head_dim + m.rope_head_dim
        return (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qd
                + d * (m.kv_lora_rank + m.rope_head_dim)
                + m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * d)
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d


def _ffn_params(cfg, dense_ffn, active_only):
    d = cfg.d_model
    m = cfg.moe
    if m.n_experts and not dense_ffn:
        routed = (m.n_experts_pad or m.n_experts) * 3 * d * m.d_expert
        if active_only:
            routed = m.top_k * 3 * d * m.d_expert
        shared = 3 * d * m.d_expert * m.n_shared_experts
        return d * m.n_experts + routed + shared
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return mult * d * cfg.d_ff if cfg.d_ff else 0


def _recurrent_params(cfg, kind):
    d = cfg.d_model
    sc = cfg.ssm
    if kind == MAMBA2:
        d_in = sc.expand * d
        nh = d_in // sc.head_dim
        return (d * (2 * d_in + 2 * sc.d_state + nh)
                + sc.d_conv * (d_in + 2 * sc.d_state) + 3 * nh + d_in + d_in * d)
    if kind == MLSTM:
        d_in = 2 * d
        nh = cfg.n_heads
        return d * 2 * d_in + 4 * d_in + 3 * d_in * d_in + d_in * 2 * nh + d_in + d_in * d
    if kind == SLSTM:
        nh = cfg.n_heads
        hd = d // nh
        return d * 4 * d + nh * hd * 4 * hd + d * d + d
    raise ValueError(kind)


def _block_params(cfg, kind, dense_ffn, active_only):
    d = cfg.d_model
    n = d  # norm1
    if kind in (ATTN, ATTN_LOCAL, ATTN_MLA, SHARED_ATTN):
        k = ATTN if kind == SHARED_ATTN else kind
        n += _attn_params(cfg, k)
        if cfg.d_ff or cfg.moe.n_experts:
            n += d + _ffn_params(cfg, dense_ffn, active_only)
    else:
        n += _recurrent_params(cfg, kind)
    return n


def count_params(cfg, active_only=False):
    total = 0
    if cfg.input_mode in ("tokens", "tokens+image"):
        total += cfg.vocab_size * cfg.d_model
    for seg in cfg.segments:
        shared_counted = False
        for kind in seg.pattern:
            if kind == SHARED_ATTN:
                if not shared_counted:
                    total += _block_params(cfg, kind, seg.dense_ffn, active_only)
                    shared_counted = True
                continue
            total += seg.repeats * _block_params(cfg, kind, seg.dense_ffn, active_only)
    total += cfg.d_model  # final norm
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    return total
