"""The decoder stack: segments of global and sliding-window GQA blocks.

A model is a sequence of ``Segment``s; a segment applies its ``pattern``
of block kinds ``repeats`` times. The reference stacks each pattern
position's parameters on a leading axis and ``lax.scan``s over the
repeats; the port keeps one module per layer (``stacked.p<i>`` is a
``ModuleList`` over the segment's repeats) and loops **repeat-major**, as
the reference's scan body does: for each repeat, every pattern position in
order (gemma3's ``(attn_local,)*5 + (attn,)`` runs five local layers, then
a global one, eight times). The per-layer modules map onto the stacked
checkpoint leaves by their index (``repro_torch.checkpoint.interop``).
``RunConfig.remat`` checkpoints each block with
``torch.utils.checkpoint``. Decode caches follow the same layout:
``caches["seg<s>"]["p<i>"][r]`` is the cache of pattern position i in
repeat r (``attention.cache_init``), updated in place by the forward.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MLA, MAMBA2,
                                      MLSTM, SHARED_ATTN, SLSTM,
                                      ModelConfig)
from repro_torch.models.attention import GQA, cache_init
from repro_torch.models.common import (RMSNorm, dtype_of, embed_init,
                                       dense_init)
from repro_torch.models.mlp import MLP


# the slice that ports each block kind the port does not have yet
_LATER = {ATTN_MLA: "the MLA slice (deepseek-v2)",
          SHARED_ATTN: "the SSM slice (zamba2's shared attention)",
          MAMBA2: "the SSM slice (zamba2)",
          MLSTM: "the xLSTM slice", SLSTM: "the xLSTM slice"}


class Block(nn.Module):
    """Pre-norm attention block (global or sliding-window GQA) + gated FFN,
    both with residuals."""

    def __init__(self, cfg: ModelConfig, kind, device, gen):
        super().__init__()
        dt = dtype_of(cfg)
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.inner = GQA(cfg, kind, device, gen)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.ffn = MLP(cfg, device, gen)

    def forward(self, x, positions, impl="auto", cache=None, q_offset=None):
        x = x + self.inner(self.norm1(x), positions, impl=impl, cache=cache,
                           q_offset=q_offset)
        return x + self.ffn(self.norm2(x))


class Segment(nn.Module):
    def __init__(self, cfg: ModelConfig, seg, device, gen):
        super().__init__()
        for kind in seg.pattern:
            if kind not in (ATTN, ATTN_LOCAL):
                raise NotImplementedError(
                    f"segment {seg} of {cfg.name}: {kind!r} blocks are "
                    f"not ported yet; {_LATER.get(kind, 'a later slice')} "
                    f"ports them")
        if cfg.moe.n_experts or seg.dense_ffn:
            raise NotImplementedError(
                f"segment {seg} of {cfg.name}: MoE FFNs are not ported "
                f"yet; the MoE slice (granite-moe-3b-a800m) ports them")
        if not cfg.d_ff:
            raise NotImplementedError(
                f"segment {seg} of {cfg.name}: blocks without an FFN are "
                f"not ported yet")
        self.stacked = nn.ModuleDict({
            f"p{pi}": nn.ModuleList(Block(cfg, kind, device, gen)
                                    for _ in range(seg.repeats))
            for pi, kind in enumerate(seg.pattern)})

    def forward(self, x, positions, remat=False, impl="auto", caches=None,
                q_offset=None):
        """The segment's layers, repeat-major (the reference's
        ``apply_segment``); ``caches`` is this segment's
        ``{"p<i>": [cache per repeat]}``."""
        for r in range(len(self.stacked["p0"])):
            for name, blocks in self.stacked.items():
                block = blocks[r]
                cache = None if caches is None else caches[name][r]
                if remat and torch.is_grad_enabled() and cache is None:
                    x = checkpoint(block, x, positions, impl, None, q_offset,
                                   use_reentrant=False)
                else:
                    x = block(x, positions, impl=impl, cache=cache,
                              q_offset=q_offset)
        return x


def segment_cache_init(cfg: ModelConfig, seg, batch: int, max_len: int,
                       dtype, device):
    return {f"p{pi}": [cache_init(cfg, kind, batch, max_len, dtype, device)
                       for _ in range(seg.repeats)]
            for pi, kind in enumerate(seg.pattern)}


def caches_init(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    return {f"seg{i}": segment_cache_init(cfg, seg, batch, max_len, dtype,
                                          device)
            for i, seg in enumerate(cfg.segments)}


class Transformer(nn.Module):
    """Embedding, segments, final norm and (tied or separate) LM head."""

    def __init__(self, cfg: ModelConfig, device, gen):
        super().__init__()
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                f"input_mode {cfg.input_mode!r} is not ported yet")
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init((cfg.vocab_size, cfg.d_model),
                                             dt, device, gen))
        self.segments = nn.ModuleDict({
            f"seg{i}": Segment(cfg, seg, device, gen)
            for i, seg in enumerate(cfg.segments)})
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(
                (cfg.d_model, cfg.vocab_size), dt, device, gen))

    def embed_inputs(self, batch):
        return self.embed[batch["tokens"].long()]

    def apply_stack(self, x, positions, remat=False, impl="auto",
                    caches=None, q_offset=None):
        """The segments and the final norm; ``caches`` (``caches_init``)
        are updated in place. ``q_offset``: see ``attention.attention_op``."""
        for name, seg in self.segments.items():
            x = seg(x, positions, remat=remat, impl=impl,
                    caches=None if caches is None else caches[name],
                    q_offset=q_offset)
        return self.final_norm(x)

    def logits_fn(self, hidden):
        w = self.embed.t() if self.cfg.tie_embeddings else self.lm_head
        return hidden @ w
