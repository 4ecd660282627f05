"""The LM: train-forward, per-sample loss + importance score, pruned pool
scoring, serving over KV caches (``repro.models.lm``).

The per-sample score is the paper's upper bound Ĝᵢ (eq. 20). For softmax
cross-entropy the last-layer pre-activation gradient is softmax(z) − 1_y,
so

    Ĝᵢ² ∝ Σ_tokens ‖softmax(z_t) − 1_{y_t}‖₂²
        = Σ_t [ exp(lse2_t − 2·lse_t) − 2·exp(z_{t,y} − lse_t) + 1 ]

with lse = logsumexp(z) and lse2 = logsumexp(2z).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of
from repro_torch.models.transformer import Transformer, caches_init


def _valid_mask(labels):
    return (labels >= 0).float()


def pad_labels(cfg, logits, labels):
    """Labels for ``logits``: an image prefix (``input_mode="tokens+image"``)
    puts ``logits.shape[1] − labels.shape[1]`` positions before the text,
    which carry no loss (label −1), as the reference pads them."""
    pad = logits.shape[1] - labels.shape[1]
    if cfg.input_mode == "tokens+image" and pad:
        labels = F.pad(labels, (pad, 0), value=-1)
    return labels


# ---------------------------------------------------------------------------
# per-token CE statistics (three implementations)
# ---------------------------------------------------------------------------
def token_stats_naive(logits, labels):
    """Paper-faithful reference: materialises the softmax gradient.
    Returns (ce, gnorm2) per token, f32."""
    z = logits.float()
    logp = torch.log_softmax(z, dim=-1)
    onehot = F.one_hot(labels.long(), z.shape[-1]).float()
    ce = -(logp * onehot).sum(-1)
    g = torch.exp(logp) - onehot              # the last-layer gradient itself
    return ce, g.square().sum(-1)


def token_stats_chunked(logits, labels, chunk=8192):
    """Streaming reductions over vocab chunks: lse, lse2, z_y only."""
    z = logits.float()
    V = z.shape[-1]
    chunk = min(chunk, V)
    pad = (-V) % chunk
    if pad:
        z = F.pad(z, (0, pad), value=-1e30)
    shape = z.shape[:-1]
    m1 = z.new_full(shape, float("-inf"))
    s1 = z.new_zeros(shape)
    m2 = z.new_full(shape, float("-inf"))
    s2 = z.new_zeros(shape)
    for zi in z.split(chunk, dim=-1):
        m1n = torch.maximum(m1, zi.amax(-1))
        s1 = s1 * torch.exp(m1 - m1n) + torch.exp(zi - m1n[..., None]).sum(-1)
        z2 = 2.0 * zi
        m2n = torch.maximum(m2, z2.amax(-1))
        s2 = s2 * torch.exp(m2 - m2n) + torch.exp(z2 - m2n[..., None]).sum(-1)
        m1, m2 = m1n, m2n
    lse = m1 + torch.log(s1)
    lse2 = m2 + torch.log(s2)
    zy = logits.float().gather(-1, labels.long()[..., None])[..., 0]
    ce = lse - zy
    gnorm2 = torch.exp(lse2 - 2 * lse) - 2 * torch.exp(zy - lse) + 1.0
    return ce, torch.clamp(gnorm2, min=0.0)


def token_stats_fused(logits, labels):
    """Direct reductions over the vocab axis (the production path)."""
    z = logits.float()
    m = z.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(z - m)
    s1 = e.sum(-1)
    s2 = e.square().sum(-1)
    lse = m[..., 0] + torch.log(s1)
    lse2 = 2.0 * m[..., 0] + torch.log(torch.clamp(s2, min=1e-30))
    zy = z.gather(-1, labels.long()[..., None])[..., 0]
    ce = lse - zy
    gnorm2 = torch.exp(lse2 - 2 * lse) - 2 * torch.exp(zy - lse) + 1.0
    return ce, torch.clamp(gnorm2, min=0.0)


def token_stats(logits, labels, impl="fused"):
    """``"pallas"`` is the per-token kernel K1 (``kernels.ce_score.ops.
    ce_score``): forward only, it raises under autograd, as the reference's
    ``jax.value_and_grad`` through its Pallas call does."""
    if impl == "naive":
        return token_stats_naive(logits, labels)
    if impl == "pallas":
        from repro_torch.kernels.ce_score import ops as ce_ops
        return ce_ops.ce_score(logits, labels)
    if impl == "chunked":
        return token_stats_chunked(logits, labels)
    if impl == "fused":
        return token_stats_fused(logits, labels)
    raise ValueError(f"unknown score_impl {impl!r}")


# ---------------------------------------------------------------------------
# model facade
# ---------------------------------------------------------------------------
class LM(Transformer):
    """The transformer plus the losses and scores Algorithm 1 needs.

    ``forward(batch)`` returns the logits; the scoring entries run it
    under ``torch.inference_mode`` with the floating parameters cast to
    ``score_dtype`` (``torch.func.functional_call`` over the cast copies;
    a cast to the parameters' own dtype copies nothing)."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        super().__init__(cfg, device, generator)

    # -- forward ------------------------------------------------------------
    def hidden(self, batch, *, remat=False, impl="auto"):
        """(hidden, aux). Without ``batch["positions"]`` every row sits at
        0..s−1 (an image prefix and its text together), which is the flash
        kernel's contract (``q_offset=0``); given positions take the plain
        attention paths."""
        x = self.embed_inputs(batch)
        b, s = x.shape[:2]
        positions = batch.get("positions")
        q_offset = None
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
            q_offset = 0
        return self.apply_stack(x, positions, remat=remat, impl=impl,
                                q_offset=q_offset)

    def logits(self, batch, *, remat=False, impl="auto"):
        """(logits, aux): the router aux summed over the layers."""
        h, aux = self.hidden(batch, remat=remat, impl=impl)
        return self.logits_fn(h), aux

    def forward(self, batch, remat=False, impl="auto"):
        return self.logits(batch, remat=remat, impl=impl)[0]

    def _score_logits(self, batch, params, score_dtype, impl):
        """Forward-only logits over ``params`` (default: the module's own)
        with the floating ones cast to ``score_dtype`` (call under
        ``torch.inference_mode``)."""
        if params is None:
            params = dict(self.named_parameters())
        if score_dtype is not None:
            dt = getattr(torch, score_dtype) \
                if isinstance(score_dtype, str) else score_dtype
            params = {n: (p.to(dt) if p.is_floating_point() else p)
                      for n, p in params.items()}
        return functional_call(self, params, (batch,), {"impl": impl})

    # -- training loss ------------------------------------------------------
    def loss(self, batch, *, remat=True, impl="auto", score_impl="fused"):
        """Mean (optionally per-sample-weighted) CE + router aux. Returns
        (loss, metrics); ``batch["weights"]`` (b,) are the unbiasedness
        weights."""
        logits, aux = self.logits(batch, remat=remat, impl=impl)
        labels = pad_labels(self.cfg, logits, batch["labels"])
        mask = _valid_mask(labels)
        ce, _ = token_stats(logits, torch.clamp(labels, min=0),
                            impl=score_impl)
        per_sample = (ce * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
        w = batch.get("weights")
        loss = per_sample.mean() if w is None else (per_sample * w).mean()
        return loss + aux, {"ce": per_sample.mean(), "aux": aux,
                            "tokens": mask.sum()}

    # -- per-sample loss + importance score (forward only) -------------------
    def sample_stats(self, batch, *, params=None, score_impl="fused",
                     impl="auto", score_dtype=None):
        """Returns (per_sample_loss, per_sample_score) — one forward pass,
        no gradients: the paper's scoring phase (Algorithm 1, line 7)."""
        with torch.inference_mode():
            logits = self._score_logits(batch, params, score_dtype, impl)
            labels = pad_labels(self.cfg, logits, batch["labels"])
            mask = _valid_mask(labels)
            ce, g2 = token_stats(logits, torch.clamp(labels, min=0),
                                 impl=score_impl)
            denom = torch.clamp(mask.sum(-1), min=1.0)
            loss_ps = (ce * mask).sum(-1) / denom
            score = torch.sqrt(torch.clamp((g2 * mask).sum(-1), min=1e-20))
        return loss_ps, score

    def pool_stats_pruned(self, batch, ctx, *, k, params=None,
                          score_dtype=None, impl="auto"):
        """Survival-pruned twin of ``sample_stats`` for the fused presample
        pool: the CE pass runs chunked over time blocks through the
        ``ce_score_block`` kernel
        (``repro_torch.kernels.fused_presample.ops.pruned_pool_score``) and
        rows whose race key can no longer reach the top-(k+1) stop being
        scored. Returns (per_sample_loss, scores, alive, prune_stats):
        survivor scores are bitwise the unpruned chunked pass's."""
        from repro_torch.kernels.fused_presample.ops import pruned_pool_score
        with torch.inference_mode():
            logits = self._score_logits(batch, params, score_dtype, impl)
            scores, alive, loss_ps, stats = pruned_pool_score(
                logits, pad_labels(self.cfg, logits, batch["labels"]), ctx,
                k=k)
        return loss_ps, scores, alive, stats

    # -- serving ------------------------------------------------------------
    def caches(self, batch_size, max_len, dtype=None):
        """Empty decode caches on the model's device, one per layer."""
        return caches_init(self.cfg, batch_size, max_len,
                           dtype or dtype_of(self.cfg),
                           self.final_norm.scale.device)

    def serve_step(self, caches, batch, *, impl="auto", q_offset=None):
        """One serve step: ``batch["tokens"]`` (b, s) new tokens (or the
        input mode's ``embeds``, or ``image_embeds`` before the tokens) at
        ``batch["positions"]`` (b, s), or at q_offset + arange(s) in every
        row when ``q_offset`` is given instead. Prefill = long s into empty
        caches; decode = s == 1 into filled caches, updated in place.
        Returns (logits of the last position (b, 1, V), caches).

        ``q_offset`` is also the caller's word about *global* caches: every
        slot below it holds its own position (filled from slot 0, as
        ``repro_torch.serve`` keeps them); then their attention on the card
        runs through the flash kernel. A sliding-window layer's ring
        decides from its own capacity and from whether every write put
        position p at slot p % capacity, which it tracks from ``q_offset``
        (``attention.ring_write_in_order``): before the wrap it holds the
        same word, after it (one token at a time, a ring of
        ``sliding_window`` slots written in order) every slot is valid.
        The prefill of a prompt longer than the ring, and every decode step
        after it unless the prompt's length is a multiple of the ring's,
        take the plain paths (``attention.flash_route``). Explicit
        positions take the plain paths, which read the masks from them."""
        x = self.embed_inputs(batch)
        positions = batch.get("positions")
        if q_offset is not None:
            if positions is not None:
                raise ValueError("serve_step takes positions or q_offset, "
                                 "not both")
            b, s = x.shape[:2]
            positions = torch.arange(q_offset, q_offset + s,
                                     dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        h, _ = self.apply_stack(x, positions, impl=impl, caches=caches,
                                q_offset=q_offset)
        return self.logits_fn(h[:, -1:]), caches
