"""GQA attention (``kind == "attn"``) with two execution paths, as in
``repro.models.attention``:

* ``online`` — blockwise attention with an online softmax over KV chunks
  (and Q chunks); never materialises the full (Sq, Skv) score matrix.
* ``naive`` — plain einsum attention, for tiny shapes and as the oracle.

Both are plain torch matmul and softmax in f32. The hand-written flash
attention kernel (the reference's ``flash_attention_pallas``) is ported in
its own slice. KV caches, MLA and the sliding window are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import apply_rope, dense_init, dtype_of

NEG_INF = -1e30


def _mask(q_pos, kv_pos):
    """(…, sq, skv) boolean mask: causal and validity."""
    m = kv_pos[..., None, :] <= q_pos[..., :, None]
    return m & (kv_pos[..., None, :] >= 0)


def naive_attention(q, k, v, q_pos, kv_pos, scale=None):
    """q: (b,sq,hq,hd); k,v: (b,skv,hkv,hd). Oracle path."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale or hd ** -0.5
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.float(), k.float()) * scale
    mask = _mask(q_pos, kv_pos)[:, None, None]                 # b,1,1,sq,skv
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    return o.reshape(b, sq, hq, hd).to(q.dtype)


def _pad_to(x, n, dim, value=0):
    pad = (-x.shape[dim]) % n
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=dim)


def online_attention(q, k, v, q_pos, kv_pos, *, scale=None, q_chunk=2048,
                     kv_chunk=1024):
    """Blockwise attention with online softmax (the flash schedule in
    plain torch); the peak live score tensor is (b, hq, q_chunk,
    kv_chunk) in f32."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale or hd ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, k.shape[1])

    qp = _pad_to(q, q_chunk, 1).float()
    qpp = _pad_to(q_pos, q_chunk, 1, value=-(10 ** 9))  # pad rows see nothing
    kp = _pad_to(k, kv_chunk, 1).float()
    vp = _pad_to(v, kv_chunk, 1).float()
    kpp = _pad_to(kv_pos, kv_chunk, 1, value=-1)        # invalid kv slots
    nq = qp.shape[1] // q_chunk
    nk = kp.shape[1] // kv_chunk

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qblk = qp[:, qs].reshape(b, q_chunk, hkv, g, hd)
        qpos = qpp[:, qs]
        acc = qblk.new_zeros((b, hkv, g, q_chunk, hd))
        m = qblk.new_full((b, hkv, g, q_chunk), NEG_INF)
        l = qblk.new_zeros((b, hkv, g, q_chunk))
        for ki in range(nk):
            ks = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kp[:, ks]) * scale
            msk = _mask(qpos, kpp[:, ks])[:, None, None]
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd",
                                                       p, vp[:, ks])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]        # b,hkv,g,qc,hd
        outs.append(out.permute(0, 3, 1, 2, 4))                 # b,qc,hkv,g,hd
    out = torch.cat(outs, dim=1).reshape(b, nq * q_chunk, hq, hd)
    return out[:, :sq].to(q.dtype)


def attention_op(q, k, v, q_pos, kv_pos, *, scale=None, impl="auto"):
    if impl == "naive" or (impl == "auto" and
                           (q.shape[1] <= 16 or
                            q.shape[1] * k.shape[1] <= 256 * 256)):
        return naive_attention(q, k, v, q_pos, kv_pos, scale)
    return online_attention(q, k, v, q_pos, kv_pos, scale=scale)


class GQA(nn.Module):
    """Grouped-query self-attention with RoPE (train/prefill, no cache)."""

    def __init__(self, cfg, device, gen):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.wq = nn.Parameter(dense_init((d, hq * hd), dt, device, gen))
        self.wk = nn.Parameter(dense_init((d, hkv * hd), dt, device, gen))
        self.wv = nn.Parameter(dense_init((d, hkv * hd), dt, device, gen))
        self.wo = nn.Parameter(dense_init((hq * hd, d), dt, device, gen))

    def forward(self, x, positions, impl="auto"):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q = (x @ self.wq).reshape(b, s, cfg.n_heads, hd)
        k = (x @ self.wk).reshape(b, s, cfg.n_kv_heads, hd)
        v = (x @ self.wv).reshape(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attention_op(q, k, v, positions, positions, impl=impl)
        return o.reshape(b, s, cfg.n_heads * hd) @ self.wo
