"""GQA attention (``kind == "attn"``) and its decode-time KV cache, as in
``repro.models.attention``. Three execution paths:

* ``online`` — blockwise attention with an online softmax over KV chunks
  (and Q chunks); never materialises the full (Sq, Skv) score matrix.
* ``naive`` — plain einsum attention, for tiny shapes and as the oracle.
* ``flash`` — the flash-attention forward (K5,
  ``repro_torch.kernels.flash_attn``) on CUDA tensors, for forward-only
  callers that know the positional contract holds (``attention_op``'s
  ``q_offset``): the scoring forward, serve prefill and decode. The
  reference's ``attention_op`` never reaches its flash kernel; the port
  adds this route. Training keeps the plain autograd paths: K5, like its
  Pallas original, has no backward. On the CPU the same calls keep the
  first two paths, whose memory stays bounded by the chunks.

The first two are plain torch matmul and softmax in f32. The cache is
updated in place (the reference donates it to ``jit``). MLA and the
sliding window (and its ring-buffer cache) are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN
from repro_torch.models.common import apply_rope, dense_init, dtype_of

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def cache_init(cfg, kind, batch, max_len, dtype, device):
    """Decode-time cache for one global attention layer: ``k``, ``v``
    (batch, max_len, hkv, hd) and ``pos`` (batch, max_len) int32, −1 where
    a slot is empty."""
    if kind != ATTN:
        raise NotImplementedError(
            f"{kind!r} caches (ring buffer, MLA) are not ported yet")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device)}


def _dus_insert(cache, new, positions):
    """Write ``new`` tensors (b, s, ...) into ``cache`` IN PLACE at slots
    start..start+s−1, start = positions[0, 0] % cap clamped to cap − s
    (the reference's ``dynamic_update_slice``; batched serving keeps
    positions aligned across the batch). If s ≥ cap only the trailing cap
    entries are kept. The start stays on the device: no host sync. Returns
    the cache's tensors (k, v, pos)."""
    names = list(new)
    cap = cache[names[0]].shape[1]
    s = new[names[0]].shape[1]
    if s >= cap:
        new = {k: t[:, -cap:] for k, t in new.items()}
        positions = positions[:, -cap:]
        s = cap
    start = torch.clamp(positions[0, 0].long() % cap, max=cap - s)
    slots = start + torch.arange(s, device=positions.device)
    for k in names:
        cache[k].index_copy_(1, slots, new[k].to(cache[k].dtype))
    cache["pos"].index_copy_(1, slots, positions.to(cache["pos"].dtype))
    return (*(cache[k] for k in names), cache["pos"])


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


def attention_op(q, k, v, q_pos, kv_pos, *, scale=None, impl="auto",
                 q_offset=None):
    """``q_offset`` is the caller's word that the flash kernel's positional
    contract holds: query i sits at position q_offset + i in every row, and
    kv slot j holds position j for j < q_offset + sq (later slots are empty
    or beyond the causal horizon). The scoring forward (positions arange)
    and serving into a global cache that holds prompt and generation give
    it. Then a forward-only call (grad mode off) on CUDA tensors under
    ``impl="auto"`` runs K5 over the kv prefix; everything else takes the
    plain paths, which read the masks from ``q_pos``/``kv_pos``."""
    n = None if q_offset is None else q_offset + q.shape[1]
    if impl == "auto" and q.is_cuda and n is not None and n <= k.shape[1] \
            and not torch.is_grad_enabled():
        from repro_torch.kernels.flash_attn.ops import flash_attention
        return flash_attention(q, k[:, :n], v[:, :n], causal=True,
                               q_offset=q_offset, scale=scale)
    if impl == "naive" or (impl == "auto" and
                           (q.shape[1] <= 16 or
                            q.shape[1] * k.shape[1] <= 256 * 256)):
        return naive_attention(q, k, v, q_pos, kv_pos, scale)
    return online_attention(q, k, v, q_pos, kv_pos, scale=scale)


class GQA(nn.Module):
    """Grouped-query self-attention with RoPE. Without a cache: causal
    self-attention over x (train, scoring). With one: x is the new token
    block at ``positions``; its K/V go into the cache in place and the
    queries attend over the cache (serve prefill and decode)."""

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

    def forward(self, x, positions, impl="auto", cache=None, q_offset=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q = (x @ self.wq).reshape(b, s, cfg.n_heads, hd)
        k = (x @ self.wk).reshape(b, s, cfg.n_kv_heads, hd)
        v = (x @ self.wv).reshape(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if cache is None:
            o = attention_op(q, k, v, positions, positions, impl=impl,
                             q_offset=q_offset)
        else:
            ck, cv, cp = _dus_insert(cache, {"k": k, "v": v}, positions)
            o = attention_op(q, ck, cv, positions, cp, impl=impl,
                             q_offset=q_offset)
        return o.reshape(b, s, cfg.n_heads * hd) @ self.wo
