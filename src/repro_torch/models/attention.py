"""GQA attention (``kind`` "attn", global, and "attn_local", sliding
window) and its decode-time KV caches, as in ``repro.models.attention``.
Three execution paths:

* ``online`` — blockwise attention with an online softmax over KV chunks
  (and Q chunks); never materialises the full (Sq, Skv) score matrix. With
  a window each Q chunk visits only a static-width band of KV chunks.
* ``naive`` — plain einsum attention, for tiny shapes and as the oracle.
* ``flash`` — the flash-attention forward (K5,
  ``repro_torch.kernels.flash_attn``) on CUDA tensors, for forward-only
  callers whose call meets the kernel's positional contract
  (``flash_route``): the scoring forward, serve prefill and decode over
  global caches and over rings written in order. The reference's ``attention_op`` never
  reaches its flash kernel; the port adds this route. Training keeps the
  plain autograd paths: K5, like its Pallas original, has no backward. On
  the CPU the same calls keep the first two paths, whose memory stays
  bounded by the chunks.

The first two are plain torch matmul and softmax in f32. A global layer's
cache has one slot per position; a sliding-window layer's is a ring of
``min(max_len, sliding_window)`` slots, with each slot's position stored
beside it so the masks stay exact, and a host flag ``in_order`` that says
whether every write put position p at slot p % length. Caches are updated in place (the
reference donates them to ``jit``). MLA is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN, ATTN_LOCAL
from repro_torch.models.common import apply_rope, dense_init, dtype_of

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def cache_init(cfg, kind, batch, max_len, dtype, device):
    """Decode-time cache for one attention layer: ``k``, ``v``
    (batch, length, hkv, hd) and ``pos`` (batch, length) int32, −1 where a
    slot is empty. ``length`` is ``max_len`` for a global layer and
    ``min(max_len, cfg.sliding_window)`` for a sliding-window one (a
    ring). A ring also carries ``in_order`` (a Python bool, True while
    every write put position p at slot p % length; ``ring_write_in_order``),
    which ``flash_route`` reads."""
    if kind not in (ATTN, ATTN_LOCAL):
        raise NotImplementedError(
            f"{kind!r} caches (MLA) are not ported yet")
    length = min(max_len, cfg.sliding_window) if kind == ATTN_LOCAL \
        else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "pos": torch.full((batch, length), -1, dtype=torch.int32,
                               device=device)}
    if kind == ATTN_LOCAL:
        cache["in_order"] = True
    return cache


def _dus_insert(cache, new, positions):
    """Write ``new`` tensors (b, s, ...) into ``cache`` IN PLACE at slots
    start..start+s−1, start = positions[0, 0] % cap clamped to cap − s
    (the reference's ``dynamic_update_slice``; batched serving keeps
    positions aligned across the batch). If s ≥ cap only the trailing cap
    entries are kept, at slot 0: a ring then holds the prompt's last cap
    keys, and the queries before them see none (the reference's rule; its
    docstring leaves multi-token blocks that would wrap unsupported).
    Single-token decode wraps step by step. The start stays on the device:
    no host sync. Returns the cache's tensors (k, v, pos)."""
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


def _mask(q_pos, kv_pos, window=0):
    """(…, sq, skv) boolean mask: causal, windowed, and validity."""
    m = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window and window > 0:
        m = m & (kv_pos[..., None, :] > q_pos[..., :, None] - window)
    return m & (kv_pos[..., None, :] >= 0)


def naive_attention(q, k, v, q_pos, kv_pos, window=0, scale=None):
    """q: (b,sq,hq,hd); k,v: (b,skv,hkv,hd). Oracle path."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale or hd ** -0.5
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg.float(), k.float()) * scale
    mask = _mask(q_pos, kv_pos, window)[:, None, None]         # b,1,1,sq,skv
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


def online_attention(q, k, v, q_pos, kv_pos, *, window=0, scale=None,
                     q_chunk=2048, kv_chunk=1024):
    """Blockwise attention with online softmax (the flash schedule in
    plain torch); the peak live score tensor is (b, hq, q_chunk,
    kv_chunk) in f32.

    With a window, Q chunk qi (positions [qi·qc, (qi+1)·qc), as the
    reference assumes: row i and kv slot j at positions i and j) needs the
    keys in [qi·qc − window + 1, (qi+1)·qc − 1]. The band starts at the
    reference's chunk (qi·qc − window) // kc and is
    (window + qc − 1) // kc + 2 chunks wide: enough for any pair of chunk
    sizes, since ⌊a/kc⌋ − ⌊b/kc⌋ ≤ ⌊(a − b)/kc⌋ + 1. The reference's
    (window + qc) // kc + 1 misses a chunk when qc < kc (window 8, qc 16,
    kc 32: the q chunk at 32 needs keys 25..47, chunks 0 and 1). The masks
    still come from the positions, so the band only skips chunks."""
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
    band = nk
    if window and window > 0:
        band = min(nk, (window + q_chunk - 1) // kv_chunk + 2)

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qblk = qp[:, qs].reshape(b, q_chunk, hkv, g, hd)
        qpos = qpp[:, qs]
        start = 0
        if band < nk:
            start = min(max((qi * q_chunk - window) // kv_chunk, 0),
                        nk - band)
        acc = qblk.new_zeros((b, hkv, g, q_chunk, hd))
        m = qblk.new_full((b, hkv, g, q_chunk), NEG_INF)
        l = qblk.new_zeros((b, hkv, g, q_chunk))
        for ki in range(start, start + band):
            ks = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            s = torch.einsum("bqkgd,bckd->bkgqc", qblk, kp[:, ks]) * scale
            msk = _mask(qpos, kpp[:, ks], window)[:, None, None]
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


def ring_write_in_order(q_offset, s, cap):
    """Whether ``_dus_insert`` of the positions q_offset .. q_offset + s − 1
    into a ring of ``cap`` slots puts each position p it keeps at slot
    p % cap. Pure, on the host. A block of s ≥ cap keeps its last cap
    positions at slot 0, in order only when q_offset + s is a multiple of
    cap (a prompt of 100 into 64 slots puts position 36 at slot 0); a
    shorter block starts at q_offset % cap unless the clamp to cap − s
    moves it. ``q_offset`` None (positions unknown here): False."""
    if q_offset is None:
        return False
    if s >= cap:
        return (q_offset + s) % cap == 0
    return q_offset % cap + s <= cap


def flash_route(q_offset, sq, skv, window=0, ring=False, in_order=True):
    """Whether and how one attention call meets K5's positional contract
    (query i at position ``q_offset + i``, key j at position j): returns
    ``(n, causal, window, q_offset)`` for K5 over the first ``n`` kv slots,
    or None for the plain paths. Pure: it reads only the call's numbers.

    ``q_offset`` is the caller's word that query i sits at position
    q_offset + i in every row and that kv slot j holds position j for
    j < q_offset + sq (None: no such word, the plain paths). ``skv`` is
    the number of kv slots (the cache's capacity, or sq without a cache),
    ``window`` the layer's (0 for a global layer), ``ring`` whether the
    slots are a sliding-window layer's ring (``cache_init``) and
    ``in_order`` whether every write into that ring, this call's included,
    put position p at slot p % skv (the ring's ``in_order`` flag).

    * A ring not written in order (a prompt longer than the ring whose
      length is not a multiple of it, and every decode step after it):
      the plain paths. Its slots hold positions out of step with the
      slots, which only the stored positions mask right.
    * No cache (the scoring forward, q_offset 0), a global cache, or a
      ring with q_offset + sq ≤ skv (the prefill of a prompt no longer
      than the ring, and decode before the wrap: slot j still holds
      position j): K5 over the first q_offset + sq slots, causal, with the
      layer's window.
    * A ring, sq == 1, past the wrap, with skv == window (decode after the
      wrap): written in order, position by position, every slot holds one
      of the last ``window`` positions, so every slot is valid: K5 over
      all skv slots, not causal, no window, q_offset 0. Softmax does not
      depend on the order of the keys, so this is exact.
    * Anything else, such as a prefill longer than the ring (the
      reference's rows that see no key), takes the plain paths (K5's
      wrapper refuses rows without a key)."""
    if q_offset is None or (ring and not in_order):
        return None
    n = q_offset + sq
    if n <= skv:
        return n, True, window, q_offset
    if ring and sq == 1 and skv == window:
        return skv, False, 0, 0
    return None


def attention_op(q, k, v, q_pos, kv_pos, *, window=0, scale=None,
                 impl="auto", q_offset=None, ring=False, in_order=True):
    """A forward-only call (grad mode off) on CUDA tensors under
    ``impl="auto"`` runs K5 where ``flash_route(q_offset, sq, skv, window,
    ring, in_order)`` says the kernel's positional contract holds (the
    scoring forward, serve's prefill and decode over global caches, and
    over rings written in order, before and after the wrap); everything
    else takes the plain paths, which read the masks from
    ``q_pos``/``kv_pos``. ``q_offset`` is the caller's word that the
    contract holds (``flash_route``); ``ring`` says that k and v are a
    sliding-window layer's ring, ``in_order`` that its every write put
    position p at slot p % skv."""
    route = flash_route(q_offset, q.shape[1], k.shape[1], window, ring,
                        in_order)
    if impl == "auto" and q.is_cuda and route is not None \
            and not torch.is_grad_enabled():
        from repro_torch.kernels.flash_attn.ops import flash_attention
        n, causal, win, off = route
        return flash_attention(q, k[:, :n], v[:, :n], causal=causal,
                               window=win, q_offset=off, scale=scale)
    if impl == "naive" or (impl == "auto" and
                           (q.shape[1] <= 16 or
                            q.shape[1] * k.shape[1] <= 256 * 256)):
        return naive_attention(q, k, v, q_pos, kv_pos, window, scale)
    return online_attention(q, k, v, q_pos, kv_pos, window=window,
                            scale=scale)


class GQA(nn.Module):
    """Grouped-query self-attention with RoPE, global (``kind`` "attn") or
    over a sliding window of ``cfg.sliding_window`` positions
    ("attn_local"). Without a cache: causal self-attention over x (train,
    scoring). With one: x is the new token block at ``positions``; its K/V
    go into the cache (a ring for "attn_local") in place and the queries
    attend over the cache (serve prefill and decode)."""

    def __init__(self, cfg, kind, device, gen):
        super().__init__()
        if kind not in (ATTN, ATTN_LOCAL):
            raise NotImplementedError(f"attention kind {kind!r} is not "
                                      f"ported yet")
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.ring = kind == ATTN_LOCAL
        self.window = cfg.sliding_window if self.ring else 0
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
            o = attention_op(q, k, v, positions, positions,
                             window=self.window, impl=impl,
                             q_offset=q_offset)
        else:
            ck, cv, cp = _dus_insert(cache, {"k": k, "v": v}, positions)
            in_order = True
            if self.ring:
                in_order = cache["in_order"] = cache["in_order"] and \
                    ring_write_in_order(q_offset, s, ck.shape[1])
            o = attention_op(q, ck, cv, positions, cp, window=self.window,
                             impl=impl, q_offset=q_offset, ring=self.ring,
                             in_order=in_order)
        return o.reshape(b, s, cfg.n_heads * hd) @ self.wo
