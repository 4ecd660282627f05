"""Public wrapper for the flash-attention forward (K5) on the model's
(b, s, heads, hd) GQA interface.

On CUDA tensors ``flash_attention`` launches the hand-written Hopper
kernel (``flash_attn.flash_attention_cuda``), which reads q, k and v in
place through their strides and maps query head h to kv head h // g
itself, and raises if it cannot. The plain torch version runs only for
tensors on the CPU or when the caller asks for it with ``interpret=True``:
the reference wrapper's fold of (b, hkv, g) into the batch, k and v
broadcast over g, and ``ref.flash_attention_ref``. Forward only: neither
has a gradient, as the Pallas kernel has none.
"""
from __future__ import annotations

from repro_torch.kernels import plain_route
from repro_torch.kernels.flash_attn.ref import flash_attention_ref


def _folded_ref(q, k, v, **kw):
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4) \
        .reshape(b * hkv * g, sq, hd)

    def fold_kv(t):
        return t.permute(0, 2, 1, 3)[:, :, None] \
            .expand(b, hkv, g, skv, hd).reshape(b * hkv * g, skv, hd)
    o = flash_attention_ref(qf, fold_kv(k), fold_kv(v), **kw)
    return o.reshape(b, hkv, g, sq, hd).permute(0, 3, 1, 2, 4) \
        .reshape(b, sq, hq, hd)


def flash_attention(q, k, v, causal=True, window=0, q_offset=0, scale=None,
                    block_q=128, block_k=512, interpret=None):
    """q: (b, sq, hq, hd); k, v: (b, skv, hkv, hd) → (b, sq, hq, hd) in
    q's dtype. Query i sits at position ``q_offset + i``, key j at
    position j.

    ``block_q``/``block_k`` are the TPU kernel's tile sizes: they shape its
    grid, not the result; the Hopper kernel picks its own tiles."""
    del block_q, block_k
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if plain_route(q, k, v, interpret=interpret):
        return _folded_ref(q, k, v, **kw)
    from repro_torch.kernels.flash_attn.flash_attn import flash_attention_cuda
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset,
                                scale=scale or q.shape[-1] ** -0.5)
