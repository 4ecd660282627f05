"""Public wrapper for the sharded selection's race keys + bottom-k (K6).

On CUDA tensors ``race_keys`` (and ``topk_race_keys`` through it)
launches the hand-written Hopper kernel (``topk_keys.race_keys_cuda``)
and raises if it cannot; the plain torch version (``ref.race_keys_ref``)
runs only for tensors on the CPU or when the caller asks for it with
``interpret=True``. The bottom-k over
the keys is a library selection either way, as the reference leaves it
to ``lax.top_k``.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import plain_route
from repro_torch.kernels.topk_keys.ref import race_keys_ref, race_params


def _bottom_k(keys, k: int):
    """The k smallest keys, ascending, ties to the lower slot (the order
    of ``lax.top_k`` over the negated keys): one int64 top-k over
    (float bits << 32 | slot). Keys are ≥ 0 or +inf, so their bits order
    like the floats; −0.0 (u rounded to 1) maps to +0.0's bits."""
    n = keys.shape[0]
    bits = keys.view(torch.int32).to(torch.int64).clamp_(min=0)
    comp = (bits << 32) | torch.arange(n, dtype=torch.int64,
                                       device=keys.device)
    slots = torch.topk(comp, k, largest=False, sorted=True).values \
        & 0xFFFFFFFF
    return keys[slots], slots


def race_keys(scores, seen, ctx, fill_pow, total, *, host_id=0, n_hosts=1,
              n_global=None, smoothing=0.1, inv_temp=1.0, interpret=None):
    """The race key of every slot of a shard: K6 on CUDA tensors, the
    plain version (``ref.race_keys_ref``) on CPU tensors or when asked.

    scores/seen: (n_local,) shard tensors (seen: 1 seen, 0 unseen, −1
    padded lane); ctx: the plan's ``selection.hash_context``;
    fill_pow/total: the reduced sufficient-stat scalars. Returns (n_local,)
    f32 keys, +inf on padded lanes; slot i's global id is i·H + host_id."""
    if plain_route(scores, seen, interpret=interpret):
        return race_keys_ref(scores, seen, ctx, fill_pow, total,
                             host_id=host_id, n_hosts=n_hosts,
                             n_global=n_global, smoothing=smoothing,
                             inv_temp=inv_temp)
    from repro_torch.kernels.topk_keys.topk_keys import race_keys_cuda
    n = scores.shape[0]
    return race_keys_cuda(
        scores.to(torch.float32).contiguous(),
        seen.to(torch.float32).contiguous(), ctx,
        race_params(fill_pow, total, n if n_global is None else n_global,
                    smoothing, inv_temp),
        host_id=int(host_id), n_hosts=int(n_hosts))


def topk_race_keys(scores, seen, ctx, fill_pow, total, *, k, host_id=0,
                   n_hosts=1, n_global=None, smoothing=0.1, inv_temp=1.0,
                   block_t=1024, interpret=None, marks=None):
    """This shard's k winning candidates of one proportional draw: the
    race keys (``race_keys``) and their bottom-k. Returns (keys, slots):
    the k smallest keys ascending (f32) and their local slots (int64;
    global id = slot·H + host_id). ``block_t`` is the TPU kernel's tile
    and shapes nothing here. ``marks`` (a list, CUDA only) receives an
    event after the keys and one after the bottom-k
    (``obs.device_mark``)."""
    del block_t
    keys = race_keys(scores, seen, ctx, fill_pow, total, host_id=host_id,
                     n_hosts=n_hosts, n_global=n_global, smoothing=smoothing,
                     inv_temp=inv_temp, interpret=interpret)
    obs.device_mark(marks)
    out = _bottom_k(keys, int(k))
    obs.device_mark(marks)
    return out
