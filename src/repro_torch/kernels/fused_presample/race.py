"""The race's counter hash on torch tensors.

Each id i of a plan (a pool row, or a store slot's global id) gets a
uniform u ∈ (0,1) from a uint32 hash of (i, ctx) — the composition of
``repro.sampler.selection.hash_uniform`` for ids below 2³², bit for bit.
torch has no full uint32 arithmetic, so the hash runs in int64 with every
product reduced mod 2³² (split into 16-bit halves so no int64 product
overflows).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x · c) mod 2³² for int64 tensors holding uint32 values."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def fmix32(x):
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def race_hash(ids, ctx: int):
    """The uint32 race hashes of uint32 ids (an int64 tensor) under plan
    context ``ctx``, as int64."""
    h = fmix32(_mul32(ids & _M32, 0x9E3779B9) ^ (int(ctx) & _M32))
    return fmix32((h + 0x6A09E667) & _M32)


def race_uniforms(ids, ctx: int):
    """u = (hash >> 8)·2⁻²⁴ + 2⁻²⁵ ∈ (0,1), f32, as the device computes it."""
    return (race_hash(ids, ctx) >> 8).to(torch.float32) * (2.0 ** -24) \
        + 2.0 ** -25


def pool_hash(n: int, ctx: int, device=None):
    """The (n,) uint32 race hashes of pool rows 0..n-1, as int64."""
    return race_hash(torch.arange(n, dtype=torch.int64, device=device), ctx)


def pool_exponentials(n: int, ctx: int, device=None):
    """The race key's numerator, known before scoring: Eᵢ = −log(uᵢ), f32."""
    return -torch.log(race_uniforms(
        torch.arange(n, dtype=torch.int64, device=device), ctx))
