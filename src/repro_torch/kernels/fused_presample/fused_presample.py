"""K2 and K3 on Hopper: the fused presample op's row scores and pool race
keys, hand-written CUDA.

Binds ``csrc/row_score.cu`` (K2, replacing the TPU kernel
``row_score_pallas`` of ``repro/kernels/fused_presample/fused_presample.py``)
and ``csrc/pool_keys.cu`` (K3, replacing ``pool_keys_pallas``; its hash is
``topk_keys/csrc/race_hash.cuh``, shared with K6). The libraries are
compiled by ``repro_torch.kernels.build`` at the first launch. The wrappers
check what the kernels take, allocate the outputs, launch on PyTorch's
current stream and raise if a launch fails: there is no fallback here
(``ops.select_pool`` and ``ops.fused_presample`` pick the plain versions,
``row_score_math`` and ``pool_keys_math`` below, only for CPU tensors or
``interpret=True``).

``row_score_launches`` and ``pool_keys_launches`` count the launches;
``chip_smoke.py`` zeroes them around a main path to show the path went
through the kernels.
"""
import ctypes
from pathlib import Path

import torch
from torch import Tensor

from repro_torch.kernels.fused_presample.race import race_uniforms

_CSRC = Path(__file__).with_name("csrc")
LIB_K2 = "row_score"                    # K2's library
SOURCES_K2 = (_CSRC / "row_score.cu",)
LIB_K3 = "pool_keys"                    # K3's library
SOURCES_K3 = (_CSRC / "pool_keys.cu",
              _CSRC.parents[1] / "topk_keys" / "csrc" / "race_hash.cuh")

row_score_launches = 0
pool_keys_launches = 0


def row_score_math(g2, mask):
    """Per-row score from per-token stats: sqrt(max(Σₜ ĝ²·mask, 1e-20)) in
    f32, the reduction ``LM.sample_stats`` applies (K2's plain version)."""
    s = (g2.to(torch.float32) * mask.to(torch.float32)).sum(-1)
    return torch.sqrt(torch.clamp(s, min=1e-20))


def pool_keys_math(scores, ids, ctx, inv_total):
    """The per-row race key: u from the (row, ctx) counter hash, g =
    s·(1/Σs), key = −log(u)/max(g, 1e-20); f32. ``ids`` are the rows as
    int64 holding uint32 values; ``inv_total`` a (1,) f32 tensor or a
    float32 value."""
    g = scores.to(torch.float32) * inv_total
    return -torch.log(race_uniforms(ids, ctx)) / torch.clamp(g, min=1e-20)


def pool_keys_plain(scores, ctx, inv_total):
    """K3's plain version: ``pool_keys_math`` over rows 0..B−1, +inf where
    the score is < 0 (a padded lane)."""
    ids = torch.arange(scores.shape[0], dtype=torch.int64,
                       device=scores.device)
    keys = pool_keys_math(scores, ids, ctx, inv_total)
    return torch.where(scores < 0, torch.inf, keys)


def _k2_lib():
    from repro_torch.kernels import build
    fn = build.load(LIB_K2, SOURCES_K2).row_score_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    return fn


def _k3_lib():
    from repro_torch.kernels import build
    fn = build.load(LIB_K3, SOURCES_K3).pool_keys_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, ctypes.c_uint, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes \
            or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"{'/'.join(str(d) for d in dtypes)} CUDA tensor, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def row_score_cuda(g2: Tensor, mask: Tensor) -> Tensor:
    """g2 (B, T) contiguous f32 per-token ĝ²; mask (B, T) contiguous bool
    or uint8 (0/1), on the same CUDA device → (B,) f32 row scores."""
    global row_score_launches
    if g2.dim() != 2:
        raise ValueError(f"g2 must be (B, T), got {tuple(g2.shape)}")
    B, T = g2.shape
    _check("g2", g2, (B, T), (torch.float32,))
    _check("mask", mask, (B, T), (torch.bool, torch.uint8))
    if mask.device != g2.device:
        raise ValueError("g2 and mask must share one device")
    if T >= 2 ** 31 or B >= 2 ** 31:
        raise ValueError(f"need B, T < 2**31, got {B}, {T}")
    s = torch.empty((B,), dtype=torch.float32, device=g2.device)
    with torch.cuda.device(g2.device):
        stream = torch.cuda.current_stream(g2.device).cuda_stream
        err = _k2_lib()(g2.data_ptr(), mask.view(torch.uint8).data_ptr(), B,
                        T, s.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row_score launch failed: cudaError {err}")
    row_score_launches += 1
    return s


def pool_keys_cuda(scores: Tensor, ctx: int, inv_total: Tensor) -> Tensor:
    """scores (B,) contiguous f32 (pads as −1); ``ctx`` the plan's uint32
    hash context; inv_total (1,) f32 = 1/Σs, on the scores' CUDA device
    (read there: the launch needs no host value) → race keys (B,) f32,
    +inf on pads."""
    global pool_keys_launches
    if scores.dim() != 1:
        raise ValueError(f"scores must be (B,), got {tuple(scores.shape)}")
    _check("scores", scores, scores.shape, (torch.float32,))
    _check("inv_total", inv_total, (1,), (torch.float32,))
    if inv_total.device != scores.device:
        raise ValueError("scores and inv_total must share one device")
    keys = torch.empty_like(scores)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = _k3_lib()(scores.data_ptr(), scores.shape[0],
                        int(ctx) & 0xFFFFFFFF, inv_total.data_ptr(),
                        keys.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pool_keys launch failed: cudaError {err}")
    pool_keys_launches += 1
    return keys
