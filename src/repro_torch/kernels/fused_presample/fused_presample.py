"""K2 and K3 on Hopper: the presample pool's row scores, race keys and the
selection they feed, as one hand-written CUDA launch.

Binds ``csrc/pool_select.cu``, which replaces the TPU kernels
``row_score_pallas`` (K2) and ``pool_keys_pallas`` (K3) of
``repro/kernels/fused_presample/fused_presample.py`` and the XLA tail of the
reference's ``_select_pool`` (``repro/kernels/fused_presample/ops.py``): row
scores → Σs → race keys → bottom-(k+1) → Horvitz–Thompson weights. Its hash
is ``topk_keys/csrc/race_hash.cuh``, shared with K6. The library is compiled
by ``repro_torch.kernels.build`` at the first launch and its entry point
resolved and typed once per process. The wrappers check what the kernel
takes, allocate the outputs, launch on PyTorch's current stream and raise if
the launch fails: there is no fallback here (``ops.select_pool`` and
``ops.fused_presample`` take the plain versions, ``pool_select_plain`` and
``pool_select_scores_plain`` below, only for CPU tensors or
``interpret=True``).

``pool_select_launches`` counts the launches; ``chip_smoke.py`` zeroes it
around a main path to show the path went through the kernel.
"""
import ctypes
from pathlib import Path

import torch
from torch import Tensor

from repro_torch.kernels.fused_presample.race import race_uniforms
from repro_torch.kernels.topk_keys.ops import _bottom_k

_CSRC = Path(__file__).with_name("csrc")
LIB = "pool_select"
SOURCES = (_CSRC / "pool_select.cu",
           _CSRC.parents[1] / "topk_keys" / "csrc" / "race_hash.cuh")
SMEM_WINNERS = 1024   # pool_select.cu's kSmemWin: above it, sort in scratch

pool_select_launches = 0
_launch_fn = None
_counters = {}        # (device index, stream) -> the kernel's zeroed counter


def row_score_math(g2, mask):
    """Per-row score from per-token stats: sqrt(max(Σₜ ĝ²·mask, 1e-20)) in
    f32, the reduction ``LM.sample_stats`` applies (K2's plain version)."""
    s = (g2.to(torch.float32) * mask.to(torch.float32)).sum(-1)
    return torch.sqrt(torch.clamp(s, min=1e-20))


def pool_keys_math(scores, ids, ctx, inv_total):
    """The per-row key: u from the (row, ctx) counter hash, g =
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


def pool_select_scores_plain(scores, ctx, k):
    """The kernel's plain version from given (B,) scores (pads as −1):
    Σs → ``pool_keys_plain`` → ``_bottom_k`` → weights. Returns the
    kernel's seven outputs ``(scores, inv_total, keys, idx, probs, w,
    thr)``: inv_total (1,) = 1/max(Σs, 1e-20); keys (B,); the k winners
    (int64, ascending key, ties to the lower row), their s/total and HT
    weights 1/(B·max(π, 1e-30)), π = 1 − exp(−probs·thr); thr (0-d) the
    (k+1)-th key. ``k >= B``: every row, weights 1/B, thr +inf."""
    B = scores.shape[0]
    scores = scores.to(torch.float32)
    dev = scores.device
    total = torch.clamp(scores.sum(), min=1e-20)
    inv_total = (1.0 / total).reshape(1)
    keys = pool_keys_plain(scores, ctx, inv_total)
    if k >= B:
        return (scores, inv_total, keys,
                torch.arange(B, dtype=torch.int64, device=dev),
                scores / total,
                torch.full((B,), 1.0 / max(B, 1), dtype=torch.float32,
                           device=dev),
                torch.tensor(float("inf"), device=dev))
    vals, slots = _bottom_k(keys, k + 1)
    thr = vals[k]
    idx = slots[:k]
    return (scores, inv_total, keys, idx,
            *ht_weights(scores, total, idx, thr), thr)


def ht_weights(scores, total, idx, thr):
    """The winners' g = s/total and Horvitz–Thompson weights 1/(B·max(π,
    1e-30)), π = 1 − exp(−g·thr), B = len(scores): the selection's tail."""
    probs = scores[idx] / total
    pi = -torch.expm1(-probs * thr)
    return probs, 1.0 / (scores.shape[0] * torch.clamp(pi, min=1e-30))


def pool_select_plain(g2, mask, ctx, k):
    """The kernel's plain version from per-token stats: ``row_score_math``
    then ``pool_select_scores_plain`` (same seven outputs)."""
    return pool_select_scores_plain(row_score_math(g2, mask), ctx, k)


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        from repro_torch.kernels import build
        fn = build.load(LIB, SOURCES).pool_select_launch
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, ll, ll, ctypes.c_int, p, ctypes.c_uint, ll,
                       p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes \
            or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         f"{'/'.join(str(d) for d in dtypes)} CUDA tensor, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _counter(device, stream):
    """The kernel's last-block counter for this stream: zeroed once, set
    back to zero by every launch."""
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None:
        c = _counters[key] = torch.zeros((1,), dtype=torch.int32,
                                         device=device)
    return c


def _launch(scores, ctx, k, g2=None, mask=None):
    global pool_select_launches
    B = scores.shape[0]
    k = int(k)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    T = 0 if g2 is None else g2.shape[1]
    if B >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError(f"need B, T < 2**31, got {B}, {T}")
    dev = scores.device
    m = min(k, B)
    f32 = torch.empty((1 + B + 2 * m + 1,), dtype=torch.float32, device=dev)
    inv_total, keys, probs, w, thr = f32.split((1, B, m, m, 1))
    idx = torch.empty((m,), dtype=torch.int64, device=dev)
    scratch = None
    if k < B and k + 1 > SMEM_WINNERS:
        scratch = torch.empty((1 << k.bit_length(),), dtype=torch.int64,
                              device=dev)
    vec = g2 is not None and g2.data_ptr() % 16 == 0 \
        and mask.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            None if g2 is None else g2.data_ptr(),
            None if mask is None else mask.data_ptr(), B, T, int(vec),
            scores.data_ptr(), int(ctx) & 0xFFFFFFFF, k,
            inv_total.data_ptr(), keys.data_ptr(), idx.data_ptr(),
            probs.data_ptr(), w.data_ptr(), thr.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _counter(dev, stream).data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pool_select launch failed: cudaError {err}")
    pool_select_launches += 1
    return scores, inv_total, keys, idx, probs, w, thr.reshape(())


def pool_select_cuda(g2: Tensor, mask: Tensor, ctx: int, k: int):
    """g2 (B, T) contiguous f32 per-token ĝ²; mask (B, T) contiguous bool
    or uint8 (0/1), on one CUDA device; ``ctx`` the plan's uint32 hash
    context; k the rows to select → ``(scores, inv_total, keys, idx, probs,
    w, thr)`` as ``pool_select_plain`` returns them, from one launch."""
    if g2.dim() != 2:
        raise ValueError(f"g2 must be (B, T), got {tuple(g2.shape)}")
    B, T = g2.shape
    _check("g2", g2, (B, T), (torch.float32,))
    _check("mask", mask, (B, T), (torch.bool, torch.uint8))
    if mask.device != g2.device:
        raise ValueError("g2 and mask must share one device")
    scores = torch.empty((B,), dtype=torch.float32, device=g2.device)
    return _launch(scores, ctx, k, g2=g2, mask=mask.view(torch.uint8))


def pool_select_scores_cuda(scores: Tensor, ctx: int, k: int):
    """The same launch from given scores (B,) contiguous f32 on a CUDA
    device (pads as −1): stage 1 is skipped and ``scores`` is returned as
    given. Outputs as ``pool_select_scores_plain``."""
    if scores.dim() != 1:
        raise ValueError(f"scores must be (B,), got {tuple(scores.shape)}")
    _check("scores", scores, scores.shape, (torch.float32,))
    return _launch(scores, ctx, k)
