"""K5 on Hopper: the flash-attention forward, hand-written CUDA.

Binds ``csrc/flash_attn_fwd.cu`` (replacing the TPU kernel
``flash_attention_pallas`` of ``repro/kernels/flash_attn/flash_attn.py``
and the fold of its wrapper) and registers it as
``torch.ops.repro_torch.flash_attention``. The library is compiled by
``repro_torch.kernels.build`` on the first launch. The wrapper checks what
the kernel takes, allocates the output and the kv-split scratch, launches
on PyTorch's current stream and raises if the launch fails: there is no
fallback here (``ops.flash_attention`` picks the plain version only for
CPU tensors or ``interpret=True``).

``launches`` counts the wrapper's launches; ``chip_smoke.py`` zeroes it
around a main path to show the path went through the kernel.
"""
import ctypes
import functools
from pathlib import Path

import torch
from torch import Tensor

SOURCES = (Path(__file__).with_name("csrc") / "flash_attn_fwd.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_HD = (16, 32, 64, 128)
_ROWS = 64                              # packed query rows per block
_TILE = {torch.bfloat16: 64, torch.float32: 32}   # keys per kv tile
_MAX_SPLIT = 32

launches = 0


def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attn_fwd", SOURCES).flash_attn_fwd_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, *[ll] * 12, i, i, i,
                   ctypes.c_float, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_rows_have_keys(sq, skv, causal, window, q_offset):
    """Every query row must see at least one key: the kernel skips wholly
    masked tiles, which is exact only then (a row with no key at all, which
    the reference averages over v, arises only with a window and queries
    past the keys)."""
    first, last = q_offset, q_offset + sq - 1
    hi_first = min(first, skv - 1) if causal else skv - 1
    hi_last = min(last, skv - 1) if causal else skv - 1
    lo_last = max(0, last - window + 1) if window > 0 else 0
    if hi_first < 0 or lo_last > hi_last:
        raise ValueError(
            f"query rows without a valid key (sq={sq}, skv={skv}, "
            f"causal={causal}, window={window}, q_offset={q_offset})")


def _split(rows: int, bhkv: int, skv: int, tile: int, sms: int) -> int:
    """Split the kv range over blocks when the grid alone would not fill
    the card (decode): about two blocks per SM, at least a tile each."""
    blocks = -(-rows // _ROWS) * bhkv
    if blocks >= sms:
        return 1
    return max(1, min(-(-2 * sms // blocks), -(-skv // tile), _MAX_SPLIT))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                         window: int, q_offset: int, scale: float) -> Tensor:
    """q (b, sq, hq, hd), k and v (b, skv, hkv, hd), one dtype (bf16 or
    f32), each with a unit stride on hd (the other strides are free: a
    view of a KV cache is read in place) → o (b, sq, hq, hd) contiguous.
    Query i sits at position ``q_offset + i``, key j at position j."""
    global launches
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (b, sq, hq, hd) and k, v (b, skv, hkv, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"form grouped-query attention")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must share one device")
    if any(t.stride(3) != 1 for t in (q, k, v)) and hd > 1:
        raise ValueError("q, k and v need a unit stride on the head dim")
    if q.dtype == torch.bfloat16:
        if hd not in _BF16_HD:
            raise ValueError(f"the bf16 kernel takes head dims {_BF16_HD}, "
                             f"got {hd}")
        # 16-byte rows of k and v (cp.async), 4-byte pairs of q
        if any(t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))
               for t in (k, v)) or q.data_ptr() % 4 \
                or any(q.stride(i) % 2 for i in range(3)):
            raise ValueError("bf16 k and v need 16-byte aligned rows, q "
                             "4-byte aligned pairs")
    elif hd > 128:
        raise ValueError(f"the f32 kernel takes head dims up to 128, got {hd}")
    if b * hkv > 65535 or b * sq * hq >= 2 ** 31 or skv >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel's grid: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    o = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=dev)
    if b == 0 or sq == 0:
        return o
    if skv == 0:
        raise ValueError("no keys to attend to (skv = 0)")
    _check_rows_have_keys(sq, skv, causal, window, q_offset)
    rows = sq * (hq // hkv)
    nsplit = _split(rows, b * hkv, skv, _TILE[q.dtype],
                    _sm_count(dev.index if dev.index is not None
                              else torch.cuda.current_device()))
    if nsplit > 1:
        part_o = torch.empty((nsplit, b * hkv, rows, hd), dtype=torch.float32,
                             device=dev)
        part_m = torch.empty((nsplit, b * hkv, rows), dtype=torch.float32,
                             device=dev)
        part_l = torch.empty_like(part_m)
        parts = (part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr())
    else:
        parts = (None, None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     _DTYPES[q.dtype], b, sq, skv, hq, hkv, hd,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3], int(causal), int(window), int(q_offset),
                     float(scale), nsplit, *parts, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return o
