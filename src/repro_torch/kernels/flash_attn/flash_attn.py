"""K5 on Hopper: the flash-attention forward, hand-written CUDA.

Two kernels replace the TPU kernel ``flash_attention_pallas`` of
``repro/kernels/flash_attn/flash_attn.py`` (and the fold of its wrapper),
registered together as ``torch.ops.repro_torch.flash_attention``:

* ``wgmma`` (``csrc/flash_attn_fwd_wgmma.cu``, library ``LIB_WGMMA``):
  prefill and scoring, a warp-specialised forward on ``wgmma`` and TMA
  with a persistent grid, for bf16 with hd = 128, at least
  ``WGMMA_MIN_ROWS`` query rows and TMA-aligned q, k and v;
* ``mma`` (``csrc/flash_attn_fwd.cu``, library ``LIB``): everything else
  the port calls, decode (one query row, the kv range split over blocks),
  f32 and the other bf16 head dims, on ``mma.sync``.

``kernel_for`` is the dispatch rule, a pure function of dtype, shape and
alignment; ``plan`` checks a call and names its kernel. Each library is
compiled by ``repro_torch.kernels.build`` on its first launch. The wrapper
allocates the output and the kv-split scratch, launches on PyTorch's
current stream and raises if the launch fails: there is no fallback from
one kernel to the other, nor to the plain version (``ops.flash_attention``
picks that only for CPU tensors or ``interpret=True``).

``launches`` counts the wrapper's launches and ``launches_by_kernel`` each
kernel's; ``chip_smoke.py`` zeroes them around a main path to show which
kernel the path went through.
"""
import ctypes
import functools
from pathlib import Path

import torch
from torch import Tensor

LIB = "flash_attn_fwd"                  # the mma.sync kernel's library
SOURCES = (Path(__file__).with_name("csrc") / "flash_attn_fwd.cu",)
LIB_WGMMA = "flash_attn_fwd_wgmma"      # the wgmma kernel's library
SOURCES_WGMMA = (Path(__file__).with_name("csrc") / "flash_attn_fwd_wgmma.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_HD = (16, 32, 64, 128)
_ROWS = 64                              # packed query rows per block
_TILE = {torch.bfloat16: 64, torch.float32: 32}   # keys per kv tile
_MAX_SPLIT = 32
WGMMA_MIN_ROWS = 64                     # query rows: half a work tile

launches = 0
launches_by_kernel = {"wgmma": 0, "mma": 0}


def _lib():
    from repro_torch.kernels import build
    fn = build.load(LIB, SOURCES).flash_attn_fwd_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, *[ll] * 12, i, i, i,
                   ctypes.c_float, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _lib_wgmma():
    from repro_torch.kernels import build
    fn = build.load(LIB_WGMMA, SOURCES_WGMMA).flash_fwd_wgmma_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_ulonglong), i, i, i,
                   i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def tma_geometry(t: Tensor) -> tuple:
    """The 4-D tensor map of a (b, s, heads, hd) bf16 tensor as the wgmma
    kernel's TMA reads or writes it: dims (hd, s, heads, b), then the byte
    strides of s, heads and b. s is the tensor's own length, so a prefix
    view of a KV cache maps its prefix and not the cache's capacity (TMA
    zero-fills past it). A dim of size 1 is never stepped over; its stride
    is given as if the tensor were contiguous there, a multiple of 16
    bytes whatever the view says."""
    b, s, h, hd = t.shape
    es = t.element_size()
    st_s = t.stride(1) * es if s > 1 else hd * es
    st_h = t.stride(2) * es if h > 1 else st_s * s
    st_b = t.stride(0) * es if b > 1 else st_h * h
    return (hd, s, h, b, st_s, st_h, st_b)


def _tma_ok(t: Tensor) -> bool:
    """16-byte aligned base and strides (TMA's rule), unit stride on hd."""
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(st % 16 == 0 and st < 2 ** 40
                    for st in tma_geometry(t)[4:]))


def kernel_for(dtype, hd: int, sq: int, aligned: bool,
               scale: float = 1.0) -> str:
    """The dispatch rule: ``"wgmma"`` for bf16 with hd = 128, at least
    ``WGMMA_MIN_ROWS`` query rows (prefill and scoring; below that the
    rows of one head fill less than half a 128-row work tile), TMA-aligned
    q, k and v (``aligned``) and a positive softmax scale (the kernel takes
    its row max on the unscaled scores); else ``"mma"`` (decode, f32,
    other head dims, any other scale)."""
    if (dtype == torch.bfloat16 and hd == 128 and sq >= WGMMA_MIN_ROWS
            and aligned and scale > 0):
        return "wgmma"
    return "mma"


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


def plan(q: Tensor, k: Tensor, v: Tensor, scale: float = 1.0) -> str:
    """Check that one of the two kernels takes q, k and v, and name it
    for this softmax scale (``kernel_for``); raise ``ValueError`` for a
    call neither takes."""
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
    return kernel_for(q.dtype, hd, sq, all(_tma_ok(t) for t in (q, k, v)),
                      scale)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                         window: int, q_offset: int, scale: float) -> Tensor:
    """q (b, sq, hq, hd), k and v (b, skv, hkv, hd), one dtype (bf16 or
    f32), each with a unit stride on hd (the other strides are free: a
    view of a KV cache is read in place) → o (b, sq, hq, hd) contiguous.
    Query i sits at position ``q_offset + i``, key j at position j."""
    global launches
    kernel = plan(q, k, v, scale)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    o = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=dev)
    if b == 0 or sq == 0:
        return o
    if skv == 0:
        raise ValueError("no keys to attend to (skv = 0)")
    _check_rows_have_keys(sq, skv, causal, window, q_offset)
    if kernel == "wgmma":
        geo = (ctypes.c_ulonglong * 28)(
            *(x for t in (q, k, v, o) for x in tma_geometry(t)))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib_wgmma()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), geo, b, sq, skv, hq, hkv,
                               int(causal), int(window), int(q_offset),
                               float(scale), stream)
        if err != 0:
            raise RuntimeError(f"flash_attention (wgmma) launch failed: "
                               f"error {err}")
        launches += 1
        launches_by_kernel["wgmma"] += 1
        return o
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
        raise RuntimeError(f"flash_attention (mma) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_by_kernel["mma"] += 1
    return o
