"""K5 on Hopper: the flash-attention forward, hand-written CUDA.

Four kernels replace the TPU kernel ``flash_attention_pallas`` of
``repro/kernels/flash_attn/flash_attn.py`` (and the fold of its wrapper),
registered together as ``torch.ops.repro_torch.flash_attention``; five
routes lead to them:

* ``wgmma`` (library ``LIB_WGMMA``): prefill and scoring, a
  warp-specialised forward on ``wgmma`` and TMA with a persistent grid,
  for bf16 with hd = 128 (``csrc/flash_attn_fwd_wgmma.cu``) or hd = 256
  (gemma3; ``csrc/flash_attn_fwd_wgmma256.cu``, 64-key tiles, Q in a ring
  of 64-row halves), at least ``WGMMA_MIN_ROWS`` query rows and
  TMA-aligned q, k and v;
* ``decode`` (``csrc/flash_attn_decode.cu``, library ``LIB_DECODE``):
  bf16 at hd 256 with one query row (gemma3's decode over its rings and
  global caches), f32 FMA on CUDA cores, whole key rows streamed by
  cp.async, the key range split by ``decode_split`` and a pair's splits
  merged in the same launch through a thread block cluster;
* ``f32`` (``csrc/flash_attn_fwd_f32.cu``, library ``LIB_F32``): f32
  prefill and scoring (lm-100m's pool, lm-tiny, the reduced configs) at
  hd in ``F32_HD`` with at least ``F32_MIN_ROWS`` query rows and 16-byte
  aligned q, k and v: an SGEMM-style register-tiled flash forward on f32
  FMA, K and V through a cp.async ring, row blocks heaviest first
  (``f32_walk`` transcribes its walk);
* ``mma`` (``csrc/flash_attn_fwd.cu``, library ``LIB``): everything else
  the port calls, the hd-128 decode and the f32 decode (one query row, the
  kv range split over blocks), the other bf16 head dims (16, 32, 64), the
  hd-256 prefills the wgmma kernel refuses and the f32 calls the f32
  kernel refuses, on ``mma.sync`` (bf16) and plain FMA (f32).

``kernel_for`` is the dispatch rule, a pure function of dtype, shape and
alignment; ``plan`` checks a call and names its kernel. Each library is
compiled by ``repro_torch.kernels.build`` on its first launch. The wrapper
allocates the output and the kv-split scratch, launches on PyTorch's
current stream and raises if the launch fails: there is no fallback from
one kernel to another, nor to the plain version (``ops.flash_attention``
picks that only for CPU tensors or ``interpret=True``).

``launches`` counts the wrapper's launches and ``launches_by_kernel`` each
kernel's where it launches: ``"wgmma"`` (hd 128), ``"wgmma256"`` (hd 256),
``"decode256"``, ``"f32"`` and ``"mma"``; ``chip_smoke.py`` zeroes them
around a main path to show which kernel the path went through.
"""
import ctypes
import functools
from pathlib import Path

import torch
from torch import Tensor

LIB = "flash_attn_fwd"                  # the mma.sync kernel's library
SOURCES = (Path(__file__).with_name("csrc") / "flash_attn_fwd.cu",)
LIB_WGMMA = "flash_attn_fwd_wgmma"      # the wgmma kernels' library
SOURCES_WGMMA = tuple(Path(__file__).with_name("csrc") / f for f in (
    "flash_attn_fwd_wgmma.cu", "flash_attn_fwd_wgmma256.cu",
    "flash_attn_wgmma.cuh"))
LIB_DECODE = "flash_attn_decode"        # the hd-256 decode kernel's library
SOURCES_DECODE = (Path(__file__).with_name("csrc") / "flash_attn_decode.cu",)
LIB_F32 = "flash_attn_fwd_f32"          # the f32 prefill kernel's library
SOURCES_F32 = (Path(__file__).with_name("csrc") / "flash_attn_fwd_f32.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_HD = (16, 32, 64, 128, 256)
_ROWS = 64                              # packed query rows per block
_MAX_SPLIT = 32
WGMMA_MIN_ROWS = 64                     # query rows: half a work tile
WGMMA_HD = (128, 256)                   # head dims of the wgmma kernels
# the decode kernel (flash_attn_decode.cu: kTile, kMinBlocks, kMaxG,
# kMaxSplit)
DECODE_HD = 256
DECODE_TILE = 32                        # keys a block step: 8 warps x 4
DECODE_BLOCKS_PER_SM = 2                # resident blocks an SM
DECODE_MAX_G = 4                        # query heads a block
DECODE_MAX_SPLIT = 8                    # blocks a cluster (portable)
# the f32 kernel (flash_attn_fwd_f32.cu: kBM, kBN)
F32_HD = (16, 32, 64, 128)
F32_ROWS = 64                           # packed query rows a block
F32_TILE = 32                           # keys a kv tile
# Query rows the f32 kernel asks for. It has no kv split: a call of a few
# query rows over a long cache (a decode, a short chunk) would run one
# block per (batch, kv head) through every key, and its rows would be
# mostly padding of a 64-row block. The mma kernel splits such calls over
# the kv range. From 16 rows on (a block's 64 packed rows hold 16 positions
# of 4 heads, 32 of 2) the calls are prefills and scoring forwards: lm-tiny
# and the reduced configs serve prompts of 24-128, lm-100m scores 1024.
F32_MIN_ROWS = 16

launches = 0
launches_by_kernel = {"wgmma": 0, "wgmma256": 0, "decode256": 0, "f32": 0,
                      "mma": 0}


@functools.cache
def _lib():
    from repro_torch.kernels import build
    fn = build.load(LIB, SOURCES).flash_attn_fwd_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, *[ll] * 12, i, i, i,
                   ctypes.c_float, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_wgmma(hd: int):
    """The wgmma kernel's launch entry for head dim ``hd`` (128 or 256)."""
    from repro_torch.kernels import build
    lib = build.load(LIB_WGMMA, SOURCES_WGMMA)
    fn = lib.flash_fwd_wgmma_launch if hd == 128 \
        else lib.flash_fwd_wgmma256_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_ulonglong), i, i, i,
                   i, i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_decode():
    """The decode kernel's launch entry and its occupancy query."""
    from repro_torch.kernels import build
    lib = build.load(LIB_DECODE, SOURCES_DECODE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.flash_decode_launch
    fn.argtypes = [p, p, p, p, i, i, i, i, *[ll] * 10, i, i, i,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    occ = lib.flash_decode_occupancy
    occ.argtypes = [i, i, ctypes.POINTER(i)]
    occ.restype = i
    return fn, occ


@functools.cache
def _lib_f32():
    """The f32 prefill kernel's launch entry."""
    from repro_torch.kernels import build
    fn = build.load(LIB_F32, SOURCES_F32).flash_fwd_f32_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, *[ll] * 12, i, i, i,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def decode_occupancy(g_block: int, nsplit: int):
    """The decode kernel's resident blocks an SM for ``g_block`` query
    heads a block, and the clusters of ``nsplit`` such blocks the card
    holds at once, by the CUDA occupancy calculator on the current device
    (``decode_split`` counts ``DECODE_BLOCKS_PER_SM``)."""
    clusters = ctypes.c_int(0)
    n = _lib_decode()[1](g_block, nsplit, ctypes.byref(clusters))
    if n < 0:
        raise RuntimeError(f"flash_decode_occupancy failed: cudaError {-n}")
    return n, clusters.value


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


def _f32_ok(t: Tensor) -> bool:
    """16-byte aligned base and strides (the f32 kernel's float4 and
    cp.async rule); a size-1 dim's stride is never stepped over."""
    return t.data_ptr() % 16 == 0 and all(
        st % 4 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _strides(t: Tensor) -> tuple:
    """t's strides of (b, s, heads), 0 for a size-1 dim (never stepped
    over; the f32 kernel checks the others' alignment)."""
    return tuple(st if n > 1 else 0 for st, n in zip(t.stride()[:3],
                                                       t.shape[:3]))


def kernel_for(dtype, hd: int, sq: int, aligned: bool,
               scale: float = 1.0) -> str:
    """The dispatch rule: ``"decode"`` for bf16 at hd ``DECODE_HD`` (256)
    with one query row (any alignment the checks allow, any scale);
    ``"wgmma"`` for bf16 with hd in ``WGMMA_HD`` (128, and 256 for gemma3),
    at least ``WGMMA_MIN_ROWS`` query rows (prefill and scoring; below that
    the rows of one head fill less than half a 128-row work tile),
    TMA-aligned q, k and v (``aligned``) and a positive softmax scale (the
    kernel takes its row max on the unscaled scores); ``"f32"`` for f32
    with hd in ``F32_HD``, at least ``F32_MIN_ROWS`` query rows and 16-byte
    aligned q, k and v (``aligned``; any scale: its max is on the scaled
    scores); else ``"mma"`` (the hd-128 and f32 decodes, other head dims,
    short or unaligned prefills, a bf16 scale <= 0). ``aligned`` is the
    alignment the dtype's fast kernel asks for."""
    if dtype == torch.bfloat16 and hd == DECODE_HD and sq == 1:
        return "decode"
    if (dtype == torch.bfloat16 and hd in WGMMA_HD and sq >= WGMMA_MIN_ROWS
            and aligned and scale > 0):
        return "wgmma"
    if dtype == torch.float32 and hd in F32_HD and sq >= F32_MIN_ROWS \
            and aligned:
        return "f32"
    return "mma"


def f32_walk(b: int, hkv: int, sq: int, g: int, skv: int, causal: bool,
             window: int, q_offset: int):
    """The f32 kernel's walk, transcribed from ``flash_attn_fwd_f32.cu``
    for the CPU tests: its blocks in launch order, each as (batch, kv head,
    first packed row, the kv tiles it visits, the tiles among them it
    masks). Block L takes row block nrb - 1 - L // (b·hkv) (heaviest first
    under the causal edge) of pair L % (b·hkv). A block visits the
    ``F32_TILE``-key tiles that hold its rows' unmasked keys, and masks a
    tile unless every key in it is unmasked for every row of the block."""
    nrows = sq * g
    nrb = -(-nrows // F32_ROWS)
    walk = []
    for blk in range(nrb * b * hkv):
        row0 = (nrb - 1 - blk // (b * hkv)) * F32_ROWS
        q_lo = q_offset + row0 // g
        q_hi = q_offset + (min(row0 + F32_ROWS, nrows) - 1) // g
        kv_end = min(skv, q_hi + 1) if causal else skv
        kv_begin = max(0, q_lo - window + 1) if window > 0 else 0
        t_begin = kv_begin // F32_TILE
        t_end = -(-kv_end // F32_TILE) if kv_end > kv_begin else t_begin
        masked = [t for t in range(t_begin, t_end)
                  if not ((t + 1) * F32_TILE <= skv
                          and (not causal or (t + 1) * F32_TILE - 1 <= q_lo)
                          and (window <= 0
                               or t * F32_TILE > q_hi - window))]
        pair = blk % (b * hkv)
        walk.append((pair // hkv, pair % hkv, row0, range(t_begin, t_end),
                     masked))
    return walk


def decode_keys(skv: int, causal: bool, window: int, q_offset: int):
    """The keys [lo, hi) one query row at ``q_offset`` attends to: what the
    causal edge and the window leave of [0, skv)."""
    hi = min(skv, q_offset + 1) if causal else skv
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    return lo, hi


def decode_heads(g: int) -> int:
    """Query heads a decode block takes: the largest divisor of the group
    size g up to ``DECODE_MAX_G`` (a block keeps each head's q and output
    in registers); the g heads of a kv head are g / that blocks."""
    return max(d for d in range(1, min(g, DECODE_MAX_G) + 1) if g % d == 0)


def decode_split(pairs: int, n_keys: int, sms: int) -> int:
    """The decode kernel's number of splits of ``n_keys`` keys for
    ``pairs`` (batch, kv head, head chunk) pairs on ``sms`` SMs: at most
    one block an SM (pairs × nsplit ≤ sms; more pairs than SMs take one
    split and ⌈pairs / (``DECODE_BLOCKS_PER_SM`` · sms)⌉ waves), at most
    one split a ``DECODE_TILE``-key tile and ``DECODE_MAX_SPLIT`` (a pair's
    splits are one cluster). One block an SM was the fastest shape
    ``decode_probe`` found at gemma3's decode on an H100 (0.0298 ms at 2
    splits, 0.0329 at 4). Split s of n takes the tiles
    [s·tiles // n, (s + 1)·tiles // n)."""
    tiles = -(-n_keys // DECODE_TILE)
    return max(1, min(sms // pairs, tiles, DECODE_MAX_SPLIT))


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


def _tile(dtype, hd: int) -> int:
    """Keys per kv tile of the mma kernel (``Bf16Tiles`` in its source)."""
    if dtype == torch.float32:
        return 32
    return 32 if hd > 128 else 64


def _split(rows: int, bhkv: int, skv: int, tile: int, sms: int) -> int:
    """Split the kv range over blocks when the grid alone would not fill
    the card (decode): about two blocks per SM, at least a tile each."""
    blocks = -(-rows // _ROWS) * bhkv
    if blocks >= sms:
        return 1
    return max(1, min(-(-2 * sms // blocks), -(-skv // tile), _MAX_SPLIT))


def plan(q: Tensor, k: Tensor, v: Tensor, scale: float = 1.0) -> str:
    """Check that one of the kernels takes q, k and v, and name it for
    this softmax scale (``kernel_for``); raise ``ValueError`` for a call
    none takes."""
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
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if (qs[3] != 1 or ks[3] != 1 or vs[3] != 1) and hd > 1:
        raise ValueError("q, k and v need a unit stride on the head dim")
    if q.dtype == torch.bfloat16:
        if hd not in _BF16_HD:
            raise ValueError(f"the bf16 kernel takes head dims {_BF16_HD}, "
                             f"got {hd}")
        # 16-byte rows of k and v (cp.async), 4-byte pairs of q
        if k.data_ptr() % 16 or v.data_ptr() % 16 \
                or any(st % 8 for st in ks[:3] + vs[:3]) \
                or q.data_ptr() % 4 or any(st % 2 for st in qs[:3]):
            raise ValueError("bf16 k and v need 16-byte aligned rows, q "
                             "4-byte aligned pairs")
    elif hd > 128:
        raise ValueError(f"f32 calls take head dims up to 128, got {hd}")
    if b * hkv > 65535 or b * sq * hq >= 2 ** 31 or skv >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel's grid: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    # the alignment the dtype's fast kernel asks for: TMA's (wgmma), 16
    # bytes (f32)
    if q.dtype == torch.bfloat16:
        aligned = (hd in WGMMA_HD and sq >= WGMMA_MIN_ROWS
                   and all(_tma_ok(t) for t in (q, k, v)))
    else:
        aligned = (hd in F32_HD and sq >= F32_MIN_ROWS
                   and all(_f32_ok(t) for t in (q, k, v)))
    return kernel_for(q.dtype, hd, sq, aligned, scale)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                         window: int, q_offset: int, scale: float) -> Tensor:
    """q (b, sq, hq, hd), k and v (b, skv, hkv, hd), one dtype (bf16 or
    f32), each with a unit stride on hd (the other strides are free: a
    view of a KV cache is read in place) → o (b, sq, hq, hd) contiguous.
    Query i sits at position ``q_offset + i``, key j at position j."""
    kernel = plan(q, k, v, scale)
    b, sq, hq, hd = q.shape
    skv = k.shape[1]
    o = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return o
    if skv == 0:
        raise ValueError("no keys to attend to (skv = 0)")
    _check_rows_have_keys(sq, skv, causal, window, q_offset)
    if kernel == "wgmma":
        _launch_wgmma(q, k, v, o, causal, window, q_offset, scale)
    elif kernel == "decode":
        _launch_decode(q, k, v, o, causal, window, q_offset, scale)
    elif kernel == "f32":
        _launch_f32(q, k, v, o, causal, window, q_offset, scale)
    else:
        _launch_mma(q, k, v, o, causal, window, q_offset, scale)
    return o


def _launch_wgmma(q, k, v, o, causal, window, q_offset, scale):
    global launches
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    geo = (ctypes.c_ulonglong * 28)(
        *(x for t in (q, k, v, o) for x in tma_geometry(t)))
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib_wgmma(hd)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), geo, b, sq, skv, hq, hkv,
                             int(causal), int(window), int(q_offset),
                             float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention (wgmma) launch failed: "
                           f"error {err}")
    launches += 1
    launches_by_kernel["wgmma" if hd == 128 else "wgmma256"] += 1


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch_decode(q, k, v, o, causal, window, q_offset, scale):
    """The decode kernel (bf16, hd 256, one query row): one launch, the
    splits merged inside it (no scratch)."""
    global launches
    b, _, hq, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    g_block = decode_heads(g)
    pairs = b * hkv * (g // g_block)
    lo, hi = decode_keys(skv, causal, window, q_offset)
    dev = q.device
    nsplit = decode_split(pairs, hi - lo, _sm_count(_device_index(dev)))
    with torch.cuda.device(dev):
        err = _lib_decode()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hkv,
            g, g_block, q.stride(0), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2), o.stride(0),
            o.stride(2), lo, hi, nsplit, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention (decode) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_by_kernel["decode256"] += 1


def _launch_f32(q, k, v, o, causal, window, q_offset, scale):
    """The f32 prefill kernel: one launch, no scratch."""
    global launches
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    with torch.cuda.device(dev):
        err = _lib_f32()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), b, sq, skv, hq, hkv, hd,
                         *_strides(q), *_strides(k), *_strides(v),
                         *_strides(o), int(causal), int(window),
                         int(q_offset), float(scale),
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention (f32) launch failed: "
                           f"cudaError {err}")
    launches += 1
    launches_by_kernel["f32"] += 1


def _launch_mma(q, k, v, o, causal, window, q_offset, scale):
    """The mma.sync kernel on any call ``plan`` accepts (the dispatch rule
    sends it what the other kernels do not take)."""
    global launches
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    rows = sq * (hq // hkv)
    nsplit = _split(rows, b * hkv, skv, _tile(q.dtype, hd),
                    _sm_count(_device_index(dev)))
    if nsplit > 1:
        part = torch.empty((nsplit * b * hkv * rows * (hd + 2),),
                           dtype=torch.float32, device=dev)
        part_o, part_m, part_l = part.split(
            (nsplit * b * hkv * rows * hd, nsplit * b * hkv * rows,
             nsplit * b * hkv * rows))
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
