"""K1 and K4 on Hopper: the CE + score kernels, hand-written CUDA.

Binds ``csrc/ce_score.cu`` (K1, replacing the TPU kernel
``ce_score_pallas`` of ``repro/kernels/ce_score/ce_score.py``) and
``csrc/ce_score_block.cu`` (K4, replacing ``ce_score_block_pallas``), which
share the per-token stream of ``csrc/ce_stream.cuh``, and registers them as
``torch.ops.repro_torch.ce_score`` and ``torch.ops.repro_torch.
ce_score_block``. The libraries are compiled by
``repro_torch.kernels.build`` on the first launch. The wrappers check what
the kernels take, allocate the outputs and scratch, launch on PyTorch's
current stream and raise if a launch fails: there is no fallback here
(``ops`` picks the plain versions only for CPU tensors or
``interpret=True``).

``launches`` counts K4's launches and ``ce_score_launches`` K1's;
``chip_smoke.py`` zeroes them around a main path to show the path went
through the kernels.
"""

import ctypes
from pathlib import Path

import torch
from torch import Tensor

_CSRC = Path(__file__).with_name("csrc")
LIB = "ce_score_block"                  # K4's library
SOURCES = (_CSRC / "ce_score_block.cu", _CSRC / "ce_stream.cuh")
LIB_K1 = "ce_score"                     # K1's library
SOURCES_K1 = (_CSRC / "ce_score.cu", _CSRC / "ce_stream.cuh")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
ce_score_launches = 0


def _k1_lib():
    from repro_torch.kernels import build
    fn = build.load(LIB_K1, SOURCES_K1).ce_score_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, ll, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::ce_score", mutates_args=(),
                         device_types="cuda")
def ce_score_cuda(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """logits (T, V) bf16/f32 with unit vocab stride (the row stride is
    free), labels (T,) int32 → per-token (ce, g2), f32 (T,). A label
    outside [0, V) gathers z_y = 0, as the TPU kernel's does."""
    global ce_score_launches
    if logits.dim() != 2 or logits.dtype not in _DTYPES:
        raise ValueError(f"logits must be (T, V) float32/bfloat16, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    T, V = logits.shape
    if logits.stride(1) != 1 and V > 1:
        raise ValueError("logits need a unit stride on the vocab axis")
    if labels.shape != (T,) or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise ValueError(f"labels must be a contiguous ({T},) int32 tensor, "
                         f"got {tuple(labels.shape)} {labels.dtype}")
    dev = logits.device
    if labels.device != dev:
        raise ValueError("logits and labels must share one device")
    if T >= 2 ** 31 or V < 1:
        raise ValueError(f"need 1 <= V and T < 2**31, got T={T}, V={V}")
    ce = torch.empty((T,), dtype=torch.float32, device=dev)
    g2 = torch.empty_like(ce)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _k1_lib()(logits.data_ptr(), _DTYPES[logits.dtype],
                        logits.stride(0), T, V, labels.data_ptr(),
                        ce.data_ptr(), g2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ce_score launch failed: cudaError {err}")
    ce_score_launches += 1
    return ce, g2


def _lib():
    from repro_torch.kernels import build
    lib = build.load(LIB, SOURCES)
    fn = lib.ce_score_block_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, ll, ll, i, i, i, p, ll, ll, p, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::ce_score_block", mutates_args=(),
                         device_types="cuda")
def ce_score_block_cuda(logits: Tensor, labels: Tensor, alive: Tensor,
                        block_b: int) -> tuple[Tensor, Tensor]:
    """logits (B, Tc, V) bf16/f32 with unit vocab stride (batch and time
    strides free: a time-chunk slice of the pool's logits is launched
    as-is), labels (B, Tc) int32 (< 0 = unsupervised), alive (B,) f32 →
    masked per-row (ce_sum, g2_sum), f32 (B,)."""
    global launches
    if logits.dim() != 3 or logits.dtype not in _DTYPES:
        raise ValueError(f"logits must be (B, Tc, V) float32/bfloat16, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    B, Tc, V = logits.shape
    if logits.stride(2) != 1:
        raise ValueError("logits need a unit stride on the vocab axis")
    if labels.shape != (B, Tc) or labels.dtype != torch.int32:
        raise ValueError(f"labels must be ({B}, {Tc}) int32, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if alive.shape != (B,) or alive.dtype != torch.float32 \
            or not alive.is_contiguous():
        raise ValueError("alive must be a contiguous (B,) float32 mask")
    dev = logits.device
    if labels.device != dev or alive.device != dev:
        raise ValueError("logits, labels and alive must share one device")
    if block_b < 1 or B == 0:
        raise ValueError(f"need block_b >= 1 and B >= 1, got {block_b}, {B}")
    ce_tok = torch.empty((B * Tc,), dtype=torch.float32, device=dev)
    g2_tok = torch.empty_like(ce_tok)
    ce_sum = torch.empty((B,), dtype=torch.float32, device=dev)
    g2_sum = torch.empty_like(ce_sum)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(logits.data_ptr(), _DTYPES[logits.dtype],
                     logits.stride(0), logits.stride(1), B, Tc, V,
                     labels.data_ptr(), labels.stride(0), labels.stride(1),
                     alive.data_ptr(), min(block_b, B),
                     ce_tok.data_ptr(), g2_tok.data_ptr(),
                     ce_sum.data_ptr(), g2_sum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ce_score_block launch failed: cudaError {err}")
    launches += 1
    return ce_sum, g2_sum
