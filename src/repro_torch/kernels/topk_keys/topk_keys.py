"""K6 on Hopper: the sharded selection's race keys, hand-written CUDA.

Binds ``csrc/race_keys.cu``, which replaces the TPU kernel
``race_keys_pallas`` of ``repro/kernels/topk_keys/topk_keys.py``. The
library is compiled by ``repro_torch.kernels.build`` at the first launch.
The wrapper checks what the kernel takes, allocates the keys, launches on
PyTorch's current stream and raises if the launch fails: there is no
fallback here (``ops.topk_race_keys`` picks the plain version only for
CPU tensors or ``interpret=True``).

``launches`` counts the wrapper's launches; ``chip_smoke.py`` zeroes it
around the main path to show the path went through the kernel.
"""
import ctypes
from pathlib import Path

import torch
from torch import Tensor

_CSRC = Path(__file__).with_name("csrc")
LIB = "race_keys"                       # K6's library
SOURCES = (_CSRC / "race_keys.cu", _CSRC / "race_hash.cuh")

launches = 0


def _lib():
    from repro_torch.kernels import build
    fn = build.load(LIB, SOURCES).race_keys_launch
    p, u, f = ctypes.c_void_p, ctypes.c_uint, ctypes.c_float
    fn.argtypes = [p, p, ctypes.c_longlong, u, u, u, f, f, f, f, p, p]
    fn.restype = ctypes.c_int
    return fn


def race_keys_cuda(scores: Tensor, seen: Tensor, ctx: int, fparams, *,
                   host_id: int, n_hosts: int) -> Tensor:
    """scores, seen (n,) contiguous f32 on one CUDA device (seen: 1 seen,
    0 unseen, −1 padded lane); ``ctx`` the plan's uint32 hash context;
    ``fparams`` the four f32 values [fill_pow, (1−λ)/S̃, λ/n, 1/T] →
    race keys (n,) f32, +inf on padded lanes. Slot i's global id is
    i·n_hosts + host_id (mod 2³²)."""
    global launches
    n = scores.shape[0]
    for name, t in (("scores", scores), ("seen", seen)):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device.type != "cuda":
            raise ValueError(f"{name} must be a contiguous ({n},) float32 "
                             f"CUDA tensor, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if seen.device != scores.device:
        raise ValueError("scores and seen must share one device")
    if not (0 <= host_id < n_hosts < 2 ** 32):
        raise ValueError(f"need 0 <= host_id < n_hosts, got {host_id}, "
                         f"{n_hosts}")
    keys = torch.empty_like(scores)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = _lib()(scores.data_ptr(), seen.data_ptr(), n, host_id, n_hosts,
                     int(ctx) & 0xFFFFFFFF, *map(float, fparams),
                     keys.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"race_keys launch failed: cudaError {err}")
    launches += 1
    return keys
