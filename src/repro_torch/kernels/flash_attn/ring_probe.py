"""Probe the ring depths of K5's wgmma kernel on the card.

The kernel streams K and V through rings of ``kKStages`` and ``kVStages``
shared-memory slots (3 and 2; 32 KB a slot, two more for Q's double
buffer, so at most 7 slots fit in a block's 227 KB). This script builds
the kernel at each depth that fits, checks that every variant's output is
bitwise the shipped kernel's, and times each beside cuDNN's
``scaled_dot_product_attention`` at the main path's shapes: CUDA events
around a loop, seven rounds in turns, the median round. Run from the repo
root on a machine with an H100 and ``nvcc``::

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attn.ring_probe
"""
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import flash_attn as k5
from repro_torch.kernels.flash_attn.ops import flash_attention

DEPTHS = ((3, 2), (2, 2), (2, 3))       # (K, V) slots; the first shipped
SHAPES = ((8, 4096, 4160), (12, 1024, 1024), (8, 1024, 1024))  # b, sq, slots
ROUNDS = 7


def _variant(kd, vd, argtypes):
    """Build the kernel with rings of kd and vd slots; its launch entry."""
    text = k5.SOURCES_WGMMA[0].read_text()
    for name, old, new in (("kKStages", 3, kd), ("kVStages", 2, vd)):
        line = f"constexpr int {name} = {old};"
        assert text.count(line) == 1, line
        text = text.replace(line, f"constexpr int {name} = {new};")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"flash_attn_fwd_wgmma_k{kd}v{vd}.cu"
    src.write_text(text)
    so = build.build(src.stem, (src,))
    log = (build.BUILD_DIR / f"{src.stem}.log").read_text()
    fn = ctypes.CDLL(str(so)).flash_fwd_wgmma_launch
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn, [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]


def _time(fn, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main():
    from torch.nn.attention import SDPBackend, sdpa_kernel
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    shipped = k5._lib_wgmma
    argtypes = shipped().argtypes          # builds the shipped library
    with ThreadPoolExecutor(len(DEPTHS)) as ex:
        built = dict(zip(DEPTHS, ex.map(lambda d: _variant(*d, argtypes),
                                        DEPTHS)))
    for (kd, vd), (_, report) in built.items():
        print(f"K {kd} / V {vd}:", *report, sep="\n  ", flush=True)

    def run_with(depth, q, k, v):
        k5._lib_wgmma = lambda: built[depth][0]
        try:
            return flash_attention(q, k, v)
        finally:
            k5._lib_wgmma = shipped

    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, sq, slots in SHAPES:
        q = torch.randn((b, sq, 24, 128), generator=gen,
                        device="cuda").bfloat16()
        kv = [torch.randn((b, slots, 8, 128), generator=gen,
                          device="cuda").bfloat16() for _ in range(2)]
        k, v = (t[:, :sq] for t in kv)
        want = flash_attention(q, k, v)
        same = {d: torch.equal(run_with(d, q, k, v), want) for d in DEPTHS}
        qt = q.transpose(1, 2)
        kt, vt = (t.repeat_interleave(3, 2).transpose(1, 2) for t in (k, v))

        def cudnn():
            with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
        runs = {f"K {kd} / V {vd}": (lambda d=(kd, vd): run_with(d, q, k, v))
                for kd, vd in DEPTHS}
        runs["cudnn"] = cudnn
        n = 20 if sq > 2048 else 50
        times = {name: [] for name in runs}
        for r in range(ROUNDS):
            for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[name].append(_time(runs[name], n))
        flop = 4 * b * 24 * 128 * sq * (sq + 1) // 2
        print(f"q ({b},{sq},24,128), kv ({b},{sq} of {slots},8,128) bf16, "
              f"causal; bitwise the shipped kernel's: {same}", flush=True)
        for name, ts in times.items():
            ts = sorted(ts)
            med = ts[ROUNDS // 2]
            print(f"  {name:9s} median {med:.4f} ms [{ts[0]:.4f} .. "
                  f"{ts[-1]:.4f}] {flop / (med * 1e-3) / 1e12:.1f} TFLOP/s",
                  flush=True)
        del q, kv, k, v, want, qt, kt, vt
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
