"""Probe K5's hd-256 decode kernel (``csrc/flash_attn_decode.cu``) on the
card, at cell F's decode: q (8, 1, 16, 256) over a full 1024-slot ring of
k and v (8, 1024, 8, 256), bf16, not causal (67.3 MB: 0.0201 ms at
3.35 TB/s).

It builds edited copies of the kernel and times each by its device time
(calls queued behind a spin kernel, as ``chip_smoke.py``'s ``_device_ms``),
two rounds in turns:

* block shapes: (warps, keys a chunk, ring stages, resident blocks an SM)
  at a given number of splits, the first the shipped shape at the split
  ``decode_split`` gives (one block an SM), each checked against the
  shipped kernel's output;
* the shipped kernel without its math (the ring streamed, one add a key),
  without its merge of the splits (each block returns after its own
  state), and without both: what each costs above the access pattern's
  floor; ``torch.sum`` over the same 67 MB and an empty launch beside them.

With ``--dispatch DIR [DIR ...]`` it times instead the host's dispatch of
one such decode call through ``ops.flash_attention`` of the package under
each ``DIR/src`` (another checkout, or ``.``), each in a child process, in
turns: CUDA events around 200 calls, the host clock over 200 calls queued
without a synchronise, and ``flash_attn.plan`` alone. Run from the repo
root on a machine with an H100 and ``nvcc``::

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attn.decode_probe
    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attn.decode_probe \\
        --dispatch . /path/to/another/checkout
"""
import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import flash_attn as k5

B, HQ, HKV, HD, SKV = 8, 16, 8, 256, 1024
SHAPES = (  # warps, keys, stages, resident blocks an SM, splits
    (8, 4, 3, 2, 2),          # shipped: 128 blocks, one an SM
    (8, 4, 3, 2, 4), (8, 4, 3, 2, 1), (4, 4, 3, 4, 8), (4, 4, 3, 4, 4),
    (2, 4, 3, 8, 8), (16, 4, 3, 1, 2), (16, 4, 2, 1, 2), (8, 4, 4, 1, 2),
    (12, 4, 3, 1, 2), (8, 8, 3, 1, 2))
ROUNDS = 2


def _edit(text, old, new):
    assert text.count(old) == 1, old
    return text.replace(old, new)


def _shape(text, warps, keys, stages, blocks):
    for name, val in (("kWarps", warps), ("kKeys", keys),
                      ("kStages", stages), ("kMinBlocks", blocks)):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        text = _edit(text, line, f"constexpr int {name} = {val};")
    return text


def _no_math(text):
    """The loop body after the wait: one add a key instead of the scores,
    the softmax and P·V (the ring is still read)."""
    i = text.index("    float s[kKeys][G];")
    j = text.index("  }\n  cp_async_wait<0>();")
    body = ("#pragma unroll\n    for (int i = 0; i < kKeys; ++i) {\n"
            "      const uint4 a = st[(2 * i) * 32 + lane];\n"
            "      const uint4 b = st[(2 * i + 1) * 32 + lane];\n"
            "      acc[0][0] += __uint_as_float((a.x ^ b.y) & 0x3f000000u);\n"
            "      m[0] = 0.f;\n      l[0] = 1.f;\n    }\n")
    return text[:i] + body + text[j:]


def _no_merge(text):
    """Every block returns after its own state: no cluster merge."""
    return _edit(text, "  if (p.nsplit == 1) return;\n", "  return;\n")


def _variant(name, text):
    """Build one edited copy; its launch entry, its occupancy query and
    ptxas's lines for its G = 2 instance (gemma3's group)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"decode_probe_{name}.cu"
    src.write_text(text)
    so = build.build(src.stem, (src,))
    lib = ctypes.CDLL(str(so))
    fn = lib.flash_decode_launch
    fn.argtypes = k5._lib_decode()[0].argtypes
    fn.restype = ctypes.c_int
    occupancy = lib.flash_decode_occupancy
    occupancy.argtypes = k5._lib_decode()[1].argtypes
    occupancy.restype = ctypes.c_int
    entry, lines = "", []
    for ln in (build.BUILD_DIR / f"{src.stem}.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "ILi2E" in entry and ("registers" in ln or "spill" in ln):
            lines.append(ln.split(":")[-1].strip())
    return fn, occupancy, lines


def _device_ms(fn, n=50):
    """Device time per call: n calls queued behind a spin kernel between
    two CUDA events (the first still pending once all are queued)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    spin = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    for _ in range(3):
        torch.cuda._sleep(int(spin * 2e9))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
        spin *= 4
    raise RuntimeError("the host could not queue the calls ahead of the card")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def shapes():
    print(_card(), flush=True)
    k5._lib_decode()                 # the shipped library, built once
    text = k5.SOURCES_DECODE[0].read_text()
    variants = {f"w{w}k{kk}s{st}b{bl}": _shape(text, w, kk, st, bl)
                for w, kk, st, bl, _ in SHAPES}
    variants.update({"no_math": _no_math(text), "no_merge": _no_merge(text),
                     "no_math_no_merge": _no_merge(_no_math(text))})
    with ThreadPoolExecutor(8) as ex:
        built = dict(zip(variants, ex.map(lambda kv: _variant(*kv),
                                          variants.items())))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, 1, HQ, HD), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, SKV, HKV, HD), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    want = k5.flash_attention_cuda(q, k, v, False, 0, 0, HD ** -0.5)
    stream = torch.cuda.current_stream().cuda_stream
    g = HQ // HKV

    def launch(fn, nsplit, o):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 HKV, g, k5.decode_heads(g), q.stride(0), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2), v.stride(0),
                 v.stride(1), v.stride(2), o.stride(0), o.stride(2), 0, SKV,
                 nsplit, HD ** -0.5, stream)
        assert err == 0, err
    shipped = k5.decode_split(B * HKV, SKV, k5._sm_count(0))
    runs = {}                   # label -> (build, splits, checked)
    for w, kk, st, bl, nsplit in SHAPES:
        runs[f"w{w}k{kk}s{st}b{bl} at {nsplit} splits "
             f"({B * HKV * nsplit} blocks)"] = (f"w{w}k{kk}s{st}b{bl}",
                                                nsplit, True)
    for name in ("no_math", "no_merge", "no_math_no_merge"):
        runs[f"shipped, {name.replace('_', ' ')}"] = (name, shipped, False)
    times = {label: [] for label in runs}
    out = {label: torch.empty_like(q) for label in runs}
    for r in range(ROUNDS):
        for label in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            name, nsplit, _ = runs[label]
            times[label].append(_device_ms(
                lambda: launch(built[name][0], nsplit, out[label])))
    flat = torch.cat([k.reshape(-1), v.reshape(-1)])
    yard = {"torch.sum over the same 67 MB":
            [_device_ms(lambda: flat.sum(dtype=torch.float32))
             for _ in range(ROUNDS)],
            "an empty launch": [_device_ms(lambda: torch.cuda._sleep(0))
                                for _ in range(ROUNDS)]}
    print(f"q ({B},1,{HQ},{HD}) over a full {SKV}-slot ring ({B},{SKV},{HKV},"
          f"{HD}) bf16, not causal; decode_split gives {shipped} splits; "
          f"device time, {ROUNDS} rounds in turns (ms)", flush=True)
    for label, (name, nsplit, checked) in runs.items():
        err = float((out[label].float() - want.float()).abs().max())
        clusters = ctypes.c_int(0)
        blocks = built[name][1](g, nsplit, ctypes.byref(clusters))
        print(f"  {label}: {[round(t, 5) for t in times[label]]}"
              + (f"; max |diff| to the shipped {err:.1e}" if checked else "")
              + f"; {blocks} blocks an SM, {clusters.value} clusters of "
              f"{nsplit} on the card; ptxas (G 2) {built[name][2]}",
              flush=True)
    for name, ts in yard.items():
        print(f"  {name}: {[round(t, 5) for t in ts]}", flush=True)


_DISPATCH = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels.flash_attn import flash_attn as k5
from repro_torch.kernels.flash_attn.ops import flash_attention
gen = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn((8, 1, 16, 256), generator=gen, device="cuda").bfloat16()
k, v = (torch.randn((8, 1024, 8, 256), generator=gen, device="cuda")
        .bfloat16() for _ in range(2))
def call():
    return flash_attention(q, k, v, causal=False)
call(); torch.cuda.synchronize()
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
start.record()
for _ in range(200): call()
end.record(); torch.cuda.synchronize()
events = start.elapsed_time(end) / 200
t0 = time.perf_counter()
for _ in range(200): call()
host = (time.perf_counter() - t0) / 200 * 1e3
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(2000): k5.plan(q, k, v)
plan = (time.perf_counter() - t0) / 2000 * 1e3
print(json.dumps(dict(kernel=k5.plan(q, k, v), event_loop_ms=events,
                      host_loop_ms=host, plan_ms=plan,
                      launches=dict(k5.launches_by_kernel))))
'''


def dispatch(trees):
    print(_card(), flush=True)
    for r in range(2):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            src = str(Path(tree).resolve() / "src")
            res = subprocess.run([sys.executable, "-c", _DISPATCH, src],
                                 capture_output=True, text=True, check=True)
            print(f"{tree}: {res.stdout.strip()}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dispatch", nargs="+", metavar="DIR")
    args = ap.parse_args()
    if args.dispatch:
        dispatch(args.dispatch)
    else:
        shapes()


if __name__ == "__main__":
    main()
