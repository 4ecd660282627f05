"""Probe K5's f32 prefill kernel (``csrc/flash_attn_fwd_f32.cu``) on the
card, at cell I's pool scoring: q (12, 1024, 10, 64), k and v
(12, 1024, 5, 64), f32, causal (1.61e10 flop: 0.2406 ms at 67 TFLOP/s).

It builds edited copies of the kernel and times each by CUDA events (the
median of 5 rounds of 20 calls, in turns, the order reversed every other
round) beside the shipped kernel, the ``mma.sync`` kernel's f32 path on
the same values (q copied off 16 bytes, which the f32 route refuses) and
SDPA's efficient backend (k and v expanded to q's heads):

* tilings: 64-key tiles (two blocks an SM), the loop over d unrolled by
  4, O and l rescaled only when a row's max moves (a branch per row);
  each held against the plain version (2e-4, and 1e-5 of a row's largest
  output) and for the same bits on a second launch;
* ablations, which compute something else and are only timed: without
  P·V, without S, without both, without the exponentials (ex2 replaced by
  a copy), without the K/V copies of later tiles.

Then it runs the shipped kernel back to back for 4 s while it samples the
card's SM clock and power draw (``nvidia-smi``). Run from the repo root on
a machine with an H100 and ``nvcc``::

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attn.f32_probe
"""
import ctypes
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import flash_attn as k5
from repro_torch.kernels.flash_attn.ops import flash_attention

B, SQ, HQ, HKV, HD = 12, 1024, 10, 5, 64
FLOP = 4 * B * HQ * HD * (SQ * (SQ + 1) // 2)
BOUND_MS = FLOP / 67e12 * 1e3
ROUNDS = 5
TILE_64 = (("constexpr int kBN = 32;", "constexpr int kBN = 64;"),
           ("constexpr int kTN = 2; ", "constexpr int kTN = 4; "),
           ("kMinBlocks = HD <= 64 ? 3 : 2;",
            "kMinBlocks = HD <= 64 ? 2 : 1;"))
NO_S = (("for (int d = 0; d < HD; d += 4) {",
         "for (int d = 0; d < 0; d += 4) {"),)
NO_PV = (("for (int j = 0; j < kBN; j += 4) {",
          "for (int j = 0; j < 0; j += 4) {"),)
VARIANTS = {  # name: (checked against the plain version, edits)
    "64-key tiles": (True, TILE_64),
    "d unrolled by 4": (True, (("#pragma unroll\n    for (int d",
                                "#pragma unroll 4\n    for (int d"),)),
    "O rescaled when the max moves": (True, ((
        "      const float corr = ex2(m[i] - mn);  // exactly 1 while the max "
        "holds\n      m[i] = mn;\n      l[i] *= corr;\n#pragma unroll\n"
        "      for (int n = 0; n < T::NC; ++n) o[i][n] *= corr;\n",
        "      if (mn > m[i]) {\n        const float corr = ex2(m[i] - mn);\n"
        "        l[i] *= corr;\n#pragma unroll\n"
        "        for (int n = 0; n < T::NC; ++n) o[i][n] *= corr;\n"
        "        m[i] = mn;\n      }\n"),)),
    "no P.V": (False, NO_PV),
    "no S": (False, NO_S),
    "no S, no P.V": (False, NO_S + NO_PV),
    "no ex2": (False, (('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
                        '"f"(x));', "y = x;"),)),
    "no K/V copies after the first": (False, (
        ("      load_kv(t + 1, buf ^ 1);\n", "\n"),)),
}
CASES = (  # b, sq, skv, hq, hkv, hd, window, q_offset, q scale, scale
    (B, SQ, SQ, HQ, HKV, HD, 0, 0, 1.0, None),
    (B, SQ, SQ, HQ, HKV, HD, 0, 0, 6.0, None),
    (2, 77, 77, 24, 8, 64, 0, 0, 1.0, None),
    (2, 200, 456, 24, 8, 64, 64, 256, 1.0, 0.2),
    (2, 300, 300, 24, 8, 128, 0, 0, 1.0, None),
    (2, 64, 64, 4, 2, 16, 0, 0, 6.0, 0.3),
)


def _variant(i, edits):
    """Build one edited copy; its launch entry and ptxas's hd-64 lines."""
    text = k5.SOURCES_F32[0].read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"f32_probe_{i}.cu"
    src.write_text(text)
    so = build.build(src.stem, (src,))
    fn = ctypes.CDLL(str(so)).flash_fwd_f32_launch
    fn.argtypes = k5._lib_f32().argtypes
    fn.restype = ctypes.c_int
    entry, lines = "", []
    for ln in (build.BUILD_DIR / f"{src.stem}.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "ILi64E" in entry and ("registers" in ln or "spill" in ln):
            lines.append(ln.split(":")[-1].strip())
    return fn, lines


def _launch(fn, q, k, v, window=0, q_offset=0, scale=None):
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
             q.shape[3], *k5._strides(q), *k5._strides(k), *k5._strides(v),
             *k5._strides(o), 1, window, q_offset,
             scale or q.shape[3] ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return o


def _inputs(b, sq, skv, hq, hkv, hd, q_scale, gen):
    q = torch.randn((b, sq, hq, hd), generator=gen, device="cuda") * q_scale
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen, device="cuda")
            for _ in range(2))
    return q, k, v


def _check(fn, gen):
    """Worst |kernel - plain| and worst row error over the row's largest
    |output| over CASES; whether a second launch gave the same bits."""
    worst, worst_rel, same = 0.0, 0.0, True
    for b, sq, skv, hq, hkv, hd, w, off, qs, sc in CASES:
        q, k, v = _inputs(b, sq, skv, hq, hkv, hd, qs, gen)
        kw = dict(window=w, q_offset=off, scale=sc)
        got = fn(q, k, v, **kw)
        same &= torch.equal(fn(q, k, v, **kw), got)
        want = torch.cat([flash_attention(q[i:i + 2], k[i:i + 2],
                                          v[i:i + 2], interpret=True, **kw)
                          for i in range(0, b, 2)])
        err = (got - want).abs()
        worst = max(worst, float(err.max()))
        worst_rel = max(worst_rel, float(
            (err.amax(-1) / want.abs().amax(-1).clamp_min(1e-30)).max()))
    return worst, worst_rel, same


def _event_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _clocks(fn, seconds=4.0):
    """Launches of fn back to back for ``seconds``, the SM clock (MHz) and
    power draw (W) sampled every 0.2 s meanwhile."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.strip())
            time.sleep(0.2)
    th = threading.Thread(target=sample)
    th.start()
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        n += 50
    stop.set()
    th.join()
    return n, time.perf_counter() - t0, samples


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    k5._lib_f32(), k5._lib()          # the shipped libraries, built once
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(
            lambda ie: _variant(*ie),
            enumerate(edits for _, edits in VARIANTS.values()))))
    for name, (_, ptxas) in built.items():
        print(f"[ptxas] {name} (hd 64): {'; '.join(ptxas)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = _check(lambda q, k, v, **kw: flash_attention(q, k, v, **kw), gen)
    print(f"[check] shipped: worst {err[0]:.3e}, row {err[1]:.3e}, same "
          f"bits {err[2]}", flush=True)
    for name, (checked, _) in VARIANTS.items():
        if checked:
            fn = built[name][0]
            err = _check(lambda q, k, v, fn=fn, **kw: _launch(fn, q, k, v,
                                                               **kw), gen)
            print(f"[check] {name}: worst {err[0]:.3e}, row {err[1]:.3e}, "
                  f"same bits {err[2]}", flush=True)
    q, k, v = _inputs(B, SQ, SQ, HQ, HKV, HD, 1.0, gen)
    buf = torch.empty(q.numel() + 2, device="cuda")
    q_off = buf[2:].view(q.shape).copy_(q)
    assert k5.plan(q, k, v) == "f32" and k5.plan(q_off, k, v) == "mma"
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = HQ // HKV
    qt, kt, vt = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
    runs = {"shipped": lambda: flash_attention(q, k, v),
            "mma.sync path": lambda: flash_attention(q_off, k, v),
            "SDPA efficient": sdpa,
            **{name: (lambda fn=fn: _launch(fn, q, k, v))
               for name, (fn, _) in built.items()}}
    ev = {name: [] for name in runs}
    for r in range(ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            ev[name].append(_event_ms(runs[name]))
    for name, ts in ev.items():
        ms = sorted(ts)[ROUNDS // 2]
        print(f"[time] {name}: {ms:.4f} ms (rounds "
              f"{[round(t, 4) for t in ts]}), {FLOP / ms / 1e9:.1f} TFLOP/s, "
              f"{BOUND_MS / ms:.3f} of the {BOUND_MS:.4f} ms bound",
              flush=True)
    n, s, samples = _clocks(runs["shipped"])
    print(f"[clocks] {n} launches of the shipped kernel in {s:.2f} s; SM "
          f"clock MHz, power W every 0.2 s: {samples}", flush=True)


if __name__ == "__main__":
    main()
