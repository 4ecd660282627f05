#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA GPU and hold every kernel
of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the process exits non-zero:

1. card     — the GPU's name and power limit (``nvidia-smi``), CUDA version;
2. build    — compile every kernel from the sources in this checkout;
3. K4       — ``ce_score_block`` against its plain version on the card:
              the slice's (12, 128, 128256) bf16 chunk view, a ragged
              shape, row blocks of 8 with dead blocks and label −1, f32;
4. prune    — ``pruned_pool_score`` on the card: survivors bitwise equal
              to the unpruned chunked pass; alive mask and receipt equal
              to the plain version's run on the same tensors;
5. lm-tiny  — the slice at lm-tiny on the card against the same run on
              the CPU (same params, same plans, losses to 1e-3);
6. slice    — ``repro_torch.train("llama3.2-3b", preset="prod", ...)``:
              full width and depth, the cuts printed, ``STEPS`` steps; K4's
              launch count is zeroed just before and read just after.
              Steps 0, 1 and 3 are timed; step ``PROFILED`` runs under
              ``torch.profiler``: where a steady step's device time goes,
              by kernel group and by name, and the device's idle share
              against step 1's unprofiled wall time (the full table goes
              to ``chiprun_out/profile_step.txt``);
7. timing   — K4 per launch (CUDA events) beside its plain version and its
              bound at the slice's shape.

The second-to-last lines are the card line and the ``{"kernels": ...}``
line; the last line is ``{"ok": true, "device": {...}}``. Also written to
``chiprun_out/chip_smoke.json``. It needs a CUDA GPU and the repository
around it: it never falls back to the CPU or to a plain version.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet (700 W)
F32_FLOPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
TOL = dict(rtol=1e-4, atol=1e-3)  # kernel vs plain, f32 row sums over ≤128
                                  # tokens: __expf and the summation order
BATCH = 4      # global batch (prod: 256); the pool is 3 × BATCH = 12 rows
STEPS = 4      # prod: 1000; steps 0, 1 and 3 timed, step PROFILED profiled
PROFILED = 2   # a steady step: it updates and scores the next pool


def log(*a):
    print(*a, flush=True)


def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
        f" | cuda {torch.version.cuda} | nvidia-smi: {smi}")
    return smi


def build_all(kernels):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = [build.build(k["name"], k["sources"]) for k in kernels]
    dt = time.perf_counter() - t0
    for k, so in zip(kernels, libs):
        log(f"[build] {k['name']}: {so.relative_to(ROOT)}")
        report = (build.BUILD_DIR / f"{k['name']}.log").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] dir {build.BUILD_DIR.relative_to(ROOT)}, {dt:.1f} s")


def _k4_inputs(B, T, V, dtype, gen, dead=(), pad_frac=0.0):
    z = torch.randn((B, T, V), generator=gen, device="cuda").mul_(2.0)
    y = torch.randint(0, V, (B, T), generator=gen, device="cuda",
                      dtype=torch.int32)
    if pad_frac:
        y[torch.rand((B, T), generator=gen, device="cuda") < pad_frac] = -1
    alive = torch.ones(B, device="cuda")
    alive[list(dead)] = 0.0
    return z.to(dtype), y, alive


def check_k4(gen):
    """Phase 3. Returns the worst absolute error."""
    from repro_torch.kernels.ce_score.ops import ce_score_block
    from repro_torch.kernels.ce_score.ref import ce_score_block_ref
    cases = [
        # name, (B, T, V), dtype, time slice, block_b, dead rows, pad
        ("slice (12,128,128256) bf16 chunk view", (12, 256, 128256),
         torch.bfloat16, slice(128, 256), 1, (), 0.0),
        ("ragged (7,45,50257) bf16", (7, 45, 50257), torch.bfloat16,
         slice(0, 45), 1, (2, 5), 0.2),
        ("block_b 8 (20,33,32003) bf16", (20, 33, 32003), torch.bfloat16,
         slice(0, 33), 8, (*range(8, 16), 17), 0.2),
        ("f32 (12,37,32003) chunk view", (12, 50, 32003), torch.float32,
         slice(5, 42), 8, (0,), 0.1),
    ]
    worst = 0.0
    for name, shape, dtype, ts, bb, dead, pad in cases:
        z, y, alive = _k4_inputs(*shape, dtype, gen, dead, pad)
        zc, yc = z[:, ts], y[:, ts]
        got = ce_score_block(zc, yc, alive, block_b=bb)
        want = ce_score_block_ref(zc, yc, alive, block_b=bb)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
            err = max(err, float((g - w).abs().max()))
        # a fully dead row block reads nothing and returns exact zeros
        B, nb = zc.shape[0], -(-zc.shape[0] // bb)
        a = torch.nn.functional.pad(alive, (0, nb * bb - B))
        dead_rows = (a.reshape(nb, bb).amax(1) == 0).repeat_interleave(bb)[:B]
        assert all(bool((g[dead_rows] == 0).all()) for g in got)
        worst = max(worst, err)
        log(f"[k4] {name}: max |kernel - plain| = {err:.3e} "
            f"(rtol {TOL['rtol']}, atol {TOL['atol']})")
        del z, y, alive, zc, yc, got, want
    torch.cuda.empty_cache()
    return worst


def check_prune(gen):
    """Phase 4, at the slice's pool: (12, 1024, 128256) bf16, k = 4."""
    from repro_torch.kernels.fused_presample.ops import pruned_pool_score
    from repro_torch.sampler.selection import hash_context
    B, T, V, k = 12, 1024, 128256, 4
    z = torch.empty((B, T, V), dtype=torch.bfloat16, device="cuda")
    for r, s in enumerate(torch.linspace(0.5, 4.0, B).tolist()):
        z[r] = torch.randn((T, V), generator=gen, device="cuda").mul_(s)
    y = torch.randint(0, V, (B, T), generator=gen, device="cuda",
                      dtype=torch.int32)
    ctx = hash_context(0, 4211, 1)
    s, alive, loss, st = pruned_pool_score(z, y, ctx, k=k)
    s0, alive0, loss0, st0 = pruned_pool_score(z, y, ctx, k=B)
    sp, alivep, _, stp = pruned_pool_score(z, y, ctx, k=k, interpret=True)
    torch.cuda.synchronize()
    live = alive > 0
    assert bool(alive0.all())
    assert torch.equal(s[live], s0[live]), "survivors differ from unpruned"
    assert torch.equal(loss[live], loss0[live])
    assert torch.equal(alive, alivep), (alive, alivep)
    assert torch.equal(st, stp), (st, stp)
    torch.testing.assert_close(s[live], sp[live], **TOL)
    log(f"[prune] rows killed {int(st[0])}/{B}, tiles skipped "
        f"{int(st[1])}/{int(st[2])}; survivors bitwise = unpruned; alive "
        f"mask and receipt = plain version's")
    del z, y
    torch.cuda.empty_cache()


def check_lm_tiny():
    """Phase 5: the slice's path at lm-tiny on the card and on the CPU,
    from the same params: as ``prod`` sets it (τ̂ stays under the gate, the
    uniform phase) and with the gate lowered so the weighted update runs."""
    from repro_torch.api import Experiment, build_run
    from repro_torch.checkpoint import interop
    for name, extra in (("prod", {}), ("is-active", {"imp.tau_th": 1.01})):
        run = build_run("lm-tiny", preset="prod", overrides={
            "shape.seq_len": 64, "shape.global_batch": 4, "steps": 3,
            "obs.enabled": False, "imp.score_dtype": "float32", **extra})
        gpu = Experiment(run)
        cpu = Experiment(run, device="cpu")
        interop.load_params(cpu.lm, interop.params_to_numpy(gpu.lm))
        _, hg = gpu.fit()
        _, hc = cpu.fit()
        for a, b in zip(hg, hc):
            assert math.isfinite(a["loss"])
            assert abs(a["loss"] - b["loss"]) < 1e-3, (a["loss"], b["loss"])
            assert a["sampler_active"] == b["sampler_active"]
        if extra:
            assert any(h["sampler_active"] for h in hg), "IS never active"
        torch.testing.assert_close(
            torch.from_numpy(gpu.sampler.store.scores),
            torch.from_numpy(cpu.sampler.store.scores), rtol=1e-3, atol=1e-4)
        log(f"[lm-tiny] {name}: gpu losses "
            f"{[round(h['loss'], 5) for h in hg]} = cpu "
            f"{[round(h['loss'], 5) for h in hc]} (to 1e-3); IS active "
            f"{[int(h['sampler_active']) for h in hg]}")


KERNEL_GROUPS = (  # first match wins; names as the profiler reports them
    ("K4 ce_score_block", ("ce_token_kernel", "row_sum_kernel")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sgemm")),
    ("memcpy/memset", ("Memcpy", "Memset")),
    ("elementwise/reduce", ("",)),
)


def run_slice(out):
    """Phase 6: the port's main path at llama3.2-3b full width."""
    import repro_torch
    from repro_torch.api import Hook
    from repro_torch.kernels.ce_score import ce_score as k4
    from torch.profiler import ProfilerActivity, profile
    overrides = {"shape.global_batch": BATCH, "shape.seq_len": 1024,
                 "steps": STEPS, "obs.enabled": False}
    log(f"[slice] llama3.2-3b, preset prod, overrides {overrides}")
    log("[slice] cuts from prod: seq_len 4096 -> 1024; global_batch 256 -> "
        f"{BATCH}; steps 1000 -> {STEPS} (step {PROFILED} under "
        "torch.profiler); telemetry on -> off; checkpointing on -> none; "
        "data plane pipelined -> synchronous, depth 1. Width, depth "
        "(28 layers) and vocab are not cut.")

    class StepLog(Hook):
        def __init__(self):
            self.rows = []
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])

        def on_step_start(self, loop, step, b, meta):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if step == PROFILED:
                self.prof.start()
            self.t0 = time.perf_counter()

        def on_step_end(self, loop, step, m):
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            if step == PROFILED:
                self.prof.stop()
            st = loop.exp.sampler.last_prune
            row = dict(step=step, loss=m["loss"], tau_hat=m["presample_tau"],
                       is_active=m["sampler_active"],
                       rows_killed=int(st[0]), tiles_skipped=int(st[1]),
                       tiles_total=int(st[2]), step_s=wall,
                       profiled=step == PROFILED,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            self.rows.append(row)
            log("[slice] " + json.dumps(row))

    hook = StepLog()
    k4.launches = 0
    t0 = time.perf_counter()
    _, history = repro_torch.train("llama3.2-3b", preset="prod",
                                   overrides=overrides, hooks=[hook])
    torch.cuda.synchronize()
    launches = k4.launches
    total = time.perf_counter() - t0
    assert len(history) == STEPS
    assert all(math.isfinite(h["loss"]) for h in history), history
    log(f"[slice] {STEPS} steps in {total:.1f} s (model build included); "
        f"K4 launches {launches} ({launches / STEPS:g} per step)")
    assert launches == 8 * STEPS, "K4 was not launched 8 times per step"
    breakdown = step_breakdown(hook.prof, hook.rows, out)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, hook.rows, breakdown


def step_breakdown(prof, rows, out):
    """Device time of the profiled step by kernel, from torch.profiler.
    Busy time is the sum of device activity on the one stream the port
    uses; the idle share is taken against step 1's unprofiled wall time,
    a step of the same work without the profiler's overhead."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us * 1e-6
    busy = sum(by_name.values())
    if busy == 0.0:
        log("[profile] the profiler saw no device activity: breakdown not "
            "measured")
        return None
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    for name, s in by_name.items():
        g = next(g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys))
        groups[g] += s
    wall, steady = rows[PROFILED]["step_s"], rows[1]["step_s"]
    log(f"[profile] step {PROFILED}: wall {wall:.4f} s (profiled), device "
        f"busy {busy:.4f} s; idle share against step 1's unprofiled "
        f"{steady:.4f} s: {1 - busy / steady:.3f}")
    for g, s in groups.items():
        log(f"[profile]   {g}: {s * 1e3:.2f} ms ({s / busy:.3f} of busy)")
    for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {s * 1e3:9.2f} ms  {name[:100]}")
    (out / "profile_step.txt").write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=60))
    return {"step": PROFILED, "wall_s": wall, "busy_s": busy,
            "idle_share": 1 - busy / steady, "groups_s": groups}


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


def time_k4(gen):
    """Phase 7: K4 at the slice's shape — a time chunk of the pool."""
    from repro_torch.kernels.ce_score.ops import ce_score_block
    from repro_torch.kernels.ce_score.ref import ce_score_block_ref
    z, y, alive = _k4_inputs(12, 256, 128256, torch.bfloat16, gen)
    zc, yc = z[:, :128], y[:, :128]
    B, Tc, V = zc.shape
    ms = _time(lambda: ce_score_block(zc, yc, alive, block_b=1), 50)
    plain_ms = _time(lambda: ce_score_block_ref(zc, yc, alive, block_b=1), 5)
    # the least the card could take: every logit read once, labels, alive
    # and the outputs; the work is ~8 f32 ops a logit (max, sub, exp, two
    # adds, a square) outside the tensor cores
    n_bytes = B * Tc * V * zc.element_size() + B * Tc * 4 + B * 4 + 2 * B * 4
    n_ops = 8 * B * Tc * V
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S)
    by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_FLOPS_PER_S \
        else "operations"
    log(f"[timing] K4 (12,128,128256) bf16: {ms:.4f} ms/launch, plain "
        f"{plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms ({by}: "
        f"{n_bytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s), "
        f"{n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved")
    return ms, plain_ms, bound_s * 1e3, by


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; torch finds none")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ce_score import ce_score as k4
    kernels = [dict(name="ce_score_block", route="cuda",
                    source="src/repro_torch/kernels/ce_score/csrc/"
                           "ce_score_block.cu",
                    replaces="src/repro/kernels/ce_score/ce_score.py:144",
                    sources=k4.SOURCES, held_by="phase 3 (K4) and 4 (prune)")]

    smi = card()
    build_all(kernels)
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = check_k4(gen)
    check_prune(gen)
    check_lm_tiny()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    launches, rows, breakdown = run_slice(out)
    ms, plain_ms, bound_ms, by = time_k4(gen)

    line = {"kernels": [{
        "name": "ce_score_block", "route": "cuda",
        "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
        "library_ms": None, "held_by": kernels[0]["held_by"]}]}
    ok = {"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "steps": rows, "profile": breakdown, **line, **ok},
        indent=1))
    print(smi)
    print(json.dumps(line))
    print(json.dumps(ok), flush=True)


if __name__ == "__main__":
    main()
