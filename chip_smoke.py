#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA GPU and hold every kernel
of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the process exits non-zero:

1. card     — the GPU's name and power limit (``nvidia-smi``), CUDA version;
2. build    — compile every kernel from the sources in this checkout, one
              ``nvcc`` per source, all started together;
3. K4       — ``ce_score_block`` against its plain version on the card:
              the slice's (12, 128, 128256) bf16 chunk view, a ragged
              shape, row blocks of 8 with dead blocks and label −1, f32;
4. prune    — ``pruned_pool_score`` on the card: survivors bitwise equal
              to the unpruned chunked pass; alive mask and receipt equal
              to the plain version's run on the same tensors;
5. lm-tiny  — the prod slice at lm-tiny on the card against the same run
              on the CPU (same params, same plans, losses to 1e-3);
6. slice    — ``repro_torch.train("llama3.2-3b", preset="prod", ...)``:
              full width and depth, the cuts printed, ``STEPS`` steps; the
              kernels' launch counts are zeroed just before and read just
              after (K4: 8 a step). Steps 0, 1 and 3 are timed; step
              ``PROFILED`` runs under ``torch.profiler``: where a steady
              step's device time goes, by kernel group and by name, and
              the device's idle share against step 1's unprofiled wall
              time (the full table goes to ``chiprun_out/profile_step.txt``);
7. timing   — K4 per launch (CUDA events) beside its plain version and its
              bound at the slice's shape;
8. K6       — ``topk_race_keys`` against its plain version on the card:
              the warm 2²⁴ store of the history slice, a ragged 3-host
              shard with unseen and padded lanes, and the CPU test's cases;
              worst key error against ``K6_RTOL``, bottom-k slots equal;
9. sharded  — ``sample_sharded`` with K6 on the warm 2²⁴ store against
              K6's plain version (equal gids, weights to 1e-5 relative),
              and beside it the float64 numpy loop's draws (measured, see
              ``check_sharded``);
10. history lm-tiny — ``history`` (sharded and gather) at lm-tiny on the
              card against the CPU run (plans and losses to 1e-3);
11. history slice — ``repro_torch.train("llama3.2-3b", preset="prod",
              overrides={"sampler.scheme": "history",
              "imp.selection_impl": "sharded", ...})`` at full width and
              depth over a 2²⁴-sequence source whose store is warmed at
              loop start (the cut printed); counts zeroed just before and
              read just after (K6: one launch a plan); per step the loss,
              store τ, gate, weights, the plan's split (stats reduction,
              host-to-card transfer, K6, bottom-k), wall time, peak memory;
12. K6 timing — K6 per launch (CUDA events) at n = 2²⁴ beside its plain
              version, the bottom-k, the transfer and its bound.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet (700 W)
F32_FLOPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
TOL = dict(rtol=1e-4, atol=1e-3)  # kernel vs plain, f32 row sums over ≤128
                                  # tokens: __expf and the summation order
BATCH = 4      # global batch (prod: 256); the pool is 3 × BATCH = 12 rows
STEPS = 4      # prod: 1000; steps 0, 1 and 3 timed, step PROFILED profiled
PROFILED = 2   # a steady step: it updates and scores the next pool
N_STORE = 2 ** 24  # the history slice's dataset: 16.8 M sequences of 1024
WARM_FRAC = 0.9    # share of the store warmed at loop start (the rest unseen)
K6_RTOL = 2e-6     # kernel vs plain keys: both f32, IEEE logf/expf on the
                   # card; a last-ulp difference in log(s) grows by |log s|/T
                   # through the exp


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
    """One nvcc per kernel, all started together."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        libs = list(pool.map(lambda k: build.build(k["name"], k["sources"]),
                             kernels))
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
    from repro_torch.kernels.topk_keys import topk_keys as k6
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
    k4.launches = k6.launches = 0
    t0 = time.perf_counter()
    _, history = repro_torch.train("llama3.2-3b", preset="prod",
                                   overrides=overrides, hooks=[hook])
    torch.cuda.synchronize()
    launches = k4.launches
    total = time.perf_counter() - t0
    assert len(history) == STEPS
    assert all(math.isfinite(h["loss"]) for h in history), history
    log(f"[slice] {STEPS} steps in {total:.1f} s (model build included); "
        f"K4 launches {launches} ({launches / STEPS:g} per step), K6 "
        f"{k6.launches} (not on this path)")
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


# ---------------------------------------------------------------------------
# slice 2: the history score-memory scheme, sharded selection, K6
# ---------------------------------------------------------------------------
def warm_fill(store, seed=0):
    """The history slice's warm store: seeded log-normal scores for
    ``WARM_FRAC`` of the ids, written through ``ScoreStore.update`` — a
    stand-in for an epoch of warm-up (or a restored checkpoint, not ported
    yet); the other ids stay unseen, so K6's fill path runs too."""
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(rng.random(store.n) < WARM_FRAC)
    store.update(ids, rng.lognormal(0.0, 1.0, ids.size).astype(np.float32))


def _warm_store():
    from repro_torch.sampler.store import ScoreStore
    store = ScoreStore(N_STORE)
    warm_fill(store)
    return store


def _k6_case(sc, seen, n_global, temp, h, H, k, gen_seed):
    """One shard on the card: the kernel's and the plain version's bottom-k
    (keys, slots), and every slot's key by both."""
    from repro_torch.kernels.topk_keys.ops import race_keys, topk_race_keys
    from repro_torch.kernels.topk_keys.ref import race_keys_ref
    from repro_torch.sampler import selection
    dist = selection.GlobalDist(selection.shard_stats(sc, seen > 0, temp),
                                n_global, 0.1, temp)
    args = (torch.from_numpy(sc).cuda(),
            torch.from_numpy(seen.astype(np.float32)).cuda(),
            selection.hash_context(gen_seed, 9173, 7), dist.fill_pow,
            dist.total)
    kw = dict(host_id=h, n_hosts=H, n_global=dist.n, smoothing=0.1,
              inv_temp=dist.inv_t)
    gk, gs = topk_race_keys(*args, k=k, **kw)
    pk, ps = topk_race_keys(*args, k=k, interpret=True, **kw)
    allk, allp = race_keys(*args, **kw), race_keys_ref(*args, **kw)
    torch.cuda.synchronize()
    return gk, gs, pk, ps, allk, allp


def check_k6(store):
    """Phase 8. Returns (worst abs key error, worst rel key error)."""
    rng = np.random.default_rng(1)
    cases = [("slice: warm store n=2^24, 1 host, T=1", store.scores,
              store.seen.astype(np.float32), N_STORE, 1.0, 0, 1, BATCH + 1)]
    n = 5_000_011
    sc = rng.lognormal(0.0, 1.0, n).astype(np.float32)
    seen = (rng.random(n) < 0.7).astype(np.float32)
    seen[-7:] = -1.0
    cases.append(("ragged n=5000011, host 1 of 3, T=0.5, unseen + 7 padded",
                  sc, seen, 3 * n, 0.5, 1, 3, 17))
    # the CPU test's cases (tests/test_torch_topk_keys.py)
    for n, h, H, temp, pad in ((1, 0, 1, 1.0, 0), (7, 0, 1, 0.5, 0),
                               (7, 1, 3, 1.0, 2), (1000, 1, 3, 0.5, 0),
                               (1000, 0, 1, 1.0, 24), (4099, 1, 3, 0.5, 3),
                               (4099, 0, 1, 1.0, 0)):
        r = np.random.default_rng(n + pad)
        sc = r.lognormal(0.0, 1.0, n).astype(np.float32)
        seen = (r.random(n) < 0.7).astype(np.float32)
        if pad:
            seen[n - pad:] = -1.0
        cases.append((f"n={n}, host {h} of {H}, T={temp}, {pad} padded", sc,
                      seen, n * H, temp, h, H, min(16, n - pad)))
    worst_abs = worst_rel = 0.0
    for i, (name, sc, seen, n_global, temp, h, H, k) in enumerate(cases):
        gk, gs, pk, ps, allk, allp = _k6_case(sc, seen, n_global, temp, h, H,
                                              k, i)
        live = torch.isfinite(allp)
        assert torch.equal(torch.isfinite(allk), live), "padded lanes differ"
        torch.testing.assert_close(allk[live], allp[live], rtol=K6_RTOL,
                                   atol=0)
        assert torch.equal(gs, ps), f"{name}: bottom-k slots differ"
        torch.testing.assert_close(gk, pk, rtol=K6_RTOL, atol=0)
        err = (allk[live] - allp[live]).abs()
        # a key of 0 (u rounded to 1) has no relative error to speak of
        tiny = torch.finfo(torch.float32).tiny
        rel = float((err / allp[live].abs().clamp(min=tiny)).max()) \
            if live.any() else 0.0
        ab = float(err.max()) if live.any() else 0.0
        worst_abs, worst_rel = max(worst_abs, ab), max(worst_rel, rel)
        log(f"[k6] {name}: max |kernel - plain| = {ab:.3e} (relative "
            f"{rel:.3e}, rtol {K6_RTOL}); bottom-{k} slots equal")
        del gk, gs, pk, ps, allk, allp
    torch.cuda.empty_cache()
    return worst_abs, worst_rel


def check_sharded(store, draws=3):
    """Phase 9: the sharded draw on the warm 2^24 store, at the slice's k.

    Held: K6 on the card against K6's plain version (the same float32
    formulation, on the CPU) — equal gids, weights to 1e-5 relative.
    Measured beside it: the float64 numpy loop on the same draws. The
    float32 uniform u = (h>>8)·2^-24 + 2^-25 rounds near u → 1 to steps of
    2^-24, so E = −log u, whose smallest values decide a bottom-5 race over
    2^24 slots (E ~ 1e-7), is quantized by up to half its size: the two
    formulations can pick other winners, and their thresholds differ.
    Returns the loop comparison."""
    from repro_torch.sampler import selection
    dist = selection.GlobalDist(selection.shard_stats(store.scores,
                                                      store.seen, 1.0),
                                store.n, 0.1, 1.0)
    same_sets, worst_w = 0, 0.0
    for step in range(draws):
        kw = dict(seed=0, salt=9173, step=step, use_kernel=True)
        t0 = time.perf_counter()
        gk = selection.sample_sharded(store, dist, BATCH, device="cuda", **kw)
        t1 = time.perf_counter()
        gp = selection.sample_sharded(store, dist, BATCH, device="cpu", **kw)
        t2 = time.perf_counter()
        gn = selection.sample_sharded(store, dist, BATCH, device="cuda",
                                      **dict(kw, use_kernel=False))
        t3 = time.perf_counter()
        assert np.array_equal(gk[0], gp[0]), (gk[0], gp[0])
        np.testing.assert_allclose(gk[2], gp[2], rtol=1e-5, atol=0)
        same = set(gk[0].tolist()) == set(gn[0].tolist())
        w_dev = float(np.max(np.abs(gk[2] / gn[2] - 1))) if same else None
        same_sets += same
        worst_w = max(worst_w, w_dev or 0.0)
        log(f"[sharded] draw {step}: K6 gids {gk[0].tolist()} = plain "
            f"version's, weights within 1e-5 (threshold {gk[3]:.6g}); "
            f"float64 loop gids {gn[0].tolist()} (same set: {same}; weights "
            f"off by {w_dev}; threshold {gn[3]:.6g}); K6 draw "
            f"{t1 - t0:.3f} s, plain on the CPU {t2 - t1:.3f} s, numpy loop "
            f"{t3 - t2:.3f} s")
    log(f"[sharded] K6 and the float64 loop chose the same set in "
        f"{same_sets} of {draws} draws; worst weight deviation where they "
        f"did: {worst_w:.3e}")
    return {"draws": draws, "same_sets": same_sets, "worst_w_dev": worst_w}


def check_history_lm_tiny():
    """Phase 10: ``history`` at lm-tiny on the card (plans through K6)
    against the same run on the CPU (the numpy loop), from the same params
    and the same warm 32-example store: plans and losses to 1e-3."""
    from repro_torch.api import Experiment, Hook, build_run
    from repro_torch.checkpoint import interop
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.topk_keys import topk_keys as k6

    def warm(store):
        store.update([17, 21, 26, 30], [0.6, 8.0, 2.5, 1.1])

    class Plans(Hook):
        def __init__(self):
            self.plans = []

        def on_loop_start(self, loop, start, steps):
            warm(loop.exp.sampler.store)

        def on_step_start(self, loop, step, batch, meta):
            self.plans.append((meta.gids.copy(), meta.weights.copy()))

    for impl in ("sharded", "gather"):
        run = build_run("lm-tiny", preset="prod", overrides={
            "sampler.scheme": "history", "imp.selection_impl": impl,
            "sampler.min_coverage": 0.2, "sampler.tau_th": 1.001,
            "sampler.gate_every": 1, "shape.seq_len": 16,
            "shape.global_batch": 4, "steps": 6, "obs.enabled": False})
        src = lambda: SyntheticLM(run.model.vocab_size, 16, n_examples=32,
                                  seed=run.seed)
        gpu = Experiment(run, source=src())
        cpu = Experiment(run, source=src(), device="cpu")
        interop.load_params(cpu.lm, interop.params_to_numpy(gpu.lm))
        hg, hc = Plans(), Plans()
        before = k6.launches
        _, mg = gpu.fit(hooks=[hg])
        launched = k6.launches - before
        _, mc = cpu.fit(hooks=[hc])
        for (g, w), (gc_, wc) in zip(hg.plans, hc.plans):
            assert np.array_equal(g, gc_), (g, gc_)
            np.testing.assert_allclose(w, wc, rtol=1e-3)
        for a, b in zip(mg, mc):
            assert math.isfinite(a["loss"])
            assert abs(a["loss"] - b["loss"]) < 1e-3, (a["loss"], b["loss"])
            assert a["sampler_active"] == b["sampler_active"]
        active = [int(h["sampler_active"]) for h in mg]
        assert any(active), "the gate never opened"
        # K6 runs once for each plan the open gate draws (sharded only)
        assert launched == (sum(active) if impl == "sharded" else 0), \
            (launched, active)
        log(f"[history lm-tiny] {impl}: gpu losses "
            f"{[round(h['loss'], 5) for h in mg]} = cpu "
            f"{[round(h['loss'], 5) for h in mc]} (to 1e-3); plans equal; "
            f"gate {active}; K6 launches {launched}")


HISTORY_CUTS = (
    "cuts from prod: seq_len 4096 -> 1024; global_batch 256 -> "
    f"{BATCH}; steps 1000 -> {STEPS}; sampler fused presample -> history "
    "with sharded selection (the slice's point); store warm-up earned over "
    f"an epoch -> a seeded fill of {WARM_FRAC:.0%} of the 2^24 ids at loop "
    "start; telemetry on -> off; checkpointing on -> none; data plane "
    "pipelined -> synchronous. Width, depth (28 layers) and vocab are not "
    "cut.")


def run_history_slice():
    """Phase 11: the history slice at llama3.2-3b full width."""
    import repro_torch
    from repro_torch.api import Hook
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.ce_score import ce_score as k4
    from repro_torch.kernels.topk_keys import topk_keys as k6
    from repro_torch.configs import get_config
    overrides = {"sampler.scheme": "history", "imp.selection_impl": "sharded",
                 "shape.global_batch": BATCH, "shape.seq_len": 1024,
                 "steps": STEPS, "obs.enabled": False}
    log(f"[history] llama3.2-3b, preset prod, overrides {overrides}, source "
        f"SyntheticLM(vocab, 1024, n_examples=2**24, seed=0)")
    log(f"[history] {HISTORY_CUTS}")

    class StepLog(Hook):
        def __init__(self):
            self.rows = []

        def on_loop_start(self, loop, start, steps):
            t0 = time.perf_counter()
            warm_fill(loop.exp.sampler.store)
            log(f"[history] store warmed: coverage "
                f"{loop.exp.sampler.store.coverage():.4f} in "
                f"{time.perf_counter() - t0:.1f} s")

        def on_step_start(self, loop, step, b, meta):
            self.plan = dict(loop.exp.sampler.last_plan)
            self.w = meta.weights.copy()
            self.is_flag = float(meta.is_flag)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()

        def on_step_end(self, loop, step, m):
            torch.cuda.synchronize()
            row = dict(step=step, loss=m["loss"], store_tau=m["store_tau"],
                       sampler_active=m["sampler_active"],
                       is_flag=self.is_flag, w_min=float(self.w.min()),
                       w_max=float(self.w.max()),
                       plan_ms={k: round(v, 4) for k, v in self.plan.items()},
                       step_s=time.perf_counter() - self.t0,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            self.rows.append(row)
            log("[history] " + json.dumps(row))

    hook = StepLog()
    source = SyntheticLM(get_config("llama3.2-3b").vocab_size, 1024,
                         n_examples=N_STORE, seed=0)
    k4.launches = k6.launches = 0
    t0 = time.perf_counter()
    _, history = repro_torch.train("llama3.2-3b", preset="prod",
                                   overrides=overrides, source=source,
                                   hooks=[hook])
    torch.cuda.synchronize()
    launches = k6.launches
    total = time.perf_counter() - t0
    log(f"[history] {STEPS} steps in {total:.1f} s (model build and store "
        f"warm-up included); K6 launches {launches} ({launches / STEPS:g} "
        f"per step), K4 {k4.launches} (not on this path)")
    assert len(history) == STEPS
    assert all(math.isfinite(h["loss"]) for h in history), history
    assert launches == STEPS, "K6 was not launched once per step"
    for r in hook.rows:
        assert r["sampler_active"] == 1.0 and r["is_flag"] > 1.0, r
        assert not (r["w_min"] == r["w_max"] == 1.0), r
    gc.collect()
    torch.cuda.empty_cache()
    return launches, hook.rows


def time_k6(store):
    """Phase 12: K6 at n = 2^24 on the warm store, the bottom-k beside it,
    and the host-to-card transfer each plan pays."""
    from repro_torch.kernels.topk_keys.ops import _bottom_k, race_keys
    from repro_torch.kernels.topk_keys.ref import race_keys_ref
    from repro_torch.sampler import selection
    dist = selection.GlobalDist(selection.shard_stats(store.scores,
                                                      store.seen, 1.0),
                                store.n, 0.1, 1.0)
    seen_f = store.seen.astype(np.float32)
    h2d_ms = _time(lambda: (torch.from_numpy(store.scores).cuda(),
                            torch.from_numpy(seen_f).cuda()), 5)
    args = (torch.from_numpy(store.scores).cuda(),
            torch.from_numpy(seen_f).cuda(),
            selection.hash_context(0, 9173, 0), dist.fill_pow, dist.total)
    ms = _time(lambda: race_keys(*args), 50)
    plain_ms = _time(lambda: race_keys_ref(*args), 5)
    keys = race_keys(*args)
    topk_ms = _time(lambda: _bottom_k(keys, BATCH + 1), 20)
    # the least the card could take: every seen flag read and every key
    # written once, a score read only where the slot is seen (an unseen
    # slot takes the fill); ~32 ops a slot (two fmix32 rounds, the
    # uniform, three transcendentals, the mixture) outside the tensor cores
    n_seen = int(np.count_nonzero(store.seen))
    n_bytes = store.n * (4 + 4) + n_seen * 4
    n_ops = 32 * store.n
    bound_s = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S)
    by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_FLOPS_PER_S \
        else "operations"
    log(f"[timing] K6 n={store.n}: {ms:.4f} ms/launch, plain "
        f"{plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms ({by}: "
        f"{n_bytes / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s), {n_bytes / (ms * 1e-3) / 1e12:.3f} "
        f"TB/s achieved; bottom-{BATCH + 1} (torch.topk over int64 "
        f"composites) {topk_ms:.4f} ms; host-to-card transfer of scores and "
        f"seen ({8 * store.n / 1e6:.1f} MB, pageable) {h2d_ms:.4f} ms")
    del args, keys
    torch.cuda.empty_cache()
    return ms, plain_ms, bound_s * 1e3, by, topk_ms, h2d_ms


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; torch finds none")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ce_score import ce_score as k4
    from repro_torch.kernels.topk_keys import topk_keys as k6
    kernels = [dict(name="ce_score_block", route="cuda",
                    source="src/repro_torch/kernels/ce_score/csrc/"
                           "ce_score_block.cu",
                    replaces="src/repro/kernels/ce_score/ce_score.py:144",
                    sources=k4.SOURCES, held_by="phase 3 (K4) and 4 (prune)"),
               dict(name="race_keys", route="cuda",
                    source="src/repro_torch/kernels/topk_keys/csrc/"
                           "race_keys.cu",
                    replaces="src/repro/kernels/topk_keys/topk_keys.py:71",
                    sources=k6.SOURCES,
                    held_by="phase 8 (K6) and 9 (sharded)")]

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
    store = _warm_store()
    k6_abs, k6_rel = check_k6(store)
    vs_loop = check_sharded(store)
    check_history_lm_tiny()
    k6_launches, hrows = run_history_slice()
    k6_t = time_k6(store)

    line = {"kernels": [
        {"name": "ce_score_block", "route": "cuda",
         "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
         "launches": launches, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
         "library_ms": None, "held_by": kernels[0]["held_by"]},
        {"name": "race_keys", "route": "cuda",
         "source": kernels[1]["source"], "replaces": kernels[1]["replaces"],
         "launches": k6_launches, "max_abs_err": k6_abs,
         "max_rel_err": k6_rel, "ms": k6_t[0], "plain_ms": k6_t[1],
         "bound_ms": k6_t[2], "bound_by": k6_t[3], "library_ms": None,
         "topk_ms": k6_t[4], "h2d_ms": k6_t[5],
         "held_by": kernels[1]["held_by"]}]}
    ok = {"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "steps": rows, "profile": breakdown,
         "history_steps": hrows, "sharded_vs_f64_loop": vs_loop, **line,
         **ok}, indent=1))
    print(smi)
    print(json.dumps(line))
    print(json.dumps(ok), flush=True)


if __name__ == "__main__":
    main()
