#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA GPU and hold every kernel
of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the process exits non-zero:

1. card     — the GPU's name and power limit (``nvidia-smi``), CUDA version;
2. build    — compile every kernel from the sources in this checkout, one
              ``nvcc`` per library, all started together, each under the
              name its wrapper loads it by (the wrapper module's ``LIB*``),
              registers and spills logged; the wgmma K5's ptxas report
              shows no spills and its SASS holds HGMMA, UTMALDG and UTMASTG
              (``cuobjdump -sass``); the f32 K5's report shows no spills
              (``check_f32_build``). At the end the script checks that
              every library the run loaded is one phase 2 built;
3. K4       — ``ce_score_block`` against its plain version on the card:
              the slice's (12, 128, 128256) bf16 chunk view, a ragged
              shape, row blocks of 8 with dead blocks and label −1, f32;
4. prune    — ``pruned_pool_score`` on the card: survivors bitwise equal
              to the unpruned chunked pass; alive mask and receipt equal
              to the plain version's run on the same tensors;
5. lm-tiny  — the prod slice at lm-tiny on the card against the same run
              on the CPU (same params, same plans, losses to 1e-3);
5b. plane lm-tiny — the data plane at lm-tiny over a seeded ``MemmapLM``
              corpus written under ``build/``: the ``presample`` kind at
              depth 2 with device-put, faults ``gather@2`` (surfaced, then
              re-popped) and ``slow@5..7`` (the real straggler monitor
              retries step 7 from a state copy on the card), on the card
              and on the CPU from the same params: plans equal, losses to
              1e-3, attempts, copies, restores and fired faults as set;
5c. plane gpu tests — the ``gpu`` cases of
              ``tests/test_torch_pipeline_gpu.py`` in a child process: every
              uploaded batch bitwise its host arrays under a busy and an
              idle compute stream;
6. slice    — ``repro_torch.train("llama3.2-3b", preset="prod", ...)``:
              full width and depth, the cuts printed, ``STEPS`` steps,
              ``prod``'s data plane (depth 2, device-put on its own
              stream); the kernels' launch counts are zeroed just before
              and read just after (K4: 8 a step; K5: 28 a step, all the
              wgmma kernel's). Every step is timed, with the plane's stage
              seconds since the last step (``plane.next_wait``, ``.gather``,
              ``.device_put``, ``.credit_stalls``; the registry turned on,
              no sink); step ``PROFILED`` runs under ``torch.profiler``:
              where a steady step's device time goes, by kernel group and
              by name, the device's idle share against step 1's unprofiled
              wall time (the full table goes to
              ``chiprun_out/profile_step.txt``), and the pool's
              host-to-card copies by CUDA stream, which must not be the
              stream K5 runs on;
6b. cell A resume — phase 6's run with ``prod``'s checkpoints and
              telemetry (``obs.enabled``, JSONL under
              ``chiprun_out/obs/``; ``ckpt_dir`` under ``build/``,
              ``ckpt_every`` 2, ``keep_ckpts`` 1): it first reads the
              free disk under ``build/`` and ``MemAvailable`` and fails,
              with both numbers, unless the disk holds the state once
              (plus 2 %) and the memory twice (the state is 45 GB: bf16
              params, f32 master, m and v; the card's machine has 80 GB
              of disk, not the two states ``keep_ckpts`` 1 holds while it
              writes the next); then steps 0-1 save ``step_2``;
              ``Experiment.from_checkpoint`` resumes at 2 and trains 2-3
              (``step_2`` removed once the resume has read it; ``step_4``
              saved);
              every step's rows equal phase 6's, losses to 1e-3 relative
              (and whether bitwise); counts zeroed just before the resumed
              fit and read just after (K4 8 and the wgmma K5 28 a step, no
              mma); a third ``fit`` resumes at the final step and trains,
              launches and writes nothing (``step_4``'s files keep their
              size, mtime, inode and manifest); the JSONL holds the
              ``health.*`` gauges, ``loop.step_s`` and ``loop.h2d_bytes``,
              finite; the checkpoint's bytes, each save's split (snapshot
              to host, write, commit) and the restores' wall times beside
              the card; the directory removed;
6c. cell A depth 1 — phase 6's run with ``data.prefetch_depth`` 1: every
              step's plan equals phase 6's, losses to 1e-3 relative (and
              whether bitwise); per step the plane's stage seconds, wall
              time and (profiled step) idle share beside phase 6's and
              the parent's synchronous plane's; then phase 6's run with a
              scripted monitor voting one retry of step 1: plans and
              losses phase 6's, K4 and K5 counts unchanged, the state
              copy's place and seconds and the restore's seconds printed;
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
              version, the bottom-k, the transfer and its bound;
13. K5       — ``flash_attention`` against its plain version on the card:
              cell C's prefill (8 × 4096 over a 4160-slot cache, 24/8
              heads of 128, bf16; the plain version run two batch rows at a
              time) and decode (one query at 4096…4159 over the cache's
              prefix), a ragged shape, a sliding window, f32, and the
              prefill and a decode with q scaled ×6 (a peaked softmax,
              outputs of order 1); the oracle runs in f32 on the same
              inputs; each case within ``K5_TOL`` of every output and
              within ``K5_ROW_REL`` of each query row's largest |output|.
              Each case names its kernel and that kernel's count must move:
              the wgmma kernel for bf16 hd-128 prefill shapes (cell C's,
              also over the cache's prefix view, cells A/E's (12, 1024),
              cell D's (8, 1024), ragged, a ragged q_offset over a cache,
              windows, one at softmax scale 0.2), the f32 kernel for f32
              prefills (cell I's pool (12, 1024, 10/5, 64), also peaked;
              an lm-tiny (2, 64, 4/2, 16); a ragged (2, 77) at g = 3; hd
              128; a window with q_offset over a longer cache view at scale
              0.2; hd 32 at scale 0.3), the mma.sync one for decode (bf16
              and f32) and a bf16 hd-64 prefill; each case's output is
              finite and a second launch gives the same bits;
14. K1       — ``ce_score`` against its plain version on the card: cell
              D's (8·1024, 128256) logits in bf16 and f32, a ragged T over
              a strided view, labels at 0 and V − 1, extreme logits;
15. serve lm-tiny — ``serve_step`` on the card (K5) against the CPU (plain)
              from the same params, prefill and teacher-forced decode
              logits to 1e-3, and ``repro_torch.serve``'s greedy tokens
              equal on both; K5's launches: the prefill's on the f32
              kernel, the decodes' on mma.sync;
16. cell C   — ``repro_torch.serve("llama3.2-3b", batch=8, prompt_len=4096,
              gen=64)`` at full width and depth (cuts printed); counts
              zeroed just before and read just after (K5: 28 a step, 1792:
              the wgmma kernel's 28 in the prefill, the mma.sync kernel's
              1764 in decode; K1 0); prefill and decode times, peak
              memory; then prefill and 4 decode steps again on the same
              tokens through K5 and through the plain route: (a) K5 beside
              the plain attention of each of the 140 calls (28 layers ×
              prefill and 4 steps) on that call's own inputs, within
              ``K5_TOL`` and ``K5_ROW_REL``; (b) the worst and the mean
              |K5-route − plain-route| f32 logit (before the lm head's
              rounding) at most twice the plain route's own with
              ``online_attention``'s chunks at (1024, 512), and the worst
              bf16 logit error under 0.05 of the logits' scale; (c) greedy
              tokens equal in every row where the plain route's top two
              bf16 logits differ by more than one ulp of the top one, and
              where they do not (a tie row) the plain route's logit of the
              K5 route's token within the larger of one ulp and the plain
              route's own worst bf16 logit drift under re-chunking of the
              top one (tie rows, the K5 route's flips and the re-chunked
              plain route's logged); (d) the K5
              route reproduces serve's tokens; the prefill and 4 decode steps under
              ``torch.profiler`` (device busy time, idle share, device ops
              and host-to-card copies a step; tables to
              ``chiprun_out/profile_serve_*.txt``);
17. cell D   — ``repro_torch.score("llama3.2-3b", preset="prod", ...)``
              under ``imp.score_impl="pallas"`` (K1 once, K5 28 times, all
              the wgmma kernel's),
              held against the same call under ``"fused"``;
18. K5/K1 timing — K5 per launch at cell C's prefill, cell D's score
              (8, 1024) and cells A/E's pool (12, 1024) (the wgmma kernel,
              TFLOP/s, and the mma.sync kernel on the same values) and cell
              C's decode (mma.sync), and the f32 kernel at cell I's pool
              scoring (12, 1024, 10/5 heads of 64, causal; by CUDA events,
              TFLOP/s and the share of its bound, operations at the f32
              rate; the mma.sync path's plain FMA on an off-16-byte copy of
              q and SDPA's f32 backends in turns), K1 at cell D's, each
              beside its plain
              version, its bound and (K5) ``scaled_dot_product_attention``
              on the same inputs as a yardstick that the port never calls,
              also under each of its fused backends that runs (flash,
              cuDNN, efficient), in turns over three rounds. CUDA events
              time the prefill shapes and K1; the decode shape is timed by
              its device time (``_device_ms``: CUDA events around calls
              queued behind a spin kernel), since a launch there is shorter
              than its dispatch.

19. pool_select — the one launch that computes K2 and K3 and the
              selection they feed (``pool_select_cuda``), at cell E's pool
              (12, 1024), ``prod``'s pool (768, 4096), a ragged (37, 13) and
              70 000 rows (keys and winners beyond shared memory), a 20 %
              mask, k = 1, B/4, B−1, B, ctx 0 and 2³²−1: scores against
              ``row_score_math`` to ``K2_RTOL``; keys bitwise
              ``pool_keys_plain`` fed the kernel's own scores and 1/Σs; idx
              and thr ``_bottom_k`` of its own keys; 1/Σs, probs and weights
              to 1e-6; two launches the same bits. The scores given
              (``select_pool``'s launch) at B = 12, 100, 768, 1024 with a −1
              pad lane: the same stage checks, ``select_pool`` equal to
              ``select_pool_ref``; 70 pads of 100 rows with k + 1 above the
              live rows: the +inf ties won by the lowest pad rows.
              ``fused_presample`` and ``select_pool`` on seeded bf16 logits
              at (12, 1024, 128256) against ``fused_presample_ref``: indices
              and gathered rows equal, weights and scores to 1e-5;
20. presample lm-tiny — the ``presample`` step kind at lm-tiny on the card
              against the same run on the CPU, ``gate="never"`` and
              ``"always"`` (both runs handed one seeded numpy draw, a check
              only): losses and stored scores to 1e-3;
21. cell E   — ``repro_torch.train("llama3.2-3b", preset="prod", overrides=
              {"imp.presample_impl": "step", ...}, gate="always")``: full
              width and depth, pool 12, the cuts printed; counts zeroed just
              before and read just after (K5: 28 a step, the wgmma
              kernel's; K1, pool_select, K4: 0);
              per step the loss, τ, weights, wall time, the plane's stage
              seconds, peak memory (step ``PROFILED`` under
              ``torch.profiler``, its host-to-card copies by stream); then one
              ``fused_presample`` on a fresh pool's logits from the final
              params (K1 once, then ``pool_select`` once): scores against
              ``sample_stats``
              (the step's scoring route) to 1e-4, the candidate set equal to
              the host's float64 race, the gathered rows the pool's; and,
              measured without a gate, the same pool scored through the
              plain attention: the scores' worst relative error against the
              K5 route's and whether the race fed the same uniforms draws
              the same candidates;
22. pool_select timing — the launch at cell E's pool (k 4) and prod's
              (768, 4096, k 256) (inputs rotated through copies that exceed
              the L2 cache), ``select_pool`` at cell E's pool (device time,
              ``_device_ms``: a launch is shorter than its dispatch; CUDA
              events around an unqueued loop of calls beside), the one-launch
              floor (a one-element ``zero_()``, the same way),
              ``fused_presample`` and its K1 stage at cell E's pool (CUDA
              events), each beside its plain version (CUDA events: a plain
              selection waits for the card) and its bound.

23. K5 hd 256 — K5 at gemma3's head dim (16/8 heads of 256), each case
              against the f32 plain version within the unchanged
              ``K5_TOL``/``K5_ROW_REL``, the dispatch rule's kernel count
              moving, a second launch the same bits. On the wgmma kernel
              (``flash_attn_fwd_wgmma256.cu``): the prefill (8, 1024) with
              window 1024 and global, peaked, over a 1088-slot cache's
              prefix view; (2, 4096) with window 1024 (the window cuts); a
              ragged (2, 77) at offset 100 over a 300-slot cache; (12, 200)
              over a cache, window 64, scale 0.2. On the decode kernel
              (``flash_attn_decode.cu``): decode at 700 over a 1024-slot
              ring before the wrap; over a full 1024-slot ring, not
              causal, and peaked; at 1023 with window 100 (the window cuts)
              and scale 0.2; over the 1088-slot global cache's 1087-key
              prefix. On the mma.sync kernel (Q staged in shared memory,
              32-key tiles): the prefill with q off TMA's alignment. One
              hd-128 case with window 256 < sq (wgmma). The three hd-256
              kernels' registers and spills are logged, and the wgmma and
              decode ones must have no spills; the decode kernel's
              resident blocks an SM (occupancy calculator) must be the 2
              its split rule counts, and 64 of its 2-block clusters must
              fit the card at once;
23b. K5 hd 256 timing — gemma3's prefill (8, 1024) and (2, 4096) with
              the window of 1024 on both kernels (the mma kernel on an
              off-TMA copy of q), by CUDA events (the rows' ms) and by
              device time (``_device_ms``), with TFLOP/s and the share of
              the bound, and decode over a full ring on the decode kernel
              (device time: the same inputs, 4 rings in rotation so that
              nothing stays in L2, the 1088-slot global cache's 1087-key
              prefix; the mma kernel on the same values; the dispatch by
              an event loop and by the host clock), each beside its
              plain version, its bound and ``scaled_dot_product_attention``
              under each backend that takes hd 256;
24. gemma3 reduced — ``reduced(gemma3-12b, repeats=2)`` (window 64, f32) on
              the card against the CPU from the same params: forward-only
              logits (K5 with the window), ``prod``'s steps over sequences
              longer than the window (plans equal, losses to 1e-3), serve
              of prompts of 40 (decode across the rings' wrap, every
              attention call through K5), 100 (longer than the rings and no
              multiple of them: the rings take the plain paths in prefill
              and decode, the global layers K5) and 128 (twice the rings:
              their prefill plain, their decode through K5 over the whole
              wrapped ring): tokens equal, logits to 1e-3, K5's launches as
              stated, exactly split: the forward's and the prefills' on the
              f32 kernel, the decodes' on mma.sync;
25. gemma3 serve — ``repro_torch.serve("gemma3-12b", batch=8,
              prompt_len=1024, gen=64)`` at full width and depth (48 layers,
              cuts printed); counts zeroed just before and read just after
              (K5: 48 in the prefill, all the wgmma kernel's, and 48 in
              each of the 63 decode steps, all the decode kernel's, rings
              wrapped from the first decode step; K1 0); prefill and
              decode times, tokens/s, peak; then phase 16's token check
              (K5 beside each plain call, the f32
              logit drift against the re-chunked plain route's, greedy
              tokens equal where the plain route's top-two margin exceeds
              one bf16 ulp and within the re-chunking ruler at tie rows,
              serve's tokens reproduced; tie rows recorded with their
              top-three margins and each route's flips); the prefill and 4
              decode steps under ``torch.profiler`` as phase 16's (tables
              to ``chiprun_out/profile_gemma_serve_*.txt``);
26. gemma3 score — ``repro_torch.score("gemma3-12b", preset="prod", ...)``
              at (8, 1024) under ``"pallas"`` (K1 once at V 262144, K5 48
              times, wgmma) against ``"fused"``, as phase 17;
27. gemma3 train — ``repro_torch.train`` of gemma3-12b under ``prod`` at
              full width, depth cut to one repeat of its pattern (6 layers,
              2.35 B parameters, the cut printed): 4 steps, K4 8 and K5 6
              (wgmma, the pool's scoring) a step, step walls and peaks,
              step ``PROFILED`` under ``torch.profiler``;
28. dense configs — lm-100m trained under ``prod`` at full size with the
              pool scored in f32 (K4 on f32 logits, K5's f32 kernel: 8 and
              12 a step; every step's wall time, steps 1-3 without the
              first step's warm-up); internlm2-20b scored at full width
              and depth and yi-34b at full width and the depth that
              counting says leaves 6 GB of the card free (the cut
              printed), each as phase 17 (K1 once, K5 once a layer,
              wgmma: group sizes 6 and 7).

Every phase's seconds are printed (``[phase]``). Phase 6 also counts K5,
which runs cell A's forward-only pool scoring (28 launches a step).

The second-to-last lines are the card line and the ``{"kernels": ...}``
line; the last line is ``{"ok": true, "device": {...}}``. Also written to
``chiprun_out/chip_smoke.json``. It needs a CUDA GPU and the repository
around it: it never falls back to the CPU or to a plain version.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
BF16_FLOPS_PER_S = 989e12       # H100 SXM, dense bf16 on the tensor cores
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
K5_TOL = {torch.float32: 2e-4,    # rtol = atol, tests/test_kernels.py's
          torch.bfloat16: 3e-2}   # bounds (bf16: P rounded for the PV mma)
# K5 per query row: worst |kernel - f32 oracle| over the row's largest
# |output|. The absolute bounds above are about one typical output late in
# a long causal row (rms about sqrt(e / n)), so they alone would pass a
# kernel wrong in late kv tiles or in the decode's split partials. bf16:
# the output's rounding is at most 2^-8 of an element, plus P's rounding;
# f32: summation order and the exponent's rounding. Each is 2.4 (bf16) and
# 5.7 (f32) times the worst over this phase's cases on an H100 80GB HBM3 at
# 700 W before the f32 kernel; its cases reach 3.4e-6 (2.9 times under).
K5_ROW_REL = {torch.float32: 1e-5, torch.bfloat16: 1.5e-2}
Q_PEAK = 6.0       # q scale of the peaked cases: a few keys carry a row
K1_TOL = dict(rtol=1e-4, atol=1e-4)  # per-token f32 stats: __expf and the
                                     # summation order
SERVE = dict(batch=8, prompt_len=4096, gen=64)  # cell C; cap 4160
N_LAYERS = 28      # llama3.2-3b
K2_RTOL = 1e-5     # K2 vs plain: f32 row sums in another order
POOL = (3 * BATCH, 1024, 128256)   # cell E's pool: B, T, V


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
    """One nvcc per library, all started together: the libraries of every
    kernel, under the names their wrappers load them by (each wrapper
    module's ``LIB*`` beside its ``SOURCES*``), so no launch builds again."""
    from repro_torch.kernels import build
    builds = [b for k in kernels for b in k["builds"]]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda nb: build.build(*nb), builds))
    dt = time.perf_counter() - t0
    for (name, _), so in zip(builds, libs):
        log(f"[build] {name}: {so.relative_to(ROOT)}")
        report = (build.BUILD_DIR / f"{name}.log").read_text()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] dir {build.BUILD_DIR.relative_to(ROOT)}, {dt:.1f} s")
    return dict(zip((n for n, _ in builds), libs))


def check_built_once(libs):
    """Every library a wrapper loaded during the run is the one phase 2
    built under that name: no launch compiled a library again."""
    from repro_torch.kernels import build
    loaded = {n: Path(lib._name) for n, lib in build._loaded.items()}
    assert all(libs.get(n) == path for n, path in loaded.items()), \
        (loaded, libs)
    log(f"[build] the run loaded {sorted(loaded)}, each the library phase 2 "
        f"built; {sorted(set(libs) - set(loaded))} built and not loaded")
    return sorted(loaded)


def check_wgmma_build(libs):
    """The wgmma K5 library: no spills in ptxas's report, and its SASS
    holds wgmma (HGMMA) and TMA loads (UTMALDG) and stores (UTMASTG)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import flash_attn as k5
    so = libs[k5.LIB_WGMMA]
    report = (build.BUILD_DIR / f"{k5.LIB_WGMMA}.log").read_text()
    spills = [ln.strip() for ln in report.splitlines() if "spill" in ln]
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
    assert spills and all(" 0 bytes spill stores, 0 bytes spill loads" in ln
                          for ln in spills), spills
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    assert all(counts.values()), counts
    log(f"[build] {k5.LIB_WGMMA} SASS: {counts}; {regs}; {spills}")
    return dict(sass=counts, ptxas=regs + spills)


def check_f32_build():
    """The f32 K5 library: every instance of its kernel in ptxas's report,
    none spilling; returns {kernel: "registers; spills"}."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import flash_attn as k5
    report = _ptxas_by_kernel(
        (build.BUILD_DIR / f"{k5.LIB_F32}.log").read_text())
    found = {fn: r for fn, r in report.items() if "flash_fwd_f32" in fn}
    assert len(found) == len(k5.F32_HD), report
    assert all("0 bytes spill stores, 0 bytes spill loads" in r
               for r in found.values()), found
    log(f"[build] {k5.LIB_F32} ptxas: {found}")
    return found


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


CORPUS = ROOT / "build" / "memmap_lm_tiny.npy"    # listed in .gitignore
PLANE_FAULTS = "gather@2;slow@5:0:30;slow@6:0:30;slow@7:0:30"


def check_plane_lm_tiny():
    """Phase 5b: the data plane at lm-tiny over a ``MemmapLM`` corpus, on
    the card and on the CPU from the same params: the ``presample`` kind
    (gate never: no draws) at depth 2 with device-put, ``gather@2`` (the
    plane surfaces the error and the loop pops the re-gathered batch) and
    ``slow@5..7`` (the real straggler monitor floors its shrink, then
    votes one retry of step 7, restored from the state copy)."""
    from repro_torch import obs
    from repro_torch.api import Experiment, Hook, build_run
    from repro_torch.checkpoint import interop
    from repro_torch.data.pipeline import MemmapLM
    from repro_torch.runtime import faults
    steps, seq = 9, 64
    run = build_run("lm-tiny", preset="prod", overrides={
        "shape.seq_len": seq, "shape.global_batch": 4, "steps": steps,
        "imp.presample_impl": "step", "data.prefetch_depth": 2,
        "obs.enabled": True, "obs.sink": "none",
        "runtime.faults.enabled": True, "runtime.faults.spec": PLANE_FAULTS})
    CORPUS.parent.mkdir(exist_ok=True)
    rng = np.random.default_rng(5)
    np.save(CORPUS, rng.integers(0, run.model.vocab_size, 4096 * seq + 1,
                                 dtype=np.int32))

    class Rec(Hook):
        def __init__(self):
            self.gids, self.loop = [], None

        def on_loop_start(self, loop, start, n):
            self.loop = loop

        def on_step_start(self, loop, step, batch, meta):
            self.gids.append([int(g) for g in meta.gids])

    res = {}
    gpu = Experiment(run, source=MemmapLM(CORPUS, seq, seed=run.seed),
                     gate="never")
    cpu = Experiment(run, source=MemmapLM(CORPUS, seq, seed=run.seed),
                     device="cpu", gate="never")
    interop.load_params(cpu.lm, interop.params_to_numpy(gpu.lm))
    for tag, exp in (("gpu", gpu), ("cpu", cpu)):
        rec = Rec()
        # one fault schedule per process: re-arm it for each run
        faults.configure(run.runtime.faults)
        obs.reset()
        _, hist = exp.fit(hooks=[rec])
        snap = obs.snapshot()
        plane = rec.loop.plane
        res[tag] = dict(
            gids=rec.gids, losses=[h["loss"] for h in hist],
            attempts=[h["attempts"] for h in hist],
            copies=rec.loop.snapshot.taken,
            restores=rec.loop.snapshot.restored,
            where=rec.loop.snapshot.where,
            faults={k: snap.get(f"faults.{k}", 0) for k in ("gather",
                                                          "slow")},
            loop_retries=snap.get("loop.retries", 0),
            device_put_bytes=snap.get("plane.device_put_bytes", 0),
            plane_device=str(plane.device), copy_stream=(
                plane._copy_stream is not None))
    obs.enable(False)
    obs.reset()
    faults.configure(None)
    g, c = res["gpu"], res["cpu"]
    assert g["gids"] == c["gids"], (g["gids"], c["gids"])
    for a, b in zip(g["losses"], c["losses"]):
        assert math.isfinite(a) and abs(a - b) < 1e-3, (a, b)
    for r in (g, c):
        assert r["attempts"] == [1] * 7 + [2, 1], r["attempts"]
        assert (r["copies"], r["restores"]) == (2, 1), r
        assert r["faults"] == {"gather": 1, "slow": 3}, r["faults"]
        assert r["loop_retries"] == 2, r    # the re-pop and the retry
        assert r["device_put_bytes"] > 0
    assert g["where"] == "device" and g["copy_stream"], g
    assert c["where"] == "cpu" and not c["copy_stream"], c
    log(f"[plane lm-tiny] MemmapLM {CORPUS.name} ({4096} sequences of "
        f"{seq}), depth 2, faults {PLANE_FAULTS!r}: plans card = cpu, "
        f"losses to 1e-3 (card {[round(x, 5) for x in g['losses']]}, "
        f"bitwise {g['losses'] == c['losses']}); attempts {g['attempts']}; "
        f"state copies {g['copies']} ({g['where']}), restores "
        f"{g['restores']}; faults fired {g['faults']}; loop.retries "
        f"{g['loop_retries']}; uploads on the plane's stream "
        f"{g['copy_stream']}")
    CORPUS.unlink()
    return res


def run_plane_gpu_tests():
    """Phase 5c: the ``gpu`` cases of ``tests/test_torch_pipeline_gpu.py``
    (every uploaded batch bitwise its host arrays under a busy and an idle
    compute stream), in a child process with a time limit."""
    import os
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "gpu", "tests/test_torch_pipeline_gpu.py"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    tail = (r.stdout.strip().splitlines() or [""])[-1]
    log(f"[plane gpu tests] rc {r.returncode}: {tail} "
        f"({time.perf_counter() - t0:.1f} s)")
    if r.returncode != 0:
        log(r.stdout[-4000:] + r.stderr[-2000:])
        raise RuntimeError("the data plane's gpu tests failed")
    return tail


CELL_A = {"shape.global_batch": BATCH, "shape.seq_len": 1024,
          "steps": STEPS, "obs.enabled": False}
KERNEL_GROUPS = (  # first match wins; names as the profiler reports them
    ("K4 ce_score_block", ("ce_token_kernel", "row_sum_kernel")),
    ("K5 flash_attention", ("flash_fwd_wgmma_kernel",
                            "flash_fwd_wgmma256_kernel", "flash_bf16_kernel",
                            "flash_f32_kernel", "combine_kernel",
                            "flash_decode_kernel")),
    ("K1, K2/K3 ce_score, pool_select", ("ce_score_kernel",
                                         "pool_select_kernel")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sgemm")),
    ("memcpy/memset", ("Memcpy", "Memset")),
    ("elementwise/reduce", ("",)),
)


PLANE_SPANS = ("plane.next_wait", "plane.gather", "plane.device_put",
               "plane.plan")
POOL_BYTES = 3 * BATCH * 1024 * 4   # one int32 (pool, 1024) array: tokens
# the parent's synchronous depth-1 plane (PERF.md §5, PR 16's run 8 and
# PR 18's runs): step wall times, NVIDIA H100 80GB HBM3 at 700 W
PARENT_STEP_S = {"cell A": "0.80-1.03", "cell E": "1.04-1.05"}


def _plane_snapshot():
    from repro_torch import obs
    snap = obs.snapshot()
    out = {n: (snap.get(n) or {}).get("sum", 0.0) for n in PLANE_SPANS}
    out["plane.credit_stalls"] = snap.get("plane.credit_stalls", 0)
    return out


def _step_log(tag, profiled=PROFILED, extra=None):
    """A hook that logs each step of a cell: its plan's gids, loss, wall
    time (host clock between two device synchronisations), peak memory
    and the data plane's stage seconds since the last step's end (the
    telemetry registry is turned on for the run, with no sink: the
    ``plane.*`` spans and ``plane.credit_stalls``); step ``profiled``
    runs under ``torch.profiler``."""
    from repro_torch import obs
    from repro_torch.api import Hook
    from torch.profiler import ProfilerActivity, profile

    class StepLog(Hook):
        def __init__(self):
            self.rows = []
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])

        def on_loop_start(self, loop, start, steps):
            obs.enable(True)
            obs.reset()
            self.plane0 = _plane_snapshot()

        def on_step_start(self, loop, step, b, meta):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.gids = [int(g) for g in meta.gids]
            if step == profiled:
                self.prof.start()
            self.t0 = time.perf_counter()

        def on_step_end(self, loop, step, m):
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            if step == profiled:
                self.prof.stop()
            now = _plane_snapshot()
            plane = {k: now[k] - self.plane0[k] for k in now}
            self.plane0 = now
            row = dict(step=step, loss=m["loss"], gids=self.gids,
                       attempts=m["attempts"], step_s=wall,
                       profiled=step == profiled, plane=plane,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            row.update(extra(loop, m) if extra else {})
            self.rows.append(row)
            log(f"[{tag}] " + json.dumps(row))

        def on_loop_end(self, loop, state, history):
            # the registry is the process's: leave it off and empty, as
            # the next phase's run expects it
            obs.enable(False)
            obs.reset()
            # what the phases read after the run; nothing that holds the
            # model, so the next phase has the card's memory
            self.plane = dict(depth=loop.plane.depth,
                              pipelined=loop.plane.pipelined,
                              finalize=loop.plane.finalize)
            self.snapshot = loop.snapshot

    return StepLog()


def _prune_row(loop, m):
    st = loop.exp.sampler.last_prune
    return dict(tau_hat=m["presample_tau"], is_active=m["sampler_active"],
                rows_killed=int(st[0]), tiles_skipped=int(st[1]),
                tiles_total=int(st[2]))


def _h2d_streams(prof, tag):
    """The profiled window's host-to-card copies by CUDA stream, beside
    the stream the K5 kernels ran on (the compute stream), from the
    profiler's trace."""
    path = ROOT / "build" / f"trace_{tag}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    compute = sorted({e["args"]["stream"] for e in events
                      if e.get("cat") == "kernel"
                      and "flash_fwd_wgmma" in e.get("name", "")})
    h2d = [(e["args"].get("stream"), e["args"].get("bytes"))
           for e in events if "memcpy" in str(e.get("cat", "")).lower()
           and "HtoD" in e.get("name", "")]
    pool = sorted({st for st, n in h2d if n == POOL_BYTES})
    by_stream = {}
    for st, _ in h2d:
        by_stream[str(st)] = by_stream.get(str(st), 0) + 1
    return {"compute_streams": compute, "pool_h2d_streams": pool,
            "pool_h2d": sum(n == POOL_BYTES for _, n in h2d),
            "h2d_by_stream": by_stream}


def run_slice(out):
    """Phase 6: the port's main path at llama3.2-3b full width."""
    import repro_torch
    from repro_torch.kernels.ce_score import ce_score as k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.topk_keys import topk_keys as k6
    overrides = dict(CELL_A)
    log(f"[slice] llama3.2-3b, preset prod, overrides {overrides}")
    log("[slice] cuts from prod: seq_len 4096 -> 1024; global_batch 256 -> "
        f"{BATCH}; steps 1000 -> {STEPS} (step {PROFILED} under "
        "torch.profiler); telemetry on -> off (the registry is read for the "
        "plane.* stage times, no sink); checkpointing on -> none. The data "
        "plane is prod's (depth 2, device-put on its own stream). Width, "
        "depth (28 layers) and vocab are not cut.")
    hook = _step_log("slice", extra=_prune_row)
    k4.launches = k6.launches = 0
    _k5_zero(k5)
    t0 = time.perf_counter()
    _, history = repro_torch.train("llama3.2-3b", preset="prod",
                                   overrides=overrides, hooks=[hook])
    torch.cuda.synchronize()
    launches, k5_launches = k4.launches, k5.launches
    k5_by = dict(k5.launches_by_kernel)
    total = time.perf_counter() - t0
    assert len(history) == STEPS
    assert all(math.isfinite(h["loss"]) for h in history), history
    assert hook.plane == dict(depth=2, pipelined=True, finalize=True), \
        hook.plane
    log(f"[slice] {STEPS} steps in {total:.1f} s (model build included); "
        f"K4 launches {launches} ({launches / STEPS:g} per step), K5 "
        f"{k5_launches} ({k5_launches / STEPS:g} per step, the pool's "
        f"scoring forward; by kernel {k5_by}), K6 {k6.launches} (not on this "
        f"path)")
    assert launches == 8 * STEPS, "K4 was not launched 8 times per step"
    assert k5_by == _k5_counts(wgmma=N_LAYERS * STEPS), \
        "the wgmma K5 was not launched once per layer of each pool's scoring"
    breakdown = step_breakdown(hook.prof, hook.rows, out)
    streams = _h2d_streams(hook.prof, "slice")
    log(f"[slice] profiled step's host-to-card copies: {streams}")
    assert streams["pool_h2d"] >= 1, \
        "no upload of a pool in the profiled step"
    assert not set(streams["pool_h2d_streams"]) & set(
        streams["compute_streams"]), \
        "a pool was uploaded on the compute stream, not the plane's"
    gc.collect()
    torch.cuda.empty_cache()
    return launches, k5_by, hook.rows, dict(breakdown or {},
                                            h2d_streams=streams)


CKPT_DIR = ROOT / "build" / "ckpt_cell_a"   # listed in .gitignore
OBS_DIR = ROOT / "chiprun_out" / "obs"
RESUME_AT = 2


def _mem_available():
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _step_files(d):
    """(name, size, mtime, inode) of every file of a checkpoint step, and
    its manifest's bytes: a rewrite renames a new directory in."""
    return (sorted((f.name, f.stat().st_size, f.stat().st_mtime_ns,
                    f.stat().st_ino) for f in d.iterdir()),
            (d / "manifest.json").read_bytes())


def run_cell_a_resume(straight, smi):
    """Phase 6b: cell A with ``prod``'s checkpoints and telemetry."""
    import shutil
    from repro_torch.api import Experiment, Hook, build_run
    from repro_torch.kernels.ce_score import ce_score as k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    overrides = dict(CELL_A, **{"obs.enabled": True, "obs.dir": str(OBS_DIR),
                                "ckpt_dir": str(CKPT_DIR),
                                "ckpt_every": RESUME_AT, "keep_ckpts": 1})
    log(f"[resume] llama3.2-3b, preset prod, overrides {overrides}; cuts "
        "from prod as phase 6's, but telemetry on (JSONL) and checkpoints "
        f"every {RESUME_AT} steps, the last kept")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    shutil.rmtree(OBS_DIR, ignore_errors=True)

    class Rec(Hook):
        def __init__(self):
            self.rows, self.t_start = [], None

        def on_loop_start(self, loop, start, steps):
            torch.cuda.synchronize()
            self.t_start = time.perf_counter()
            self.start = start

        def on_step_start(self, loop, step, b, meta):
            self.gids = [int(g) for g in meta.gids]

        def on_step_end(self, loop, step, m):
            self.rows.append(dict(step=step, loss=m["loss"], gids=self.gids,
                                  is_active=m["sampler_active"]))

    exp = Experiment(build_run("llama3.2-3b", preset="prod",
                               overrides=overrides))
    n = sum(p.numel() for p in exp.lm.parameters())
    # the params in their dtype, then f32 master, m and v
    state_bytes = sum(p.numel() * p.element_size()
                      for p in exp.lm.parameters()) + 3 * 4 * n
    disk, mem = shutil.disk_usage(CKPT_DIR).free, _mem_available()
    log(f"[resume] {n} parameters: a state of {state_bytes / 1e9:.3f} GB; "
        f"free disk under build/ {disk / 1e9:.3f} GB (needs the state once "
        f"plus 2 %: {1.02 * state_bytes / 1e9:.3f}), MemAvailable "
        f"{mem / 1e9:.3f} GB (needs twice the state: "
        f"{2 * state_bytes / 1e9:.3f}) | {smi}")
    if disk < 1.02 * state_bytes or mem < 2 * state_bytes:
        raise RuntimeError(
            f"too little room for cell A's checkpoint: free disk "
            f"{disk} B against {int(1.02 * state_bytes)} B, MemAvailable "
            f"{mem} B against {2 * state_bytes} B")

    # 1. steps 0 and 1, saving step_2
    first = Rec()
    exp.fit(steps=RESUME_AT, hooks=[first])
    save1 = dict(exp.ckpt.last_save)
    assert exp.ckpt.steps() == [RESUME_AT], exp.ckpt.steps()
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    # 2. resume at 2 from the manifest and train 2 and 3; step_2 is removed
    # once the restore has read it, so the disk holds one checkpoint
    class Drop(Hook):
        def on_loop_start(self, loop, start, steps):
            shutil.rmtree(CKPT_DIR / f"step_{RESUME_AT}")

    resumed = Rec()
    t0 = time.perf_counter()
    exp = Experiment.from_checkpoint(CKPT_DIR)
    built = time.perf_counter() - t0
    k4.launches = 0
    _k5_zero(k5)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hist = exp.fit(steps=STEPS, hooks=[resumed, Drop()])[1]
    torch.cuda.synchronize()
    launches, k5_by = k4.launches, dict(k5.launches_by_kernel)
    restore_s = resumed.t_start - t1
    save2 = dict(exp.ckpt.last_save)
    n_run = STEPS - RESUME_AT
    assert resumed.start == RESUME_AT and len(hist) == n_run, hist
    assert exp.ckpt.steps() == [STEPS], exp.ckpt.steps()

    # 3. the same rows as phase 6's straight run, losses to 1e-3 relative
    bitwise = True
    for got, want in zip(first.rows + resumed.rows, straight):
        assert got["step"] == want["step"]
        assert got["gids"] == want["gids"], (got, want)
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        assert rel <= 1e-3, (got, want)
        bitwise &= got["loss"] == want["loss"]
    log(f"[resume] steps 0-{STEPS - 1} (0-{RESUME_AT - 1} before the save, "
        f"{RESUME_AT}-{STEPS - 1} resumed): the plans of phase 6's straight "
        f"run; losses {[r['loss'] for r in first.rows + resumed.rows]} "
        f"against {[r['loss'] for r in straight]}, bitwise: {bitwise}")

    # 4. the resumed steps ran the cell's kernels
    log(f"[resume] resumed steps: K4 launches {launches} "
        f"({launches / n_run:g} per step), K5 {k5_by}")
    assert launches == 8 * n_run, "K4 was not launched 8 times per step"
    assert k5_by == _k5_counts(wgmma=N_LAYERS * n_run), \
        "the wgmma K5 was not launched once per layer of each pool's scoring"

    # 5. resumed at the final step: nothing trained, step_4 untouched
    step_dir = CKPT_DIR / f"step_{STEPS}"
    before = _step_files(step_dir)
    k4.launches = 0
    _k5_zero(k5)
    again = Rec()
    t2 = time.perf_counter()
    hist = exp.fit(steps=STEPS, hooks=[again])[1]
    torch.cuda.synchronize()
    restore2_s = time.perf_counter() - t2
    assert hist == [] and again.rows == [] and again.start == STEPS
    assert k4.launches == 0 and k5.launches == 0
    assert _step_files(step_dir) == before, "step_4 was rewritten"
    assert exp.ckpt.steps() == [STEPS]
    on_disk = sum(f.stat().st_size for f in step_dir.iterdir())
    del exp, hist
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the JSONL telemetry
    recs = [json.loads(line) for f in sorted(OBS_DIR.glob("obs-p0.*.jsonl"))
            for line in f.read_text().splitlines()]
    ends = [r["metrics"] for r in recs if r["event"] == "loop_end"]
    assert len(ends) == 3, [r["event"] for r in recs]
    health = {}
    for i, m in enumerate(ends[:2]):   # the two fits that trained
        names = [k for k in m if k.startswith("health.")]
        assert {"health.tau", "health.variance_gain", "health.speedup_est",
                "health.is_active"} <= set(names), sorted(m)
        for k in names + ["loop.h2d_bytes"]:
            assert math.isfinite(m[k]), (k, m[k])
        hist_s = m["loop.step_s"]
        # the registry is the process's: counts add up over the fits
        assert hist_s["count"] == RESUME_AT * (i + 1), hist_s
        assert math.isfinite(hist_s["sum"])
        health = {k: m[k] for k in sorted(names)}
    log(f"[resume] JSONL: {len(recs)} records in "
        f"{OBS_DIR.relative_to(ROOT)}; the last fit that trained: {health}, "
        f"loop.step_s {ends[1]['loop.step_s']['sum']:.4f} s over "
        f"{ends[1]['loop.step_s']['count']} steps, loop.h2d_bytes "
        f"{ends[1]['loop.h2d_bytes']}")

    # 7. the numbers, beside the card
    out = dict(state_bytes=state_bytes, ckpt_bytes_on_disk=on_disk,
               free_disk=disk, mem_available=mem, save_step_2=save1,
               save_step_4=save2, build_from_checkpoint_s=built,
               restore_s=restore_s, restore_at_final_step_s=restore2_s,
               losses_bitwise=bitwise, k4_launches=launches,
               k5_launches_by_kernel=k5_by, health=health,
               steps=first.rows + resumed.rows, card=smi)
    for tag, sv in (("step_2", save1), ("step_4", save2)):
        log(f"[resume] save {tag}: snapshot to host {sv['snapshot_s']:.2f} "
            f"s, write {sv['write_s']:.2f} s, commit {sv['commit_s']:.3f} "
            f"s, {sv['bytes'] / 1e9:.3f} GB | {smi}")
    log(f"[resume] checkpoint on disk {on_disk / 1e9:.3f} GB; resume "
        f"(fresh state + restore of step_2) {restore_s:.2f} s after "
        f"{built:.2f} s to build the Experiment; resume at the final step "
        f"(restore of step_4, nothing trained) {restore2_s:.2f} s | {smi}")

    # 8. the directory goes
    shutil.rmtree(CKPT_DIR)
    return out


def _same_rows(tag, got_rows, want_rows):
    """Every step's plan equals phase 6's, losses to 1e-3 relative;
    returns whether the losses are bitwise."""
    assert [r["step"] for r in got_rows] == [r["step"] for r in want_rows]
    bitwise = True
    for got, want in zip(got_rows, want_rows):
        assert got["gids"] == want["gids"], (tag, got, want)
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        assert rel <= 1e-3, (tag, got, want)
        bitwise &= got["loss"] == want["loss"]
    return bitwise


class ScriptedSkip:
    """A scripted straggler monitor (the reference's ``SkipOnce``): one
    skip, on its second observation — step 1's first attempt."""

    def __init__(self):
        self.calls = 0

    def observe(self, dt):
        self.calls += 1
        return {"skip": self.calls == 2, "b_scale": 1.0,
                "over_deadline": False}


def run_cell_a_depth1(out, straight, breakdown6, smi):
    """Phase 6c: cell A with the plane at depth 1 beside phase 6's depth
    2, then one forced retry at depth 2."""
    from repro_torch.api import Experiment, build_run
    from repro_torch.kernels.ce_score import ce_score as k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    overrides = dict(CELL_A, **{"data.prefetch_depth": 1})
    log(f"[depth 1] llama3.2-3b, preset prod, overrides {overrides}; cuts "
        "from prod as phase 6's, the plane at depth 1")
    hook = _step_log("depth 1", extra=_prune_row)
    gc.collect()
    torch.cuda.empty_cache()
    exp = Experiment(build_run("llama3.2-3b", preset="prod",
                               overrides=overrides))
    k4.launches = 0
    _k5_zero(k5)
    exp.fit(hooks=[hook])
    torch.cuda.synchronize()
    assert hook.plane["depth"] == 1, hook.plane
    assert k4.launches == 8 * STEPS and dict(k5.launches_by_kernel) == \
        _k5_counts(wgmma=N_LAYERS * STEPS)
    bitwise = _same_rows("depth 1", hook.rows, straight)
    breakdown = step_breakdown(hook.prof, hook.rows, out, "profile depth 1",
                               "profile_step_depth1")
    streams = _h2d_streams(hook.prof, "depth1")
    assert not set(streams["pool_h2d_streams"]) & set(
        streams["compute_streams"]), streams
    idle = {1: (breakdown or {}).get("idle_share"),
            2: (breakdown6 or {}).get("idle_share")}
    log(f"[depth 1] every step's plan is phase 6's, losses to 1e-3 "
        f"relative, bitwise: {bitwise} | {smi}")
    for r1, r2 in zip(hook.rows, straight):
        cols = []
        for tag, r, d in (("depth 1", r1, 1), ("depth 2", r2, 2)):
            p = r["plane"]
            cols.append(
                f"{tag}: wall {r['step_s']:.4f} s, next_wait "
                f"{p['plane.next_wait'] * 1e3:.3f} ms, gather "
                f"{p['plane.gather'] * 1e3:.3f} ms, device_put "
                f"{p['plane.device_put'] * 1e3:.3f} ms, credit_stalls "
                f"{p['plane.credit_stalls']}, idle share "
                + (f"{idle[d]:.3f}" if r["profiled"] and idle[d] is not None
                   else "not measured"))
        log(f"[depth 1] step {r1['step']}: " + " | ".join(cols)
            + f" | the parent's synchronous plane {PARENT_STEP_S['cell A']} "
            "s (PERF.md §5)")
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    # one forced retry at full width: a scripted monitor votes a skip on
    # step 1's first attempt; the state copy goes to pinned host memory
    # (45 GB of state, 80 GB of card), and the retry restores it
    retry = _step_log("retry", profiled=-1, extra=_prune_row)
    exp = Experiment(build_run("llama3.2-3b", preset="prod",
                               overrides=CELL_A))
    exp.monitor = ScriptedSkip()
    n = sum(p.numel() for p in exp.lm.parameters())
    state_bytes = sum(p.numel() * p.element_size()
                      for p in exp.lm.parameters()) + 3 * 4 * n
    k4.launches = 0
    _k5_zero(k5)
    t0 = time.perf_counter()
    _, hist = exp.fit(hooks=[retry])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    snap = retry.snapshot
    assert [h["attempts"] for h in hist] == [1, 2, 1, 1], hist
    assert (snap.taken, snap.restored) == (5, 1), (snap.taken, snap.restored)
    retry_bitwise = _same_rows("retry", retry.rows, straight)
    # the retried attempt scores no pool again: the counts are phase 6's
    assert k4.launches == 8 * STEPS and dict(k5.launches_by_kernel) == \
        _k5_counts(wgmma=N_LAYERS * STEPS)
    res = dict(state_bytes=state_bytes, where=snap.where,
               snapshot_s=snap.take_s, restore_s=snap.restore_s,
               attempts=[h["attempts"] for h in hist],
               losses_bitwise=retry_bitwise, total_s=total, card=smi)
    log(f"[retry] step 1 retried once (attempts {res['attempts']}); every "
        f"step's plan is phase 6's, losses to 1e-3 relative, bitwise: "
        f"{retry_bitwise}; K4 {k4.launches}, K5 {dict(k5.launches_by_kernel)}")
    log(f"[retry] the state copy: {state_bytes / 1e9:.3f} GB in {snap.where}"
        f" memory; taken {snap.taken} times "
        f"({', '.join(f'{t:.3f}' for t in snap.take_s)} s), restored once "
        f"({snap.restore_s[0]:.3f} s); fit {total:.1f} s | {smi}")
    del exp, hist
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=hook.rows, bitwise=bitwise, profile=breakdown,
                h2d_streams=streams, retry=res, retry_steps=retry.rows)


def _device_time(prof):
    """Seconds of device activity by kernel name in a profiler window."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us * 1e-6
    return by_name


def _groups(by_name):
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    for name, s in by_name.items():
        g = next(g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys))
        groups[g] += s
    return groups


def step_breakdown(prof, rows, out, tag="profile", fname="profile_step"):
    """Device time of the profiled step by kernel, from torch.profiler.
    Busy time is the sum of device activity on the one stream the port
    uses; the idle share is taken against step 1's unprofiled wall time,
    a step of the same work without the profiler's overhead."""
    by_name = _device_time(prof)
    busy = sum(by_name.values())
    if busy == 0.0:
        log(f"[{tag}] the profiler saw no device activity: breakdown not "
            "measured")
        return None
    groups = _groups(by_name)
    wall, steady = rows[PROFILED]["step_s"], rows[1]["step_s"]
    log(f"[{tag}] step {PROFILED}: wall {wall:.4f} s (profiled), device "
        f"busy {busy:.4f} s; idle share against step 1's unprofiled "
        f"{steady:.4f} s: {1 - busy / steady:.3f}")
    for g, s in groups.items():
        log(f"[{tag}]   {g}: {s * 1e3:.2f} ms ({s / busy:.3f} of busy)")
    for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[{tag}]   {s * 1e3:9.2f} ms  {name[:100]}")
    (out / f"{fname}.txt").write_text(prof.key_averages().table(
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
        bitwise = torch.equal(allk, allp)
        err = (allk[live] - allp[live]).abs()
        # a key of 0 (u rounded to 1) has no relative error to speak of
        tiny = torch.finfo(torch.float32).tiny
        rel = float((err / allp[live].abs().clamp(min=tiny)).max()) \
            if live.any() else 0.0
        ab = float(err.max()) if live.any() else 0.0
        worst_abs, worst_rel = max(worst_abs, ab), max(worst_rel, rel)
        log(f"[k6] {name}: max |kernel - plain| = {ab:.3e} (relative "
            f"{rel:.3e}, rtol {K6_RTOL}); keys bitwise: {bitwise}; "
            f"bottom-{k} slots equal")
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
    from repro_torch.kernels.flash_attn import flash_attn as k5
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
    k4.launches = k5.launches = k6.launches = 0
    t0 = time.perf_counter()
    _, history = repro_torch.train("llama3.2-3b", preset="prod",
                                   overrides=overrides, source=source,
                                   hooks=[hook])
    torch.cuda.synchronize()
    launches = k6.launches
    total = time.perf_counter() - t0
    log(f"[history] {STEPS} steps in {total:.1f} s (model build and store "
        f"warm-up included); K6 launches {launches} ({launches / STEPS:g} "
        f"per step), K4 {k4.launches} (not on this path), K5 "
        f"{k5.launches} (no forward-only pass on this path)")
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

# ---------------------------------------------------------------------------
# slice 3: serving and scoring, K5 and K1
# ---------------------------------------------------------------------------
def _k5_zero(k5):
    """K5's counts, the total and each kernel's, set to 0."""
    k5.launches = 0
    k5.launches_by_kernel.update(dict.fromkeys(k5.launches_by_kernel, 0))


def _k5_counts(**moved):
    """K5's ``launches_by_kernel`` with ``moved``'s counts and the other
    kernels' 0: ``wgmma`` (hd 128), ``wgmma256`` (hd 256), ``decode256``
    (hd 256, one query row), ``f32`` (f32 prefill and scoring), ``mma``."""
    return dict(dict.fromkeys(("wgmma", "wgmma256", "decode256", "f32",
                               "mma"), 0), **moved)


def _k5_inputs(b, sq, skv, hq, hkv, hd, dtype, gen, slots=0, q_scale=1.0):
    """q (b, sq, hq, hd); k, v (b, skv, hkv, hd), as prefix views of a
    ``slots``-slot cache when ``slots`` > skv (how serving passes them)."""
    n = max(skv, slots)
    q = torch.randn((b, sq, hq, hd), generator=gen, device="cuda") \
        .mul_(q_scale).to(dtype)
    k = torch.randn((b, n, hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, n, hkv, hd), generator=gen, device="cuda").to(dtype)
    return q, k[:, :skv], v[:, :skv]


def _k5_plain(q, k, v, rows=2, **kw):
    """K5's plain version, ``rows`` batch rows at a time: the oracle holds
    the whole (B·hq, sq, skv) score matrix in f32, 13 GB for all 8 rows of
    cell C's prefill."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    return torch.cat([flash_attention(q[i:i + rows], k[i:i + rows],
                                      v[i:i + rows], interpret=True, **kw)
                      for i in range(0, q.shape[0], rows)])


def _row_rel_err(got, want):
    """max over query rows of max|got − want| / max|want| (over hd)."""
    err = (got.float() - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


def _k5_case(name, kernel, shape, dtype, gen, *, window=0, q_offset=0,
             slots=0, q_scale=1.0, scale=None, causal=True, off_tma=False):
    """One K5 case on the card: the dispatch rule must send it to
    ``kernel`` (whose count alone moves); a second launch gives the same
    bits; the output is finite and within ``K5_TOL`` of the f32 plain
    version on the same inputs, and within ``K5_ROW_REL`` of each query
    row's largest |output|. ``off_tma``: q copied off TMA's alignment
    (``_off_tma``), which sends a prefill to the mma kernel."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.flash_attn.ops import flash_attention
    q, k, v = _k5_inputs(*shape, dtype, gen, slots, q_scale)
    if off_tma:
        q = _off_tma(q)
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    before = dict(k5.launches_by_kernel)
    got = flash_attention(q, k, v, **kw)
    moved = {n: c - before[n] for n, c in k5.launches_by_kernel.items()}
    assert moved == {n: int(n == kernel) for n in moved}, (name, moved)
    # no atomics: a second launch on the same inputs gives the same bits
    assert torch.equal(flash_attention(q, k, v, **kw), got), name
    want = _k5_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    tol, rel_tol = K5_TOL[dtype], K5_ROW_REL[dtype]
    err = float((got.float() - want).abs().max())
    rel = _row_rel_err(got, want)
    log(f"[k5] {name}: {kernel} kernel; max |kernel - plain| = {err:.3e} "
        f"(rtol = atol {tol}); worst row error / row's max |output| = "
        f"{rel:.3e} (<= {rel_tol})")
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert rel <= rel_tol, (name, rel, rel_tol)
    assert torch.isfinite(got).all(), name
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return dict(kernel=kernel, max_abs_err=err, max_row_rel_err=rel,
                bitwise_repeatable=True)


def check_k5(gen):
    """Phase 13. Returns the worst absolute and per-row relative errors
    over the cases, and each case's. Each case names the kernel the
    dispatch rule must send it to, and that kernel's count must move."""
    P, cap = SERVE["prompt_len"], SERVE["prompt_len"] + SERVE["gen"]
    cases = [
        # name, kernel, (b, sq, skv, hq, hkv, hd), dtype, window, q_offset,
        # slots[, q scale]
        (f"cell C prefill (8,{P}) over the {cap}-slot cache, bf16", "wgmma",
         (8, P, cap, 24, 8, 128), torch.bfloat16, 0, 0, 0),
        (f"cell C prefill (8,{P}), q x{Q_PEAK:g} (peaked), bf16", "wgmma",
         (8, P, cap, 24, 8, 128), torch.bfloat16, 0, 0, 0, Q_PEAK),
        (f"cell C prefill (8,{P}) over the cache's {P}-key prefix view (as "
         "serve passes it), bf16", "wgmma", (8, P, P, 24, 8, 128),
         torch.bfloat16, 0, 0, cap),
        ("cells A/E pool (12,1024) 24/8x128 bf16", "wgmma",
         (12, 1024, 1024, 24, 8, 128), torch.bfloat16, 0, 0, 0),
        ("cell D score (8,1024) 24/8x128 bf16", "wgmma",
         (8, 1024, 1024, 24, 8, 128), torch.bfloat16, 0, 0, 0),
        ("ragged (3,333) 24/8x128 bf16", "wgmma",
         (3, 333, 333, 24, 8, 128), torch.bfloat16, 0, 0, 0),
        ("ragged (2,777) at offset 100 over a 1000-slot cache, bf16",
         "wgmma", (2, 777, 877, 24, 8, 128), torch.bfloat16, 0, 100, 1000),
        ("window 256 (2,600) 24/8x128 bf16", "wgmma",
         (2, 600, 600, 24, 8, 128), torch.bfloat16, 256, 0, 0),
        # rows whose first kv tile is wholly masked for them (window and
        # offset) at a softmax scale other than hd^-0.5
        ("window 64 (2,200) at offset 256 over a 512-slot cache, scale 0.2,"
         " bf16", "wgmma", (2, 200, 456, 24, 8, 128), torch.bfloat16, 64,
         256, 512, 1.0, 0.2),
        ("ragged (2,77) 24/8x64 bf16 (the mma kernel's bf16 prefill)",
         "mma", (2, 77, 77, 24, 8, 64), torch.bfloat16, 0, 0, 0),
        # f32 prefill and scoring: the f32 kernel
        ("f32 (2,300) 24/8x128", "f32", (2, 300, 300, 24, 8, 128),
         torch.float32, 0, 0, 0),
        ("f32 cell I pool (12,1024) 10/5x64", "f32",
         (12, 1024, 1024, 10, 5, 64), torch.float32, 0, 0, 0),
        (f"f32 cell I pool (12,1024) 10/5x64, q x{Q_PEAK:g} (peaked)", "f32",
         (12, 1024, 1024, 10, 5, 64), torch.float32, 0, 0, 0, Q_PEAK),
        ("f32 lm-tiny prefill (2,64) 4/2x16", "f32", (2, 64, 64, 4, 2, 16),
         torch.float32, 0, 0, 0),
        ("f32 ragged (2,77) 24/8x64 (g = 3)", "f32", (2, 77, 77, 24, 8, 64),
         torch.float32, 0, 0, 0),
        ("f32 window 64 (2,200) at offset 256 over a 512-slot cache, scale "
         "0.2", "f32", (2, 200, 456, 24, 8, 64), torch.float32, 64, 256, 512,
         1.0, 0.2),
        (f"f32 window 40 (2,130) 4/2x32, q x{Q_PEAK:g}, scale 0.3", "f32",
         (2, 130, 130, 4, 2, 32), torch.float32, 40, 0, 0, Q_PEAK, 0.3),
        ("f32 lm-tiny decode (2,1) 4/2x16 at 40", "mma", (2, 1, 41, 4, 2, 16),
         torch.float32, 0, 40, 64),
    ]
    for off in (P, P + 31, cap - 1):
        cases.append((f"cell C decode (8,1) at {off} over the cache, bf16",
                      "mma", (8, 1, off + 1, 24, 8, 128), torch.bfloat16, 0,
                      off, cap))
    cases.append((f"cell C decode (8,1) at {P + 31}, q x{Q_PEAK:g} "
                  "(peaked), bf16", "mma", (8, 1, P + 32, 24, 8, 128),
                  torch.bfloat16, 0, P + 31, cap, Q_PEAK))
    worst, worst_rel, per_case = 0.0, 0.0, {}
    for name, kernel, shape, dtype, window, off, slots, *extra in cases:
        q_scale = extra[0] if extra else 1.0      # [q scale[, softmax scale]]
        scale = extra[1] if len(extra) > 1 else None
        per_case[name] = _k5_case(name, kernel, shape, dtype, gen,
                                  window=window, q_offset=off, slots=slots,
                                  q_scale=q_scale, scale=scale)
        worst = max(worst, per_case[name]["max_abs_err"])
        worst_rel = max(worst_rel, per_case[name]["max_row_rel_err"])
    log("[k5] the plain version ran in f32 on the same inputs, two batch "
        "rows at a time (its f32 score matrix for all 8 rows of the "
        "prefill is 13 GB); each case's second launch gave the same bits")
    return worst, worst_rel, per_case


def check_k1(gen):
    """Phase 14. Returns the worst absolute error over the cases."""
    from repro_torch.kernels.ce_score.ops import ce_score
    from repro_torch.kernels.ce_score.ref import ce_score_ref
    T, V = 8 * 1024, 128256
    cases = [("cell D (8192, 128256) bf16", T, V, torch.bfloat16, 0),
             ("cell D (8192, 128256) f32", T, V, torch.float32, 0),
             ("ragged (1001, 50257) bf16, strided rows", 1001, 50257,
              torch.bfloat16, 5),
             ("ragged (77, 32003) f32, strided rows", 77, 32003,
              torch.float32, 3)]
    worst = 0.0
    for name, T, V, dtype, pad in cases:
        z = torch.randn((T, V + pad), generator=gen, device="cuda") \
            .mul_(3.0)
        z = z.to(dtype)[:, pad // 2:pad // 2 + V]          # rows strided
        extreme = torch.tensor([1e4, -1e4, 0.0, 5.0])
        z[0, :4] = extreme
        z[1, :4] = extreme
        y = torch.randint(0, V, (T,), generator=gen, device="cuda",
                          dtype=torch.int32)
        y[0], y[1], y[2], y[3] = 0, 1, V - 1, 0
        got = ce_score(z, y)
        want = ce_score_ref(z, y)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            torch.testing.assert_close(g, w, **K1_TOL)
            err = max(err, float((g - w).abs().max()))
        # label = argmax: ce ~ 0, g2 ~ 0; label = argmin: g2 ~ 2
        assert abs(float(got[0][0])) < 1e-3 and abs(float(got[1][0])) < 1e-3
        assert abs(float(got[1][1]) - 2.0) < 1e-3
        worst = max(worst, err)
        log(f"[k1] {name}: max |kernel - plain| = {err:.3e} (rtol "
            f"{K1_TOL['rtol']}, atol {K1_TOL['atol']}); extreme rows finite")
        del z, y, got, want
        torch.cuda.empty_cache()
    return worst


def _teacher_forced(lm, tokens, prompts, steps, q_offset, f32_head=False):
    """Prefill ``prompts`` into fresh caches, then ``steps`` decode steps
    fed ``tokens[:, i]``; the last-position logits of each (f32). With
    ``q_offset`` the steps take K5, else the plain attention paths. With
    ``f32_head`` also the logits before the lm head's bf16 rounding: the
    final norm's output times the head's weights, in f32."""
    b, P = prompts.shape
    caches = lm.caches(b, P + tokens.shape[1])
    dev = prompts.device
    hidden = []
    hook = lm.final_norm.register_forward_hook(
        lambda mod, args, h: hidden.append(h[:, -1].float())) \
        if f32_head else None

    def step(toks, start):
        if q_offset:
            return lm.serve_step(caches, {"tokens": toks}, q_offset=start)
        pos = torch.arange(start, start + toks.shape[1], dtype=torch.int32,
                           device=dev)[None].expand(b, -1)
        return lm.serve_step(caches, {"tokens": toks, "positions": pos})
    out = []
    with torch.inference_mode():
        out.append(step(prompts, 0)[0][:, -1].float())
        for i in range(steps):
            out.append(step(tokens[:, i:i + 1], P + i)[0][:, -1].float())
        if not f32_head:
            return out
        hook.remove()
        w = (lm.embed.t() if lm.cfg.tie_embeddings else lm.lm_head).float()
        return out, [h @ w for h in hidden]


@contextlib.contextmanager
def _swapped(module, name, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _k5_beside(errs):
    """A wrapper of the plain ``attention_op`` that also runs K5 on each
    call's own q, k and v as the K5 route would (``flash_route`` from the
    query positions, the layer's window, whether k and v are a ring and
    whether its slots hold their positions in step, read from the stored
    positions: a global cache's or an unwrapped ring's prefix, causal; a
    wrapped ring whole, not causal), holds it within ``K5_TOL`` (bf16) of
    the plain output and records (max |K5 - plain|, worst row error
    against the row's largest |output|); the plain output goes on."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.models.attention import flash_route
    tol = K5_TOL[torch.bfloat16]

    def wrap(real):
        def attention_op(q, k, v, q_pos, kv_pos, **kw):
            o = real(q, k, v, q_pos, kv_pos, **kw)
            cap, ring = k.shape[1], kw.get("ring", False)
            slots = torch.arange(cap, device=kv_pos.device)
            in_order = not ring or bool(
                ((kv_pos < 0) | (kv_pos % cap == slots)).all())
            route = flash_route(int(q_pos[0, 0]), q.shape[1], cap,
                                kw.get("window", 0), ring, in_order)
            assert route is not None, (q.shape, k.shape, kw)
            n, causal, window, off = route
            f = flash_attention(q, k[:, :n], v[:, :n], causal=causal,
                                window=window, q_offset=off,
                                scale=kw.get("scale"))
            torch.testing.assert_close(f.float(), o.float(), rtol=tol,
                                       atol=tol)
            errs.append((float((f.float() - o.float()).abs().max()),
                         _row_rel_err(f, o.float())))
            return o
        return attention_op
    return wrap


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _token_check(fast, plain, again):
    """Greedy tokens of the K5 route (``fast``) against the plain route's,
    per (step, row): where the plain route's top two bf16 logits differ by
    more than one bf16 ulp of the top logit, the K5 token must equal the
    plain one; where they lie within one ulp (a tie at the logits'
    precision), the plain route's logit of the K5 token must lie within
    the ruler of the top one: the larger of one ulp and the plain route's
    own worst logit drift under re-chunking (``again``, the same f32 sums
    in another order). Any token so close is one an equally valid route
    may pick, ties of three or more logits included. The re-chunked
    route's flips on the same rows are recorded beside the K5 route's.
    Returns the record; raises on a row that breaks the rule."""
    ruler = max(float((a - p).abs().max()) for p, a in zip(plain, again))
    ties, flips, again_flips, bad = [], [], [], []
    for i, (f, p, a) in enumerate(zip(fast, plain, again)):
        top3 = p.topk(3, dim=-1)
        mine, ref = f.argmax(-1), a.argmax(-1)
        for r in range(p.shape[0]):
            hi, second, _ = (float(x) for x in top3.values[r])
            first = int(top3.indices[r, 0])
            tie = hi - second <= _bf16_ulp(hi)
            if tie:
                ties.append(dict(step=i, row=r, top3_margins=[
                    hi - float(x) for x in top3.values[r]]))
            m = int(mine[r])
            if m != first:
                margin = hi - float(p[r, m])
                flips.append(dict(step=i, row=r, tie=tie, token=m,
                                  margin=margin, ulp=_bf16_ulp(hi),
                                  in_top2=m in top3.indices[r, :2].tolist()))
                if not tie or margin > max(ruler, _bf16_ulp(hi)):
                    bad.append(flips[-1])
            if int(ref[r]) != first:
                again_flips.append(dict(step=i, row=r, tie=tie,
                                        token=int(ref[r]),
                                        margin=hi - float(p[r, ref[r]])))
    rec = dict(rows=sum(p.shape[0] for p in plain), tie_rows=len(ties),
               ties=ties, tie_ruler=ruler, k5_flips=flips,
               k5_flips_at_ties=sum(f["tie"] for f in flips),
               k5_flips_outside_top2=[f for f in flips
                                      if f["tie"] and not f["in_top2"]],
               plain_rechunked_flips=again_flips,
               plain_rechunked_flips_at_ties=sum(f["tie"]
                                                 for f in again_flips))
    assert not bad, (bad, rec)
    return rec


def check_serve_lm_tiny():
    """Phase 15: lm-tiny served on the card (K5, f32) and on the CPU (the
    plain attention paths) from the same params and prompts."""
    import repro_torch
    from repro_torch.checkpoint import interop
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.models.lm import LM
    cfg = get_config("lm-tiny")
    gpu = LM(cfg, "cuda")
    cpu = interop.params_from_numpy(interop.params_to_numpy(gpu), cfg, "cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    _k5_zero(k5)
    outs = [repro_torch.serve(cfg, params=lm.state_dict(), prompts=prompts,
                              gen=8, device=dev)
            for lm, dev in ((gpu, "cuda"), (cpu, "cpu"))]
    launched = k5.launches
    assert np.array_equal(outs[0]["tokens"], outs[1]["tokens"]), \
        (outs[0]["tokens"], outs[1]["tokens"])
    n_layers = cfg.segments[0].repeats
    # the 24-token prefill on the f32 kernel, the 7 decode steps on mma
    by_kernel = dict(k5.launches_by_kernel)
    assert launched == n_layers * 8 and by_kernel == _k5_counts(
        f32=n_layers, mma=n_layers * 7), (launched, by_kernel)
    toks = torch.from_numpy(outs[0]["tokens"])
    pg = _teacher_forced(gpu, toks.cuda(), torch.from_numpy(prompts).cuda(),
                         7, True)
    pc = _teacher_forced(cpu, toks, torch.from_numpy(prompts), 7, True)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(pg, pc))
    assert err < 1e-3, err
    log(f"[serve lm-tiny] card (K5, {launched} launches: {by_kernel}) and "
        f"CPU (plain): "
        f"greedy tokens equal {outs[0]['tokens'].tolist()}; prefill and "
        f"decode logits within {err:.2e} (< 1e-3)")
    return err


SERVE_CUTS = (
    "cuts from decode_32k (batch 128, prompt 32768): batch 128 -> "
    f"{SERVE['batch']}, prompt 32768 -> {SERVE['prompt_len']}, generation "
    f"{SERVE['gen']} tokens, cap {SERVE['prompt_len'] + SERVE['gen']}; "
    "mesh (pod) -> one card. Width, depth (28 layers), vocab and the bf16 "
    "weights and caches are not cut.")


def profile_serve(lm, prompts, toks, row, out, steps=4, tag="C",
                  fname="profile_serve"):
    """Where a serving cell's time goes (cell ``tag``; tables to
    ``<fname>_prefill.txt`` and ``_decode.txt``): the K5-route prefill and
    ``steps`` teacher-forced decode steps, each window under
    ``torch.profiler``.
    Device busy time against the unprofiled serve's prefill time and
    decode step time gives each phase's idle share; the kernel count of a
    decode step and its host-to-card copies show what the host does."""
    from torch.profiler import ProfilerActivity, profile
    b, P = prompts.shape
    caches = lm.caches(b, P + toks.shape[1])
    res = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pre:
            lm.serve_step(caches, {"tokens": prompts}, q_offset=0)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as dec:
            t0 = time.perf_counter()
            for i in range(steps):
                lm.serve_step(caches, {"tokens": toks[:, i:i + 1]},
                              q_offset=P + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    for name, prof, n, ref_s in (("prefill", pre, 1, row["prefill_s"]),
                                 ("decode", dec, steps,
                                  row["decode_ms_per_step"] * 1e-3)):
        by_name = _device_time(prof)
        busy = sum(by_name.values()) / n
        kernels = sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / n
        h2d = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "HtoD" in e.name) / n
        groups = {g: t / n for g, t in _groups(by_name).items()}
        res[name] = dict(busy_ms=busy * 1e3, unprofiled_ms=ref_s * 1e3,
                         idle_share=1 - busy / ref_s,
                         device_ops=kernels, h2d_copies=h2d,
                         groups_ms={g: t * 1e3 for g, t in groups.items()})
        log(f"[profile {tag}] {name} (per {'step' if n > 1 else 'pass'}): "
            f"device busy {busy * 1e3:.3f} ms of an unprofiled "
            f"{ref_s * 1e3:.3f} ms (idle share {1 - busy / ref_s:.3f}); "
            f"{kernels:g} device ops, {h2d:g} host-to-card copies")
        for g, t in groups.items():
            log(f"[profile {tag}]   {g}: {t * 1e3:.3f} ms")
        for k, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log(f"[profile {tag}]   {t / n * 1e3:9.3f} ms  {k[:90]}")
        (out / f"{fname}_{name}.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=50))
    res["decode"]["profiled_wall_ms"] = wall / steps * 1e3
    return res


def _route_check(lm, prompts, toks, steps, n_layers, tag):
    """Phase 16's token check of a served model: the prefill and ``steps``
    teacher-forced decode steps on serve's tokens ``toks`` through the K5
    route and through the plain route, with (a) K5 run beside each plain
    attention call on that call's own inputs, (b) the f32 logits' drift
    between the routes against the plain route's own under re-chunking,
    (c) ``_token_check``, (d) serve's
    tokens reproduced by the K5 route. Returns the record."""
    from repro_torch.models import attention
    fast, fast32 = _teacher_forced(lm, toks, prompts, steps, True, True)
    # the plain route, with K5 run beside each attention call on that
    # call's own inputs: every layer of the prefill and of each step
    layer = []
    with _swapped(attention, "attention_op", _k5_beside(layer)):
        plain, plain32 = _teacher_forced(lm, toks, prompts, steps, False,
                                         True)
    # the plain route again with its blockwise attention in other chunks
    # (the same f32 sums in another order): the ruler of how far two
    # equally valid routes drift apart over 28 bf16 layers
    with _swapped(attention, "online_attention", lambda real:
                  functools.partial(real, q_chunk=1024, kv_chunk=512)):
        again, again32 = _teacher_forced(lm, toks, prompts, steps, False,
                                         True)
    errs, scales, agree = [], [], []
    for i, (f, p) in enumerate(zip(fast, plain)):
        errs.append(float((f - p).abs().max()))
        scales.append(float(p.abs().max()))
        agree.append(float((f.argmax(-1) == p.argmax(-1)).float().mean()))
        # the K5 route reproduces serve's own greedy tokens
        assert torch.equal(f.argmax(-1), toks[:, i]), i
    for e, s in zip(errs, scales):
        assert math.isfinite(e) and e < 0.05 * s, (errs, scales)
    # K5 on the plain route's own activations, each layer and step, within
    # the kernel's tolerances of the plain attention (no drift between)
    assert len(layer) == n_layers * (steps + 1), len(layer)
    assert all(r <= K5_ROW_REL[torch.bfloat16] for _, r in layer), layer
    # the logits before the lm head's rounding: the K5 route drifts from
    # the plain route at most twice as far as the plain route drifts from
    # itself in other chunks, in the worst and in the mean logit
    def drift(xs, ys):
        d = [(x - y).abs() for x, y in zip(xs, ys)]
        return max(float(t.max()) for t in d), \
            sum(float(t.mean()) for t in d) / len(d)
    k5_drift, ref_drift = drift(fast32, plain32), drift(again32, plain32)
    assert all(math.isfinite(a) and a <= 2 * b
               for a, b in zip(k5_drift, ref_drift)), (k5_drift, ref_drift)
    # Greedy tokens through either route are equal in every row where the
    # plain route's top two bf16 logits differ by more than one ulp; where
    # they lie within one, the drift above decides between them (for the
    # plain route in other chunks too) and the K5 route's token lies within
    # the plain route's own re-chunking drift of the top logit.
    tokens = _token_check(fast, plain, again)
    cmp = dict(max_abs_err=max(errs), err_by_step=errs, logit_scale=scales,
               greedy_agreement=agree, tokens=tokens,
               f32_logit_drift_k5=k5_drift,
               f32_logit_drift_plain_rechunked=ref_drift,
               layer_max_abs_err=max(a for a, _ in layer),
               layer_max_row_rel_err=max(r for _, r in layer))
    log(f"[{tag}] K5 route vs plain route, prefill + {steps} decode steps "
        f"(teacher-forced on serve's tokens): " + json.dumps(cmp))
    log(f"[{tag}] (a) {len(layer)} K5 calls beside the plain attention: "
        f"worst |K5 - plain| {cmp['layer_max_abs_err']:.3e} (<= "
        f"{K5_TOL[torch.bfloat16]}), worst row error "
        f"{cmp['layer_max_row_rel_err']:.3e} (<= "
        f"{K5_ROW_REL[torch.bfloat16]}); (b) f32 logit drift worst/mean: K5 "
        f"{k5_drift[0]:.4e}/{k5_drift[1]:.4e}, plain re-chunked "
        f"{ref_drift[0]:.4e}/{ref_drift[1]:.4e} (K5 <= 2x); (c) "
        f"{tokens['tie_rows']} tie rows of {tokens['rows']} (ruler "
        f"{tokens['tie_ruler']:.4e}), K5 flips "
        f"{len(tokens['k5_flips'])} ({tokens['k5_flips_at_ties']} at ties), "
        f"plain re-chunked flips {len(tokens['plain_rechunked_flips'])} "
        f"({tokens['plain_rechunked_flips_at_ties']} at ties); (d) the K5 "
        f"route reproduces serve's tokens")
    del fast, plain, again, fast32, plain32, again32
    return cmp


def _serve_cell(arch, kw, per_step_kernels, tag, cuts):
    """``repro_torch.serve(arch, **kw)`` at full width and depth: counts
    zeroed just before and read just after (K5 once a layer in each
    ``serve_step``, the prefill's and each decode step's kernels as
    ``per_step_kernels`` gives them; K1 0), walls and peak; then phase 16's
    token check (``_route_check``) on serve's tokens from serve's params
    (seed 0) and prompts (seed 1), prefill and 4 decode steps. Returns
    (row, check, the model, prompts, serve's tokens)."""
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ce_score import ce_score as k1k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.models.lm import LM
    cfg = get_config(arch)
    n_layers, b, gen = cfg.n_layers, kw["batch"], kw["gen"]
    log(f"[{tag}] repro_torch.serve({arch!r}, {kw}); "
        f"{cfg.param_count() / 1e9:.3f} B parameters by counting")
    log(f"[{tag}] {cuts}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per_step = []

    def count(real):
        def serve_step(self, *a, **kw):
            before = dict(k5.launches_by_kernel)
            out = real(self, *a, **kw)
            per_step.append({n: c - before[n]
                             for n, c in k5.launches_by_kernel.items()})
            return out
        return serve_step
    _k5_zero(k5)
    k1k4.ce_score_launches = 0
    t0 = time.perf_counter()
    with _swapped(LM, "serve_step", count):
        served = repro_torch.serve(arch, **kw)
    total = time.perf_counter() - t0
    launches, by_kernel = k5.launches, dict(k5.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert served["tokens"].shape == (b, gen)
    prefill, decode = per_step_kernels
    want = [_k5_counts(**{prefill: n_layers})] + \
        [_k5_counts(**{decode: n_layers})] * (gen - 1)
    assert per_step == want, per_step
    assert k1k4.ce_score_launches == 0
    row = dict(prefill_s=served["prefill_s"], decode_s=served["decode_s"],
               decode_ms_per_step=served["decode_s"] / (gen - 1) * 1e3,
               tok_per_s=served["tok_per_s"], peak_gib=peak, total_s=total,
               k5_launches=launches, k5_launches_by_kernel=by_kernel,
               k5_prefill=sum(per_step[0].values()),
               k5_decode=sum(sum(p.values()) for p in per_step[1:]),
               k1_launches=k1k4.ce_score_launches)
    log(f"[{tag}] " + json.dumps(row))
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg, "cuda")                           # serve's params (seed 0)
    g = torch.Generator().manual_seed(1)           # serve's prompts (seed 1)
    prompts = torch.randint(0, cfg.vocab_size, (b, kw["prompt_len"]),
                            generator=g).cuda()
    toks = torch.from_numpy(served["tokens"]).cuda()
    cmp = _route_check(lm, prompts, toks, 4, n_layers, tag)
    return row, cmp, lm, prompts, toks


def run_cell_c(out):
    """Phase 16: serving llama3.2-3b at full width and depth: the prefill
    takes the wgmma kernel in each layer, the 63 decode steps the mma.sync
    kernel with its kv split."""
    row, cmp, lm, prompts, toks = _serve_cell(
        "llama3.2-3b", SERVE, ("wgmma", "mma"), "cell C", SERVE_CUTS)
    cmp["profile"] = profile_serve(lm, prompts, toks, row, out)
    del lm, toks, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return row["k5_launches"], row, cmp


def run_cell_d():
    """Phase 17: scoring llama3.2-3b under the K1 route against "fused"."""
    k1, row = _score_run("llama3.2-3b", "cell D", N_LAYERS, "wgmma",
                         "cuts from prod: seq_len 4096 -> 1024, global_batch "
                         "256 -> 8 (the first batch of the synthetic source "
                         "scored once); width, depth and vocab are not cut")
    return k1, row


def _score_run(model, tag, n_layers, kernel, cuts, batch=8):
    """``repro_torch.score(model, preset="prod", ...)`` at (``batch``,
    1024) under ``imp.score_impl="pallas"``: counts zeroed just before and
    read just after (K1 once, K5 once a layer, all ``kernel``'s, K4 0),
    then the same call under ``"fused"``: losses and scores to 1e-4."""
    import repro_torch
    from repro_torch.kernels.ce_score import ce_score as k1k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    base = {"shape.seq_len": 1024, "shape.global_batch": batch,
            "obs.enabled": False}
    name = model if isinstance(model, str) else model.name
    log(f"[{tag}] repro_torch.score({name!r}, preset='prod', "
        f"overrides={dict(base, **{'imp.score_impl': 'pallas'})}); {cuts}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _k5_zero(k5)
    k1k4.ce_score_launches = k1k4.launches = 0
    t0 = time.perf_counter()
    loss, sc = repro_torch.score(model, preset="prod", overrides=dict(
        base, **{"imp.score_impl": "pallas"}))
    wall = time.perf_counter() - t0
    k1, k5n = k1k4.ce_score_launches, k5.launches
    k5_by = dict(k5.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert (k1, k5n, k1k4.launches) == (1, n_layers, 0), (k1, k5n)
    assert k5_by == _k5_counts(**{kernel: n_layers}), k5_by
    gc.collect()
    torch.cuda.empty_cache()
    loss_f, sc_f = repro_torch.score(model, preset="prod",
                                     overrides=dict(
                                         base, **{"imp.score_impl": "fused"}))
    assert loss.shape == sc.shape == (batch,)
    assert np.isfinite(loss).all() and np.isfinite(sc).all()
    np.testing.assert_allclose(loss, loss_f, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sc, sc_f, rtol=1e-4, atol=1e-4)
    row = dict(k1_launches=k1, k5_launches=k5n,
               k5_launches_by_kernel=k5_by, wall_s=wall, peak_gib=peak,
               loss=loss.tolist(), score=sc.tolist(),
               max_loss_diff_vs_fused=float(np.abs(loss - loss_f).max()),
               max_score_diff_vs_fused=float(np.abs(sc - sc_f).max()))
    log(f"[{tag}] " + json.dumps(row) + " (against 'fused': rtol = atol "
        "1e-4)")
    gc.collect()
    torch.cuda.empty_cache()
    return k1, row


DEVICE_TIMED = ("device time: CUDA events around calls queued behind a spin "
                "kernel (_device_ms)")


def _device_ms(fn, n):
    """Device time per call of ``fn``, for calls shorter than the host's
    dispatch of them, where CUDA events around a loop time the host. A
    spin kernel (``torch.cuda._sleep``) holds the card while the host
    queues n calls between two CUDA events, so the card runs them back to
    back. The start event must still be pending when the last call is
    queued: else the spin was too short or the launch queue filled, and
    the loop is taken again with a spin four times as long and half the
    calls, up to three times in all; a call that waits for the card (a
    read to the host) cannot be timed so. Not ``torch.profiler``: its windows on an
    H100 80GB HBM3 lose the records of some launches (171 of 200 recorded,
    73 of 100, 23 of 50, 16 of 20, also after a warm-up step)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    for attempt in range(3):
        torch.cuda._sleep(int(spin_s * 2e9))    # cycles; the clock <= 2 GHz
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
        log(f"[timing] the card reached the first of {n} calls before the "
            f"host had queued them all (spin {spin_s * 1e3:.1f} ms): taken "
            f"again")
        spin_s, n = 4 * spin_s, max(1, n // 2)
    raise RuntimeError("the host could not queue the calls ahead of the card")


def _bound(n_bytes, n_ops, flops_per_s):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def _sdpa(q, k, v, causal):
    """``scaled_dot_product_attention`` on the kernel's inputs, a yardstick
    the port never calls. Returns the timed call with k and v already
    expanded to q's heads (the expansion, outside the timing, lets it take
    its fused backends; what it times is the attention alone)."""
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qt, kt, vt, is_causal=causal)


def _sdpa_backends(q, k, v, causal):
    """``_sdpa`` under each of SDPA's fused backends that takes these
    inputs on this card (``torch.nn.attention.sdpa_kernel``): name -> the
    timed call. A backend that refuses them is logged and left out."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    f = _sdpa(q, k, v, causal)
    runs = {}
    for name, be in (("flash", SDPBackend.FLASH_ATTENTION),
                     ("cudnn", SDPBackend.CUDNN_ATTENTION),
                     ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        def run(be=be):
            with sdpa_kernel(be):
                return f()
        try:
            run()
            torch.cuda.synchronize()
        except RuntimeError as e:
            log(f"[timing] SDPA backend {name} does not run here: "
                f"{str(e).splitlines()[0][:120]}")
            continue
        runs[name] = run
    return runs


def _off_tma(t):
    """A copy of ``t`` whose base sits two elements (4 bytes in bf16, 8 in
    f32) off a 16-byte boundary: TMA and the f32 kernel refuse it, so the
    dispatch rule sends the call to the mma.sync kernel, which takes it
    (both kernels timed on the same values)."""
    buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
    return buf[2:].view(t.shape).copy_(t)


def _time_k5_f32(gen):
    """Phase 18a's f32 row: the f32 kernel at cell I's pool scoring
    (lm-100m: the (12, 1024) pool, 10/5 heads of 64, causal; 12 launches a
    step), by CUDA events (the median of 3 rounds of 20 calls, in turns
    with the mma.sync path's plain FMA on the same values through an
    off-16-byte copy of q, and SDPA under each backend that takes f32),
    beside its plain version and its bound (operations at the f32 rate
    outside the tensor cores: both kernels compute in plain f32 FMA)."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.flash_attn.ops import flash_attention
    b, s, hq, hkv, hd = 12, 1024, 10, 5, 64
    q, k, v = _k5_inputs(b, s, s, hq, hkv, hd, torch.float32, gen)
    qm = _off_tma(q)
    assert k5.plan(q, k, v) == "f32" and k5.plan(qm, k, v) == "mma"
    runs = {"f32": lambda: flash_attention(q, k, v),
            "mma": lambda: flash_attention(qm, k, v),
            "sdpa": _sdpa(q, k, v, True),
            **{f"sdpa {n}": f for n, f in
               _sdpa_backends(q, k, v, True).items()}}
    ev = {key: [] for key in runs}
    for r in range(3):
        for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            ev[key].append(_time(runs[key], 20))
    med = {key: sorted(ts)[1] for key, ts in ev.items()}
    n_ops = _attn_flops(b, hq, hd, s, s, 0)
    n_bytes = 4 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    bound_ms, by = _bound(n_bytes, n_ops, F32_FLOPS_PER_S)
    by_backend = {key[5:]: t for key, t in med.items()
                  if key.startswith("sdpa ")}
    ms, mma_ms = med["f32"], med["mma"]
    row = dict(
        shape=f"q ({b},{s},{hq},{hd}), kv ({b},{s},{hkv},{hd}) f32, causal "
              f"(cell I's pool scoring, 12 launches a step)",
        kernel="f32", ms=ms, mma_ms=mma_ms, rounds_ms=ev,
        plain_ms=_time(lambda: _k5_plain(q, k, v), 2),
        library_ms=med["sdpa"], library_ms_by_backend=by_backend,
        bound_ms=bound_ms, bound_by=by, flop=n_ops,
        share_of_bound=bound_ms / ms, mma_share_of_bound=bound_ms / mma_ms,
        tflops=n_ops / (ms * 1e-3) / 1e12,
        mma_tflops=n_ops / (mma_ms * 1e-3) / 1e12,
        sdpa_tflops={n: n_ops / (t * 1e-3) / 1e12
                     for n, t in by_backend.items()},
        timed_by="CUDA events, the median of 3 rounds of 20 calls, in turns")
    assert ms < mma_ms, (ms, mma_ms)
    log(f"[timing] K5 f32: the f32 kernel {ms:.4f} ms ({row['tflops']:.1f} "
        f"TFLOP/s, {row['share_of_bound']:.3f} of the {bound_ms:.4f} ms "
        f"bound), the mma.sync path on the same values {mma_ms:.4f} ms "
        f"({row['mma_tflops']:.1f} TFLOP/s, {row['mma_share_of_bound']:.3f})"
        f"; SDPA by backend {by_backend}")
    del q, qm, k, v, runs
    torch.cuda.empty_cache()
    return row


def time_k5(gen):
    """Phase 18a: K5 per launch at cell C's prefill, cell D's score and
    cells A/E's pool (the wgmma kernel, and the mma.sync kernel on the same
    values beside it), and at cell C's mean decode shape (mma)."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.flash_attn.ops import flash_attention
    P, cap = SERVE["prompt_len"], SERVE["prompt_len"] + SERVE["gen"]
    hq, hkv, hd = 24, 8, 128
    res = {}
    # causal; at cell C's prefill k and v are the prompt's prefix view of
    # the cache, as serving passes them
    for name, b, sq, slots in (("prefill", 8, P, cap),
                               ("score (8, 1024)", 8, 1024, 0),
                               ("pool (12, 1024)", 12, 1024, 0)):
        q, k, v = _k5_inputs(b, sq, sq, hq, hkv, hd, torch.bfloat16, gen,
                             slots=slots)
        qm = _off_tma(q)
        assert k5.plan(q, k, v) == "wgmma" and k5.plan(qm, k, v) == "mma"
        runs = {"wgmma": lambda: flash_attention(q, k, v),
                "mma": lambda: flash_attention(qm, k, v),
                "sdpa": _sdpa(q, k, v, True),
                **{f"sdpa {n}": f for n, f in
                   _sdpa_backends(q, k, v, True).items()}}
        # CUDA events around a loop (20 calls at the prefill, 50 at 1024
        # keys), three rounds in turns, the order reversed every other
        # round; each entry's median round
        n_launch = 20 if sq > 2048 else 50
        ev = {key: [] for key in runs}
        for r in range(3):
            for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                ev[key].append(_time(runs[key], n_launch))
        med = {key: sorted(ts)[1] for key, ts in ev.items()}
        ms, mma_ms, lib_ms = med["wgmma"], med["mma"], med["sdpa"]
        by_backend = {key[5:]: t for key, t in med.items()
                      if key.startswith("sdpa ")}
        plain_ms = _time(lambda: _k5_plain(q, k, v), 2)
        pairs = sq * (sq + 1) // 2                 # unmasked (q, k) pairs
        n_ops = 4 * b * hq * hd * pairs
        n_bytes = 2 * (2 * b * sq * hq * hd + 2 * b * sq * hkv * hd)
        bound_ms, by = _bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
        res[name] = dict(
            shape=f"q ({b},{sq},24,128), kv ({b},{sq},8,128)"
                  + (f" of a {slots}-slot cache" if slots else "")
                  + " bf16, causal",
            kernel="wgmma", ms=ms, mma_ms=mma_ms, rounds_ms=ev,
            plain_ms=plain_ms, library_ms=lib_ms,
            library_ms_by_backend=by_backend, bound_ms=bound_ms, bound_by=by,
            tflops=n_ops / (ms * 1e-3) / 1e12,
            sdpa_tflops={n: n_ops / (t * 1e-3) / 1e12
                         for n, t in by_backend.items()},
            timed_by=f"CUDA events, the median of 3 rounds of {n_launch} "
                     "calls, in turns")
        del q, qm, k, v, runs
        torch.cuda.empty_cache()
    # decode: one query at the cache's mean fill, over the cache prefix.
    # A launch takes less device time than the host needs to issue it, so
    # CUDA events around a loop of them time the host: the kernel, its
    # plain version and the library call are timed by their device time
    # (``_device_ms``; the unqueued loop's event time kept beside)
    off = P + SERVE["gen"] // 2 - 1
    q, k, v = _k5_inputs(8, 1, off + 1, hq, hkv, hd, torch.bfloat16, gen,
                         slots=cap)
    assert k5.plan(q, k, v) == "mma"
    sdpa = _sdpa(q, k, v, False)
    ms = _device_ms(lambda: flash_attention(q, k, v, q_offset=off), 50)
    plain_ms = _device_ms(lambda: _k5_plain(q, k, v, rows=8, q_offset=off),
                          10)
    lib_ms = _device_ms(sdpa, 50)
    loop_ms = _time(lambda: flash_attention(q, k, v, q_offset=off), 100)
    n_ops = 4 * 8 * hq * hd * (off + 1)
    n_bytes = 2 * (2 * 8 * hq * hd + 2 * 8 * (off + 1) * hkv * hd)
    bound_ms, by = _bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
    res["decode"] = dict(shape=f"q (8,1,24,128) at {off}, kv (8,{off + 1},"
                               f"8,128) of a {cap}-slot cache, bf16",
                         kernel="mma", ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         tb_per_s=n_bytes / (ms * 1e-3) / 1e12,
                         timed_by=DEVICE_TIMED,
                         event_loop_ms=loop_ms)
    del q, k, v, sdpa
    torch.cuda.empty_cache()
    res["f32 pool (12, 1024)"] = _time_k5_f32(gen)
    for name, r in res.items():
        extra = ""
        if "tflops" in r:
            extra = (f"; {r['tflops']:.1f} TFLOP/s (rounds "
                     f"{[round(t, 4) for t in r['rounds_ms'][r['kernel']]]})"
                     + (f"; the mma kernel on the same values "
                        f"{r['mma_ms']:.4f} ms" if "mma_ms" in r else "")
                     + "; SDPA by backend "
                     + ", ".join(f"{n} {t:.4f} ms ({r['sdpa_tflops'][n]:.1f}"
                                 f" TFLOP/s)" for n, t in
                                 r["library_ms_by_backend"].items()))
        log(f"[timing] K5 {name} {r['shape']}: {r['kernel']} kernel "
            f"{r['ms']:.4f} ms/launch, plain {r['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); timed by "
            f"{r['timed_by']}" + extra
            + (f" (CUDA events around a loop of launches: "
               f"{r['event_loop_ms']:.4f} ms each)"
               if "event_loop_ms" in r else ""))
    return res


def time_k1(gen):
    """Phase 18b: K1 at cell D's shape."""
    from repro_torch.kernels.ce_score.ops import ce_score
    from repro_torch.kernels.ce_score.ref import ce_score_ref
    T, V = 8 * 1024, 128256
    z = torch.randn((T, V), generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randint(0, V, (T,), generator=gen, device="cuda",
                      dtype=torch.int32)
    ms = _time(lambda: ce_score(z, y), 20)
    plain_ms = _time(lambda: ce_score_ref(z, y), 3)
    # every logit read once, labels read, two f32 outputs written; ~8 f32
    # ops a logit outside the tensor cores
    n_bytes = T * V * 2 + T * 4 + 2 * T * 4
    bound_ms, by = _bound(n_bytes, 8 * T * V, F32_FLOPS_PER_S)
    log(f"[timing] K1 ({T}, {V}) bf16: {ms:.4f} ms/launch, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
        f"{n_bytes / 1e9:.3f} GB), {n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s "
        f"achieved; no single PyTorch call computes it")
    del z, y
    torch.cuda.empty_cache()
    return ms, plain_ms, bound_ms, by


# ---------------------------------------------------------------------------
# slice 4: Algorithm 1 on the device, the fused presample op, K2 and K3
# ---------------------------------------------------------------------------
def _fused_pool(gen, pad_frac=0.1):
    """Cell E's pool shape: seeded bf16 logits whose rows differ in scale,
    labels with ``pad_frac`` unsupervised, and the rows to gather."""
    B, T, V = POOL
    z = torch.empty((B, T, V), dtype=torch.bfloat16, device="cuda")
    for r, sc in enumerate(torch.linspace(0.5, 4.0, B).tolist()):
        z[r] = torch.randn((T, V), generator=gen, device="cuda").mul_(sc)
    y = torch.randint(0, V, (B, T), generator=gen, device="cuda",
                      dtype=torch.int32)
    y[torch.rand((B, T), generator=gen, device="cuda") < pad_frac] = -1
    toks = torch.randint(0, V, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)
    return z, y, {"tokens": toks, "labels": y}


def _bits(t):
    """A tensor's bits, to compare two launches bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _pool_select_stages(out, ctx, k):
    """Each output of one ``pool_select`` launch against the plain version
    fed the kernel's own earlier outputs: 1/Σs within 1e-6 (Σs in another
    order); keys bitwise ``pool_keys_plain`` on the kernel's scores and
    1/Σs; idx and thr ``_bottom_k`` of its own keys; probs and w within
    1e-6 of ``ht_weights`` on its idx and thr. Returns the worst relative
    error of 1/Σs, probs and w."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.topk_keys.ops import _bottom_k
    s, inv_total, keys, idx, probs, w, thr = out
    B = s.shape[0]
    total = torch.clamp(s.sum(), min=1e-20)
    assert torch.equal(keys, fp.pool_keys_plain(s, ctx, inv_total))
    if k < B:
        vals, slots = _bottom_k(keys, k + 1)
        assert torch.equal(idx, slots[:k]) and torch.equal(thr, vals[k])
        want = fp.ht_weights(s, total, idx, thr)
    else:
        assert torch.equal(idx, torch.arange(B, device=s.device))
        assert float(thr) == float("inf")
        want = s / total, torch.full_like(s, 1.0 / max(B, 1))
    rel = 0.0
    for a, b in zip((inv_total, probs, w),
                    ((1.0 / total).reshape(1), *want)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        fin = torch.isfinite(b) & (b != 0)
        if bool(fin.any()):
            rel = max(rel, float(((a - b)[fin].abs() / b[fin].abs()).max()))
    return rel


def check_pool_select(gen):
    """Phase 19. Returns the worst errors and what the fused op gave."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.fused_presample.ops import (fused_presample,
                                                         select_pool)
    from repro_torch.kernels.fused_presample.ref import (fused_presample_ref,
                                                         select_pool_ref)
    from repro_torch.sampler.selection import hash_context
    res = {"k2_max_abs_err": 0.0, "k2_max_rel_err": 0.0,
           "k3_max_abs_err": 0.0, "k3_bitwise": True,
           "select_max_rel_err": 0.0, "two_launches_same_bits": True}
    for B, T in ((12, 1024), (768, 4096), (37, 13), (70000, 8)):
        g2 = torch.rand((B, T), generator=gen, device="cuda").mul_(2.0)
        mask = torch.rand((B, T), generator=gen, device="cuda") >= 0.2
        want = fp.row_score_math(g2, mask)
        ks = sorted({1, B // 4, B - 1, B})
        for k in ks:
            for ctx in (0, 0xFFFFFFFF):
                out = fp.pool_select_cuda(g2, mask, ctx, k)
                again = fp.pool_select_cuda(g2, mask, ctx, k)
                torch.cuda.synchronize()
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(out, again)), (B, T, k, ctx)
                got = out[0]
                torch.testing.assert_close(got, want, rtol=K2_RTOL, atol=0)
                res["k2_max_rel_err"] = max(
                    res["k2_max_rel_err"],
                    float(((got - want).abs() / want).max()))
                res["k2_max_abs_err"] = max(res["k2_max_abs_err"],
                                            float((got - want).abs().max()))
                res["select_max_rel_err"] = max(
                    res["select_max_rel_err"],
                    _pool_select_stages(out, ctx, k))
        log(f"[pool_select] ({B}, {T}), 20 % masked, k {ks}, ctx 0 and "
            f"2^32-1: scores within {res['k2_max_rel_err']:.3e} of "
            f"row_score_math (rtol {K2_RTOL}); keys bitwise pool_keys_plain "
            f"on the kernel's scores and 1/sum; idx and thr = _bottom_k of "
            f"its keys; two launches the same bits")
    # the scores given (select_pool's launch), a -1 pad lane
    for B in (12, 100, 768, 1024):
        for ctx in (0, 0xFFFFFFFF):
            s = torch.rand(B, generator=gen, device="cuda").mul_(5.0) \
                .add_(0.01)
            s[B // 2] = -1.0
            k = B // 4
            out = fp.pool_select_scores_cuda(s, ctx, k)
            res["select_max_rel_err"] = max(res["select_max_rel_err"],
                                            _pool_select_stages(out, ctx, k))
            got, want = select_pool(s, ctx, k=k), select_pool_ref(s, ctx,
                                                                  k=k)
            assert torch.equal(got[0], want[0]), (B, ctx)
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    # 70 of 100 rows padded and k + 1 above the 30 live ones: +inf ties,
    # won by the lowest pad rows in row order
    s = torch.rand(100, generator=gen, device="cuda").mul_(5.0).add_(5.0)
    pads = torch.randperm(100, generator=gen, device="cuda")[:70].sort()[0]
    s[pads] = -1.0
    out = fp.pool_select_scores_cuda(s, 4211, 50)
    _pool_select_stages(out, 4211, 50)
    assert float(out[6]) == float("inf")
    assert torch.equal(out[3][30:], pads[:20])
    log("[pool_select] scores given, B = 12, 100, 768, 1024, a -1 pad lane: "
        "keys bitwise, select_pool = select_pool_ref; 70 pads of 100 with "
        "k + 1 = 51: +inf ties won by the lowest pad rows; probs, weights, "
        f"1/sum and thr within {res['select_max_rel_err']:.3e} of the plain "
        "version on the kernel's scores")
    # the whole op at cell E's pool, against the unfused plain composition
    B, T, V = POOL
    k = BATCH
    z, y, rows = _fused_pool(gen)
    ctx = hash_context(0, 4211, 21)
    sel, idx, w, sc = fused_presample(z, y, rows, ctx, k=k)
    sel_r, idx_r, w_r, sc_r = fused_presample_ref(z, y, rows, ctx, k=k)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_r), (idx, idx_r)
    for name in rows:
        assert torch.equal(sel[name], sel_r[name]), name
        assert torch.equal(sel[name], rows[name][idx]), name
    torch.testing.assert_close(w, w_r, rtol=1e-5, atol=0)
    torch.testing.assert_close(sc, sc_r, rtol=1e-5, atol=1e-6)
    # the selection stage alone on the op's scores: the same winners
    got, want = select_pool(sc, ctx, k=k), select_pool_ref(sc, ctx, k=k)
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    res.update(
        op_idx=idx.tolist(),
        op_score_max_rel_err=float(((sc - sc_r).abs() / sc_r).max()),
        op_weight_max_rel_err=float(((w - w_r).abs() / w_r).max()))
    log(f"[fused op] ({B}, {T}, {V}) bf16, k {k}: indices {idx.tolist()} = "
        f"plain composition's, gathered rows equal; scores within "
        f"{res['op_score_max_rel_err']:.3e}, weights within "
        f"{res['op_weight_max_rel_err']:.3e} (relative, <= 1e-5); "
        f"select_pool on the op's scores = select_pool_ref's")
    del z, y, rows, sel, sel_r
    gc.collect()
    torch.cuda.empty_cache()
    return res


def check_presample_lm_tiny():
    """Phase 20: the ``presample`` step kind at lm-tiny on the card and on
    the CPU from the same params, never and always taking the IS branch.
    The IS branch's draw is replaced, for this check only, by one seeded
    numpy table both runs read in turn (torch's CUDA and CPU generators
    give other numbers from one seed)."""
    from repro_torch.api import Experiment, build_run
    from repro_torch.checkpoint import interop
    from repro_torch.core import importance
    from repro_torch.kernels.flash_attn import flash_attn as k5
    steps = 4
    run = build_run("lm-tiny", preset="smoke", overrides={
        "shape.seq_len": 64, "shape.global_batch": 4, "steps": steps,
        "obs.enabled": False})
    b = run.shape.global_batch
    table = np.random.default_rng(0).integers(
        0, b * run.imp.presample_ratio, (steps, b))
    calls = {}

    def shared_draw(generator, g, n):   # each run has its own generator
        i = calls[id(generator)] = calls.get(id(generator), -1) + 1
        return torch.from_numpy(table[i, :n]).to(g.device)
    real = importance.sample_with_replacement
    res = {}
    for gate in ("never", "always"):
        calls.clear()
        if gate == "always":
            importance.sample_with_replacement = shared_draw
        try:
            gpu = Experiment(run, gate=gate)
            cpu = Experiment(run, device="cpu", gate=gate)
            interop.load_params(cpu.lm, interop.params_to_numpy(gpu.lm))
            before = k5.launches
            _, hg = gpu.fit()
            launched = k5.launches - before
            _, hc = cpu.fit()
        finally:
            importance.sample_with_replacement = real
        for a, c in zip(hg, hc):
            assert math.isfinite(a["loss"])
            assert abs(a["loss"] - c["loss"]) < 1e-3, (a["loss"], c["loss"])
            assert a["is_active"] == c["is_active"] == float(
                gate == "always")
            assert abs(a["tau"] - c["tau"]) < 1e-3, (a["tau"], c["tau"])
        # every step of each run drew once from the shared table
        assert sorted(calls.values()) == ([steps - 1] * 2 if gate == "always"
                                          else []), calls
        torch.testing.assert_close(
            torch.from_numpy(gpu.sampler.store.scores),
            torch.from_numpy(cpu.sampler.store.scores), rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(gpu.sampler.store.seen,
                                      cpu.sampler.store.seen)
        # the IS branch scores its pool forward-only: K5 in every layer
        n_layers = gpu.run.model.segments[0].repeats
        assert launched == (n_layers * steps if gate == "always" else 0), \
            launched
        res[gate] = dict(gpu_loss=[h["loss"] for h in hg],
                         cpu_loss=[h["loss"] for h in hc], k5=launched)
        log(f"[presample lm-tiny] gate {gate}: gpu losses "
            f"{[round(h['loss'], 5) for h in hg]} = cpu "
            f"{[round(h['loss'], 5) for h in hc]} (to 1e-3); τ̂ "
            f"{[round(h['tau'], 4) for h in hg]}; stored scores equal to "
            f"1e-3; K5 launches {launched}")
    return res


CELL_E = {"imp.presample_impl": "step", "shape.global_batch": BATCH,
          "shape.seq_len": 1024, "steps": STEPS, "obs.enabled": False}
CELL_E_CUTS = (
    "cuts from prod: seq_len 4096 -> 1024; global_batch 256 -> "
    f"{BATCH} (pool {3 * BATCH}); steps 1000 -> {STEPS}; presample fused + "
    "conservative pruning -> the in-step presample kind (the slice's point)"
    ", gate='always' so every step takes the IS branch; telemetry on -> "
    "off (the registry is read for the plane.* stage times, no sink); "
    "checkpointing on -> none. The data plane is prod's (depth 2, "
    "device-put on its own stream). Width, depth (28 layers) and vocab are "
    "not cut.")


def run_cell_e(out):
    """Phase 21: Algorithm 1 inside the step at llama3.2-3b full width
    (step ``PROFILED`` under ``torch.profiler``, its table to
    ``chiprun_out/profile_cell_e.txt``), then the fused device op on a
    fresh pool from the final params."""
    import repro_torch
    from repro_torch import obs
    from repro_torch.api import Hook
    from repro_torch.core import importance
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels.ce_score import ce_score as k1k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.fused_presample.ops import fused_presample
    from repro_torch.kernels.topk_keys import topk_keys as k6
    from repro_torch.sampler import selection
    from torch.profiler import ProfilerActivity, profile
    log(f"[cell E] repro_torch.train('llama3.2-3b', preset='prod', "
        f"overrides={CELL_E}, gate='always')")
    log(f"[cell E] {CELL_E_CUTS}")
    weights = []
    real_w = importance.unbiased_weights

    def record_weights(g, idx):      # observes the step's weights, as is
        w = real_w(g, idx)
        weights.append(w)
        return w

    class StepLog(Hook):
        def __init__(self):
            self.rows = []
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])

        def on_loop_start(self, loop, start, steps):
            obs.enable(True)
            obs.reset()
            self.plane0 = _plane_snapshot()

        def on_step_start(self, loop, step, b, meta):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.gids = [int(g) for g in meta.gids]
            if step == PROFILED:
                self.prof.start()
            self.t0 = time.perf_counter()

        def on_step_end(self, loop, step, m):
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            if step == PROFILED:
                self.prof.stop()
            w = weights[-1]
            now = _plane_snapshot()
            plane = {k: now[k] - self.plane0[k] for k in now}
            self.plane0 = now
            row = dict(step=step, loss=m["loss"], tau=m["tau"],
                       attempts=m["attempts"], plane=plane,
                       is_active=m["is_active"], w_min=float(w.min()),
                       w_max=float(w.max()), step_s=wall,
                       profiled=step == PROFILED,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            self.rows.append(row)
            log("[cell E] " + json.dumps(row))

        def on_loop_end(self, loop, state, history):
            self.exp = loop.exp
            obs.enable(False)
            obs.reset()

    hook = StepLog()
    gc.collect()
    torch.cuda.empty_cache()
    importance.unbiased_weights = record_weights
    counters = ((k1k4, "ce_score_launches"), (k1k4, "launches"),
                (k5, "launches"), (k6, "launches"),
                (fp, "pool_select_launches"))
    try:
        for mod, name in counters:
            setattr(mod, name, 0)
        _k5_zero(k5)
        t0 = time.perf_counter()
        _, history = repro_torch.train("llama3.2-3b", preset="prod",
                                       overrides=CELL_E, gate="always",
                                       hooks=[hook])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        k1, k4, k5n, k6n, ps = (getattr(m, n) for m, n in counters)
        k5_by = dict(k5.launches_by_kernel)
    finally:
        importance.unbiased_weights = real_w
    log(f"[cell E] {STEPS} steps in {total:.1f} s (model build included); "
        f"K5 {k5n} ({k5n / STEPS:g} a step, the IS branch's scoring "
        f"forward; by kernel {k5_by}), K1 {k1}, pool_select (K2/K3) {ps}, "
        f"K4 {k4}, K6 {k6n} (not on this path)")
    assert len(history) == STEPS
    assert all(math.isfinite(h["loss"]) for h in history), history
    assert all(h["is_active"] == 1.0 for h in history), history
    assert k5n == N_LAYERS * STEPS, k5n
    assert k5_by == _k5_counts(wgmma=N_LAYERS * STEPS), k5_by
    assert (k1, ps, k4, k6n) == (0, 0, 0, 0)
    for r in hook.rows:
        assert math.isfinite(r["w_min"]) and r["w_min"] > 0, r
    breakdown = step_breakdown(hook.prof, hook.rows, out, "profile E",
                               "profile_cell_e")
    # the pool of step PROFILED + 2 is planned, gathered and uploaded as
    # step PROFILED's batch leaves the plane, which may be just before the
    # profiler starts: its upload is logged, and held off the compute
    # stream where the window caught it
    streams = _h2d_streams(hook.prof, "cell_e")
    log(f"[profile E] profiled step's host-to-card copies: {streams} (the "
        f"parent's synchronous plane: steps {PARENT_STEP_S['cell E']} s, "
        "PERF.md §5)")
    assert not set(streams["pool_h2d_streams"]) & set(
        streams["compute_streams"]), streams
    breakdown = dict(breakdown or {}, h2d_streams=streams)
    exp = hook.exp
    del history
    gc.collect()
    torch.cuda.empty_cache()
    # the fused device op on the next pool, from the trained params
    B, T, V = POOL
    pool = to_device(exp.source.gather(np.arange(B * STEPS, B * (STEPS + 1)),
                                       epoch=0), "cuda")
    ctx = selection.hash_context(exp.run.seed, 4211, STEPS)
    with torch.inference_mode():
        logits = exp.lm(pool)
        for mod, name in counters:
            setattr(mod, name, 0)
        sel, idx, w, sc = fused_presample(logits, pool["labels"], pool, ctx,
                                          k=BATCH)
        torch.cuda.synchronize()
        op = dict(k1=k1k4.ce_score_launches,
                  pool_select=fp.pool_select_launches, k4=k1k4.launches)
        del logits
        _, want = exp.lm.sample_stats(pool, score_impl=exp.run.imp.score_impl)
    assert (op["k1"], op["pool_select"], op["k4"]) == (1, 1, 0), op
    rel = float(((sc - want).abs() / want).max())
    assert rel < 1e-4, rel
    host_idx, _, host_w, _ = selection.presample_race_select(
        sc.cpu().numpy(), BATCH, ctx=ctx)
    assert set(idx.tolist()) == set(host_idx.tolist()), (idx, host_idx)
    for name, v in pool.items():
        assert torch.equal(sel[name], v[idx]), name
    op.update(idx=idx.tolist(), host_idx=host_idx.tolist(),
              score_max_rel_err_vs_sample_stats=rel,
              weights=w.tolist(), host_weights=list(map(float, host_w)))
    log(f"[cell E] fused_presample on the next pool's logits "
        f"({B}, {T}, {V}) from the final params: K1 {op['k1']}, "
        f"pool_select {op['pool_select']}; scores within {rel:.3e} of "
        f"sample_stats "
        f"(< 1e-4); candidates {sorted(idx.tolist())} = the host float64 "
        f"race's; gathered rows = the pool's rows at idx")
    # K5's divergence by design in training use (measured, decides
    # nothing): the same pool scored through the plain attention (given
    # positions take the plain paths), the scores' worst relative error,
    # and the draw's candidate set fed the same uniforms (same ctx)
    positions = torch.arange(T, device="cuda")[None].expand(B, T)
    _, plain = exp.lm.sample_stats({**pool, "positions": positions},
                                   score_impl=exp.run.imp.score_impl)
    k5_vs_plain = float(((want - plain).abs() / plain).max())
    plain_idx = selection.presample_race_select(plain.cpu().numpy(), BATCH,
                                                ctx=ctx)[0]
    k5_idx = selection.presample_race_select(want.cpu().numpy(), BATCH,
                                             ctx=ctx)[0]
    op.update(k5_vs_plain_score_max_rel_err=k5_vs_plain,
              k5_route_candidates=sorted(k5_idx.tolist()),
              plain_route_candidates=sorted(plain_idx.tolist()),
              candidates_equal=set(k5_idx.tolist()) == set(plain_idx.tolist()))
    log(f"[cell E] K5 route vs plain attention on the pool (measured, no "
        f"gate): scores' worst relative error {k5_vs_plain:.3e}; candidates "
        f"{op['k5_route_candidates']} vs {op['plain_route_candidates']} "
        f"(equal: {op['candidates_equal']})")
    del exp, hook.exp, pool, sel, want, plain
    gc.collect()
    torch.cuda.empty_cache()
    return hook.rows, op, total, breakdown, k5_by


def time_pool_select(gen):
    """Phase 22: the pool_select launch at cell E's and prod's pools,
    select_pool and the fused op per call, beside their plain versions and
    bounds, and the one-launch floor. A pool_select launch takes less
    device time than the host needs to issue it, so its time is its device
    time (``_device_ms``; CUDA events around an unqueued loop of calls kept
    beside). The plain selections wait for the card inside a call, so they
    cannot be queued ahead of it: they, and the fused op, by CUDA events."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.fused_presample.ops import (fused_presample,
                                                         select_pool)
    from repro_torch.kernels.fused_presample.ref import (fused_presample_ref,
                                                         select_pool_ref)
    res = {}
    # the floor under any one launch: a one-element zero_() (a fill kernel)
    one = torch.zeros((1,), device="cuda")
    res["launch floor: one-element zero_()"] = dict(
        ms=_device_ms(one.zero_, 200), event_loop_ms=_time(one.zero_, 200),
        bound_ms=_bound(4, 0, F32_FLOPS_PER_S)[0], bound_by="bytes")
    for B, T, k in ((POOL[0], POOL[1], BATCH), (768, 4096, 256)):
        # enough copies of the inputs to fill the 50 MB L2 cache 2.5 times,
        # called in turn: each launch reads its inputs from HBM (one set,
        # called again and again, is read from L2, faster than the bound)
        n_sets = max(2, -(-125_000_000 // (B * T * 5)))
        sets = [(torch.rand((B, T), generator=gen, device="cuda").mul_(2.0),
                 torch.rand((B, T), generator=gen, device="cuda") >= 0.2)
                for _ in range(n_sets)]
        turn = iter(range(10 ** 9))
        kern = lambda: fp.pool_select_cuda(*sets[next(turn) % n_sets], 77, k)
        plain = lambda: fp.pool_select_plain(*sets[next(turn) % n_sets], 77,
                                             k)
        warm = lambda: fp.pool_select_cuda(*sets[0], 77, k)
        # g2 (4 B) and the mask byte read once a token; the scores and keys
        # (B each), the k winners' idx (8 B), probs and w, 1/sum and thr
        # written; a multiply-add a token, ~40 f32 ops a row for the key
        bound_ms, by = _bound(B * T * 5 + B * 8 + k * 16 + 8,
                              2 * B * T + 40 * B, F32_FLOPS_PER_S)
        res[f"pool_select ({B}, {T}) k {k}"] = dict(
            ms=_device_ms(kern, 200), plain_ms=_time(plain, 50),
            l2_warm_ms=_device_ms(warm, 200), event_loop_ms=_time(kern, 200),
            bound_ms=bound_ms, bound_by=by)
        del sets
    B, T, V = POOL
    k = BATCH
    z, y, rows = _fused_pool(gen)
    ctx = 12345
    sc = fused_presample(z, y, rows, ctx, k=k)[3]
    sk, sp = (lambda: select_pool(sc, ctx, k=k)), \
        (lambda: select_pool_ref(sc, ctx, k=k))
    # the scores read; the keys, the k winners' idx, probs, w, 1/sum and
    # thr written; ~40 f32 ops a row
    bound_ms, by = _bound(B * 8 + k * 16 + 8, 40 * B, F32_FLOPS_PER_S)
    res[f"select_pool ({B},) k {k}"] = dict(
        ms=_device_ms(sk, 100), plain_ms=_time(sp, 50),
        event_loop_ms=_time(sk, 100), bound_ms=bound_ms, bound_by=by)
    fk = lambda: fused_presample(z, y, rows, ctx, k=k)
    fpl = lambda: fused_presample_ref(z, y, rows, ctx, k=k)
    # the logits read once (K1), labels, the k winning rows read and
    # written, the scores, indices and weights; ~8 f32 ops a logit
    row_bytes = sum(v[0].numel() * v.element_size() for v in rows.values())
    n_bytes = z.numel() * 2 + B * T * 4 + 2 * k * row_bytes + B * 4 + k * 12
    bound_ms, by = _bound(n_bytes, 8 * B * T * V, F32_FLOPS_PER_S)
    # the op and its K1 stage by CUDA events only: a launch here is far
    # longer than its dispatch
    res[f"fused_presample ({B}, {T}, {V}) bf16 k {k}"] = dict(
        ms=_time(fk, 20), plain_ms=_time(fpl, 3), bound_ms=bound_ms,
        bound_by=by)
    from repro_torch.kernels.ce_score.ops import ce_score
    zf, yf = z.reshape(-1, V), torch.clamp(y.reshape(-1), min=0)
    k1 = lambda: ce_score(zf, yf)
    res[f"K1 ({B * T}, {V}) bf16, the op's first stage"] = dict(
        ms=_time(k1, 20), bound_ms=_bound(z.numel() * 2 + B * T * 12,
                                          8 * z.numel(), F32_FLOPS_PER_S)[0],
        bound_by="bytes")
    for name, r in res.items():
        line = (f"[timing] {name}: {r['ms']:.5f} ms ("
                + ("device" if "event_loop_ms" in r else "CUDA events") + ")")
        if "plain_ms" in r:
            line += f", plain {r['plain_ms']:.5f} ms (CUDA events)"
        line += f", bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
        if "event_loop_ms" in r:
            line += (f"; CUDA events around a loop of calls "
                     f"{r['event_loop_ms']:.5f} ms")
        if "l2_warm_ms" in r:
            line += (f"; the same inputs every launch (L2-warm) "
                     f"{r['l2_warm_ms']:.5f} ms")
        log(line)
    del z, y, rows, sc, zf, yf
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# slice 9: windowed attention and the other dense configs, K5 at hd 256
# ---------------------------------------------------------------------------
GEMMA = dict(hq=16, hkv=8, hd=256, window=1024)   # gemma3-12b's attention


def _ptxas_by_kernel(report):
    """ptxas's ``-v`` report -> {mangled kernel: "registers; spills"}."""
    out, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("spill" in line or "registers" in line):
            out[fn] = (out.get(fn, "") + " " + line.split(":")[-1].strip()
                       ).strip()
    return out


def check_k5_hd256(gen):
    """Phase 23: K5 at gemma3's head dim 256, each case against the plain
    version within the unchanged ``K5_TOL``/``K5_ROW_REL``, a second launch
    the same bits: the prefill shapes on the wgmma kernel
    (``flash_attn_fwd_wgmma256.cu``), the decode shapes on the decode
    kernel (``flash_attn_decode.cu``: a full ring, before the wrap, a
    window that cuts, the global cache's prefix), the mma kernel's prefill
    on an off-TMA copy of q, and a windowed hd-128 case (wgmma). Each case
    asserts which kernel took it. The three hd-256 kernels' registers and
    spills are logged; the wgmma and decode ones have none. The decode
    kernel's resident blocks an SM (the occupancy calculator) must be the
    ``DECODE_BLOCKS_PER_SM`` its split rule counts, and the card must hold
    cell F's 64 clusters of 2 blocks at once. Returns (per case,
    the ptxas lines of the hd-256 kernels)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import flash_attn as k5
    hq, hkv, hd, w = (GEMMA[k] for k in ("hq", "hkv", "hd", "window"))
    bf = torch.bfloat16
    ptxas = {}
    for lib, key in ((k5.LIB, "ILi256E"), (k5.LIB_WGMMA, "wgmma256"),
                     (k5.LIB_DECODE, "flash_decode")):
        report = _ptxas_by_kernel(
            (build.BUILD_DIR / f"{lib}.log").read_text())
        found = {fn: r for fn, r in report.items() if key in fn}
        assert found, (lib, sorted(report))
        ptxas.update(found)
    assert all("0 bytes spill stores, 0 bytes spill loads" in r
               for fn, r in ptxas.items()
               if "wgmma256" in fn or "flash_decode" in fn), ptxas
    log(f"[k5 hd256] ptxas, the hd-256 kernels (mma.sync, wgmma, decode): "
        f"{ptxas}")
    occupancy = [k5.decode_occupancy(g, 2) for g in
                 range(1, k5.DECODE_MAX_G + 1)]
    assert [n for n, _ in occupancy] == \
        [k5.DECODE_BLOCKS_PER_SM] * k5.DECODE_MAX_G, occupancy
    assert min(c for _, c in occupancy) >= 64, occupancy
    log(f"[k5 hd256] the decode kernel: (resident blocks an SM, clusters of "
        f"2 blocks the card holds: cell F's 64 pairs x 2 splits) for 1..."
        f"{k5.DECODE_MAX_G} query heads a block: {occupancy}; the split rule "
        f"counts {k5.DECODE_BLOCKS_PER_SM} blocks an SM")
    q = torch.zeros(2, 64, hq, hd, dtype=bf, device="cuda")
    kv = torch.zeros(2, 64, hkv, hd, dtype=bf, device="cuda")
    assert k5.plan(q, kv, kv) == "wgmma"
    assert k5.plan(q[:, :1], kv, kv) == "decode"
    assert k5.plan(_off_tma(q), kv, kv) == "mma"
    # name, kernel, (b, sq, skv, hq, hkv, hd), keywords of _k5_case
    g3 = (8, 1024, 1024, hq, hkv, hd)
    cases = [
        (f"gemma3 prefill (8,1024) {hq}/{hkv}x{hd}, window {w}", "wgmma256",
         g3, dict(window=w)),
        (f"gemma3 prefill (8,1024) {hq}/{hkv}x{hd}, global", "wgmma256", g3,
         {}),
        (f"gemma3 prefill (8,1024), window {w}, q x{Q_PEAK:g} (peaked)",
         "wgmma256", g3, dict(window=w, q_scale=Q_PEAK)),
        (f"gemma3 prefill (8,1024) over the 1088-slot cache's 1024-key "
         "prefix view (as serve passes it)", "wgmma256", g3, dict(slots=1088)),
        (f"(2,4096) {hq}/{hkv}x{hd}, window {w} (the window cuts)", "wgmma256",
         (2, 4096, 4096, hq, hkv, hd), dict(window=w)),
        ("ragged (2,77) at offset 100 over a 300-slot cache, window 64, "
         f"{hq}/{hkv}x{hd}", "wgmma256", (2, 77, 177, hq, hkv, hd),
         dict(window=64, q_offset=100, slots=300)),
        ("(12,200) at offset 256 over a 512-slot cache, window 64, scale "
         "0.2 (blocks walk two tiles)", "wgmma256", (12, 200, 456, hq, hkv, hd),
         dict(window=64, q_offset=256, slots=512, scale=0.2)),
        (f"gemma3 prefill (8,1024), window {w}, q off TMA's alignment (the "
         "mma kernel's prefill)", "mma", g3, dict(window=w, off_tma=True)),
        (f"decode (8,1) at 700 over a {w}-slot ring before the wrap",
         "decode256", (8, 1, 701, hq, hkv, hd),
         dict(window=w, q_offset=700, slots=w)),
        (f"decode (8,1) over a full {w}-slot ring, not causal", "decode256",
         (8, 1, w, hq, hkv, hd), dict(causal=False)),
        (f"decode (8,1) over a full {w}-slot ring, q x{Q_PEAK:g} (peaked)",
         "decode256", (8, 1, w, hq, hkv, hd),
         dict(causal=False, q_scale=Q_PEAK)),
        ("decode (8,1) at 1023, window 100 (the window cuts), scale 0.2",
         "decode256", (8, 1, w, hq, hkv, hd),
         dict(window=100, q_offset=w - 1, scale=0.2)),
        ("decode (8,1) at 1086 over the 1088-slot global cache's prefix",
         "decode256", (8, 1, 1087, hq, hkv, hd),
         dict(q_offset=1086, slots=1088)),
        ("hd 128 (2,1024) 24/8x128, window 256 < sq", "wgmma",
         (2, 1024, 1024, 24, 8, 128), dict(window=256)),
    ]
    per_case = {name: _k5_case(name, kernel, shape, bf, gen, **kw)
                for name, kernel, shape, kw in cases}
    return per_case, ptxas


def _plans_hook():
    """A hook that records each step's plan (gids)."""
    from repro_torch.api import Hook

    class Plans(Hook):
        def __init__(self):
            self.gids = []

        def on_step_start(self, loop, step, b, meta):
            self.gids.append([int(g) for g in meta.gids])
    return Plans()


def check_gemma_reduced():
    """Phase 24: ``reduced(gemma3-12b, repeats=2)`` (window 64, 5 local : 1
    global, f32 as ``reduced`` gives it) on the card against the CPU from
    the same params: the forward-only logits (K5 with the window, f32),
    ``prod``'s steps over sequences longer than the window (plans equal,
    losses to 1e-3), and ``serve`` (greedy tokens equal, the teacher-forced
    logits to 1e-3) of prompts of 40 for 30 tokens (the rings of 64 slots
    wrap at position 64; every attention call through K5), of 100 for 8
    (the rings, filled out of step with their slots, take the plain paths
    in prefill and decode; the global layers K5) and of 128 for 8 (the
    rings' prefill plain, their decode through K5 over the whole ring)."""
    import repro_torch
    from repro_torch.api import Experiment, build_run
    from repro_torch.checkpoint import interop
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ATTN
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.models.lm import LM
    cfg = reduced(get_config("gemma3-12b"), repeats=2)
    n_layers = cfg.n_layers
    res = {}
    gpu = LM(cfg, "cuda")
    cpu = interop.params_from_numpy(interop.params_to_numpy(gpu), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (2, 96)))
    _k5_zero(k5)
    with torch.inference_mode():
        lg = gpu({"tokens": toks.cuda()}).cpu()
        lc = cpu({"tokens": toks})
    assert k5.launches_by_kernel == _k5_counts(f32=n_layers), \
        k5.launches_by_kernel
    res["forward_max_abs_err"] = float((lg - lc).abs().max())
    assert res["forward_max_abs_err"] < 1e-3, res
    run = build_run(model=cfg, preset="prod", overrides={
        "shape.seq_len": 96, "shape.global_batch": 4, "steps": 3,
        "obs.enabled": False, "imp.score_dtype": "float32",
        "imp.tau_th": 1.01})
    ge, ce = Experiment(run), Experiment(run, device="cpu")
    interop.load_params(ce.lm, interop.params_to_numpy(ge.lm))
    hg, hc = _plans_hook(), _plans_hook()
    _, mg = ge.fit(hooks=[hg])
    _, mc = ce.fit(hooks=[hc])
    assert hg.gids == hc.gids, (hg.gids, hc.gids)
    for a, b in zip(mg, mc):
        assert math.isfinite(a["loss"]) and abs(a["loss"] - b["loss"]) < 1e-3
    assert any(h["sampler_active"] for h in mg), "IS never active"
    res["prod_losses"] = [[a["loss"], b["loss"]] for a, b in zip(mg, mc)]
    del ge, ce
    n_global = sum(seg.repeats * seg.pattern.count(ATTN)
                   for seg in cfg.segments)
    # (prompt, gen, K5 launches of the prefill (the f32 kernel) and of the
    # decode steps (mma)): every layer at every step; the global layers
    # only (rings out of step); the global layers in the prefill and every
    # layer in decode (rings of 128 = 2 × 64 stay in step)
    cases = ((40, 30, n_layers, n_layers * 29),
             (100, 8, n_global, n_global * 7),
             (128, 8, n_global, n_layers * 7))
    res["serve"] = []
    for P, gen, pre, dec in cases:
        want = pre + dec
        prompts = np.random.default_rng(P).integers(0, cfg.vocab_size,
                                                    (2, P))
        _k5_zero(k5)
        outs = [repro_torch.serve(cfg, params=lm.state_dict(),
                                  prompts=prompts, gen=gen, device=dev)
                for lm, dev in ((gpu, "cuda"), (cpu, "cpu"))]
        assert np.array_equal(outs[0]["tokens"], outs[1]["tokens"]), \
            (P, outs)
        assert k5.launches_by_kernel == _k5_counts(f32=pre, mma=dec), \
            (P, k5.launches_by_kernel, pre, dec)
        tk = torch.from_numpy(outs[0]["tokens"])
        pg = _teacher_forced(gpu, tk.cuda(),
                             torch.from_numpy(prompts).cuda(), gen - 1, True)
        pc = _teacher_forced(cpu, tk, torch.from_numpy(prompts), gen - 1,
                             True)
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(pg, pc))
        assert err < 1e-3, (P, err)
        res["serve"].append(dict(prompt_len=P, gen=gen, k5_launches=want,
                                 k5_f32=pre, k5_mma=dec, max_abs_err=err))
    log(f"[gemma reduced] {cfg.name}: forward (K5, {n_layers} f32 launches) "
        f"within {res['forward_max_abs_err']:.2e} of the CPU; prod plans "
        f"equal {hg.gids}, losses card/CPU {res['prod_losses']} (to 1e-3); "
        f"serve (prompt, gen, K5 launches, teacher-forced logits' worst "
        f"error against the CPU): " + json.dumps(res["serve"]) +
        "; tokens equal")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return res


GEMMA_SERVE = dict(batch=8, prompt_len=1024, gen=64)   # cap 1088
GEMMA_SERVE_CUTS = (
    "cuts from decode_32k (batch 128, prompt 32768): batch 128 -> 8, prompt "
    "32768 -> 1024 (= the window: the reference's serve prefill into a ring "
    "is exact only while the prompt fits in it), generation 64 tokens, cap "
    "1088 (rings of 1024 slots in the 40 local layers, 1088 in the 8 global "
    "ones); mesh (pod) -> one card. Width, depth (48 layers), vocab and the "
    "bf16 weights and caches are not cut.")


def run_gemma_serve(out):
    """Phase 25: serving gemma3-12b at full width and depth: every layer of
    the prefill takes the wgmma kernel (hd 256) and every layer of each
    decode step the decode kernel (48 ``decode256`` a step: 40 rings, from
    the first step after the wrap, and 8 global caches); phase 16's token
    check; the prefill and 4 decode steps under ``torch.profiler`` as cell
    C's (``profile_gemma_serve_*.txt``)."""
    row, cmp, lm, prompts, toks = _serve_cell(
        "gemma3-12b", GEMMA_SERVE, ("wgmma256", "decode256"), "gemma serve",
        GEMMA_SERVE_CUTS)
    cmp["profile"] = profile_serve(lm, prompts, toks, row, out, tag="F",
                                   fname="profile_gemma_serve")
    del lm, toks, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return row, cmp


def _cut(cfg, repeats):
    """``cfg`` with its one segment cut to ``repeats`` repeats."""
    from repro_torch.configs import Segment
    (seg,) = cfg.segments
    return dataclasses.replace(cfg, segments=(Segment(seg.pattern, repeats),))


def run_gemma_train(out):
    """Phase 27: ``prod`` training of gemma3-12b at full width, depth cut
    to one repeat of its pattern (5 local layers, 1 global)."""
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ce_score import ce_score as k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    full = get_config("gemma3-12b")
    cfg = _cut(full, 1)
    n = cfg.param_count()
    log(f"[gemma train] gemma3-12b, preset prod, overrides {CELL_A}; cuts: "
        f"depth 48 -> {cfg.n_layers} layers (one repeat of the 5 local : 1 "
        f"global pattern), {full.param_count() / 1e9:.3f} -> {n / 1e9:.3f} B "
        f"parameters by counting, state {14 * n / 1e9:.1f} GB (bf16 params, "
        f"f32 master, m, v); seq_len 4096 -> 1024; global_batch 256 -> "
        f"{BATCH}; steps 1000 -> {STEPS}; telemetry off, no checkpoints. "
        f"Width and vocab (262144) are not cut.")
    gc.collect()
    torch.cuda.empty_cache()
    hook = _step_log("gemma train", extra=_prune_row)
    k4.launches = 0
    _k5_zero(k5)
    t0 = time.perf_counter()
    _, history = repro_torch.train(cfg, preset="prod", overrides=CELL_A,
                                   hooks=[hook])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    k4n, k5_by = k4.launches, dict(k5.launches_by_kernel)
    assert len(history) == STEPS
    assert all(math.isfinite(h["loss"]) for h in history), history
    assert k4n == 8 * STEPS, k4n
    assert k5_by == _k5_counts(wgmma256=cfg.n_layers * STEPS), k5_by
    log(f"[gemma train] {STEPS} steps in {total:.1f} s (model build "
        f"included); K4 {k4n} ({k4n / STEPS:g} a step), K5 {k5_by}")
    breakdown = step_breakdown(hook.prof, hook.rows, out, tag="gemma train",
                               fname="profile_gemma_step")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k4_launches=k4n, k5_launches_by_kernel=k5_by, total_s=total,
                steps=hook.rows, profile=breakdown)


def _fit_depth(cfg, batch, seq, free_bytes=6e9):
    """The most repeats of ``cfg``'s one segment whose bf16 weights (by
    ``counting``) and the score call's largest tensors (the bf16 logits,
    and the ``fused`` route's f32 logits, their exp and its square) leave
    ``free_bytes`` of the card's memory free. Returns (cut cfg, bytes)."""
    total = torch.cuda.get_device_properties(0).total_memory
    act = batch * seq * cfg.vocab_size * (2 + 3 * 4)
    for r in range(cfg.segments[0].repeats, 0, -1):
        c = _cut(cfg, r)
        need = 2 * c.param_count() + act
        if need + free_bytes <= total:
            return c, need, total
    raise RuntimeError(f"{cfg.name} does not fit one card")


def _step_walls():
    """A hook that keeps each step's wall time (host clock between two
    device synchronisations)."""
    from repro_torch.api import Hook

    class Walls(Hook):
        def __init__(self):
            self.step_s = []

        def on_step_start(self, loop, step, b, meta):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_step_end(self, loop, step, m):
            torch.cuda.synchronize()
            self.step_s.append(time.perf_counter() - self.t0)
    return Walls()


def run_dense_configs():
    """Phase 28: lm-100m trained with ``prod`` at full size (f32: K4 on f32
    logits, K5's f32 kernel), internlm2-20b scored at full width and depth,
    yi-34b scored at full width and the depth ``_fit_depth`` gives."""
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ce_score import ce_score as k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    res = {}
    over = dict(CELL_A, **{"imp.score_dtype": "float32"})
    log(f"[lm-100m] lm-100m, preset prod, overrides {over}; cuts from prod: "
        f"seq_len 4096 -> 1024, global_batch 256 -> {BATCH}, steps 1000 -> "
        f"{STEPS}, telemetry off; the model (97 M parameters, f32) is not "
        f"cut; the pool is scored in f32 (prod scores in bf16)")
    walls = _step_walls()
    k4.launches = 0
    _k5_zero(k5)
    t0 = time.perf_counter()
    _, hist = repro_torch.train("lm-100m", preset="prod", overrides=over,
                                hooks=[walls])
    torch.cuda.synchronize()
    cfg = get_config("lm-100m")
    k4n, k5_by = k4.launches, dict(k5.launches_by_kernel)
    assert all(math.isfinite(h["loss"]) for h in hist), hist
    assert k4n == 8 * STEPS, k4n
    assert k5_by == _k5_counts(f32=cfg.n_layers * STEPS), k5_by
    res["lm-100m"] = dict(k4_launches=k4n, k5_launches_by_kernel=k5_by,
                          losses=[h["loss"] for h in hist],
                          wall_s=time.perf_counter() - t0,
                          step_s=walls.step_s,
                          steps_1_3_s=sum(walls.step_s[1:]))
    log("[lm-100m] " + json.dumps(res["lm-100m"]))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("internlm2-20b")
    k1, row = _score_run(
        "internlm2-20b", "internlm2", cfg.n_layers, "wgmma",
        f"{cfg.param_count() / 1e9:.3f} B parameters by counting "
        f"({2 * cfg.param_count() / 1e9:.1f} GB in bf16); cuts from prod: "
        "seq_len 4096 -> 1024, global_batch 256 -> 8; width, depth (48 "
        "layers) and vocab are not cut")
    res["internlm2-20b"] = dict(row, k1_launches=k1)
    full = get_config("yi-34b")
    cfg, need, total = _fit_depth(full, 8, 1024)
    cut = ("no cut of depth" if cfg.n_layers == full.n_layers else
           f"depth {full.n_layers} -> {cfg.n_layers} layers")
    k1, row = _score_run(
        cfg, "yi-34b", cfg.n_layers, "wgmma",
        f"{full.param_count() / 1e9:.3f} B parameters by counting "
        f"({2 * full.param_count() / 1e9:.1f} GB in bf16); {cut}: by "
        f"counting, {need / 1e9:.1f} GB of weights and the score's largest "
        f"tensors leave {(total - need) / 1e9:.1f} GB of the card's "
        f"{total / 1e9:.1f} GB free (at least 6); cuts from prod: seq_len "
        "4096 -> 1024, global_batch 256 -> 8; width and vocab are not cut")
    res["yi-34b"] = dict(row, k1_launches=k1, n_layers=cfg.n_layers,
                         counted_gb=need / 1e9, card_gb=total / 1e9)
    return res


def _attn_flops(b, hq, hd, sq, skv, window, causal=True, q_offset=0):
    """4·b·hq·hd times the keys the query rows attend to: the operations
    of Q K^T and P V, counted from the causal edge and the window."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    return 4 * b * hq * hd * int((hi - lo).sum())


def _host_loop_ms(fn, n=200):
    """The host's time per call of ``fn`` over n calls queued without a
    synchronise (its dispatch, where the card runs the calls faster than
    the host queues them); the card drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def _time_decode256(gen):
    """Phase 23b's decode row: cell F's decode over a full 1024-slot ring
    (b 8, 16/8 heads of 256, bf16, not causal) on the decode kernel by its
    device time three ways: on the same inputs; over 4 distinct rings in
    rotation (4 x 67 MB, so nothing stays in the 50 MB L2, as in a decode
    step, whose 48 layers read 48 caches); over the 1088-slot global
    cache's 1087-key prefix (causal, at 1086). Beside it, on the same
    values: the mma kernel (``flash_attn._launch_mma``, the path before the
    decode kernel), SDPA by backend, the plain version, the bound, and the
    dispatch: CUDA events around a loop of calls (``event_loop_ms``) and
    the host clock over calls queued without a synchronise."""
    import itertools
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.flash_attn.ops import flash_attention
    hq, hkv, hd, w = (GEMMA[k] for k in ("hq", "hkv", "hd", "window"))
    b, bf = 8, torch.bfloat16
    q, k, v = _k5_inputs(b, 1, w, hq, hkv, hd, bf, gen)
    kw = dict(causal=False)
    assert k5.plan(q, k, v) == "decode"
    ms = _device_ms(lambda: flash_attention(q, k, v, **kw), 50)
    rings = [(k, v)] + [_k5_inputs(b, 1, w, hq, hkv, hd, bf, gen)[1:]
                        for _ in range(3)]
    turn = itertools.count()

    def rotate():
        kr, vr = rings[next(turn) % len(rings)]
        return flash_attention(q, kr, vr, **kw)
    rot_ms = _device_ms(rotate, 48)
    del rings
    qg, kg, vg = _k5_inputs(b, 1, 1087, hq, hkv, hd, bf, gen, slots=1088)
    glob_ms = _device_ms(lambda: flash_attention(qg, kg, vg, q_offset=1086),
                         50)
    glob_bound, _ = _bound(2 * (2 * b * hq * hd + 2 * b * 1087 * hkv * hd),
                           4 * b * hq * hd * 1087, BF16_FLOPS_PER_S)
    del qg, kg, vg
    o = torch.empty_like(q)
    scale = hd ** -0.5

    def mma():
        k5._launch_mma(q, k, v, o, False, 0, 0, scale)
    mma_ms = _device_ms(mma, 50)
    lib = {"sdpa": _sdpa(q, k, v, False),
           **{f"sdpa {n}": f for n, f in
              _sdpa_backends(q, k, v, False).items()}}
    lib_ms = {key: _device_ms(f, 50) for key, f in lib.items()}
    n_bytes = 2 * (2 * b * hq * hd + 2 * b * w * hkv * hd)
    n_ops = 4 * b * hq * hd * w
    bound_ms, by = _bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
    row = dict(
        shape=f"q ({b},1,{hq},{hd}), kv a full {w}-slot ring ({b},{w},{hkv},"
              f"{hd}) bf16, not causal",
        kernel="decode256", ms=ms, ms_l2_cold_rotation=rot_ms,
        share_of_bound=bound_ms / ms,
        share_of_bound_l2_cold=bound_ms / rot_ms,
        global_prefix=dict(shape=f"q ({b},1,{hq},{hd}) at 1086, kv the "
                                 f"1088-slot global cache's 1087-key prefix, "
                                 f"causal", ms=glob_ms, bound_ms=glob_bound,
                           share_of_bound=glob_bound / glob_ms),
        mma_ms=mma_ms,
        plain_ms=_device_ms(lambda: _k5_plain(q, k, v, rows=8, **kw), 10),
        library_ms=lib_ms["sdpa"],
        library_ms_by_backend={key[5:]: t for key, t in lib_ms.items()
                               if key.startswith("sdpa ")},
        bound_ms=bound_ms, bound_by=by,
        tb_per_s=n_bytes / (ms * 1e-3) / 1e12,
        event_loop_ms=_time(lambda: flash_attention(q, k, v, **kw), 100),
        host_loop_ms=_host_loop_ms(lambda: flash_attention(q, k, v, **kw)),
        mma_event_loop_ms=_time(mma, 100), mma_host_loop_ms=_host_loop_ms(mma),
        timed_by=DEVICE_TIMED + "; event_loop_ms: CUDA events around 100 "
                 "calls; host_loop_ms: the host clock over 200 calls queued "
                 "without a synchronise")
    best = min(row["library_ms_by_backend"].values(), default=row["library_ms"])
    log(f"[timing hd256] K5 decode: the decode kernel {ms:.4f} ms device "
        f"time ({row['share_of_bound']:.3f} of the {bound_ms:.4f} ms bound), "
        f"{rot_ms:.4f} over 4 rings in rotation (L2-cold, "
        f"{row['share_of_bound_l2_cold']:.3f}), {glob_ms:.4f} over the "
        f"1087-key global prefix (bound {glob_bound:.4f}); the mma kernel "
        f"on the same values {mma_ms:.4f}; SDPA's best backend {best:.4f} "
        f"(the decode kernel {'under' if ms < best else 'NOT under'} it); "
        f"dispatch per call: events {row['event_loop_ms']:.4f} ms, host "
        f"{row['host_loop_ms']:.4f} ms (the mma kernel's launch helper alone:"
        f" {row['mma_event_loop_ms']:.4f} / {row['mma_host_loop_ms']:.4f})")
    del q, k, v, o, lib
    torch.cuda.empty_cache()
    return row


def time_k5_hd256(gen):
    """Phase 23b: K5 at gemma3's shapes. The prefill (8, 1024, 16/8, 256),
    causal with the window of 1024 (which cuts nothing at 1024 queries),
    and (2, 4096) with the window of 1024 (which cuts), on the wgmma
    kernel and on the mma kernel (q copied off TMA's alignment: the same
    values), each timed by CUDA events (the median of 3 rounds of 20
    calls, in turns) and by its device time (``_device_ms``), beside
    its plain version, its bound (counted from the window) and
    ``scaled_dot_product_attention`` (k and v expanded to 16 heads) under
    each backend that takes hd 256: ``is_causal`` where the window cuts
    nothing, else a boolean band mask. The row's ``ms`` (and ``mma_ms``,
    ``library_ms``) is the CUDA events' time, the yardstick of every
    prefill row since phase 18a's; the device time stands beside it
    (``device_ms``), since at ~0.15 ms a launch the wrapper's host
    dispatch can set an event loop's pace. The decode on the decode
    kernel by its device time (``_time_decode256``)."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.flash_attn.ops import flash_attention
    hq, hkv, hd, w = (GEMMA[k] for k in ("hq", "hkv", "hd", "window"))
    res = {}
    for name, b, sq in (("prefill", 8, 1024), ("prefill (2, 4096)", 2, 4096)):
        q, k, v = _k5_inputs(b, sq, sq, hq, hkv, hd, torch.bfloat16, gen)
        q_off = _off_tma(q)
        assert k5.plan(q, k, v) == "wgmma" and k5.plan(q_off, k, v) == "mma"
        cuts = sq > w
        if cuts:
            pos = torch.arange(sq, device="cuda")
            band = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - w)
            g = hq // hkv
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2)
                      for t in (k, v))
            f = torch.nn.functional.scaled_dot_product_attention
            sdpa = {"sdpa": lambda: f(qt, kt, vt, attn_mask=band)}
        else:
            sdpa = {"sdpa": _sdpa(q, k, v, True),
                    **{f"sdpa {n}": f for n, f in
                       _sdpa_backends(q, k, v, True).items()}}
        runs = {"wgmma": lambda: flash_attention(q, k, v, window=w),
                "mma": lambda: flash_attention(q_off, k, v, window=w),
                **sdpa}
        ev = {key: [] for key in runs}
        for r in range(3):
            for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                ev[key].append(_time(runs[key], 20))
        med = {key: sorted(ts)[1] for key, ts in ev.items()}
        dev = {key: _device_ms(fn, 20) for key, fn in runs.items()}
        n_ops = _attn_flops(b, hq, hd, sq, sq, w)
        n_bytes = 2 * (2 * b * sq * hq * hd + 2 * b * sq * hkv * hd)
        bound_ms, by = _bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
        res[name] = dict(
            shape=f"q ({b},{sq},{hq},{hd}), kv ({b},{sq},{hkv},{hd}) bf16, "
                  f"causal, window {w}",
            kernel="wgmma", ms=med["wgmma"], device_ms=dev["wgmma"],
            rounds_ms=ev, mma_ms=med["mma"], mma_device_ms=dev["mma"],
            plain_ms=_time(lambda: _k5_plain(q, k, v, window=w), 2),
            library_ms=med["sdpa"], library_device_ms=dev["sdpa"],
            library_ms_by_backend={
                key[5:]: t for key, t in med.items()
                if key.startswith("sdpa ")} or None,
            library_device_ms_by_backend={
                key[5:]: t for key, t in dev.items()
                if key.startswith("sdpa ")} or None,
            library_call=("is_causal" if not cuts else
                          "a boolean band mask (the window cuts)"),
            bound_ms=bound_ms, bound_by=by, flop=n_ops,
            tflops=n_ops / (med["wgmma"] * 1e-3) / 1e12,
            share_of_bound=bound_ms / med["wgmma"],
            device_share_of_bound=bound_ms / dev["wgmma"],
            mma_tflops=n_ops / (med["mma"] * 1e-3) / 1e12,
            timed_by="ms: CUDA events, the median of 3 rounds of 20 calls, "
                     "in turns; device_ms: " + DEVICE_TIMED)
        del q, k, v, q_off, runs, sdpa
        torch.cuda.empty_cache()
    res["decode"] = _time_decode256(gen)
    for name, r in res.items():
        backends = {n: round(t, 4)
                    for n, t in (r["library_ms_by_backend"] or {}).items()}
        extra = ""
        if "device_ms" in r:
            extra = (f" ({r['tflops']:.1f} TFLOP/s, {r['share_of_bound']:.3f}"
                     f" of the bound; by device time "
                     f"{r['device_ms']:.4f}); the mma kernel on the same "
                     f"values {r['mma_ms']:.4f} (device "
                     f"{r['mma_device_ms']:.4f}); SDPA by device time "
                     f"{r['library_device_ms']:.4f} (by backend "
                     f"{r['library_device_ms_by_backend']})")
        log(f"[timing hd256] K5 {name} {r['shape']}: {r['kernel']} kernel "
            f"{r['ms']:.4f} ms/launch{extra}, plain {r['plain_ms']:.4f} ms, "
            f"SDPA {r['library_ms']:.4f} ms (by backend {backends}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); row timed by "
            f"{r['timed_by']}")
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; torch finds none")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ce_score import ce_score as k1k4
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.topk_keys import topk_keys as k6
    csrc = "src/repro_torch/kernels/{}/csrc/{}"
    fp_tpu = "src/repro/kernels/fused_presample/fused_presample.py:{}"
    kernels = [dict(name="ce_score_block", route="cuda",
                    builds=[(k1k4.LIB, k1k4.SOURCES)],
                    source=csrc.format("ce_score", "ce_score_block.cu"),
                    replaces="src/repro/kernels/ce_score/ce_score.py:144",
                    held_by="phase 3 (K4), 4 (prune), 24 (gemma3 "
                            "reduced, card against CPU) and 27/28 (gemma3 "
                            "and lm-100m steps, losses finite)"),
               dict(name="race_keys", route="cuda",
                    builds=[(k6.LIB, k6.SOURCES)],
                    source=csrc.format("topk_keys", "race_keys.cu"),
                    replaces="src/repro/kernels/topk_keys/topk_keys.py:71",
                    held_by="phase 8 (K6) and 9 (sharded)"),
               dict(name="flash_attention", route="cuda",
                    builds=[(k5.LIB_WGMMA, k5.SOURCES_WGMMA),
                            (k5.LIB, k5.SOURCES),
                            (k5.LIB_DECODE, k5.SOURCES_DECODE),
                            (k5.LIB_F32, k5.SOURCES_F32)],
                    source=csrc.format("flash_attn",
                                       "flash_attn_fwd_wgmma.cu"),
                    replaces="src/repro/kernels/flash_attn/flash_attn.py:66",
                    held_by="phase 13 (K5, the wgmma, f32 and mma "
                            "kernels), 15 (serve lm-tiny: f32 prefill, mma "
                            "decode), 16 (cell C: beside "
                            "every plain attention call, and the route "
                            "against the plain route), 23 (hd 256: the "
                            "wgmma256, decode and mma kernels; windows), 24 "
                            "(gemma3 reduced, card against CPU), 25 (gemma3 "
                            "serve, as 16) and 26/28 (the scores against "
                            "'fused')"),
               dict(name="ce_score", route="cuda",
                    builds=[(k1k4.LIB_K1, k1k4.SOURCES_K1)],
                    source=csrc.format("ce_score", "ce_score.cu"),
                    replaces="src/repro/kernels/ce_score/ce_score.py:198",
                    held_by="phase 14 (K1), 17 (cell D), 26 (gemma3, V "
                            "262144) and 28 (internlm2-20b, yi-34b), each "
                            "against 'fused'"),
               dict(name="pool_select (K2 row_score)", route="cuda",
                    builds=[(fp.LIB, fp.SOURCES)],
                    source=csrc.format("fused_presample", "pool_select.cu"),
                    replaces=fp_tpu.format(50),
                    held_by="phase 19 (scores against row_score_math, two "
                            "launches the same bits, the fused op against "
                            "fused_presample_ref), 21 (cell E's op: one "
                            "launch, scores against sample_stats) and 22 "
                            "(times)"),
               dict(name="pool_select (K3 pool_keys)", route="cuda",
                    builds=[],       # the same library as the row above
                    source=csrc.format("fused_presample", "pool_select.cu"),
                    replaces=fp_tpu.format(108),
                    held_by="phase 19 (keys bitwise pool_keys_plain on the "
                            "kernel's scores and 1/sum, idx = _bottom_k of "
                            "its keys, weights), 21 (cell E's op against the "
                            "host race) and 22 (times)")]

    seconds = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {seconds[name]:.1f} s")
        return r
    smi = phase("1 card", card)
    libs = phase("2 build", build_all, kernels)
    wgmma_build = check_wgmma_build(libs)
    f32_ptxas = check_f32_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = phase("3 K4", check_k4, gen)
    phase("4 prune", check_prune, gen)
    phase("5 lm-tiny", check_lm_tiny)
    plane_tiny = phase("5b plane lm-tiny", check_plane_lm_tiny)
    plane_gpu = phase("5c plane gpu tests", run_plane_gpu_tests)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    launches, k5_cell_a, rows, breakdown = phase("6 slice", run_slice, out)
    resume = phase("6b cell A resume", run_cell_a_resume, rows, smi)
    depth1 = phase("6c cell A depth 1", run_cell_a_depth1, out, rows,
                   breakdown, smi)
    ms, plain_ms, bound_ms, by = phase("7 K4 timing", time_k4, gen)
    store = _warm_store()
    k6_abs, k6_rel = phase("8 K6", check_k6, store)
    vs_loop = phase("9 sharded", check_sharded, store)
    phase("10 history lm-tiny", check_history_lm_tiny)
    k6_launches, hrows = phase("11 history slice", run_history_slice)
    k6_t = phase("12 K6 timing", time_k6, store)
    del store
    k5_err, k5_rel, k5_cases = phase("13 K5", check_k5, gen)
    k1_err = phase("14 K1", check_k1, gen)
    tiny_err = phase("15 serve lm-tiny", check_serve_lm_tiny)
    k5_launches, cell_c, c_vs_plain = phase("16 cell C", run_cell_c, out)
    k1_launches, cell_d = phase("17 cell D", run_cell_d)
    k5_t = phase("18a K5 timing", time_k5, gen)
    k1_t = phase("18b K1 timing", time_k1, gen)
    ps = phase("19 pool_select", check_pool_select, gen)
    tiny_presample = phase("20 presample lm-tiny", check_presample_lm_tiny)
    e_rows, e_op, e_total, e_profile, k5_cell_e = phase("21 cell E",
                                                         run_cell_e, out)
    ps_t = phase("22 pool_select timing", time_pool_select, gen)
    k5_256, ptxas_256 = phase("23 K5 hd 256", check_k5_hd256, gen)
    k5_256_t = phase("23b K5 hd 256 timing", time_k5_hd256, gen)
    gemma_tiny = phase("24 gemma3 reduced", check_gemma_reduced)
    gemma_serve, gemma_cmp = phase("25 gemma3 serve", run_gemma_serve, out)
    k1_gemma, gemma_score = phase(
        "26 gemma3 score", _score_run, "gemma3-12b", "gemma score", 48,
        "wgmma256", "11.765 B parameters by counting (23.5 GB in bf16); cuts "
        "from prod: seq_len 4096 -> 1024, global_batch 256 -> 8; width, depth "
        "(48 layers: 40 local, 8 global) and vocab (262144) are not cut")
    gemma_train = phase("27 gemma3 train", run_gemma_train, out)
    dense = phase("28 dense configs", run_dense_configs)
    k5_cases.update(k5_256)

    def entry(i, **kw):
        k = kernels[i]
        return {"name": k["name"], "route": k["route"], "source": k["source"],
                "replaces": k["replaces"], **kw, "held_by": k["held_by"]}
    pre, dec = k5_t["prefill"], k5_t["decode"]
    k5_by_path = {"cell C serve": cell_c["k5_launches_by_kernel"],
                  "cell D score": cell_d["k5_launches_by_kernel"],
                  "cell A steps": k5_cell_a,
                  "cell A resumed steps": resume["k5_launches_by_kernel"],
                  "cell E steps": k5_cell_e,
                  "gemma3 serve": gemma_serve["k5_launches_by_kernel"],
                  "gemma3 score": gemma_score["k5_launches_by_kernel"],
                  "gemma3 train steps": gemma_train["k5_launches_by_kernel"],
                  "lm-100m train steps":
                      dense["lm-100m"]["k5_launches_by_kernel"],
                  "internlm2-20b score":
                      dense["internlm2-20b"]["k5_launches_by_kernel"],
                  "yi-34b score": dense["yi-34b"]["k5_launches_by_kernel"]}

    def k5_paths(kernel):
        return {path: by[kernel] for path, by in k5_by_path.items()
                if by[kernel]}

    def k5_worst(kernel):
        return max(c["max_abs_err"] for c in k5_cases.values()
                   if c["kernel"] == kernel)
    g3, d256 = k5_256_t["prefill"], k5_256_t["decode"]
    f32r = k5_t["f32 pool (12, 1024)"]
    ps_key = f"pool_select ({POOL[0]}, {POOL[1]}) k {BATCH}"
    ps_cell_e = {k: ps_t[ps_key][k]
                 for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    ps_common = dict(
        timed_by=DEVICE_TIMED,
        timed_at=f"cell E's pool {ps_key}: one launch computes K2, K3 and "
                 "the selection; prod's pool, select_pool, the op and the "
                 "launch floor in by_shape",
        launch_floor_ms=ps_t["launch floor: one-element zero_()"]["ms"],
        two_launches_same_bits=ps["two_launches_same_bits"], by_shape=ps_t)
    line = {"kernels": [
        entry(0, launches=launches, max_abs_err=err, ms=ms,
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
              library_ms=None, launches_by_path={
                  "cell A steps": launches,
                  "cell A resumed steps": resume["k4_launches"],
                  "gemma3 train steps": gemma_train["k4_launches"],
                  "lm-100m train steps": dense["lm-100m"]["k4_launches"]}),
        entry(1, launches=k6_launches, max_abs_err=k6_abs,
              max_rel_err=k6_rel, ms=k6_t[0], plain_ms=k6_t[1],
              bound_ms=k6_t[2], bound_by=k6_t[3], library_ms=None,
              topk_ms=k6_t[4], h2d_ms=k6_t[5]),
        entry(2, launches=k5_launches, max_abs_err=k5_err,
              max_row_rel_err=k5_rel, ms=pre["ms"],
              plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
              bound_by=pre["bound_by"], library_ms=pre["library_ms"],
              library_ms_by_backend=pre["library_ms_by_backend"],
              timed_at="cell C prefill (the wgmma kernel); the other shapes "
                       "and decode (the mma kernel) in by_shape",
              by_shape=k5_t, launches_by_path=k5_by_path,
              kernels=[
                  dict(name="flash_fwd_wgmma", route="cuda",
                       source=csrc.format("flash_attn",
                                          "flash_attn_fwd_wgmma.cu"),
                       serves="bf16, hd 128, sq >= 64, TMA-aligned "
                              "(prefill, scoring)",
                       launches=cell_c["k5_launches_by_kernel"]["wgmma"],
                       launches_by_path=k5_paths("wgmma"),
                       max_abs_err=k5_worst("wgmma"), ms=pre["ms"],
                       plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
                       bound_by=pre["bound_by"],
                       library_ms=pre["library_ms"],
                       library_ms_by_backend=pre["library_ms_by_backend"],
                       tflops=pre["tflops"], build=wgmma_build,
                       timed_at="cell C prefill; (8, 1024) and (12, 1024) "
                                "in by_shape"),
                  dict(name="flash_fwd_wgmma256", route="cuda",
                       source=csrc.format("flash_attn",
                                          "flash_attn_fwd_wgmma256.cu"),
                       serves="bf16, hd 256, sq >= 64, TMA-aligned "
                              "(gemma3's prefill, scoring, pool scoring)",
                       launches=gemma_serve["k5_launches_by_kernel"][
                           "wgmma256"],
                       launches_by_path=k5_paths("wgmma256"),
                       max_abs_err=k5_worst("wgmma256"),
                       ms=g3["ms"], device_ms=g3["device_ms"],
                       plain_ms=g3["plain_ms"], bound_ms=g3["bound_ms"],
                       bound_by=g3["bound_by"],
                       library_ms=g3["library_ms"],
                       library_ms_by_backend=g3["library_ms_by_backend"],
                       tflops=g3["tflops"],
                       share_of_bound=g3["share_of_bound"],
                       mma_ms=g3["mma_ms"], ptxas=ptxas_256,
                       timed_by=g3["timed_by"],
                       timed_at="gemma3 prefill (8, 1024); (2, 4096) with "
                                "the window in by_shape_hd256 of flash_mma"),
                  dict(name="flash_decode256", route="cuda",
                       source=csrc.format("flash_attn",
                                          "flash_attn_decode.cu"),
                       serves="bf16, hd 256, one query row (gemma3's decode "
                              "over its rings and global caches)",
                       launches=gemma_serve["k5_launches_by_kernel"][
                           "decode256"],
                       launches_by_path=k5_paths("decode256"),
                       max_abs_err=k5_worst("decode256"),
                       ms=d256["ms"], plain_ms=d256["plain_ms"],
                       bound_ms=d256["bound_ms"], bound_by=d256["bound_by"],
                       library_ms=d256["library_ms"],
                       library_ms_by_backend=d256["library_ms_by_backend"],
                       share_of_bound=d256["share_of_bound"],
                       ms_l2_cold_rotation=d256["ms_l2_cold_rotation"],
                       global_prefix=d256["global_prefix"],
                       mma_ms=d256["mma_ms"],
                       event_loop_ms=d256["event_loop_ms"],
                       host_loop_ms=d256["host_loop_ms"],
                       ptxas={fn: r for fn, r in ptxas_256.items()
                              if "flash_decode" in fn},
                       timed_by=d256["timed_by"],
                       timed_at="cell F's decode over a full 1024-slot ring "
                                "(b 8, 16/8 heads of 256, not causal); "
                                "4 rings in rotation and the 1087-key "
                                "global prefix beside it"),
                  dict(name="flash_f32", route="cuda",
                       source=csrc.format("flash_attn",
                                          "flash_attn_fwd_f32.cu"),
                       serves="f32 prefill and scoring: hd 16/32/64/128, sq "
                              f">= {k5.F32_MIN_ROWS}, 16-byte aligned (cell "
                              "I's pool, lm-tiny, the reduced configs)",
                       launches=dense["lm-100m"]["k5_launches_by_kernel"][
                           "f32"],
                       launches_by_path=k5_paths("f32"),
                       max_abs_err=k5_worst("f32"), ms=f32r["ms"],
                       plain_ms=f32r["plain_ms"],
                       bound_ms=f32r["bound_ms"], bound_by=f32r["bound_by"],
                       library_ms=f32r["library_ms"],
                       library_ms_by_backend=f32r["library_ms_by_backend"],
                       tflops=f32r["tflops"],
                       share_of_bound=f32r["share_of_bound"],
                       mma_ms=f32r["mma_ms"], ptxas=f32_ptxas,
                       timed_by=f32r["timed_by"],
                       timed_at="cell I's pool scoring (12, 1024, 10/5, 64), "
                                "causal; mma_ms: the mma.sync kernel's f32 "
                                "path on the same values (what this shape "
                                "took before the f32 kernel)"),
                  dict(name="flash_mma", route="cuda",
                       source=csrc.format("flash_attn", "flash_attn_fwd.cu"),
                       serves="the hd-128 and f32 decodes, other head dims, "
                              "hd-256 prefills off TMA's alignment or under "
                              "64 rows, f32 and bf16 calls the fast kernels "
                              "refuse (unaligned views, short calls)",
                       launches=cell_c["k5_launches_by_kernel"]["mma"],
                       launches_by_path=k5_paths("mma"),
                       max_abs_err=k5_worst("mma"), ms=dec["ms"],
                       plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"],
                       bound_by=dec["bound_by"],
                       library_ms=dec["library_ms"],
                       library_ms_by_backend=None,
                       by_shape_hd256=k5_256_t, ptxas_hd256=ptxas_256,
                       timed_at="cell C decode (device time); on the "
                                "wgmma shapes as mma_ms in by_shape; "
                                "gemma3's prefill and its decode (mma_ms) "
                                "at hd 256 in by_shape_hd256; cell I's f32 "
                                "pool scoring as flash_f32's mma_ms")]),
        entry(3, launches=k1_launches, max_abs_err=k1_err, ms=k1_t[0],
              plain_ms=k1_t[1], bound_ms=k1_t[2], bound_by=k1_t[3],
              library_ms=None, launches_by_path={
                  "cell D score": k1_launches,
                  "cell E fused_presample op": e_op["k1"],
                  "gemma3 score": k1_gemma,
                  "internlm2-20b score": dense["internlm2-20b"]["k1_launches"],
                  "yi-34b score": dense["yi-34b"]["k1_launches"]}),
        entry(4, launches=e_op["pool_select"],
              max_abs_err=ps["k2_max_abs_err"],
              max_rel_err=ps["k2_max_rel_err"], **ps_cell_e,
              library_ms=None, **ps_common),
        entry(5, launches=e_op["pool_select"],
              max_abs_err=ps["k3_max_abs_err"], bitwise=ps["k3_bitwise"],
              select_max_rel_err=ps["select_max_rel_err"], **ps_cell_e,
              library_ms=None, **ps_common)]}
    loaded = check_built_once(libs)
    ok = {"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "steps": rows, "profile": breakdown,
         "cell_a_resume": resume, "cell_a_depth1": depth1,
         "plane_lm_tiny": plane_tiny, "plane_gpu_tests": plane_gpu,
         "history_steps": hrows, "sharded_vs_f64_loop": vs_loop,
         "k5_cases": k5_cases, "serve_lm_tiny_err": tiny_err,
         "cell_c": cell_c, "cell_c_vs_plain": c_vs_plain, "cell_d": cell_d,
         "pool_select": ps, "pool_select_timing": ps_t,
         "presample_lm_tiny": tiny_presample,
         "cell_e_steps": e_rows, "cell_e_op": e_op, "cell_e_total_s": e_total,
         "cell_e_profile": e_profile, "libraries_loaded": loaded,
         "gemma_reduced": gemma_tiny, "gemma_serve": gemma_serve,
         "gemma_serve_vs_plain": gemma_cmp, "gemma_score": gemma_score,
         "gemma_train": gemma_train, "dense_configs": dense,
         "phase_seconds": seconds,
         **line, **ok}, indent=1))
    print(smi)
    print(json.dumps(line))
    print(json.dumps(ok), flush=True)


if __name__ == "__main__":
    main()
