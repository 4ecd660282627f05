"""The rates a checkpoint of a large state moves at on this machine.

    python3 -m repro_torch.checkpoint.io_probe [--gb 4]

Prints one JSON object: the free disk under ``build/`` and
``MemAvailable``; a device-to-host copy of ``--gb`` GB into pageable and
into pinned host memory (and the time to allocate each) and back, and
through the snapshot's two pinned 256 MiB buffers (``ckpt._PinnedRing``)
into fresh pageable memory; a host copy
into fresh and into touched pageable memory; zlib's CRC-32; the same
bytes written and read as a plain ``.npy`` and through
``checkpoint.ckpt.write_npz`` (the zip a checkpoint is, with its CRC-32),
read back by ``np.load`` and by ``checkpoint.ckpt.read_npz``; and a
``Checkpointer`` save (snapshot, write, commit) and restore of a
``--gb`` GB state of bf16 and f32 tensors on the card. Needs a CUDA
device; writes under ``build/io_probe/`` and removes it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (Checkpointer, _PinnedRing,
                                         read_npz, write_npz)

ROOT = Path(__file__).resolve().parents[3]


def _gbps(n_bytes, fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"s": dt, "GB/s": n_bytes / dt / 1e9}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("io_probe needs a CUDA device")
    out_dir = ROOT / "build" / "io_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    meminfo = dict(line.split(":", 1) for line in
                   Path("/proc/meminfo").read_text().splitlines())
    n = int(args.gb * 1e9) // 4
    dev = torch.empty(n, dtype=torch.float32, device="cuda").normal_()
    nb = n * 4
    res = {"bytes": nb,
           "free_disk": shutil.disk_usage(out_dir).free,
           "mem_available": int(meminfo["MemAvailable"].split()[0]) * 1024}
    for pinned in (False, True):
        t0 = time.perf_counter()
        host = torch.empty(n, dtype=torch.float32, pin_memory=pinned)
        tag = "pinned" if pinned else "pageable"
        res[f"alloc_{tag}_s"] = time.perf_counter() - t0
        res[f"d2h_{tag}"] = _gbps(nb, lambda: host.copy_(dev))
        res[f"h2d_{tag}"] = _gbps(nb, lambda: dev.copy_(host))
    ring = _PinnedRing()

    def staged():
        ring.copy(torch.empty(n, dtype=torch.float32), dev)
    res["d2h_staged"] = _gbps(nb, staged)
    arr = host.numpy()
    res["memcpy_fresh"] = _gbps(nb, lambda: np.copyto(np.empty_like(arr),
                                                      arr))
    touched = np.ones_like(arr)
    res["memcpy_touched"] = _gbps(nb, lambda: np.copyto(touched, arr))
    del touched
    res["crc32"] = _gbps(nb, lambda: zlib.crc32(memoryview(arr)))
    res["npy_write"] = _gbps(nb, lambda: np.save(out_dir / "a.npy", arr))
    res["npy_read"] = _gbps(nb, lambda: np.load(out_dir / "a.npy"))
    res["npz_write"] = _gbps(nb, lambda: write_npz(out_dir / "a.npz",
                                                   {"a": arr}))

    def read_npz_load():
        with np.load(out_dir / "a.npz") as z:
            z["a"]
    res["npz_read"] = _gbps(nb, read_npz_load)
    res["read_npz"] = _gbps(nb, lambda: list(read_npz(out_dir / "a.npz",
                                                      ["a"])))
    del arr, host
    # a Checkpointer round trip of a state on the card: half bf16, half f32
    shapes = [(4096, 8192)] * max(int(nb // (4096 * 8192 * 6)), 1)
    state = {"bf16": {str(i): torch.randn(s, device="cuda").bfloat16()
                      for i, s in enumerate(shapes)},
             "f32": {str(i): torch.randn(s, device="cuda")
                     for i, s in enumerate(shapes)}}
    state_bytes = sum(t.numel() * t.element_size()
                      for d in state.values() for t in d.values())
    ck = Checkpointer(out_dir / "ckpt", keep=1)
    ck.save(1, state)
    t0 = time.perf_counter()
    ck.restore(state)
    torch.cuda.synchronize()
    res["checkpointer"] = {"bytes": state_bytes, **ck.last_save,
                           "restore_s": time.perf_counter() - t0}
    shutil.rmtree(out_dir)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
