"""Fault-tolerant checkpoints (``repro.checkpoint.ckpt``), in the
reference's on-disk format, so a checkpoint crosses between the packages.

Layout::

    <dir>/step_<N>/
        manifest.json      # keys with shapes and dtypes, meta, n_hosts
        shard_0.npz        # every leaf, one npy member per ``/``-joined key
        COMMIT             # written LAST; a checkpoint without it is ignored

Guarantees:

* atomic: written into ``step_<N>.tmp-<nonce>/`` and then renamed, with
  COMMIT last, so a crash mid-save never corrupts the newest checkpoint;
  a dead run's ``step_*.tmp-*`` dirs are reaped when a ``Checkpointer``
  starts;
* async: ``save_async`` snapshots to host memory now (device-to-host
  copies through a bounded pinned ring) and writes on a thread, off the
  training loop;
* restart: ``latest_step``/``restore`` pick the newest committed step;
* GC: keep-last-k.

One host writes; a checkpoint whose manifest names another writer count
raises ``TopologyMismatch`` (the cross-topology reshard belongs to the
distributed runtime, which is not ported yet).

A payload is a nested dict (NamedTuple fields flatten as ``.<field>``, as
the reference's pytree paths do) whose leaves are torch tensors, numpy
arrays or scalars, or a ``Stacked`` list of per-layer tensors saved as one
array stacked on a leading axis (the reference's layer-stacked layout).

bfloat16: npz has no bf16. The reference's numpy writes a bf16 leaf as raw
2-byte void records (npy descr ``'<V2'``) and names its dtype ``bfloat16``
in the manifest; the port writes the same bytes (the tensor's bits under a
``'<V2'`` header) and reads them back exactly (``'<V2'`` → int16 view →
``torch.bfloat16`` view).

``restore`` copies tensor leaves IN PLACE into the template's tensors (on
their device, in their dtype), one leaf at a time, so a model's state is
never held twice in host memory while it loads.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import uuid
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

BF16 = "bfloat16"


class Stacked(list):
    """Per-layer tensors saved as one array stacked on a leading axis."""


class TopologyMismatch(RuntimeError):
    """A committed checkpoint was written by another number of hosts than
    the one restoring it."""

    def __init__(self, ckpt_hosts: int, now_hosts: int, step: int):
        self.ckpt_hosts = int(ckpt_hosts)
        self.now_hosts = int(now_hosts)
        self.step = int(step)
        super().__init__(
            f"checkpoint step {step} was written by {ckpt_hosts} host(s) "
            f"but {now_hosts} are restoring it — reshard, don't restore "
            f"(the cross-topology reshard is not ported yet)")


# ---------------------------------------------------------------------------
# payload trees
# ---------------------------------------------------------------------------
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: str = "") -> dict:
    """Nested payload -> ``{"/"-joined key: leaf}``; dict keys sorted and
    NamedTuple fields as ``.<field>``, the reference's ``_flatten`` names."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    if _is_namedtuple(tree):
        out = {}
        for f in tree._fields:
            out.update(flatten(getattr(tree, f), f"{prefix}.{f}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(tree, values: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), values,
                                       f"{prefix}.{f}/")
                            for f in tree._fields))
    return values[prefix[:-1]]


def _host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bf16 as its raw bits under a void dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


class _PinnedRing:
    """Device-to-host copies through two pinned buffers of ``STAGE``
    bytes: the card fills one while the host copies the other out. On an
    H100 machine a 4 GB copy into fresh pageable memory ran at 5.9-6.3
    GB/s this way and at 2.4-2.5 GB/s as one pageable copy (``io_probe``)."""

    STAGE = 1 << 28

    def __init__(self):
        self.bufs = [torch.empty(self.STAGE, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(2)]
        self.done = [torch.cuda.Event(), torch.cuda.Event()]
        self.stream = torch.cuda.Stream()

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        if not (src.is_cuda and src.is_contiguous() and src.numel()):
            dst.copy_(src)
            return
        s = src.reshape(-1).view(torch.uint8)
        d = dst.reshape(-1).view(torch.uint8)
        offs = list(range(0, s.numel(), self.STAGE))
        self.stream.wait_stream(torch.cuda.current_stream(src.device))

        def issue(i):
            k = min(self.STAGE, s.numel() - offs[i])
            with torch.cuda.stream(self.stream):
                self.bufs[i % 2][:k].copy_(s[offs[i]:offs[i] + k],
                                           non_blocking=True)
                self.done[i % 2].record(self.stream)
        issue(0)
        for i, off in enumerate(offs):
            if i + 1 < len(offs):
                issue(i + 1)         # the other buffer, copied out at i - 1
            self.done[i % 2].synchronize()
            k = min(self.STAGE, s.numel() - off)
            d[off:off + k].copy_(self.bufs[i % 2][:k])


def snapshot(items: dict) -> dict:
    """Host copies of a flat payload's leaves (the training loop goes on
    mutating the live tensors and arrays in place)."""
    tensors = [t for v in items.values()
               for t in (v if isinstance(v, Stacked) else [v])
               if torch.is_tensor(t)]
    ring = _PinnedRing() if any(t.is_cuda for t in tensors) else None
    copy = ring.copy if ring is not None else (lambda d, s: d.copy_(s))
    out = {}
    for key, v in items.items():
        if isinstance(v, Stacked):
            buf = torch.empty((len(v), *v[0].shape), dtype=v[0].dtype)
            for i, t in enumerate(v):
                copy(buf[i], t.detach())
            out[key] = _host(buf)
        elif torch.is_tensor(v):
            buf = torch.empty(v.shape, dtype=v.dtype)
            copy(buf, v.detach())
            out[key] = _host(buf)
        else:
            out[key] = np.array(v)
    return out


def dtype_name(arr: np.ndarray) -> str:
    """The manifest's dtype name (``bfloat16`` for 2-byte void leaves)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return BF16
    return str(arr.dtype)


def _write_npy(fh, arr: np.ndarray) -> None:
    """``np.lib.format.write_array``'s bytes, the data written straight
    from the array's memory (no per-chunk copies); a bf16 leaf under the
    reference's ``'<V2'`` header."""
    arr = np.require(arr, requirements="C")
    if dtype_name(arr) == BF16:
        header = {"descr": "<V2", "fortran_order": False,
                  "shape": arr.shape}
    else:
        header = np.lib.format.header_data_from_array_1_0(arr)
    np.lib.format.write_array_header_1_0(fh, header)
    if arr.size:
        fh.write(memoryview(arr.reshape(-1).view(np.uint8)))


def write_npz(path, items: dict) -> None:
    """``np.savez``'s archive (stored, zip64 members), with bf16 leaves
    written as the reference writes them."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fh:
                _write_npy(fh, arr)


def _readinto(fh, mv) -> None:
    while len(mv):
        n = fh.readinto(mv)
        if not n:
            raise EOFError("checkpoint member ends early")
        mv = mv[n:]


def read_npz(path, keys):
    """Yield ``(key, array)`` for ``keys`` of a stored npz, each member
    read at its offset in one pass into a fresh array (``np.load`` reads a
    zip member 256 KiB at a time). Each member's CRC-32 is checked on a
    worker thread while the next is read and used, at most one behind; a
    mismatch raises before the generator is exhausted, so a restore fails
    (with its template partly written)."""
    from concurrent.futures import ThreadPoolExecutor

    def check(name, crc, parts):
        got = 0
        for part in parts:
            got = zlib.crc32(part, got)
        if got != crc:
            raise zipfile.BadZipFile(f"{path}: CRC mismatch in {name}")

    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh, \
            ThreadPoolExecutor(1) as pool:
        pending = None
        for key in keys:
            info = zf.getinfo(key + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {key} is compressed")
            fh.seek(info.header_offset)
            local = fh.read(30)
            if local[:4] != b"PK\x03\x04":
                raise zipfile.BadZipFile(f"{path}: no local header for {key}")
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            start = info.header_offset + 30 + n_name + n_extra
            fh.seek(start)
            version = np.lib.format.read_magic(fh)
            if version not in ((1, 0), (2, 0)):
                raise ValueError(f"{path}: {key} is npy format {version}")
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(fh) if version == (1, 0)
                else np.lib.format.read_array_header_2_0(fh))
            head = fh.tell() - start
            fh.seek(start)
            header = fh.read(head)
            arr = np.empty(shape, dtype, order="F" if fortran else "C")
            if info.file_size != head + arr.nbytes:
                raise zipfile.BadZipFile(f"{path}: {key} has "
                                         f"{info.file_size} bytes")
            data = memoryview(arr.reshape(-1, order="A").view(np.uint8))
            _readinto(fh, data)
            if pending is not None:
                pending.result()
            pending = pool.submit(check, key, info.CRC, (header, data))
            yield key, arr
        if pending is not None:
            pending.result()


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A loaded leaf as a CPU tensor; 2-byte void leaves as bf16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.require(arr, requirements="C").view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C"))


@torch.no_grad()
def _load_leaf(tmpl, arr: np.ndarray, key: str):
    if isinstance(tmpl, Stacked):
        want = (len(tmpl), *tmpl[0].shape)
    elif torch.is_tensor(tmpl) or isinstance(tmpl, np.ndarray):
        want = tuple(tmpl.shape)
    else:
        want = ()
    if tuple(arr.shape) != tuple(want):
        raise ValueError(f"{key}: ckpt {arr.shape} != state {want}")
    if isinstance(tmpl, Stacked):
        for i, t in enumerate(tmpl):
            t.copy_(to_torch(arr[i]))
        return tmpl
    if torch.is_tensor(tmpl):
        tmpl.copy_(to_torch(arr))
        return tmpl
    if isinstance(tmpl, np.ndarray):
        # host-side state (the score memory) stays numpy, in its dtype
        return np.asarray(arr, dtype=tmpl.dtype).copy()
    return np.asarray(arr).reshape(())


class Checkpointer:
    def __init__(self, directory, keep=3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread = None
        self._error = None
        self.last_save = {}      # the last save's receipt (seconds, bytes)
        # a process that died mid-write left its nonce dir behind; restore
        # ignores them, but each holds a whole state
        for p in self.dir.glob("step_*.tmp-*"):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)

    # -- write ---------------------------------------------------------------
    def _write(self, step: int, host_items: dict, meta: dict) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f"step_{step}.tmp-{uuid.uuid4().hex[:8]}"
        tmp.mkdir(parents=True)
        write_npz(tmp / "shard_0.npz", host_items)
        t1 = time.perf_counter()
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": {k: {"shape": list(v.shape), "dtype": dtype_name(v)}
                     for k, v in host_items.items()},
            "meta": meta,
            "n_hosts": 1,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "COMMIT").write_text("ok")
        final = self.dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.last_save.update(
            step=step, write_s=t1 - t0, commit_s=time.perf_counter() - t1,
            bytes=sum(p.stat().st_size for p in final.iterdir()))

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def _snapshot(self, state) -> dict:
        t0 = time.perf_counter()
        host = snapshot(flatten(state))
        self.last_save = {"snapshot_s": time.perf_counter() - t0}
        return host

    def save(self, step: int, state, meta=None) -> None:
        """Synchronous save."""
        self.wait()
        self._write(step, self._snapshot(state), meta or {})

    def save_async(self, step: int, state, meta=None) -> None:
        """Snapshot to host memory now; write on a background thread."""
        self.wait()
        host = self._snapshot(state)

        def work():
            try:
                self._write(step, host, meta or {})
            except Exception as e:          # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read ----------------------------------------------------------------
    def steps(self) -> list:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "COMMIT").exists() and "tmp" not in p.name:
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step=None, strict=True, check_topology=True):
        """Restore into the structure of ``template`` -> ``(tree, step)``.

        Tensor leaves (and ``Stacked`` layers) are filled in place; numpy
        leaves come back as new arrays of the template's dtype; scalar
        leaves as 0-d arrays. ``strict=False`` keeps the template's value
        for keys the checkpoint lacks. ``check_topology`` raises
        ``TopologyMismatch`` before reading a shard when the checkpoint
        was written by more than one host."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        if check_topology:
            ckpt_hosts = int(self.manifest(step).get("n_hosts", 1))
            if ckpt_hosts != 1:
                raise TopologyMismatch(ckpt_hosts, 1, step)
        items = flatten(template)
        where = {}
        for shard in sorted(d.glob("shard_*.npz")):
            with zipfile.ZipFile(shard) as zf:
                for name in zf.namelist():
                    where[name[:-len(".npy")]] = shard
        values = {}
        for key, tmpl in items.items():
            if key not in where:
                if not strict:
                    values[key] = tmpl
                    continue
                raise KeyError(f"checkpoint missing {key}")
        for shard in dict.fromkeys(where[k] for k in items if k in where):
            keys = [k for k in items if where.get(k) == shard]
            for key, arr in read_npz(shard, keys):
                values[key] = _load_leaf(items[key], arr, key)
        return _unflatten(template, values), step

    def meta(self, step=None) -> dict:
        return self.manifest(step).get("meta", {})

    def manifest(self, step=None) -> dict:
        """The full manifest (incl. ``n_hosts``, the writer count)."""
        step = step if step is not None else self.latest_step()
        return json.loads(
            (self.dir / f"step_{step}" / "manifest.json").read_text())

    def shards(self, step=None) -> dict:
        """Per-writer shard payloads: ``{host_id: {key: array}}``."""
        step = step if step is not None else self.latest_step()
        out = {}
        for shard in sorted((self.dir / f"step_{step}").glob("shard_*.npz")):
            h = int(shard.stem.split("_", 1)[1])
            with np.load(shard) as z:
                out[h] = {k: z[k] for k in z.files}
        return out
