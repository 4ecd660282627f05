"""Telemetry sinks: where registry snapshots go (``repro.obs.sinks``,
copied: the port writes the same bytes for the same records).

One tiny interface — ``write(record)`` / ``close()`` — behind which live:

* ``JsonlSink`` (default) — one JSON object per line, one rotating file
  per process (``obs-p{proc}.{gen}.jsonl``): the greppable, tail-able
  production format. Rotation is size-based so a week-long run cannot
  fill a disk with telemetry; generations rotate in place and the
  ``path`` property always names the live file.
* ``ConsoleSink`` — compact one-line summaries (debug runs).
* ``TensorBoardSink`` — scalar summaries in TensorBoard's event-file
  format, written WITHOUT any tensorboard/protobuf dependency: the
  Event proto is hand-encoded (wire format) and framed as TFRecords
  with the masked CRC-32C the reader requires. Only scalars (counters,
  gauges, and histogram count/avg) are exported — enough for the
  step-time/τ/variance dashboards.

Records are the ``TelemetryHook``'s flush unit::

    {"event": "step" | "loop_start" | "loop_end",
     "step": int, "ts": float, "proc": int,
     "metrics": {<registry snapshot> + step metrics}}

(the documented JSONL schema of ``repro/obs/schema.py``; the port's
records use only its names).
"""
from __future__ import annotations

import json
import struct
from pathlib import Path


class Sink:
    """Base sink: every record is dropped. Subclasses override."""

    def write(self, record: dict) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """Rotating one-JSON-object-per-line file sink."""

    def __init__(self, directory, *, proc: int = 0, rotate_mb: float = 64.0,
                 prefix: str = "obs"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.proc = int(proc)
        self.prefix = prefix
        self.rotate_bytes = max(int(rotate_mb * (1 << 20)), 1 << 16)
        self._gen = 0
        self._fh = None
        self._open()

    @property
    def path(self) -> Path:
        return self.dir / f"{self.prefix}-p{self.proc}.{self._gen}.jsonl"

    def _open(self):
        self._fh = open(self.path, "a", encoding="utf-8")

    def write(self, record: dict) -> None:
        self._fh.write(json.dumps(record, sort_keys=True, default=float))
        self._fh.write("\n")
        self._fh.flush()
        if self._fh.tell() >= self.rotate_bytes:
            self._fh.close()
            self._gen += 1
            self._open()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ConsoleSink(Sink):
    """Compact per-flush console line (debugging)."""

    def __init__(self, printer=print):
        self.printer = printer

    def write(self, record: dict) -> None:
        metrics = record.get("metrics", {})
        scalars = {k: v for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        keys = sorted(scalars)[:8]
        body = " ".join(f"{k}={scalars[k]:.4g}" for k in keys)
        self.printer(f"[obs] {record.get('event', '?')} "
                     f"step={record.get('step', -1)} {body}", flush=True)


# ---------------------------------------------------------------------------
# TensorBoard event-file scalars, dependency-free
# ---------------------------------------------------------------------------
def _crc32c_table():
    poly = 0x82F63B78                      # Castagnoli, reflected
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right 15 and add a constant."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _encode_scalar_event(wall_time: float, step: int, tag: str,
                         value: float) -> bytes:
    """Hand-encoded ``Event{wall_time, step, summary{value{tag,
    simple_value}}}`` (tensorboard's event.proto, wire format)."""
    tag_b = tag.encode("utf-8")
    val = (_field(1, 2) + _varint(len(tag_b)) + tag_b            # tag
           + _field(2, 5) + struct.pack("<f", float(value)))     # simple_value
    summary = _field(1, 2) + _varint(len(val)) + val             # Summary.value
    ev = (_field(1, 1) + struct.pack("<d", float(wall_time))     # wall_time
          + _field(2, 0) + _varint(int(step) & (1 << 64) - 1)    # step
          + _field(5, 2) + _varint(len(summary)) + summary)      # summary
    return ev


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


class TensorBoardSink(Sink):
    """Scalar summaries in TensorBoard's ``events.out.tfevents.*``
    format. Counters and gauges export directly; histograms/spans export
    their ``count`` and ``avg`` as two scalar series. Point
    ``tensorboard --logdir`` at the directory."""

    def __init__(self, directory, *, proc: int = 0, run: str = "run"):
        import time
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._path = self.dir / f"events.out.tfevents.{int(time.time())}" \
                                f".{run}.p{proc}"
        self._fh = open(self._path, "ab")
        # file-version header record: readers skip files without it
        self._fh.write(_tfrecord(
            _field(1, 1) + struct.pack("<d", time.time())
            + _field(3, 2) + _varint(len(b"brain.Event:2"))
            + b"brain.Event:2"))

    @property
    def path(self) -> Path:
        return self._path

    def write(self, record: dict) -> None:
        import time
        ts = record.get("ts", time.time())
        step = int(record.get("step", 0))
        for tag, v in record.get("metrics", {}).items():
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                self._fh.write(_tfrecord(
                    _encode_scalar_event(ts, step, tag, v)))
            elif isinstance(v, dict) and v.get("count"):
                self._fh.write(_tfrecord(_encode_scalar_event(
                    ts, step, tag + ".count", v["count"])))
                if v.get("avg") is not None:
                    self._fh.write(_tfrecord(_encode_scalar_event(
                        ts, step, tag + ".avg", v["avg"])))
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def make_sink(cfg, *, proc: int = 0) -> Sink:
    """``ObsConfig`` → sink instance (the ``obs.sink`` config knob)."""
    kind = cfg.sink
    if kind in (None, "none", ""):
        return Sink()
    if kind == "jsonl":
        return JsonlSink(cfg.dir, proc=proc, rotate_mb=cfg.rotate_mb)
    if kind == "console":
        return ConsoleSink()
    if kind == "tensorboard":
        return TensorBoardSink(cfg.dir, proc=proc)
    raise ValueError(f"unknown obs sink {kind!r}; "
                     f"have ('jsonl', 'console', 'tensorboard', 'none')")
