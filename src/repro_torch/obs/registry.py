"""Typed instruments + the process-local metrics registry.

The telemetry plane's core invariant is that instrumentation must be
safe to leave in the hot paths permanently: every instrument is gated on
the registry's ``enabled`` flag at RECORD time (one attribute read), so
a disabled registry reduces ``counter.inc()`` / ``with span:`` to a
couple of Python attribute checks — no locks, no clocks, no dict
traffic. Instruments are therefore always *real* objects: code captures
them once (``obs.counter("plane.gather.calls")``) and the same handle
is live or inert as the registry is enabled or disabled, in either
order.

Instrument kinds:

* ``Counter`` — monotonic count (``inc``). Snapshot value: int.
* ``Gauge`` — last-written scalar (``set``). Snapshot value: float.
* ``Histogram`` — exponential power-of-two buckets: a value ``v`` lands
  in bucket ``e`` iff ``2^(e-1) <= |v| < 2^e`` (``math.frexp``, so
  bucketing is one C call — no log, no search). Tracks count/sum/min/max
  alongside the buckets. Snapshot value:
  ``{"count", "sum", "min", "max", "avg", "buckets": {str(e): n}}``.
* ``Span`` — a monotonic wall-clock timer (``time.perf_counter``) over a
  ``with`` block, recording seconds into its histogram. Spans nest
  (per-thread stack, exception-safe); worker threads time their own
  stages concurrently without interference.

Thread-safety: get-or-create goes through one registry lock; record-time
mutation relies on per-instrument locks only where a read-modify-write
spans several bytecodes (histograms). Counter/gauge writes are single
attribute stores under the GIL — a lost increment under pathological
contention costs a tick of telemetry, never correctness, which is the
right trade for the hot path.
"""
from __future__ import annotations

import math
import threading
import time


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, registry, name):
        self._reg = registry
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if self._reg.enabled:
            self.value += n

    def snapshot(self):
        return int(self.value)


class Gauge:
    """Last-written scalar."""

    kind = "gauge"

    def __init__(self, registry, name):
        self._reg = registry
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        if self._reg.enabled:
            self.value = float(v)

    def snapshot(self):
        return float(self.value)


class Histogram:
    """Exponential (power-of-two) bucket histogram.

    Bucket ``e`` holds values with ``2^(e-1) <= |v| < 2^e`` (frexp's
    exponent); zero and negative-or-zero magnitudes land in the
    dedicated ``"0"`` bucket. Exponential buckets are the right shape
    for both durations (ns .. minutes) and sizes (bytes .. GiB) with a
    few dozen buckets and no a-priori range choice.
    """

    kind = "histogram"

    def __init__(self, registry, name):
        self._reg = registry
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = {}

    @staticmethod
    def bucket_of(v: float):
        """The bucket key of a value (the frexp exponent, or 0 for 0)."""
        v = abs(float(v))
        if v == 0.0:
            return 0
        return math.frexp(v)[1]

    def observe(self, v) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        e = self.bucket_of(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self.buckets[e] = self.buckets.get(e, 0) + 1

    def snapshot(self):
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0, "min": None, "max": None,
                        "avg": None, "buckets": {}}
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max,
                    "avg": self.sum / self.count,
                    "buckets": {str(e): n
                                for e, n in sorted(self.buckets.items())}}


class Span(Histogram):
    """Monotonic wall-clock timer over a ``with`` block.

    Reusable and nest-safe: each thread keeps its own stack of start
    times, so ``with obs.span("a"): ...`` can nest inside itself (retry
    loops) and run concurrently on pipeline worker threads. Seconds are
    recorded into the inherited histogram.
    """

    kind = "span"

    def __init__(self, registry, name):
        super().__init__(registry, name)
        self._local = threading.local()

    def __enter__(self):
        if self._reg.enabled:
            stack = getattr(self._local, "stack", None)
            if stack is None:
                stack = self._local.stack = []
            # repro-lint: disable=RL001 -- span timing is telemetry; the
            # measured duration is written to sinks, never into plan bytes
            stack.append(time.perf_counter())
        return self

    def __exit__(self, exc_type, exc, tb):
        # guard the pop: the registry may have been enabled mid-span
        # (start missing) or disabled (drop the measurement silently)
        stack = getattr(self._local, "stack", None)
        if stack:
            t0 = stack.pop()
            # repro-lint: disable=RL001 -- same: span duration goes to
            # telemetry sinks only, never into plan bytes
            self.observe(time.perf_counter() - t0)
        return False


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "span": Span}


class Registry:
    """Get-or-create registry of named instruments.

    One per process in practice (``repro.obs`` owns the global one), but
    plain enough that tests instantiate their own. Names are flat dotted
    strings (``"plane.gather"``, ``"store.gather_cache.hits"``) — the
    metric-name schema is documented in the README's instrument
    catalogue. A name maps to exactly one instrument kind; asking for
    the same name as a different kind is a hard error (silent aliasing
    would corrupt both series).
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._instruments = {}

    # -- lifecycle -----------------------------------------------------------
    def enable(self, on: bool = True) -> None:
        self.enabled = bool(on)

    def reset(self) -> None:
        """Zero every instrument IN PLACE: handles captured before the
        reset stay registered and keep recording, so long-lived call
        sites never observe a dead instrument."""
        with self._lock:
            for name, inst in self._instruments.items():
                if inst.kind == "counter":
                    inst.value = 0
                elif inst.kind == "gauge":
                    inst.value = 0.0
                else:
                    inst.count, inst.sum = 0, 0.0
                    inst.min, inst.max = math.inf, -math.inf
                    inst.buckets = {}

    # -- get-or-create -------------------------------------------------------
    def _get(self, kind: str, name: str):
        inst = self._instruments.get(name)
        if inst is not None:
            if inst.kind != kind:
                raise ValueError(f"instrument {name!r} already registered "
                                 f"as a {inst.kind}, requested {kind}")
            return inst
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = _KINDS[kind](self, name)
                self._instruments[name] = inst
            elif inst.kind != kind:
                raise ValueError(f"instrument {name!r} already registered "
                                 f"as a {inst.kind}, requested {kind}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._get("histogram", name)

    def span(self, name: str) -> Span:
        return self._get("span", name)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat ``{name: value}`` dict of every instrument's current
        state (counters → int, gauges → float, histograms/spans → the
        bucket dict). JSON-able as-is — this is what sinks flush."""
        with self._lock:
            insts = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in sorted(insts)}

    def names(self) -> list:
        with self._lock:
            return sorted(self._instruments)
