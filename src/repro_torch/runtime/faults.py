"""Deterministic fault injection (``RunConfig.runtime.faults``;
``repro.runtime.faults``).

A seeded, fully explicit fault schedule threaded through the hook points
the port has — the ``DataPlane`` gather worker and the ``TrainLoop``
step clock — so the failure paths run in ordinary tests instead of
waiting for hardware to die. Off by default; when disabled every
injection site costs one module-attribute check (``_plane is None``).

Schedule grammar (``FaultsConfig.spec``): ``;``-separated entries
``kind@step[:host[:arg]]``.

* ``timeout@3:1``   — host 1's collective attempts at step 3 raise an
  injected deadline error (``arg`` = how many consecutive attempts fail;
  default 1). The port's collectives are single-host identities with no
  deadline envelope yet, so nothing consumes this kind.
* ``gather@4``      — every host's data-plane gather for the step-4 plan
  fails once (the plane's surface-then-retry path).
* ``die@8:1``       — host 1 exits abruptly at step 8 (host death).
* ``slow@5:0:0.4``  — 0.4 s is ADDED to host 0's measured step-5 wall
  time (a deterministic straggler: no real sleep).

Nothing here reads a clock or draws randomness — firing is a pure
function of (schedule, step, host).
"""
from __future__ import annotations

from repro_torch import obs


class FaultInjected(RuntimeError):
    """An injected fault (never raised in production configs)."""


class FaultSpecError(ValueError):
    """A ``FaultsConfig.spec`` string the grammar cannot parse."""


_KINDS = ("timeout", "gather", "die", "slow")


def parse_spec(spec: str):
    """``"kind@step[:host[:arg]];..."`` → tuple of (kind, step, host, arg)
    with host −1 meaning every host."""
    out = []
    for raw in (spec or "").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        try:
            kind, _, where = entry.partition("@")
            parts = where.split(":")
            step = int(parts[0])
            host = int(parts[1]) if len(parts) > 1 else -1
            arg = float(parts[2]) if len(parts) > 2 else 0.0
        except (ValueError, IndexError):
            raise FaultSpecError(
                f"bad fault entry {entry!r} (want kind@step[:host[:arg]])")
        if kind not in _KINDS:
            raise FaultSpecError(f"unknown fault kind {kind!r} in {entry!r}; "
                                 f"have {_KINDS}")
        out.append((kind, step, host, arg))
    return tuple(out)


class FaultPlane:
    """The per-process scheduled-fault state (see module docstring)."""

    def __init__(self, cfg, host_id: int = 0):
        self.host_id = int(host_id)
        self.seed = int(getattr(cfg, "seed", 0))
        self.schedule = parse_spec(getattr(cfg, "spec", ""))
        self._step = -1
        self._fired = {}          # schedule index -> times fired

    def set_step(self, step: int) -> None:
        self._step = int(step)

    def match(self, kind: str, step=None):
        """The scheduled (kind, step, host, arg) entry due NOW for this
        host, consuming one firing; None when nothing is due. ``timeout``
        entries fire ``arg`` times (default once); others fire once."""
        at = self._step if step is None else int(step)
        for idx, f in enumerate(self.schedule):
            k, s, h, arg = f
            if k != kind or s != at or h not in (-1, self.host_id):
                continue
            budget = max(1, int(arg)) if kind == "timeout" else 1
            used = self._fired.get(idx, 0)
            if used >= budget:
                continue
            self._fired[idx] = used + 1
            obs.counter(f"faults.{kind}").inc()
            return f
        return None


_plane = None


def configure(cfg, host_id: int = 0) -> None:
    """Install (or clear) the process-wide fault plane. ``cfg`` is a
    ``FaultsConfig``; disabled or None uninstalls."""
    global _plane
    _plane = (FaultPlane(cfg, host_id)
              if cfg is not None and getattr(cfg, "enabled", False) else None)


def active() -> bool:
    return _plane is not None


def set_step(step: int) -> None:
    """Advance the fault clock (called by the loop; the data plane fires
    against the step it serves)."""
    if _plane is not None:
        _plane.set_step(step)


def raise_if(kind: str, *, op: str = "", step=None) -> None:
    """Raise ``FaultInjected`` when a ``kind`` fault is due for this host
    at the current (or given) step."""
    if _plane is None:
        return
    f = _plane.match(kind, step)
    if f is not None:
        raise FaultInjected(
            f"injected {kind} fault at step {f[1]}"
            + (f" in {op}" if op else ""))


def should(kind: str, step=None) -> bool:
    """True (consuming the firing) when a ``kind`` fault is due."""
    return _plane is not None and _plane.match(kind, step) is not None


def die_if(step=None) -> None:
    """Abrupt host death — ``os._exit``, no atexit/finally, which is what
    a kernel OOM or a pulled cable looks like to the survivors."""
    if _plane is None:
        return
    if _plane.match("die", step) is not None:
        import os
        os._exit(17)


def slow_penalty(step=None) -> float:
    """Seconds to add to the step's measured wall time (a deterministic
    straggler — the monitor sees the latency, the run pays nothing)."""
    if _plane is None:
        return 0.0
    f = _plane.match("slow", step)
    return float(f[3]) if f is not None else 0.0
