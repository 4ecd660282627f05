"""``repro_torch.obs`` — the port's own copy of the process-local
telemetry plane (``repro.obs``'s registry and entry points).

One global registry of typed instruments (counters, gauges,
exponential-bucket histograms, monotonic span timers)::

    from repro_torch import obs

    obs.counter("engine.dispatches").inc()
    with obs.span("engine.dispatch"):
        ...

Disabled (the default) every entry point reduces to a couple of
attribute checks. Instrument names are the ones documented in
``repro/obs/schema.py`` (the lint gate's RL005 holds both packages to
that one schema). Sinks, the telemetry hook and the IS-health layer are
not ported yet: a run's counters are read with ``snapshot()``.

``device_mark`` / ``mark_intervals_ms`` time phases of device work with
CUDA events, which cost no synchronisation: a caller records marks on
the current stream and reads the intervals once its results are on the
host anyway.
"""
from __future__ import annotations

from repro_torch.obs.registry import (Counter, Gauge, Histogram, Registry,
                                      Span)

_registry = Registry(enabled=False)


def get_registry() -> Registry:
    return _registry


def enabled() -> bool:
    return _registry.enabled


def enable(on: bool = True) -> None:
    _registry.enable(on)


def configure(obs_cfg) -> None:
    """Apply an ``ObsConfig`` to the global registry (the enable switch)."""
    _registry.enable(bool(obs_cfg.enabled))


def counter(name: str) -> Counter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)


def span(name: str) -> Span:
    return _registry.span(name)


def device_mark(marks) -> None:
    """Append a CUDA event recorded on the current stream to ``marks``
    (a list); ``None`` records nothing."""
    if marks is None:
        return
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append(ev)


def mark_intervals_ms(marks) -> list:
    """Milliseconds between consecutive marks; waits for the last one."""
    marks[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def snapshot() -> dict:
    return _registry.snapshot()


def reset() -> None:
    _registry.reset()


__all__ = ["Registry", "Counter", "Gauge", "Histogram", "Span",
           "get_registry", "enabled", "enable", "configure",
           "counter", "gauge", "histogram", "span", "device_mark",
           "mark_intervals_ms", "snapshot", "reset"]
