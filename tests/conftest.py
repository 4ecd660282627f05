"""Test bootstrap.

The container has no ``hypothesis`` wheel, so when the real package is
absent we install a minimal deterministic stand-in into ``sys.modules``
*before* test modules import it. The stand-in runs each property test over
a small fixed sample drawn from the declared strategies (seeded PRNG, so
runs are reproducible); with real hypothesis installed it is inert.
"""
from __future__ import annotations

import sys
import types

try:  # pragma: no cover - exercised only where hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    import numpy as _np

    _DEFAULT_EXAMPLES = 8

    class _Strategy:
        def __init__(self, draw, edges=()):
            self._draw = draw
            self._edges = tuple(edges)

        def example(self, rng, i):
            # first calls hit the boundary values, then random interior draws
            if i < len(self._edges):
                return self._edges[i]
            return self._draw(rng)

    def _integers(lo, hi):
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)),
                         edges=(lo, hi))

    def _sampled_from(xs):
        xs = list(xs)
        return _Strategy(lambda rng: xs[int(rng.integers(len(xs)))],
                         edges=xs[:2])

    def _floats(lo=0.0, hi=1.0, **_kw):
        return _Strategy(lambda rng: float(rng.uniform(lo, hi)),
                         edges=(lo, hi))

    def _booleans():
        return _Strategy(lambda rng: bool(rng.integers(2)), edges=(False, True))

    def _given(*strats):
        def deco(fn):
            def run():
                rng = _np.random.default_rng(0)
                n = min(getattr(run, "_max_examples", _DEFAULT_EXAMPLES),
                        _DEFAULT_EXAMPLES)
                for i in range(n):
                    fn(*(s.example(rng, i) for s in strats))

            # plain zero-arg wrapper (no functools.wraps): pytest must NOT
            # see the strategy-filled parameters as fixtures
            run.__name__ = fn.__name__
            run.__doc__ = fn.__doc__
            run.__module__ = fn.__module__
            return run

        return deco

    def _settings(*_a, max_examples=None, **_kw):
        def deco(fn):
            if max_examples is not None:
                fn._max_examples = max_examples
            return fn

        return deco

    mod = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")
    st.integers = _integers
    st.sampled_from = _sampled_from
    st.floats = _floats
    st.booleans = _booleans
    mod.given = _given
    mod.settings = _settings
    mod.assume = lambda cond: None
    mod.strategies = st
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA Hopper GPU and nvcc; skips elsewhere "
        "(run them on the card: python -m pytest -m gpu tests/)")
