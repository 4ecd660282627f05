"""Straggler mitigation (``repro.runtime.straggler``).

The monitor keeps an EMA of step wall time and a deadline (factor ×
EMA). Three mitigations, in escalation order:

1. shrink the importance-sampling pre-sample B toward b (the elastic part
   of the step; it trades variance reduction for wall time, never
   correctness);
2. signal the caller to skip the straggling step and re-issue the batch
   (bounded by ``max_skips``) — ``StragglerHook`` turns it into the loop's
   retry vote;
3. escalate: with the shrink floored AND the skip budget spent the host
   is persistently slow; ``StragglerHook`` raises ``MembershipChange``.

Health is visible through the ``straggler.*`` obs instruments (inert
when telemetry is disabled).
"""
from __future__ import annotations

import dataclasses

from repro_torch import obs


@dataclasses.dataclass
class StragglerState:
    ema: float = 0.0
    count: int = 0
    skips: int = 0
    b_scale: float = 1.0   # multiplier on presample ratio (1.0 = full B)


class StragglerMonitor:
    def __init__(self, deadline_factor=2.0, alpha=0.9, max_skips=3,
                 min_b_scale=1 / 3):
        self.f = deadline_factor
        self.alpha = alpha
        self.max_skips = max_skips
        self.min_b_scale = min_b_scale
        self.state = StragglerState()
        self._g_ema = obs.gauge("straggler.ema_s")
        self._g_deadline = obs.gauge("straggler.deadline_s")
        self._g_b_scale = obs.gauge("straggler.b_scale")
        self._c_skips = obs.counter("straggler.skips")

    def deadline(self):
        if self.state.count < 5:
            return float("inf")
        return self.f * self.state.ema

    def observe(self, dt: float):
        """Record a step time; returns an action dict. ``escalate`` goes
        True only once the milder rungs are spent: over deadline with the
        batch shrink floored and the skip budget exhausted."""
        st = self.state
        over = st.count >= 5 and dt > self.f * st.ema
        st.ema = (dt if st.count == 0
                  else self.alpha * st.ema + (1 - self.alpha) * dt)
        st.count += 1
        action = {"over_deadline": over, "b_scale": st.b_scale,
                  "skip": False, "escalate": False}
        if over:
            if st.b_scale > self.min_b_scale:
                st.b_scale = max(self.min_b_scale, st.b_scale * 0.5)
                action["b_scale"] = st.b_scale
            elif st.skips < self.max_skips:
                st.skips += 1
                action["skip"] = True
                self._c_skips.inc()
            else:
                action["escalate"] = True
        else:
            st.skips = 0
            st.b_scale = min(1.0, st.b_scale * 1.1)
            action["b_scale"] = st.b_scale
        self._g_ema.set(st.ema)
        if st.count >= 5:              # warm-up deadline is inf: not a stat
            self._g_deadline.set(self.f * st.ema)
        self._g_b_scale.set(st.b_scale)
        return action
