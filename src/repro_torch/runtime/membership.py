"""Cluster membership as a runtime event (``repro.runtime.membership``).

A ``MembershipEvent`` records the facts of a membership transition —
which stable host uids survive, which departed, and at which loop step
it was detected. ``MembershipChange`` is the control-flow spelling: the
straggler escalation (``StragglerHook``) and a data-plane gather that
loses a peer raise it. The reference's loop catches it and reshards onto
the survivors; the port has no elastic runtime yet, so it leaves ``fit``
with the data plane stopped.

Hosts are identified by a stable **uid** (their process index at
launch, never reused); a host's **rank** is its position in the sorted
surviving-member tuple. This module is leaf-level (stdlib only).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """The facts of one membership transition.

    ``members`` is the SORTED tuple of surviving host uids. An empty
    tuple means the survivors are unknown (a bare collective timeout).
    """

    kind: str                 # "leave" | "join" | "timeout" | "straggler"
    step: int = -1            # loop step at detection (-1 = pre-loop)
    members: tuple = ()       # surviving host uids, sorted ascending
    departed: tuple = ()      # uids that left (empty for joins)
    reason: str = ""

    @property
    def n_hosts(self) -> int:
        return len(self.members)


class MembershipChange(RuntimeError):
    """The pod cannot proceed under its current membership. Carries the
    ``MembershipEvent`` so a catcher need not re-derive the facts."""

    def __init__(self, event: MembershipEvent):
        super().__init__(f"membership change ({event.kind}): "
                         f"{event.reason or 'collective deadline exceeded'}")
        self.event = event
