"""Graceful-degradation ladder over the execution tiers: the port of
``paddle_tpu/resilience/ladder.py``, host code copied as it is.

The tiers form a ladder, and repeated faults at a tier *demote* it: the
runtime stops attempting that tier and the step runs one rung down, with
identical numerics. After a cooldown of clean steps the tier is
re-promoted and the fast path is tried again — a capture-with-fallback
loop driven by observed fault history.

In the port the ladder's clients are the serving engine (each
prefill/decode bucket program keyed by its signature at the ``captured``
tier, so a disruptive fault demotes that ONE bucket from its CUDA graph to
the retained rung while every other bucket keeps replaying its graph) and
the eager dispatcher (a captured training step keyed by its step
signature at ``captured``; lazy segments at ``lazy``, demoted globally,
which ``runtime.lazy_tier_ok`` reads). The state machine takes any tier
name, as the JAX one does.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, Optional, Tuple

from ..core import flags

__all__ = ["DegradationLadder", "LadderPolicy", "TIERS", "degradation_ladder"]

# ladder rungs, fastest first; per_op is the floor and never demotes
TIERS = ("captured", "lazy", "per_op")


class LadderPolicy:
    """Demotion/re-promotion thresholds. Defaults read the FLAGS_ladder_*
    values at access time so flag changes apply live; explicit values pin."""

    def __init__(self, demote_after: Optional[int] = None,
                 cooldown_steps: Optional[int] = None):
        self._demote_after = demote_after
        self._cooldown = cooldown_steps

    @property
    def demote_after(self) -> int:
        if self._demote_after is not None:
            return self._demote_after
        return int(flags.flag("ladder_demote_after"))

    @property
    def cooldown_steps(self) -> int:
        if self._cooldown is not None:
            return self._cooldown
        return int(flags.flag("ladder_cooldown_steps"))

    def __repr__(self):
        return (f"LadderPolicy(demote_after={self.demote_after}, "
                f"cooldown_steps={self.cooldown_steps})")


class _TierState:
    __slots__ = ("faults", "demoted", "clean_steps", "fault_this_step")

    def __init__(self):
        self.faults = 0
        self.demoted = False
        self.clean_steps = 0
        self.fault_this_step = False


class DegradationLadder:
    """Fault-history state machine per (tier, key)."""

    def __init__(self, policy: Optional[LadderPolicy] = None):
        self.policy = policy or LadderPolicy()
        self._states: Dict[Tuple[str, Hashable], _TierState] = {}

    def _state(self, tier: str, key: Hashable) -> _TierState:
        st = self._states.get((tier, key))
        if st is None:
            st = _TierState()
            self._states[(tier, key)] = st
        return st

    def allows(self, tier: str, key: Hashable = None) -> bool:
        """May the runtime attempt `tier` (for step-signature `key`)?"""
        if tier == "per_op":
            return True
        st = self._states.get((tier, key))
        if st is not None and st.demoted:
            return False
        if key is not None:
            st = self._states.get((tier, None))
            if st is not None and st.demoted:
                return False
        return True

    def record_fault(self, tier: str, key: Hashable = None):
        """One DISRUPTIVE fault observed at `tier` (fatal, or transient with
        retries exhausted — recovered retries re-run the same program and
        don't count; see runtime._record_fault)."""
        if tier == "per_op":
            return  # the floor: faults there are retried, never demoted
        st = self._state(tier, key)
        st.faults += 1
        st.fault_this_step = True
        st.clean_steps = 0
        if not st.demoted and st.faults >= self.policy.demote_after:
            st.demoted = True
            self._count("ladder_demotions")
            self._emit("demote", tier, key, st.faults)

    def step_end(self):
        """Step-boundary tick: demoted tiers accrue clean steps and
        re-promote after the cooldown."""
        for (tier, _key), st in list(self._states.items()):
            if st.demoted:
                if not st.fault_this_step:
                    st.clean_steps += 1
                if st.clean_steps >= self.policy.cooldown_steps:
                    st.demoted = False
                    st.faults = 0
                    st.clean_steps = 0
                    self._count("ladder_promotions")
                    self._emit("promote", tier, _key, 0)
            st.fault_this_step = False

    def any_demoted(self) -> bool:
        """Cheap gate for the perf-regression sentinel: a demoted tier IS
        slower — that slowdown is resilience working, not a regression."""
        return any(st.demoted for st in self._states.values())

    def state(self) -> Dict[str, Any]:
        """Snapshot for profiler/bench introspection."""
        demoted = sorted(
            tier + ("" if key is None else f"[{key}]")
            for (tier, key), st in self._states.items() if st.demoted
        )
        return {
            "policy": repr(self.policy),
            "demoted": demoted,
            "tracked": len(self._states),
            "faults": {
                tier + ("" if key is None else f"[{key}]"): st.faults
                for (tier, key), st in self._states.items() if st.faults
            },
        }

    def reset(self):
        self._states.clear()

    @staticmethod
    def _count(name: str):
        from .. import profiler

        profiler.count(name)

    @staticmethod
    def _emit(action: str, tier: str, key, faults: int):
        from ..profiler import trace

        trace.emit("ladder", site=tier, action=action,
                   key=None if key is None else str(key), faults=faults)


_ladder = DegradationLadder()


def degradation_ladder() -> DegradationLadder:
    """The process-wide ladder instance the execution runtime consults."""
    return _ladder
