"""``paddle.resilience`` for the port: the numeric-rescue policies
(``FLAGS_numeric_rescue``) over the fused update's non-finite sentinel.

Not ported yet (ROADMAP, open items): fault injection, retry, the
degradation ladder, preemption and the runtime's ``execute`` wrapper.
"""
from __future__ import annotations

from . import rescue  # noqa: F401
from .rescue import Abort, LRBackoff, RescuePolicy, SkipStep  # noqa: F401

__all__ = ["Abort", "LRBackoff", "RescuePolicy", "SkipStep", "rescue"]
