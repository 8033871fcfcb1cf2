"""``paddle.resilience`` for the port: the fault-tolerant runtime of
``paddle_tpu/resilience``, host code with its error classification
re-derived for CUDA.

  faults      deterministic fault injection (FLAGS_fault_inject)
  retry       transient-vs-fatal classification + capped exponential backoff
  ladder      graceful degradation: repeated faults demote a serving bucket
              from its CUDA graph to the retained rung, cooldown re-promotes
  rescue      the fused non-finite sentinel's skip/lr-backoff/abort policies
              (FLAGS_numeric_rescue)
  preemption  SIGTERM/SIGINT guard → emergency checkpoint → Preempted
  runtime     the execute() wrapper binding it all to the serving engine's
              rungs and the fused optimizer update

Every retry, fault, demotion and emergency save is counted in
paddle_tpu_torch.profiler.dispatch_counters(); numeric rescues in
``rescue.counters``.
"""
from __future__ import annotations

from . import faults, ladder, preemption, rescue, retry, runtime  # noqa: F401
from .faults import (  # noqa: F401
    FaultClause,
    FaultPlan,
    InjectedCompileError,
    InjectedExecuteError,
    InjectedFault,
    InjectedHang,
    current_step,
    parse_fault_spec,
)
from .ladder import DegradationLadder, LadderPolicy, degradation_ladder  # noqa: F401
from .preemption import Preempted, PreemptionGuard  # noqa: F401
from .rescue import Abort, LRBackoff, RescuePolicy, SkipStep  # noqa: F401
from .retry import RetryPolicy, is_transient  # noqa: F401
from .runtime import execute, on_step_end, reset, state  # noqa: F401

__all__ = [
    "Abort",
    "DegradationLadder",
    "FaultClause",
    "FaultPlan",
    "InjectedCompileError",
    "InjectedExecuteError",
    "InjectedFault",
    "InjectedHang",
    "LRBackoff",
    "LadderPolicy",
    "Preempted",
    "PreemptionGuard",
    "RescuePolicy",
    "RetryPolicy",
    "SkipStep",
    "current_step",
    "degradation_ladder",
    "execute",
    "is_transient",
    "on_step_end",
    "parse_fault_spec",
    "rescue",
    "reset",
    "state",
]
