"""Profiler: the port's dispatch-counter registry, ``metrics`` and ``trace``.

``dispatch_counters()`` / ``reset_dispatch_counters()`` keep the JAX
package's names (``paddle_tpu.profiler``) for the counters the serving
engine and the resilience runtime keep. The port has no per-op dispatcher,
so the JAX package's program and flush counters are not here; the
numeric-rescue counters stay in ``resilience.rescue.counters``. ``trace``
is the flight recorder, the stall watchdog and the crash postmortem. The
sentinel, attribution and the diagnostics server are not ported yet
(ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import threading
from types import MappingProxyType
from typing import Any, Dict, Mapping

from . import metrics, trace  # noqa: F401

__all__ = ["count", "count_labeled", "count_locked", "dispatch_counters", "metrics",
           "reset_dispatch_counters", "trace"]

# the keys and what counts them (serving/engine.py, core/lazy.py,
# resilience/, profiler/trace.py)
_COUNTERS = (
    "serve_prefills",             # prefill programs run
    "serve_decode_steps",         # decode batches run
    "serve_capture_builds",       # first call of a captured program (graph built)
    "serve_capture_replays",      # every later call of one
    "serve_capture_evictions",    # programs dropped by the LRU cap
    "serve_capture_fallbacks",    # a captured or retained rung failed
    "serve_admission_refusals",   # a request that can never fit the pool
    "serve_requests_completed",
    "serve_requests_rejected",
    "serve_requests_shed",        # 'overloaded' responses
    "serve_requests_dropped",     # accepted, never answered (must stay 0)
    "serve_request_requeues",
    "serve_preempt_drains",
    "serve_deadline_expired",
    "serve_health_transitions",
    "serve_block_leaks",          # blocks still out at idle (must stay 0)
    "serve_engine_restarts",      # Engine.restart (the Supervisor's budgeted ones)
    "fault_events",               # every fault resilience.runtime.execute saw
    "injected_faults",            # ... of them from FLAGS_fault_inject (and nan:grads)
    "transient_faults",
    "fatal_faults",
    "retry_attempts",
    "retry_exhausted",
    "retry_backoff_ms",           # summed backoff delay, ms
    "ladder_demotions",
    "ladder_promotions",
    "preemptions",                # PreemptionGuard signals
    "emergency_saves",
    "postmortems_pruned",         # postmortem files dropped past FLAGS_postmortem_keep
)
_FAMILIES = ("serve_shed_reasons", "serve_expire_stages", "fault_sites")

_counters: Dict[str, Any] = {}
# the stall watchdog's thread prunes postmortems too: its counts take this
_lock = threading.Lock()


def reset_dispatch_counters():
    _counters.clear()
    _counters.update(dict.fromkeys(_COUNTERS, 0))
    _counters.update({f: {} for f in _FAMILIES})


def count(key: str, n: int = 1):
    _counters[key] += n


def count_locked(key: str, n: int = 1):
    """``count`` for a writer off the main thread (the stall watchdog)."""
    with _lock:
        _counters[key] += n


def count_labeled(family: str, key: str, n: int = 1):
    fam = _counters[family]
    fam[key] = fam.get(key, 0) + n


def dispatch_counters() -> Mapping[str, Any]:
    """A read-only snapshot; the labeled families are copied too."""
    return MappingProxyType({k: MappingProxyType(dict(v)) if isinstance(v, dict) else v
                             for k, v in _counters.items()})


reset_dispatch_counters()
