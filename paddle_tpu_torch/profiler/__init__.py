"""Profiler: the port's dispatch-counter registry, ``metrics`` and ``trace``.

``dispatch_counters()`` / ``reset_dispatch_counters()`` keep the JAX
package's names (``paddle_tpu.profiler``) for the counters the serving
engine and the resilience runtime keep. The port has no per-op dispatcher,
so the JAX package's program and flush counters are not here; the
numeric-rescue counters stay in ``resilience.rescue.counters``. ``trace``
is the flight recorder, the stall watchdog and the crash postmortem.
``StepTimer`` is the step-time EMA the checkpoint cadence tuner reads. The
sentinel, attribution and the diagnostics server are not ported yet
(ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import threading
import time
from types import MappingProxyType
from typing import Any, Dict, Mapping, Optional

from . import metrics, trace  # noqa: F401

__all__ = ["StepTimer", "count", "count_labeled", "count_locked", "dispatch_counters",
           "gauge_locked", "metrics", "reset_dispatch_counters", "trace"]

# the keys and what counts them (serving/engine.py, core/lazy.py,
# resilience/, profiler/trace.py, distributed/checkpoint.py)
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
    # the checkpoint pipeline (distributed/checkpoint.py): boundary device
    # snapshots, async vs sync persists, emergency saves that joined an
    # in-flight persist instead of redoing it, and the per-phase time split
    # (the snapshot is the only step-path cost; transfer and commit run on
    # the background persist thread, which writes through count_locked)
    "ckpt_snapshots",
    "ckpt_async_saves",
    "ckpt_sync_saves",
    "ckpt_emergency_joined_inflight",
    "ckpt_snapshot_ms",
    "ckpt_transfer_ms",
    "ckpt_commit_ms",
    "ckpt_pipeline_stall_ms",
    "ckpt_cadence_retunes",
    "ckpt_auto_save_freq",        # a gauge: the cadence tuner's save frequency
)
_FAMILIES = ("serve_shed_reasons", "serve_expire_stages", "fault_sites")

_counters: Dict[str, Any] = {}
# the stall watchdog's thread prunes postmortems and the checkpoint persist
# thread times its phases: their counts take this
_lock = threading.Lock()


def reset_dispatch_counters():
    with _lock:
        _counters.clear()
        _counters.update(dict.fromkeys(_COUNTERS, 0))
        _counters.update({f: {} for f in _FAMILIES})


def count(key: str, n: int = 1):
    _counters[key] += n


def count_locked(key: str, n: int = 1):
    """``count`` for a writer off the main thread (the stall watchdog, the
    checkpoint persist thread)."""
    with _lock:
        _counters[key] += n


def gauge_locked(key: str, value):
    """Set a gauge (``ckpt_auto_save_freq``) from any thread."""
    with _lock:
        _counters[key] = value


def count_labeled(family: str, key: str, n: int = 1):
    fam = _counters[family]
    fam[key] = fam.get(key, 0) + n


def dispatch_counters() -> Mapping[str, Any]:
    """A read-only snapshot; the labeled families are copied too."""
    return MappingProxyType({k: MappingProxyType(dict(v)) if isinstance(v, dict) else v
                             for k, v in _counters.items()})


class StepTimer:
    """Steady-state step-time tracker (``paddle_tpu/profiler/__init__.py:344``):
    an EMA over per-step wall time with drift detection against the value
    at the last ``mark()``. Callers bracket each step with ``lap()`` or feed
    measured durations to ``observe(dt_s)``; the checkpoint cadence tuner
    reads ``ema_ms`` and ``drift_pct()``."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self.ema_ms: Optional[float] = None
        self.total_ms = 0.0
        self.count = 0
        self._marked_ms: Optional[float] = None
        self._lap_t0: Optional[float] = None

    def observe(self, dt_s: float):
        ms = float(dt_s) * 1000.0
        self.total_ms += ms
        self.count += 1
        if self.ema_ms is None:
            self.ema_ms = ms
        else:
            self.ema_ms += self.alpha * (ms - self.ema_ms)
        return self.ema_ms

    def lap(self):
        """Call once per step boundary; the first call only starts the
        clock, each later call records the elapsed step."""
        now = time.perf_counter()
        if self._lap_t0 is not None:
            self.observe(now - self._lap_t0)
        self._lap_t0 = now

    def mark(self):
        """Remember the current EMA as the drift baseline."""
        self._marked_ms = self.ema_ms

    def drift_pct(self) -> float:
        """Percent drift of the EMA from the value at the last mark()."""
        if not self._marked_ms or self.ema_ms is None:
            return 0.0
        return abs(self.ema_ms - self._marked_ms) / self._marked_ms * 100.0


reset_dispatch_counters()
