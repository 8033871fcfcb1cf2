"""Profiler: the port's dispatch-counter registry, ``metrics`` and ``trace``.

``dispatch_counters()`` / ``reset_dispatch_counters()`` keep the JAX
package's names (``paddle_tpu.profiler``, ``paddle_tpu/core/dispatch.py:174``)
for the counters the eager dispatcher, the serving engine and the
resilience runtime keep: programs by category (one per Paddle-level op
call, lazy segment, backward sweep, optimizer update or captured step),
the lazy segment and capture caches, the fallback-reason families and the
host-time split that ``bench.py``'s ``_host_breakdown`` reads.
``measure_programs`` counts the programs of one steady-state step. The
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
           "gauge_locked", "measure_programs", "metrics", "reset_dispatch_counters", "trace"]

# the keys and what counts them (serving/engine.py, core/lazy.py,
# resilience/, profiler/trace.py, distributed/checkpoint.py)
_COUNTERS = (
    # eager dispatch (core/dispatch.py, core/lazy.py): programs by category.
    # An op program is one Paddle-level call run at once (an outermost
    # layer or functional call with Tensor arguments, an apply); a segment
    # program one lazy flush; a backward program one autograd sweep; an
    # optimizer program one optimizer.step() update; a captured program one
    # whole step (or one accumulate-only microstep) run as one program
    "programs",
    "op_programs",
    "segment_programs",
    "backward_programs",
    "optimizer_programs",
    "captured_programs",
    "segments_flushed",
    "lazy_ops_deferred",
    "segment_cache_hits",
    "segment_cache_misses",
    "segment_cache_evictions",
    "segment_graph_builds",       # a segment's forward and backward CUDA graphs captured
    "segment_graph_replays",
    "segment_graph_invalidations",  # a segment's graphs dropped: a parameter or buffer rebound
    "jit_cache_evictions",        # the output-spec cache's LRU
    "capture_builds",
    "capture_replays",
    "capture_fallbacks",
    "capture_evictions",
    "capture_invalidations",      # an entry dropped: parameters or state rebound
    "capture_accum_builds",
    "capture_accum_replays",
    # the JAX package's background-build counters, kept under its names:
    # always 0 here, where builds are synchronous (FLAGS_eager_async_compile)
    "capture_async_builds",
    "capture_build_pending_steps",
    "async_compiles",
    "async_compile_joins",
    "async_compile_skipped",
    "async_bridge_flushes",
    # host time, ms: recording (spec inference included), a program's
    # first build, cached runs, and background builds (0: see above)
    "trace_time_ms",
    "compile_time_ms",
    "replay_time_ms",
    "async_compile_ms",
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
_FAMILIES = ("serve_shed_reasons", "serve_expire_stages", "fault_sites", "flush_reasons",
             "capture_fallback_reasons")

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


def count_program(category: str):
    """One program of ``category`` (op, segment, backward, optimizer,
    captured) and one of the total."""
    _counters[category + "_programs"] += 1
    _counters["programs"] += 1


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


def measure_programs(step_fn, *args, warmup: int = 2, **kwargs):
    """The dispatch counters of ONE steady-state ``step_fn`` call
    (``paddle_tpu/profiler/__init__.py:400``): ``warmup`` calls first (with
    whole-step capture on, the steps that arm it), then the pending lazy
    segment is flushed, the counters are zeroed, one call is measured and
    flushed again so its trailing lazy ops count. Returns a plain dict of the counters, with the step's result in
    ``_step_result`` and ``lazy.step_capture_state()`` in
    ``_capture_state``."""
    from ..core import lazy

    for _ in range(max(0, warmup)):
        step_fn(*args, **kwargs)
    lazy.flush_if_pending("measure_programs")
    reset_dispatch_counters()
    out = step_fn(*args, **kwargs)
    lazy.flush_if_pending("measure_programs")
    counters = {k: dict(v) if isinstance(v, Mapping) else v
                for k, v in dispatch_counters().items()}
    counters["_step_result"] = out
    counters["_capture_state"] = lazy.step_capture_state()
    return counters


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
