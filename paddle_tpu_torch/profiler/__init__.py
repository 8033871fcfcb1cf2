"""Profiler: the port of ``paddle_tpu/profiler/__init__.py``.

``Profiler`` composes the host spans of ``RecordEvent`` with the device
trace: where the JAX package starts ``jax.profiler`` (XPlane), the port
runs a ``torch.profiler`` session with the CPU and CUDA activities (Kineto
over CUPTI on the card) and writes its chrome trace into the directory the
export's metadata names (``device_trace_dir``). Inside a session
``RecordEvent`` also opens a ``torch.profiler.record_function``, the
counterpart of ``TraceAnnotation``. ``make_scheduler``,
``export_chrome_tracing``, ``export_protobuf``, ``load_profiler_result``,
``summary()`` (``statistic``) and ``benchmark()`` keep the JAX package's
behaviour.

``dispatch_counters()`` / ``reset_dispatch_counters()`` keep the JAX
package's names (``paddle_tpu/core/dispatch.py:174``) for the counters the
eager dispatcher, the serving engine, the resilience runtime and the ops
plane keep. ``measure_programs`` counts the programs of one steady-state
step, with the memory estimate of a captured step beside the allocator's
figures (``_memory``) and the resilience state (``_resilience``).
``program_costs`` is the attribution layer's per-program profile. The
numeric-rescue counters stay in ``resilience.rescue.counters``. ``trace``
is the flight recorder, ``metrics`` the typed registry, ``attribution``
the program costs and telemetry, ``sentinel`` the perf-regression
sentinel and ``diag`` the diagnostics server.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from enum import Enum
from types import MappingProxyType
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

from . import metrics, trace  # noqa: F401

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent", "SortedKeys",
           "StepTimer", "SummaryView", "attribution", "benchmark", "count", "count_labeled",
           "count_locked", "diag", "dispatch_counters", "export_chrome_tracing",
           "export_protobuf", "gauge_locked", "load_profiler_result", "make_scheduler",
           "measure_programs", "metrics", "program_costs", "reset_dispatch_counters",
           "sentinel", "trace"]

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
    # the ops plane (profiler/attribution.py, sentinel.py): programs
    # registered with the cost registry, sentinel trips and clears, steps
    # of fused telemetry recorded and the groups that spiked
    "program_registrations",
    "perf_regressions",
    "perf_regression_clears",
    "telemetry_steps",
    "telemetry_spikes",
    # static analysis and the memory plan (analysis/, optimizer/offload.py):
    # remat plans built and failed (a failure falls back unplanned), live
    # aliases of storages a captured program writes in place, and the
    # equivalence certificates of captured steps and serving rungs
    "memory_plan_builds",
    "memory_plan_failures",
    "donation_alias_flags",
    "capture_equivalence_checks",
    "capture_equivalence_certified",
    "capture_equivalence_divergences",
    "capture_equivalence_unprovable",
    "serve_equivalence_checks",
    "serve_equivalence_certified",
    "serve_equivalence_divergences",
)
_FAMILIES = ("serve_shed_reasons", "serve_expire_stages", "fault_sites", "flush_reasons",
             "capture_fallback_reasons", "perf_regression_sites", "telemetry_spike_groups")

_KEYS = frozenset(_COUNTERS + _FAMILIES)
_counters: Dict[str, Any] = {}
# the stall watchdog's thread prunes postmortems and the checkpoint persist
# thread times its phases: their counts take this
_lock = threading.Lock()


def reset_dispatch_counters():
    """Zero every counter in place: the key set never shrinks, so a scrape
    on another thread never sees a counter missing mid-reset."""
    with _lock:
        for k in [k for k in _counters if k not in _KEYS]:
            del _counters[k]
        _counters.update(dict.fromkeys(_COUNTERS, 0))
        _counters.update({f: {} for f in _FAMILIES})


def count(key: str, n: int = 1):
    _counters[key] += n


def count_program(category: str):
    """One program of ``category`` (op, segment, backward, optimizer,
    captured) and one of the total, and its ``program`` flight event."""
    _counters[category + "_programs"] += 1
    _counters["programs"] += 1
    trace.emit("program", site=category)


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


def count_labeled_locked(family: str, key: str, n: int = 1):
    """``count_labeled`` for a writer off the main thread (the sentinel, the
    telemetry record)."""
    with _lock:
        count_labeled(family, key, n)


def dispatch_counters() -> Mapping[str, Any]:
    """A read-only snapshot; the labeled families are copied too. Safe from
    another thread (a diagnostics scrape): a copy that races a new label
    key is taken again."""
    for _ in range(8):
        try:
            return MappingProxyType({k: MappingProxyType(dict(v)) if isinstance(v, dict) else v
                                     for k, v in list(_counters.items())})
        except RuntimeError:  # a family grew during the copy
            continue
    with _lock:
        return MappingProxyType({k: MappingProxyType(dict(v)) if isinstance(v, dict) else v
                                 for k, v in _counters.items()})


def measure_programs(step_fn, *args, warmup: int = 2, **kwargs):
    """The dispatch counters of ONE steady-state ``step_fn`` call
    (``paddle_tpu/profiler/__init__.py:400``): ``warmup`` calls first (with
    whole-step capture on, the steps that arm it), then the pending lazy
    segment is flushed, the counters are zeroed, one call is measured and
    flushed again so its trailing lazy ops count. Returns a plain dict of
    the counters, with the step's result in ``_step_result``,
    ``lazy.step_capture_state()`` in ``_capture_state``, the allocator's
    figures and, after a captured replay, the planner's estimate of the
    captured step in ``_memory``, and ``resilience.runtime.state()`` in
    ``_resilience``."""
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
    counters["_memory"] = _memory_snapshot(counters)
    try:
        from ..resilience import runtime as _resilience_rt

        counters["_resilience"] = _resilience_rt.state()
    except Exception:  # measurement must never break the profiled step
        counters["_resilience"] = None
    return counters


def _memory_snapshot(counters):
    """The allocator's live figures at the step boundary (None on a CPU
    run) and, when a whole-step capture replayed the step, the liveness
    planner's estimate of the captured program (``analysis.memory``): the
    estimated-against-measured pair of the JAX package's
    ``_memory_snapshot``."""
    import torch

    snap: Dict[str, Any] = {"live_buffer_bytes": None, "live_buffer_count": None}
    try:
        if torch.cuda.is_initialized():
            dev = torch.cuda.current_device()
            snap["live_buffer_bytes"] = int(torch.cuda.memory_allocated(dev))
            snap["live_buffer_count"] = int(
                torch.cuda.memory_stats(dev).get("active.all.current", 0))
            snap["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    except Exception:
        pass
    if int(counters.get("capture_replays", 0) or 0) > 0:
        try:
            from ..analysis import memory as _mem

            plans = _mem.captured_step_plans()
            if plans is not None:
                plan, _no_donation = plans
                snap["estimated_captured_peak_bytes"] = int(plan.peak_bytes)
                snap["estimated_captured_boundary_bytes"] = int(plan.boundary_bytes)
                snap["estimated_donation_credit_bytes"] = int(plan.donation_credit_bytes)
        except Exception:
            pass  # measurement must never break the profiled step
    return snap


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


# ---------------------------------------------------------------------------
# The profiler session: scheduler states, host spans, the device trace
# ---------------------------------------------------------------------------
class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    GPUTotal = 3


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6


_host_events = []
_events_lock = threading.Lock()
_device_sessions = [0]  # torch.profiler sessions running (RecordEvent annotates inside)


class RecordEvent:
    """Host-side annotation (reference: profiler/utils.py RecordEvent). A
    context manager or ``begin()`` / ``end()``; its span joins the host
    events the export and ``summary()`` read, and inside a device session
    it also opens a ``torch.profiler.record_function`` of its name."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None
        self._annot = None

    def begin(self):
        self._t0 = time.perf_counter_ns()
        if _device_sessions[0]:
            try:
                import torch

                self._annot = torch.profiler.record_function(self.name)
                self._annot.__enter__()
            except Exception:
                self._annot = None

    def end(self):
        if self._annot is not None:
            self._annot.__exit__(None, None, None)
            self._annot = None
        if self._t0 is not None:
            t1 = time.perf_counter_ns()
            with _events_lock:
                _host_events.append({
                    "name": self.name,
                    "ph": "X",
                    "ts": self._t0 / 1000.0,
                    "dur": (t1 - self._t0) / 1000.0,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() % 100000,
                    "cat": "host",
                })
            self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """reference: profiler.py make_scheduler, the step-phase state machine."""

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        cycle = closed + ready + record
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """reference: profiler.py export_chrome_tracing callback."""

    def handle(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_time_{int(time.time())}.paddle_trace.json")
        prof.export(path, "json")
        return path

    return handle


def export_protobuf(dir_name: str, worker_name=None):
    """on_trace_ready factory writing the trace as a length-prefixed binary
    blob around the chrome-trace JSON (reference: profiler.py
    export_protobuf), as the JAX package writes it."""
    import struct

    def _handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_{int(time.time())}.pb")
        tmp = path + ".json"
        prof.export(tmp, "json")
        with open(tmp) as f:
            payload = f.read().encode()
        os.remove(tmp)
        with open(path, "wb") as f:
            f.write(b"PDTRACE1" + struct.pack("<Q", len(payload)) + payload)
        return path

    return _handler


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)


class Profiler:
    """reference: profiler.py:43 Profiler, host and device tracers together.

    Device side: a ``torch.profiler`` session with the CPU activity and,
    when ``targets`` name the GPU and CUDA is there, the CUDA activity
    (CUPTI); its chrome trace goes to ``device_trace_dir`` (under
    ``PADDLE_PROFILER_DIR``, else the temporary directory) when the
    recording window closes. Host side: RecordEvent spans and the flight
    recorder's events, exported as one chrome-trace JSON by ``export``."""

    def __init__(self, *, targets: Optional[Iterable] = None, scheduler=None,
                 on_trace_ready=None, record_shapes=False, profile_memory=False,
                 timer_only=False, with_flops=False):
        self._scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = make_scheduler(
                closed=max(0, lo), ready=0, record=hi - lo, repeat=1)
        self._targets = list(targets) if targets is not None else [
            ProfilerTarget.CPU, ProfilerTarget.GPU]
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._with_flops = with_flops
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._device_dir = None
        self._session = None

    def start(self):
        self._state = self._scheduler(self._step)
        if self._state in _RECORDING:
            self._start_device()

    def _activities(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if ProfilerTarget.GPU in self._targets and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _start_device(self):
        if self._session is not None or self._timer_only:
            return
        import torch

        self._device_dir = os.path.join(
            os.environ.get("PADDLE_PROFILER_DIR",
                           os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_prof")),
            f"{int(time.time() * 1000)}_{os.getpid()}")
        os.makedirs(self._device_dir, exist_ok=True)
        try:
            self._session = torch.profiler.profile(
                activities=self._activities(), record_shapes=self._record_shapes,
                profile_memory=self._profile_memory, with_flops=self._with_flops)
            self._session.__enter__()
            _device_sessions[0] += 1
        except Exception:
            self._session = None

    def _stop_device(self):
        if self._session is None:
            return
        session, self._session = self._session, None
        _device_sessions[0] -= 1
        try:
            session.__exit__(None, None, None)
            session.export_chrome_trace(os.path.join(self._device_dir, "device.pt.trace.json"))
        except Exception:
            pass  # the host export still names the directory

    def step(self, num_samples: Optional[int] = None):
        self._step += 1
        new_state = self._scheduler(self._step)
        if new_state != self._state:
            if new_state in _RECORDING:
                self._start_device()
            elif self._state in _RECORDING:
                self._stop_device()
                if self._on_trace_ready:
                    self._on_trace_ready(self)
            self._state = new_state

    def stop(self):
        if self._state in _RECORDING:
            self._stop_device()
            if self._on_trace_ready:
                self._on_trace_ready(self)
        self._state = ProfilerState.CLOSED

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def export(self, path: str, format: str = "json"):
        """Write the merged chrome trace: RecordEvent host spans, the flight
        recorder's runtime events (instants, and per-request async lanes for
        serving) and the attribution layer's per-program counter lanes; the
        device trace's directory is named in the metadata."""
        with _events_lock:
            events = list(_host_events)
        flight = trace.events()
        events = events + trace.chrome_trace_events(flight)
        counter_events = attribution.chrome_counter_events()
        events = events + counter_events
        doc = {
            "traceEvents": events,
            "metadata": {
                "device_trace_dir": self._device_dir,
                "framework": "paddle_tpu_torch",
                "flight_recorder_events": len(flight),
                "program_counter_samples": len(counter_events),
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return path

    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms", views=None):
        """reference: profiler_statistic.py, the Overview + Operator report."""
        from .statistic import build_summary_report

        with _events_lock:
            events = list(_host_events)
        key = {
            SortedKeys.CPUTotal: "total",
            SortedKeys.CPUAvg: "avg",
            SortedKeys.CPUMax: "max",
        }.get(sorted_by, "total")
        table = build_summary_report(events, sorted_by=key, time_unit=time_unit)
        print(table)
        return table


def load_profiler_result(path: str):
    with open(path) as f:
        return json.load(f)


class _Timer:
    """Throughput timer (reference: python/paddle/profiler/timer.py)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = None
        self._n = 0
        self._elapsed = 0.0

    def step(self, num_samples=1):
        now = time.perf_counter()
        if self._start is not None:
            self._elapsed += now - self._start
            self._n += num_samples
        self._start = now

    def ips(self):
        return self._n / self._elapsed if self._elapsed else 0.0


benchmark_timer = _Timer()


def benchmark():
    return benchmark_timer


def program_costs(top_k: int = 5, static: bool = True):
    """Per-program cost profiles (``attribution.program_costs``): the static
    FLOP/byte/top-ops estimate of every registered program paired with its
    measured EMA."""
    return attribution.program_costs(top_k=top_k, static=static)


# the ops plane: imported last, they reach back into this package
from . import attribution  # noqa: E402
from . import sentinel  # noqa: E402
from . import diag  # noqa: E402
