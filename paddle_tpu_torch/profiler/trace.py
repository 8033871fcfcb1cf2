"""The flight recorder, the step-stall watchdog and the crash postmortem: the
port of ``paddle_tpu/profiler/trace.py``.

A bounded in-memory ring of structured runtime events
``{ts, kind, site, step, attrs}`` emitted at the port's choke points:

  program          every program run, by category
                   (op/segment/backward/optimizer/captured)
  flush            a lazy-segment flush: reason, cache hit/miss
  capture          whole-step capture build/replay/fallback WITH REASON
  serve_capture    a serving bucket program built
  fault / retry    every resilience event: classification, attempt,
                   backoff, disruptive verdict (resilience/runtime.py)
  ladder           degradation-ladder demotions and re-promotions
  serve            serving request lanes: admit/reject/shed/prefill/
                   decode/requeue/complete/error/expire, with request ids,
                   and engine-scoped health/restart/block_leak events
  rescue           a numeric rescue at the optimizer step
  stall            the step-stall watchdog fired
  preempt          a preemption signal reached the step boundary
  postmortem       a postmortem file was written
  perf_regression  a sentinel key tripped or cleared (profiler/sentinel.py)
  telemetry        one step's fused numerics telemetry (attribution.py)
  diag             the diagnostics server started

The ring (``FLAGS_trace_ring_size``, default on) is a ``deque(maxlen=N)``:
append is O(1); with the flag at 0 the emit fast path is a single dict
read. ``chrome_trace_events`` turns events into chrome-trace instants and
per-request async lanes. Crash postmortems dump the event tail, the
unified metrics snapshot, the card's allocator figures, the resilience
state and the attribution triage to ``FLAGS_postmortem_dir`` as JSON.

Host code throughout. The watchdog thread reads only ``perf_counter_ns``
and calls listeners; the postmortems it dumps leave the memory section
``None`` rather than query the card from a second thread. Every postmortem
carries the attribution layer's triage section (``attribution``).
"""
from __future__ import annotations

import json
import os
import threading
import time
import traceback as _tb
from collections import deque
from typing import Any, Dict, List, Optional

from ..core import flags as _flags

__all__ = [
    "TraceEvent",
    "add_stall_listener",
    "chrome_trace_events",
    "clear",
    "dump_postmortem",
    "emit",
    "enabled",
    "events",
    "heartbeat_age_ms",
    "last_postmortem_path",
    "read_postmortem",
    "remove_stall_listener",
    "stall_count",
    "step_heartbeat",
    "watchdog_disarm",
]

# direct reference to the flag registry entry: the emit fast path reads one
# dict key instead of going through flags.flag()'s name normalization
_ring_entry = _flags._registry["trace_ring_size"]

# wall-clock anchor for the perf_counter timestamps events carry
_ANCHOR_WALL = time.time()
_ANCHOR_NS = time.perf_counter_ns()

_ring: Optional[deque] = None
_ring_lock = threading.Lock()  # guards ring (re)creation only, not append
_faults = None  # lazily bound resilience.faults (step auto-fill)


class TraceEvent:
    """One flight-recorder event. ``ts`` is ``time.perf_counter_ns()`` at
    emit; ``wall_time`` derives the absolute time from the module anchor."""

    __slots__ = ("ts", "kind", "site", "step", "attrs")

    def __init__(self, ts: int, kind: str, site: str, step: int,
                 attrs: Optional[Dict[str, Any]]):
        self.ts = ts
        self.kind = kind
        self.site = site
        self.step = step
        self.attrs = attrs

    @property
    def wall_time(self) -> float:
        return _ANCHOR_WALL + (self.ts - _ANCHOR_NS) / 1e9

    def as_dict(self) -> Dict[str, Any]:
        return {
            "ts": round(self.wall_time, 6),
            "kind": self.kind,
            "site": self.site,
            "step": self.step,
            "attrs": dict(self.attrs) if self.attrs else {},
        }

    def __repr__(self):
        a = f" {self.attrs}" if self.attrs else ""
        return f"<TraceEvent {self.kind}/{self.site} step={self.step}{a}>"


def enabled() -> bool:
    return int(_ring_entry["value"]) > 0


def _current_step() -> int:
    global _faults
    if _faults is None:
        from ..resilience import faults as _f

        _faults = _f
    return _faults.current_step()


def emit(kind: str, site: str = "", step: Optional[int] = None, **attrs):
    """Record one event: off mode is a dict read and a falsy test; on mode
    one clock read and a bounded-deque append (no lock: deque.append is
    atomic under the GIL)."""
    size = _ring_entry["value"]
    if not size:
        return None
    size = int(size)
    if size <= 0:
        return None  # a negative flag value means off, not a hot-path raise
    global _ring
    ring = _ring
    if ring is None or ring.maxlen != size:
        # (re)configure after a flag change, carrying the old events over.
        # Creation is locked so two threads racing the first emit cannot
        # each install a ring; copying the old ring may race unlocked
        # appends, so retry and, as a last resort, start empty
        with _ring_lock:
            ring = _ring
            if ring is None or ring.maxlen != size:
                for _ in range(4):
                    try:
                        ring = deque(_ring or (), maxlen=size)
                        break
                    except RuntimeError:
                        continue
                else:
                    ring = deque(maxlen=size)
                _ring = ring
    if step is None:
        step = _current_step()
    ev = TraceEvent(time.perf_counter_ns(), kind, site, step, attrs or None)
    ring.append(ev)
    return ev


def events(last: Optional[int] = None, kind: Optional[str] = None,
           site: Optional[str] = None) -> List[TraceEvent]:
    """Snapshot of the ring, oldest first: optionally only ``kind`` /
    ``site`` events, and of those the trailing ``last``. Safe against
    concurrent emits (the copy retries a 'deque mutated during iteration')."""
    ring = _ring
    if ring is None:
        return []
    if kind is None and site is None:
        keep = None
    else:
        def keep(e):
            return ((kind is None or e.kind == kind)
                    and (site is None or e.site == site))
    for _ in range(8):
        try:
            out = list(ring) if keep is None else [e for e in ring if keep(e)]
            break
        except RuntimeError:
            continue
    else:  # sustained concurrent churn: drain via indexed access
        out = [ring[i] for i in range(len(ring))]
        if keep is not None:
            out = [e for e in out if keep(e)]
    if last is not None and last >= 0:
        out = out[-last:] if last else []
    return out


def clear():
    """Drop every recorded event (test isolation / fresh measurement)."""
    ring = _ring
    if ring is not None:
        ring.clear()


# ---------------------------------------------------------------------------
# Crash postmortems: the event tail + counters + memory + resilience state
# as one JSON file in FLAGS_postmortem_dir.
# ---------------------------------------------------------------------------
_pm_lock = threading.Lock()
_pm_last_path: Optional[str] = None
_pm_seq = 0
_pm_active = False  # re-entrance guard: a postmortem must never postmortem


def last_postmortem_path() -> Optional[str]:
    return _pm_last_path


def dump_postmortem(reason: str, exc: Optional[BaseException] = None,
                    **attrs) -> Optional[str]:
    """Write one postmortem JSON; returns its path, or None when
    ``FLAGS_postmortem_dir`` is unset (the default) or the dump itself
    fails: a diagnostics path must never add a second crash."""
    return _dump(reason, exc, attrs, memory=True)


def _dump(reason, exc, attrs, memory: bool) -> Optional[str]:
    global _pm_last_path, _pm_seq, _pm_active
    directory = str(_flags.flag("postmortem_dir"))
    if not directory:
        return None
    with _pm_lock:
        if _pm_active:
            return None
        _pm_active = True
        try:
            _pm_seq += 1
            seq = _pm_seq
            doc = _build_postmortem(reason, exc, attrs, memory)
            os.makedirs(directory, exist_ok=True)
            name = f"postmortem_{reason}_{os.getpid()}_{seq:04d}.json"
            path = os.path.join(directory, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)
            os.replace(tmp, path)
            _pm_last_path = path
            _prune_postmortems(directory, keep_path=path)
            emit("postmortem", site=reason, path=path)
            return path
        except Exception:
            return None
        finally:
            _pm_active = False


def _prune_postmortems(directory: str, keep_path: Optional[str] = None):
    """Bound the directory to FLAGS_postmortem_keep files, oldest first.
    The just-written dump is never pruned; pruned files are counted
    (``postmortems_pruned``)."""
    keep = int(_flags.flag("postmortem_keep"))
    if keep <= 0:
        return  # 0 = unbounded
    try:
        entries = []
        for name in os.listdir(directory):
            if not (name.startswith("postmortem_") and name.endswith(".json")):
                continue
            p = os.path.join(directory, name)
            try:
                entries.append((os.stat(p).st_mtime, name, p))
            except OSError:
                continue
        if len(entries) <= keep:
            return
        entries.sort()  # oldest first
        pruned = 0
        for _mtime, _name, p in entries[: len(entries) - keep]:
            if keep_path is not None and os.path.abspath(p) == os.path.abspath(keep_path):
                continue
            try:
                os.remove(p)
                pruned += 1
            except OSError:
                continue
        if pruned:
            from .. import profiler

            # locked: the watchdog thread dumps postmortems too
            profiler.count_locked("postmortems_pruned", pruned)
    except Exception:
        pass  # pruning must never fail the dump that triggered it


def _memory_snapshot() -> Optional[Dict[str, Any]]:
    """The caching allocator's figures for the current card, or None when
    the process has not touched CUDA (a CPU run)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    return {
        "device": torch.cuda.get_device_name(dev),
        "memory_allocated_bytes": int(torch.cuda.memory_allocated(dev)),
        "memory_reserved_bytes": int(torch.cuda.memory_reserved(dev)),
        "max_memory_allocated_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }


def _build_postmortem(reason, exc, attrs, memory: bool) -> Dict[str, Any]:
    doc: Dict[str, Any] = {
        "reason": reason,
        "time": time.time(),
        "pid": os.getpid(),
        "attrs": {k: v for k, v in (attrs or {}).items()},
    }
    try:
        doc["step"] = _current_step()
    except Exception:
        doc["step"] = None
    if exc is not None:
        doc["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": _tb.format_exception(type(exc), exc, exc.__traceback__),
        }
    tail = int(_flags.flag("postmortem_events"))
    doc["events"] = [e.as_dict() for e in events(last=max(0, tail))]
    # unified metrics: registry-native + the adopted dispatch counters
    try:
        from . import metrics as _metrics

        doc["metrics"] = _metrics.snapshot(include_dispatch=True)
    except Exception:
        doc["metrics"] = None
    try:
        doc["memory"] = _memory_snapshot() if memory else None
    except Exception:
        doc["memory"] = None
    try:
        from ..resilience import runtime as _rt

        doc["resilience"] = _rt.state()
    except Exception:
        doc["resilience"] = None
    # spike auto-triage (profiler.attribution): which program key's measured
    # EMA moved (and the sentinel-tripped keys), which parameter group's
    # grad-norm broke trend, and the batch's sample ids from the registered
    # GlobalStepSampler
    try:
        from . import attribution as _attribution

        doc["attribution"] = _attribution.triage_section()
    except Exception:
        doc["attribution"] = None
    return doc


def read_postmortem(path: str) -> Dict[str, Any]:
    """Load one postmortem JSON (tools/tests convenience)."""
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Step-stall watchdog (FLAGS_trace_stall_ms): a daemon thread that watches
# the step heartbeat (resilience.runtime.on_step_end) and dumps a 'stall'
# postmortem when no boundary lands inside the threshold. One trip per
# episode; the next heartbeat re-arms.
# ---------------------------------------------------------------------------
_wd_lock = threading.Lock()
_wd_thread: Optional[threading.Thread] = None
# heartbeats are PER SOURCE ('train' from optimizer.step, 'serve[<uid>]'
# from each engine tick): one loop standing its heartbeat down must not
# erase another's liveness signal
_wd_hb: Dict[str, int] = {}
_wd_fired: Dict[str, bool] = {}
_wd_stalls = 0
# consumers of stall trips beyond the postmortem dump: the serving
# Supervisor registers here so a wedged engine tick is observed and the
# engine restarted once the tick returns control
_stall_listeners: List = []


def add_stall_listener(fn):
    """Register ``fn(stalled_ms)``, called from the watchdog thread every
    time the watchdog trips. Listener exceptions are swallowed."""
    with _wd_lock:
        if fn not in _stall_listeners:
            _stall_listeners.append(fn)


def remove_stall_listener(fn):
    with _wd_lock:
        if fn in _stall_listeners:
            _stall_listeners.remove(fn)


def step_heartbeat(source: str = "train"):
    """Step-boundary tick (called from resilience.runtime.on_step_end).
    Re-arms the watchdog for ``source`` and starts it on first use when
    FLAGS_trace_stall_ms > 0."""
    _wd_hb[source] = time.perf_counter_ns()
    _wd_fired[source] = False
    if float(_flags.flag("trace_stall_ms")) > 0 and _wd_thread is None:
        _start_watchdog()


def watchdog_disarm(source: Optional[str] = None):
    """Stand down the watchdog for ``source`` (every source when None)
    until its next heartbeat. A loop that ENDS looks exactly like a
    stalled one, so clean completion disarms (``Engine.run_until_idle``
    and ``Supervisor.run_until_idle`` do)."""
    if source is None:
        _wd_hb.clear()
        _wd_fired.clear()
    else:
        _wd_hb.pop(source, None)
        _wd_fired.pop(source, None)


def stall_count() -> int:
    return _wd_stalls


def heartbeat_age_ms(source: Optional[str] = None) -> Optional[float]:
    """Milliseconds since the last heartbeat of ``source`` (or, when None,
    of the stalest armed source); None when no loop is armed."""
    if source is not None:
        hb = _wd_hb.get(source)
        return None if hb is None else (time.perf_counter_ns() - hb) / 1e6
    beats = list(_wd_hb.values())
    if not beats:
        return None
    return (time.perf_counter_ns() - min(beats)) / 1e6


def _start_watchdog():
    global _wd_thread
    with _wd_lock:
        if _wd_thread is not None:
            return
        t = threading.Thread(target=_watchdog_loop, daemon=True,
                             name="paddle-stall-watchdog")
        _wd_thread = t
        t.start()


def _watchdog_loop():
    global _wd_stalls
    while True:
        ms = float(_flags.flag("trace_stall_ms"))
        if ms <= 0:
            time.sleep(0.25)
            continue
        time.sleep(min(max(ms / 2000.0, 0.005), 0.5))
        now = time.perf_counter_ns()
        for source, hb in list(_wd_hb.items()):
            if _wd_fired.get(source):
                continue
            stalled_ms = (now - hb) / 1e6
            if stalled_ms < ms:
                continue
            _wd_fired[source] = True
            _wd_stalls += 1
            emit("stall", site="watchdog", source=source,
                 stalled_ms=round(stalled_ms, 1), threshold_ms=ms)
            _dump("stall", None, {"source": source, "stalled_ms": round(stalled_ms, 1),
                                  "threshold_ms": ms}, memory=False)
            with _wd_lock:
                listeners = list(_stall_listeners)
            for fn in listeners:
                try:
                    fn(stalled_ms)
                except Exception:
                    pass  # a listener must never take the watchdog down


# ---------------------------------------------------------------------------
# Chrome-trace conversion: flight events become instants on a dedicated
# lane; serving events become per-request async lanes (ph b/n/e keyed by
# request id).
# ---------------------------------------------------------------------------
_FLIGHT_TID = 1
_SERVE_END_PHASES = frozenset(("complete", "error", "reject", "shed", "expire"))


def chrome_trace_events(evts: Optional[List[TraceEvent]] = None):
    pid = os.getpid()
    src = events() if evts is None else evts
    # a request's lane begins at its admit event; a serve event of a request
    # WITHOUT a begin in the window (rejected at submit, or its admit
    # evicted from the ring) renders as a plain instant, since trace viewers
    # drop async events without an enclosing b/e pair
    admitted = {
        (ev.attrs or {}).get("rid")
        for ev in src
        if ev.kind == "serve" and (ev.attrs or {}).get("phase") == "admit"
    }
    out = []
    for ev in src:
        ts_us = ev.ts / 1000.0
        attrs = dict(ev.attrs) if ev.attrs else {}
        if ev.kind == "serve":
            phase = attrs.pop("phase", "")
            rids = attrs.pop("rids", None)
            if rids is None:
                rid = attrs.pop("rid", None)
                rids = [] if rid is None else [rid]
            if not rids:
                # engine-scoped events (health/restart/block_leak)
                out.append({
                    "name": f"serve:{phase}", "cat": "serving",
                    "ph": "i", "s": "t", "ts": ts_us, "pid": pid,
                    "tid": _FLIGHT_TID, "args": dict(attrs, step=ev.step),
                })
                continue
            for rid in rids:
                args = dict(attrs, phase=phase, step=ev.step)
                if rid not in admitted:
                    out.append({
                        "name": f"serve:{phase}", "cat": "serving",
                        "ph": "i", "s": "t", "ts": ts_us, "pid": pid,
                        "tid": _FLIGHT_TID, "args": dict(args, rid=rid),
                    })
                    continue
                if phase == "admit":
                    ph = "b"
                elif phase in _SERVE_END_PHASES:
                    ph = "e"
                else:
                    ph = "n"
                out.append({
                    "name": "request", "cat": "serving", "ph": ph,
                    "id": str(rid), "ts": ts_us, "pid": pid,
                    "tid": _FLIGHT_TID, "args": args,
                })
            continue
        name = ev.kind if not ev.site else f"{ev.kind}:{ev.site}"
        out.append({
            "name": name, "cat": "flight", "ph": "i", "s": "t",
            "ts": ts_us, "pid": pid, "tid": _FLIGHT_TID,
            "args": dict(attrs, step=ev.step),
        })
    return out
