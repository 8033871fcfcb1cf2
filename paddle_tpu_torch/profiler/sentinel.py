"""The perf-regression sentinel: the port of ``paddle_tpu/profiler/sentinel.py``.

It keeps a per-key baseline of measured step times and serving latencies
and pages when the measured value drifts away from it and STAYS away.
Keys are step signatures:

  ``train`` / ``train[<sig>]``     inter-step-boundary time fed from
                                   ``resilience.runtime.on_step_end``
                                   (``<sig>`` = the whole-step capture
                                   controller's armed signature id, so a
                                   re-captured step re-baselines); host clock
  ``serve[<uid>]``                 per-engine tick cadence (same hook); host
                                   clock
  ``serve_decode[<uid>:<BxN>]``    per-bucket decode-step ms: the step's CUDA
                                   event pair on the card (read after the
                                   step's tokens, which the engine reads
                                   anyway), the host clock on the CPU
  ``serve_queue_wait[<uid>]``      admission queue wait ms; host clock

Each key runs the same state machine: ``FLAGS_sentinel_warmup_steps``
observations feed the EMA, then the baseline is frozen (``StepTimer.mark``)
and drift detection arms. ``FLAGS_sentinel_sustain_steps`` consecutive
observations past ``FLAGS_sentinel_pct`` slower than baseline trip the
sentinel ONCE (hysteresis: the key stays tripped, and /healthz 503
``degraded``, until drift falls back under half the threshold for the same
sustain count; then it clears and re-baselines to the new steady state). A
trip emits a ``perf_regression`` flight event, increments
``perf_regressions`` (+ the ``perf_regression_sites`` labeled family),
names the key to the attribution layer and dumps a postmortem.

Breaches are SUPPRESSED (not counted, the EMA left untouched) while the
slowdown has a legitimate cause the runtime can see: the degradation ladder
has a tier demoted, a checkpoint persist is running, or a boundary snapshot
landed on the step path this interval. The JAX package's third cause, a
background compile in flight, has no counterpart: the port builds its
programs on the calling thread (``FLAGS_eager_async_compile``).

``FLAGS_sentinel_pct`` = 0 (the default) disables everything; the armed
fast path is one flag read per observation. Host code, copied otherwise.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..core import flags as _flags

_PKG = __name__.split(".")[0]

__all__ = [
    "PerfSentinel",
    "clear_external",
    "default_sentinel",
    "lap",
    "observe",
    "reset",
    "retire",
    "state",
    "trip_external",
    "tripped",
]


class _KeyState:
    __slots__ = ("timer", "seen", "armed", "breach", "clear_streak",
                 "tripped", "trips", "suppressed", "last_suppressed",
                 "last_lap_ns")

    def __init__(self, timer):
        self.timer = timer
        self.seen = 0
        self.armed = False
        self.breach = 0
        self.clear_streak = 0
        self.tripped = False
        self.trips = 0
        self.suppressed = 0
        self.last_suppressed: Optional[str] = None
        self.last_lap_ns: Optional[int] = None


class PerfSentinel:
    """Per-key drift detector over :class:`paddle.profiler.StepTimer`
    EMAs. Thread-safe: the training thread, the serving loop, and a diag
    scrape may touch it concurrently."""

    def __init__(self):
        self._states: Dict[str, _KeyState] = {}
        self._lock = threading.Lock()
        self._last_ckpt_snapshots = 0
        # last lap key PER THREAD: a training loop and a serving loop lap
        # concurrently from different threads, and each one's consecutive
        # same-key laps are a valid cadence — one global last-key would
        # see the alternation and starve both baselines forever
        self._last_key_by_thread: Dict[int, str] = {}

    # -- configuration -------------------------------------------------
    @staticmethod
    def enabled() -> bool:
        return float(_flags.flag("sentinel_pct")) > 0

    # -- feeding -------------------------------------------------------
    def lap(self, key: str):
        """Bracket-style feed: each call observes the time since the
        previous ``lap(key)`` (the on_step_end hook uses this — inter-step
        boundary time IS steady-state step time)."""
        if not self.enabled():
            return
        now = time.perf_counter_ns()
        tid = threading.get_ident()
        actions: List[tuple] = []
        with self._lock:
            st = self._state_locked(key)
            # only CONSECUTIVE same-key laps OF THIS THREAD form an
            # interval: when one loop's step signature switches (capture
            # re-arms, a fallback step), the key's stale clock would read
            # as a wall-time gap — a fake spike
            old_key = self._last_key_by_thread.get(tid)
            prev = st.last_lap_ns if old_key == key else None
            if old_key is not None and old_key != key:
                # this thread is the old key's only feeder: once it moves
                # on (capture re-arm retires train[<old-sig>]), the key
                # gets no further observations, so a tripped latch could
                # never run its hysteresis clear — /healthz would stay 503
                # on a baseline nothing measures anymore. Unlatch it (keep
                # the timer: consecutive laps may resume later).
                ost = self._states.get(old_key)
                if ost is not None and ost.tripped:
                    ost.tripped = False
                    ost.breach = 0
                    ost.clear_streak = 0
                    actions.append(
                        ("clear", old_key, self._signed_drift_pct(ost), ost))
            st.last_lap_ns = now
            self._last_key_by_thread[tid] = key
        for action in actions:
            self._report(*action)
        if prev is not None:  # the first lap only starts the clock
            self.observe(key, (now - prev) / 1e6)

    def observe(self, key: str, ms: float):
        """One measured duration for ``key``; runs the full baseline /
        drift / hysteresis state machine."""
        if not self.enabled():
            return
        pct = float(_flags.flag("sentinel_pct"))
        warmup = max(1, int(_flags.flag("sentinel_warmup_steps")))
        sustain = max(1, int(_flags.flag("sentinel_sustain_steps")))
        suppressed = self._suppression_reason()
        actions: List[tuple] = []
        with self._lock:
            st = self._state_locked(key)
            if suppressed is not None:
                # a legitimately slow phase must neither count toward a
                # trip nor poison the baseline/EMA it will be judged by
                st.breach = 0
                st.suppressed += 1
                st.last_suppressed = suppressed
                return
            st.timer.observe(ms / 1000.0)
            st.seen += 1
            if not st.armed:
                if st.seen >= warmup:
                    st.armed = True
                    st.timer.mark()  # freeze the baseline
                return
            drift = self._signed_drift_pct(st)
            if not st.tripped:
                # a breach needs the smoothed EMA AND this observation
                # past the threshold: one huge spike inflates the EMA for
                # several steps, but the follow-up steps being fast again
                # means nothing is SUSTAINED — reset, don't page
                base = st.timer._marked_ms or 0.0
                obs_slow = base > 0 and ms > base * (1.0 + pct / 100.0)
                st.breach = st.breach + 1 if (drift > pct and obs_slow) else 0
                if st.breach >= sustain:
                    st.tripped = True
                    st.trips += 1
                    st.breach = 0
                    actions.append(("trip", key, drift, st))
            else:
                # hysteresis: clear only after the drift falls back under
                # HALF the threshold and stays there — flapping around the
                # line must not re-page every other step
                st.clear_streak = (st.clear_streak + 1
                                   if drift < pct / 2.0 else 0)
                if st.clear_streak >= sustain:
                    st.tripped = False
                    st.clear_streak = 0
                    st.timer.mark()  # adopt the new steady state
                    actions.append(("clear", key, drift, st))
        for action in actions:  # emit/dump outside the lock
            self._report(*action)

    @staticmethod
    def _signed_drift_pct(st: _KeyState) -> float:
        base = st.timer._marked_ms
        ema = st.timer.ema_ms
        if not base or ema is None:
            return 0.0
        # SIGNED: only slowdowns are regressions — a step getting faster
        # must never page
        return (ema - base) / base * 100.0

    # -- suppression ---------------------------------------------------
    def _suppression_reason(self) -> Optional[str]:
        import sys

        try:
            from ..resilience import ladder as _ladder

            if _ladder.degradation_ladder().any_demoted():
                return "ladder_demoted"
        except Exception:
            pass
        ck = sys.modules.get(_PKG + ".distributed.checkpoint")
        if ck is not None:
            try:
                if ck.persists_in_flight():
                    return "checkpoint_in_flight"
            except Exception:
                pass
        try:
            from .. import profiler

            snaps = int(profiler._counters.get("ckpt_snapshots", 0) or 0)
            if snaps != self._last_ckpt_snapshots:
                # a boundary snapshot ran on the step path this interval
                self._last_ckpt_snapshots = snaps
                return "checkpoint_snapshot"
        except Exception:
            pass
        return None

    # -- reporting -----------------------------------------------------
    def _report(self, what: str, key: str, drift: float, st: _KeyState):
        try:
            from .. import profiler

            if what == "trip":
                profiler.count_locked("perf_regressions")
                profiler.count_labeled_locked("perf_regression_sites", key)
            else:
                profiler.count_locked("perf_regression_clears")
        except Exception:
            pass
        if what == "trip":
            try:
                # attribution triage: record the tripped key so the
                # postmortem's attribution section names the regressed
                # program key even when the cost registry's own drift
                # arithmetic disagrees with the sentinel's
                from . import attribution as _attribution

                _attribution.note_regression(key, drift)
            except Exception:
                pass
        try:
            from . import trace as _trace

            _trace.emit(
                "perf_regression", site=key, phase=what,
                drift_pct=round(drift, 2),
                baseline_ms=round(st.timer._marked_ms or 0.0, 3),
                ema_ms=round(st.timer.ema_ms or 0.0, 3),
                trips=st.trips,
            )
            if what == "trip":
                _trace.dump_postmortem(
                    "perf_regression", site=key,
                    drift_pct=round(drift, 2),
                    baseline_ms=round(st.timer._marked_ms or 0.0, 3),
                    ema_ms=round(st.timer.ema_ms or 0.0, 3),
                )
        except Exception:
            pass  # the sentinel must never add a second failure

    def _state_locked(self, key: str) -> _KeyState:
        st = self._states.get(key)
        if st is None:
            from . import StepTimer

            st = _KeyState(StepTimer())
            self._states[key] = st
        return st

    # -- introspection -------------------------------------------------
    def tripped(self) -> List[str]:
        """Keys currently in the tripped state (what /healthz degrades on)."""
        with self._lock:
            return sorted(k for k, st in self._states.items() if st.tripped)

    def state(self) -> Dict[str, Any]:
        """Detached snapshot for /statusz, tests, and bench."""
        with self._lock:
            keys = {}
            for k, st in self._states.items():
                keys[k] = {
                    "seen": st.seen,
                    "armed": st.armed,
                    "baseline_ms": (None if st.timer._marked_ms is None
                                    else round(st.timer._marked_ms, 3)),
                    "ema_ms": (None if st.timer.ema_ms is None
                               else round(st.timer.ema_ms, 3)),
                    "drift_pct": round(self._signed_drift_pct(st), 2),
                    "breach_streak": st.breach,
                    "tripped": st.tripped,
                    "trips": st.trips,
                    "suppressed": st.suppressed,
                    "last_suppressed": st.last_suppressed,
                }
        return {
            "enabled": self.enabled(),
            "pct": float(_flags.flag("sentinel_pct")),
            "warmup_steps": int(_flags.flag("sentinel_warmup_steps")),
            "sustain_steps": int(_flags.flag("sentinel_sustain_steps")),
            "tripped": sorted(k for k, v in keys.items() if v["tripped"]),
            "keys": keys,
        }

    # -- externally driven keys (fleet straggler detector) ----------------
    def trip_external(self, key: str, **attrs):
        """Latch `key` tripped on behalf of an EXTERNAL detector (the
        fleet StragglerDetector compares this worker against the fleet
        median — a judgment no in-process EMA can make). The key degrades
        /healthz like any sentinel trip and stays latched until
        clear_external / retire. Idempotent while latched."""
        with self._lock:
            st = self._state_locked(key)
            if st.tripped:
                return
            st.tripped = True
            st.trips += 1
        self._report("trip", key, float(attrs.get("drift_pct", 0.0)),
                     self._states[key])

    def clear_external(self, key: str):
        """Clear an externally tripped key (the detector observed the
        worker back under the fleet threshold)."""
        with self._lock:
            st = self._states.get(key)
            if st is None or not st.tripped:
                return
            st.tripped = False
            st.breach = 0
            st.clear_streak = 0
        self._report("clear", key, 0.0, st)

    def retire(self, prefix: str):
        """Drop every key starting with ``prefix`` (Engine.close retires
        its ``serve_decode[<uid>:``/``serve_queue_wait[<uid>]`` keys). A
        retired key gets no further observations, so a tripped latch could
        never clear — it would hold /healthz at 503 'degraded' long after
        the regressed engine is gone, and per-engine key state would grow
        with replica churn. Tripped keys report a clear on the way out."""
        actions: List[tuple] = []
        with self._lock:
            for k in [k for k in self._states if k.startswith(prefix)]:
                st = self._states.pop(k)
                if st.tripped:
                    actions.append(
                        ("clear", k, self._signed_drift_pct(st), st))
            self._last_key_by_thread = {
                tid: k for tid, k in self._last_key_by_thread.items()
                if not k.startswith(prefix)}
        for action in actions:
            self._report(*action)

    def reset(self):
        """Drop every key (test isolation / fresh measurement window)."""
        with self._lock:
            self._states.clear()
            self._last_ckpt_snapshots = 0
            self._last_key_by_thread.clear()


_default = PerfSentinel()


def default_sentinel() -> PerfSentinel:
    """The process-wide sentinel the runtime hooks feed."""
    return _default


def lap(key: str):
    _default.lap(key)


def observe(key: str, ms: float):
    _default.observe(key, ms)


def tripped() -> List[str]:
    return _default.tripped()


def state() -> Dict[str, Any]:
    return _default.state()


def trip_external(key: str, **attrs):
    _default.trip_external(key, **attrs)


def clear_external(key: str):
    _default.clear_external(key)


def retire(prefix: str):
    _default.retire(prefix)


def reset():
    _default.reset()
