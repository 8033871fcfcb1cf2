"""Per-program cost profiles, fused numerics telemetry and spike triage:
the port of ``paddle_tpu/profiler/attribution.py``.

1. **Program cost registry.** Every program the port builds registers here
   at build time: a per-op call (``op:<name>``), a lazy segment
   (``segment:<sig>``), a captured whole step (``captured:<sig>``), a
   captured accumulate-only microstep (``accum:<sig>``), a serving prefill
   or decode bucket (``serve:<kind>:<uid>:...``), with a *static* cost
   profile (FLOP and byte estimates and the top ops over the port's IR,
   ``analysis``: the aten ops one run of the program issued, recorded by a
   dispatch mode during a run that happens anyway, plus one entry per
   hand-written kernel launch; and the liveness planner's estimated peak,
   ``analysis.memory``) paired with a *measured* EMA. Which clock measures
   a key is said where it is fed: per-op calls, segments and the step laps
   use the host clock (the same ``perf_counter`` brackets that book
   ``replay_time_ms``); a captured step on the card uses a CUDA event pair
   per entry, read at the key's next run without a synchronisation; a
   serving bucket uses the engine's step events. Step-boundary laps land
   here too (``train[<sig>]`` / ``serve[<uid>]`` keys, category ``step``).
   Exposed as :func:`program_costs`, the ``/programz`` endpoint, labeled
   ``program_cost_*`` metric families and per-program chrome-trace counter
   lanes in ``Profiler.export``.

2. **Fused numerics telemetry** (``FLAGS_telemetry``, default off). The
   fused optimizer update (the fused-update kernels' telemetry variant, or
   torch sums beside the rule's update) produces one stacked
   ``(n_params, 3)`` f32 vector of per-parameter sums of squares of the
   gradient, the parameter and the applied update, in the same program and
   with bitwise-identical step numerics. :func:`record_telemetry` reduces
   it per parameter *group* (the name prefix up to the last ``.``) into
   grad-norm, param-norm and update-ratio gauges, a bounded history ring,
   spike detection against each group's own EMA, and one ``telemetry``
   flight event per step.

3. **Spike auto-triage.** :func:`triage_section`, attached to every crash
   postmortem, reports which keys' measured EMAs drifted from their frozen
   baselines (with their top ops), the keys the perf sentinel tripped, the
   last telemetry records and the groups whose grad-norm broke trend, and
   the offending batch's sample ids recovered from the registered
   ``GlobalStepSampler``.

Everything here is diagnostics: every entry point swallows its own
failures, holds no strong references to models or buffers (the IR holds
shapes and dtypes only) and bounds its own memory. Host code, copied from
the JAX package where the JAX package's IR is not involved.
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import flags as _flags

__all__ = [
    "chrome_counter_events",
    "costs_summary",
    "flush_telemetry",
    "group_names",
    "known",
    "measure_record_cost_ms",
    "note_regression",
    "note_run",
    "program_costs",
    "push_telemetry",
    "record_telemetry",
    "register",
    "register_sampler",
    "reset",
    "retire",
    "step_lap",
    "telemetry_active",
    "telemetry_record_cost_ms",
    "telemetry_state",
    "telemetry_summary",
    "triage_section",
]

# program categories the registry recognizes (the five executable kinds
# plus the step-boundary laps)
CATEGORIES = ("op", "segment", "captured", "accum", "serve", "step")

_EMA_ALPHA = 0.25
# measured runs before a key's baseline EMA freezes (the value triage
# drifts are judged against)
_BASELINE_RUNS = 5
_MAX_PROGRAMS = 512  # LRU bound on registry entries
_MAX_SAMPLES = 2048  # bound on the chrome counter-lane sample ring


class _Program:
    """One registered executable (or step key) and its measured state."""

    __slots__ = (
        "key", "category", "runs", "ema_ms", "last_ms", "total_ms",
        "baseline_ms", "builds", "registered_step", "ir_thunk",
        "donated", "extras", "_static", "m_ms", "m_runs",
    )

    def __init__(self, key: str, category: str):
        self.key = key
        self.category = category
        self.runs = 0
        self.ema_ms: Optional[float] = None
        self.last_ms: Optional[float] = None
        self.total_ms = 0.0
        self.baseline_ms: Optional[float] = None
        self.builds = 0
        self.registered_step: Optional[int] = None
        self.ir_thunk: Optional[Callable] = None
        self.donated = 0
        self.extras: Dict[str, Any] = {}
        self._static: Any = None  # None = not computed; dict or False
        self.m_ms = None  # cached Gauge / Counter handles (lazy)
        self.m_runs = None

    def drift_pct(self) -> Optional[float]:
        if not self.baseline_ms or self.ema_ms is None:
            return None
        return (self.ema_ms - self.baseline_ms) / self.baseline_ms * 100.0


_lock = threading.Lock()
_programs: "OrderedDict[str, _Program]" = OrderedDict()
_samples: deque = deque(maxlen=_MAX_SAMPLES)  # (ts_ns, key, ms) counter lane
_lap_by_thread: Dict[int, tuple] = {}  # tid -> (key, perf_ns)
_regressions: deque = deque(maxlen=32)  # sentinel-tripped keys, newest last


def _current_step() -> Optional[int]:
    try:
        from ..resilience import faults as _faults

        return _faults.current_step()
    except Exception:
        return None


def known(key: str) -> bool:
    return key in _programs


def register(key: str, category: str, *, ir_thunk: Optional[Callable] = None,
             donated: int = 0, **extras) -> None:
    """Register one program's static side at build time. Idempotent per
    key: the first registration's thunks win (a later auto-registration
    from ``note_run`` never clobbers them); re-registration after an
    eviction re-arms the static profile. ``ir_thunk`` returns the
    program's recorded ``analysis.Program`` (or None); the profile over it
    is computed at the first :func:`program_costs` read."""
    try:
        with _lock:
            prog = _programs.get(key)
            if prog is None:
                prog = _Program(key, category)
                _programs[key] = prog
                while len(_programs) > _MAX_PROGRAMS:
                    _programs.popitem(last=False)
            else:
                _programs.move_to_end(key)
            prog.builds += 1
            if ir_thunk is not None and prog.ir_thunk is None:
                prog.ir_thunk = ir_thunk
                prog._static = None  # (re)compute on next read
            if donated:
                prog.donated = int(donated)
            if extras:
                prog.extras.update(extras)
            if prog.registered_step is None:
                prog.registered_step = _current_step()
        try:
            from .. import profiler

            profiler.count_locked("program_registrations")
        except Exception:
            pass
    except Exception:
        pass  # registration must never break a compile


def note_run(key: str, category: str, dt_ms: float) -> None:
    """One measured steady-state run of ``key`` (the same duration the
    dispatch timers book to ``replay_time_ms``). Auto-registers unknown
    keys (without a static profile) so a registry that was reset mid-run
    keeps attributing."""
    try:
        with _lock:
            prog = _programs.get(key)
            if prog is None:
                prog = _Program(key, category)
                _programs[key] = prog
                while len(_programs) > _MAX_PROGRAMS:
                    _programs.popitem(last=False)
            else:
                # keep the bound a true LRU: a hot key (the captured step,
                # run every step) must never evict before a cold one just
                # because it registered first
                _programs.move_to_end(key)
            prog.runs += 1
            prog.last_ms = dt_ms
            prog.total_ms += dt_ms
            if prog.ema_ms is None:
                prog.ema_ms = dt_ms
            else:
                prog.ema_ms += _EMA_ALPHA * (dt_ms - prog.ema_ms)
            if prog.baseline_ms is None and prog.runs >= _BASELINE_RUNS:
                prog.baseline_ms = prog.ema_ms
            gauge, counter = prog.m_ms, prog.m_runs
        _samples.append((time.perf_counter_ns(), key, dt_ms))
        if gauge is None:
            from . import metrics as _metrics

            reg = _metrics.default_registry()
            labels = {"program": key, "category": category}
            gauge = reg.gauge(
                "program_cost_measured_ms",
                doc="measured wall-time EMA per program key, ms",
                labels=labels)
            counter = reg.counter(
                "program_cost_runs",
                doc="measured steady-state runs per program key",
                labels=labels)
            with _lock:
                p = _programs.get(key)
                if p is not None:
                    p.m_ms, p.m_runs = gauge, counter
        gauge.set(prog.ema_ms)
        counter.inc()
    except Exception:
        pass  # measurement must never break the measured program


def step_lap(key: str) -> None:
    """Step-boundary lap (``resilience.runtime.on_step_end``): consecutive
    same-key laps of one thread feed a ``step``-category EMA — the
    host-inclusive view a program timer cannot see (a sleep between steps
    slows ``train[<sig>]`` without touching ``captured:<sig>``)."""
    try:
        now = time.perf_counter_ns()
        tid = threading.get_ident()
        prev = _lap_by_thread.get(tid)
        _lap_by_thread[tid] = (key, now)
        if prev is not None and prev[0] == key:
            note_run(key, "step", (now - prev[1]) / 1e6)
    except Exception:
        pass


def note_regression(key: str, drift_pct: float = 0.0) -> None:
    """Record a perf-sentinel trip (the sentinel calls this) so triage can
    name the regressed key even when the registry's own drift arithmetic
    differs from the sentinel's."""
    _regressions.append({
        "key": key,
        "drift_pct": round(float(drift_pct), 2),
        "step": _current_step(),
        "wall": time.time(),
    })


def retire(prefix: str) -> None:
    """Drop every registry key starting with ``prefix`` (Engine.close
    retires its serve program keys so registry state does not grow with
    replica churn)."""
    with _lock:
        for k in [k for k in _programs if k.startswith(prefix)]:
            del _programs[k]
    try:
        from . import metrics as _metrics

        reg = _metrics.default_registry()
        for m in reg.metrics():
            if (m.name.startswith("program_cost_")
                    and str(m.labels.get("program", "")).startswith(prefix)):
                reg.remove(m.name, m.labels)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Static cost profiles: FLOP and byte estimates and the top ops over the
# port's IR, plus the liveness planner's estimated peak. Lazy and cached.
# ---------------------------------------------------------------------------
def _ir_profile(program, top_k: int = 5) -> Dict[str, Any]:
    """FLOPs, bytes and the top-k ops of one recorded program
    (``analysis.Program``): matmuls and convolutions by
    ``torch.utils.flop_counter``'s formulas, the hand-written kernels by
    their own counts, elementwise ops by their output elements."""
    flops = 0
    bytes_est = 0
    by_name: Dict[str, List[int]] = {}
    for op in program.ops:
        flops += op.flops
        bytes_est += op.nbytes
        row = by_name.setdefault(op.name, [0, 0])
        row[0] += op.flops
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:max(1, top_k)]
    return {
        "eqns": len(program.ops),
        "flops_est": int(flops),
        "bytes_est": int(bytes_est),
        # one card: no collectives (the sharded cost model is item 13)
        "comm_bytes": 0,
        "collective_count": 0,
        "top_ops": [
            {"op": name, "flops_est": int(f), "count": int(n)}
            for name, (f, n) in top
        ],
    }


def _est_peak_mb(program) -> Optional[float]:
    """Estimated peak device memory of the recorded program by the
    liveness planner (``analysis.memory.plan_memory``)."""
    from ..analysis import memory as _memory

    return round(_memory.plan_memory(program).peak_bytes / 2**20, 3)


def _static_profile(prog: _Program, top_k: int = 5) -> Optional[Dict]:
    """Compute (once) and cache the static cost profile of one entry."""
    if prog._static is not None:
        return prog._static or None
    static: Dict[str, Any] = {}
    try:
        if prog.ir_thunk is not None:
            program = prog.ir_thunk()
            if program is not None:
                static.update(_ir_profile(program, top_k))
                if "est_peak_hbm_mb" not in prog.extras:
                    try:
                        static["est_peak_hbm_mb"] = _est_peak_mb(program)
                    except Exception:
                        pass
    except Exception:
        static = {}
    prog._static = static or False
    if static:
        try:
            from . import metrics as _metrics

            reg = _metrics.default_registry()
            labels = {"program": prog.key, "category": prog.category}
            flops = static.get("flops_est")
            if flops is not None:
                reg.gauge("program_cost_flops",
                          doc="static flop estimate per program key",
                          labels=labels).set(float(flops))
            peak = prog.extras.get("est_peak_hbm_mb",
                                   static.get("est_peak_hbm_mb"))
            if peak is not None:
                reg.gauge("program_cost_est_peak_hbm_mb",
                          doc="planner-estimated peak HBM per program key, MB",
                          labels=labels).set(float(peak))
            comm = static.get("comm_bytes")
            if comm:
                reg.gauge("program_cost_comm_bytes",
                          doc="collective wire bytes per device per run",
                          labels=labels).set(float(comm))
        except Exception:
            pass
    return static or None


def _row(prog: _Program, with_static: bool, top_k: int = 5) -> Dict[str, Any]:
    row: Dict[str, Any] = {
        "category": prog.category,
        "runs": prog.runs,
        "builds": prog.builds,
        "ema_ms": None if prog.ema_ms is None else round(prog.ema_ms, 4),
        "last_ms": None if prog.last_ms is None else round(prog.last_ms, 4),
        "total_ms": round(prog.total_ms, 3),
        "baseline_ms": (None if prog.baseline_ms is None
                        else round(prog.baseline_ms, 4)),
        "drift_pct": (None if prog.drift_pct() is None
                      else round(prog.drift_pct(), 2)),
        "donated": prog.donated,
        "registered_step": prog.registered_step,
    }
    for k, v in prog.extras.items():
        row.setdefault(k, v)
    if with_static:
        static = _static_profile(prog, top_k)
        if static:
            row.update(static)
    return row


def program_costs(top_k: int = 5, static: bool = True) -> Dict[str, Dict]:
    """``{key: profile}`` for every registered program — the static cost
    profile (computed lazily, cached) paired with the measured wall-time
    EMA. ``static=False`` skips the (one-time) profile computation for a
    cheap measured-only view."""
    with _lock:
        progs = list(_programs.values())
    return {p.key: _row(p, static, top_k) for p in progs}


def costs_summary(k: int = 5) -> List[Dict[str, Any]]:
    """Compact top-``k`` programs by measured EMA — what ObsPublisher
    ships in the fleet snapshot (no static traces, bounded size)."""
    with _lock:
        progs = [p for p in _programs.values() if p.ema_ms is not None]
    progs.sort(key=lambda p: -(p.ema_ms or 0.0))
    return [
        {"key": p.key, "category": p.category,
         "ema_ms": round(p.ema_ms, 4), "runs": p.runs,
         "drift_pct": (None if p.drift_pct() is None
                       else round(p.drift_pct(), 2)),
         # from the CACHED static profile only: the snapshot path must
         # never force a profile computation (bounded-size contract)
         "comm_bytes": (p._static or {}).get("comm_bytes")
         if isinstance(p._static, dict) else None}
        for p in progs[:max(1, k)]
    ]


def chrome_counter_events() -> List[Dict[str, Any]]:
    """Per-program counter lanes for ``Profiler.export``: every measured
    run becomes one chrome counter sample (``ph: "C"``), so a program
    key's wall time is a plottable lane on the merged timeline."""
    import os

    pid = os.getpid()
    out = []
    for ts_ns, key, ms in list(_samples):
        out.append({
            "name": f"program_ms:{key}", "cat": "attribution", "ph": "C",
            "ts": ts_ns / 1000.0, "pid": pid, "tid": 0,
            "args": {"ms": round(ms, 4)},
        })
    return out


# ---------------------------------------------------------------------------
# Fused numerics telemetry (FLAGS_telemetry)
# ---------------------------------------------------------------------------
class _GroupState:
    __slots__ = ("grad_norm", "param_norm", "update_ratio", "grad_norm_ema",
                 "seen", "spikes", "gauges")

    def __init__(self):
        self.grad_norm: Optional[float] = None
        self.param_norm: Optional[float] = None
        self.update_ratio: Optional[float] = None
        self.grad_norm_ema: Optional[float] = None
        self.seen = 0
        self.spikes = 0
        # cached (grad_norm, param_norm, update_ratio) Gauge handles: the
        # registry's get-or-create lookup (lock + label sort) per group per
        # step is the dominant record cost — resolve once, set forever
        self.gauges = None


_tele_lock = threading.Lock()
_tele_groups: "OrderedDict[str, _GroupState]" = OrderedDict()
_tele_ring: deque = deque(maxlen=64)
_tele_steps = 0
_tele_record_cost_ms: Optional[float] = None
# cached module refs: a per-step `from ... import` pair is measurable
# inside the record-cost budget
_tele_reg = None
_tele_disp = None


def _tele_registry():
    global _tele_reg
    if _tele_reg is None:
        from . import metrics as _metrics

        _tele_reg = _metrics.default_registry()
    return _tele_reg


def _tele_dispatch():
    global _tele_disp
    if _tele_disp is None:
        from .. import profiler as _profiler

        _tele_disp = _profiler
    return _tele_disp


def telemetry_active() -> bool:
    return bool(_flags.flag("telemetry"))


def group_names(params) -> List[str]:
    """Parameter-group labels: the parameter name's prefix up to the last
    ``.`` (the owning layer), or ``param<i>`` for anonymous tensors."""
    names = []
    for i, p in enumerate(params):
        name = str(getattr(p, "name", "") or "")
        if name:
            names.append(name.rsplit(".", 1)[0] if "." in name else name)
        else:
            names.append(f"param{i}")
    return names


def record_telemetry(names: List[str], tele, step: Optional[int] = None):
    """Host half of the fused telemetry: reduce the in-program
    ``(n_params, 3)`` sums-of-squares vector (grad², param², update²) to
    per-group norms, update the gauges / history ring / spike state, and
    emit one ``telemetry`` flight event. Reading ``tele`` blocks on the
    already-launched step program — it never launches a new one."""
    global _tele_steps, _tele_record_cost_ms
    try:
        # the device->host read blocks on the step program — work the
        # caller's loss read pays anyway — so the measured record cost
        # (the analytic telemetry-overhead numerator) starts AFTER it
        if hasattr(tele, "detach"):  # a torch tensor (on the card: one read)
            tele = tele.detach().to("cpu").double().numpy()
        arr = np.asarray(tele, dtype=np.float64).reshape(len(names), 3)
    except Exception:
        return
    t0 = time.perf_counter()
    try:
        if step is None:
            step = _current_step()
        factor = float(_flags.flag("telemetry_spike_factor"))
        # aggregate params into groups (sums of squares add); plain python
        # floats throughout — numpy scalar arithmetic here would triple
        # the per-step record cost the analytic overhead gate budgets
        agg: "OrderedDict[str, list]" = OrderedDict()
        for name, row in zip(names, arr.tolist()):
            cur = agg.get(name)
            if cur is None:
                agg[name] = row
            else:
                cur[0] += row[0]
                cur[1] += row[1]
                cur[2] += row[2]
        spiking: List[str] = []
        record: Dict[str, Dict[str, float]] = {}
        gauge_rows = []
        isfinite, sqrt = math.isfinite, math.sqrt
        worst_name, worst_rank = None, -1.0
        total_g2 = 0.0
        with _tele_lock:
            hist = int(_flags.flag("telemetry_history"))
            if hist > 0 and _tele_ring.maxlen != hist:
                # deque.maxlen is immutable — REBIND the module global to
                # a resized ring (readers re-resolve it under the lock)
                globals()["_tele_ring"] = deque(_tele_ring, maxlen=hist)
            for name, (g2, p2, d2) in agg.items():
                st = _tele_groups.get(name)
                if st is None:
                    st = _tele_groups[name] = _GroupState()
                gn = sqrt(g2) if g2 >= 0 else float("nan")
                pn = sqrt(p2) if p2 >= 0 else float("nan")
                dn = sqrt(d2) if d2 >= 0 else float("nan")
                ratio = dn / pn if pn and isfinite(pn) and pn > 0 else 0.0
                gn_ok = isfinite(gn)
                spike = (not gn_ok) or (
                    st.grad_norm_ema is not None and st.seen >= 3
                    and factor > 0 and gn > factor * max(st.grad_norm_ema,
                                                         1e-30))
                st.grad_norm, st.param_norm, st.update_ratio = gn, pn, ratio
                if gn_ok:
                    total_g2 += g2
                    st.grad_norm_ema = (
                        gn if st.grad_norm_ema is None
                        else st.grad_norm_ema + _EMA_ALPHA * (
                            gn - st.grad_norm_ema))
                st.seen += 1
                if spike:
                    st.spikes += 1
                    spiking.append(name)
                rank = float("inf") if not gn_ok else gn
                if worst_name is None or rank > worst_rank:
                    worst_name, worst_rank = name, rank
                record[name] = {
                    "grad_norm": gn, "param_norm": pn, "update_ratio": ratio,
                    "spike": spike,
                }
                gauge_rows.append((st, name, gn, pn, ratio))
            _tele_ring.append({"step": step, "groups": record})
            _tele_steps += 1
        # gauges + counters + the per-step flight event (outside the lock)
        try:
            reg = _tele_registry()
            for st, name, gn, pn, ratio in gauge_rows:
                gauges = st.gauges
                if gauges is None:
                    labels = {"group": name}
                    gauges = st.gauges = tuple(
                        reg.gauge(f"telemetry_{field}",
                                  doc="fused numerics telemetry: "
                                      f"{field} per parameter group",
                                  labels=labels)
                        for field in ("grad_norm", "param_norm",
                                      "update_ratio"))
                gauges[0].set(gn if isfinite(gn) else -1.0)
                gauges[1].set(pn if isfinite(pn) else -1.0)
                gauges[2].set(ratio if isfinite(ratio) else -1.0)
        except Exception:
            pass
        try:
            profiler = _tele_dispatch()
            profiler.count_locked("telemetry_steps")
            for name in spiking:
                profiler.count_locked("telemetry_spikes")
                profiler.count_labeled_locked("telemetry_spike_groups", name)
            profiler.trace.emit(
                "telemetry", site="update", step=step,
                groups=len(record),
                max_group=worst_name,
                max_grad_norm=round(worst_rank, 6)
                if isfinite(worst_rank) else "nan",
                grad_norm_total=round(sqrt(total_g2), 6)
                if total_g2 else None,
                spikes=spiking or None,
            )
        except Exception:
            pass
    except Exception:
        pass  # telemetry must never break the step
    finally:
        dt = (time.perf_counter() - t0) * 1000.0
        _tele_record_cost_ms = (
            dt if _tele_record_cost_ms is None
            else _tele_record_cost_ms + _EMA_ALPHA * (
                dt - _tele_record_cost_ms))


class _TelemetryLag:
    """The one-step-late read of the telemetry vector when nothing else
    synchronises the step (no numeric rescue): ``push`` copies the step's
    ``(n, 3)`` vector into one of two pinned host buffers behind an event
    (on the card; a copy on the CPU) and records the PREVIOUS step's, whose
    event has normally completed by then; ``flush`` records the pending one.
    A deliberate difference from the JAX package, whose telemetry read is a
    synchronisation every step (ROADMAP, deliberate differences)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pending = None  # (names, host buffer, event or None, step)
        self.bufs: Dict[tuple, list] = {}
        self.turn = 0

    def push(self, names, tele, step):
        if tele.device.type == "cuda":
            import torch

            pair = self.bufs.get(tuple(tele.shape))
            if pair is None:
                pair = self.bufs[tuple(tele.shape)] = [
                    torch.empty(tele.shape, dtype=tele.dtype, pin_memory=True)
                    for _ in range(2)]
            self.turn ^= 1
            buf = pair[self.turn]
            buf.copy_(tele, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            buf, ev = tele.detach().clone(), None
        with self.lock:
            prev, self.pending = self.pending, (list(names), buf, ev, step)
        if prev is not None:
            self._record(prev)

    def flush(self):
        with self.lock:
            prev, self.pending = self.pending, None
        if prev is not None:
            self._record(prev)

    @staticmethod
    def _record(entry):
        names, buf, ev, step = entry
        if ev is not None:
            ev.synchronize()
        record_telemetry(names, buf, step)


_tele_lag = _TelemetryLag()


def push_telemetry(names: List[str], tele, step: Optional[int] = None) -> None:
    """Hand one step's device ``(n, 3)`` telemetry vector to the lagged
    reader: it is recorded at the next push or at :func:`flush_telemetry`,
    without a host synchronisation on the step path."""
    try:
        _tele_lag.push(names, tele, _current_step() if step is None else step)
    except Exception:
        pass  # telemetry must never break the step


def flush_telemetry() -> None:
    """Record the pending (last pushed) telemetry vector now."""
    try:
        _tele_lag.flush()
    except Exception:
        pass


def telemetry_record_cost_ms() -> Optional[float]:
    """EMA of the host-side cost of one record_telemetry call as observed
    LIVE, ms. Reported alongside the gated number — on a noisy box the
    live EMA folds in cache-warming and scheduler noise an A/B cannot
    attribute; the gate uses :func:`measure_record_cost_ms`."""
    return _tele_record_cost_ms


def measure_record_cost_ms(names=None, n: int = 500, reps: int = 3) -> float:
    """Tight-loop microbenchmark of one ``record_telemetry`` call (min of
    ``reps`` windows) — the analytic telemetry-overhead numerator the
    obs_probe triage gate and bench.py share: marginal record cost × one
    record/step over step time, same discipline as the flight-recorder
    per-emit bound (a wall-clock A/B at 1% resolution does not replicate
    on a shared box). MUTATES telemetry state (ring/gauges/counters) —
    run it after assertions, or reset() afterwards."""
    names = list(names) if names else [f"param{i}" for i in range(8)]
    vec = np.full((len(names), 3), 0.25)
    best = None
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for i in range(max(1, n)):
            record_telemetry(names, vec, step=-1)
        dt = (time.perf_counter() - t0) / max(1, n) * 1000.0
        best = dt if best is None else min(best, dt)
    return best


def telemetry_state() -> Dict[str, Any]:
    """Detached snapshot for /programz, /statusz, and tests (the pending
    vector is recorded first)."""
    flush_telemetry()
    with _tele_lock:
        groups = {
            name: {
                "grad_norm": st.grad_norm,
                "param_norm": st.param_norm,
                "update_ratio": st.update_ratio,
                "grad_norm_ema": st.grad_norm_ema,
                "seen": st.seen,
                "spikes": st.spikes,
            }
            for name, st in _tele_groups.items()
        }
        tail = [dict(r) for r in _tele_ring]
    return {
        "enabled": telemetry_active(),
        "steps": _tele_steps,
        "record_cost_ms": (None if _tele_record_cost_ms is None
                           else round(_tele_record_cost_ms, 4)),
        "groups": groups,
        "tail": tail,
    }


def telemetry_summary() -> Optional[Dict[str, Any]]:
    """One-line fleet summary (ObsPublisher): the hottest group's grad
    norm, or None when telemetry is off / has not recorded yet."""
    flush_telemetry()
    with _tele_lock:
        if not _tele_groups:
            return None
        worst_name, worst = None, None
        for name, st in _tele_groups.items():
            gn = st.grad_norm
            if gn is None:
                continue
            rank = float("inf") if not math.isfinite(gn) else gn
            if worst is None or rank > worst:
                worst_name, worst = name, rank
        if worst_name is None:
            return None
        st = _tele_groups[worst_name]
        return {
            "group": worst_name,
            "grad_norm": st.grad_norm,
            "update_ratio": st.update_ratio,
            "spikes": sum(s.spikes for s in _tele_groups.values()),
            "steps": _tele_steps,
        }


# ---------------------------------------------------------------------------
# Sample-id recovery: the data plane half of triage
# ---------------------------------------------------------------------------
_sampler_ref: Optional[Callable] = None  # weakref to the live sampler


def register_sampler(sampler) -> None:
    """Remember the live :class:`GlobalStepSampler` (weakly — diagnostics
    must not extend the data pipeline's lifetime). Called from the
    sampler's own ``__init__``; the latest sampler wins."""
    global _sampler_ref
    try:
        _sampler_ref = weakref.ref(sampler)
    except TypeError:
        _sampler_ref = None


def _batch_section() -> Dict[str, Any]:
    out: Dict[str, Any] = {"sampler": False, "step": None, "sample_ids": None}
    ref = _sampler_ref
    sampler = ref() if ref is not None else None
    if sampler is None:
        return out
    try:
        step = int(sampler.cursor) - 1  # last consumed global step
        out.update({
            "sampler": True,
            "seed": int(sampler.seed),
            "cursor": int(sampler.cursor),
            "step": step if step >= 0 else None,
        })
        if step >= 0:
            out["epoch"] = step // sampler.steps_per_epoch
            out["sample_ids"] = [int(i) for i in sampler.local_ids(step)]
            out["global_ids_count"] = int(sampler.global_batch_size)
    except Exception:
        pass
    return out


# ---------------------------------------------------------------------------
# The triage section every postmortem carries
# ---------------------------------------------------------------------------
def triage_section(top_k: int = 3, drift_threshold_pct: Optional[float] = None,
                   tail: int = 8) -> Dict[str, Any]:
    """The ``attribution`` block of a crash postmortem: which program keys
    regressed (cost-registry EMA vs frozen baseline, plus the keys the
    sentinel actually tripped), which parameter group's grad-norm broke
    trend (last N telemetry records included), and which samples were in
    the current batch (pure-function recovery from the registered
    sampler). Cheap: measured state only, and cached static profiles."""
    flush_telemetry()
    if drift_threshold_pct is None:
        pct = float(_flags.flag("sentinel_pct"))
        drift_threshold_pct = pct if pct > 0 else 20.0
    with _lock:
        progs = list(_programs.values())
    rows = []
    for p in progs:
        d = p.drift_pct()
        if d is None:
            continue
        rows.append((d, p))
    rows.sort(key=lambda t: -t[0])
    regressed = []
    for d, p in rows:
        if d < drift_threshold_pct:
            break
        row = {
            "key": p.key, "category": p.category,
            "ema_ms": round(p.ema_ms, 4),
            "baseline_ms": round(p.baseline_ms, 4),
            "drift_pct": round(d, 2),
        }
        static = p._static if isinstance(p._static, dict) else None
        if static and static.get("top_ops"):
            row["top_ops"] = static["top_ops"][:top_k]
        regressed.append(row)
        if len(regressed) >= 8:
            break
    with _tele_lock:
        tele_tail = [dict(r) for r in list(_tele_ring)[-max(0, tail):]]
        spiking = sorted(
            (name for name, st in _tele_groups.items()
             if st.grad_norm is not None and (
                 not math.isfinite(st.grad_norm)
                 or (st.grad_norm_ema and st.grad_norm
                     > float(_flags.flag("telemetry_spike_factor"))
                     * max(st.grad_norm_ema, 1e-30)))),
        )
        total_spikes = sum(st.spikes for st in _tele_groups.values())
    return {
        "programs": {
            "regressed": regressed,
            "tripped": list(_regressions),
            "top_measured": costs_summary(top_k + 2),
        },
        "telemetry": {
            "enabled": telemetry_active(),
            "spiking_groups": spiking,
            "total_spikes": total_spikes,
            "tail": tele_tail,
        },
        "batch": _batch_section(),
    }


def reset() -> None:
    """Drop every registry entry, telemetry record, and lap clock (test
    isolation / fresh measurement window)."""
    global _tele_steps, _tele_record_cost_ms, _sampler_ref
    with _lock:
        _programs.clear()
    _samples.clear()
    _lap_by_thread.clear()
    _regressions.clear()
    with _tele_lag.lock:
        _tele_lag.pending = None
    with _tele_lock:
        _tele_groups.clear()
        _tele_ring.clear()
        _tele_steps = 0
        _tele_record_cost_ms = None
    try:
        from . import metrics as _metrics

        reg = _metrics.default_registry()
        for m in reg.metrics():
            if m.name.startswith(("program_cost_", "telemetry_")):
                reg.remove(m.name, m.labels)
    except Exception:
        pass
