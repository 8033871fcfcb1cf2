"""Host offload of cold optimizer state: the port of
``paddle_tpu/optimizer/offload.py`` (``_OffloadScheduler`` :65, ``enable``
:434, ``disable`` :466, ``scheduler_of`` :479, ``state`` :483).

An Adam-family optimizer's moment tensors are COLD: the update reads and
writes them, and nothing else does, so their memory sits idle through the
forward and the backward (``analysis.plan.cold_state_indices`` proves it on
a captured step's recording). The scheduler parks them on the host between
steps: a park copies a moment into a pinned host buffer on the step's
stream and frees its device storage (``untyped_storage().resize_(0)``: the
tensor object, and every reference to it, stays the same); bringing it back
allocates the storage again and copies the host buffer in, on the same
stream, ahead of the update that reads it. The copies are exact, so a
parked run is bitwise an unparked one.

  eager fused step   ``Optimizer.step()`` brings the parked moments of the
                     parameters it updates back (``ensure_resident``), runs
                     the update, and parks the selected set again at its end;
  whole-step capture a CUDA graph reads fixed addresses, so a captured step
                     keeps its parked moments on the host for good: the
                     program itself stages them, copying each into a buffer
                     of the graph's pool before the update and back to its
                     pinned host buffer after it (``staged``), where the
                     activations of the forward are already dead. The set
                     of staged moments keys the capture: a set the
                     scheduler changes is captured anew.

The prefetch is on the step's critical path (the update waits for it): its
measured time is the scheduler's blocked time. ``FLAGS_offload_overhead_pct``
bounds it as a share of the step's period; above it the scheduler halves
the parked set (the largest moments stay: they buy the most memory per
transfer), well under it the set grows back, CheckFreq's discipline.
``state_dict()`` and a checkpoint's ``training_state`` bring every moment
back first (``Optimizer._state_sync``), so a snapshot never sees a parked
one, and a restore writes the device tensors the next park copies out.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["disable", "enable", "scheduler_of", "state"]

_MB = float(1 << 20)


def _ema(cur: float, new: float, alpha: float = 0.2) -> float:
    return new if cur == 0.0 else (1.0 - alpha) * cur + alpha * new


class _OffloadScheduler:
    """One optimizer's offload state machine."""

    def __init__(self, opt, *, overhead_pct: Optional[float] = None,
                 min_bytes: int = 1 << 16):
        from ..core import flags as _flags

        self._opt_ref = weakref.ref(opt)
        self.overhead_pct = (float(_flags.flag("offload_overhead_pct"))
                             if overhead_pct is None else float(overhead_pct))
        self.min_bytes = int(min_bytes)
        # (id(state dict), key) -> (state dict, key, bytes)
        self._groups: Dict[Tuple[int, str], Tuple[dict, str, int]] = {}
        self._host: Dict[Tuple[int, str], torch.Tensor] = {}  # pinned host buffers
        self._parked: set = set()  # groups whose device storage is freed
        self._selected: Optional[List[Tuple[int, str]]] = None
        self._max_groups: Optional[int] = None
        self._cold_source = "heuristic"
        self._pending = None  # (start, end) CUDA events of the last prefetch
        self._h2d_rate = None  # measured host-to-device bytes per ms
        self._t_last = None
        self.d2h_ema_ms = 0.0
        self.h2d_ema_ms = 0.0
        self.blocked_ema_ms = 0.0
        self.step_ema_ms = 0.0
        self.overhead_pct_ema = 0.0
        self.d2h_count = 0
        self.h2d_count = 0
        self.shrinks = 0
        self.regrows = 0
        self.steps = 0
        self.staged_steps = 0
        self._staging = False  # inside a captured update's staging

    # -- the groups ----------------------------------------------------------
    def _select_groups(self, opt):
        """The moments to park: those the planner proves cold on the last
        captured step when one replayed, else every state tensor of one
        dimension or more and at least ``min_bytes`` (the Adam family's
        moments, not its beta-power scalars)."""
        entries = []
        for p in opt._param_list():
            st = opt._accumulators.get(id(p)) if p.requires_grad else None
            for k in sorted(st or ()):
                t = st[k]
                if isinstance(t, torch.Tensor) and t.dim() >= 1 and \
                        t.numel() * t.element_size() >= self.min_bytes:
                    entries.append((st, k, t.numel() * t.element_size()))
        cold = self._planner_cold_keys(opt)
        if cold is not None:
            entries = [e for e in entries if (id(e[0]), e[1]) in cold]
            self._cold_source = "planner"
        groups = {(id(st), k): (st, k, nb) for st, k, nb in entries}
        # a parked moment leaving the candidates comes back first
        self._unpark_all([g for g in self._parked if g not in groups])
        self._groups = groups
        order = sorted(self._groups, key=lambda g: -self._groups[g][2])
        self._selected = order if self._max_groups is None else order[:self._max_groups]

    def _planner_cold_keys(self, opt):
        """(id(state dict), key) of the moments cold on the last captured
        step's recording, or None before a capture replayed."""
        try:
            from ..analysis import plan as _plan
            from ..core import lazy as _lazy

            got = _lazy.captured_step_program()
            if got is None:
                return None
            named = [((id(st), k), st[k]) for p in opt._param_list()
                     for st in [opt._accumulators.get(id(p)) or {}] for k in sorted(st)
                     if isinstance(st[k], torch.Tensor)]
            cold = _plan.cold_state_indices(got[0], named)
            # a parked moment is staged inside the captured update itself
            # (``staged``): its only reads are there, cold by construction
            return {named[i][0] for i, _name in cold} | set(self._parked) or None
        except Exception:  # noqa: BLE001
            return None

    # -- park and bring back ---------------------------------------------------
    def _park(self, g):
        st, k, nb = self._groups[g]
        t = st[k]
        host = self._host.get(g)
        if host is None or host.shape != t.shape or host.dtype != t.dtype:
            host = self._host[g] = torch.empty(t.shape, dtype=t.dtype,
                                               pin_memory=t.device.type == "cuda")
        t0 = time.perf_counter()
        host.copy_(t, non_blocking=True)
        t.untyped_storage().resize_(0)  # later work on this stream runs after the copy
        self._parked.add(g)
        self.d2h_count += 1
        self.d2h_ema_ms = _ema(self.d2h_ema_ms, (time.perf_counter() - t0) * 1e3)

    def _unpark(self, g):
        st, k, nb = self._groups[g]
        t = st[k]
        t.untyped_storage().resize_(nb)
        t.copy_(self._host[g], non_blocking=True)
        self._parked.discard(g)
        self.h2d_count += 1

    def _unpark_all(self, groups):
        """Bring ``groups`` back, timing the copies (CUDA events on the card,
        read at the next step; the host clock on the CPU)."""
        groups = [g for g in groups if g in self._parked]
        if not groups:
            return 0.0
        st0 = self._groups[groups[0]][0]
        cuda = st0[self._groups[groups[0]][1]].device.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        for g in groups:
            self._unpark(g)
        if cuda:
            ev[1].record()
            self._pending = (ev, sum(self._groups[g][2] for g in groups))
            return 0.0
        ms = (time.perf_counter() - t0) * 1e3
        self._note_prefetch(ms, sum(self._groups[g][2] for g in groups))
        return ms

    def _note_prefetch(self, ms, nbytes):
        self.h2d_ema_ms = _ema(self.h2d_ema_ms, ms)
        self.blocked_ema_ms = _ema(self.blocked_ema_ms, ms)
        if ms > 0:
            self._h2d_rate = nbytes / ms

    def _read_pending(self):
        if self._pending is None:
            return
        (start, end), nbytes = self._pending
        if end.query():
            self._note_prefetch(start.elapsed_time(end), nbytes)
            self._pending = None

    # -- the step's hooks ------------------------------------------------------
    def step_begin(self):
        """``Optimizer.step()`` entry: the step's period, and the last
        prefetch's measured time."""
        now = time.perf_counter()
        if self._t_last is not None:
            self.step_ema_ms = _ema(self.step_ema_ms, (now - self._t_last) * 1e3)
        self._t_last = now
        self._read_pending()

    def ensure_resident(self, opt, params) -> float:
        """Bring the parked moments of ``params`` back before an update that
        reads them in place. Returns the blocked milliseconds measured on
        the host (the card's are read at the next step)."""
        if self._staging:
            return 0.0  # a captured step's program stages its parked moments itself
        wanted = set()
        for p in params:
            st = opt._accumulators.get(id(p))
            for k in (st or ()):
                wanted.add((id(st), k))
        return self._unpark_all([g for g in list(self._parked) if g in wanted])

    def step_end(self, captured: bool = False):
        """``Optimizer.step()`` exit: choose the set (the planner's cold set
        once a capture replayed), retune it against the budget, park what is
        selected and bring back what is not."""
        opt = self._opt_ref()
        if opt is None:
            return
        self.steps += 1
        if captured:
            self.staged_steps += 1
            if self._h2d_rate:  # the staged copies' time at the measured rate
                self.blocked_ema_ms = _ema(self.blocked_ema_ms,
                                           self.parked_bytes() / self._h2d_rate)
        if self._selected is None or (self._cold_source == "heuristic" and self.steps <= 8):
            self._select_groups(opt)
        self._retune()
        keep = set(self._selected or ())
        back = [g for g in self._parked if g not in keep]
        self._unpark_all(back)
        for g in self._selected or ():
            st, k, _nb = self._groups[g]
            if g not in self._parked and isinstance(st.get(k), torch.Tensor):
                self._park(g)
        self._publish()

    def _retune(self):
        if self.step_ema_ms <= 0.0 or self._selected is None:
            return
        pct = 100.0 * self.blocked_ema_ms / self.step_ema_ms
        self.overhead_pct_ema = pct
        n_all, n_sel = len(self._groups), len(self._selected)
        if pct > self.overhead_pct and n_sel > 0:
            self._max_groups = n_sel // 2
            self.shrinks += 1
            self.blocked_ema_ms *= 0.5  # one spike must not pin the set small
        elif pct < 0.25 * self.overhead_pct and n_sel < n_all:
            self._max_groups = min(n_all, max(1, n_sel * 2))
            self.regrows += 1
        else:
            return
        order = sorted(self._groups, key=lambda g: -self._groups[g][2])
        self._selected = order[:self._max_groups]

    # -- the captured step's staging -----------------------------------------------
    def staged_key(self) -> frozenset:
        """The parked set, which keys a captured step's program."""
        return frozenset(self._parked)

    @contextlib.contextmanager
    def staged(self, opt):
        """Around a captured update: each parked moment is copied from its
        pinned host buffer into a fresh device buffer that stands in for it
        in the optimizer's state, and copied back after the update; the
        parked tensor itself stays empty."""
        swaps = []
        self._staging = True
        for g in sorted(self._parked):
            st, k, _nb = self._groups[g]
            t = st[k]
            buf = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            buf.copy_(self._host[g], non_blocking=True)
            st[k] = buf
            swaps.append((g, st, k, t, buf))
        try:
            yield
        finally:
            for g, st, k, t, buf in swaps:
                self._host[g].copy_(buf, non_blocking=True)
                st[k] = t
            self._staging = False

    def sync(self):
        """Bring EVERY parked moment back: ``state_dict()`` and the
        checkpoint's snapshot run through this."""
        if self._parked:
            self._unpark_all(list(self._parked))
            for g in self._groups:
                st, k, _nb = self._groups[g]
                t = st[k]
                if t.device.type == "cuda":
                    torch.cuda.current_stream(t.device).synchronize()
                    break

    # -- observability ---------------------------------------------------------
    def parked_bytes(self) -> int:
        return sum(self._groups[g][2] for g in self._parked if g in self._groups)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "groups_total": len(self._groups),
            "groups_selected": len(self._selected or ()),
            "cold_source": self._cold_source,
            "offloaded_mb": round(self.parked_bytes() / _MB, 3),
            "d2h_ema_ms": round(self.d2h_ema_ms, 3),
            "h2d_ema_ms": round(self.h2d_ema_ms, 3),
            "blocked_ema_ms": round(self.blocked_ema_ms, 3),
            "step_ema_ms": round(self.step_ema_ms, 3),
            "overhead_pct_ema": round(self.overhead_pct_ema, 3),
            "overhead_budget_pct": self.overhead_pct,
            "d2h_count": self.d2h_count,
            "h2d_count": self.h2d_count,
            "shrinks": self.shrinks,
            "regrows": self.regrows,
            "steps": self.steps,
            "staged_steps": self.staged_steps,
        }

    def _publish(self):
        try:
            from ..core import lazy

            lazy._emit("offload", site="optimizer", phase="step",
                       groups=len(self._selected or ()),
                       offloaded_mb=round(self.parked_bytes() / _MB, 3),
                       overhead_pct=round(self.overhead_pct_ema, 3))
        except Exception:  # noqa: BLE001
            pass
        try:
            from ..profiler import metrics as _metrics

            reg = _metrics.default_registry()
            reg.gauge("memory_plan_offload_groups",
                      doc="optimizer state tensors currently selected for host offload"
                      ).set(len(self._selected or ()))
            reg.gauge("memory_plan_offload_mb",
                      doc="bytes of optimizer state parked on the host, MB"
                      ).set(self.parked_bytes() / _MB)
            reg.gauge("memory_plan_offload_overhead_pct",
                      doc="measured prefetch time as % of the step's period (EMA); the "
                          "budget is FLAGS_offload_overhead_pct").set(self.overhead_pct_ema)
        except Exception:  # noqa: BLE001
            pass


_registry: "weakref.WeakValueDictionary[int, _OffloadScheduler]" = weakref.WeakValueDictionary()
_reg_lock = threading.Lock()


def enable(optimizer, *, overhead_pct: Optional[float] = None,
           min_bytes: int = 1 << 16) -> _OffloadScheduler:
    """Attach a host-offload scheduler to ``optimizer`` (idempotent: a second
    call returns the first scheduler). ``overhead_pct`` overrides
    FLAGS_offload_overhead_pct for it; ``min_bytes`` is the smallest state
    tensor worth a round trip."""
    sched = getattr(optimizer, "_offload_sched", None)
    if sched is not None:
        return sched
    sched = _OffloadScheduler(optimizer, overhead_pct=overhead_pct, min_bytes=min_bytes)
    optimizer._offload_sched = sched
    with _reg_lock:
        _registry[id(optimizer)] = sched
    return sched


def disable(optimizer) -> None:
    """Detach the scheduler: every parked moment comes back first, so
    training goes on exactly where it was."""
    sched = getattr(optimizer, "_offload_sched", None)
    if sched is None:
        return
    sched.sync()
    optimizer._offload_sched = None
    with _reg_lock:
        _registry.pop(id(optimizer), None)


def scheduler_of(optimizer) -> Optional[_OffloadScheduler]:
    return getattr(optimizer, "_offload_sched", None)


def state() -> List[Dict[str, Any]]:
    """Snapshots of every live scheduler (the /statusz 'memory plan &
    offload' section)."""
    with _reg_lock:
        scheds = list(_registry.values())
    return [s.snapshot() for s in scheds]
