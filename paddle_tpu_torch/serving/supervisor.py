"""Self-healing engine supervision: restart the engine, not the fleet. The
port of ``paddle_tpu/serving/supervisor.py``, host code.

The engine recovers from faults *inside* a tick (the resilience ladder
retries, demotes, requeues), but a tick exception that escapes the ladder —
a scheduler bug, a graph whose replay failed on the card, an error the
device reports at the host read of the next tokens — would otherwise
propagate to whoever drives the loop and strand every queued request. The
:class:`Supervisor` is the layer above: it drives the serve loop, consumes
the two wedge signals, and restarts the engine in place.

Signals:

- **tick exceptions** — any ``Exception`` escaping ``Engine.step()``
  (``Preempted``/``KeyboardInterrupt``/``SystemExit`` pass through: those
  are control flow, not faults);
- **the step-stall watchdog** — ``FLAGS_trace_stall_ms`` > 0 starts the
  ``profiler.trace`` watchdog; the supervisor registers a stall listener,
  and a tick that trips it with no observable progress is treated as a
  wedge once control returns.

A restart (``Engine.restart``) evicts the engine's CUDA graphs, zeroes the
pool, and re-enqueues in-flight sequences through the requeue path — greedy
decode is deterministic, so the re-run reproduces the same tokens. Restarts
are bounded by ``FLAGS_serving_max_engine_restarts``; past the budget the
supervisor fails *cleanly* (``Engine.fail_clean``): every queued and
in-flight request gets a terminal error response, the engine goes ``dead``,
and a postmortem is dumped — zero hangs, zero silent drops. A sticky CUDA
error (an illegal address, ``retry.is_cuda_error``) fails clean at once,
without a restart: the context is lost, so the restart's own work on the
card (evicting the graphs, zeroing the pool) would raise it again. A
restart that raises for any other reason fails clean too. Only a new
process recovers from either.
"""
from __future__ import annotations

from typing import List, Optional, Sequence as Seq

from ..core import flags

__all__ = ["Supervisor"]


class Supervisor:
    """Drives one :class:`~paddle_tpu_torch.serving.Engine`'s serve loop with
    wedge detection and bounded self-healing restarts.

        sup = pt.serving.Supervisor(engine)
        rids = [engine.submit(p, deadline_ms=500) for p in prompts]
        sup.run_until_idle()          # restarts the engine if it wedges

    ``max_restarts=None`` reads FLAGS_serving_max_engine_restarts live.

    The stall watchdog's listeners are process-global (every engine tick
    and training step feeds a heartbeat), so stall trips are only
    attributed to this supervisor's engine while one of ITS ticks is in
    flight, and ``run_until_idle`` disarms its engine's heartbeat when it
    goes idle — run one supervised serve loop at a time per process for
    stall detection (tick-exception wedge recovery is always per-engine
    regardless).
    """

    def __init__(self, engine, max_restarts: Optional[int] = None):
        import weakref

        from ..profiler import trace as _trace

        self._engine = engine
        self._max_restarts = max_restarts
        self._restarts = 0
        self._stalled_ms: Optional[float] = None
        self._in_tick = False
        # the listener holds only a WEAK reference to this supervisor: the
        # global listener registry must not pin the supervisor (and through
        # it the engine, the model, and the pool's K/V tensors) alive when a
        # caller drops the supervisor without close(). A trip after
        # collection removes the stale closure itself.
        ref = weakref.ref(self)

        def _listener(stalled_ms, _ref=ref):
            sup = _ref()
            if sup is None:
                _trace.remove_stall_listener(_listener)
                return
            sup._note_stall(stalled_ms)

        self._listener = _listener  # stable identity for remove
        _trace.add_stall_listener(self._listener)

    # -- stall-watchdog plumbing ----------------------------------------
    def _note_stall(self, stalled_ms: float):
        # called from the watchdog daemon thread; consumed at the next
        # tick boundary on the driving thread. The watchdog heartbeat is
        # process-global, so only latch trips that fired while OUR engine
        # was mid-tick — another engine's (or a training loop's) stall
        # must not restart a healthy engine and burn its requests'
        # requeue budgets
        if self._in_tick:
            self._stalled_ms = stalled_ms

    def _take_stall(self) -> Optional[float]:
        ms, self._stalled_ms = self._stalled_ms, None
        return ms

    def close(self):
        from ..profiler import trace as _trace

        _trace.remove_stall_listener(self._listener)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- supervision ----------------------------------------------------
    @property
    def restarts(self) -> int:
        return self._restarts

    def _budget(self) -> int:
        if self._max_restarts is not None:
            return int(self._max_restarts)
        return int(flags.flag("serving_max_engine_restarts"))

    def _recover(self, err: BaseException):
        from ..resilience.retry import is_cuda_error

        self._restarts += 1
        if self._restarts > self._budget():
            self._engine.fail_clean(err)
            return
        if is_cuda_error(err):
            self._engine.fail_clean(err, why=f"engine dead: the CUDA context is lost: {err}")
            return
        try:
            self._engine.restart(err)
        except Exception as e:
            # the requests the restart requeued must still be answered
            self._engine.fail_clean(e, why=f"engine dead: its restart failed: {e}")

    @staticmethod
    def _progress_marker() -> float:
        """Cheap observable-progress sum: a tick that prefilled, decoded,
        completed, or expired anything was slow, not wedged."""
        from .. import profiler

        c = profiler.dispatch_counters()
        return (c["serve_prefills"] + c["serve_decode_steps"]
                + c["serve_requests_completed"]
                + c["serve_deadline_expired"])

    def step(self):
        """One supervised tick: run ``Engine.step()``, convert a wedge
        into an engine restart. A wedge is an exception escaping the tick,
        or a stall-watchdog trip during a tick that made NO observable
        progress — a slow-but-productive tick (first-serve CUDA graph
        captures can exceed FLAGS_trace_stall_ms) must not trigger a
        restart that evicts the very graphs it just captured."""
        from ..profiler import trace as _trace

        self._take_stall()  # stalls from BEFORE this tick aren't its fault
        before = self._progress_marker()
        self._in_tick = True
        try:
            self._engine.step()
        except Exception as e:
            # Preempted (a SystemExit subclass) propagates past this
            # handler on its own — a preemption drain is control flow,
            # not a wedge, and must not burn the restart budget
            self._recover(e)
            return
        finally:
            self._in_tick = False
        stalled = self._take_stall()
        if stalled is not None:
            if self._progress_marker() > before:
                _trace.emit("serve", site="supervisor", phase="stall_benign",
                            stalled_ms=round(stalled, 1))
                return  # slow tick, real work done — not a wedge
            self._recover(TimeoutError(
                f"step-stall watchdog fired mid-tick with no progress "
                f"({stalled:.0f} ms > FLAGS_trace_stall_ms)"))

    def run_until_idle(self):
        """Drive the supervised loop until every accepted request has a
        terminal response — including through restarts, and including the
        fail-clean path (a dead engine has already answered everything)."""
        from ..profiler import trace as _trace

        eng = self._engine
        try:
            while eng.pending and eng.health != "dead":
                self.step()
            eng._audit_drops()
        finally:
            # an idle serving loop looks exactly like a stalled one to the
            # watchdog — stand THIS engine's source down (the
            # train_step_range discipline); a co-resident training loop or
            # sibling engine stays armed
            _trace.watchdog_disarm(f"serve[{eng._uid}]")

    def serve(self, requests: Seq, **submit_kw) -> List:
        """Submit every prompt, run supervised to completion, return (and
        evict) the responses in submit order."""
        ids = [self._engine.submit(p, **submit_kw) for p in requests]
        self.run_until_idle()
        return [self._engine.pop_response(i) for i in ids]

    def state(self) -> dict:
        return {
            "restarts": self._restarts,
            "budget": self._budget(),
            "engine_health": self._engine.health,
            "last_restart_error": self._engine._last_restart_error,
        }
