"""Preemption-safe training: SIGTERM/SIGINT → finish the in-flight step,
emergency-checkpoint, exit cleanly, resume losing at most one step. The port
of ``paddle_tpu/resilience/preemption.py``, host code.

Preemptible fleets send SIGTERM and give the process a grace window. The
guard's signal handler only sets a flag, so the in-flight step always runs to
completion; the training loop observes the flag at the next step boundary,
fires an emergency save through the duck-typed checkpointer (``save`` /
``emergency_save`` / ``wait``), and raises `Preempted` (a SystemExit, so
generic `except Exception` recovery code can't swallow it).

``distributed.checkpoint.train_step_range`` / ``train_epoch_range`` take
the guard as ``guard=``: they bind it to their checkpointer and state,
install it for the loop, call ``step_boundary`` after every step and
uninstall it at the end; a relaunch restores the emergency snapshot and
resumes at the next step.

An emergency save first flushes what lazy dispatch holds pending
(``lazy.flush_if_pending``), as the JAX guard does.
"""
from __future__ import annotations

import signal
import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["Preempted", "PreemptionGuard"]


class Preempted(SystemExit):
    """Raised at the step boundary after a preemption signal; carries the
    signal and the last completed step. SystemExit subclass: training loops
    that catch Exception for fault recovery do not accidentally absorb it."""

    def __init__(self, signum: int, step: Optional[int] = None):
        super().__init__(128 + int(signum))
        self.signum = int(signum)
        self.step = step

    def __str__(self):
        name = signal.Signals(self.signum).name
        return f"preempted by {name} (last completed step: {self.step})"


class PreemptionGuard:
    """Installable SIGTERM/SIGINT latch + emergency-checkpoint hook.

    Usage::

        guard = paddle.resilience.PreemptionGuard(checkpointer, state_dict)
        with guard:
            for step in range(n):
                train_one_step()
                guard.step_boundary(step)   # raises Preempted after a signal

    """

    def __init__(self, checkpointer=None, state_dict: Optional[Dict[str, Any]] = None,
                 signals=None, on_preempt: Optional[Callable[[int], None]] = None):
        self.checkpointer = checkpointer
        self.state_dict = state_dict
        self.signals = tuple(signals or (signal.SIGTERM, signal.SIGINT))
        self.on_preempt = on_preempt
        self.preempted = False
        self.signum: Optional[int] = None
        self._prev = {}
        self._installed = False

    def bind(self, checkpointer, state_dict):
        """Late-bind the emergency-save target (no-op for already-set
        fields)."""
        if self.checkpointer is None:
            self.checkpointer = checkpointer
        if self.state_dict is None:
            self.state_dict = state_dict

    # -- signal plumbing ----------------------------------------------------
    def _handler(self, signum, frame):
        self.preempted = True
        self.signum = signum
        from .. import profiler

        profiler.count("preemptions")

    def install(self):
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal is main-thread-only; stay passive
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev = {}
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- boundary protocol ---------------------------------------------------
    def emergency_save(self, step: int):
        """Make this boundary's snapshot durable before the process exits:
        the checkpointer's ``emergency_save`` when it has one (an in-flight
        async save that already covers the boundary is joined, anything
        else superseded), else a plain ``save``; then ``wait``."""
        from .. import profiler
        from ..core import lazy

        # resolve a pending lazy segment or deferred whole step first, so the
        # snapshot holds a consistent state
        lazy.flush_if_pending("preemption")
        if self.checkpointer is not None and self.state_dict is not None:
            emergency = getattr(self.checkpointer, "emergency_save", None)
            if emergency is not None:
                emergency(step, self.state_dict)
            else:  # duck-typed checkpointer without the join/supersede path
                self.checkpointer.save(step, self.state_dict)
            self.checkpointer.wait()
            profiler.count("emergency_saves")

    def step_boundary(self, step: int):
        """Call after each completed step; raises Preempted (after the
        emergency save) when a signal arrived during the step."""
        if not self.preempted:
            return
        if self.on_preempt is not None:
            self.on_preempt(step)
        self.emergency_save(step)
        signum = self.signum if self.signum is not None else signal.SIGTERM
        exc = Preempted(signum, step)
        from ..profiler import trace as _trace

        _trace.emit("preempt", site="guard", step=step, signum=signum)
        # the emergency snapshot is durable by now; the postmortem records
        # what the run looked like at the boundary it exits on (a dump never
        # raises)
        _trace.dump_postmortem("preempted", exc=exc, signum=signum,
                               last_completed_step=step)
        raise exc
