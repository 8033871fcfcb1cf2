"""The choke-point executor: fault injection + retry/backoff + ladder
accounting around every program launch. The port of
``paddle_tpu/resilience/runtime.py``.

`execute(site, thunk)` is the one wrapper the port routes launches through:
the serving engine's prefill/decode rungs (``prefill`` / ``decode``) and its
eager floor (``op``), the fused optimizer update (``optimizer``) and
checkpoint IO (``checkpoint``, ``distributed/checkpoint.py``). It
consults the fault-injection plan (synthetic faults are raised BEFORE the
thunk runs, so a retry re-executes from scratch), retries transient
failures with capped exponential backoff + jitter, and reports every
disruptive fault to the degradation ladder so a repeatedly-faulting bucket
program demotes.

A CUDA error is raised where the host first waits for the device, which is
usually after the thunk returned (the engine's read of the next tokens):
such a fault escapes the tick, not ``execute``, and the serving Supervisor
owns it. ``execute`` adds no synchronize to catch it earlier: that would
cost every decode step a host wait.

Every event lands in paddle_tpu_torch.profiler.dispatch_counters():
fault_events / injected_faults / transient_faults / fatal_faults /
retry_attempts / retry_exhausted / retry_backoff_ms / fault_sites.

The eager tiers form the ladder captured → lazy → per-op
(``core/lazy.py``): a lazy segment runs at site ``segment`` (tier
``lazy``: a disruptive fault there demotes lazy dispatch and calls take
the per-op path, ``lazy_tier_ok``), a captured step's replay at site
``captured``, keyed by its step signature (a demoted signature is not
armed again until its cooldown ends, and its steps run on the 3-program
path). ``on_step_end`` is also the step lap of the perf sentinel and of
the attribution layer (``train[<sig>]`` / ``serve[<uid>]`` keys).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Hashable

from .. import profiler
from ..core import flags
from ..profiler import trace as _trace
from . import faults
from . import ladder as _ladder
from . import rescue as _rescue
from . import retry as _retry

__all__ = ["captured_tier_ok", "execute", "lazy_tier_ok", "on_step_end", "reset", "state"]

# site → ladder tier that owns faults there. The floor and the optimizer
# update run at the ladder floor (retried, never demoted). The serving
# engine's prefill/decode launches run at the captured tier keyed by their
# bucket signature: a disruptive fault demotes that ONE bucket's program
# while other buckets keep replaying their CUDA graphs.
_SITE_TIER = {"prefill": "captured", "decode": "captured", "captured": "captured",
              "segment": "lazy"}

# exception type names that pass through untouched: control flow and
# verdicts, not faults
_PASSTHROUGH = frozenset(("Preempted", "FloatingPointError"))


def execute(site: str, thunk: Callable[[], Any], *, fresh: bool = False,
            ladder_key: Hashable = None, retry_unsafe: bool = False) -> Any:
    """Run `thunk()` under the resilience policy for `site`.

    `fresh=True` marks a first build (a CUDA graph capture), enabling
    `compile:` fault clauses there. `ladder_key` scopes ladder demotion
    (the serving engine passes its bucket signature). `retry_unsafe=True`
    marks a thunk that writes its inputs IN PLACE (a captured serving graph
    over the pool, the fused optimizer kernels over p, m and v): a real
    fault may fire after part of the write, so it is never re-invoked — the
    fault is recorded as disruptive (the ladder demotes) and propagates to
    the caller's fallback path. Injected faults raise BEFORE the thunk
    runs, so they still retry."""
    plan = faults.active_plan()
    if plan is None:
        # hot path (no fault injection): one call, no flag reads; a real
        # failure re-enters below with full classify/retry/ladder handling
        try:
            return thunk()
        except BaseException as e:
            if type(e).__name__ in _PASSTHROUGH or not isinstance(e, Exception):
                raise
            pending = e
    else:
        pending = None
    max_retries = int(flags.flag("retry_max"))
    attempt = 0
    while True:
        try:
            if pending is not None:
                e, pending = pending, None
                raise e
            if plan is not None:
                step = faults.current_step()
                if fresh:
                    plan.check("compile", site, step)
                plan.check("execute", site, step)
                plan.check("hang", site, step)
            return thunk()
        except BaseException as e:
            if type(e).__name__ in _PASSTHROUGH or not isinstance(e, Exception):
                raise
            transient = _retry.is_transient(e)
            replayable = transient and not (
                retry_unsafe and not isinstance(e, faults.InjectedFault)
            )
            disruptive = not replayable or attempt >= max_retries
            _record_fault(site, e, transient, ladder_key, disruptive)
            if not replayable:
                _postmortem_escape(site, e, attempt)
                raise
            if attempt >= max_retries:
                profiler.count("retry_exhausted")
                _postmortem_escape(site, e, attempt)
                raise
            attempt += 1
            profiler.count("retry_attempts")
            delay = _retry.default_policy().delay_ms(attempt)
            _trace.emit("retry", site=site, attempt=attempt,
                        delay_ms=round(delay, 2), error=type(e).__name__)
            if delay > 0:
                time.sleep(delay / 1000.0)
            profiler.count("retry_backoff_ms", delay)


def _postmortem_escape(site: str, e: BaseException, attempt: int):
    """An unrecovered fault is escaping execute(): dump a postmortem (no-op
    unless FLAGS_postmortem_dir is set) with the site, the retries, the
    classification and the flight recorder's tail — even when the caller's
    fallback rung later completes the step."""
    _trace.dump_postmortem(
        "unrecovered_fault", exc=e, site=site, retries=attempt,
        transient=_retry.is_transient(e),
        injected=isinstance(e, faults.InjectedFault),
    )


def _record_fault(site: str, e: BaseException, transient: bool,
                  ladder_key: Hashable, disruptive: bool):
    profiler.count("fault_events")
    profiler.count_labeled("fault_sites", site)
    injected = isinstance(e, faults.InjectedFault)
    if injected:
        profiler.count("injected_faults")
    profiler.count("transient_faults" if transient else "fatal_faults")
    _trace.emit("fault", site=site, error=type(e).__name__, transient=transient,
                injected=injected, disruptive=disruptive)
    # only DISRUPTIVE faults (fatal, or transient with retries exhausted)
    # count toward demotion: a retried-and-recovered fault re-ran the same
    # program, so demoting on it would switch rungs for no reliability gain
    if disruptive:
        tier = _SITE_TIER.get(site)
        if tier is not None:
            _ladder.degradation_ladder().record_fault(tier, key=ladder_key)


def lazy_tier_ok() -> bool:
    """Fast gate read by the eager dispatcher: False while the ladder has
    the lazy tier demoted (calls then take the per-op path)."""
    return _ladder.degradation_ladder().allows("lazy")


def captured_tier_ok(key: Hashable = None) -> bool:
    return _ladder.degradation_ladder().allows("captured", key)


def on_step_end(source: str = "train"):
    """Step-boundary tick (``Optimizer.step`` with 'train', each serving
    engine tick with 'serve[<uid>]'): advances the fault-injection step
    counter, the ladder's cooldown clocks and the stall watchdog's
    heartbeat for `source` (FLAGS_trace_stall_ms)."""
    faults.advance_step()
    _ladder.degradation_ladder().step_end()
    _trace.step_heartbeat(source)
    # the perf-regression sentinel's and the attribution registry's lap
    # (paddle_tpu/resilience/runtime.py:183-215): a captured training step
    # laps under its armed signature, so a re-captured step re-baselines
    try:
        key = source
        if source == "train":
            from ..core import lazy as _lazy

            sig = _lazy.step_signature_id()
            if sig is not None:
                key = f"train[{sig}]"
        # inner try: an attribution failure must not cost the sentinel its lap
        try:
            from ..profiler import attribution as _attribution

            _attribution.step_lap(key)
        except Exception:
            pass
        from ..profiler import sentinel as _sentinel

        if _sentinel.PerfSentinel.enabled():
            _sentinel.default_sentinel().lap(key)
    except Exception:
        pass  # the sentinel must never break the step boundary


def state() -> dict:
    """Snapshot of the resilience runtime (postmortems read this)."""
    return {
        "step": faults.current_step(),
        "fault_inject": str(flags.flag("fault_inject")),
        "retry_max": int(flags.flag("retry_max")),
        "numeric_rescue": _rescue.mode(),
        "ladder": _ladder.degradation_ladder().state(),
    }


def reset():
    """Reset harness + ladder state (test isolation; counters are reset
    separately via profiler.reset_dispatch_counters)."""
    faults.reset()
    _ladder.degradation_ladder().reset()
