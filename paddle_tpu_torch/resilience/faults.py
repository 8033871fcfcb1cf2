"""Deterministic fault-injection harness (FLAGS_fault_inject): the port of
``paddle_tpu/resilience/faults.py``, host code copied as it is.

The chaos half of the resilience runtime: a spec string describes *synthetic*
faults — device/runtime errors, compile errors, simulated hangs, NaN
poisoning, mid-write kills — and the harness fires them at the execution
choke points routed through ``resilience.runtime.execute``: in the port the
serving engine's prefill/decode rungs and its eager floor (``op``), and the
fused optimizer update (``optimizer``). The grammar keeps the JAX package's
whole site set, so a spec written for one package parses in the other.

Spec grammar (comma-separated clauses, tokens separated by ':'):

    FLAGS_fault_inject="execute:p=0.2,compile:step>=3,nan:grads"

    clause   := kind (':' qualifier)*
    kind     := execute | compile | hang | nan | kill
    qualifier:= p=<float>      fire probability per (site, step)
              | step>=<int> | step<=<int> | step=<int>   step window
              | x=<int>        consecutive attempts the fault fires at one
                               matched (site, step) before letting the
                               retry through (default 1)
              | <word>         target filter: a site name for execute/
                               compile/hang/kill (op, segment, backward,
                               optimizer, captured, checkpoint, prefill,
                               decode) or a value target for nan (grads)

Decisions are SEEDED per (clause, site, step) from FLAGS_fault_seed, so a
failing run replays exactly: the same step faults at the same site every
time. Injected errors are raised BEFORE the wrapped program executes, so a
retry re-runs the program from scratch — injection never corrupts state.
"""
from __future__ import annotations

import os
import time
import zlib
from typing import List, Optional

from ..core import flags

__all__ = [
    "FaultClause",
    "FaultPlan",
    "InjectedCompileError",
    "InjectedExecuteError",
    "InjectedFault",
    "InjectedHang",
    "active_plan",
    "advance_step",
    "current_step",
    "maybe_kill",
    "parse_fault_spec",
    "reset",
]

_KINDS = ("execute", "compile", "hang", "nan", "kill")

# the closed set of site targets a clause may name: the execution choke
# points routed through resilience.runtime.execute (including the serving
# engine's prefill/decode program launches), plus the nan-injection
# targets — validated at parse time so a typo'd site fails loud instead of
# silently matching nothing
_SITES = frozenset((
    "op", "segment", "backward", "optimizer", "captured", "checkpoint",
    "prefill", "decode",
    "grads",
))


class InjectedFault(RuntimeError):
    """Synthetic fault from the harness. Raised before the wrapped program
    runs, so retrying the call is always safe."""

    transient = True


class InjectedExecuteError(InjectedFault):
    """Synthetic device/runtime failure (a transient runtime-error stand-in)."""


class InjectedCompileError(InjectedFault):
    """Synthetic compile failure at a fresh-compile point."""


class InjectedHang(InjectedFault):
    """Simulated hang: the harness stalls FLAGS_fault_hang_ms, then raises as
    if a watchdog had fired — classified transient, so the retry path runs."""


class FaultClause:
    """One parsed clause of the spec."""

    __slots__ = ("kind", "p", "step_lo", "step_hi", "step_eq", "repeat",
                 "target", "index")

    def __init__(self, kind: str, index: int):
        if kind not in _KINDS:
            raise ValueError(
                f"invalid fault kind {kind!r}: expected one of {_KINDS}"
            )
        self.kind = kind
        self.index = index
        self.p = 1.0
        self.step_lo: Optional[int] = None
        self.step_hi: Optional[int] = None
        self.step_eq: Optional[int] = None
        self.repeat = 1
        self.target: Optional[str] = None

    def matches(self, kind: str, site: str, step: int) -> bool:
        if self.kind != kind:
            return False
        if self.target is not None and self.target != site:
            return False
        if self.step_eq is not None and step != self.step_eq:
            return False
        if self.step_lo is not None and step < self.step_lo:
            return False
        if self.step_hi is not None and step > self.step_hi:
            return False
        return True

    def __repr__(self):
        return (f"<FaultClause {self.kind} p={self.p} target={self.target} "
                f"step=[{self.step_lo},{self.step_eq},{self.step_hi}] "
                f"x={self.repeat}>")


def parse_fault_spec(spec: str) -> List[FaultClause]:
    """Parse a FLAGS_fault_inject spec into clauses; raises on junk."""
    clauses: List[FaultClause] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        tokens = raw.split(":")
        clause = FaultClause(tokens[0].strip(), len(clauses))
        for tok in tokens[1:]:
            tok = tok.strip()
            if tok.startswith("p="):
                clause.p = float(tok[2:])
            elif tok.startswith("step>="):
                clause.step_lo = int(tok[6:])
            elif tok.startswith("step<="):
                clause.step_hi = int(tok[6:])
            elif tok.startswith("step="):
                clause.step_eq = int(tok[5:])
            elif tok.startswith("x="):
                clause.repeat = max(1, int(tok[2:]))
            elif tok and ("=" not in tok and "<" not in tok and ">" not in tok):
                if tok not in _SITES:
                    raise ValueError(
                        f"unknown fault site {tok!r} in clause {raw!r}: "
                        f"expected one of {sorted(_SITES)} — a typo here "
                        "would silently inject nothing"
                    )
                if clause.target is not None:
                    raise ValueError(
                        f"duplicate site in clause {raw!r}: a clause takes "
                        "at most one site target"
                    )
                clause.target = tok
            else:
                raise ValueError(
                    f"invalid fault-spec qualifier {tok!r} in clause {raw!r}"
                )
        clauses.append(clause)
    return clauses


class FaultPlan:
    """Parsed spec + the per-(clause, site, step) occurrence bookkeeping that
    makes injection deterministic AND lets a retry eventually succeed: a
    clause fires at most `x` consecutive attempts per matched (site, step)."""

    def __init__(self, clauses: List[FaultClause], seed: int):
        self.clauses = clauses
        self.seed = int(seed)
        self._fired = {}

    def _roll(self, clause: FaultClause, site: str, step: int) -> bool:
        if clause.p >= 1.0:
            return True
        key = f"{self.seed}:{clause.index}:{site}:{step}".encode()
        return (zlib.crc32(key) / 2**32) < clause.p

    def _fires(self, kind: str, site: str, step: int) -> Optional[FaultClause]:
        for clause in self.clauses:
            if not clause.matches(kind, site, step):
                continue
            if not self._roll(clause, site, step):
                continue
            key = (clause.index, site, step)
            n = self._fired.get(key, 0)
            if n >= clause.repeat:
                continue
            self._fired[key] = n + 1
            return clause
        return None

    def would_fire(self, kind: str, site: str, step: int) -> bool:
        """Non-consuming peek: True when `check`/`nan_fires` for this
        (kind, site, step) would fire right now (x= budget not exhausted).
        The capture controller uses it to route nan injection to a tier
        that can poison a materialized gradient, without spending the
        budget the fallback path's real check will consume."""
        for clause in self.clauses:
            if not clause.matches(kind, site, step):
                continue
            if not self._roll(clause, site, step):
                continue
            if self._fired.get((clause.index, site, step), 0) >= clause.repeat:
                continue
            return True
        return False

    def check(self, kind: str, site: str, step: int):
        """Raise the injected fault for (kind, site, step), if one fires."""
        clause = self._fires(kind, site, step)
        if clause is None:
            return
        if kind == "compile":
            raise InjectedCompileError(
                f"injected compile fault at site '{site}' (step {step})"
            )
        if kind == "hang":
            time.sleep(float(flags.flag("fault_hang_ms")) / 1000.0)
            raise InjectedHang(
                f"injected hang at site '{site}' (step {step}): watchdog fired"
            )
        raise InjectedExecuteError(
            f"injected device fault at site '{site}' (step {step}): "
            "UNAVAILABLE: simulated transient runtime error"
        )

    def nan_fires(self, target: str, step: int) -> bool:
        """True when a `nan:<target>` clause fires this step (counted like
        execute faults: at most `x` times per (target, step))."""
        return self._fires("nan", target, step) is not None

    def kill_fires(self, site: str, step: int) -> bool:
        return self._fires("kill", site, step) is not None

    def prune(self, step: int):
        """Drop occurrence bookkeeping older than a few steps so long runs
        don't grow the dict without bound."""
        if len(self._fired) > 256:
            stale = [k for k in self._fired if k[2] < step - 4]
            for k in stale:
                del self._fired[k]


# ---------------------------------------------------------------------------
# Module state: the active plan (cached per (spec, seed)) and the global
# step counter the qualifiers are evaluated against. The step advances at
# every optimizer.step() boundary and every serving engine tick
# (resilience.runtime.on_step_end).
# ---------------------------------------------------------------------------
_plan: Optional[FaultPlan] = None
_plan_key = None
_step = 0


def active_plan() -> Optional[FaultPlan]:
    """The FaultPlan for the current FLAGS_fault_inject value, or None when
    injection is off. Changing the flag (or the seed) resets the plan's
    occurrence bookkeeping — each scenario replays from scratch; that
    includes toggling injection off and back on with the SAME spec, so the
    cached plan (and its consumed x= budgets) is dropped on the off edge."""
    global _plan, _plan_key
    spec = str(flags.flag("fault_inject"))
    if not spec:
        _plan = None
        _plan_key = None
        return None
    seed = int(flags.flag("fault_seed"))
    key = (spec, seed)
    if _plan_key != key:
        _plan = FaultPlan(parse_fault_spec(spec), seed)
        _plan_key = key
    return _plan


def current_step() -> int:
    return _step


def advance_step():
    global _step
    _step += 1
    if _plan is not None:
        _plan.prune(_step)


def reset():
    """Clear the plan cache and the step counter (test isolation)."""
    global _plan, _plan_key, _step
    _plan = None
    _plan_key = None
    _step = 0


def maybe_kill(site: str):
    """Hard-exit the process when a `kill:<site>` clause fires — the
    crash-consistency probe for checkpoint IO (a mid-save kill must never
    corrupt the latest restorable snapshot). The port has no checkpoint
    writer yet (ROADMAP queue 1 item 11); the call is here for it."""
    plan = active_plan()
    if plan is not None and plan.kill_fires(site, current_step()):
        os._exit(137)
