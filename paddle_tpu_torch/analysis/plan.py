"""Planner-guided rematerialization: the port of
``paddle_tpu/analysis/plan.py`` (``RematPlan`` :167, ``build_remat_plan``
:307, ``cold_state_indices`` :429, ``plan_program`` :464,
``record_failure`` / ``state`` :570/:588).

The liveness planner (``analysis.memory``) reports a program's peak; this
module uses it to choose what to recompute so the peak fits a budget, and
emits a :class:`RematPlan` the execution layers apply.

A port program is a recorded run of one training step, not a jaxpr, so a
plan cannot slice one. Its unit is a LAYER CALL: each recorded op carries
the layer call that issued it (``Op.scope``), and the forward (the ops
before the ``"backward"`` mark) splits into the child calls of its
outermost layer calls: GPT-2's embeddings, its decoder layers, its final
norm, and the loss layer. Ops between those calls (the tied head's
product) are glue: kept. A unit never goes below those children (a
deliberate difference): recomputing a sublayer whose input also feeds a
residual add moved that input's gradient by an ulp on the CPU, where
whole decoder layers recompute bitwise.
A stage is a contiguous range of the forward's ops whose bounds fall on
unit bounds; a remat stage recomputes each layer call inside it as its own
segment (``incubate.recompute``'s ``_Segment``, which replays dropout masks
and the O1 state bitwise), keeping the boundaries between them saved: the
JAX plan's one ``jax.checkpoint`` per stage becomes one segment per layer
call (a deliberate difference).

Measuring a candidate does not run it: ``simulate_peak`` replays the
candidate's remat on the unplanned step's recorded IR. A saved activation
of a rematerialized call (an interior value the backward reads) dies at
its last forward read and is born again where the backward first needs one
of that call's values (the recomputation), living to its last backward
read; the call's inputs, which the segment saves, live to that point.
Nothing is allocated for a candidate, on the card or anywhere.

``plan.n_eqns`` is the forward's op count (its ops that are not views,
``Program.n_forward_ops``): a plan applied to a step whose forward records
another count is stale, falls back unplanned, and is
counted (``memory_plan_failures``).
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import Program

__all__ = [
    "RematPlan",
    "build_remat_plan",
    "cold_state_indices",
    "forward_units",
    "plan_program",
    "record_failure",
    "simulate_peak",
    "state",
]

_MB = float(1 << 20)


# ---------------------------------------------------------------------------
# Units: the layer calls of the forward
# ---------------------------------------------------------------------------
def forward_units(program: Program) -> List[Tuple[int, int, str, int]]:
    """The forward's remat units in issue order: ``(start, end, path,
    occurrence)`` per layer call (module path from the outermost call, and
    which call of that module it is). A unit is a child call of an
    outermost call (GPT-2's embeddings, each decoder layer, the final
    norm), a chain of single children collapsed; a call with no child is
    its own unit (a loss layer)."""
    n = program.n_forward
    calls = [c for c in program.calls if c.start < n]
    kids: Dict[int, list] = {}
    for c in calls:
        kids.setdefault(c.parent, []).append(c)
    units = []
    for root in sorted(kids.get(-1, []), key=lambda c: c.start):
        layer = [root]
        while len(layer) == 1 and kids.get(layer[0].index):
            layer = sorted(kids[layer[0].index], key=lambda c: c.start)
        units += layer
    return [(c.start, min(c.end, n), c.path, c.occurrence) for c in units if c.start < c.end]


# ---------------------------------------------------------------------------
# Liveness with rematerialization, over a recorded step
# ---------------------------------------------------------------------------
def _intervals(program: Program) -> Dict[int, List[int]]:
    """vid -> [born, dies, bytes], the liveness planner's (donation-credited)
    live ranges."""
    n = len(program.ops)
    last: Dict[int, int] = {}
    for op in program.ops:
        for vid in op.inputs:
            last[vid] = op.index
        for vid in op.outputs:
            if program.values[vid].producer != op.index:
                last[vid] = max(last.get(vid, -1), op.index)
    out = {}
    for v in program.values.values():
        if v.producer < 0:
            out[v.vid] = [-1, n, v.nbytes]
        else:
            dies = n if v.vid in program.escaping else last.get(v.vid, v.producer)
            out[v.vid] = [v.producer, max(dies, v.producer), v.nbytes]
    return out


def _reads(program: Program) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {}
    for op in program.ops:
        for vid in op.inputs:
            out.setdefault(vid, []).append(op.index)
    return out


def simulate_peak(program: Program, remat: Sequence[Tuple[int, int]]) -> int:
    """The planner's peak of ``program`` (a recorded step) with the layer
    calls spanning op ranges ``remat`` recomputed in the backward."""
    from .memory import _peak_of

    n, fwd = len(program.ops), program.n_forward
    iv = _intervals(program)
    reads = _reads(program)
    extra = []
    for start, end in remat:
        interior, t_re, t_end = [], None, -1
        for vid, (born, dies, nb) in iv.items():
            if not start <= born < end or program.values[vid].producer < 0:
                continue
            rs = reads.get(vid, [])
            if vid in program.escaping or any(end <= r < fwd for r in rs):
                continue  # an output of the call: kept
            back = [r for r in rs if r >= fwd]
            if not back:
                continue  # dies inside the forward anyway
            interior.append((vid, [r for r in rs if r < fwd], back))
            t_re = min(back) if t_re is None else min(t_re, min(back))
            t_end = max(t_end, max(back))
        if t_re is None:
            continue
        for vid, fwd_reads, back in interior:
            born, _, nb = iv[vid]
            iv[vid][1] = max([born] + fwd_reads)
            extra.append((t_re, max(back), nb))  # recomputed for the backward
        for vid, (born, dies, nb) in iv.items():  # the segment's saved inputs
            if born < start and any(start <= r < end for r in reads.get(vid, [])):
                iv[vid][1] = max(dies, t_end)
    peak, _ = _peak_of([tuple(x) for x in iv.values()] + extra, n)
    return int(peak)


# ---------------------------------------------------------------------------
# The plan object
# ---------------------------------------------------------------------------
class RematPlan:
    """A chosen staging of one recorded step's forward, plus the planner's
    before/after peaks. ``units`` are the forward's layer calls; a remat
    stage recomputes every call inside it. Apply with :meth:`bind`;
    display with :meth:`to_dict` / :meth:`summary`."""

    def __init__(self, *, stages, n_eqns, budget_bytes, peak_before_bytes, peak_after_bytes,
                 recompute_flops, full_remat_flops, source="", note="", evals=0, units=(),
                 program=None):
        self.stages = tuple((int(s), int(t), bool(r)) for s, t, r in stages)
        self.n_eqns = int(n_eqns)
        self.budget_bytes = int(budget_bytes)
        self.peak_before_bytes = int(peak_before_bytes)
        self.peak_after_bytes = int(peak_after_bytes)
        self.recompute_flops = int(recompute_flops)
        self.full_remat_flops = int(full_remat_flops)
        self.source = source
        self.note = note
        self.evals = int(evals)
        self.units = tuple(units)
        self.program = program

    @property
    def has_cuts(self) -> bool:
        return any(r for _s, _t, r in self.stages)

    @property
    def feasible(self) -> bool:
        return self.budget_bytes <= 0 or self.peak_after_bytes <= self.budget_bytes

    @property
    def cut_points(self) -> Tuple[int, ...]:
        return tuple(s for s, _t, _r in self.stages[1:])

    @property
    def remat_units(self) -> List[Tuple[int, int, str, int]]:
        """The layer calls the plan recomputes."""
        return [u for u in self.units
                if any(r and s <= u[0] and u[1] <= t for s, t, r in self.stages)]

    @property
    def recompute_pct(self) -> float:
        """Predicted recompute FLOPs as % of one full forward: the uniform
        per-block plan (``use_recompute``) sits near 100."""
        if not self.full_remat_flops:
            return 0.0
        return 100.0 * self.recompute_flops / self.full_remat_flops

    def fingerprint(self) -> str:
        payload = repr((self.stages, self.n_eqns, self.budget_bytes))
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    def _modules(self, roots) -> Dict[int, Tuple[torch.nn.Module, set]]:
        """{id(module): (module, the calls of it to recompute)} of the
        recomputed layers in ``roots`` (the model, and the loss layer when it
        is one); raises ValueError when a layer is missing."""
        by_type = {type(r).__name__: r for r in roots if isinstance(r, torch.nn.Module)}
        out: Dict[int, Tuple[torch.nn.Module, set]] = {}
        for _s, _e, path, occ in self.remat_units:
            head, _, rest = path.partition(".")
            try:
                mod = by_type[head].get_submodule(rest) if rest else by_type[head]
            except (KeyError, AttributeError):
                raise ValueError(f"memory plan names layer {path!r}, which none of the bound "
                                 "layers has: replan for this model") from None
            out.setdefault(id(mod), (mod, set()))[1].add(int(occ))
        return out

    def applies_to(self, *roots) -> bool:
        """Whether every layer the plan recomputes exists in ``roots`` (a plan
        made for another model does not)."""
        try:
            self._modules(roots)
        except ValueError:
            return False
        return True

    @contextlib.contextmanager
    def bind(self, *roots):
        """Apply the plan while the block runs: each rematerialized layer
        call of ``roots`` runs as one recompute segment. Leaves every layer
        as it was."""
        from ..incubate.recompute import _segment

        patched = []
        try:
            for mod, wanted in self._modules(roots).values():
                had = "forward" in mod.__dict__
                orig = mod.forward
                seen = [0]

                def forward(*args, _orig=orig, _mod=mod, _occ=wanted, _seen=seen, **kwargs):
                    k = _seen[0]
                    _seen[0] += 1
                    if k in _occ:
                        return _segment(_orig, list(_mod.parameters()), args, kwargs)
                    return _orig(*args, **kwargs)

                mod.forward = forward
                patched.append((mod, had, orig))
            yield self
        finally:
            for mod, had, orig in patched:
                if had:
                    mod.forward = orig
                else:
                    del mod.forward

    def to_dict(self) -> Dict[str, Any]:
        return {
            "source": self.source,
            "n_eqns": self.n_eqns,
            "stages": [{"start": s, "end": t, "remat": r} for s, t, r in self.stages],
            "cut_points": list(self.cut_points),
            "remat_layers": [f"{p}#{o}" for _s, _e, p, o in self.remat_units],
            "budget_mb": round(self.budget_bytes / _MB, 2),
            "peak_before_mb": round(self.peak_before_bytes / _MB, 2),
            "peak_after_mb": round(self.peak_after_bytes / _MB, 2),
            "recompute_flops": self.recompute_flops,
            "full_remat_flops": self.full_remat_flops,
            "recompute_pct": round(self.recompute_pct, 1),
            "feasible": self.feasible,
            "fingerprint": self.fingerprint(),
            "evals": self.evals,
            "note": self.note,
        }

    def summary(self) -> str:
        d = self.to_dict()
        lines = [
            f"memory plan [{self.source}] {'FEASIBLE' if self.feasible else 'INFEASIBLE'} "
            f"fingerprint={d['fingerprint']}",
            f"  peak: {d['peak_before_mb']} MB -> {d['peak_after_mb']} MB "
            f"(budget {d['budget_mb']} MB)",
            f"  recompute: {d['recompute_pct']}% of one forward "
            "(uniform per-block recompute ~ 100%)",
        ]
        if self.has_cuts:
            marked = [f"[{s}:{t})" + ("*" if r else "") for s, t, r in self.stages]
            lines.append(f"  stages over {self.n_eqns} forward ops (* = rematerialized): "
                         + " ".join(marked))
            lines.append(f"  rematerialized layer calls: {d['remat_layers']}")
        else:
            lines.append(f"  no cuts chosen ({self.note or 'peak already under budget'})")
        return "\n".join(lines)

    def __repr__(self):
        return (f"RematPlan(source={self.source!r}, peak={self.peak_before_bytes / _MB:.1f}->"
                f"{self.peak_after_bytes / _MB:.1f}MB, budget={self.budget_bytes / _MB:.1f}MB, "
                f"cuts={list(self.cut_points)}, recompute={self.recompute_pct:.0f}%, "
                f"feasible={self.feasible})")


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------
def _byte_balanced_bounds(weights: List[int], k: int) -> List[int]:
    """Split ``range(len(weights))`` into ``k`` contiguous chunks of roughly
    equal total weight (per-unit output bytes)."""
    n = len(weights)
    total = max(1, sum(weights))
    bounds = [0]
    acc = 0
    target = total / k
    for i, w in enumerate(weights):
        acc += w
        while len(bounds) < k and acc >= target * len(bounds):
            nxt = i + 1
            if bounds[-1] < nxt < n:
                bounds.append(nxt)
            else:
                break
    while len(bounds) < k:
        nxt = min(n - 1, bounds[-1] + 1)
        if nxt <= bounds[-1]:
            break
        bounds.append(nxt)
    bounds.append(n)
    return bounds


def build_remat_plan(program: Program, *, budget_bytes: int,
                     measure: Optional[Callable] = None, source: str = "loss",
                     max_evals: int = 8, min_gain: float = 0.01) -> RematPlan:
    """Pick a staging of ``program``'s forward (a recorded training step)
    whose peak fits ``budget_bytes``, spending as little recompute as
    possible. ``measure(remat_ranges) -> peak_bytes`` is the oracle (the
    op ranges of the layer calls to recompute; default ``simulate_peak``
    over ``program``, which runs nothing).

    Candidates: K byte-balanced stages over the forward's layer calls, the
    earliest m marked for remat (their saved activations span the whole
    backward), ordered by predicted recompute FLOPs; a bisection over that
    order finds the cheapest feasible one in ``max_evals`` measurements,
    then walks left from it. When nothing fits, the best peak seen is kept
    if it gains at least ``min_gain``."""
    from .memory import plan_memory

    if measure is None:
        def measure(ranges):
            return simulate_peak(program, ranges)

    t0 = time.perf_counter()
    n = program.n_forward
    peak_before = int(plan_memory(program).peak_bytes)
    evals = 1
    units = forward_units(program)
    flops = [sum(op.flops for op in program.ops[s:e]) for s, e, _p, _o in units]
    out_bytes = [sum(program.values[v].nbytes for op in program.ops[s:e] for v in op.outputs
                     if program.values[v].producer == op.index) for s, e, _p, _o in units]
    full_flops = sum(op.flops for op in program.ops[:n])

    def stages_of(bounds, m):
        out = []
        for i in range(len(bounds) - 1):
            s = 0 if i == 0 else units[bounds[i]][0]
            t = n if i == len(bounds) - 2 else units[bounds[i + 1]][0]
            out.append((s, t, i < m))
        return out

    def ranges_of(stages):
        return [(u[0], u[1]) for u in units
                if any(r and s <= u[0] and u[1] <= t for s, t, r in stages)]

    def cost_of(stages):
        return sum(f for f, u in zip(flops, units)
                   if any(r and s <= u[0] and u[1] <= t for s, t, r in stages))

    def finish(stages, peak_after, note):
        plan = RematPlan(stages=stages, n_eqns=program.n_forward_ops, budget_bytes=budget_bytes,
                         peak_before_bytes=peak_before, peak_after_bytes=peak_after,
                         recompute_flops=cost_of(stages), full_remat_flops=full_flops,
                         source=source, note=note, evals=evals, units=units, program=program)
        _record(source, plan, (time.perf_counter() - t0) * 1000.0)
        return plan

    identity = [(0, n, False)]
    if budget_bytes <= 0 or peak_before <= budget_bytes:
        return finish(identity, peak_before, "peak already under budget")
    if len(units) < 2:
        return finish(identity, peak_before, "program too small to stage")

    candidates = []
    for k in (2, 3, 4, 6, 8, 12, 16, 24, 32):
        if k > len(units):
            break
        bounds = _byte_balanced_bounds(out_bytes, k)
        k = len(bounds) - 1
        for m in sorted({max(1, k // 2), k - 1, k}):
            stages = stages_of(bounds, m)
            candidates.append((cost_of(stages), k, tuple(stages)))
    candidates.sort(key=lambda c: (c[0], c[1]))
    seen, ordered = set(), []
    for cost, _k, stages in candidates:
        if stages not in seen and cost > 0:
            seen.add(stages)
            ordered.append((cost, list(stages)))

    best_stages, best_peak = identity, peak_before
    measured: Dict[int, int] = {}

    def peak_of(idx: int) -> int:
        nonlocal evals, best_stages, best_peak
        if idx not in measured:
            stages = ordered[idx][1]
            measured[idx] = int(measure(ranges_of(stages)))
            evals += 1
            if measured[idx] < best_peak:
                best_stages, best_peak = stages, measured[idx]
        return measured[idx]

    lo, hi, found = 0, len(ordered) - 1, None
    while lo <= hi and evals < max_evals:
        mid = (lo + hi) // 2
        if peak_of(mid) <= budget_bytes:
            found, hi = mid, mid - 1
        else:
            lo = mid + 1
    if found is not None:
        i = found - 1
        while i >= 0 and evals < max_evals:
            if i not in measured and peak_of(i) <= budget_bytes:
                found = i
            i -= 1
        return finish(ordered[found][1], measured[found], "")
    if best_peak < peak_before * (1.0 - min_gain):
        return finish(best_stages, best_peak, "budget unreachable; best reduction kept")
    return finish(identity, peak_before, "remat cannot reduce this program's peak")


# ---------------------------------------------------------------------------
# Cold optimizer state (feeds optimizer.offload)
# ---------------------------------------------------------------------------
def cold_state_indices(program: Program, states: Sequence[Tuple[str, torch.Tensor]]
                       ) -> List[Tuple[int, str]]:
    """Of ``states`` ([(name, tensor)], the optimizer's state tensors), those
    COLD in the recorded step ``program``: first read inside the trailing
    update (at or after the ``"update"`` mark, past the step's midpoint).
    Returns ``(index into states, name)``; their storages are dead through
    the forward and the backward, the window the offload scheduler parks
    them on the host."""
    first: Dict[int, int] = {}
    for op in program.ops:
        for vid in op.inputs:
            first.setdefault(vid, op.index)
    n = max(1, len(program.ops))
    horizon = program.marks.get("update", program.n_forward)
    cold = []
    for i, (name, t) in enumerate(states):
        vid = program.value_of(t)
        fr = first.get(vid) if vid is not None else None
        if fr is not None and fr >= horizon and fr >= n // 2:
            cold.append((i, str(name)))
    return cold


# ---------------------------------------------------------------------------
# Whole-program planning for a layer (graph_lint --plan)
# ---------------------------------------------------------------------------
def plan_program(target, feed_specs=None, *, memory_budget_mb=None, source=None,
                 max_evals: int = 8) -> RematPlan:
    """Plan remat for a layer the way ``graph_lint --plan`` sees it: record
    a synthetic training step (the forward, the sum of its float outputs,
    the backward over the parameters) once on zero inputs of
    ``feed_specs``, then search stagings of the forward until the step's
    planner peak fits the budget (FLAGS_memory_budget_mb when None)."""
    import numpy as np

    from . import _norm_specs, mark, recording
    from ..core import flags as _flags

    if not isinstance(target, torch.nn.Module):
        raise TypeError("plan_program plans a layer (an nn.Layer / torch.nn.Module)")
    specs = _norm_specs(feed_specs)
    source = source or f"plan:{type(target).__name__}"
    budget_mb = (float(_flags.flag("memory_budget_mb")) if memory_budget_mb is None
                 else float(memory_budget_mb))
    params = [p for p in target.parameters() if p.requires_grad]
    if not params:
        raise ValueError(f"{source}: no trainable parameters to plan a training step over")
    device = params[0].device
    feeds = [torch.zeros(s, dtype=torch.from_numpy(np.zeros((), d)).dtype, device=device)
             for _, s, d in specs]
    with recording(source) as r:
        out = target(*feeds)
        outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(o, torch.Tensor) and o.is_floating_point()]
        loss = sum(o.float().sum() for o in outs)
        mark("backward")
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    del grads, loss, outs, out
    return build_remat_plan(r.program, budget_bytes=int(budget_mb * _MB), source=source,
                            max_evals=max_evals)


# ---------------------------------------------------------------------------
# Module state: last plan per source (for /statusz, metrics, events)
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_state: Dict[str, Dict[str, Any]] = {}


def _record(source: str, plan: RematPlan, build_ms: float) -> None:
    doc = plan.to_dict()
    doc["build_ms"] = round(build_ms, 2)
    with _lock:
        _state[source] = doc
    try:
        from ..core import lazy

        lazy._counters()["memory_plan_builds"] += 1
        lazy._emit("memory_plan", site=source, phase="built", fingerprint=doc["fingerprint"],
                   feasible=doc["feasible"], peak_before_mb=doc["peak_before_mb"],
                   peak_after_mb=doc["peak_after_mb"], recompute_pct=doc["recompute_pct"])
    except Exception:  # noqa: BLE001
        pass
    try:
        from ..profiler import metrics as _metrics

        reg = _metrics.default_registry()
        labels = {"source": source}
        reg.gauge("memory_plan_peak_before_mb", doc="planner peak estimate before remat, MB",
                  labels=labels).set(doc["peak_before_mb"])
        reg.gauge("memory_plan_peak_after_mb",
                  doc="planner peak estimate with the chosen plan, MB",
                  labels=labels).set(doc["peak_after_mb"])
        reg.gauge("memory_plan_recompute_pct",
                  doc="predicted recompute as % of one forward (uniform per-block "
                      "recompute ~ 100)", labels=labels).set(doc["recompute_pct"])
    except Exception:  # noqa: BLE001
        pass


def record_failure(source: str, err: BaseException) -> None:
    """Book a plan that failed to build or apply (the execution layers call
    this before falling back to the unplanned step)."""
    with _lock:
        _state[source] = {"source": source, "failed": True,
                          "error": f"{type(err).__name__}: {err}"}
    try:
        from ..core import lazy

        lazy._counters()["memory_plan_failures"] += 1
        lazy._emit("memory_plan", site=source, phase="failed", error=type(err).__name__)
    except Exception:  # noqa: BLE001
        pass


def state() -> Dict[str, Any]:
    """The last plan (or failure) per source: the /statusz 'memory plan &
    offload' section reads this."""
    with _lock:
        return {k: dict(v) for k, v in _state.items()}


def _reset_state() -> None:  # tests
    with _lock:
        _state.clear()
