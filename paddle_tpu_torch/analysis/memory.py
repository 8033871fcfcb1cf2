"""The static memory planner: the port of ``paddle_tpu/analysis/memory.py``.

Over a recorded program (``analysis.Program``), every value (a storage) is
one buffer with a live range over the op timeline:

  - an op's fresh output is born at its op and dies at its last read, or
    escapes (lives to the end) when it was still referenced when the run
    ended: the outputs a caller keeps, gradients, a captured step's
    static outputs;
  - a program input (a parameter, an optimizer state, a batch) is
    caller-owned and lives throughout;
  - an input the program writes in place counts as DONATED: a CUDA graph
    writes a captured step's parameters and states in place, which is what
    donation buys the JAX package on the TPU (old and new values never
    coexist). ``peak_no_donation_bytes`` charges each such write a second
    buffer from the write to the end, so ``donation_credit_bytes`` says
    what the in-place writes save.

The peak is the largest live sum over the timeline, the caching
allocator's view without its rounding and fragmentation. ``memory_budget``
is the registered pass; ``captured_step_plans`` plans the captured step
this thread replayed last; ``device_hbm_bytes`` is the card's memory.

Donation safety (``donation_safety``, ``donation_verdicts``): in the port
"donated" means written in place by a captured program, so a use after
donation is a live external alias of such a storage, which the next replay
overwrites under it: a held ``numpy()`` view, a detached view, a tied
buffer bound at two positions. ``tensor_aliases`` and
``donated_buffer_alias_diags`` find them by one ``gc`` scan for tensors
(and numpy arrays) over the same storage; ``donated_buffer_diags`` adds the
tied buffers; ``donation_gate`` is the one gate the whole-step capture and
``compile_train_step`` run under FLAGS_check_programs.

``plan_block_pool`` sizes a paged KV pool from the budget: the decode
program recorded once on a MINIMAL pool gives the non-pool overhead, and
the pool gets ``(budget - overhead) // block_bytes`` blocks. The budget is
an explicit argument, else FLAGS_memory_budget_mb, else the card's memory
less what this process already holds outside the decode program's inputs
(a deliberate difference: the JAX package takes the whole HBM).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import flags as _flags
from . import Context, Diagnostic, Program, Severity, register_pass

__all__ = ["BlockPoolPlan", "Buffer", "MemoryPlan", "captured_step_plans",
           "device_hbm_bytes", "donated_buffer_alias_diags", "donated_buffer_diags",
           "donation_gate", "donation_verdicts", "plan_block_pool", "plan_memory",
           "tensor_aliases", "traced_program_diags"]

_MB = float(1 << 20)


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / _MB:.1f}MB"
    if n >= 1 << 10:
        return f"{n / 1024:.1f}KB"
    return f"{n}B"


@dataclasses.dataclass
class Buffer:
    """One planned buffer with its live range over the op timeline
    (born=-1: exists at program entry; dies=n_ops: escapes/held to exit)."""

    kind: str  # "param" | "buffer" | "feed" | "arg" | "op" | "copy"
    name: str  # role name or op path
    shape: Tuple
    dtype: str
    nbytes: int
    born: int
    dies: int
    donated: bool = False

    def label(self) -> str:
        return f"{self.kind}:{self.name}" if self.kind != "op" else self.name


class MemoryPlan:
    """Result of the liveness simulation over one program."""

    def __init__(self, buffers, n_ops, peak_bytes, peak_index, peak_op_path,
                 peak_no_donation_bytes):
        self.buffers: List[Buffer] = buffers
        self.n_ops = n_ops
        self.peak_bytes = peak_bytes
        self.peak_index = peak_index  # op timeline position of the peak
        self.peak_op_path = peak_op_path
        self.peak_no_donation_bytes = peak_no_donation_bytes

    @property
    def donation_credit_bytes(self) -> int:
        """Memory the in-place (donated) inputs save below the no-donation
        peak."""
        return self.peak_no_donation_bytes - self.peak_bytes

    @property
    def input_bytes(self) -> int:
        return sum(b.nbytes for b in self.buffers if b.born < 0)

    @property
    def const_bytes(self) -> int:
        return 0  # a recorded program's constants are inputs

    @property
    def output_bytes(self) -> int:
        return sum(b.nbytes for b in self.buffers
                   if b.born >= 0 and b.dies >= self.n_ops and b.kind == "op")

    @property
    def boundary_bytes(self) -> int:
        """Live bytes at program exit: inputs and escaping outputs, what
        stays resident between runs."""
        return sum(b.nbytes for b in self.live_at(self.n_ops) if b.kind != "copy")

    def live_at(self, t: int) -> List[Buffer]:
        return [b for b in self.buffers if b.born <= t <= b.dies]

    def top_live(self, k: int = 5) -> List[Buffer]:
        live = sorted(self.live_at(self.peak_index), key=lambda b: -b.nbytes)
        return live[:k]

    def to_dict(self) -> Dict:
        top = self.top_live(5)
        return {
            "peak_bytes": int(self.peak_bytes),
            "peak_mb": round(self.peak_bytes / _MB, 3),
            "peak_index": int(self.peak_index),
            "peak_op": self.peak_op_path,
            "peak_no_donation_bytes": int(self.peak_no_donation_bytes),
            "donation_credit_bytes": int(self.donation_credit_bytes),
            "input_bytes": int(self.input_bytes),
            "const_bytes": int(self.const_bytes),
            "output_bytes": int(self.output_bytes),
            "boundary_bytes": int(self.boundary_bytes),
            "n_ops": int(self.n_ops),
            "n_buffers": len(self.buffers),
            "top_live": [
                {"name": b.label(), "shape": list(map(int, b.shape)),
                 "dtype": b.dtype, "nbytes": int(b.nbytes), "donated": b.donated}
                for b in top
            ],
        }

    def __repr__(self):
        return (f"<MemoryPlan peak={_fmt_bytes(self.peak_bytes)} "
                f"@{self.peak_op_path or self.peak_index} "
                f"credit={_fmt_bytes(self.donation_credit_bytes)} "
                f"ops={self.n_ops} buffers={len(self.buffers)}>")


def _peak_of(intervals: Sequence[Tuple[int, int, int]], n_ops: int):
    """(peak bytes, peak time) over timeline t in [-1, n_ops] for
    (born, dies, nbytes) intervals (inclusive on both ends)."""
    delta = [0] * (n_ops + 3)
    for born, dies, nb in intervals:
        if dies < born or nb <= 0:
            continue
        delta[born + 1] += nb
        delta[dies + 2] -= nb
    cur, peak, at = 0, 0, -1
    for t in range(-1, n_ops + 1):
        cur += delta[t + 1]
        if cur > peak:
            peak, at = cur, t
    return peak, at


def plan_memory(program, donated: Optional[Sequence[int]] = None, roles=()) -> MemoryPlan:
    """Liveness simulation of a recorded program (an ``analysis.Program``
    or a ``Context`` over one). ``donated`` overrides which input value ids
    count as donated (default: those the program writes in place);
    ``roles`` names the inputs, in ``Program.inputs`` order."""
    if isinstance(program, Context):
        roles = roles or program.roles
        if donated is None:
            donated = program.donated
        program = program.program
    donated_set = set(donated if donated is not None else
                      (v.vid for v in program.values.values() if v.written))
    ops = program.ops
    n = len(ops)
    last_use: Dict[int, int] = {}
    first_write: Dict[int, int] = {}
    for op in ops:
        for vid in op.inputs:
            last_use[vid] = op.index
        for vid in op.outputs:
            v = program.values[vid]
            if v.producer != op.index:
                last_use[vid] = max(last_use.get(vid, -1), op.index)
                if v.producer < 0:
                    first_write.setdefault(vid, op.index)
    role_of = dict(zip(program.inputs, roles))
    buffers: List[Buffer] = []
    copies = []
    for v in program.values.values():
        if v.producer < 0:
            kind, name = (getattr(program, "roles", {}).get(v.vid)
                          or role_of.get(v.vid, ("arg", str(v.vid))))
            don = v.vid in donated_set
            buffers.append(Buffer(kind, name, v.shape, v.dtype, v.nbytes, -1, n, don))
            if don and v.vid in first_write:
                copies.append((first_write[v.vid], n, v.nbytes))
        else:
            dies = n if v.vid in program.escaping else last_use.get(v.vid, v.producer)
            op = ops[v.producer]
            buffers.append(Buffer("op", op.path, v.shape, v.dtype, v.nbytes,
                                  v.producer, max(dies, v.producer)))
    intervals = [(b.born, b.dies, b.nbytes) for b in buffers]
    peak, at = _peak_of(intervals, n)
    nodon_peak, _ = _peak_of(intervals + copies, n)
    peak_op = ops[at].path if 0 <= at < n else ("exit" if at >= n else "entry")
    return MemoryPlan(buffers, n, peak, at, peak_op, nodon_peak)


# ---------------------------------------------------------------------------
# Device memory (budget fallback when no explicit flag is set)
# ---------------------------------------------------------------------------
def device_hbm_bytes() -> Optional[int]:
    """The current card's memory (``torch.cuda.get_device_properties``), or
    None on a CPU run or before the process touched CUDA (a lint must not
    initialise the card just to ask its size)."""
    try:
        if not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory)
    except Exception:
        return None


def captured_step_plans():
    """(donation-credited plan, no-donation plan) of the captured
    whole-step program this thread replayed last, or None: the estimate
    ``profiler.measure_programs`` reports beside the measured figures."""
    from ..core import lazy

    program = lazy.captured_step_ir()
    if program is None:
        return None
    return plan_memory(program), plan_memory(program, donated=())


@register_pass("memory_budget")
def memory_budget(ctx: Context) -> List[Diagnostic]:
    if not ctx.ops:
        return []
    budget_mb = ctx.memory_budget_mb
    if budget_mb is None:
        flagged = float(_flags.flag("memory_budget_mb"))
        budget_mb = flagged if flagged > 0 else None
    donated = tuple(ctx.donated or ())
    hbm = device_hbm_bytes()
    if budget_mb is None and not donated and hbm is None:
        return []  # not configured: stay silent in the default suites

    plan = plan_memory(ctx)
    diags = []
    if budget_mb is not None or donated:
        top = plan.top_live(5)
        top_str = ", ".join(
            f"{b.label()} {b.dtype}{list(b.shape)} {_fmt_bytes(b.nbytes)}" for b in top)
        credit = (
            f"; donation credit {_fmt_bytes(plan.donation_credit_bytes)} "
            f"({len([b for b in plan.buffers if b.donated])} donated buffers)"
            if donated else "")
        diags.append(Diagnostic(
            Severity.INFO, "memory_budget",
            plan.peak_op_path if 0 <= plan.peak_index < plan.n_ops else "program",
            f"estimated peak device memory {_fmt_bytes(plan.peak_bytes)} "
            f"(inputs {_fmt_bytes(plan.input_bytes)}, outputs "
            f"{_fmt_bytes(plan.output_bytes)}{credit}); largest live: {top_str}",
            shapes=tuple(b.shape for b in top),
            dtypes=tuple(b.dtype for b in top),
            data=plan.to_dict(),
        ))
    budget_bytes = int(budget_mb * _MB) if budget_mb else None
    if budget_bytes is not None and plan.peak_bytes > budget_bytes:
        diags.append(Diagnostic(
            Severity.ERROR, "memory_budget", "program",
            f"estimated peak device memory {_fmt_bytes(plan.peak_bytes)} exceeds the "
            f"declared budget of {budget_mb:g} MB (FLAGS_memory_budget_mb)",
            hint="shrink batch/activation sizes, enable whole-step capture, or raise "
                 "the budget; the largest live buffers are listed in the memory "
                 "report diagnostic",
            data={"peak_bytes": int(plan.peak_bytes), "budget_mb": float(budget_mb)},
        ))
    if hbm is not None and plan.peak_bytes > hbm:
        diags.append(Diagnostic(
            Severity.ERROR, "memory_budget", "program",
            f"estimated peak device memory {_fmt_bytes(plan.peak_bytes)} exceeds "
            f"the card's memory ({_fmt_bytes(hbm)}): this program will run out of memory",
            hint="shard the model, shrink the batch, or enable recompute",
            data={"peak_bytes": int(plan.peak_bytes), "hbm_bytes": int(hbm)},
        ))
    return diags


# ---------------------------------------------------------------------------
# Donation safety
# ---------------------------------------------------------------------------
def _use_after_donate_diag(label, holders, source="") -> Diagnostic:
    """The one use-after-donate ERROR, shared by the pass (caller-provided
    alias_refs) and the runtime scan."""
    held = "; ".join(str(h) for h in holders[:3])
    more = f" (+{len(holders) - 3} more)" if len(holders) > 3 else ""
    return Diagnostic(
        Severity.ERROR, "donation_safety", label,
        f"use-after-donate: {len(holders)} live external reference(s) alias this "
        f"donated buffer [{held}{more}]; the captured program writes it in place, so "
        "the alias changes under its holder at the next replay (a numpy() view or a "
        "detach() held across a captured step is the classic shape of this bug)",
        hint="copy before holding (alias.clone()), drop the alias before the step, or "
             "keep the step off whole-step capture",
        source=source)


def _label(ctx: Context, vid: int) -> str:
    kind, name = ctx.role_of(vid)
    return f"{kind}:{name}"


@register_pass("donation_safety")
def donation_safety(ctx: Context) -> List[Diagnostic]:
    donated = set(ctx.donated or ())
    if not donated or ctx.program is None:
        return []  # nothing donated: vacuously safe, stay silent
    read = set()
    for op in ctx.ops:
        read.update(op.inputs)
    diags: List[Diagnostic] = []
    returned = set(ctx.program.outputs)
    for vid in sorted(donated):
        if vid in returned and not ctx.program.values[vid].written:
            diags.append(Diagnostic(
                Severity.ERROR, "donation_safety", _label(ctx, vid),
                "donated input is returned unchanged: the caller's output aliases a "
                "buffer the captured program writes in place at its next run",
                hint="return a copy, or keep this input out of the donated set",
                shapes=(ctx.program.values[vid].shape,)))
        elif vid not in read and not ctx.program.values[vid].written:
            diags.append(Diagnostic(
                Severity.INFO, "donation_safety", _label(ctx, vid),
                "donated input is never read: its buffer is free from program entry "
                "(full donation credit)"))
    for group in ctx.alias_groups:
        g = set(group)
        dg = g & donated
        if dg and len(g) > 1:
            names = ", ".join(_label(ctx, v) for v in sorted(g))
            diags.append(Diagnostic(
                Severity.ERROR, "donation_safety", _label(ctx, min(dg)),
                f"one runtime buffer is bound to {len(g)} argument positions ({names}) and "
                "at least one of them is written in place: the write changes what the "
                "other position reads",
                hint="pass distinct tensors, or keep the shared buffer out of the captured "
                     "program"))
    for vid, holders in sorted(ctx.alias_refs.items()):
        if vid in donated and holders:
            diags.append(_use_after_donate_diag(_label(ctx, vid), list(holders)))
    if not any(d.severity >= Severity.ERROR for d in diags):
        diags.append(Diagnostic(
            Severity.INFO, "donation_safety", "program",
            f"all {len(donated)} donated argument positions verified: no double-bound "
            "buffers, no live external aliases"))
    return diags


def donation_verdicts(ctx: Context) -> List[Dict[str, object]]:
    """Per-position verdicts of ``donation_safety`` over ``ctx``'s donated
    values: ``{"position", "role", "proven", "diagnostics"}``, ``proven``
    when no error names the position."""
    from . import run_passes

    diags = [d for d in run_passes(ctx, ["donation_safety"])
             if d.pass_name == "donation_safety"]
    out = []
    for vid in sorted(set(ctx.donated or ())):
        label = _label(ctx, vid)
        errs = [d for d in diags if d.severity >= Severity.ERROR
                and (d.op == label or label in (d.message or ""))]
        out.append({"position": int(vid), "role": label, "proven": not errs,
                    "diagnostics": [d.message for d in errs]})
    return out


def _scan_holders(targets: Dict, exclude=()) -> Dict:
    """ONE ``gc.get_objects()`` pass: {storage key: [description of a live
    tensor or numpy array over that storage]} for the storages of
    ``targets`` ({storage key: (data pointer, bytes, device type)}),
    leaving out the tensors in ``exclude`` (their owners)."""
    import gc

    import numpy as np

    ex = {id(t) for t in exclude}
    cpu = {k: (ptr, n) for k, (ptr, n, dev) in targets.items() if dev == "cpu"}
    found: Dict = {}
    for obj in gc.get_objects():
        kind = type(obj)  # not isinstance: no attribute of a foreign object is read
        if id(obj) in ex:
            continue
        if issubclass(kind, torch.Tensor):
            try:
                key = obj.untyped_storage()._cdata
            except Exception:  # noqa: BLE001
                continue
            if key in targets:
                found.setdefault(key, []).append(
                    f"tensor shape={tuple(obj.shape)} dtype={obj.dtype}")
        elif cpu and issubclass(kind, np.ndarray):
            try:
                ptr = obj.__array_interface__["data"][0]
            except Exception:  # noqa: BLE001
                continue
            for key, (lo, n) in cpu.items():
                if lo <= ptr < lo + n:
                    found.setdefault(key, []).append(
                        f"numpy array shape={obj.shape} dtype={obj.dtype}")
    return found


def _target(t):
    st = t.untyped_storage()
    return st._cdata, (st.data_ptr(), st.nbytes(), t.device.type)


def tensor_aliases(t, exclude=()) -> List[str]:
    """Descriptions of the live tensors and numpy arrays (outside
    ``exclude``, and besides ``t`` itself) over ``t``'s storage: what an
    in-place write by a captured program changes under its holder."""
    key, info = _target(t)
    return _scan_holders({key: info}, tuple(exclude) + (t,)).get(key, [])


def donated_buffer_alias_diags(named_tensors, exclude=(),
                               source="captured-step") -> List[Diagnostic]:
    """donation_safety errors for tensors a captured program writes in place:
    ``named_tensors`` is [(label, tensor)], ``exclude`` the tensors that own
    them. One ``gc`` pass covers all."""
    targets = dict(_target(t) for _label_, t in named_tensors)
    owners = tuple(exclude) + tuple(t for _l, t in named_tensors)
    found = _scan_holders(targets, owners)
    diags = []
    for label, t in named_tensors:
        holders = found.get(_target(t)[0], [])
        if holders:
            diags.append(_use_after_donate_diag(label, holders, source))
    return diags


def donated_buffer_diags(named_tensors, exclude=(),
                         source="captured-step") -> List[Diagnostic]:
    """The runtime donation scan shared by the whole-step capture and
    ``compile_train_step``: storages bound at two positions (tied weights),
    then the live-external-alias scan. Errors bump the
    ``donation_alias_flags`` dispatch counter."""
    by_key: Dict = {}
    for label, t in named_tensors:
        by_key.setdefault(_target(t)[0], []).append(label)
    diags: List[Diagnostic] = []
    for labels in by_key.values():
        if len(labels) > 1:
            diags.append(Diagnostic(
                Severity.ERROR, "donation_safety", labels[0],
                f"one runtime buffer is bound to {len(labels)} donated positions "
                f"({', '.join(labels)}): the program writes it in place twice, the second "
                "update reading the first's result",
                hint="untie the tensors (clone one), or keep the shared buffer out of the "
                     "update",
                source=source))
    diags += donated_buffer_alias_diags(named_tensors, exclude=exclude, source=source)
    if diags:
        from ..core import lazy

        lazy._counters()["donation_alias_flags"] += len(diags)
    return diags


def donation_gate(params, states, program_thunk, roles, donated, source,
                  static_diags=None) -> List[Diagnostic]:
    """The one donation-safety gate of the whole-step capture and
    ``compile_train_step``: the runtime scan of the parameters and
    optimizer states the program writes in place, plus the static passes
    over the program's recording (``program_thunk()``; pass the previous
    return value as ``static_diags`` to reuse it), then ``enforce`` per
    FLAGS_check_programs. The static result is returned only after enforce
    passes, so a raising verdict is proven again at the next call."""
    from . import enforce

    named = [(f"param:{getattr(p, 'name', '') or i}", p) for i, p in enumerate(params)]
    owners = list(params)
    for i, st in enumerate(states):
        for k in sorted(st):
            if isinstance(st[k], torch.Tensor):
                named.append((f"opt_state:{i}.{k}", st[k]))
                owners.append(st[k])
    diags = donated_buffer_diags(named, exclude=owners, source=source)
    if static_diags is None:
        static_diags = traced_program_diags(program_thunk, roles, donated, source)
    enforce(diags + static_diags, where=f"{source} donation")
    return static_diags


def traced_program_diags(program_thunk, roles, donated, source) -> List[Diagnostic]:
    """Once-per-build static check of a program written in place: its
    recorded IR (``program_thunk()``, a recording that happened anyway)
    through the memory passes. A missing recording yields []: the check
    never breaks the step it audits."""
    from . import run_passes

    try:
        program = program_thunk()
        if program is None:
            return []
        ctx = Context(program, roles, source, donated=donated)
        return run_passes(ctx, ["memory_budget", "donation_safety"])
    except Exception:  # noqa: BLE001
        return []


# ---------------------------------------------------------------------------
# Block pools
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BlockPoolPlan:
    """The planner's size of a paged KV block pool (paddle.serving).

    ``num_blocks`` is None when no budget is configured anywhere (argument,
    flag or detected card memory): the caller applies its default.
    ``overhead_bytes`` is the decode program's estimated peak without the
    pool: weights, activations, the gathered block views, block tables."""

    num_blocks: Optional[int]
    block_bytes: int
    budget_bytes: Optional[int]
    overhead_bytes: int
    trace_peak_bytes: int

    @property
    def est_peak_hbm_mb(self) -> float:
        """Estimated peak of the recorded decode program (MB)."""
        return self.trace_peak_bytes / _MB

    def pool_bytes(self, num_blocks: Optional[int] = None) -> int:
        n = self.num_blocks if num_blocks is None else num_blocks
        return int(n or 0) * self.block_bytes


# The share of the card the detected rung keeps out of a plan: what no
# recording of the decode program sees (the serve buckets' graph pools, the
# prefill activations, the streams' cuBLAS workspaces) and whatever the
# process allocates later. XLA gives a JAX process 75% of the card by
# default, the bytes_limit the JAX planner's detected rung reads.
DETECTED_HEADROOM = 0.25


def detected_budget_bytes(held_inputs_bytes: int = 0) -> Optional[int]:
    """The budget of the detected rung, or None off the card: the card's
    free memory (``torch.cuda.mem_get_info``, which sees every other
    process, the CUDA context and this process's allocator segments), the
    allocator's cached but unused bytes, and the program's inputs already
    resident (``held_inputs_bytes``: the weights, which the plan counts),
    less ``DETECTED_HEADROOM`` of the card's memory."""
    hbm = device_hbm_bytes()
    if hbm is None:
        return None
    dev = torch.cuda.current_device()
    free, _total = torch.cuda.mem_get_info(dev)
    cached = int(torch.cuda.memory_reserved(dev)) - int(torch.cuda.memory_allocated(dev))
    budget = int(free) + cached + int(held_inputs_bytes) - int(DETECTED_HEADROOM * hbm)
    return max(0, budget)


def plan_block_pool(record_thunk, *, block_bytes: int, pool_bytes_in_trace: int = 0,
                    budget_mb: Optional[float] = None, roles: Sequence = (),
                    donated: Sequence[int] = (),
                    source: str = "serving-decode") -> BlockPoolPlan:
    """Size a paged KV block pool against the memory budget: record the
    decode program once over a MINIMAL pool (``record_thunk()`` returns its
    ``analysis.Program``), take its planner peak less the minimal pool's own
    bytes (``pool_bytes_in_trace``) as the non-pool overhead, and give the
    pool ``(budget - overhead) // block_bytes`` blocks. Budget precedence:
    ``budget_mb`` > FLAGS_memory_budget_mb > the detected budget
    (``detected_budget_bytes``: the card's free memory and the program's
    resident inputs, less a headroom); with none,
    ``num_blocks`` is None. A failed recording plans an overhead of the
    minimal pool alone."""
    if budget_mb is None:
        flagged = float(_flags.flag("memory_budget_mb"))
        budget_mb = flagged if flagged > 0 else None
    peak, held = 0, 0
    try:
        program = record_thunk()
        ctx = Context(program, list(roles), source, donated=tuple(donated))
        peak = plan_memory(ctx, donated=tuple(donated)).peak_bytes
        held = sum(v.nbytes for v in program.values.values() if v.producer < 0)
    except Exception:  # noqa: BLE001
        peak = int(pool_bytes_in_trace)
    budget_bytes = (int(budget_mb * _MB) if budget_mb is not None
                    else detected_budget_bytes(held))
    overhead = max(0, int(peak) - int(pool_bytes_in_trace))
    num_blocks: Optional[int] = None
    if budget_bytes is not None:
        num_blocks = max(0, (budget_bytes - overhead) // int(block_bytes))
    return BlockPoolPlan(num_blocks=num_blocks, block_bytes=int(block_bytes),
                         budget_bytes=budget_bytes, overhead_bytes=overhead,
                         trace_peak_bytes=int(peak))
