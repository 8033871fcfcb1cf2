"""The static memory planner's estimate: the port of the liveness half of
``paddle_tpu/analysis/memory.py``.

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
Donation safety, the use-after-donate scans, ``BlockPoolPlan`` and
``plan_block_pool`` are ROADMAP queue 1 item 12b.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import flags as _flags
from . import Context, Diagnostic, Program, Severity, register_pass

__all__ = ["Buffer", "MemoryPlan", "captured_step_plans", "device_hbm_bytes",
           "plan_memory"]

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
            kind, name = role_of.get(v.vid, ("arg", str(v.vid)))
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
