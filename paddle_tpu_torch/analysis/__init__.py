"""The analysis IR and the pass framework: the port of the first half of
``paddle_tpu/analysis/__init__.py``.

The JAX package's IR is the inlined flat list of a traced jaxpr's
equations. A port program is not traced: its IR is the flat list of the
aten ops ONE run of the program issued, recorded below autograd by a
``TorchDispatchMode`` (``recording()``), plus one entry per hand-written
kernel launch, which the kernel wrappers add themselves
(``kernel_region``): a ``ctypes`` launch is invisible to a dispatch mode,
and on the CPU the kernels' plain versions would otherwise be counted op by
op. Each entry (``Op``) holds the op name, the value ids it reads and
writes, their shapes and dtypes, and its FLOP and byte estimates, computed
when it is recorded (matmuls and convolutions by
``torch.utils.flop_counter``'s formulas). Values are storages: a view or an
in-place write reads and writes the value it aliases; a fresh output is a
new value. The recording never runs a program again: the capture's own run
of a step, or a run that happens anyway, is recorded.

Passes are registered by name (``register_pass``) and give structured
``Diagnostic`` records. This slice ports the framework, ``check`` over an
``nn.Layer`` or a callable with input specs, and the ``memory_budget``
pass (``analysis.memory``); the other passes, ``check_pending_segment``,
``check_launch_budget``, the remat plan and the equivalence prover are
ROADMAP queue 1 item 12b, and ``FLAGS_check_programs`` accepts only 0.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import flags as _flags

__all__ = [
    "Context",
    "Diagnostic",
    "Op",
    "Program",
    "ProgramVerificationError",
    "Severity",
    "check",
    "enforce",
    "kernel_region",
    "pass_names",
    "recording",
    "register_pass",
    "run_passes",
]


class Severity(enum.IntEnum):
    """Diagnostic severity; ordered so ``>= Severity.ERROR`` comparisons work."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):  # "error", not "Severity.ERROR", in reports
        return self.name.lower()


@dataclasses.dataclass
class Diagnostic:
    """One structured finding from an analysis pass: the op path plus the
    shapes and dtypes involved, and a fix hint."""

    severity: Severity
    pass_name: str
    op: str  # op path, e.g. "op[12] mm" or "program"
    message: str
    hint: str = ""
    shapes: Tuple = ()
    dtypes: Tuple = ()
    source: str = ""
    data: Dict = dataclasses.field(default_factory=dict)

    def __str__(self):
        loc = f" [{self.source}]" if self.source else ""
        hint = f" (hint: {self.hint})" if self.hint else ""
        return (
            f"{self.severity}[{self.pass_name}]{loc} {self.op}: "
            f"{self.message}{hint}"
        )


class ProgramVerificationError(RuntimeError):
    """Raised by enforce() when FLAGS_check_programs>=2 and an error-severity
    diagnostic is present. Carries the full diagnostic list."""

    def __init__(self, message, diagnostics):
        super().__init__(message)
        self.diagnostics = list(diagnostics)


# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Value:
    """One storage the program reads or writes."""

    vid: int
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int          # the storage's bytes
    producer: int = -1   # op index; -1: an input of the program
    written: bool = False  # an input the program writes in place


class Op:
    """One recorded op: its name, the value ids it reads (``inputs``) and
    writes (``outputs``; a view's or an in-place op's output is the value
    it aliases), their shapes and dtypes, and its FLOP and byte
    estimates."""

    __slots__ = ("index", "name", "inputs", "outputs", "shapes", "dtypes",
                 "flops", "nbytes", "kernel")

    def __init__(self, index, name, inputs, outputs, shapes, dtypes, flops, nbytes,
                 kernel=False):
        self.index = index
        self.name = name
        self.inputs = inputs
        self.outputs = outputs
        self.shapes = shapes
        self.dtypes = dtypes
        self.flops = flops
        self.nbytes = nbytes
        self.kernel = kernel

    @property
    def path(self) -> str:
        return f"op[{self.index}] {self.name}"

    def __repr__(self):
        return f"<Op {self.path} flops={self.flops} in={self.inputs} out={self.outputs}>"


class Program:
    """A recorded program: its ops in issue order, its values, and which
    values were still held when the run ended (``escaping``: parameters,
    optimizer states, gradients and the outputs a caller keeps)."""

    def __init__(self, ops, values, escaping, source="", record_ms=0.0):
        self.ops: List[Op] = ops
        self.values: Dict[int, Value] = values
        self.escaping = frozenset(escaping)
        self.source = source
        self.record_ms = record_ms  # the recording's host cost

    @property
    def inputs(self) -> List[int]:
        return [v.vid for v in self.values.values() if v.producer < 0]

    def producers(self) -> Dict[int, int]:
        return {v.vid: v.producer for v in self.values.values() if v.producer >= 0}

    def consumers(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for op in self.ops:
            for vid in op.inputs:
                out.setdefault(vid, []).append(op.index)
        return out

    def flops(self, names=None) -> int:
        return sum(op.flops for op in self.ops if names is None or op.name in names)

    def __repr__(self):
        return (f"<Program {self.source} ops={len(self.ops)} values={len(self.values)} "
                f"flops={self.flops()}>")


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def _matmul_flops(name, args):
    """``torch.utils.flop_counter``'s formulas for the matrix products
    (2 m k n, times the batch), read off the shapes directly: its generic
    shape walk costs more than the rest of a recorded op."""
    if name == "mm":
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * k * n
    if name == "addmm":
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * k * n
    if name in ("bmm", "baddbmm"):
        a, b = args[-2], args[-1]
        bs, m, k = a.shape
        return 2 * bs * m * k * b.shape[2]
    return None


def _tensors(tree, out: list):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _real(t) -> bool:
    return not t.is_meta and type(t).__name__ != "FakeTensor"


class _Recording:
    """The state of one recording: the ops so far, the values by storage,
    and a weak reference to every tensor seen (a value still referenced
    when the run ends escapes it)."""

    def __init__(self, source):
        self.source = source
        self.ops: List[Op] = []
        self.values: Dict[int, Value] = {}
        self.by_key: Dict[Tuple, int] = {}    # (device index, data_ptr) -> vid
        self.refs: Dict[int, list] = {}       # vid -> weakrefs of its tensors
        self.lock = threading.Lock()
        self.t0 = time.perf_counter()

    def _hold(self, vid, t):
        try:
            self.refs.setdefault(vid, []).append(weakref.ref(t))
        except TypeError:
            pass

    def _value(self, t, producer):
        """The value id of ``t``'s storage: the one it aliases when
        ``producer`` is None (an op's input, or a view's or in-place
        output), else a new value that ``producer`` wrote."""
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if not ptr:
            return None
        key = (t.get_device(), ptr)
        vid = self.by_key.get(key) if producer is None else None
        if vid is None:  # a program input, or a fresh storage (an older one there is dead)
            vid = len(self.values)
            self.values[vid] = Value(vid, tuple(t.shape), str(t.dtype), st.nbytes(),
                                     -1 if producer is None else producer)
            self.by_key[key] = vid
        self._hold(vid, t)
        return vid

    def add(self, name, ins, outs, flops, kernel=False, view=False):
        with self.lock:
            index = len(self.ops)
            ins = [t for t in ins if _real(t)]
            outs = [t for t in outs if _real(t)]
            in_ids = [self._value(t, None) for t in ins]
            read = {(t.get_device(), t.untyped_storage().data_ptr()) for t in ins}
            out_ids = []
            for t in outs:
                aliased = (t.get_device(), t.untyped_storage().data_ptr()) in read
                vid = self._value(t, None if aliased else index)
                if aliased and not view:  # an in-place write to a program input
                    v = self.values[vid]
                    if v.producer < 0:
                        v.written = True
                out_ids.append(vid)
            both = ins + outs
            nbytes = 0 if view else sum(t.numel() * t.element_size() for t in both)
            self.ops.append(Op(
                index, name, tuple(v for v in in_ids if v is not None),
                tuple(v for v in out_ids if v is not None),
                tuple(t.shape for t in both), tuple(t.dtype for t in both),
                int(flops), int(nbytes), kernel))

    def finish(self) -> Program:
        escaping = [vid for vid, refs in self.refs.items()
                    if any(r() is not None for r in refs)]
        record_ms = (time.perf_counter() - self.t0) * 1e3
        return Program(self.ops, self.values, escaping, self.source, record_ms)


_active: List[_Recording] = []        # the recording in progress, if any
_kernel_tls = threading.local()       # inside a kernel wrapper: skip its ops


class _Recorder(TorchDispatchMode):
    def __init__(self, rec: _Recording):
        super().__init__()
        self.rec = rec

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch would wrap __torch_dispatch__ to keep its compiler out, and
        # the wrapper imports ``torch._dynamo`` (seconds) at the first op;
        # nothing here runs under the compiler
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_kernel_tls, "depth", 0):
            return out
        try:
            ins = _tensors(args, [])
            _tensors(kwargs, ins)
            outs = _tensors(out, [])
            if not all(_real(t) for t in ins + outs):
                return out
            packet = func._overloadpacket
            name = packet.__name__
            view = bool(getattr(func, "is_view", False))
            flops = _matmul_flops(name, args)
            if flops is None:
                fn = _flop_registry().get(packet)
                if fn is not None:
                    flops = fn(*args, **kwargs, out_val=out)
                else:
                    flops = 0 if view else sum(t.numel() for t in outs)
            self.rec.add(name, ins, outs, flops, view=view)
        except Exception:  # noqa: BLE001 — recording must never break the run
            pass
        return out


class recording:
    """Record the aten ops of the run inside the ``with`` block (and the
    kernel launches the wrappers note) into an ``analysis.Program``:
    ``with recording("captured") as r: ...; program = r.program``. One
    recording at a time; a nested one records nothing."""

    def __init__(self, source: str = ""):
        self.source = source
        self.program: Optional[Program] = None
        self._rec = None
        self._mode = None

    def __enter__(self):
        if _active:
            return self
        self._rec = _Recording(self.source)
        _active.append(self._rec)
        self._mode = _Recorder(self._rec)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rec is None:
            return False
        self._mode.__exit__(*exc)
        _active.remove(self._rec)
        self.program = self._rec.finish()
        self._rec = self._mode = None
        return False


class _KernelRegion:
    __slots__ = ()

    def __enter__(self):
        _kernel_tls.depth = getattr(_kernel_tls, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _kernel_tls.depth -= 1
        return False

    def note(self, name: str, inputs, outputs, flops: int):
        """One kernel launch: ``inputs`` and ``outputs`` are its tensors (an
        in-place kernel lists a buffer on both sides)."""
        if _active:
            _active[0].add(name, _tensors(inputs, []), _tensors(outputs, []), flops,
                           kernel=True)


class _NoRegion:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, name, inputs, outputs, flops):
        pass


_NO_REGION = _NoRegion()


def kernel_region():
    """A kernel wrapper's bracket: while a recording runs, the ops inside
    (its output allocations, or its plain version on the CPU) are not
    recorded, and ``region.note(...)`` adds the kernel as one op. Free when
    nothing records."""
    return _KernelRegion() if _active else _NO_REGION


def matmul_flops(program: Program) -> int:
    """The FLOPs of the program's matrix products (mm, addmm, bmm, baddbmm)."""
    return program.flops(("mm", "addmm", "bmm", "baddbmm"))


# ---------------------------------------------------------------------------
# Pass registry
# ---------------------------------------------------------------------------
_passes: "OrderedDict[str, Callable]" = OrderedDict()


def register_pass(name: str):
    """Decorator: register ``fn(ctx) -> List[Diagnostic]`` under ``name``."""

    def deco(fn):
        _passes[name] = fn
        return fn

    return deco


def pass_names() -> List[str]:
    return list(_passes)


class Context:
    """Everything a pass sees for one checked program."""

    def __init__(self, program: Optional[Program], roles=(), source="", counters=None,
                 budget=None, donated=None, memory_budget_mb=None):
        self.program = program
        self.ops = program.ops if program is not None else []
        # (kind, name) per program input, in Program.inputs order
        self.roles: List[Tuple[str, str]] = list(roles)
        self.source = source
        self.counters = counters
        self.budget = budget
        # input value ids counted as donated: by default those the program
        # writes in place (a captured step's parameters and states, which
        # its CUDA graph updates in place: what donation buys on the TPU)
        self.donated = (tuple(donated) if donated is not None else
                        tuple(v.vid for v in program.values.values() if v.written)
                        if program is not None else ())
        self.memory_budget_mb = memory_budget_mb


def run_passes(ctx: Context, passes: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    names = list(passes) if passes is not None else pass_names()
    diags: List[Diagnostic] = []
    for name in names:
        fn = _passes.get(name)
        if fn is None:
            raise ValueError(
                f"unknown analysis pass {name!r}; registered: {pass_names()}"
            )
        for d in fn(ctx):
            if not d.source:
                d.source = ctx.source
            diags.append(d)
    diags.sort(key=lambda d: (-int(d.severity), d.pass_name, d.op))
    return diags


# ---------------------------------------------------------------------------
# Front end: check over a Layer or a callable with input specs
# ---------------------------------------------------------------------------
def _norm_one_spec(spec, name=None):
    from ..core.dtype import to_np_dtype

    shape = getattr(spec, "shape", None)
    if shape is not None:
        dtype = getattr(spec, "dtype", "float32")
    else:
        shape, dtype = spec  # (shape, dtype) tuple
    shape = tuple(1 if d in (None, -1) else int(d) for d in shape)
    return (name or getattr(spec, "name", None), shape, to_np_dtype(dtype))


def _norm_specs(feed_specs) -> List[Tuple[Optional[str], Tuple, np.dtype]]:
    if feed_specs is None:
        return []
    if isinstance(feed_specs, dict):
        return [_norm_one_spec(s, name=n) for n, s in sorted(feed_specs.items())]
    if not isinstance(feed_specs, (list, tuple)):
        feed_specs = [feed_specs]
    return [_norm_one_spec(s) for s in feed_specs]


def _record_callable(fn, specs, device, source):
    """One forward run of ``fn`` on zero inputs of ``specs``, recorded (no
    grad: the JAX package traces the forward alone)."""
    feeds = [torch.zeros(s, dtype=torch.from_numpy(np.zeros((), d)).dtype, device=device)
             for _, s, d in specs]
    with torch.no_grad(), recording(source) as r:
        fn(*feeds)
    return r.program


def _program_of(target, feed_specs):
    from ..nn.layer_base import Layer

    if isinstance(target, Program):
        return target, target.source or "program"
    if type(target).__name__ in ("Program", "StaticFunction") or hasattr(target, "_static_fn"):
        raise NotImplementedError(
            "analysis.check of a static.Program or a to_static function is not ported yet "
            "(ROADMAP, open items, queue 1 item 14)")
    specs = _norm_specs(feed_specs)
    if isinstance(target, (Layer, torch.nn.Module)):
        if not specs:
            raise ValueError("checking a Layer requires feed_specs")
        p = next(iter(target.parameters()), None)
        device = p.device if p is not None else torch.device("cpu")
        return _record_callable(target, specs, device, type(target).__name__), \
            type(target).__name__
    if callable(target):
        if not specs:
            raise ValueError("checking a callable requires feed_specs")
        from ..core.place import torch_device

        name = getattr(target, "__name__", "fn")
        return _record_callable(target, specs, torch_device(), name), name
    raise TypeError(
        f"cannot analyze object of type {type(target).__name__}: expected a "
        "Layer, a callable or a recorded analysis.Program"
    )


def check(program_or_fn, feed_specs=None, *, passes: Optional[Sequence[str]] = None,
          counters: Optional[Dict[str, Any]] = None, budget: Optional[int] = None,
          source: Optional[str] = None, donated: Optional[Sequence[int]] = None,
          memory_budget_mb: Optional[float] = None) -> List[Diagnostic]:
    """Run the pass suite over a program: an ``nn.Layer`` or a callable run
    once on zero inputs of ``feed_specs`` (``InputSpec`` list, ``(shape,
    dtype)`` tuples or a ``{name: spec}`` dict) under a recording, or an
    already recorded ``analysis.Program``. Returns diagnostics sorted most
    severe first."""
    program, src = _program_of(program_or_fn, feed_specs)
    ctx = Context(program, (), source or src, counters=counters, budget=budget,
                  donated=donated, memory_budget_mb=memory_budget_mb)
    return run_passes(ctx, passes)


def enforce(diags: List[Diagnostic], where: str, level: Optional[int] = None):
    """Apply the FLAGS_check_programs policy to a diagnostic list.

    level 0 (or empty diags): no-op. level>=1: each diagnostic becomes a
    Python warning. level>=2: error-severity findings raise
    ``ProgramVerificationError`` (after warning the rest)."""
    if level is None:
        level = int(_flags.flag("check_programs"))
    if level <= 0 or not diags:
        return diags
    errors = [d for d in diags if d.severity >= Severity.ERROR]
    for d in diags:
        warnings.warn(f"[{where}] {d}", stacklevel=3)
    if level >= 2 and errors:
        err = ProgramVerificationError(
            f"{where}: program verification failed with "
            f"{len(errors)} error-severity diagnostic(s):\n"
            + "\n".join(f"  {d}" for d in errors),
            diags,
        )
        try:
            from ..profiler import trace as _trace

            _trace.dump_postmortem(
                "verification_failed", exc=err, where=where,
                diagnostics=[str(d) for d in errors],
            )
        except Exception:
            pass  # the verdict must surface even if the dump fails
        raise err
    return diags


from . import memory  # noqa: E402  (registers memory_budget)

__all__ += ["memory"]
