"""The analysis IR and the pass framework: the port of
``paddle_tpu/analysis/__init__.py``.

The JAX package's IR is the inlined flat list of a traced jaxpr's
equations. A port program is not traced: its IR is the flat list of the
aten ops ONE run of the program issued, recorded below autograd by a
``TorchDispatchMode`` (``recording()``), plus one entry per hand-written
kernel launch, which the kernel wrappers add themselves
(``kernel_region``): a ``ctypes`` launch is invisible to a dispatch mode,
and on the CPU the kernels' plain versions would otherwise be counted op by
op. Each entry (``Op``) holds the op name and overload, the value ids it
reads and writes, their shapes, dtypes and (for the inputs) strides and
offsets, the tensors it read and wrote, its non-tensor arguments (scalars,
dims, dtypes; ``"$i"`` stands for its i-th tensor), the generator state a
random op drew from, the layer call that issued it (``scope``, an index
into ``Program.calls``), and its FLOP and byte estimates (matmuls and
convolutions by ``torch.utils.flop_counter``'s formulas). Values are
storages: a view or an in-place write reads and writes the value it
aliases; a fresh output is a new value. The recording never runs a program
again: the capture's own run of a step, or a run that happens anyway, is
recorded. ``mark(name)`` notes where a phase starts (``"backward"``,
``"update"``); ``Program.n_forward`` is the op count before the backward.

Passes are registered by name (``register_pass``) and give structured
``Diagnostic`` records: ``dtype_check``, ``dead_code``, ``redundant_ops``,
``numeric_hazards``, ``launch_budget``, ``determinism`` (``passes``),
``memory_budget``, ``donation_safety`` (``memory``) and ``equivalence``.
``check`` runs them over an ``nn.Layer`` or a callable with input specs,
``check_pending_segment`` over this thread's pending lazy segment (run under
``FakeTensorMode``, so nothing runs on the device and nothing is flushed),
``check_launch_budget`` over ``profiler.measure_programs``' counters, and
``enforce`` applies FLAGS_check_programs (1 warn, 2 raise).
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
    "Call",
    "Context",
    "Diagnostic",
    "Op",
    "Program",
    "ProgramVerificationError",
    "Severity",
    "check",
    "check_launch_budget",
    "check_pending_segment",
    "enforce",
    "kernel_region",
    "mark",
    "pass_names",
    "record",
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
    """One recorded op: its name and overload, the value ids it reads
    (``inputs``) and writes (``outputs``; a view's or an in-place op's output
    is the value it aliases), their shapes and dtypes, the strides and
    offsets it read and wrote them at (``geoms``), the tensors it read and wrote
    (``tin``/``tout``: tensor ids), its arguments (``args``: the positional
    ones and the keyword pairs, a tensor as ``"$i"``, its index in ``tin``), the
    generator state a random op drew from (``rng``), the layer call that
    issued it (``scope``, -1 for none), and its FLOP and byte estimates."""

    __slots__ = ("index", "name", "inputs", "outputs", "shapes", "dtypes",
                 "flops", "nbytes", "kernel", "overload", "args", "geoms", "tin",
                 "tout", "scope", "rng", "view")

    def __init__(self, index, name, inputs, outputs, shapes, dtypes, flops, nbytes,
                 kernel=False, overload="", args=(), geoms=(), tin=(), tout=(), scope=-1,
                 rng=None, view=False):
        self.index = index
        self.name = name
        self.inputs = inputs
        self.outputs = outputs
        self.shapes = shapes
        self.dtypes = dtypes
        self.flops = flops
        self.nbytes = nbytes
        self.kernel = kernel
        self.overload = overload
        self.args = args
        self.geoms = geoms
        self.tin = tin
        self.tout = tout
        self.scope = scope
        self.rng = rng
        self.view = view

    @property
    def path(self) -> str:
        return f"op[{self.index}] {self.name}"

    @property
    def in_shapes(self):
        return self.shapes[:len(self.tin)]

    @property
    def out_shapes(self):
        return self.shapes[len(self.tin):]

    @property
    def in_dtypes(self):
        return self.dtypes[:len(self.tin)]

    @property
    def out_dtypes(self):
        return self.dtypes[len(self.tin):]

    @property
    def pos(self) -> tuple:
        """The positional arguments (a tensor as ``"$i"``)."""
        return self.args[0] if self.args else ()

    def kw(self, name, default=None):
        """A keyword argument."""
        for k, v in (self.args[1] if self.args else ()):
            if k == name:
                return v
        return default

    def arg(self, i, name=None, default=None):
        """Argument ``i`` by position, else by keyword ``name``."""
        pos = self.pos
        if i < len(pos):
            return pos[i]
        return self.kw(name, default) if name is not None else default

    def __repr__(self):
        return f"<Op {self.path} flops={self.flops} in={self.inputs} out={self.outputs}>"


@dataclasses.dataclass
class Call:
    """One layer call of a recorded run: its module's dotted path from the
    outermost call, the op range it issued (``start`` to ``end``, its
    sublayers' ops included), its parent call and which call of that module
    it was (``occurrence``)."""

    index: int
    path: str
    type_name: str
    parent: int
    start: int
    end: int = -1
    occurrence: int = 0
    module: Any = None  # a weak reference to the module


class Program:
    """A recorded program: its ops in issue order, its values, and which
    values were still held when the run ended (``escaping``: parameters,
    optimizer states, gradients and the outputs a caller keeps)."""

    def __init__(self, ops, values, escaping, source="", record_ms=0.0, keys=None,
                 calls=(), marks=None, roles=None, unused=()):
        self.ops: List[Op] = ops
        self.values: Dict[int, Value] = values
        self.escaping = frozenset(escaping)
        self.source = source
        self.record_ms = record_ms  # the recording's host cost
        self.keys: Dict[Any, int] = dict(keys or {})  # storage key -> value id
        self.calls: List[Call] = list(calls)
        self.marks: Dict[str, int] = dict(marks or {})
        # (kind, name) per value id of a parameter, buffer or feed, and the
        # (kind, name, shape) of those the run never read
        self.roles: Dict[int, Tuple[str, str]] = dict(roles or {})
        self.unused: List[Tuple[str, str, Tuple]] = list(unused)
        self.outputs: List[int] = []  # value ids a checked callable returned

    @property
    def inputs(self) -> List[int]:
        return [v.vid for v in self.values.values() if v.producer < 0]

    @property
    def n_forward(self) -> int:
        """Ops issued before the backward started (the whole program when no
        backward was marked)."""
        return self.marks.get("backward", len(self.ops))

    @property
    def n_forward_ops(self) -> int:
        """The forward's ops that are not views: what a remat plan indexes
        (a recompute segment's forward issues the same ops, without the
        views autograd makes to save tensors)."""
        return sum(1 for op in self.ops[:self.n_forward] if not op.view)

    def value_of(self, t) -> Optional[int]:
        """The value id of tensor ``t``'s storage in this program, or None."""
        try:
            return self.keys.get(_storage_key(t))
        except Exception:
            return None

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


def _fake_type(t) -> bool:
    return type(t).__name__ == "FakeTensor"


def _real(t) -> bool:
    return not t.is_meta and not _fake_type(t)


# torch's own getters: a port Parameter overrides ``shape`` in Python
_shape = torch._C.TensorBase.shape.__get__
_dtype = torch._C.TensorBase.dtype.__get__


def _storage_of(t):
    """``t``'s storage, or None for a tensor without one (sparse, empty)."""
    try:
        st = t.untyped_storage()
    except Exception:  # noqa: BLE001 — a sparse or other storage-less tensor
        return None
    return st if st.nbytes() else None


def _storage_key(t):
    """A storage's identity: its StorageImpl (a fake tensor's storage has no
    data pointer; a resized one keeps its identity)."""
    return t.untyped_storage()._cdata


# random ops: their canonical form includes the generator state they drew from
_RANDOM_OPS = frozenset({
    "bernoulli", "bernoulli_", "rand", "rand_like", "randn", "randn_like", "randint",
    "randint_like", "randperm", "normal", "normal_", "uniform_", "exponential_",
    "geometric_", "log_normal_", "cauchy_", "multinomial", "native_dropout", "random_",
})


def _rng_fingerprint(kwargs, device) -> Optional[Tuple]:
    """The state a random op draws from: its generator (the device's default
    one when none is passed) as (seed, offset) on CUDA, a digest of the
    state on the CPU."""
    try:
        gen = kwargs.get("generator")
        if gen is None:
            gen = (torch.cuda.default_generators[device.index or 0] if device.type == "cuda"
                   else torch.default_generator)
        if gen.device.type == "cuda":
            return ("cuda", gen.initial_seed(), gen.get_offset())
        return ("cpu", hash(bytes(gen.get_state().numpy().tobytes())))
    except Exception:
        return None


def _static(x, tensor_index):
    """The recordable form of one non-tensor argument (tensors become
    ``"$i"``, their position among the op's tensors)."""
    if isinstance(x, torch.Tensor):
        return f"${tensor_index[id(x)]}" if id(x) in tensor_index else "$?"
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return tuple(_static(v, tensor_index) for v in x)
    if isinstance(x, (torch.dtype, torch.device, torch.layout, torch.memory_format)):
        return str(x)
    if isinstance(x, torch.Generator):
        return "<generator>"
    return repr(x)


class _Recording:
    """The state of one recording: the ops so far, the values by storage,
    a weak reference to every tensor seen (a value still referenced when
    the run ends escapes it), the layer calls and the marks."""

    def __init__(self, source):
        self.source = source
        self.ops: List[Op] = []
        self.values: Dict[int, Value] = {}
        self.by_key: Dict[Any, int] = {}    # storage key -> vid
        self.refs: Dict[int, list] = {}     # vid -> weakrefs of its tensors
        self.calls: List[Call] = []
        self.stack: List[int] = []          # the open layer calls
        self.seen: Dict[Tuple[int, int], int] = {}  # (parent, id(module)) -> calls
        self.names: Dict[int, Dict[int, str]] = {}  # root call -> its modules' paths
        self.marks: Dict[str, int] = {}
        self.owner = None  # the thread that opened the recording
        self.fake = False  # records ops on fake tensors (a run under FakeTensorMode)
        self.lock = threading.Lock()
        self.t0 = time.perf_counter()

    def _hold(self, vid, t):
        try:
            self.refs.setdefault(vid, []).append(weakref.ref(t))
        except TypeError:
            pass

    def _value(self, t, st, producer):
        """The value id of storage ``st`` (``t``'s): the one it aliases when
        ``producer`` is None (an op's input, or a view's or in-place
        output), else a new value that ``producer`` wrote."""
        key = st._cdata
        vid = self.by_key.get(key) if producer is None else None
        if vid is None:  # a program input, or a fresh storage (an older one there is dead)
            vid = len(self.values)
            self.values[vid] = Value(vid, tuple(_shape(t)), str(t.dtype), st.nbytes(),
                                     -1 if producer is None else producer)
            self.by_key[key] = vid
        self._hold(vid, t)
        return vid

    def add(self, name, ins, outs, flops, kernel=False, view=False, overload="", args=(),
            rng=None):
        # each tensor's storage once: a tensor without one (sparse, empty) is left out
        ins = [(t, st) for t in ins if not t.is_meta
               for st in (_storage_of(t),) if st is not None]
        outs = [(t, st) for t in outs if not t.is_meta
                for st in (_storage_of(t),) if st is not None]
        with self.lock:
            index = len(self.ops)
            in_ids = [self._value(t, st, None) for t, st in ins]
            read = {st._cdata for _t, st in ins}
            out_ids = []
            for t, st in outs:
                aliased = st._cdata in read
                vid = self._value(t, st, None if aliased else index)
                if aliased and not view:  # an in-place write
                    v = self.values[vid]
                    if v.producer < 0:
                        v.written = True
                out_ids.append(vid)
            both = [t for t, _st in ins] + [t for t, _st in outs]
            self.ops.append(Op(
                index, name, tuple(in_ids), tuple(out_ids),
                tuple(_shape(t) for t in both), tuple(_dtype(t) for t in both),
                int(flops), 0 if view else sum(t.nbytes for t in both), kernel, overload,
                args, tuple((t.stride(), t.storage_offset()) for t in both),
                tuple(t._cdata for t, _st in ins), tuple(t._cdata for t, _st in outs),
                self.stack[-1] if self.stack else -1, rng, view))

    def enter_call(self, module):
        with self.lock:
            parent = self.stack[-1] if self.stack else -1
            root = parent
            while root >= 0 and self.calls[root].parent >= 0:
                root = self.calls[root].parent
            name = type(module).__name__
            if root >= 0:
                names = self.names.get(root)
                if names is None:
                    rm = self.calls[root].module()
                    names = self.names[root] = {
                        id(m): n for n, m in (rm.named_modules() if rm is not None else ())}
                rel = names.get(id(module))
                if rel:
                    name = f"{self.calls[root].path}.{rel}"
            occ_key = (root, id(module))
            occ = self.seen.get(occ_key, 0)
            self.seen[occ_key] = occ + 1
            call = Call(len(self.calls), name, type(module).__name__, parent, len(self.ops),
                        occurrence=occ, module=weakref.ref(module))
            self.calls.append(call)
            self.stack.append(call.index)

    def exit_call(self):
        with self.lock:
            if self.stack:
                self.calls[self.stack.pop()].end = len(self.ops)

    def finish(self) -> Program:
        escaping = [vid for vid, refs in self.refs.items()
                    if any(r() is not None for r in refs)]
        record_ms = (time.perf_counter() - self.t0) * 1e3
        for c in self.calls:
            if c.end < 0:
                c.end = len(self.ops)
        return Program(self.ops, self.values, escaping, self.source, record_ms,
                       self.by_key, self.calls, self.marks)


_active: List[_Recording] = []        # the recordings in progress, on any thread
_modes: Dict[int, "_Recorder"] = {}   # thread id -> the mode feeding its recordings
_kernel_tls = threading.local()       # inside a kernel wrapper: skip its ops
_hooks: list = []                     # the layer-call hooks while anything records


def _targets() -> List[_Recording]:
    """The recordings an op, a kernel note or a layer call on this thread
    goes to: this thread's own, else (autograd's device thread running a
    recorded backward) every recording in progress."""
    me = threading.get_ident()
    own = [r for r in _active if r.owner == me]
    return own or list(_active)


class _Recorder(TorchDispatchMode):
    def __init__(self, recs: List[_Recording]):
        super().__init__()
        self.recs = recs  # this thread's recordings (autograd's threads inherit the mode)

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch would wrap __torch_dispatch__ to keep its compiler out, and
        # the wrapper imports ``torch._dynamo`` (seconds) at the first op;
        # nothing here runs under the compiler
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        name = packet.__name__
        rng = None
        if name in _RANDOM_OPS:
            first = next(iter(_tensors(args, [])), None)
            device = first.device if first is not None else kwargs.get("device")
            rng = _rng_fingerprint(kwargs, torch.device(device or "cpu"))
        out = func(*args, **kwargs)
        if getattr(_kernel_tls, "depth", 0):
            return out
        try:
            ins = _tensors(args, [])
            _tensors(kwargs, ins)
            outs = _tensors(out, [])
            if any(t.is_meta for t in ins + outs):
                return out
            ins = [t for t in ins if _storage_of(t) is not None]
            outs = [t for t in outs if _storage_of(t) is not None]
            fake = any(_fake_type(t) for t in ins + outs)
            recs = [r for r in self.recs if r.fake or not fake]
            if not recs:
                return out
            view = bool(getattr(func, "is_view", False))
            flops = _matmul_flops(name, args)
            if flops is None:
                fn = _flop_registry().get(packet)
                if fn is not None:
                    flops = fn(*args, **kwargs, out_val=out)
                else:
                    flops = 0 if view else sum(t.numel() for t in outs)
            index = {}
            for i, t in enumerate(ins):
                index.setdefault(id(t), i)
            kw = tuple((k, _static(v, index)) for k, v in sorted(kwargs.items())
                       if k != "generator")
            if name in ("lift_fresh", "lift_fresh_copy") and ins and ins[0].numel() == 1 \
                    and ins[0].device.type == "cpu" and _real(ins[0]):
                kw += (("value", ins[0].item()),)  # a literal lifted into the program
            static = (tuple(_static(a, index) for a in args), kw)
            for rec in recs:
                rec.add(name, ins, outs, flops, view=view, overload=func._overloadname,
                        args=static, rng=rng)
        except Exception:  # noqa: BLE001 — recording must never break the run
            pass
        return out


def _pre_hook(module, args):
    for rec in _targets():
        rec.enter_call(module)


def _post_hook(module, args, out):
    for rec in _targets():
        rec.exit_call()


def _arm_hooks():
    if not _hooks:
        from torch.nn.modules import module as _module

        _hooks.append(_module.register_module_forward_pre_hook(_pre_hook))
        _hooks.append(_module.register_module_forward_hook(_post_hook, always_call=True))


def _disarm_hooks():
    while _hooks:
        _hooks.pop().remove()


class recording:
    """Record the aten ops of the run inside the ``with`` block (and the
    kernel launches the wrappers note, and the layer calls) into an
    ``analysis.Program``: ``with recording("captured") as r: ...; program =
    r.program``. Recordings nest: each one records every op of its block.
    Ops on fake tensors (output-spec inference) are left out unless
    ``fake=True``."""

    def __init__(self, source: str = "", fake: bool = False):
        self.source = source
        self.fake = fake  # a run under FakeTensorMode: record its fake tensors
        self.program: Optional[Program] = None
        self._rec = None

    def __enter__(self):
        rec = self._rec = _Recording(self.source)
        rec.fake = self.fake
        rec.owner = threading.get_ident()
        _active.append(rec)
        _arm_hooks()
        mode = _modes.get(rec.owner)
        if mode is None:
            mode = _modes[rec.owner] = _Recorder([rec])
            mode.__enter__()
        else:
            mode.recs.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        mode = _modes.get(rec.owner)
        if mode is not None:
            mode.recs.remove(rec)
            if not mode.recs:
                del _modes[rec.owner]
                mode.__exit__(*exc)
        _active.remove(rec)
        if not _active:
            _disarm_hooks()
        self.program = rec.finish()
        self._rec = None
        return False


def mark(name: str):
    """Note that phase ``name`` of the program starts here (``"backward"``,
    ``"update"``) in every recording in progress (the first mark of a name
    wins). Free when nothing records."""
    if _active:
        for rec in _targets():
            rec.marks.setdefault(name, len(rec.ops))


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
        ins, outs = _tensors(inputs, []), _tensors(outputs, [])
        for rec in _targets():
            rec.add(name, ins, outs, flops, kernel=True)


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
                 budget=None, donated=None, memory_budget_mb=None, alias_groups=None,
                 alias_refs=None, reference=None):
        self.program = program
        self.ops = program.ops if program is not None else []
        # (kind, name) per program input, in Program.inputs order (the
        # program's own roles, from its recording, come first)
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
        # donation safety: value-id groups bound to one runtime buffer, and
        # {value id: [description of a live external alias]}
        self.alias_groups = [tuple(g) for g in (alias_groups or ())]
        self.alias_refs: Dict[int, List] = dict(alias_refs or {})
        self.reference = reference  # the equivalence pass's reference program

    def role_of(self, vid: int) -> Tuple[str, str]:
        """(kind, name) of value ``vid``: a parameter, buffer or feed of a
        checked layer or callable, else an input by position, else an op's
        output."""
        if self.program is not None and vid in self.program.roles:
            return self.program.roles[vid]
        if self.program is not None:
            inputs = self.program.inputs
            if vid in inputs:
                i = inputs.index(vid)
                return self.roles[i] if i < len(self.roles) else ("arg", str(i))
        return ("value", str(vid))


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


def _record_callable(fn, specs, device, source, layer=None):
    """One forward run of ``fn`` on zero inputs of ``specs``, recorded (no
    grad: the JAX package traces the forward alone). The program's roles
    name the layer's parameters and buffers and the feeds; those the run
    never read are its ``unused``."""
    from ..core import dispatch, lazy

    feeds = [torch.zeros(s, dtype=torch.from_numpy(np.zeros((), d)).dtype, device=device)
             for _, s, d in specs]
    with torch.no_grad(), recording(source) as r:
        out = fn(*[dispatch.wrap(t) for t in feeds])  # held: the outputs escape
        lazy.flush_if_pending("analysis")
        out = dispatch.unwrap(out)
    program = r.program
    program.outputs = [v for v in (program.value_of(t) for t in _tensors(out, []))
                       if v is not None]
    named = []
    if layer is not None:
        named += [("param", n, p) for n, p in layer.named_parameters()]
        named += [("buffer", n, b) for n, b in layer.named_buffers()]
    named += [("feed", n or f"arg{i}", t) for i, ((n, _, _), t) in enumerate(zip(specs, feeds))]
    for kind, name, t in named:
        vid = program.value_of(t)
        if vid is not None and program.values[vid].producer < 0:
            program.roles.setdefault(vid, (kind, name))
        elif vid is None:
            program.unused.append((kind, name, tuple(t.shape)))
    del out
    return program


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
        name = type(target).__name__
        return _record_callable(target, specs, device, name, layer=target), name
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


def record(target, feed_specs=None) -> Program:
    """The recorded ``analysis.Program`` that ``check`` would run its passes
    over: a layer's forward or a callable, run once on zero inputs of
    ``feed_specs`` (its ``roles`` name the parameters, buffers and feeds)."""
    return _program_of(target, feed_specs)[0]


def check(program_or_fn, feed_specs=None, *, passes: Optional[Sequence[str]] = None,
          counters: Optional[Dict[str, Any]] = None, budget: Optional[int] = None,
          source: Optional[str] = None, donated: Optional[Sequence[int]] = None,
          alias_groups=None, alias_refs=None,
          memory_budget_mb: Optional[float] = None) -> List[Diagnostic]:
    """Run the pass suite over a program: an ``nn.Layer`` (its forward under
    ``no_grad``) or a callable run once on zero inputs of ``feed_specs``
    (``InputSpec`` list, ``(shape, dtype)`` tuples or a ``{name: spec}``
    dict) under a recording, or an already recorded ``analysis.Program``.
    ``donated``, ``alias_groups`` and ``alias_refs`` (value ids) feed the
    donation passes (nothing counts as donated unless named, as in the JAX
    package). Returns diagnostics sorted most severe first."""
    program, src = _program_of(program_or_fn, feed_specs)
    ctx = Context(program, (), source or src, counters=counters, budget=budget,
                  donated=() if donated is None else donated,
                  memory_budget_mb=memory_budget_mb,
                  alias_groups=alias_groups, alias_refs=alias_refs)
    return run_passes(ctx, passes)


def check_pending_segment(passes=None) -> List[Diagnostic]:
    """Analyze this thread's pending lazy-dispatch segment WITHOUT flushing
    it: its calls run once more under ``FakeTensorMode`` inside a recording
    (nothing runs on the device, nothing is written). Returns [] when
    nothing is pending."""
    from ..core import lazy

    program = lazy.pending_segment_program()
    if program is None:
        return []
    return run_passes(Context(program, (), "lazy-segment"), passes)


def check_launch_budget(step_fn=None, *args, budget=None, counters=None,
                        warmup=2, **kwargs) -> List[Diagnostic]:
    """Audit steady-state device-program launches per step against a
    budget, over the dispatch counters: runs ``step_fn`` ``warmup`` times,
    then measures one step (``profiler.measure_programs``), or reads a
    ``counters`` dict captured around a step. ``budget=None`` picks 1 per
    captured replay when whole-step capture replayed the step, else 3 (the
    lazy steady state: one segment, one backward, one update)."""
    if counters is None:
        if step_fn is None:
            raise ValueError("check_launch_budget needs a step_fn or counters")
        from ..profiler import measure_programs

        counters = measure_programs(step_fn, *args, warmup=warmup, **kwargs)
    ctx = Context(None, [], "launch-budget", counters=dict(counters), budget=budget)
    return run_passes(ctx, ["launch_budget"])


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


from . import passes as _builtin_passes  # noqa: E402,F401  (registers the lint suite)
from . import memory  # noqa: E402  (registers memory_budget / donation_safety)
from . import plan  # noqa: E402  (the remat plan over the liveness estimates)
from . import equivalence  # noqa: E402  (registers the equivalence pass)

__all__ += ["memory", "plan", "equivalence"]
