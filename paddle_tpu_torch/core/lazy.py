"""Deferred (lazy) eager dispatch, whole-step capture, and the serving
engine's decode-mode capture: the port of ``paddle_tpu/core/lazy.py``.

**Lazy segments** (FLAGS_eager_lazy_dispatch). A Paddle-level call that
takes Tensors does not run: it is appended to this thread's pending
*segment* and returns Tensors over ``LazyRef``s, whose shape, dtype,
device and ``requires_grad`` come from running the call once under
``FakeTensorMode`` (cached by call and input specs, ``_infer_out_specs``).
What is recorded is the OUTERMOST Paddle-level call: an ``nn.Layer`` call
with Tensor arguments (the whole model, then the criterion), an
``nn.functional`` call through ``dispatch.accepts_tensors``, or a
``dispatch.apply`` (the ``paddle.*`` functions and Tensor methods); what
runs inside it is torch's. A host read (``numpy``, ``item``, ``float``,
``bool``), ``backward()``, ``paddle.device.synchronize()``, an op that
cannot be deferred (its output shape depends on data, an argument is not
hashable, AMP is on) or FLAGS_eager_segment_max_ops flushes the whole
segment as ONE program. The segment is cached by its *signature* (the
calls, their static arguments and bindings, the specs of its external
inputs; a layer call's key holds the state of the layer and of each of its
sublayers, ``layer_key``). Its first occurrence runs the op plan eagerly with autograd
recording (the bridge). On the card a later occurrence runs as a CUDA
graph of the forward and, through an ``autograd.Function``, a CUDA graph
of its autograd sweep (``torch.cuda.make_graphed_callables``'s pattern,
with the layers' parameters among the inputs), so an eager LeNet step is
3 programs: 1 segment, 1 backward, 1 optimizer update. On the CPU a
segment program runs its plan eagerly.

**Whole-step capture** (FLAGS_eager_step_capture, read only under lazy
dispatch). An observer folds each step's events ([segment flush,
backward] repeated k times before one ``optimizer.step()``) into a step
signature: the segment signature, the backward's root and leaves, the
optimizer fingerprint (rule, hypers, per-parameter hypers, the clip's
``clip_fingerprint``, the fused-update flag, the updated parameters) and
k. After FLAGS_eager_capture_warmup identical steps it arms: the next
``backward()`` is DEFERRED (the forward has not run yet) and
``optimizer.step()`` runs forward, backward, clip and update as ONE
program: one CUDA graph on the card over static input buffers, with the
parameters, optimizer state and grads written in place and the learning
rate read from a device scalar; on the CPU the same function eagerly. k-1
accumulate-only microsteps of a k-step cycle each run forward + backward
as one captured program at their ``backward()``. Anything the captured
program cannot reproduce resolves the step on the 3-program path with the
same numerics and counts the reason in ``capture_fallback_reasons``: a
signature change, hooks, a read of the loss or a grad before ``step()``
(``sync``), a grad written or cleared there (``grad_replaced``), an
auxiliary differentiable output, a custom clip (never armed), a changed
optimizer, a build error (``capture_error``), the flag turned off
(``capture_disabled``). ``retain_graph``, ``create_graph``, several roots
and a seeded backward are never deferred; a second backward resolves the
deferred one first.

**Builds.** A program is built where it is first needed, on the calling
thread, and every CUDA graph is captured through ``core/cuda_graphs.py``.
FLAGS_eager_async_compile is accepted and has no effect: in the JAX
package it moves an XLA compile off the hot path, and here a build is a
tuple of plan ops (ROADMAP, deliberate differences), so the ``async_*``
counters stay 0.

Counters: ``profiler.dispatch_counters()`` (``programs`` by category,
``flush_reasons``, the segment and capture caches, ``capture_*``, the
host-time split). Every program registers with the attribution cost
registry (``profiler.attribution``: ``segment:<sig>``, ``captured:<sig>``,
``accum:<sig>``, ``serve:<kind>:<uid>:...``) with its IR (``analysis``),
recorded during a run that happens anyway (a segment's first run, the
capture's own run of a step, a serving program's capture), and feeds its
measured runs there: a segment on the host clock (the ``replay_time_ms``
bracket), a captured program on the card by a CUDA event pair per entry,
read at the entry's next run without a synchronisation (on the CPU the
host clock). Under FLAGS_telemetry the captured step's update computes the
fused telemetry inside the graph and hands it to the lagged reader after
every replay.

**Static analysis and the memory plan.** A segment's first run is checked
under FLAGS_check_programs (``analysis.check`` of its recording, then
``enforce``); ``pending_segment_program`` records the pending segment under
``FakeTensorMode`` without flushing it. While the capture wants a reference
(FLAGS_check_programs=2, or FLAGS_memory_plan='auto' with a budget), each
step observed on the 3-program path is recorded whole, its segments run
eagerly (``step_end``, at ``Optimizer.step()``'s end). At a capture build
the last such recording is the reference: FLAGS_memory_plan='auto' plans
the capture's remat over it (``analysis.plan``; the plan keys the cache and
binds around the capture's forward), and under FLAGS_check_programs=2 the
capture's own recording is certified equivalent to it before the first
replay (on the CPU, after the first run: the step stands, a failed proof
drops the program). A divergent proof resolves the step on the 3-program
path and raises ``ProgramVerificationError`` at the end of ``step()``
(``verification_failed``); an unprovable one falls back
(``equivalence_unprovable``). Under FLAGS_check_programs >= 1 each replay
first passes the donation gate. ``captured_step_program``,
``captured_step_certificate`` and ``captured_step_handle`` expose the last
replayed capture. Left to item 13: mesh-aware and sharded capture.

**Decode-mode capture** (``serve_program``, ``reset_serve_programs``,
``serve_capture_state``). A serving engine knows its step boundaries
exactly, so each prefill and decode step is a pure step function keyed by
its bucket signature, captured ONCE and replayed from an LRU cache bounded
by FLAGS_serving_capture_cache_size. On the card a program is one
CUDA graph (``core/cuda_graphs.py``) over the KV pool tensors and static
input buffers; the JAX package's is one donated XLA program. The engine runs
each step through two rungs of a program and an eager floor:

  captured  ``run(args, donate=True)``: the graph, which writes the pool
            tensors it was captured over in place (the analogue of
            donation); on a CPU tensor the function runs eagerly, in place;
  retained  ``run(args, donate=False)``: the function on copies of the pool
            tensors, copied back on success, so a failure leaves the pool
            intact (the JAX rung with the inputs retained);
  eager     the engine calls the function itself.

A step function takes ``(k_pools, v_pools, *feeds)``: two tuples of pool
tensors, then int64 feed tensors on the host (block tables, lengths,
token ids), and returns ``(k_pools, v_pools, row, nxt)``. The feeds are
packed into one pinned host buffer and reach the device in one copy; the
graph reads them from its static device buffer, whose values the host
replaces before each replay. ``row`` and ``nxt`` of a graph are its static
outputs: the next replay overwrites them, so the caller reads them first.
The first call of a key counts one ``serve_capture_builds``, each later
call one ``serve_capture_replays``. Under FLAGS_check_programs=2 each
program's rungs are certified equivalent once (``_certify_rungs``): on the
card the capture's recording against the warm-up run's, before the first
replay; on the CPU the first two runs' recordings.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
import types
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import cuda_graphs
from . import flags

__all__ = [
    "LazyRef", "captured_step_certificate", "captured_step_donation_verdicts", "captured_step_ir",
    "drain_async",
    "captured_step_handle", "captured_step_program", "captured_step_shard_info",
    "flush_if_pending", "pending_op_count", "reset_lazy_state",
    "reset_serve_programs", "serve_capture_state", "serve_program", "stage_feeds",
    "step_capture_state", "step_signature_id",
]

_tls = threading.local()
# the _DeferredStep waiting for optimizer.step(), if any: Tensor.grad and
# Parameter.grad read it on every access, so it is a plain list, not a
# thread-local
deferred_step: List[Optional["_DeferredStep"]] = [None]
# returned by record() when the call must run at once (the per-op path)
FALLBACK = object()
# set once a backward with create_graph ran: a graphed segment's backward is
# a replay, not differentiable again, so segments stop using graphs
_higher_order = [False]

_EXT, _RES = 0, 1
_STATIC_TYPES = (bool, int, float, complex, str, bytes, type(None), torch.dtype,
                 torch.device, slice, type(Ellipsis), torch.memory_format, torch.layout)


def _counters():
    from .. import profiler

    return profiler._counters


def _add_time(key: str, t0: float):
    _counters()[key] += (time.perf_counter() - t0) * 1e3


def _emit(kind, site="", **attrs):
    """A flight-recorder event (``profiler.trace``), at the JAX package's
    sites: segment flushes, capture builds, replays and fallbacks, serving
    program builds."""
    from ..profiler import trace

    trace.emit(kind, site=site, **attrs)


def _sig_id(sig) -> str:
    try:
        return f"{hash(sig) & 0xFFFF:04x}"
    except TypeError:
        return "anon"


def _note_program(key: str, category: str, dt_ms: float):
    """One measured run of ``key`` into the attribution cost registry."""
    try:
        from ..profiler import attribution as _attribution

        _attribution.note_run(key, category, dt_ms)
    except Exception:
        pass  # attribution must never break the program


def _register_program(key: str, category: str, **kw):
    try:
        from ..profiler import attribution as _attribution

        _attribution.register(key, category, **kw)
    except Exception:
        pass


def _recording(source: str):
    from .. import analysis

    return analysis.recording(source)


def _count_reason(family: str, reason: str):
    fam = _counters()[family]
    fam[reason] = fam.get(reason, 0) + 1


def _dispatch():
    from . import dispatch

    return dispatch


# ---------------------------------------------------------------------------
# pending values
# ---------------------------------------------------------------------------
class LazyRef:
    """The pending value of one output of one deferred op. Its spec (shape,
    dtype, device, requires_grad) answers without a flush; ``materialize``
    flushes the owning segment. After the flush ``_concrete`` holds the
    torch tensor."""

    __slots__ = ("_segment", "_op_index", "_out_index", "shape", "dtype", "device",
                 "requires_grad", "_concrete", "cell", "__weakref__")

    def __init__(self, segment, op_index, out_index, spec):
        self._segment = segment
        self._op_index = op_index
        self._out_index = out_index
        self.shape, self.dtype, self.device, self.requires_grad = spec
        self._concrete = None
        self.cell = None  # weakref to the Tensor cell that holds it

    def dim(self):
        return len(self.shape)

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    def is_floating_point(self):
        return self.dtype.is_floating_point

    def is_complex(self):
        return self.dtype.is_complex

    @property
    def spec(self):
        return (self.shape, self.dtype, self.device, self.requires_grad)

    def materialize(self) -> torch.Tensor:
        if self._concrete is None:
            seg = self._segment
            if not seg.flushed:
                _flush(seg, "sync")
            if self._concrete is None:
                raise RuntimeError(
                    "lazy-dispatch segment flush failed; this tensor's value is "
                    "unavailable") from seg.error
        return self._concrete

    def __repr__(self):
        state = "pending" if self._concrete is None else "materialized"
        return f"<LazyRef {state} shape={tuple(self.shape)} dtype={self.dtype}>"


def _spec(t) -> Tuple:
    return (t.shape, t.dtype, t.device, t.requires_grad)


# ---------------------------------------------------------------------------
# argument trees: containers of tensors and hashable static values
# ---------------------------------------------------------------------------
class _Unhashable(Exception):
    pass


_LEAF = ("T",)


def _static_key(x):
    if isinstance(x, _STATIC_TYPES):
        return (type(x), x)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_static_key(v) for v in x))
    if isinstance(x, types.FunctionType) or isinstance(x, functools.partial):
        k = _fn_key(x)
        if k is None:
            raise _Unhashable
        return k
    from .dtype import DType

    if isinstance(x, DType):
        return (DType, x.name)
    raise _Unhashable


def _flatten(obj, leaves: list):
    """The structure of ``obj`` (hashable: containers, static values and
    ``_LEAF`` marks); its tensors (Tensor cells or torch tensors) are
    appended to ``leaves`` in order. Raises _Unhashable for any other
    value."""
    from .tensor import Tensor

    if isinstance(obj, (Tensor, torch.Tensor)):
        leaves.append(obj)
        return _LEAF
    t = type(obj)
    if t is tuple or t is list:
        return (t, tuple(_flatten(o, leaves) for o in obj))
    if t is dict:
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return (t, tuple(_flatten(o, leaves) for o in obj))
    return ("S", _static_key(obj), obj)


def _unflatten(tree, it):
    if tree is _LEAF or tree == _LEAF:
        return next(it)
    kind = tree[0]
    if kind == "S":
        return tree[2]
    if kind is dict:
        return {k: _unflatten(v, it) for k, v in tree[1]}
    if kind is tuple or kind is list:
        return kind(_unflatten(v, it) for v in tree[1])
    return kind(*(_unflatten(v, it) for v in tree[1]))  # a namedtuple


def _tree_key(tree):
    """``tree`` without the static values themselves (their keys stay)."""
    if tree is _LEAF or tree == _LEAF:
        return _LEAF
    if tree[0] == "S":
        return ("S", tree[1])
    if tree[0] is dict:
        return (dict, tuple((k, _tree_key(v)) for k, v in tree[1]))
    return (tree[0], tuple(_tree_key(v) for v in tree[1]))


def _out_leaves(out, leaves: list):
    if isinstance(out, torch.Tensor):
        leaves.append(out)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _out_leaves(o, leaves)
    elif isinstance(out, dict):
        for o in out.values():
            _out_leaves(o, leaves)
    return leaves


def _fn_key(fn):
    """A hashable identity of ``fn`` that holds across calls: a function by
    its code, defaults and closure values; a partial by its parts; a
    builtin by itself. None when that is not possible (a bound method, a
    closure over a tensor or a module): such calls are not deferred."""
    try:
        if isinstance(fn, functools.partial):
            inner = _fn_key(fn.func)
            if inner is None:
                return None
            return ("partial", inner, _static_key(fn.args),
                    tuple((k, _static_key(v)) for k, v in sorted(fn.keywords.items())))
        code = getattr(fn, "__code__", None)
        if code is not None and isinstance(fn, types.FunctionType):
            cells = fn.__closure__ or ()
            return ("fn", code, tuple(_static_key(c.cell_contents) for c in cells),
                    _static_key(fn.__defaults__ or ()),
                    tuple((k, _static_key(v)) for k, v in sorted((fn.__kwdefaults__ or {})
                                                                  .items())))
        if isinstance(fn, (types.MethodDescriptorType, types.WrapperDescriptorType)):
            return fn
        if isinstance(fn, (types.BuiltinFunctionType, types.BuiltinMethodType)):
            if isinstance(getattr(fn, "__self__", None), torch.Tensor):
                return None
            return fn
        if type(fn).__name__ in ("OpOverloadPacket", "OpOverload"):
            return fn
    except (_Unhashable, ValueError):  # ValueError: an empty closure cell
        return None
    return None


class _LayerCall:
    """The deferred call of one layer: ``torch.nn.Module.__call__`` on it."""

    __slots__ = ("module",)

    def __init__(self, module):
        self.module = module

    def __call__(self, *args, **kwargs):
        return torch.nn.Module.__call__(self.module, *args, **kwargs)


# what torch.nn.Module keeps in every instance's __dict__ (its registries and
# hook tables), left out of a layer's attributes: its parameters, buffers,
# sublayers and forward hooks are taken by _layer_state itself
_MODULE_INTERNALS = frozenset(torch.nn.Module().__dict__) - {"training"}
_PLAIN = frozenset((bool, int, float, str, type(None)))
# a layer state -> (its token, the objects whose ids the state holds: kept
# alive while the entry lives, so no id in it is reused); LRU-bounded by
# FLAGS_eager_jit_cache_size. A token is never reused, so a state that
# comes back after its entry was dropped gets a new one, never a stale match
_layer_tokens: "OrderedDict[Tuple, Tuple[int, list]]" = OrderedDict()
_next_token = [0]


def _held(v, held: list):
    """A non-plain attribute value in a layer state: its static key, or its
    identity (the object then goes to ``held``)."""
    try:
        return _static_key(v)
    except _Unhashable:
        held.append(v)
        return ("id", id(v))


def _layer_state(module, by_identity: bool, held: list) -> Tuple:
    """What decides what ``module``'s forward computes, apart from its
    inputs and its tensors' values, for it and each of its sublayers: the
    mode and other attributes (static values by value, any other object by
    identity), the parameters and buffers by identity with whether each
    trains, the sublayers by name and identity, the forward hooks; with
    ``by_identity`` the layers' own identities too. Every object taken by
    identity is appended to ``held``."""
    out, seen, todo = [], set(), [module]
    plain, internal = _PLAIN, _MODULE_INTERNALS
    while todo:
        m = todo.pop()
        if id(m) in seen:
            continue
        seen.add(id(m))
        d = m.__dict__
        params, bufs, subs = d["_parameters"], d["_buffers"], d["_modules"]
        held += params.values()
        held += bufs.values()
        held += subs.values()
        out.append((
            id(m) if by_identity else type(m), tuple(d),
            tuple([v if type(v) in plain else _held(v, held)
                   for k, v in d.items() if k not in internal]),
            tuple(params), tuple(map(id, params.values())),
            tuple([p is not None and p.requires_grad for p in params.values()]),
            tuple(bufs), tuple(map(id, bufs.values())),
            tuple(subs), tuple(map(id, subs.values())),
            tuple(d["_forward_pre_hooks"]), tuple(d["_forward_hooks"]),
        ))
        todo += [c for c in subs.values() if c is not None]
    if by_identity:
        held.append(module)
    return tuple(out)


def layer_key(module) -> Tuple:
    """The op key of a layer call: a token of the layer's state. A layer
    with no parameters, buffers or sublayers (a criterion, an activation)
    is keyed by its class and attributes, so two equal ones are one op, as
    the JAX package keys their ops; any other by its identity and that of
    each of its sublayers, with the state of each. A layer put into eval
    mode, a sublayer or parameter replaced, a parameter frozen, a hook
    added or an attribute set gives another key, so a cached segment or
    captured step never replays the layer as it was. A mutable object held
    as an attribute and changed in place is not seen."""
    d = module.__dict__
    held: list = []
    state = _layer_state(module, bool(d["_parameters"] or d["_buffers"] or d["_modules"]),
                         held)
    hit = _layer_tokens.get(state)
    if hit is None:
        _next_token[0] += 1
        hit = _layer_tokens[state] = (_next_token[0], held)
        cap = int(flags.flag("eager_jit_cache_size"))
        while cap > 0 and len(_layer_tokens) > cap:
            _layer_tokens.popitem(last=False)
    else:
        _layer_tokens.move_to_end(state)
    return ("layer", hit[0])


# ---------------------------------------------------------------------------
# output-spec inference: FakeTensorMode, cached by (op, statics, input specs)
# ---------------------------------------------------------------------------
_spec_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_fake_mode = [None]
# the last call that could not be deferred, and why: (op key, the error)
last_infer_failure: List[Optional[Tuple]] = [None]
# the last error that made a captured program fall back (capture_error)
last_capture_error: List[Optional[str]] = [None]


def _fake():
    if _fake_mode[0] is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _fake_mode[0] = FakeTensorMode(allow_non_fake_inputs=True)
    return _fake_mode[0]


def _infer_out_specs(fn, key, tree, specs, grad):
    """``(out_tree, out_specs)`` of ``fn`` on inputs of ``specs``, or
    ``(reason,)`` when the call cannot be deferred: its output shape
    depends on data (``fallback_nojit``), or it fails under fake tensors,
    reads a value on the host or returns something other than tensors
    (``fallback_infer``)."""
    ck = (key, _tree_key(tree), specs, grad)
    hit = _spec_cache.get(ck)
    if hit is not None:
        _spec_cache.move_to_end(ck)
        return hit
    from torch._subclasses import fake_tensor as ft

    mode = _fake()
    d = _dispatch()
    prev = d._depth()
    d._set_depth(1)
    # FakeTensorMode refuses a tensor subclass it does not know, and the
    # port's parameters are one (core.tensor.Parameter): a layer runs over
    # fake stand-ins of its parameters
    module = fn.module if isinstance(fn, _LayerCall) else None
    try:
        with mode, torch.set_grad_enabled(grad), _swapped_parameters(
                [module] if module is not None else [],
                lambda p: torch.empty(p.shape, dtype=p.dtype,
                                      device=p.device).requires_grad_(p.requires_grad)):
            fakes = []
            for shape, dtype, device, rg in specs:
                f = torch.empty(shape, dtype=dtype, device=device)
                fakes.append(f.requires_grad_(True) if rg else f)
            args, kwargs = _unflatten(tree, iter(fakes))
            out = fn(*args, **kwargs)
        leaves: list = []
        out_tree = _flatten(out, leaves)
        if not all(isinstance(o, ft.FakeTensor) for o in leaves):
            raise TypeError("an output is not a tensor made by the call")
        res = (out_tree, tuple(_spec(o) for o in leaves))
    except (ft.DynamicOutputShapeException, ft.DataDependentOutputException) as e:
        res = ("fallback_nojit",)
        last_infer_failure[0] = (key, repr(e))
    except Exception as e:  # noqa: BLE001 — any failure means: run it at once
        res = ("fallback_infer",)
        last_infer_failure[0] = (key, repr(e))
    finally:
        d._set_depth(prev)
    _spec_cache[ck] = res
    cap = int(flags.flag("eager_jit_cache_size"))
    while cap > 0 and len(_spec_cache) > cap:
        _spec_cache.popitem(last=False)
        _counters()["jit_cache_evictions"] += 1
    return res


@contextlib.contextmanager
def _swapped_parameters(modules, stand_in):
    """Inside the block, every parameter of ``modules`` and their sublayers
    for which ``stand_in(param)`` gives a tensor is that tensor (one per
    parameter, however often it is registered); put back on exit."""
    swapped, made = [], {}
    try:
        for module in modules:
            for m in module.modules():
                params = m._parameters
                for name, p in list(params.items()):
                    if p is None:
                        continue
                    if id(p) not in made:
                        made[id(p)] = stand_in(p)
                    t = made[id(p)]
                    if t is not None:
                        params[name] = t
                        swapped.append((params, name, p))
        yield
    finally:
        for params, name, p in reversed(swapped):
            params[name] = p


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
class _SegOp:
    __slots__ = ("fn", "tree", "bindings", "grad", "out_tree", "refs", "sig", "module")

    def __init__(self, fn, tree, bindings, grad, out_tree, refs, sig, module):
        self.fn, self.tree, self.bindings, self.grad = fn, tree, bindings, grad
        self.out_tree, self.refs, self.sig, self.module = out_tree, refs, sig, module


class _PlanOp:
    """A segment op without its values: what a cached program runs."""

    __slots__ = ("fn", "tree", "bindings", "grad", "module")

    def __init__(self, op: _SegOp):
        self.fn, self.tree, self.bindings = op.fn, op.tree, op.bindings
        self.grad, self.module = op.grad, op.module


class _Segment:
    __slots__ = ("ops", "ext", "ext_ids", "ext_cells", "flushed", "error", "pinned",
                 "__weakref__")

    def __init__(self):
        self.ops: List[_SegOp] = []
        self.ext: List[torch.Tensor] = []
        self.ext_ids: Dict[int, int] = {}
        self.ext_cells: list = []  # weakref to the cell an input came in, or None
        self.flushed = False
        self.error = None
        self.pinned: set = set()  # (op, out) kept as outputs whatever cells live


def _current_segment() -> _Segment:
    seg = getattr(_tls, "segment", None)
    if seg is None or seg.flushed:
        seg = _tls.segment = _Segment()
    return seg


def pending_op_count() -> int:
    seg = getattr(_tls, "segment", None)
    return 0 if seg is None or seg.flushed else len(seg.ops)


def flush_if_pending(reason: str = "explicit_sync"):
    """Flush this thread's pending segment (nothing when none is pending).
    A deferred whole step resolves on the 3-program path first."""
    if getattr(_tls, "capture_deferred", None) is not None:
        _abort_capture(reason)
    seg = getattr(_tls, "segment", None)
    if seg is not None and not seg.flushed and seg.ops:
        _flush(seg, reason)


def pending_segment_program():
    """The recorded IR (``analysis.Program``) of this thread's pending
    segment WITHOUT flushing it, or None: its calls run once more under
    ``FakeTensorMode``, over fake stand-ins of its inputs and its layers'
    parameters, inside a recording of fake tensors (nothing runs on the
    device, nothing is written)."""
    seg = getattr(_tls, "segment", None)
    if seg is None or seg.flushed or not seg.ops:
        return None
    from .. import analysis

    plan = tuple(_PlanOp(op) for op in seg.ops)
    modules = [op.module for op in plan if op.module is not None]

    def fake_like(t):
        return torch.empty(t.shape, dtype=t.dtype, device=t.device).requires_grad_(
            t.requires_grad)

    with _fake(), _swapped_parameters(modules, fake_like):
        ext = [fake_like(t) for t in seg.ext]
        with analysis.recording("lazy-segment", fake=True) as rec:
            _run_plan(plan, ext)
    return rec.program


def lazy_on() -> bool:
    return bool(flags.flag("eager_lazy_dispatch"))


def record(fn, key, args, kwargs, grad: bool, apply_outputs: bool, module=None):
    """Defer ``fn(*args, **kwargs)`` (``fn`` over torch values, the
    arguments holding Tensors, torch tensors and static values) onto the
    pending segment. Returns its outputs as Tensors over LazyRefs, a list
    of them for a sequence when ``apply_outputs`` (``dispatch.apply``'s
    convention) and the output's own structure otherwise, or FALLBACK after
    flushing the pending segment when the call must run at once."""
    from ..amp import amp_active
    from ..resilience import runtime as _rrt
    from .tensor import Tensor, _wrap

    t0 = time.perf_counter()
    if flags.flag("check_nan_inf"):
        return _fallback("fallback_debug")
    if amp_active():
        return _fallback("fallback_amp")
    if not _rrt.lazy_tier_ok():
        return _fallback("ladder_demoted")
    if key is None:
        return _fallback("fallback_unhashable")
    leaves: list = []
    try:
        tree = _flatten((args, kwargs), leaves)
    except _Unhashable:
        return _fallback("fallback_unhashable")
    seg = _current_segment()
    if len(seg.ops) >= max(1, int(flags.flag("eager_segment_max_ops"))):
        _flush(seg, "segment_limit")
        seg = _current_segment()
    bindings, specs = [], []
    for leaf in leaves:
        cell = leaf if isinstance(leaf, Tensor) else None
        v = leaf._v if cell is not None else leaf
        if type(v) is LazyRef:
            if v._concrete is None and v._segment is seg:
                bindings.append((_RES, v._op_index, v._out_index))
                specs.append(v.spec)
                continue
            v = v.materialize()  # another segment's value (a deferred step's: resolved)
            if cell is not None:
                cell._v = v
            if seg.flushed:  # defensive: the bindings so far are stale
                return _fallback("sync")
        idx = seg.ext_ids.get(id(v))
        if idx is None:
            idx = seg.ext_ids[id(v)] = len(seg.ext)
            seg.ext.append(v)
            seg.ext_cells.append(None if cell is None else weakref.ref(cell))
        elif cell is not None and seg.ext_cells[idx] is None:
            seg.ext_cells[idx] = weakref.ref(cell)
        bindings.append((_EXT, idx))
        specs.append(_spec(v))
    specs = tuple(specs)
    inferred = _infer_out_specs(fn, key, tree, specs, grad)
    if len(inferred) == 1:
        _add_time("trace_time_ms", t0)
        return _fallback(inferred[0])
    out_tree, out_specs = inferred
    op_i = len(seg.ops)
    refs = [LazyRef(seg, op_i, j, s) for j, s in enumerate(out_specs)]
    bindings = tuple(bindings)
    sig = (key, _tree_key(tree), bindings, grad)
    seg.ops.append(_SegOp(fn, tree, bindings, grad, out_tree, refs, sig, module))
    cells = []
    for ref in refs:
        c = _wrap(ref)
        ref.cell = weakref.ref(c)
        cells.append(c)
    out = _unflatten(out_tree, iter(cells))
    _counters()["lazy_ops_deferred"] += 1
    _add_time("trace_time_ms", t0)
    if apply_outputs and isinstance(out, (tuple, list)):
        return list(out)
    return out


def _fallback(reason: str):
    flush_if_pending(reason)
    return FALLBACK


def _seg_signature(seg: _Segment) -> Tuple:
    return (tuple(op.sig for op in seg.ops), tuple(_spec(t) for t in seg.ext))


def _run_plan(plan, ext) -> list:
    """Run a segment plan on the external inputs ``ext``: each op's flat
    outputs, in order. Nested Paddle-level calls run at once."""
    d = _dispatch()
    prev = d._depth()
    d._set_depth(1)
    try:
        results: list = []
        for op in plan:
            vals = [ext[b[1]] if b[0] == _EXT else results[b[1]][b[2]] for b in op.bindings]
            args, kwargs = _unflatten(op.tree, iter(vals))
            with torch.set_grad_enabled(op.grad):
                out = op.fn(*args, **kwargs)
            results.append(_out_leaves(out, []))
        return results
    finally:
        d._set_depth(prev)


# ---------------------------------------------------------------------------
# segment programs: the plan eagerly, then (on the card) two CUDA graphs
# ---------------------------------------------------------------------------
def _on_card(plan, ext) -> bool:
    if any(t.device.type == "cuda" for t in ext):
        return True
    for op in plan:
        if op.module is not None:
            p = next(op.module.parameters(), None)
            if p is not None and p.device.type == "cuda":
                return True
    return False


def _params_of(plan) -> List[torch.Tensor]:
    seen, out = set(), []
    for op in plan:
        if op.module is None:
            continue
        for p in op.module.parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def _storage_of(plan) -> Tuple:
    """Where the plan's layers keep their parameters and buffers, which a
    graph reads in place: a tensor rebound to new storage after the
    capture (``p.data = ...``) changes it."""
    return tuple(t.data_ptr() for op in plan if op.module is not None
                 for t in (*op.module.parameters(), *op.module.buffers()))


def _aliased(plan, alias: Dict[int, torch.Tensor]):
    """Run the plan's layers over aliases of their trainable parameters:
    tensors that share each parameter's storage (so a graph reads, and an
    in-place update writes, the parameter itself) but are leaves of their
    own. Gradients are taken with respect to the aliases (``alias`` maps
    ``id(param)`` to its alias). A parameter's own AccumulateGrad node may
    be kept alive by an older step's graph (a loss the user keeps) and runs
    on the stream it was made on, which a capture on its own stream cannot
    take in; the aliases' nodes are made inside the capture."""
    def stand_in(p):
        if not p.requires_grad:
            return None
        return alias.setdefault(id(p), p.detach().requires_grad_(True))

    modules = list({id(op.module): op.module for op in plan if op.module is not None}.values())
    return _swapped_parameters(modules, stand_in)


class _SegProgram:
    """The program of one segment signature: on the CPU its plan, run
    eagerly; on the card the plan eagerly once (the bridge, which also
    loads every kernel), then a forward graph and a backward graph per set
    of live outputs."""

    def __init__(self, plan):
        self.plan = plan
        self.runs = 0
        self.graphs: Dict[Tuple, Any] = {}
        self.card = None

    def release(self):
        """Drop the graphs (they are captured again when next needed)."""
        for g in self.graphs.values():
            if g:
                g.release()
        self.graphs.clear()

    def run(self, ext, live):
        if self.card is None:
            self.card = _on_card(self.plan, ext)
        self.runs += 1
        if not self.card or self.runs == 1 or _higher_order[0] \
                or getattr(_tls, "reference", None) is not None and _tls.reference[0] == "open":
            # (a step recorded as the capture's reference runs its ops eagerly)
            return _run_plan(self.plan, ext)
        g = self.graphs.get(live)
        if g and g.storage != _storage_of(self.plan):
            # a parameter or buffer was rebound: the graph reads stale memory.
            # A replay still waiting for its backward keeps the graph alive
            if not g.busy():
                g.release()
            g = self.graphs[live] = None
            _counters()["segment_graph_invalidations"] += 1
        if g is None:
            try:
                g = self.graphs[live] = _SegGraph(self.plan, ext, live)
            except Exception as e:  # noqa: BLE001 — the plan still runs eagerly
                self.graphs[live] = g = False
                _count_reason("flush_reasons", "graph_build_error")
                last_capture_error[0] = repr(e)
        if g is False or g.busy():
            return _run_plan(self.plan, ext)
        _counters()["segment_graph_replays"] += 1
        return g.run(ext)


class _GraphedSegment(torch.autograd.Function):
    """A segment graph's forward replay, with its backward graph as the
    autograd backward."""

    @staticmethod
    def forward(ctx, g, *inputs):
        g.fwd.replay()
        outs = tuple(o.clone() for o in g.outs)
        ctx.g = g
        if len(outs) > len(g.diff_idx):
            diff = set(g.diff_idx)
            ctx.mark_non_differentiable(*[c for k, c in enumerate(outs) if k not in diff])
        # a second backward without retain_graph raises, as through the
        # eager graph: the saved tensor is freed by the first
        ctx.save_for_backward(outs[0])
        g.waiting = weakref.ref(outs[0])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        ctx.saved_tensors  # noqa: B018 — raises on a second backward
        g = ctx.g
        for buf, k in zip(g.grad_outs, g.diff_idx):
            gr = grads[k]
            if gr is None:
                buf.zero_()
            else:
                buf.copy_(gr)
        g.bwd.replay()
        g.waiting = None
        return (None,) + tuple(None if t is None else t.clone() for t in g.grads)


class _SegGraph:
    """The forward and backward CUDA graphs of one segment plan for one set
    of live outputs, over static copies of the external inputs and the
    layers' own parameters (read in place)."""

    def __init__(self, plan, ext, live):
        device = next(t.device for t in list(ext) + _params_of(plan) if t.device.type == "cuda")
        self.static = [t.detach().clone().requires_grad_(t.requires_grad) for t in ext]
        self.rg_ext = [i for i, t in enumerate(ext) if t.requires_grad]
        self.params = [p for p in _params_of(plan) if p.requires_grad]
        self.storage = _storage_of(plan)
        self.waiting = None
        pool = torch.cuda.graph_pool_handle()
        self.fwd = cuda_graphs.Graph(device)
        alias: Dict[int, torch.Tensor] = {}
        with _aliased(plan, alias), self.fwd.capture(pool):
            results = _run_plan(plan, self.static)
        outs = [results[i][j] for i, j in live]
        self.diff_idx = [k for k, o in enumerate(outs) if o.requires_grad]
        diff_outs = [outs[k] for k in self.diff_idx]
        diff_in = ([self.static[i] for i in self.rg_ext]
                   + [alias.get(id(p), p) for p in self.params])
        self.bwd = None
        self.grads = [None] * len(diff_in)
        self.grad_outs = [torch.empty_like(o) for o in diff_outs]
        if diff_outs and diff_in:
            self.bwd = cuda_graphs.Graph(device)
            with self.bwd.capture(pool):
                self.grads = list(torch.autograd.grad(
                    diff_outs, diff_in, grad_outputs=self.grad_outs, allow_unused=True))
        # the graphs hold the kernels: the autograd graph of the capture goes
        self.outs = [o.detach() for o in outs]
        _counters()["segment_graph_builds"] += 1

    def release(self):
        self.fwd.reset()
        if self.bwd is not None:
            self.bwd.reset()
        self.static = self.outs = self.grads = self.grad_outs = None

    def busy(self) -> bool:
        """A replay's outputs still wait for their backward: a new forward
        replay would overwrite the activations it reads."""
        return self.waiting is not None and self.waiting() is not None

    def run(self, ext):
        cuda_graphs.copy_in(self.static, ext)
        if self.bwd is None:
            self.fwd.replay()
            outs = [o.clone() for o in self.outs]
        else:
            with torch.enable_grad():
                outs = list(_GraphedSegment.apply(
                    self, *[ext[i] for i in self.rg_ext], *self.params))
        return _Sparse(outs)


class _Sparse:
    """Flat outputs of the live positions, as ``results[i][j]`` reads them."""

    def __init__(self, outs):
        self.outs = outs


_segment_cache: "OrderedDict[Tuple, _SegProgram]" = OrderedDict()


def _build_segment_fn(plan) -> _SegProgram:
    """The program of a segment plan."""
    return _SegProgram(plan)


def _live_of(seg: _Segment) -> Tuple:
    live = []
    for i, op in enumerate(seg.ops):
        for j, ref in enumerate(op.refs):
            c = ref.cell
            if (i, j) in seg.pinned or (c is not None and c() is not None):
                live.append((i, j))
    return tuple(live)


def _give(ref: LazyRef, v: torch.Tensor):
    """The value of ``ref``, written back into its cell when it lives."""
    ref._concrete = v
    c = ref.cell
    c = None if c is None else c()
    if c is not None and c._v is ref:
        c._v = v


def _flush(seg: _Segment, reason: str):
    """Run the pending segment ``seg`` as one program and give its live
    outputs their values."""
    from ..resilience import runtime as _rrt

    if seg.flushed:
        return
    rec = getattr(_tls, "capture_deferred", None)
    if rec is not None and seg is rec.segment:
        # a read reached the deferred step's forward: resolve the step on
        # the 3-program path (which flushes this segment)
        _abort_capture(reason)
        return
    seg.flushed = True
    if getattr(_tls, "segment", None) is seg:
        _tls.segment = None
    if not seg.ops:
        return
    ref = getattr(_tls, "reference", None)
    if ref is not None and ref[0] == "armed":
        # the step the capture will be held against starts at its forward
        from .. import analysis

        rec = analysis.recording("3-program")
        rec.__enter__()
        _tls.reference = ("open", rec)
    c = _counters()
    _count_reason("flush_reasons", reason)
    c["segments_flushed"] += 1
    sig = _seg_signature(seg)
    program = _segment_cache.get(sig)
    live = _live_of(seg)
    t0 = time.perf_counter()
    timer = "replay_time_ms"
    skey = f"segment:{_sig_id(sig)}"
    try:
        if program is None:
            c["segment_cache_misses"] += 1
            program = _build_segment_fn(tuple(_PlanOp(op) for op in seg.ops))
            timer = "compile_time_ms"
            _segment_cache[sig] = program
            cap = int(flags.flag("eager_segment_cache_size"))
            while cap > 0 and len(_segment_cache) > cap:
                _segment_cache.popitem(last=False)
                c["segment_cache_evictions"] += 1
            # the first run is recorded: the segment's IR for attribution
            with _recording(skey) as rec:
                results = _rrt.execute("segment", lambda: program.run(seg.ext, live),
                                       retry_unsafe=True)
            _register_program(skey, "segment", ir_thunk=lambda _p=rec.program: _p,
                              ops=len(seg.ops))
            if int(flags.flag("check_programs")):
                # FLAGS_check_programs: verify the segment's program at its first
                # run (later runs replay the same program); a level-2 raise lands
                # below, so reads of this segment's tensors re-raise it
                from .. import analysis

                analysis.enforce(analysis.check(rec.program, source="lazy-segment"),
                                 where=f"lazy-segment flush ({reason})")
        else:
            c["segment_cache_hits"] += 1
            _segment_cache.move_to_end(sig)
            results = _rrt.execute("segment", lambda: program.run(seg.ext, live),
                                   retry_unsafe=True)
    except BaseException as e:
        seg.error = e
        raise
    finally:
        dt = (time.perf_counter() - t0) * 1e3
        c[timer] += dt
    if timer == "replay_time_ms":
        _note_program(skey, "segment", dt)  # host clock: the enqueue on the card
    _emit("flush", site="segment", reason=reason, ops=len(seg.ops),
          cache="miss" if timer == "compile_time_ms" else "hit", fused=True,
          bridged=program.runs == 1)
    from .. import profiler

    profiler.count_program("segment")
    if isinstance(results, _Sparse):
        for (i, j), v in zip(live, results.outs):
            _give(seg.ops[i].refs[j], v)
    else:
        for op, vals in zip(seg.ops, results):
            for ref, v in zip(op.refs, vals):
                _give(ref, v)
    _observe(("seg", sig))
    _retire(seg)


def _retire(seg: _Segment):
    """Drop a segment's inputs and ops once its outputs have their values:
    its refs and ops form reference cycles, and the inputs can be large."""
    seg.ext, seg.ext_ids, seg.ext_cells, seg.ops = [], {}, [], []


# ---------------------------------------------------------------------------
# whole-step capture: the observer
# ---------------------------------------------------------------------------
_MAX_OBSERVED_EVENTS = 64


class _Observer:
    __slots__ = ("events", "dirty", "prev", "stable", "armed", "cycle_len", "pos")

    def __init__(self):
        self.events: List[Tuple] = []
        self.dirty = False
        self.prev = None
        self.stable = 0
        self.armed = None  # (seg_sig, bwd_key, opt_fp, k)
        self.cycle_len = 1
        self.pos = 0


def _disarm(obs: _Observer):
    obs.armed, obs.prev, obs.stable = None, None, 0
    obs.cycle_len, obs.pos = 1, 0


def _capture_on() -> bool:
    return (bool(flags.flag("eager_lazy_dispatch")) and bool(flags.flag("eager_step_capture"))
            and not flags.flag("check_nan_inf"))


def _mem_plan_on() -> bool:
    """Planner-guided remat of the captured step (FLAGS_memory_plan='auto'
    with a budget): a budget of 0 leaves nothing to plan against."""
    return str(flags.flag("memory_plan")) == "auto" and float(flags.flag("memory_budget_mb")) > 0


def _want_reference() -> bool:
    """Record 3-program steps as the capture's reference: for its
    equivalence certificate (FLAGS_check_programs=2) or its remat plan."""
    return _capture_on() and (int(flags.flag("check_programs")) >= 2 or _mem_plan_on())


def _step_labels(opt, program, lr=None):
    """({value id: label}, output value ids) of a recorded step: its
    parameters, their optimizer states and gradients by position, and the
    learning rate of a captured step (a device scalar, labelled by its
    value: the 3-program step makes it from the float)."""
    labels, outs = {}, []
    params = [p for p in opt._param_list() if p.requires_grad]
    sched = getattr(opt, "_offload_sched", None)
    for i, p in enumerate(params):
        st = opt._accumulators.get(id(p)) or {}
        parked = set() if sched is None else {k for k in st if (id(st), k) in sched._parked}
        named = [(f"param{i}", p)]
        # a parked moment's value is its pinned host buffer's
        named += [(f"state{i}.{k}", sched._host[(id(st), k)] if k in parked else t)
                  for k, t in sorted(st.items()) if isinstance(t, torch.Tensor)]
        g = _raw_grad(p)
        for label, t in named:
            vid = program.value_of(t)
            if vid is not None and program.values[vid].producer < 0:
                labels[vid] = label
            outs.append(vid)
        outs.append(program.value_of(g) if g is not None else None)
    if lr is not None:
        vid = program.value_of(lr)
        if vid is not None:
            labels[vid] = f"sc:{float(opt.get_lr())!r}"
    return labels, outs


def step_end(opt, captured: bool):
    """``Optimizer.step()``'s end: close the reference recording of the step
    that just ran on the 3-program path (the capture's certificate and
    remat plan read it), open one for the next while they are wanted, and
    raise a verification error the step deferred until it completed."""
    ref = getattr(_tls, "reference", None)
    if ref is not None and ref[0] == "open":
        rec = ref[1]
        _tls.reference = None
        rec.__exit__(None, None, None)
        labels, outs = _step_labels(opt, rec.program)
        _tls.reference_done = (rec.program, labels, outs)
    if not captured and _want_reference() and getattr(_tls, "capture_deferred", None) is None:
        _tls.reference = ("armed",)  # opened at the next step's first segment flush
    err = getattr(_tls, "pending_verification", None)
    if err is not None:
        _tls.pending_verification = None
        raise err


def _observer() -> _Observer:
    obs = getattr(_tls, "observer", None)
    if obs is None:
        obs = _tls.observer = _Observer()
    return obs


def _observe(ev: Tuple):
    if not _capture_on():
        return
    obs = _observer()
    if len(obs.events) < _MAX_OBSERVED_EVENTS:
        obs.events.append(ev)
    else:
        obs.dirty = True


def observe_op_program():
    """A Paddle-level call ran at once inside a lazy step: that step is not
    capturable as one program."""
    obs = getattr(_tls, "observer", None)
    if obs is not None:
        obs.dirty = True


def observe_backward(key):
    _observe(("bwd", key))


def _capture_fallback(reason: str):
    _counters()["capture_fallbacks"] += 1
    _count_reason("capture_fallback_reasons", reason)
    _emit("capture", site="captured", phase="fallback", reason=reason)


# torch's own grad slot, past the Parameter.grad property that reports
# accesses to the controller
_raw_grad = torch._C.TensorBase.grad.__get__
_set_raw_grad = torch._C.TensorBase.grad.__set__


def _opt_fingerprint(opt, grad_ids) -> Optional[Tuple]:
    """The optimizer part of a step signature: rule, hypers, per-parameter
    hypers, weight decay, the clip's fingerprint, the fused-update flag and
    the parameters it updates (those in ``grad_ids``). The learning rate is
    not in it: a captured step reads it from a device scalar. None for a
    step the capture cannot reproduce (a custom clip, numeric rescue)."""
    from ..nn.clip import clip_fingerprint
    from ..resilience import rescue as _rescue

    clip_fp = clip_fingerprint(getattr(opt, "_grad_clip", None))
    if clip_fp is None or _rescue.active():
        return None
    upd = [p for p in opt._param_list() if p.requires_grad and id(p) in grad_ids]
    return (
        type(opt),
        tuple(sorted(opt._hyper().items())),
        tuple(tuple(sorted(opt._per_param_hyper(p).items())) for p in upd),
        opt._weight_decay,
        clip_fp,
        bool(flags.flag("pallas_fused_update")),
        tuple(id(p) for p in upd),
    )


def _ladder_key(sig):
    try:
        return hash(sig) & 0xFFFFFFFF
    except TypeError:
        return None


def _step_boundary(opt):
    """Fold this step's events into the stability count; arm after
    FLAGS_eager_capture_warmup identical steady-state steps."""
    from ..resilience import runtime as _rrt

    obs = _observer()
    events, dirty = obs.events, obs.dirty
    obs.events, obs.dirty = [], False
    k = len(events) // 2
    periodic = (
        not dirty and k >= 1 and len(events) == 2 * k
        and all(events[2 * i][0] == "seg" and events[2 * i][1] == events[0][1]
                for i in range(k))
        and all(events[2 * i + 1][0] == "bwd" and events[2 * i + 1][1] == events[1][1]
                and events[1][1] is not None for i in range(k))
    )
    opt_fp = None
    if periodic:
        grad_ids = {id(p) for p in opt._param_list() if _raw_grad(p) is not None}
        try:
            opt_fp = _opt_fingerprint(opt, grad_ids)
        except Exception:  # noqa: BLE001 — an exotic optimizer: never armed
            opt_fp = None
    if opt_fp is None:
        _disarm(obs)
        return
    sig = (events[0][1], events[1][1], opt_fp, k)
    if sig == obs.prev:
        obs.stable += 1
    else:
        obs.prev, obs.stable = sig, 1
    armed = sig if obs.stable >= int(flags.flag("eager_capture_warmup")) else None
    if armed is not None and not _rrt.captured_tier_ok(_ladder_key(events[0][1])):
        armed = None  # the ladder demoted this signature
    if armed is not None and obs.armed != armed:
        obs.cycle_len, obs.pos = k, 0
    obs.armed = armed


# ---------------------------------------------------------------------------
# whole-step capture: the deferred backward
# ---------------------------------------------------------------------------
class _DeferredStep:
    __slots__ = ("segment", "root", "seg_sig", "bwd_key", "leaves", "leaf_ids",
                 "expected_opt_fp", "accumulate", "replaced", "thread")


class _CaptureIneligible(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _ancestors(seg: _Segment, root_op: int) -> set:
    seen, todo = set(), [root_op]
    while todo:
        i = todo.pop()
        if i in seen:
            continue
        seen.add(i)
        todo.extend(b[1] for b in seg.ops[i].bindings if b[0] == _RES)
    return seen


def _leaves_of(seg: _Segment, ops) -> Tuple[list, Optional[str]]:
    """The tensors a backward through ``ops`` accumulates into, in order:
    trainable leaves among the external inputs (each must have come in as
    a Tensor cell) and the trainable parameters of the layer calls (each a
    port ``Parameter``). ``(leaves, None)``, or ``(_, reason)`` when one
    cannot be watched or is not a leaf."""
    from .tensor import Parameter

    leaves, seen = [], set()
    for i in sorted(ops):
        op = seg.ops[i]
        for b in op.bindings:
            if b[0] != _EXT:
                continue
            t = seg.ext[b[1]]
            if not t.requires_grad or id(t) in seen:
                continue
            cell = seg.ext_cells[b[1]]
            cell = None if cell is None else cell()
            if t.grad_fn is not None or cell is None or cell._leaf is not None:
                return leaves, "leaf_ineligible"
            seen.add(id(t))
            leaves.append(t)
        if op.module is not None:
            for p in op.module.parameters():
                if not p.requires_grad or id(p) in seen:
                    continue
                if type(p) is not Parameter:
                    return leaves, "leaf_ineligible"
                seen.add(id(p))
                leaves.append(p)
    return leaves, None


def _has_hooks(seg: _Segment, leaves) -> bool:
    """Whether a hook would run in this step's backward: a cell's hook on a
    leaf or on a value of the segment, or a torch hook on a leaf."""
    from .tensor import _hooked

    ids = {id(t) for t in leaves}
    for cell in list(_hooked):
        v = cell._v
        if cell._hooks and (id(v) in ids or (type(v) is LazyRef and v._segment is seg)):
            return True
    for t in leaves:
        if getattr(t, "_backward_hooks", None) or getattr(t, "_post_accumulate_grad_hooks", None):
            return True
    return False


def backward_key(root) -> Optional[Tuple]:
    """The backward part of a step signature: the root's position in the
    pending segment and the leaves' identities; None when the root is not
    pending there."""
    v = getattr(root, "_v", None)
    seg = getattr(_tls, "segment", None)
    if type(v) is not LazyRef or seg is None or v._segment is not seg or seg.flushed:
        return None
    leaves, _ = _leaves_of(seg, _ancestors(seg, v._op_index))
    return (v._op_index, v._out_index, tuple(id(t) for t in leaves))


def step_capture_backward(root) -> bool:
    """``run_backward``'s capture hook. With the controller armed and this
    backward matching the armed signature, the backward is taken over:
    deferred to ``optimizer.step()`` (a plain step, or the last microstep
    of an accumulation cycle), or run with its forward as one captured
    accumulate-only program (an earlier microstep). Returns True when the
    caller must not sweep."""
    from ..resilience import runtime as _rrt

    if not _capture_on():
        return False
    obs = getattr(_tls, "observer", None)
    if obs is None or obs.armed is None:
        return False
    if getattr(_tls, "capture_deferred", None) is not None:
        return False  # a second backward this step: the flush resolves the first
    seg = getattr(_tls, "segment", None)
    rv = getattr(root, "_v", None)
    if seg is None or seg.flushed or not seg.ops or type(rv) is not LazyRef \
            or rv._segment is not seg or rv.numel() != 1 or not rv.requires_grad:
        return False
    seg_sig = _seg_signature(seg)
    if not _rrt.captured_tier_ok(_ladder_key(seg_sig)):
        return False
    armed_seg, armed_bwd, armed_opt, cycle_len = obs.armed
    if seg_sig != armed_seg:
        return _no_capture(obs, "signature_mismatch")
    anc = _ancestors(seg, rv._op_index)
    leaves, bad = _leaves_of(seg, anc)
    if bad is not None:
        return _no_capture(obs, bad)
    if (rv._op_index, rv._out_index, tuple(id(t) for t in leaves)) != armed_bwd:
        return _no_capture(obs, "tape_mismatch")
    if _has_hooks(seg, leaves):
        return _no_capture(obs, "tape_ineligible")
    for i, op in enumerate(seg.ops):
        if i not in anc and any(r.requires_grad and r.cell is not None and r.cell() is not None
                                for r in op.refs):
            # a differentiable output off the loss's tape: a later backward
            # of its own needs the flushed graph, which a capture has not
            return _no_capture(obs, "non_tape_recorded_ops")
    pos = obs.pos if cycle_len > 1 else 0
    grads = [_raw_grad(t) for t in leaves]
    if pos == 0 and any(g is not None for g in grads):
        return _no_capture(obs, "leaf_ineligible")
    if pos > 0 and any(g is None for g in grads):
        return _no_capture(obs, "accum_grad_ineligible")
    if cycle_len > 1 and pos < cycle_len - 1:
        return _run_accum_microstep(seg, rv, seg_sig, armed_bwd, leaves, pos, obs)
    rec = _DeferredStep()
    rec.segment, rec.root, rec.seg_sig, rec.bwd_key = seg, rv, seg_sig, armed_bwd
    rec.leaves = leaves
    rec.leaf_ids = {id(t) for t in leaves}
    rec.expected_opt_fp = armed_opt
    rec.accumulate = pos > 0
    rec.replaced = {}
    rec.thread = threading.get_ident()
    seg.pinned.add((rv._op_index, rv._out_index))
    _tls.segment = None  # later ops open a new segment
    _tls.capture_deferred = rec
    deferred_step[0] = rec
    return True


def _no_capture(obs, reason) -> bool:
    _capture_fallback(reason)
    _disarm(obs)
    return False


def on_grad_access(holder, value, write: bool) -> bool:
    """A read or write of ``holder.grad`` while a step is deferred: a read
    of one of its leaves resolves the step first (reason ``sync``); a write
    is kept and applied after the step's backward, which ``step()`` then
    resolves on the 3-program path (``grad_replaced``). Returns True when
    the write was kept."""
    rec = deferred_step[0]
    if rec is None or rec.thread != threading.get_ident() or id(holder) not in rec.leaf_ids:
        return False
    if write:
        rec.replaced[id(holder)] = (holder, value)
        return True
    _abort_capture("sync")
    return False


def _abort_capture(reason: str):
    """Resolve the deferred step on the 3-program path: flush its segment,
    run its backward (which accumulates into the leaves' grads as the
    eager step would), then apply the grad writes made since. Counted as a
    capture fallback."""
    rec = getattr(_tls, "capture_deferred", None)
    if rec is None:
        return
    _tls.capture_deferred = None
    deferred_step[0] = None
    obs = getattr(_tls, "observer", None)
    _capture_fallback(reason)
    if obs is not None:
        _disarm(obs)
    _flush(rec.segment, reason)
    root = rec.root.materialize()
    _dispatch()._sweep([root], [None], False)
    for holder, value in rec.replaced.values():
        _set_raw_grad(holder, value)
    if obs is not None:
        obs.events, obs.dirty = [], False


# ---------------------------------------------------------------------------
# whole-step capture: the captured programs
# ---------------------------------------------------------------------------
class _CaptureEntry:
    """One captured step program (a whole step, or an accumulate-only
    microstep): its plan and, on the card, its graph and static buffers."""

    def __init__(self, plan, root, live, update):
        self.plan = plan
        self.root = root          # (op, out) of the loss
        self.live = live          # (op, out) of the other outputs handed out
        self.update = update      # False for an accumulate-only microstep
        self.card = None
        self.graph = None         # a cuda_graphs.Graph
        self.static = None
        self.lr = None
        self.outs = None
        self.grad_bufs = None     # the leaves' grads the graph writes
        self.grad_in = None       # ... and those it adds into (accumulation)
        self.ptrs = None          # parameters' and states' storage at capture
        self.ladder_key = None
        self.seg_sig = None
        self.out_rg = None        # requires_grad of the graph's outputs
        self.akey = None          # the attribution key (captured:<sig> / accum:<sig>)
        self.ir = None            # the program's recorded IR (analysis.Program)
        self.timing = None        # (start, end) CUDA events of the last replay
        self.tele = None          # (group names, the graph's telemetry vector)
        self.mem_plan = None      # the RematPlan applied (FLAGS_memory_plan='auto')
        self.reference = None     # (IR, labels, outputs) of a 3-program step
        self.certificate = None   # its EquivalenceCertificate (FLAGS_check_programs=2)
        self.failed_proof = None  # an exception that failed the certificate
        self.static_diags = None  # the donation gate's static findings, once clean
        self.opt = None           # a weak reference to the optimizer that replays it

    def release(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.static = self.outs = self.grad_bufs = self.grad_in = None
        self.tele = self.timing = None

    def note_replay(self):
        """The last replay's device ms into the attribution registry, when
        its end event has completed: read at the next replay, so the step
        path never waits for it."""
        if self.timing is None:
            return
        start, end = self.timing
        if end.query():
            _note_program(self.akey, self.akey.split(":", 1)[0], start.elapsed_time(end))

    def hand_out(self, outs) -> list:
        """The outputs a run hands out: copies (a graph's static outputs are
        overwritten by its next replay), over a spent graph where the
        output was differentiable."""
        rg = self.out_rg if self.out_rg is not None else [o.requires_grad for o in outs]
        return [_hand_out(o, r) for o, r in zip(outs, rg)]


_capture_cache: "OrderedDict[Tuple, _CaptureEntry]" = OrderedDict()


def _build_captured_step(rec: _DeferredStep, opt, live=()) -> _CaptureEntry:
    """A new captured-step entry for the deferred step ``rec``."""
    plan = tuple(_PlanOp(op) for op in rec.segment.ops)
    return _CaptureEntry(plan, (rec.root._op_index, rec.root._out_index), live, update=True)


def _step_fn(entry: _CaptureEntry, opt, ext, lr, leaves):
    """The whole step: the forward plan, the backward of the root into the
    leaves' grads, then (for an update) the optimizer's own step body, the
    clip and the update, with the learning rate ``lr``. Returns the root
    and the live outputs.

    The gradients are taken with respect to aliases of the leaves
    (``_aliased``) and written (or added) here, as AccumulateGrad writes
    them."""
    from .. import analysis

    alias: Dict[int, torch.Tensor] = {}
    ids = {id(t) for t in leaves}
    bound = contextlib.nullcontext() if entry.mem_plan is None else entry.mem_plan.bind(
        *[op.module for op in entry.plan if op.module is not None])
    # the aliases stay the layers' parameters through the backward: a
    # recompute segment of the memory plan runs its layers again there
    with _aliased(entry.plan, alias):
        with bound:
            ext = [alias.setdefault(id(t), t.detach().requires_grad_(True)) if id(t) in ids
                   else t for t in ext]
            results = _run_plan(entry.plan, ext)
        ri, rj = entry.root
        root = results[ri][rj]
        analysis.mark("backward")
        grads = (torch.autograd.grad([root], [alias.get(id(t), t) for t in leaves],
                                     allow_unused=True) if leaves else ())
    with torch.no_grad():
        for t, g in zip(leaves, grads):
            if g is None:
                continue
            have = _raw_grad(t)
            if have is None:
                _set_raw_grad(t, g)
            else:
                have.add_(g)
    if entry.update:
        from ..nn.clip import capture_clip_fn

        analysis.mark("update")
        sched = getattr(opt, "_offload_sched", None)
        # parked moments stay on the host: the program stages them around the
        # update (optimizer.offload)
        with sched.staged(opt) if sched is not None else contextlib.nullcontext():
            opt._update_params(lr, capture_clip_fn(getattr(opt, "_grad_clip", None)))
    return [results[ri][rj]] + [results[i][j] for i, j in entry.live]


def _entry_ir(entry: _CaptureEntry):
    """The registry's thunk of a captured program's IR: weak, so the
    registry never outlives the capture cache."""
    ref = weakref.ref(entry)

    def thunk():
        e = ref()
        return None if e is None else e.ir

    return thunk


def _donated_count(program) -> int:
    """Inputs the captured program writes in place: parameters and states,
    which a CUDA graph updates in place (the donation of the JAX step)."""
    if program is None:
        return 0
    return sum(1 for v in program.values.values() if v.written)


def captured_step_ir():
    """The recorded IR (``analysis.Program``) of the captured whole step this
    thread replayed last, or None: what ``analysis.memory.captured_step_plans``
    plans."""
    ref = getattr(_tls, "last_captured", None)
    entry = ref() if ref is not None else None
    return None if entry is None else entry.ir


def _state_ptrs(entry: "_CaptureEntry", opt, params, leaves) -> Tuple:
    """Where the graph's leaves, the layers' parameters and buffers, and the
    updated parameters and their optimizer states live."""
    out = [t.data_ptr() for t in leaves]
    for p in params:
        out.append(p.data_ptr())
        st = opt._accumulators.get(id(p)) if opt is not None else None
        for k in sorted(st or ()):
            out.append(st[k].data_ptr())
    return tuple(out) + _storage_of(entry.plan)


class _Spent(torch.autograd.Function):
    """A captured step's output: its value, and a graph a second backward
    cannot go through, as after an eager step's backward."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "Trying to backward through the graph a second time: this tensor came out of "
            "a captured training step, whose backward already ran")


def _hand_out(v: torch.Tensor, differentiable: bool) -> torch.Tensor:
    if differentiable:
        with torch.enable_grad():
            return _Spent.apply(v.detach().requires_grad_())
    return v.detach().clone()


def _run_entry(entry: _CaptureEntry, opt, seg: _Segment, leaves) -> list:
    """Run a captured program for ``seg``'s inputs: eagerly on the CPU, as
    its CUDA graph on the card (captured at the first run)."""
    from ..resilience import runtime as _rrt

    ext = seg.ext
    if entry.card is None:
        entry.card = _on_card(entry.plan, ext)
    params = list(opt._param_list()) if entry.update else []
    if not entry.card:
        # the function itself, at the captured site (an injected fault is
        # raised before it runs; a real one propagates)
        if entry.ir is None:  # the first run is recorded: the program's IR
            with _recording(entry.akey or "captured") as rec:
                out = _rrt.execute("captured", lambda: _step_fn(entry, opt, ext, None, leaves),
                                   retry_unsafe=True, ladder_key=entry.ladder_key)
            entry.ir = rec.program
            if entry.update and int(flags.flag("check_programs")) >= 2:
                # the CPU's first run is the recorded one: a failed proof drops
                # the program after it (its step stands, it ran the same function)
                try:
                    _certify_capture(entry, opt)
                except Exception as e:  # noqa: BLE001
                    entry.failed_proof = e
            return out
        if entry.update and int(flags.flag("check_programs")):
            _check_captured_donation(entry, opt, params)
        return _rrt.execute("captured", lambda: _step_fn(entry, opt, ext, None, leaves),
                            retry_unsafe=True, ladder_key=entry.ladder_key)
    lr = opt.get_lr() if entry.update else None
    if entry.graph is None:
        _capture_graph(entry, opt, ext, lr, leaves, params, entry.seg_sig)
        if entry.update and int(flags.flag("check_programs")) >= 2:
            _certify_capture(entry, opt)  # before the first replay
    elif _state_ptrs(entry, opt if entry.update else None, params, leaves) != entry.ptrs:
        raise _CaptureIneligible("param_rebound")
    if entry.update and int(flags.flag("check_programs")):
        _check_captured_donation(entry, opt, params)
    for t, g in zip(leaves, entry.grad_in or ()):
        if _raw_grad(t) is not g:
            raise _CaptureIneligible("accum_grad_ineligible")
    cuda_graphs.copy_in(entry.static, ext)
    if entry.lr is not None:
        entry.lr.fill_(lr)
    entry.note_replay()
    if entry.timing is None:
        entry.timing = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
    entry.timing[0].record()
    _rrt.execute("captured", entry.graph.replay, retry_unsafe=True, ladder_key=entry.ladder_key)
    entry.timing[1].record()
    if entry.tele is not None:
        from ..profiler import attribution as _attribution

        _attribution.push_telemetry(*entry.tele)
    for t, g in zip(leaves, entry.grad_bufs):
        if g is not None:
            _set_raw_grad(t, g)
    return entry.outs


def _capture_graph(entry: _CaptureEntry, opt, ext, lr, leaves, params, seg_sig=None):
    device = next(t.device for t in list(ext) + list(leaves) if t.device.type == "cuda")
    # the captured step replaces its segment's graphs: give their pools back
    # first, and the allocator's cached blocks, so the capture has the room
    program = _segment_cache.get(seg_sig) if seg_sig is not None else None
    if program is not None:
        program.release()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    for p in params:
        if p.requires_grad:  # a frozen parameter gets no state, as in the eager step
            opt._state_of(p)  # states made inside a capture would be zeroed every replay
    entry.static = [t if (t.requires_grad and t.grad_fn is None) else t.detach().clone()
                    for t in ext]
    entry.lr = None if lr is None else torch.full((), lr, dtype=torch.float32, device=device)
    entry.grad_in = [_raw_grad(t) for t in leaves] if any(
        _raw_grad(t) is not None for t in leaves) else None
    graph = cuda_graphs.Graph(device)
    segments = 0 if entry.mem_plan is None else len(entry.mem_plan.remat_units)
    # the capture's own run of the step is recorded: the program's IR
    with graph.capture(segments=segments), _recording(entry.akey or "captured") as rec:
        outs = _step_fn(entry, opt, entry.static, entry.lr, leaves)
    entry.ir = rec.program
    entry.tele = opt.__dict__.pop("_captured_telemetry", None) if opt is not None else None
    entry.out_rg = [o.requires_grad for o in outs]
    entry.graph, entry.outs = graph, [o.detach() for o in outs]
    entry.grad_bufs = [_raw_grad(t) for t in leaves]
    entry.ptrs = _state_ptrs(entry, opt if entry.update else None, params, leaves)


def _certify_capture(entry: _CaptureEntry, opt):
    """FLAGS_check_programs=2: prove the captured step's recording equal to
    a 3-program step's (the reference recorded while the step was observed;
    two recordings that happened anyway, nothing runs to prove them), over
    the parameters, optimizer states and gradients the step leaves.
    Unprovable (no reference, a failed canonicalisation) raises
    ``_CaptureIneligible("equivalence_unprovable")``; divergent raises
    ``ProgramVerificationError`` with the first divergence."""
    from ..analysis import ProgramVerificationError
    from ..analysis import equivalence as _eq

    c = _counters()
    c["capture_equivalence_checks"] += 1
    try:
        if entry.reference is None:
            raise RuntimeError("no 3-program step was recorded to certify against")
        ref_ir, ref_labels, ref_outs = entry.reference
        labels, outs = _step_labels(opt, entry.ir, lr=entry.lr)
        cert = _eq.prove_equivalent(
            entry.ir, ref_ir, label_a="captured-step", label_b="3-program-composition",
            source="captured-step", labels_a=labels, labels_b=ref_labels, outputs_a=outs,
            outputs_b=ref_outs)
    except Exception as e:  # noqa: BLE001 — unprovable is not divergent
        c["capture_equivalence_unprovable"] += 1
        _emit("capture", site="captured", phase="equivalence", result="unprovable",
              error=type(e).__name__)
        last_capture_error[0] = repr(e)
        raise _CaptureIneligible("equivalence_unprovable")
    if not cert.equivalent:
        c["capture_equivalence_divergences"] += 1
        _emit("capture", site="captured", phase="equivalence", result="divergent", mesh=None)
        raise ProgramVerificationError(
            f"captured step is not provably equivalent to the 3-program composition: "
            f"{cert.summary()}", [d for d in [cert.divergence] if d is not None])
    entry.certificate = cert
    c["capture_equivalence_certified"] += 1
    _emit("capture", site="captured", phase="equivalence", result="certified", mesh=None,
          ops=cert.n_ops[0], outputs=cert.outputs_compared)


def _check_captured_donation(entry: _CaptureEntry, opt, params):
    """FLAGS_check_programs >= 1, before a replay: the donation gate over the
    parameters and states the captured program writes in place (a live
    external alias changes under its holder), plus the static memory passes
    over its recording once."""
    from ..analysis import memory as _memory

    upd = [p for p in params if p.requires_grad]
    states = [opt._accumulators.get(id(p)) or {} for p in upd]
    program = entry.ir
    donated = None if program is None else tuple(
        v.vid for v in program.values.values() if v.written)
    entry.static_diags = _memory.donation_gate(
        upd, states, lambda: program, (), donated, "captured-step",
        static_diags=entry.static_diags)


def _build_capture_plan(entry: _CaptureEntry):
    """The RematPlan of a capture build (FLAGS_memory_plan='auto'), made over
    the reference 3-program step's recording against FLAGS_memory_budget_mb;
    None when it has no cuts. A failure raises (the caller counts it)."""
    from ..analysis import plan as _plan

    if entry.reference is None:
        raise RuntimeError("no 3-program step was recorded to plan over")
    budget = int(float(flags.flag("memory_budget_mb")) * (1 << 20))
    plan = _plan.build_remat_plan(entry.reference[0], budget_bytes=budget, source="capture")
    return plan if plan.has_cuts else None


def _resolve_outputs(seg: _Segment, entry: _CaptureEntry, outs):
    positions = [entry.root] + list(entry.live)
    for (i, j), v in zip(positions, entry.hand_out(outs)):
        _give(seg.ops[i].refs[j], v)
    seg.flushed = True
    _retire(seg)


def _live_besides(seg, root) -> Tuple:
    return tuple(p for p in _live_of(seg) if p != root)


def _lru_capture(key, entry):
    _capture_cache[key] = entry
    cap = int(flags.flag("eager_capture_cache_size"))
    while cap > 0 and len(_capture_cache) > cap:
        _, old = _capture_cache.popitem(last=False)
        old.release()
        _counters()["capture_evictions"] += 1


def _run_accum_microstep(seg, rv, seg_sig, bwd_key, leaves, pos, obs) -> bool:
    """An accumulate-only microstep: forward + backward (+ the add into the
    partial grad sums) as ONE captured program, run now. A failure returns
    False and the normal flush and sweep run."""
    from .. import profiler

    root = (rv._op_index, rv._out_index)
    live = _live_besides(seg, root)
    key = ("accum", seg_sig, bwd_key, pos > 0, live)
    entry = _capture_cache.get(key)
    c = _counters()
    t0 = time.perf_counter()
    try:
        fresh = entry is None
        if fresh:
            plan = tuple(_PlanOp(op) for op in seg.ops)
            entry = _CaptureEntry(plan, root, live, update=False)
            entry.seg_sig = seg_sig
            entry.akey = f"accum:{_sig_id(seg_sig)}"
            _lru_capture(key, entry)
            c["capture_accum_builds"] += 1
        else:
            _capture_cache.move_to_end(key)
        outs = _run_entry(entry, None, seg, leaves)
        if fresh:
            _register_program(entry.akey, "accum", ir_thunk=_entry_ir(entry))
    except Exception as e:  # noqa: BLE001 — the normal path runs the microstep
        _capture_cache.pop(key, None)
        if not isinstance(e, _CaptureIneligible):
            last_capture_error[0] = repr(e)
        return _no_capture(obs, e.reason if isinstance(e, _CaptureIneligible)
                           else "accum_error")
    dt = (time.perf_counter() - t0) * 1e3
    c["replay_time_ms"] += dt
    if not fresh and not entry.card:
        _note_program(entry.akey, "accum", dt)  # host clock (the card's: events)
    _tls.segment = None
    _resolve_outputs(seg, entry, outs)
    c["capture_accum_replays"] += 1
    profiler.count_program("captured")
    _emit("capture", site="captured", phase="accum_replay", pos=pos)
    obs.pos = pos + 1
    obs.events, obs.dirty = [], False
    return True


def step_capture_step(optimizer) -> bool:
    """``Optimizer.step()``'s hook: the capture controller's step boundary.
    With no deferred step this flushes what is pending and observes the
    step; with one, the whole step runs as ONE captured program (built
    first when new) and True is returned so ``step()`` skips its own
    update; anything that stops it resolves the step on the 3-program path
    and returns False."""
    from .. import profiler
    from ..resilience import faults as _faults

    rec = getattr(_tls, "capture_deferred", None)
    if rec is None:
        flush_if_pending("optimizer_step")
        if _capture_on():
            _step_boundary(optimizer)
        return False

    def fallback(reason: str) -> bool:
        _abort_capture(reason)
        flush_if_pending("optimizer_step")
        return False

    if not _capture_on():
        return fallback("capture_disabled")
    plan = _faults.active_plan()
    if plan is not None and plan.would_fire("nan", "grads", _faults.current_step()):
        return fallback("nan_injected")
    if rec.replaced:
        return fallback("grad_replaced")
    try:
        opt_fp = _opt_fingerprint(optimizer, set(rec.expected_opt_fp[-1]))
    except Exception:  # noqa: BLE001
        opt_fp = None
    if opt_fp is None or opt_fp != rec.expected_opt_fp:
        return fallback("optimizer_mismatch")
    seg = rec.segment
    root = (rec.root._op_index, rec.root._out_index)
    live = _live_besides(seg, root)
    # the fused telemetry and the memory plan change the captured program:
    # they key the cache
    key = (rec.seg_sig, rec.bwd_key, opt_fp, rec.accumulate, live,
           bool(flags.flag("telemetry")),
           (str(flags.flag("memory_plan")), float(flags.flag("memory_budget_mb")))
           if _mem_plan_on() else None,
           optimizer._offload_sched.staged_key()
           if getattr(optimizer, "_offload_sched", None) is not None else None)
    c = _counters()
    t0 = time.perf_counter()
    try:
        entry = _capture_cache.get(key)
        fresh = entry is None
        if fresh:
            entry = _build_captured_step(rec, optimizer, live)
            entry.ladder_key, entry.seg_sig = _ladder_key(rec.seg_sig), rec.seg_sig
            entry.akey = f"captured:{_sig_id(rec.seg_sig)}"
            if entry.reference is None:
                entry.reference = getattr(_tls, "reference_done", None)
            c["capture_builds"] += 1
            _emit("capture", site="captured", phase="build", background=False, mesh=None)
            _lru_capture(key, entry)
            if _mem_plan_on():
                try:
                    entry.mem_plan = _build_capture_plan(entry)
                except Exception as e:  # noqa: BLE001 — counted; the step runs 3-program
                    from ..analysis import plan as _plan

                    _plan.record_failure("capture", e)
                    raise _CaptureIneligible("memory_plan_failed")
        else:
            _capture_cache.move_to_end(key)
        # the step's own reads of the grads are not a user's: stop watching
        _tls.capture_deferred = None
        deferred_step[0] = None
        outs = _run_entry(entry, optimizer, seg, rec.leaves)
        if fresh:
            _register_program(entry.akey, "captured", ir_thunk=_entry_ir(entry),
                              donated=_donated_count(entry.ir))
    except Exception as e:  # noqa: BLE001 — the step completes on the normal path
        _tls.capture_deferred = rec
        deferred_step[0] = rec
        if not rec.accumulate:
            for t in rec.leaves:
                _set_raw_grad(t, None)
        old = _capture_cache.pop(key, None)
        if old is not None:
            old.release()
        if isinstance(e, _CaptureIneligible):
            c["capture_invalidations"] += e.reason == "param_rebound"
            return fallback(e.reason)
        from ..analysis import ProgramVerificationError

        if isinstance(e, ProgramVerificationError):
            # the step completes on the 3-program path; the verdict surfaces
            # at the end of step()
            _tls.pending_verification = e
            return fallback("verification_failed")
        last_capture_error[0] = repr(e)
        return fallback("capture_error")
    if entry.failed_proof is not None:
        # the CPU ran the step once, recorded, before its proof failed: the
        # step stands; the program is dropped and the verdict counted
        err, entry.failed_proof = entry.failed_proof, None
        _capture_cache.pop(key, None)
        entry.release()
        _tls.segment = None
        _resolve_outputs(seg, entry, outs)
        if isinstance(err, _CaptureIneligible):
            _capture_fallback(err.reason)
        else:
            _tls.pending_verification = err
            _capture_fallback("verification_failed")
        obs = _observer()
        obs.events, obs.dirty = [], False
        obs.pos = 0
        _disarm(obs)
        return True
    dt = (time.perf_counter() - t0) * 1e3
    c["replay_time_ms"] += dt
    if not fresh and not entry.card:
        _note_program(entry.akey, "captured", dt)  # host clock (the card's: events)
    _tls.last_captured = weakref.ref(entry)
    entry.opt = weakref.ref(optimizer)
    _emit("capture", site="captured", phase="replay", donated=True, mesh=None)
    _resolve_outputs(seg, entry, outs)
    c["capture_replays"] += 1
    profiler.count_program("captured")
    obs = _observer()
    obs.events, obs.dirty = [], False
    obs.pos = 0
    return True


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
def drain_async():
    """Join every background build (``paddle_tpu/core/lazy.py:100``): the
    port builds its programs on the calling thread
    (FLAGS_eager_async_compile), so there is nothing to join."""


def step_signature_id() -> Optional[int]:
    """A small id of this thread's armed step signature, or None."""
    obs = getattr(_tls, "observer", None)
    if obs is None or obs.armed is None:
        return None
    return _ladder_key(obs.armed)


def step_capture_state() -> Dict[str, Any]:
    """This thread's whole-step capture controller, for measure_programs."""
    obs = getattr(_tls, "observer", None)
    return {
        "enabled": _capture_on(),
        "armed": bool(obs is not None and obs.armed is not None),
        "stable_steps": 0 if obs is None else obs.stable,
        "deferred": getattr(_tls, "capture_deferred", None) is not None,
        "cached_steps": len(_capture_cache),
        "cycle_len": 1 if obs is None else obs.cycle_len,
        "cycle_pos": 0 if obs is None else obs.pos,
        "pending_compiles": 0,  # builds are synchronous (FLAGS_eager_async_compile)
        "cuda_graphs": sum(1 for e in _capture_cache.values() if e.graph is not None),
    }


def _later(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP, open items, queue 1 {item})")


def _last_entry() -> Optional["_CaptureEntry"]:
    ref = getattr(_tls, "last_captured", None)
    return ref() if ref is not None else None


def captured_step_program():
    """``(program, donated value ids, roles)`` of the captured whole step this
    thread replayed last, or None: its recorded IR (``analysis.Program``),
    the inputs it writes in place, and {value id: (kind, label)} of its
    parameters and optimizer states. What the memory planner, the offload
    scheduler's cold set and ``measure_programs`` read."""
    entry = _last_entry()
    if entry is None or entry.ir is None:
        return None
    program = entry.ir
    donated = tuple(v.vid for v in program.values.values() if v.written)
    roles = {}
    opt = entry.opt() if getattr(entry, "opt", None) is not None else None
    if opt is not None:
        labels, _outs = _step_labels(opt, program)
        roles = {vid: ("param" if lab.startswith("param") else "buffer",
                       lab.replace("state", "opt_state", 1)) for vid, lab in labels.items()}
    return program, donated, roles


def captured_step_certificate():
    """The ``EquivalenceCertificate`` of the captured step this thread
    replayed last, or None (no capture, or FLAGS_check_programs < 2 when it
    was built)."""
    entry = _last_entry()
    return None if entry is None else entry.certificate


class _CapturedStepHandle:
    """A stand-in for this thread's last replayed captured step: the
    analysis tools dispatch on ``_captured_step`` and read the program
    through it; the handle pins nothing."""

    _captured_step = True

    def program(self):
        """The captured step's recorded IR, or None."""
        got = captured_step_program()
        return None if got is None else got[0]

    def pool_bytes(self):
        """The bytes the captured step's graph keeps in its memory pool, or
        None (no graph: the CPU, or no capture)."""
        entry = _last_entry()
        graph = None if entry is None else entry.graph
        return None if graph is None else graph.pool_bytes()


def captured_step_handle() -> _CapturedStepHandle:
    return _CapturedStepHandle()


def captured_step_shard_info():
    """A sharded capture's mesh and specs: not ported (item 13)."""
    _later("lazy.captured_step_shard_info (sharded capture)", "item 13")


def captured_step_donation_verdicts():
    """A sharded capture's donation proofs: not ported (item 13)."""
    _later("lazy.captured_step_donation_verdicts (sharded capture)", "item 13")


def reset_lazy_state():
    """Drop this thread's pending segment, deferred step and observer, and
    every cached segment, spec and captured step (test isolation; a phase
    that frees its model first)."""
    _tls.segment = None
    _tls.capture_deferred = None
    deferred_step[0] = None
    _tls.observer = None
    _tls.last_captured = None
    ref = getattr(_tls, "reference", None)
    if ref is not None and ref[0] == "open":
        ref[1].__exit__(None, None, None)
    _tls.reference = _tls.reference_done = None
    _tls.pending_verification = None
    _segment_cache.clear()
    _spec_cache.clear()
    _layer_tokens.clear()
    for e in _capture_cache.values():
        e.release()
    _capture_cache.clear()
    _higher_order[0] = False


_serve_cache: "OrderedDict[Tuple, _ServeProgram]" = OrderedDict()
# one memory pool for every serve graph on a device: the graphs run one
# after another on one stream and nothing of one graph is live when another
# replays (their outputs are read before the next step), so they can share
# it instead of each keeping a private pool. Each entry is [pool handle,
# live graphs]: once its last graph is reset, the caching allocator refuses
# a new capture into that pool until its memory is returned, so the next
# capture starts a new pool
_graph_pools: Dict[torch.device, list] = {}


def stage_feeds(feeds, device):
    """The host feed tensors on ``device`` in one copy (views of one buffer)."""
    if device.type != "cuda":
        return tuple(feeds)
    flat = torch.cat([f.reshape(-1) for f in feeds]).to(device)
    return _views(flat, feeds)


def _views(flat, feeds):
    out, at = [], 0
    for f in feeds:
        out.append(flat[at:at + f.numel()].view(f.shape))
        at += f.numel()
    return tuple(out)


class _ServeProgram:
    """One captured serving program (a prefill or decode bucket signature)."""

    __slots__ = ("key", "fn", "_built_donate", "_built_plain", "_graph", "_host", "_dev",
                 "_inputs", "_out", "ir", "certificate", "_plain_run")

    def __init__(self, key, fn):
        self.key = key
        self.fn = fn
        self.ir = None  # the IR recorded at the capture (the first run on the CPU)
        self.certificate = None  # the rungs' EquivalenceCertificate (FLAGS_check_programs=2)
        self._plain_run = None  # the CPU's first run, kept for the certificate
        self._built_donate = False
        self._built_plain = False
        self._graph = None
        self._host = self._dev = self._inputs = self._out = None

    def built(self, donate: bool = True) -> bool:
        return self._built_donate if donate else self._built_plain

    def run(self, args, donate: bool = True):
        """Run the program (building it on first use): ``donate=True`` is
        the captured rung, ``donate=False`` the retained one."""
        from .. import profiler

        k_pools, v_pools, feeds = args[0], args[1], args[2:]
        fresh = not self.built(donate)
        if donate:
            out = self._captured(k_pools, v_pools, feeds)
            self._built_donate = True
        else:
            out = self._retained(k_pools, v_pools, feeds)
            self._built_plain = True
        profiler.count("serve_capture_builds" if fresh else "serve_capture_replays")
        if fresh:
            _emit("serve_capture", site="captured", phase="build", key=str(self.key),
                  donated=bool(donate))
        return out

    def _captured(self, k_pools, v_pools, feeds):
        device = k_pools[0].device
        if device.type != "cuda":
            if self.ir is None:
                with _recording("serve") as rec:
                    out = self.fn(k_pools, v_pools, *feeds)
                self.ir = rec.program
                if int(flags.flag("check_programs")) >= 2:
                    self._plain_run = (k_pools, v_pools, feeds, out)
                return out
            if self.certificate is None and int(flags.flag("check_programs")) >= 2 \
                    and self._plain_run is not None:
                # the CPU's rungs are one function in place: its first two runs
                # are the two recordings the certificate compares
                with _recording("serve") as rec:
                    out = self.fn(k_pools, v_pools, *feeds)
                self._certify_rungs(rec.program, (k_pools, v_pools, feeds, out),
                                    self.ir, self._plain_run)
                return out
            return self.fn(k_pools, v_pools, *feeds)
        if self._graph is None:
            self._capture(k_pools, v_pools, feeds, device)
        else:
            self._load(feeds)
        self._graph.replay()
        return (k_pools, v_pools) + self._out

    def _load(self, feeds):
        # the pinned buffer is free to overwrite: the caller read the last
        # step's output, which waited for that step's copy
        torch.cat([f.reshape(-1) for f in feeds], out=self._host)
        self._dev.copy_(self._host, non_blocking=True)

    def _capture(self, k_pools, v_pools, feeds, device):
        n = sum(f.numel() for f in feeds)
        self._host = torch.empty(n, dtype=torch.int64, pin_memory=True)
        self._dev = torch.empty(n, dtype=torch.int64, device=device)
        self._inputs = _views(self._dev, feeds)
        self._load(feeds)
        # the warm-up writes the chunk's K/V at lens..lens+s-1, the same
        # values at the same places the replay below writes, so running the
        # step twice is harmless
        check = int(flags.flag("check_programs")) >= 2
        with _recording("serve-plain") if check else contextlib.nullcontext() as plain:
            warm = cuda_graphs.warm_up(device, self.fn, k_pools, v_pools, *self._inputs)
        pool = _graph_pools.get(device)
        if pool is None:
            pool = _graph_pools[device] = [torch.cuda.graph_pool_handle(), 0]
        graph = cuda_graphs.Graph(device)
        try:
            # the recording inside the capture: the graph's own set-up (its
            # generator registration) is not the program's
            with graph.capture(pool[0]), _recording("serve") as rec:
                _, _, row, nxt = self.fn(k_pools, v_pools, *self._inputs)
            self.ir = rec.program
            if check:  # before the first replay: the warm-up's run and the capture's
                self._certify_rungs(rec.program, (k_pools, v_pools, [self._dev],
                                                  (None, None, row, nxt)),
                                    plain.program, (k_pools, v_pools, [self._dev], warm))
        except BaseException:
            if not pool[1]:
                del _graph_pools[device]
            raise
        self._graph, self._out = graph, (row, nxt)
        pool[1] += 1

    def _certify_rungs(self, captured, cap_io, plain, plain_io):
        """FLAGS_check_programs=2, once per program: the captured rung's
        recording against a plain run's (on the card the warm-up's, on the
        CPU the first run's), over the pools it writes and the row and token
        it returns. Divergent raises ``ProgramVerificationError``."""
        from .. import profiler
        from ..analysis import ProgramVerificationError
        from ..analysis import equivalence as _eq

        def io(program, run):
            k_pools, v_pools, feeds, out = run
            named = [(f"k_pool{i}", t) for i, t in enumerate(k_pools)]
            named += [(f"v_pool{i}", t) for i, t in enumerate(v_pools)]
            named += [(f"feed{i}", t) for i, t in enumerate(feeds)]
            labels = {}
            for label, t in named:
                vid = program.value_of(t)
                if vid is not None and program.values[vid].producer < 0:
                    labels.setdefault(vid, label)
            outs = [program.value_of(t) for t in list(k_pools) + list(v_pools)]
            outs += [program.value_of(t) for t in out[2:]]
            return labels, outs

        profiler.count("serve_equivalence_checks")
        la, oa = io(captured, cap_io)
        lb, ob = io(plain, plain_io)
        cert = _eq.prove_equivalent(captured, plain, label_a="serve-donated",
                                    label_b="serve-plain", source="serve", labels_a=la,
                                    labels_b=lb, outputs_a=oa, outputs_b=ob)
        if not cert.equivalent:
            profiler.count("serve_equivalence_divergences")
            raise ProgramVerificationError(
                f"serving program {self.key} rungs diverge: {cert.summary()}",
                [d for d in [cert.divergence] if d is not None])
        self.certificate = cert
        profiler.count("serve_equivalence_certified")
        self._plain_run = None

    def _retained(self, k_pools, v_pools, feeds):
        device = k_pools[0].device
        k_copy = tuple(t.clone() for t in k_pools)
        v_copy = tuple(t.clone() for t in v_pools)
        _, _, row, nxt = self.fn(k_copy, v_copy, *stage_feeds(feeds, device))
        for dst, src in zip(k_pools + v_pools, k_copy + v_copy):
            dst.copy_(src)
        return k_pools, v_pools, row, nxt

    def release(self):
        """Drop the graph and its buffers (eviction, engine close)."""
        if self._graph is not None:
            self._graph.reset()
            pool = _graph_pools[self._dev.device]
            pool[1] -= 1
            if not pool[1]:
                del _graph_pools[self._dev.device]
        self._graph = self._host = self._dev = self._inputs = self._out = None


def serve_program(key: Tuple, fn: Callable) -> _ServeProgram:
    """The decode-mode capture cache: one ``_ServeProgram`` per bucket
    signature, LRU-bounded by FLAGS_serving_capture_cache_size. A re-used
    key returns the cached handle with its graph intact, so a steady-state
    decode loop replays without re-capturing — verified by the
    serve_capture_builds counter staying flat."""
    from .. import profiler

    prog = _serve_cache.get(key)
    if prog is not None:
        _serve_cache.move_to_end(key)
        return prog
    prog = _ServeProgram(key, fn)
    _serve_cache[key] = prog
    cap = int(flags.flag("serving_capture_cache_size"))
    while cap > 0 and len(_serve_cache) > cap:
        _, old = _serve_cache.popitem(last=False)
        old.release()
        profiler.count("serve_capture_evictions")
    return prog


def serve_program_if_cached(key: Tuple) -> Optional[_ServeProgram]:
    """The cached program of ``key`` (no LRU touch), or None."""
    return _serve_cache.get(key)


def reset_serve_programs(owner=None):
    """Drop captured serving programs: all of them (test isolation), or —
    with ``owner`` set — only the ones whose key belongs to that engine uid
    (``Engine.close()``: a closed engine's step functions hold the model)."""
    for key in [k for k in _serve_cache
                if owner is None or (len(k) > 1 and k[1] == owner)]:
        _serve_cache.pop(key).release()


def serve_capture_state() -> Dict[str, Any]:
    """Snapshot of the decode-mode capture cache (the engine's stats read
    this). ``cuda_graphs`` counts the programs captured as a CUDA graph."""
    return {
        "cached_programs": len(_serve_cache),
        "built_programs": sum(
            1 for p in _serve_cache.values()
            if p._built_donate or p._built_plain
        ),
        "cuda_graphs": sum(1 for p in _serve_cache.values() if p._graph is not None),
    }
