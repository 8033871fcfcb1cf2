"""Op application, grad mode and the backward: the Paddle semantics of
``paddle_tpu/core/dispatch.py`` over torch's eager autograd.

torch runs each op eagerly and records its own tape, so the JAX
dispatcher's per-op compile caches and its GradNode engine have no
counterpart here. What stays is what a user sees: ``apply`` unwraps
Tensors, runs the op and wraps what it returns, under the
``stop_gradient`` rule (an output stops gradient when every differentiable
input does; integer and bool outputs always do); the grad-mode switches;
``run_backward`` and ``run_grad`` with the JAX engine's checks (gradients
accumulate, a non-scalar root without a gradient raises, a second backward
without ``retain_graph`` raises, ``create_graph`` records the backward);
and the
``FLAGS_check_nan_inf`` scan of every op's outputs.

It is also the eager dispatcher's front (``paddle_tpu/core/dispatch.py:688-715,
1065-1085``): the OUTERMOST Paddle-level call with Tensor arguments (an
``apply``, an ``nn.Layer`` call, a functional through ``accepts_tensors``)
counts one op program, or is deferred onto the pending lazy segment under
FLAGS_eager_lazy_dispatch (``core/lazy.py``). Calls nested inside it run
at once and count nothing. ``run_backward`` is the whole-step capture's
backward hook and counts one backward program per sweep.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional, Sequence

import torch

from . import flags
from . import lazy as _lazy
from .lazy import LazyRef

# how deep this thread is inside a Paddle-level call: only depth 0 counts a
# program or defers
_tls = threading.local()


def _depth() -> int:
    return getattr(_tls, "depth", 0)


def _set_depth(d: int):
    _tls.depth = d


# read on every Paddle-level call (set_flags writes these dicts in place)
_LAZY = flags.entry("eager_lazy_dispatch")
_NAN_CHECK = flags.entry("check_nan_inf")
_profiler: list = []  # the profiler module, imported at the first count


def _count_op():
    if not _profiler:
        from .. import profiler

        _profiler.append(profiler)
    c = _profiler[0]._counters
    c["op_programs"] += 1
    c["programs"] += 1


_tensor_api: tuple = ()  # (Tensor, _wrap) of core/tensor.py, which imports this module


def _load_tensor_api() -> tuple:
    global _tensor_api
    from .tensor import Tensor, _wrap

    _tensor_api = (Tensor, _wrap)
    return _tensor_api


def _tensor_cls():
    return (_tensor_api or _load_tensor_api())[0]


def apply(fn: Callable, *args, differentiable: bool = True, **kwargs):
    """Run ``fn`` on the torch values of Tensor ``args`` (other arguments as
    they are) and wrap its torch results as Tensors; a tuple or list of
    results comes back as a list. ``differentiable=False`` runs it without
    recording."""
    Tensor, _wrap = _tensor_api or _load_tensor_api()
    depth = getattr(_tls, "depth", 0)
    if not depth:
        if _LAZY["value"]:
            out = _lazy.record(fn, _lazy._fn_key(fn), args, kwargs,
                               differentiable and torch.is_grad_enabled(), True)
            if out is not _lazy.FALLBACK:
                return out
            _lazy.observe_op_program()
        _count_op()
    _tls.depth = depth + 1
    try:
        vals = [(a._v if type(a._v) is not LazyRef else a._value) if isinstance(a, Tensor)
                else a for a in args]
        if differentiable:
            out = fn(*vals, **kwargs)
        else:
            with torch.no_grad():
                out = fn(*vals, **kwargs)
    finally:
        _tls.depth = depth
    if _NAN_CHECK["value"]:
        _check_nan_inf(getattr(fn, "__name__", "op"), out)
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    return [_wrap(o) if isinstance(o, torch.Tensor) else o for o in out]


def tensor_call(key, fn, args, kwargs, module=None):
    """``fn`` (a function of torch tensors) called with arguments that hold
    Tensors: the outermost such call counts one op program, or is deferred
    under lazy dispatch (``key`` is its op key, ``module`` the layer it
    calls); the Tensors are unwrapped (no copy) and the results wrapped."""
    depth = getattr(_tls, "depth", 0)
    if not depth:
        if _LAZY["value"]:
            out = _lazy.record(fn, key, args, kwargs, torch.is_grad_enabled(), False, module)
            if out is not _lazy.FALLBACK:
                return out
            _lazy.observe_op_program()
        _count_op()
    _tls.depth = depth + 1
    try:
        return wrap(fn(*unwrap(args), **{k: unwrap(v) for k, v in kwargs.items()}))
    finally:
        _tls.depth = depth


def wrap(out):
    """Torch results as Tensors, through tuples (named ones too), lists and dicts."""
    from .tensor import _wrap

    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if isinstance(out, tuple) and hasattr(out, "_fields"):  # a namedtuple
        return type(out)(*(wrap(o) for o in out))
    if isinstance(out, (tuple, list)):
        return type(out)(wrap(o) for o in out)
    if isinstance(out, dict):
        return type(out)((k, wrap(v)) for k, v in out.items())
    return out


def unwrap(x):
    """Tensors as their torch values, through tuples (named ones too), lists and
    dicts (no copy)."""
    if isinstance(x, _tensor_cls()):
        return x._value
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a namedtuple
        return type(x)(*(unwrap(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(unwrap(v) for v in x)
    if isinstance(x, dict):
        return type(x)((k, unwrap(v)) for k, v in x.items())
    return x


def holds_tensor(args, kwargs) -> bool:
    """Whether a Tensor is among ``args`` or the values of ``kwargs``, or
    inside a tuple, list or dict among them."""
    T = _tensor_cls()
    return _holds(args, T) or _holds(kwargs.values(), T)


def _holds(values, T) -> bool:
    for a in values:
        if isinstance(a, T):
            return True
        if isinstance(a, (tuple, list)) and _holds(a, T):
            return True
        if isinstance(a, dict) and _holds(a.values(), T):
            return True
    return False


def accepts_tensors(fn):
    """Let a function of torch tensors take Paddle Tensors: when an argument
    is one or holds one (in a tuple, list or dict), the arguments are
    unwrapped (no copy) and the results wrapped. Calls with torch tensors go
    straight through."""
    key = _lazy._fn_key(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not holds_tensor(args, kwargs):
            return fn(*args, **kwargs)
        return tensor_call(key, fn, args, kwargs)

    return wrapper


def _check_nan_inf(op_name, out):
    """FLAGS_check_nan_inf debug scan — reference: framework/operator.cc:1258."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for i, o in enumerate(outs):
        if isinstance(o, torch.Tensor) and (o.is_floating_point() or o.is_complex()):
            if not bool(torch.isfinite(o).all()):
                raise FloatingPointError(f"NaN/Inf detected in output {i} of op '{op_name}'")


# ---------------------------------------------------------------------------
# grad mode: torch's, behind Paddle's switches (paddle.no_grad is a context
# manager and a decorator, with or without parentheses)
# ---------------------------------------------------------------------------
def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradModeCtx:
    def __init__(self, mode: bool):
        self._mode = bool(mode)

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, func=None):
        if func is None:
            return self

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with _GradModeCtx(self._mode):
                return func(*args, **kwargs)

        return wrapper


def no_grad(func=None):
    ctx = _GradModeCtx(False)
    return ctx(func) if func is not None else ctx


def enable_grad(func=None):
    ctx = _GradModeCtx(True)
    return ctx(func) if func is not None else ctx


class set_grad_enabled(_GradModeCtx):
    """Set the grad mode now; as a context manager, restore the previous
    mode on exit."""

    def __init__(self, mode: bool):
        super().__init__(mode)
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)

    def __enter__(self):
        return self


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def _torch_of(x):
    return x._value if isinstance(x, _tensor_cls()) else x


@contextlib.contextmanager
def _attached_hooks(block=()):
    """Attach the hooks kept on cells (``Tensor.register_hook``) to their
    current values for one backward, and a hook that zeroes the gradient
    through each tensor of ``block``."""
    from .tensor import _hooked, _wrap

    handles = []
    try:
        for cell in list(_hooked):
            v = cell._value
            if not v.requires_grad:
                continue
            for hook in cell._hooks:
                def run(g, hook=hook):
                    out = hook(_wrap(g))
                    return None if out is None else _torch_of(out)

                handles.append(v.register_hook(run))
        for t in block:
            v = _torch_of(t)
            if v.requires_grad:
                handles.append(v.register_hook(torch.zeros_like))
        yield
    finally:
        for h in handles:
            h.remove()


def run_backward(tensors: Sequence, grad_tensors: Optional[Sequence] = None,
                 retain_graph: bool = False):
    """Accumulate the gradients of ``tensors`` (seeded by ``grad_tensors``,
    ones for a scalar) into the ``grad`` of every trainable leaf they reach.

    A root that stops gradient contributes nothing, as in the JAX engine;
    torch raises for a non-scalar root without a gradient and for a second
    backward through a graph not retained."""
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    key = None
    if flags.flag("eager_lazy_dispatch") and len(tensors) == 1 and not retain_graph \
            and grad_tensors[0] is None:
        if _lazy.step_capture_backward(tensors[0]):
            return
        key = _lazy.backward_key(tensors[0])
    _lazy.flush_if_pending("backward")
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        v = _torch_of(t)
        if not v.requires_grad:
            continue
        roots.append(v)
        seeds.append(None if g is None else _torch_of(g))
    if roots:
        _sweep(roots, seeds, retain_graph)
    if flags.flag("eager_lazy_dispatch"):
        _lazy.observe_backward(key)


def _sweep(roots, seeds, retain_graph):
    """One backward sweep (a backward program) with the cells' hooks on."""
    from .. import profiler

    with _attached_hooks():
        torch.autograd.backward(roots, seeds, retain_graph=retain_graph)
    profiler.count_program("backward")


def run_grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
             allow_unused=False, no_grad_vars=()):
    """The gradients of ``outputs`` with respect to ``inputs`` (torch values),
    without touching any ``grad``; None for an input the outputs do not
    reach. ``retain_graph`` defaults to ``create_graph``."""
    if retain_graph is None:
        retain_graph = create_graph
    _lazy.flush_if_pending("backward")
    if create_graph:
        _lazy._higher_order[0] = True
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    pairs = [(_torch_of(o), None if g is None else _torch_of(g))
             for o, g in zip(outputs, grad_outputs)]
    pairs = [(o, g) for o, g in pairs if o.requires_grad]
    want = [i for i, t in enumerate(inputs) if _torch_of(t).requires_grad]
    got = [None] * len(inputs)
    if pairs and want:
        from .. import profiler

        with _attached_hooks(no_grad_vars or ()):
            res = torch.autograd.grad(
                [o for o, _ in pairs], [_torch_of(inputs[i]) for i in want],
                grad_outputs=[g for _, g in pairs], retain_graph=bool(retain_graph),
                create_graph=create_graph, allow_unused=True)
        profiler.count_program("backward")
        for i, g in zip(want, res):
            got[i] = g
    if not allow_unused and any(g is None for g in got):
        raise RuntimeError("one of the input tensors received no gradient "
                           "(pass allow_unused=True to return None for it)")
    return got
