"""``paddle.Tensor`` of the port: a mutable cell over a ``torch.Tensor``.

The counterpart of ``paddle_tpu/core/tensor.py:48``, a mutable cell over an
immutable ``jax.Array``. Here the cell holds a ``torch.Tensor`` in
``_value`` and autograd runs on torch's own tape. The class does not
subclass ``torch.Tensor`` and patches nothing onto it: Paddle's names
(``shape`` a list, ``size`` a property, ``reshape([0, -1])``,
``transpose(perm)``, ``max`` returning values, ``split(num_or_sections,
axis)``, ``dtype`` a Paddle ``DType``) would otherwise stand in front of
torch's own, which torch and the port's modules call.

The cell gives the JAX package's mutation semantics. An in-place Paddle op
(``set_value``, ``fill_``, ``__setitem__``, the ``*_`` functions of
``tensor_api``) computes an out-of-place result and rebinds ``_value`` to
it, bumping ``_inplace_version``: a view taken earlier is never changed
behind the user's back, and autograd history is never broken.

``stop_gradient`` is ``not _value.requires_grad``. Setting it on a leaf
toggles ``requires_grad_``; setting it True on a non-leaf detaches. An op's
output stops gradient when every differentiable input does; integer and
bool outputs always do (their cells keep the flag themselves, as torch
tracks no gradient for them). A trainable leaf rebound by an in-place op
keeps receiving its gradient in ``grad``, as the JAX cell does. Hooks are
kept on the cell, so they survive a rebind, and are attached to ``_value``
for the duration of each backward (``dispatch.run_backward``).

Under lazy dispatch (``core/lazy.py``) a cell may hold a ``LazyRef``, the
pending output of a deferred op: ``shape``, ``ndim``, ``size``, ``dtype``,
``place`` and ``stop_gradient`` answer from its spec without running
anything; every other read of ``_value`` (``numpy``, ``item``, ``float``,
``bool``, ...) flushes the pending segment and holds the result from then
on. While a whole training step is deferred between ``backward()`` and
``optimizer.step()``, reading or writing the ``grad`` of one of its leaves
(a cell, or a port ``Parameter``) is seen by the capture controller.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from . import dispatch
from . import lazy as _lazy
from .dtype import DType, get_default_dtype, to_paddle_dtype, to_torch_dtype
from .lazy import LazyRef
from .place import Place, place_of, torch_device

# cells that hold hooks; dispatch attaches them around each backward
_hooked: "weakref.WeakSet[Tensor]" = weakref.WeakSet()


def _differentiable(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


def _from_numpy(arr: np.ndarray, dtype, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes: torch reads its bits
        out = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
        return out.to(device=device, dtype=dtype or torch.bfloat16, copy=True)
    return torch.tensor(arr, dtype=dtype, device=device)


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    """A host copy of ``v`` (never a view of the cell's storage)."""
    host = v.detach().cpu().resolve_conj().resolve_neg()
    if host.dtype == torch.bfloat16:
        import ml_dtypes

        arr = host.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    else:
        arr = host.numpy()
    return arr.copy() if v.device.type == "cpu" else arr


class Tensor:
    """Mutable eager tensor over a ``torch.Tensor``."""

    __slots__ = ("_v", "_stop", "_inplace_version", "__weakref__", "__dict__")

    # rarely set; kept out of the slots so a new cell assigns three fields
    name = ""
    persistable = False
    _hooks = ()
    _leaf = None  # a trainable leaf this cell held before an in-place rebind
    _grad_cell = None

    def __init__(self, value, dtype=None, place: Optional[Place] = None,
                 stop_gradient: bool = True, name: Optional[str] = None):
        tdt = None if dtype is None else to_torch_dtype(dtype)
        if isinstance(value, Tensor):
            value = value._value
        if isinstance(value, torch.Tensor):
            if tdt is not None and value.dtype != tdt:
                value = value.to(tdt)
            if place is not None:
                value = value.to(torch_device(place))
        else:
            from_ndarray = isinstance(value, (np.ndarray, np.generic))
            arr = np.asarray(value)
            if tdt is None and not from_ndarray and arr.dtype == np.float64:
                # Python floats take the default dtype; numpy float64 keeps it
                tdt = to_torch_dtype(get_default_dtype())
            value = _from_numpy(arr, tdt, torch_device(place))
        self._value = value
        self._stop = True
        self._inplace_version = 0
        if name:
            self.name = name
        if not stop_gradient:
            self.stop_gradient = False

    @property
    def _value(self) -> torch.Tensor:
        """The torch value; a pending one is computed first (a flush)."""
        v = self._v
        if type(v) is LazyRef:
            v = self._v = v.materialize()
        return v

    @_value.setter
    def _value(self, value):
        self._v = value

    # -- meta (a pending value answers from its spec) --------------------------
    @property
    def shape(self):
        return list(self._v.shape)

    @property
    def ndim(self):
        return len(self._v.shape)

    dim = ndim

    @property
    def size(self):
        return self._v.numel()

    @property
    def dtype(self) -> DType:
        return to_paddle_dtype(self._v.dtype)

    @property
    def place(self) -> Place:
        return place_of(self._v.device)

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    @property
    def _grad_node(self):
        return self._value.grad_fn

    # -- autograd state -------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        v = self._v
        if v.requires_grad:
            return False
        return True if _differentiable(v) else self._stop

    @stop_gradient.setter
    def stop_gradient(self, flag):
        flag = bool(flag)
        v = self._value
        if not _differentiable(v):
            self._stop = flag
        elif v.grad_fn is None:
            v.requires_grad_(not flag)
        elif flag:
            self._value = v.detach()
            self._leaf = None

    def _grad_holder(self) -> torch.Tensor:
        return self._value if self._leaf is None else self._leaf

    @property
    def grad(self):
        if _lazy.deferred_step[0] is not None:
            _lazy.on_grad_access(self._grad_holder(), None, False)
        g = self._grad_holder().grad
        if g is None:
            return None
        cell = self._grad_cell
        if cell is None or cell._value is not g:
            cell = self._grad_cell = _wrap(g)
        return cell

    @grad.setter
    def grad(self, value):
        value = None if value is None else _unwrap(value)
        if _lazy.deferred_step[0] is not None and _lazy.on_grad_access(
                self._grad_holder(), value, True):
            return
        self._grad_holder().grad = value

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        dispatch.run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def register_hook(self, hook):
        """``hook(grad)`` when this cell's gradient is computed; a Tensor it
        returns replaces the gradient. Returns a handle with ``remove()``."""
        if not self._hooks:
            self._hooks = []
        self._hooks.append(hook)
        _hooked.add(self)
        cell = self

        class _Handle:
            def remove(_self):
                if hook in cell._hooks:
                    cell._hooks.remove(hook)

        return _Handle()

    # -- conversion -----------------------------------------------------------
    def numpy(self):
        return _to_numpy(self._value)

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of a Tensor with more than one element is ambiguous")
        return bool(self.item())

    def __index__(self):
        return int(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._v.shape[0]

    def __iter__(self):
        if self.ndim == 0:
            raise TypeError("iteration over a 0-d Tensor")
        return (self[i] for i in range(self._value.shape[0]))

    def __repr__(self):
        return (
            f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
            f"place={self.place.device_type}, stop_gradient={self.stop_gradient},\n"
            f"       {np.array2string(np.asarray(self.numpy()), prefix='       ')})"
        )

    # -- copies -------------------------------------------------------------
    def detach(self) -> "Tensor":
        t = _wrap(self._value.detach())
        t._inplace_version = self._inplace_version
        if self.name:
            t.name = self.name
        return t

    def detach_(self):
        self._value = self._value.detach()
        self._leaf = None
        self._stop = True
        return self

    def clone(self) -> "Tensor":
        return dispatch.apply(torch.clone, self)

    def astype(self, dtype):
        tdt = to_torch_dtype(dtype)
        return dispatch.apply(lambda v: v.to(tdt), self)

    cast = astype

    # -- mutation (in-place rebinds) -----------------------------------------
    def _rebind(self, new: torch.Tensor):
        """Hold ``new`` in place of ``_value``: the in-place step of every
        ``*_`` op. A trainable leaf stays trainable: rebound to a result of
        its own op it keeps its gradient there (``_leaf``); rebound to a
        value made without autograd it becomes that leaf, grad and all."""
        old = self._value
        if old.requires_grad and old.grad_fn is None and new is not old:
            if new.grad_fn is None:
                new = new.detach().requires_grad_(True)
                if old.grad is not None and old.grad.shape == new.shape:
                    new.grad = old.grad
            elif self._leaf is None:
                self._leaf = old
        self._value = new
        self._inplace_version += 1
        return self

    def set_value(self, value):
        """Rebind to ``value``'s data (cast to this dtype and device), keeping
        identity (optimizer.step / load_state_dict)."""
        v = self._value
        if isinstance(value, Tensor):
            new = value._value
        elif isinstance(value, torch.Tensor):
            new = value
        else:
            new = _from_numpy(np.asarray(value), v.dtype, v.device)
        if tuple(new.shape) != tuple(v.shape):
            raise ValueError(f"set_value shape mismatch: {list(new.shape)} vs {list(v.shape)}")
        return self._rebind(new.detach().to(device=v.device, dtype=v.dtype))

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def fill_(self, value):
        return self._rebind(torch.full_like(self._value.detach(), value))

    def zero_(self):
        return self.fill_(0)

    def __setitem__(self, idx, value):
        v = self._value
        idx = _index(idx, v)
        val = value._value if isinstance(value, Tensor) else value
        if isinstance(val, torch.Tensor):
            val = val.to(device=v.device, dtype=v.dtype)
        elif not isinstance(val, (int, float, bool)):
            val = _from_numpy(np.asarray(val), v.dtype, v.device)
        new = v.clone()
        if idx[1]:
            new = new.flip(idx[1])
            new[idx[0]] = val
            new = new.flip(idx[1])
        else:
            new[idx[0]] = val
        self._rebind(new)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)) and not isinstance(idx, (bool, np.bool_)):
            n = self._value.shape[0] if self._value.dim() else 0
            if not -n <= idx < n:
                raise IndexError(f"index {idx} is out of bounds for axis 0 with size {n}")
        key, flips = _index(idx, self._value)
        if flips:
            return dispatch.apply(lambda v: v.flip(flips)[key], self)
        return dispatch.apply(lambda v: v[key], self)

    # -- devices --------------------------------------------------------------
    def _moved(self, device):
        t = _wrap(self._value.detach().to(device))
        t.stop_gradient = self.stop_gradient
        return t

    def cpu(self):
        return self._moved(torch.device("cpu"))

    def cuda(self, device_id=None, blocking=True):
        return self._moved(torch.device("cuda", device_id or 0))

    def pin_memory(self):
        return self

    def element_size(self) -> int:
        return self._value.element_size()

    def ndimension(self) -> int:
        return self._value.dim()

    def is_contiguous(self) -> bool:
        return True  # the cell's value is never written through: strides are private

    def contiguous(self):
        return self

    def to(self, *args, **kwargs):
        device = kwargs.get("device")
        dtype = kwargs.get("dtype")
        for a in args:
            if isinstance(a, DType) or isinstance(a, torch.dtype):
                dtype = a
            elif isinstance(a, str):
                try:
                    to_paddle_dtype(a)
                except ValueError:
                    device = a
                else:
                    dtype = a
            elif isinstance(a, (Place, torch.device)):
                device = a
        out = self if dtype is None else self.astype(dtype)
        if device is not None:
            out = out._moved(torch_device(device))
        return out


class _Shape(tuple):
    """A parameter's shape: a tuple of ints, as ``torch.Size`` is (which
    cannot be subclassed), that also equals the list of the same sizes, as a
    Paddle shape does."""

    __slots__ = ()

    def __eq__(self, other):
        if isinstance(other, list):
            return list(self) == other
        return tuple.__eq__(self, other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__


_param_count = [0]  # the process-wide counter of Paddle parameter names


def _next_param_name() -> str:
    _param_count[0] += 1
    return f"param_{_param_count[0]}"


class Parameter(torch.nn.Parameter):
    """The port's ``paddle.nn.Parameter`` (``paddle_tpu/nn/layer_base.py:38``):
    a ``torch.nn.Parameter``, so torch modules register it and autograd and
    the optimizers use it as they use any leaf, with Paddle's surface over
    it.

    ``Parameter(value, requires_grad=True, name=None, trainable=None)``
    takes a torch tensor, a Paddle Tensor or anything numpy takes (on the
    current device); ``trainable``, where given, sets ``requires_grad``, as
    the JAX ``Parameter(value, trainable, name)``'s does. It names itself
    ``param_<n>`` unless ``name`` is given. ``stop_gradient`` and
    ``trainable`` read and set ``requires_grad``: a frozen parameter gets no
    gradient, the optimizers skip it, and the lazy layer keys and captured
    steps see the change. ``name`` is the Paddle name (also ``param_name``);
    ``shape`` a tuple that equals the list of its sizes; ``numpy()``,
    ``set_value()`` (in place, so a captured graph stays valid), ``astype()``
    (a Paddle Tensor on the tape), ``place`` and ``gradient`` as a Tensor
    has them.

    ``grad`` stays torch's tensor (torch's clips and the port's optimizers
    read it); the capture controller sees it: while a training step is
    deferred between ``backward()`` and ``optimizer.step()``, reading the
    grad of one of its leaves resolves the step on the 3-program path first,
    and writing one is remembered and honoured by ``step()``, as the JAX
    package's placeholder grads are. Autograd itself writes the grad in C++
    and is not slowed down."""

    def __new__(cls, data=None, requires_grad=True, name=None, trainable=None):
        if isinstance(data, Tensor):
            data = data._value.detach()
        elif data is not None and not isinstance(data, torch.Tensor):
            data = _from_numpy(np.asarray(data), None, torch_device(None))
        elif data is not None and type(data) is not torch.Tensor:
            data = data.detach()
        if trainable is not None:
            requires_grad = bool(trainable)
        param = super().__new__(cls, data, requires_grad)
        param.param_name = name or _next_param_name()
        return param

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad, self.name)
        memo[id(self)] = out
        return out

    @property
    def grad(self):
        if _lazy.deferred_step[0] is not None:
            _lazy.on_grad_access(self, None, False)
        return _lazy._raw_grad(self)

    @grad.setter
    def grad(self, value):
        value = _unwrap(value)
        if _lazy.deferred_step[0] is not None and _lazy.on_grad_access(self, value, True):
            return
        _lazy._set_raw_grad(self, value)

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, flag):
        self.requires_grad_(not flag)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, flag):
        self.requires_grad_(bool(flag))

    @property
    def name(self):
        return self.__dict__.get("param_name")

    @name.setter
    def name(self, value):
        self.param_name = value

    @property
    def shape(self) -> _Shape:
        return _Shape(self.size())

    @property
    def place(self) -> Place:
        return place_of(self.device)

    @property
    def gradient(self):
        g = _lazy._raw_grad(self)
        return None if g is None else _to_numpy(g)

    def numpy(self):
        return _to_numpy(self)

    def set_value(self, value):
        """Copy ``value`` (a Tensor, a torch tensor or anything numpy takes)
        into this parameter in place, cast to its dtype and device; another
        shape raises ValueError."""
        src = _unwrap(value)
        if not isinstance(src, torch.Tensor):
            src = _from_numpy(np.asarray(src), self.dtype, self.device)
        if tuple(src.shape) != tuple(self.size()):
            raise ValueError(f"set_value shape mismatch: {list(src.shape)} vs {list(self.size())}")
        with torch.no_grad():
            self.copy_(src)
        return self

    def astype(self, dtype):
        tdt = to_torch_dtype(dtype)
        return dispatch.apply(lambda v: v.to(tdt), self, op_name="cast")

    cast = astype


def _wrap(value: torch.Tensor) -> Tensor:
    """A new cell over ``value`` (no copy)."""
    t = object.__new__(Tensor)
    t._v = value
    t._stop = True
    t._inplace_version = 0
    return t


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def _index_entry(e, device):
    if isinstance(e, Tensor):
        return e._value
    if isinstance(e, list):
        return torch.as_tensor(np.asarray(e), device=device)
    if isinstance(e, np.ndarray):
        return torch.as_tensor(e, device=device)
    return e


def _index(idx, v: torch.Tensor):
    """``idx`` as torch indexes it, and the axes to flip first: torch slices
    take no negative step, so ``a:b:-s`` becomes a positive slice of the
    axis flipped."""
    entries = idx if isinstance(idx, tuple) else (idx,)
    entries = [_index_entry(e, v.device) for e in entries]
    if not any(isinstance(e, slice) and e.step is not None and e.step < 0 for e in entries):
        return (tuple(entries) if isinstance(idx, tuple) else entries[0]), ()
    # the axis each entry indexes (None adds one, Ellipsis stands for the rest)
    used = sum(e.dim() if isinstance(e, torch.Tensor) and e.dtype == torch.bool else 1
               for e in entries if e is not None and e is not Ellipsis)
    ax, flips, out = 0, [], []
    for e in entries:
        if e is None:
            out.append(e)
            continue
        if e is Ellipsis:
            out.append(e)
            ax += v.dim() - used
            continue
        if isinstance(e, slice) and e.step is not None and e.step < 0:
            n = v.shape[ax]
            r = range(*e.indices(n))
            flips.append(ax)
            if len(r) == 0:
                e = slice(0, 0)
            else:
                start = n - 1 - r[0]
                e = slice(start, start + (len(r) - 1) * -e.step + 1, -e.step)
        out.append(e)
        ax += e.dim() if isinstance(e, torch.Tensor) and e.dtype == torch.bool else 1
    return tuple(out), tuple(flips)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor`` (reference: python/paddle/tensor/creation.py:87).

    A Python float takes the default dtype, a numpy float64 array keeps
    float64, a Python int gives int64; the place is the current device."""
    if isinstance(data, Tensor):
        t = data.astype(dtype) if dtype is not None else data.clone()
        if place is not None:
            t = t._moved(torch_device(place))
        t.stop_gradient = stop_gradient
        return t
    if isinstance(data, torch.Tensor):
        data = data.detach().to(torch_device(place), copy=True)
        return Tensor(data, dtype=dtype, stop_gradient=stop_gradient)
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
