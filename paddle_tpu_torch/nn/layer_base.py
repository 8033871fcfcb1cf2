"""``paddle.nn.Layer`` for the port: a ``torch.nn.Module`` with Paddle's
state-loading methods and its parameter and sublayer surface
(``paddle_tpu/nn/layer_base.py:74-318``).

``state_dict()`` stays torch's: torch calls it recursively with ``prefix=``
and ``keep_vars=``, which Paddle's signature lacks, and its names already
equal the JAX package's (``convert.py``). ``set_state_dict`` and its
aliases ``set_dict`` / ``load_dict`` copy into the existing tensors in
place, so an optimizer's references and a captured CUDA graph's addresses
stay valid. ``create_parameter``, ``add_parameter``, ``add_sublayer``,
``sublayers``, ``named_sublayers``, ``clear_gradients``, ``full_name`` and
``register_forward_post_hook`` keep the JAX methods' order and return
values; torch's own methods of the same purpose (``named_modules``,
``register_forward_hook``, ...) stay as they are. ``apply`` visits the
layer before its sublayers, as Paddle does (torch visits it last);
``to`` and ``register_buffer`` also take Paddle's forms (dtype names,
place strings, ``persistable``). torch's ``register_forward_pre_hook``
already has Paddle's contract: ``hook(layer, inputs)``, a result that is
not None replaces the inputs, and a handle with ``remove()``. A layer
takes Paddle Tensors as well as torch tensors (``__call__``).
"""
from __future__ import annotations

import torch

from ..convert import source_for
from ..core import dispatch
from ..core import lazy as _lazy
from ..core.dtype import DType, to_torch_dtype
from ..core.place import torch_device

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = dtype or "float32"
        self._full_name = name_scope or type(self).__name__.lower()

    def __call__(self, *args, **kwargs):
        """Run the layer. Paddle Tensor arguments, also inside tuples, lists
        and dicts, are unwrapped to their torch values (no copy) and the
        results wrapped as Tensors; a call with torch tensors runs as
        ``torch.nn.Module`` runs it. The outermost call with Tensors is one
        op program, deferred under lazy dispatch (``core/lazy.py``)."""
        if not dispatch.holds_tensor(args, kwargs):
            return super().__call__(*args, **kwargs)
        key = _lazy.layer_key(self) if _lazy.lazy_on() and not dispatch._depth() else None
        return dispatch.tensor_call(key, _lazy._LayerCall(self), args, kwargs, self)

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or numpy arrays) into this
        layer's parameters and buffers of the same names, in place, cast to
        each destination's dtype and device. A shape mismatch raises
        ValueError before anything is copied. Returns ``(missing,
        unexpected)``: the layer's names the dict lacks, and the dict's
        names the layer lacks. ``use_structured_name`` is accepted and, as
        in the JAX package, the names are always the structured ones."""
        current = self.state_dict()
        sources = {
            name: source_for(name, state_dict[name], t, True, "set_state_dict")
            for name, t in current.items() if name in state_dict
        }
        missing = [name for name in current if name not in state_dict]
        unexpected = [name for name in state_dict if name not in current]
        with torch.no_grad():
            for name, src in sources.items():
                current[name].copy_(src)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- construction --------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new parameter of ``shape``, not yet registered (assign it to an
        attribute, or ``add_parameter`` it). ``attr`` is a ``ParamAttr``
        (its initializer, ``trainable`` and name), an Initializer or None;
        the initializer falls back to ``set_global_initializer``'s, then to
        ``default_initializer``, then to zeros for a bias and XavierNormal
        otherwise (``nn.layer.common.param_of``). Its dtype is ``dtype`` or
        the layer's (float32). It lies on the device of this layer's first
        parameter, or on the current device when the layer has none, and
        carries a Paddle name, ``param_<n>`` unless the attribute names it,
        in ``param_name``."""
        from .layer.common import param_of

        first = next(self.parameters(), None)
        device = first.device if first is not None else torch_device(None)
        return param_of(shape, attr if attr is not False else None, default_initializer,
                        device, to_torch_dtype(dtype or self._dtype), is_bias)

    def register_buffer(self, name, tensor, persistable=True, persistent=None):
        """Paddle's ``persistable`` (torch's ``persistent``): a buffer that is
        not persistable stays out of ``state_dict``."""
        return super().register_buffer(
            name, dispatch.unwrap(tensor), persistable if persistent is None else persistent)

    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` with Paddle's dtype
        names and places, or torch's own arguments: floating parameters and
        buffers cast, everything moved (``blocking`` is accepted; the copies
        are torch's)."""
        if isinstance(device, (torch.dtype, DType)) or (
                isinstance(device, str) and not device.startswith(("cpu", "gpu", "cuda"))):
            device, dtype = None, device  # torch's positional dtype
        if dtype is not None and not isinstance(dtype, torch.dtype):
            dtype = to_torch_dtype(dtype)
        if device is not None and not isinstance(device, (torch.device, torch.Tensor, int)):
            device = torch_device(device)  # a Paddle place or place string
        return super().to(*[a for a in (device, dtype) if a is not None], **kwargs)

    def apply(self, fn):
        """``fn(layer)`` on this layer, then on every sublayer depth first."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    # -- traversal -----------------------------------------------------------
    def sublayers(self, include_self=False):
        return [layer for _, layer in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        """``(name, layer)`` over every sublayer, depth first, each before
        its own sublayers; a layer reached twice is yielded twice, as in the
        JAX package."""
        if include_self:
            yield prefix.rstrip("."), self
        yield from _named_sublayers(self, prefix)

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    # -- hooks ---------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward; a result that
        is not None replaces the outputs. Returns a handle whose ``remove()``
        unregisters it."""
        return self.register_forward_hook(hook)


def _named_sublayers(module, prefix):
    for name, sub in module._modules.items():
        if sub is None:
            continue
        path = f"{prefix}{name}"
        yield path, sub
        yield from _named_sublayers(sub, path + ".")
