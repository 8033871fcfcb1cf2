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
``register_forward_hook``, ...) stay as they are. A layer takes Paddle
Tensors as well as torch tensors (``__call__``).
"""
from __future__ import annotations

import torch

from ..convert import source_for
from ..core import dispatch
from ..core.dtype import to_torch_dtype
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
        ``torch.nn.Module`` runs it."""
        if not dispatch.holds_tensor(args, kwargs):
            return super().__call__(*args, **kwargs)
        kwargs = {k: dispatch.unwrap(v) for k, v in kwargs.items()}
        return dispatch.wrap(super().__call__(*dispatch.unwrap(args), **kwargs))

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
        attribute, or ``add_parameter`` it). Its initializer is ``attr`` when
        that is an Initializer, else ``default_initializer``, else zeros for
        a bias and XavierNormal otherwise; its dtype ``dtype`` or the
        layer's (float32). It lies on the device of this layer's first
        parameter, or on the current device when the layer has none, and
        carries a Paddle name, ``param_<n>``, in ``param_name``."""
        from . import initializer as I
        from .layer.common import create_parameter

        if attr is not None and attr is not False and not isinstance(attr, I.Initializer):
            raise NotImplementedError(
                "create_parameter(attr=ParamAttr(...)) is not ported yet (ROADMAP, open "
                "items, queue 1 item 4); pass an Initializer"
            )
        init = attr if isinstance(attr, I.Initializer) else default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        first = next(self.parameters(), None)
        device = first.device if first is not None else torch_device(None)
        return create_parameter(shape, init, device, to_torch_dtype(dtype or self._dtype))

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
