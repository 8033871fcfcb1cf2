"""``paddle.nn.Layer`` for the port: a ``torch.nn.Module`` with Paddle's
state-loading methods (``paddle_tpu/nn/layer_base.py:281-318``).

``state_dict()`` stays torch's: torch calls it recursively with ``prefix=``
and ``keep_vars=``, which Paddle's signature lacks, and its names already
equal the JAX package's (``convert.py``). ``set_state_dict`` and its
aliases ``set_dict`` / ``load_dict`` copy into the existing tensors in
place, so an optimizer's references and a captured CUDA graph's addresses
stay valid. The rest of the Layer surface (``sublayers``,
``add_sublayer``, hooks, ...) is not ported yet (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

import torch

from ..convert import source_for

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype=None):
        super().__init__()

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
