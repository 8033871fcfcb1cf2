"""``paddle.amp`` for the port: ``decorate`` (``paddle_tpu/amp/__init__.py:106``).

O2 casts the model's floating parameters and buffers to the low dtype and
wraps ``forward`` to cast floating tensor inputs to it. The optimizer state
then takes the parameters' dtype (bf16 moments under O2 bf16), as in the JAX
package. O1 leaves the model as it is, as the JAX ``decorate`` does. Not
ported yet (ROADMAP, open items, queue 1 item 7): ``auto_cast`` and its O1
cast lists, and ``GradScaler``.
"""
from __future__ import annotations

import torch

from ..core.dtype import to_torch_dtype

__all__ = ["decorate"]


def _wrap_forward(m: torch.nn.Module, low: torch.dtype):
    orig = m.forward

    def forward(*args, **kw):
        # pure-low-precision mode casts floating inputs at model entry
        def cast(a):
            if isinstance(a, torch.Tensor) and a.is_floating_point() and a.dtype != low:
                return a.to(low)
            return a

        return orig(*[cast(a) for a in args], **{k: cast(v) for k, v in kw.items()})

    m.forward = forward


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: parameters in ``dtype``, floating inputs cast at model entry.

    Returns ``models`` (or ``(models, optimizers)`` when optimizers are given)."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        low = to_torch_dtype(dtype)
        for m in model_list:
            m.to(dtype=low)
            _wrap_forward(m, low)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
