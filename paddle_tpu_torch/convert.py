"""Carry weights into a port model from numpy arrays or tensors.

The JAX package's ``state_dict()`` and the port's use the same names and
layouts, so ``{k: v.numpy() for k, v in jax_model.state_dict().items()}``
loads as it is. ``state_dict_from_numpy`` is the strict loader the parity
tests use; ``nn.Layer.set_state_dict`` is Paddle's lenient one. Both check
each value with ``source_for``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, copy=True)  # owned and writable, as torch needs
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def source_for(name: str, value, target: torch.Tensor, cast: bool, who: str) -> torch.Tensor:
    """``value`` (a tensor or anything numpy takes) as a tensor to copy into
    ``target``. A shape other than the target's raises ValueError; so does
    another dtype unless ``cast``, where the copy converts it."""
    src = value if isinstance(value, torch.Tensor) else _to_torch(np.asarray(value))
    if tuple(src.shape) != tuple(target.shape):
        raise ValueError(
            f"{who}: {name} has shape {tuple(src.shape)}, the model expects "
            f"{tuple(target.shape)}"
        )
    if not cast and src.dtype != target.dtype:
        raise ValueError(
            f"{who}: {name} has dtype {src.dtype}, the model expects {target.dtype}"
        )
    return src


def state_dict_from_numpy(model: torch.nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Load ``arrays`` into ``model``'s state, in place, on the model's devices.

    Every name, shape and dtype must match the model's ``state_dict()``:
    a missing, extra, mis-shaped or mis-typed key raises ValueError and
    nothing is loaded."""
    target = model.state_dict()
    missing = sorted(set(target) - set(arrays))
    extra = sorted(set(arrays) - set(target))
    if missing or extra:
        raise ValueError(
            f"state_dict_from_numpy: missing keys {missing}, unexpected keys {extra}"
        )
    tensors = {name: source_for(name, np.asarray(arrays[name]), t, False, "state_dict_from_numpy")
               for name, t in target.items()}
    with torch.no_grad():
        for name, t in target.items():
            t.copy_(tensors[name])
