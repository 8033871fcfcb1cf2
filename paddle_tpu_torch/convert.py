"""Carry weights into a port model from numpy arrays.

The JAX package's ``state_dict()`` and the port's use the same names and
layouts, so ``{k: v.numpy() for k, v in jax_model.state_dict().items()}``
loads as it is.
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
    tensors = {}
    for name, t in target.items():
        src = _to_torch(np.asarray(arrays[name]))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(
                f"state_dict_from_numpy: {name} has shape {tuple(src.shape)}, "
                f"the model expects {tuple(t.shape)}"
            )
        if src.dtype != t.dtype:
            raise ValueError(
                f"state_dict_from_numpy: {name} has dtype {src.dtype}, "
                f"the model expects {t.dtype}"
            )
        tensors[name] = src
    with torch.no_grad():
        for name, t in target.items():
            t.copy_(tensors[name])
