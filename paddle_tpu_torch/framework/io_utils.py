"""``paddle.save`` / ``paddle.load`` for the port (``paddle_tpu/framework/io_utils.py``).

The file format is the JAX package's, the reference's pickle format
(python/paddle/framework/io.py:568): a pickle of nested dicts, lists and
tuples with every tensor stored as a plain numpy array. A file written by
either package loads in the other. ``save`` writes a temporary file in the
target directory and renames it into place, so a kill mid-save never
leaves a torn file at ``path``.

bfloat16 has no numpy dtype of its own. Both packages store it as an
``ml_dtypes.bfloat16`` array, the JAX package's ``Tensor.numpy()``; the port
writes the tensor's 16 bits into one, bit for bit, so unpickling such a
file needs ``ml_dtypes`` installed. Where it is not, ``save`` raises on a
bf16 tensor rather than change its dtype.

The JAX package's legacy ``_TensorPayload`` surrogate (files of its early
releases) has no counterpart here: such a file does not unpickle in the
port.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..convert import _to_torch

__all__ = ["load", "save", "to_numpy"]


def _bfloat16_dtype():
    try:
        import ml_dtypes
    except ImportError as e:
        raise RuntimeError(
            "paddle.save: a bfloat16 tensor is stored as an ml_dtypes.bfloat16 "
            "array, the JAX package's format, and ml_dtypes is not installed"
        ) from e
    return ml_dtypes.bfloat16


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's values as a numpy array, bf16 bit for bit as
    ``ml_dtypes.bfloat16``. The array shares ``t``'s memory."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_bfloat16_dtype())
    return t.numpy()


def _pack(obj: Any):
    if isinstance(obj, torch.Tensor):
        return to_numpy(obj.cpu())
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return type(obj)(packed) if not isinstance(obj, tuple) else tuple(packed)
    return obj


def _unpack(obj: Any, return_numpy=False):
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        return obj if return_numpy else _to_torch(obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """paddle.save: state dicts, tensors, nested containers. Tensors on the
    card are copied to the host first."""
    packed = _pack(obj)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(packed, f, protocol=protocol)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # failed mid-write: drop the partial file
            try:
                os.remove(tmp)
            except OSError:
                pass


def load(path, return_numpy=False, **configs):
    """paddle.load: arrays come back as CPU ``torch.Tensor``s (numpy arrays
    with ``return_numpy=True``); the caller moves them, or
    ``Layer.set_state_dict`` copies them onto the destination's device."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy=return_numpy)
