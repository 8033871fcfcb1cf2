"""The dtype system: the port's counterpart of ``paddle_tpu/core/dtype.py``.

A ``DType`` is a named Paddle dtype over a torch dtype. It compares equal to
its name ('float32'), to its numpy dtype and to its torch dtype, so
``paddle.float32``, ``'float32'`` and ``torch.float32`` work wherever a dtype
is accepted. ``to_np_dtype`` gives ``ml_dtypes.bfloat16`` for bfloat16, as
``numpy()`` and ``paddle.save`` do; ``ml_dtypes`` is imported only then.
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """A framework dtype. Compares equal to its name, numpy and torch dtype."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name: str, torch_dtype: torch.dtype):
        self.name = name
        self.torch_dtype = torch_dtype

    def __repr__(self):
        return f"paddle.{self.name}"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        if isinstance(other, str):
            return other in (self.name, _NP_NAMES.get(self.name))
        try:
            return np.dtype(other) == self.np_dtype
        except TypeError:
            return NotImplemented

    @property
    def np_dtype(self) -> np.dtype:
        return to_np_dtype(self)

    @property
    def is_floating_point(self):
        return self.name in ("float16", "bfloat16", "float32", "float64")

    @property
    def is_complex(self):
        return self.name in ("complex64", "complex128")

    @property
    def is_integer(self):
        return self.name in ("int8", "int16", "int32", "int64", "uint8")


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALL = (bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32, float64,
        complex64, complex128)
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME["bool_"] = bool_
_BY_TORCH = {d.torch_dtype: d for d in _ALL}
_NP_NAMES = {"bool": "bool_"}


def to_paddle_dtype(dtype) -> DType:
    """Any dtype-like (DType, name, numpy or torch dtype) as a DType."""
    if isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, torch.dtype):
        found = _BY_TORCH.get(dtype)
    elif isinstance(dtype, str):
        found = _BY_NAME.get(dtype)
        if found is None and dtype.startswith("paddle."):
            found = _BY_NAME.get(dtype[len("paddle."):])
    else:
        try:
            npd = np.dtype(dtype)
        except TypeError:
            npd = None
        found = None if npd is None else _BY_NAME.get(npd.name)
    if found is None:
        raise ValueError(f"unsupported dtype {dtype!r}: the port knows "
                         f"{sorted(d.name for d in _ALL)}")
    return found


def to_torch_dtype(dtype) -> torch.dtype:
    """A dtype-like (DType, 'float32', numpy or torch dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return to_paddle_dtype(dtype).torch_dtype


def to_np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a dtype-like; bfloat16 is ``ml_dtypes.bfloat16``."""
    name = to_paddle_dtype(dtype).name
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def inexact(dtype: torch.dtype) -> torch.dtype:
    """The floating dtype the JAX package computes an integer or bool input in
    (jnp's ``promote_dtypes_inexact`` with 64-bit types on): float64 for
    int64, float32 for the narrower integers and bool; float types stay."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.int64 else torch.float32


# the default dtype — reference: python/paddle/framework/framework.py
_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    d = to_paddle_dtype(d)
    if not d.is_floating_point:
        raise TypeError("set_default_dtype only accepts floating dtypes")
    _default_dtype = d


def get_default_dtype() -> str:
    return _default_dtype.name
