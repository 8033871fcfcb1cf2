"""Dtype names to torch dtypes (the port's ``paddle_tpu/core/dtype.py``)."""
from __future__ import annotations

import torch

_BY_NAME = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int64": torch.int64,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """'float32' / 'bfloat16' / 'float16' / 'int64' (or a torch dtype) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _BY_NAME[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r}: the port knows {sorted(_BY_NAME)}"
        ) from None

