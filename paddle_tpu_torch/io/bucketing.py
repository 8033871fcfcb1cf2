"""Shape-bucketing policy: the part of ``paddle_tpu/io/bucketing.py`` that the
serving engine uses.

Every distinct shape is one captured program (a CUDA graph here, an XLA
program in the JAX package), so ragged lengths pad up to a small set of
bucket boundaries and the number of programs stays bounded:

    spec = BucketSpec(boundaries=[32, 64, 128], axis=-1, pad_value=0)
    spec.bucket_for(40)     # 64
    spec.pad(ids)           # ids padded along the last axis to its bucket

The DataLoader policy of the JAX class (batch padding, the recompile
budget warning, per-field selection) is not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["BucketSpec"]


class BucketSpec:
    """Pad-to-bucket policy.

    Args:
        boundaries: ascending bucket sizes for the ragged axis. A length
            above the largest boundary rounds up to the next multiple of
            it (shapes stay bounded: largest, 2*largest, ...).
        axis: the ragged axis of each array (default -1).
        pad_value: fill for padded positions (e.g. a tokenizer's pad id).
    """

    def __init__(self, boundaries: Sequence[int], axis: int = -1, pad_value=0):
        bs = [int(b) for b in boundaries]
        if not bs or sorted(bs) != bs or any(b <= 0 for b in bs):
            raise ValueError("boundaries must be ascending positive ints")
        self.boundaries = bs
        self.axis = int(axis)
        self.pad_value = pad_value

    def bucket_for(self, length: int) -> int:
        """Smallest boundary >= length; beyond the table, the next
        multiple of the largest boundary."""
        for b in self.boundaries:
            if length <= b:
                return b
        top = self.boundaries[-1]
        return ((length + top - 1) // top) * top

    def pad(self, arr, target: Optional[int] = None):
        """Pad `arr` along `self.axis` to `target` (default: the bucket
        of its current length)."""
        a = np.asarray(arr)
        ax = self.axis if self.axis >= 0 else a.ndim + self.axis
        cur = a.shape[ax]
        tgt = self.bucket_for(cur) if target is None else int(target)
        if cur > tgt:
            raise ValueError(f"length {cur} exceeds pad target {tgt}")
        if cur == tgt:
            return a
        widths = [(0, 0)] * a.ndim
        widths[ax] = (0, tgt - cur)
        return np.pad(a, widths, constant_values=self.pad_value)
