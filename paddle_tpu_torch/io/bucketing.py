"""Shape-bucketing policy for variable-length data (the port's copy of
``paddle_tpu/io/bucketing.py``).

Every distinct shape is one captured program (a CUDA graph here, an XLA
program in the JAX package), so ragged lengths pad up to a small set of
bucket boundaries and the number of programs stays bounded, and a workload
past its budget of shapes is warned about instead of capturing forever.

`BucketSpec` is both a standalone padding helper and a collate policy:

    spec = BucketSpec(boundaries=[32, 64, 128], axis=-1, pad_value=0)
    spec.bucket_for(40)                      # 64
    batch = spec.collate(samples, collate)   # ragged fields padded, stacked
    # every emitted ids array has seq len in {32, 64, 128}: at most 3
    # captures of the train step instead of one per length

The serving scheduler rounds prompts with it (``serving/scheduler.py``).
``DataLoader(bucket_spec=...)`` waits for the port's DataLoader (ROADMAP
queue 1 item 18).
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

__all__ = ["BucketSpec"]


class BucketSpec:
    """Pad-to-bucket policy.

    Args:
        boundaries: ascending bucket sizes for the ragged axis. A length
            above the largest boundary rounds up to the next multiple of
            it (shapes stay bounded: largest, 2*largest, ...).
        axis: the ragged axis of each array (default -1). The batch axis
            is handled by `pad_batch_to`, not `axis`.
        pad_value: fill for padded positions (e.g. a tokenizer's pad id).
        pad_batch_to: when set, short batches (the last-batch problem)
            are padded along axis 0 up to this size by REPEATING the
            final sample — keeping the compiled batch shape constant.
            `real_batch_size(batch)` recovers the unpadded count.
        max_shapes: recompile budget — distinct emitted shapes beyond
            this warn once per new shape (each one is a capture).
        fields: indices of the sample tuple the policy applies to (None:
            every array field with ndim >= 1).
    """

    def __init__(self, boundaries: Sequence[int], axis: int = -1,
                 pad_value=0, pad_batch_to: Optional[int] = None,
                 max_shapes: int = 8, fields: Optional[Sequence[int]] = None):
        bs = [int(b) for b in boundaries]
        if not bs or sorted(bs) != bs or any(b <= 0 for b in bs):
            raise ValueError("boundaries must be ascending positive ints")
        self.boundaries = bs
        self.axis = int(axis)
        self.pad_value = pad_value
        self.pad_batch_to = pad_batch_to
        self.max_shapes = int(max_shapes)
        self.fields = None if fields is None else set(int(f) for f in fields)
        self._seen_shapes = set()
        # id(batch) -> unpadded row count, FIFO-capped: entries outlive
        # their batch only briefly, so a recycled id cannot alias a live
        # query beyond the last few batches
        from collections import OrderedDict

        self._real_sizes = OrderedDict()
        self._real_sizes_cap = 16

    # -- bucket arithmetic ---------------------------------------------------
    def bucket_for(self, length: int) -> int:
        """Smallest boundary >= length; beyond the table, the next
        multiple of the largest boundary."""
        for b in self.boundaries:
            if length <= b:
                return b
        top = self.boundaries[-1]
        return ((length + top - 1) // top) * top

    @property
    def seen_shapes(self):
        """Distinct padded shapes emitted so far (the compile count a
        consumer of this loader pays)."""
        return frozenset(self._seen_shapes)

    def _observe(self, shape):
        if shape in self._seen_shapes:
            return
        self._seen_shapes.add(shape)
        if len(self._seen_shapes) > self.max_shapes:
            warnings.warn(
                f"BucketSpec: {len(self._seen_shapes)} distinct padded "
                f"shapes exceed the recompile budget max_shapes="
                f"{self.max_shapes} (each is one captured program). "
                f"Coarsen `boundaries` or raise the budget. "
                f"Newest shape: {shape}",
                stacklevel=3,
            )

    # -- array padding -------------------------------------------------------
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

    def apply(self, batch):
        """Pad an already-collated batch (array, or tuple/list/dict of
        arrays) to bucket boundaries and record the emitted shapes."""
        if isinstance(batch, (tuple, list)):
            out = [
                self.apply(b) if self._applies(i, b) else b
                for i, b in enumerate(batch)
            ]
            return type(batch)(out)
        if isinstance(batch, dict):
            return {
                k: self.apply(v) if self._applies(None, v) else v
                for k, v in batch.items()
            }
        padded = self.pad(batch)
        self._observe(tuple(padded.shape))
        return padded

    def _applies(self, idx, value) -> bool:
        if (self.fields is not None and idx is not None
                and idx not in self.fields):
            return False
        if isinstance(value, list):
            return True
        # scalars (0-d arrays, python numbers — e.g. label fields) have no
        # ragged axis to pad
        return np.ndim(value) >= 1 and hasattr(value, "shape")

    # -- collate-time policy (ragged samples) --------------------------------
    def collate(self, samples, base_collate):
        """Pad each RAGGED sample field to the bucket of the batch max
        length, then run the normal collate (which can now stack).
        Handles tuple/list samples and bare-array samples."""
        if not samples:
            return base_collate(samples)
        first = samples[0]
        if isinstance(first, (tuple, list)):
            n_fields = len(first)
            cols = list(zip(*samples))
            padded_cols = []
            for i in range(n_fields):
                col = cols[i]
                if self._applies(i, np.asarray(col[0])):
                    arrs = [np.asarray(c) for c in col]
                    ax = self.axis if self.axis >= 0 else \
                        arrs[0].ndim + self.axis
                    tgt = self.bucket_for(max(a.shape[ax] for a in arrs))
                    padded_cols.append(
                        tuple(self.pad(a, tgt) for a in arrs)
                    )
                else:
                    padded_cols.append(col)
            samples = [
                type(first)(field[j] for field in padded_cols)
                for j in range(len(samples))
            ]
        else:
            arrs = [np.asarray(s) for s in samples]
            ax = self.axis if self.axis >= 0 else arrs[0].ndim + self.axis
            tgt = self.bucket_for(max(a.shape[ax] for a in arrs))
            samples = [self.pad(a, tgt) for a in arrs]
        batch = base_collate(samples)
        batch = self._pad_batch_dim(batch)
        self._record_shapes(batch)
        return batch

    def _pad_batch_dim(self, batch):
        if self.pad_batch_to is None:
            return batch
        tgt = int(self.pad_batch_to)

        def padb(a):
            from ..core.tensor import Tensor

            if isinstance(a, np.ndarray):
                arr = a
            elif isinstance(a, Tensor):  # Tensor passthrough
                arr = a.numpy()
            else:
                return a
            n = arr.shape[0]
            if n >= tgt:
                return a
            reps = np.repeat(arr[-1:], tgt - n, axis=0)
            out = np.concatenate([arr, reps], axis=0)
            self._remember_real(out, n)
            if not isinstance(a, np.ndarray):
                t = Tensor(out, place=a.place)
                self._remember_real(t, n)
                return t
            return out

        if isinstance(batch, (tuple, list)):
            return type(batch)(padb(b) for b in batch)
        return padb(batch)

    def _remember_real(self, obj, n):
        self._real_sizes[id(obj)] = int(n)
        while len(self._real_sizes) > self._real_sizes_cap:
            self._real_sizes.popitem(last=False)

    def real_batch_size(self, padded) -> Optional[int]:
        """Unpadded row count of a batch grown by `pad_batch_to`
        (None: the batch was not padded)."""
        return self._real_sizes.get(id(padded))

    def _record_shapes(self, batch):
        if isinstance(batch, (tuple, list)):
            for b in batch:
                self._record_shapes(b)
            return
        shp = getattr(batch, "shape", None)
        if shp is not None:
            self._observe(tuple(shp))
