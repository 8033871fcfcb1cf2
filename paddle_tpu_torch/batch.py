"""paddle.batch — reader batching decorator (the port's copy of
``paddle_tpu/batch.py``; a reader is a no-argument callable yielding
samples, ``batch()`` groups them)."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
