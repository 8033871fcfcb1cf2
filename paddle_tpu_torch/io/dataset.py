"""Datasets of the port (``paddle_tpu/io/dataset.py``; reference:
python/paddle/fluid/dataloader/dataset.py). ``random_split`` permutes with
numpy from the seed of ``generator`` or of ``paddle.seed``, as the JAX
package's does, so one seed gives both packages the same split."""
from __future__ import annotations

import bisect


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        # TypeError, as len() of an unsized object raises: list() and other
        # length hints then fall back to iterating (the JAX package raises
        # RuntimeError, which they pass on)
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lengths = {t.shape[0] for t in tensors}
        if len(lengths) > 1:
            raise ValueError("all tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        lengths = {len(d) for d in self.datasets}
        if len(lengths) > 1:
            raise ValueError("datasets must share length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (tuple, list)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            for sample in d:
                yield sample


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    import numpy as np

    from ..core import random as _random

    n = len(dataset)
    if sum(lengths) != n:
        # fractional lengths support (paddle >= 2.5 style)
        if all(0 < l < 1 for l in lengths):
            counts = [int(np.floor(n * l)) for l in lengths]
            rem = n - sum(counts)
            for i in range(rem):
                counts[i % len(counts)] += 1
            lengths = counts
        else:
            raise ValueError("sum of lengths != dataset size")
    rng = np.random.default_rng(
        generator.initial_seed() if generator is not None else _random.host_stream_state()[0]
    )
    perm = rng.permutation(n)
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off : off + l].tolist()))
        off += l
    return out
