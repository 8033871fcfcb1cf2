"""``paddle.io`` of the port: datasets, samplers, the ``DataLoader`` and the
shape-bucketing policy (``paddle_tpu/io/__init__.py``). The loader makes
numpy batches on the host; the parent wraps them as Tensors on the current
device unless ``return_numpy=True``."""
from .bucketing import BucketSpec  # noqa: F401
from .dataloader import DataLoader, default_collate_fn, get_worker_info  # noqa: F401
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset, Subset,
    TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, GlobalStepSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)

__all__ = [
    "BatchSampler", "BucketSpec", "ChainDataset", "ComposeDataset", "ConcatDataset",
    "DataLoader", "Dataset", "DistributedBatchSampler", "GlobalStepSampler",
    "IterableDataset", "RandomSampler", "Sampler", "SequenceSampler", "Subset",
    "SubsetRandomSampler", "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
    "get_worker_info", "random_split",
]
