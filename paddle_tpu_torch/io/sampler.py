"""Samplers of the port (``paddle_tpu/io/sampler.py``; reference:
python/paddle/fluid/dataloader/sampler.py, batch_sampler.py, and fleet's
DistributedBatchSampler).

The orders are the JAX package's, from numpy: ``DistributedBatchSampler``
permutes from its epoch, ``GlobalStepSampler`` from (seed, epoch), and
``RandomSampler``, ``SubsetRandomSampler`` and ``WeightedRandomSampler``
from the host sampling stream (``core.random.host_draw``): after
``paddle.seed(s)`` their first iteration gives the JAX sampler's order for
the same seed, and each further iteration draws anew.

``GlobalStepSampler`` registers with the profiler's sample attribution
(``profiler.attribution.register_sampler``, weakly): a postmortem's triage
names the last batch's sample ids from the step number alone.
"""
from __future__ import annotations

import math
import os

import numpy as np

from ..core import random as _random


def _world():
    """(world size, rank) of this process: torch.distributed's when it is
    initialised, else the launcher's PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID
    (1 and 0 when unset)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return (int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
            int(os.environ.get("PADDLE_TRAINER_ID", "0")))


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        seed, draws = _random.host_draw()
        rng = np.random.default_rng(seed * 1000003 + draws)
        if self.replacement:
            yield from rng.integers(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        rng = np.random.default_rng(_random.host_draw()[1])
        return iter(rng.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        rng = np.random.default_rng(_random.host_draw()[1])
        p = self.weights / self.weights.sum()
        idx = rng.choice(
            len(self.weights), self.num_samples, replace=self.replacement, p=p
        )
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """reference: dataloader/batch_sampler.py BatchSampler."""

    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the dataset across data-parallel ranks.

    Reference: python/paddle/fluid/dataloader/batch_sampler.py
    DistributedBatchSampler (rank/num_replicas from ParallelEnv).

    ``total_size = ceil(len/nranks) * nranks`` pads the epoch with WRAPPED
    samples (``epoch_pad_ids``) so every rank sees the same batch count —
    fine for a fixed world, but a pad sample is a duplicate: under elastic
    rescale the global-step-indexed stream (:class:`GlobalStepSampler`)
    excludes padding entirely so shrink/grow never trains twice on a pad
    sample in one epoch. ``set_world`` re-shards in place after a rescale;
    ``state_dict``/``load_state_dict`` carry (epoch, batch cursor) so a
    resumed run continues mid-epoch instead of re-reading from the top."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            world, me = _world()
            num_replicas = num_replicas or world
            rank = rank if rank is not None else me
        self.epoch = 0
        self._cursor = 0  # batches already consumed in the current epoch
        self.set_world(rank, num_replicas)

    def set_world(self, rank, num_replicas):
        """Elastic-rescale fix-up: re-shard the SAME dataset across a new
        world. The pad set is recomputed for the new ``total_size`` and the
        epoch survives; the mid-epoch BATCH cursor resets on a world
        change — rank r's batch k indexes a different interleaving in
        every world, so carrying it would skip and duplicate samples.
        Exactly-once mid-epoch resharding is GlobalStepSampler's contract
        (its global-step cursor IS world-invariant)."""
        num_replicas = int(num_replicas)
        rank = int(rank)
        if not (0 <= rank < num_replicas):
            raise ValueError(
                f"rank {rank} out of range for num_replicas={num_replicas}")
        if getattr(self, "nranks", None) is not None and (
                num_replicas != self.nranks or rank != self.local_rank):
            self._cursor = 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.num_samples = int(math.ceil(len(self.dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def _epoch_indices(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n)
        return indices

    def epoch_pad_ids(self):
        """The wrapped sample ids this epoch pads with (duplicates of real
        samples) — what the global-step-indexed stream must exclude."""
        pad = self.total_size - len(self.dataset)
        return self._epoch_indices()[:max(0, pad)].tolist()

    def __iter__(self):
        n = len(self.dataset)
        indices = self._epoch_indices()
        # pad to make evenly divisible, then shard
        pad = self.total_size - n
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        local = indices[self.local_rank :: self.nranks]
        batch = []
        emitted = 0
        skip = self._cursor  # restored mid-epoch: fast-forward, no fetch
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                emitted += 1
                if emitted > skip:
                    self._cursor = emitted
                    yield batch
                batch = []
        if batch and not self.drop_last:
            emitted += 1
            if emitted > skip:
                self._cursor = emitted
                yield batch
        self._cursor = 0  # epoch fully consumed

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
        self._cursor = 0

    # -- resumable-iterator state (paddle.distributed.checkpoint) ---------
    def state_dict(self):
        return {"epoch": int(self.epoch), "cursor": int(self._cursor)}

    def load_state_dict(self, state):
        self.epoch = int(state.get("epoch", 0))
        self._cursor = int(state.get("cursor", 0))


class GlobalStepSampler(Sampler):
    """Deterministic, reshardable, global-step-indexed sampling (the
    elastic-rescale data plane — RESILIENCE.md "Elastic rescale").

    The sample ids consumed at global step ``s`` are a PURE FUNCTION of
    ``(seed, epoch, s)`` — epoch ``e = s // steps_per_epoch`` draws one
    seeded permutation, step ``s`` takes its ``global_batch_size`` slice —
    and are split across whatever world exists at ``s``: the step's
    ``global_batch_size // microbatch_size`` microbatches are dealt to
    ranks as contiguous aligned blocks, so rank ``r`` of world ``W`` runs
    ``accumulation_factor = num_microbatches // W`` accumulation
    microsteps. After a shrink/grow, ``set_world`` re-deals the SAME
    stream — survivors raise their accumulation factor to hold the global
    batch constant, and (with ``deterministic_tree_sum`` gradient
    reduction) the post-rescale trajectory is bitwise-identical to a
    fault-free run at matched global batch.

    Padding is excluded by construction: only the first
    ``steps_per_epoch * global_batch_size`` entries of each epoch's
    permutation are ever consumed — the tail remainder is dropped, never
    wrapped, so no sample can appear twice in one epoch's stream (the
    DistributedBatchSampler pad-duplication hazard cannot occur).

    ``world`` and ``num_microbatches`` must be powers of two (aligned
    blocks are then exact subtrees of the fixed reduction tree)."""

    def __init__(self, dataset, global_batch_size, seed=0, rank=0, world=1,
                 microbatch_size=None, shuffle=True):
        self._n = int(dataset) if isinstance(dataset, int) else len(dataset)
        self.global_batch_size = int(global_batch_size)
        if not (0 < self.global_batch_size <= self._n):
            raise ValueError(
                f"global_batch_size={global_batch_size} must be in "
                f"[1, {self._n}] (dataset length)")
        self.microbatch_size = int(microbatch_size or self.global_batch_size)
        if self.global_batch_size % self.microbatch_size:
            raise ValueError(
                f"global_batch_size={self.global_batch_size} must be a "
                f"multiple of microbatch_size={self.microbatch_size}")
        m = self.global_batch_size // self.microbatch_size
        if m & (m - 1):
            raise ValueError(
                f"num_microbatches={m} must be a power of two (aligned "
                "rank blocks must be exact subtrees of the reduction tree)")
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.cursor = 0  # next global step to consume
        self._perm_cache = (None, None)  # (epoch, permutation)
        self.set_world(rank, world)
        # the batch of step s is a pure function of (seed, epoch, s), so a
        # postmortem names the offending batch's samples from the step
        # number alone; weak, and the latest sampler wins
        try:
            from ..profiler import attribution as _attribution

            _attribution.register_sampler(self)
        except Exception:
            pass

    # -- geometry --------------------------------------------------------
    @property
    def steps_per_epoch(self) -> int:
        return self._n // self.global_batch_size

    @property
    def num_microbatches(self) -> int:
        return self.global_batch_size // self.microbatch_size

    @property
    def accumulation_factor(self) -> int:
        """Microbatches this rank accumulates per global step: it rises when
        the world shrinks, holding the global batch constant."""
        return self.num_microbatches // self.world

    @property
    def epoch(self) -> int:
        return self.cursor // self.steps_per_epoch

    def set_world(self, rank, world):
        """Elastic-rescale fix-up: re-deal the stream across a new world.
        Pure — the global stream is untouched; only which block of each
        step's microbatches this rank consumes changes."""
        rank, world = int(rank), int(world)
        if world <= 0 or world & (world - 1):
            raise ValueError(f"world={world} must be a positive power of "
                             "two (tree-reduction alignment)")
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} out of range for world={world}")
        if self.num_microbatches % world:
            raise ValueError(
                f"world={world} must divide num_microbatches="
                f"{self.num_microbatches} (every rank owns a whole block)")
        self.rank = rank
        self.world = world

    # -- the pure (seed, epoch, step) -> ids function ---------------------
    def _perm(self, epoch):
        cached_epoch, cached = self._perm_cache
        if cached_epoch == epoch:
            return cached
        if self.shuffle:
            perm = np.random.default_rng(
                (self.seed, int(epoch))).permutation(self._n)
        else:
            perm = np.arange(self._n)
        self._perm_cache = (epoch, perm)
        return perm

    def global_ids(self, step) -> np.ndarray:
        """All ``global_batch_size`` sample ids of global step ``step`` —
        identical on every rank, for any world, forever."""
        step = int(step)
        spe = self.steps_per_epoch
        epoch, pos = step // spe, step % spe
        g = self.global_batch_size
        ids = self._perm(epoch)[pos * g:(pos + 1) * g]
        assert len(ids) == g  # pad-free by construction: tail dropped
        return ids

    def microbatches(self, step):
        """This rank's contiguous aligned block of the step's microbatches
        (``accumulation_factor`` arrays of ``microbatch_size`` ids)."""
        ids = self.global_ids(step)
        k = self.accumulation_factor
        m = self.microbatch_size
        lo = self.rank * k
        return [ids[(lo + j) * m:(lo + j + 1) * m] for j in range(k)]

    def local_ids(self, step) -> list:
        """This rank's flat id list for global step ``step``."""
        return np.concatenate(self.microbatches(step)).tolist()

    # -- batch-sampler protocol ------------------------------------------
    def __iter__(self):
        """Yields this rank's per-global-step batches from the cursor to
        the end of the CURRENT epoch, advancing the cursor — a restored
        sampler resumes mid-epoch, consuming each sample exactly once."""
        epoch = self.epoch
        while self.cursor // self.steps_per_epoch == epoch:
            step = self.cursor
            self.cursor += 1
            yield self.local_ids(step)

    def __len__(self):
        return self.steps_per_epoch

    # -- resumable-iterator state (paddle.distributed.checkpoint) ---------
    def state_dict(self):
        return {
            "seed": self.seed,
            "cursor": int(self.cursor),
            "global_batch_size": self.global_batch_size,
            "microbatch_size": self.microbatch_size,
            "shuffle": self.shuffle,
        }

    def load_state_dict(self, state):
        for key in ("global_batch_size", "microbatch_size"):
            if key in state and int(state[key]) != getattr(self, key):
                raise ValueError(
                    f"restored {key}={state[key]} != configured "
                    f"{getattr(self, key)} — the global-step stream would "
                    "not be the one the checkpoint was cut from")
        self.seed = int(state.get("seed", self.seed))
        self.shuffle = bool(state.get("shuffle", self.shuffle))
        self.cursor = int(state.get("cursor", 0))
        self._perm_cache = (None, None)
