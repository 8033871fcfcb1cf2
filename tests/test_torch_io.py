"""The port's ``paddle.io`` against the JAX package's: datasets, samplers and
the ``DataLoader`` (after ``tests/test_io.py`` and
``tests/test_dataloader_mp.py``).

Both packages get the same datasets of numpy samples and the same seeds;
orders and ``state_dict``s are compared exactly, batches bitwise (their
values are copies of the samples: nothing is computed). The port's loader
runs single-process, with 2 forked workers and with 2 threads; every loader
that starts workers is drained or closed in the test, and a worker's wait
has its own timeout (``timeout=``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu_torch as pt
import paddle_tpu_torch.io as tio

WORKER_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _cpu():
    """The CPU for this file's tests, the caller's device after them."""
    was = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(was)


def _seed(s):
    paddle.seed(s)
    pt.seed(s)


class Ragged:
    """A map-style dataset for either package: a float vector, an int label,
    a ragged int sequence, a dict field."""

    def __init__(self, base, n=40):
        self.base, self.n = base, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((3,), i, np.float32), np.int64(i % 7),
                np.arange(i % 5 + 1, dtype=np.int64), {"w": np.float32(i) / 2})


def _ds(mod, n=40):
    return type("DS", (Ragged, mod.Dataset), {})(mod, n)


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same(a, b):
    a, b = _host(a), _host(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


class Fixed(Ragged):
    """``Ragged`` without its ragged field: what the default collate stacks."""

    def __getitem__(self, i):
        vec, label, _, d = super().__getitem__(i)
        return vec, label, d


def _fixed_ds(mod, n=40):
    return type("FixedDS", (Fixed, mod.Dataset), {})(mod, n)


def test_datasets_match_the_jax_package():
    for mod in (tio, jio):
        assert len(mod.ConcatDataset([_ds(mod, 3), _ds(mod, 4)])) == 7
    jc, tc = jio.ConcatDataset([_ds(jio, 3), _ds(jio, 4)]), tio.ConcatDataset([_ds(tio, 3),
                                                                              _ds(tio, 4)])
    for i in (0, 2, 3, 6, -1):
        _same(tc[i], jc[i])
    _same(tio.Subset(_ds(tio), [5, 1])[1], jio.Subset(_ds(jio), [5, 1])[1])
    _same(tio.ComposeDataset([_ds(tio, 5), _ds(tio, 5)])[3],
          jio.ComposeDataset([_ds(jio, 5), _ds(jio, 5)])[3])
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    td = tio.TensorDataset([pt.to_tensor(xs), pt.to_tensor(np.arange(6))])
    jd = jio.TensorDataset([paddle.to_tensor(xs), paddle.to_tensor(np.arange(6))])
    assert len(td) == len(jd) == 6
    _same(td[2], jd[2])
    with pytest.raises(ValueError, match="dim 0"):
        tio.TensorDataset([pt.to_tensor(xs), pt.to_tensor(np.arange(5))])

    class Stream(tio.IterableDataset):
        def __init__(self, k):
            self.k = k

        def __iter__(self):
            yield from range(self.k)

    assert list(tio.ChainDataset([Stream(2), Stream(3)])) == [0, 1, 0, 1, 2]
    with pytest.raises(RuntimeError):
        Stream(1)[0]


@pytest.mark.parametrize("lengths", [[7, 3], [0.5, 0.3, 0.2]], ids=["counts", "fractions"])
def test_random_split_matches_the_jax_package(lengths):
    _seed(11)
    got = [s.indices for s in tio.random_split(_ds(tio, 10), lengths)]
    want = [s.indices for s in jio.random_split(_ds(jio, 10), lengths)]
    assert got == want
    gen_t, gen_j = pt.Generator(5, device="cpu"), paddle.Generator(5)
    assert ([s.indices for s in tio.random_split(_ds(tio, 10), [4, 6], generator=gen_t)]
            == [s.indices for s in jio.random_split(_ds(jio, 10), [4, 6], generator=gen_j)])


@pytest.mark.parametrize("name", ["SequenceSampler", "RandomSampler", "RandomSampler_repl",
                                  "SubsetRandomSampler", "WeightedRandomSampler"])
def test_sampler_orders_match_the_jax_package_after_a_seed(name):
    def make(mod):
        ds = _ds(mod, 30)
        return {
            "SequenceSampler": lambda: mod.SequenceSampler(ds),
            "RandomSampler": lambda: mod.RandomSampler(ds),
            "RandomSampler_repl": lambda: mod.RandomSampler(ds, replacement=True, num_samples=12),
            "SubsetRandomSampler": lambda: mod.SubsetRandomSampler([3, 9, 1, 20, 7]),
            "WeightedRandomSampler": lambda: mod.WeightedRandomSampler(
                np.arange(1, 11, dtype=np.float64), 15),
        }[name]()

    _seed(21)
    got, want = list(make(tio)), list(make(jio))
    assert got == want and len(make(tio)) == len(make(jio))


def test_random_sampler_draws_anew_each_iteration():
    """The port counts its host draws (core.random.host_draw): a second
    iteration reshuffles, and ``pt.seed`` restarts the stream."""
    pt.seed(4)
    s = tio.RandomSampler(_ds(tio, 50))
    first, second = list(s), list(s)
    assert sorted(first) == sorted(second) == list(range(50)) and first != second
    pt.seed(4)
    assert list(s) == first


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_and_distributed_samplers_match_the_jax_package(shuffle, drop_last):
    _seed(3)
    assert (list(tio.BatchSampler(_ds(tio, 10), shuffle=shuffle, batch_size=3,
                                  drop_last=drop_last))
            == list(jio.BatchSampler(_ds(jio, 10), shuffle=shuffle, batch_size=3,
                                     drop_last=drop_last)))
    for rank in range(3):
        t = tio.DistributedBatchSampler(_ds(tio, 17), 2, num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        j = jio.DistributedBatchSampler(_ds(jio, 17), 2, num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        for epoch in range(2):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)
        assert t.epoch_pad_ids() == j.epoch_pad_ids()


def test_distributed_sampler_state_and_set_world_match_the_jax_package():
    t = tio.DistributedBatchSampler(_ds(tio, 20), 2, num_replicas=2, rank=1, shuffle=True)
    j = jio.DistributedBatchSampler(_ds(jio, 20), 2, num_replicas=2, rank=1, shuffle=True)
    t.set_epoch(5)
    j.set_epoch(5)
    it_t, it_j = iter(t), iter(j)
    for _ in range(3):
        assert next(it_t) == next(it_j)
    assert t.state_dict() == j.state_dict() == {"epoch": 5, "cursor": 3}
    fresh = tio.DistributedBatchSampler(_ds(tio, 20), 2, num_replicas=2, rank=1, shuffle=True)
    fresh.load_state_dict(t.state_dict())
    assert list(fresh) == list(it_j)  # resumes mid-epoch
    for s in (t, j):
        s.set_world(0, 4)
    assert list(t) == list(j) and t.state_dict() == j.state_dict()
    with pytest.raises(ValueError, match="out of range"):
        t.set_world(4, 4)


def test_distributed_sampler_reads_the_launcher_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    s = tio.DistributedBatchSampler(_ds(tio, 16), 2)
    assert (s.nranks, s.local_rank) == (4, 2)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_global_step_sampler_matches_the_jax_package(world):
    kw = dict(global_batch_size=8, seed=7, microbatch_size=2)
    for rank in range(world):
        t = tio.GlobalStepSampler(_ds(tio, 37), rank=rank, world=world, **kw)
        j = jio.GlobalStepSampler(_ds(jio, 37), rank=rank, world=world, **kw)
        assert [list(b) for b in t] == [list(b) for b in j]
        assert t.state_dict() == j.state_dict() and t.accumulation_factor == 4 // world
        for step in (0, 5, 9):
            np.testing.assert_array_equal(t.global_ids(step), j.global_ids(step))
    resumed = tio.GlobalStepSampler(37, rank=0, world=1, **kw)
    resumed.load_state_dict({"seed": 7, "cursor": 2, "global_batch_size": 8,
                             "microbatch_size": 2, "shuffle": True})
    assert next(iter(resumed)) == tio.GlobalStepSampler(37, **kw).local_ids(2)
    with pytest.raises(ValueError, match="global_batch_size"):
        resumed.load_state_dict({"global_batch_size": 4})


@pytest.mark.parametrize("mode", ["single", "processes", "threads"])
def test_dataloader_batches_match_the_jax_package(mode):
    kw = {"single": {}, "processes": {"num_workers": 2},
          "threads": {"num_workers": 2, "use_thread_workers": True}}[mode]

    def loader(mod):
        return list(mod.DataLoader(_fixed_ds(mod), batch_size=6, shuffle=True,
                                   timeout=WORKER_TIMEOUT_S if kw else 0, **kw))

    _seed(9)
    got = loader(tio)
    _seed(9)
    want = loader(jio)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert isinstance(g[0], pt.Tensor) and g[0]._value.device.type == "cpu"
        _same(g, w)


def test_dataloader_return_numpy_and_worker_collate():
    loader = tio.DataLoader(_ds(tio), batch_size=8, num_workers=2, return_numpy=True,
                            worker_collate_fn=lambda s: np.stack([x[0] for x in s]),
                            timeout=WORKER_TIMEOUT_S)
    out = list(loader)
    assert all(isinstance(b, np.ndarray) for b in out)
    np.testing.assert_array_equal(np.concatenate(out)[:, 0], np.arange(40, dtype=np.float32))


def test_dataloader_custom_collate_runs_in_the_parent():
    seen = []

    def collate(samples):
        seen.append(len(samples))
        return [s[2].tolist() for s in samples]  # the ragged field, as lists

    got = list(tio.DataLoader(_ds(tio), batch_size=5, num_workers=2, collate_fn=collate,
                              timeout=WORKER_TIMEOUT_S))
    want = list(jio.DataLoader(_ds(jio), batch_size=5, collate_fn=collate))
    assert got == want and len(seen) == 16


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_bucket_spec_pads_as_the_jax_package(workers):
    def run(mod):
        spec = mod.BucketSpec([2, 4, 8], fields=[2])
        out = list(mod.DataLoader(_ds(mod), batch_size=6, num_workers=workers,
                                  bucket_spec=spec, timeout=WORKER_TIMEOUT_S if workers else 0))
        return out, spec

    got, tspec = run(tio)
    want, jspec = run(jio)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        _same(g, w)
        assert g[2].shape[1] in (2, 4, 8)
    assert sorted(tspec.seen_shapes) == sorted(jspec.seen_shapes)
    with pytest.raises(ValueError, match="pad_batch_to"):
        tio.DataLoader(_ds(tio), num_workers=2, bucket_spec=tio.BucketSpec([4], pad_batch_to=8))


def test_dataloader_worker_error_reaches_the_parent_with_its_traceback():
    class Broken(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("sample 5 is broken")
            return np.zeros(3, np.float32)

    with pytest.raises(RuntimeError, match="sample 5 is broken") as info:
        list(tio.DataLoader(Broken(), batch_size=2, num_workers=2, timeout=WORKER_TIMEOUT_S))
    assert "Traceback" in str(info.value) and "__getitem__" in str(info.value)


def test_dataloader_workers_ship_numpy_and_know_their_info():
    class Who(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = tio.get_worker_info()
            return np.array([info.id, info.num_workers, torch.cuda.is_initialized()], np.int64)

    out = np.concatenate([b.numpy() for b in tio.DataLoader(
        Who(), batch_size=2, num_workers=2, timeout=WORKER_TIMEOUT_S)])
    assert set(out[:, 0]) <= {0, 1} and set(out[:, 1]) == {2} and not out[:, 2].any()
    assert tio.get_worker_info() is None


def test_dataloader_persistent_workers_and_a_large_shared_memory_batch():
    class Big(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return np.full((64, 64, 8), i, np.float32)  # 128 KiB: over the shared-memory cut

    loader = tio.DataLoader(Big(), batch_size=2, num_workers=2, persistent_workers=True,
                            timeout=WORKER_TIMEOUT_S)
    try:
        first = [b.numpy() for b in loader]
        pool = loader._pool
        second = [b.numpy() for b in loader]
        assert pool is not None and loader._pool is pool
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        assert first[2][1, 0, 0, 0] == 5
    finally:
        loader._stop_pool()


def test_iterable_dataset_shards_across_workers():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            info = tio.get_worker_info()
            wid, n = (0, 1) if info is None else (info.id, info.num_workers)
            yield from (np.int64(i) for i in range(wid, 20, n))

    got = sorted(np.concatenate([b.numpy() for b in tio.DataLoader(
        Stream(), batch_size=3, num_workers=2, timeout=WORKER_TIMEOUT_S)]).tolist())
    assert got == list(range(20))
    assert [b.shape[0] for b in tio.DataLoader(Stream(), batch_size=3)] == [3] * 6 + [2]


def test_dataloader_state_dict_matches_the_jax_package_mid_epoch():
    def run(mod):
        sampler = mod.DistributedBatchSampler(_fixed_ds(mod, 30), 4, num_replicas=1, rank=0,
                                              shuffle=True)
        loader = mod.DataLoader(_fixed_ds(mod, 30), batch_sampler=sampler)
        it = iter(loader)
        for _ in range(3):
            next(it)
        return loader.state_dict(), sampler

    _seed(2)
    t_state, _ = run(tio)
    _seed(2)
    j_state, _ = run(jio)
    assert t_state["sampler"] == j_state["sampler"] == {"epoch": 0, "cursor": 3}
    assert t_state["rng"] == tuple(j_state["rng"]) == (2, 0)
    fresh = tio.DataLoader(_fixed_ds(tio, 30), batch_sampler=tio.DistributedBatchSampler(
        _fixed_ds(tio, 30), 4, num_replicas=1, rank=0, shuffle=True))
    fresh.load_state_dict(t_state)
    assert len(list(fresh)) == 8 - 3  # the rest of the epoch


def test_default_collate_matches_the_jax_package():
    samples = [(*Fixed(None)[i], "tag") for i in range(4)]
    got, want = tio.default_collate_fn(samples), jio.default_collate_fn(samples)
    _same(got[:3], want[:3])
    assert got[3] == want[3] == ["tag"] * 4
    stacked = tio.default_collate_fn([pt.to_tensor(np.ones(2, np.float32))] * 3)
    assert stacked.shape == [3, 2]
    assert tio.default_collate_fn([torch.zeros(2)] * 2).shape == [2, 2]
