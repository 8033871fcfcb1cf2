"""``io.BucketSpec`` of the port against the JAX package's, on the CPU: its
whole surface (``bucket_for``, ``pad``, ``apply`` over arrays, tuples and
dicts with ``fields``, ``collate`` of ragged samples with a base collate,
``pad_batch_to`` with ``real_batch_size``, ``seen_shapes`` and the
once-per-shape warning past ``max_shapes``) on the same seeded numpy
samples, compared exactly (padding copies values), and the serving
scheduler's use of it.
"""
import warnings

import numpy as np
import pytest

from paddle_tpu.io.bucketing import BucketSpec as JBucketSpec
import paddle_tpu_torch as tp
from paddle_tpu_torch.io import BucketSpec


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _both(**kw):
    return JBucketSpec(**kw), BucketSpec(**kw)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert np.asarray(b).dtype == np.asarray(a).dtype


def _ragged(seed, n, lens=(3, 7, 5, 12, 9)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 50, lens[i % len(lens)]), np.int64(i)) for i in range(n)]


def _stack_collate(samples):
    if isinstance(samples[0], tuple):
        return tuple(np.stack(col) for col in zip(*samples))
    return np.stack(samples)


def test_bucket_arithmetic_and_pad():
    for spec in _both(boundaries=[4, 8, 16], pad_value=-1):
        assert [spec.bucket_for(n) for n in (1, 4, 5, 16, 17, 40)] == [4, 4, 8, 16, 32, 48]
    j, t = _both(boundaries=[4, 8], axis=0, pad_value=7)
    x = np.arange(15).reshape(5, 3)
    _same(j.pad(x), t.pad(x))
    _same(j.pad(x, 6), t.pad(x, 6))
    for spec in (j, t):
        with pytest.raises(ValueError, match="exceeds"):
            spec.pad(x, 4)
    for bad in ([], [8, 4], [0, 4]):
        for cls in (JBucketSpec, BucketSpec):
            with pytest.raises(ValueError, match="ascending"):
                cls(boundaries=bad)


def test_apply_over_arrays_tuples_dicts_and_fields():
    rng = np.random.default_rng(1)
    ids, mask = rng.integers(0, 9, (2, 5)), rng.random((2, 5)).astype(np.float32)
    label = np.int64(3)
    j, t = _both(boundaries=[8, 16], pad_value=0)
    _same(j.apply(ids), t.apply(ids))
    _same(j.apply((ids, mask, label)), t.apply((ids, mask, label)))
    _same(j.apply([ids, [1, 2, 3]]), t.apply([ids, [1, 2, 3]]))
    _same(j.apply({"ids": ids, "n": label}), t.apply({"ids": ids, "n": label}))
    assert t.seen_shapes == j.seen_shapes == frozenset({(2, 8)})
    jf, tf = _both(boundaries=[8], fields=[0])
    _same(jf.apply((ids, mask)), tf.apply((ids, mask)))
    assert tf.apply((ids, mask))[1].shape == (2, 5)


def test_collate_pads_ragged_fields_to_the_batch_bucket():
    samples = _ragged(2, 4)
    j, t = _both(boundaries=[4, 8, 16], pad_value=0)
    _same(j.collate(samples, _stack_collate), t.collate(samples, _stack_collate))
    bare = [s[0] for s in samples]
    _same(j.collate(bare, _stack_collate), t.collate(bare, _stack_collate))
    assert t.seen_shapes == j.seen_shapes
    assert (4, 16) in t.seen_shapes and (4,) in t.seen_shapes


def test_pad_batch_to_repeats_the_last_sample_and_remembers_the_real_size():
    samples = _ragged(3, 3)
    j, t = _both(boundaries=[16], pad_batch_to=5)
    jb, tb = j.collate(samples, _stack_collate), t.collate(samples, _stack_collate)
    _same(jb, tb)
    assert tb[0].shape == (5, 16)
    np.testing.assert_array_equal(tb[0][3], tb[0][2])
    assert t.real_batch_size(tb[0]) == j.real_batch_size(jb[0]) == 3
    assert t.real_batch_size(np.zeros(3)) is None
    full = _ragged(4, 5)
    assert t.real_batch_size(t.collate(full, _stack_collate)[0]) is None


def test_pad_batch_to_passes_tensors_through():
    spec = BucketSpec(boundaries=[4], pad_batch_to=4)
    batch = spec._pad_batch_dim(tp.to_tensor(np.arange(6).reshape(2, 3)))
    assert isinstance(batch, tp.Tensor) and batch.shape == [4, 3]
    assert spec.real_batch_size(batch) == 2
    np.testing.assert_array_equal(batch.numpy()[2:], [[3, 4, 5], [3, 4, 5]])


def test_recompile_budget_warns_once_per_new_shape_past_max_shapes():
    got = {}
    for spec in _both(boundaries=[2], max_shapes=2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for n in (1, 2, 3, 4, 3, 5, 6, 1):  # buckets 2, 2, 4, 4, 4, 6, 6, 2
                spec.apply(np.zeros((1, n)))
        got[type(spec)] = [str(w.message) for w in caught]
        assert len(spec.seen_shapes) == 3
    assert len(got[BucketSpec]) == len(got[JBucketSpec]) == 1
    assert "max_shapes=2" in got[BucketSpec][0] and "(1, 6)" in got[BucketSpec][0]


def test_serving_scheduler_rounds_prompts_with_the_spec():
    from paddle_tpu_torch.serving.scheduler import ServingBuckets

    b = ServingBuckets(block_size=8, prompt_buckets=[8, 16], decode_batch_buckets=[1, 4])
    assert isinstance(b.prompt_spec, BucketSpec)
    assert [b.prompt_bucket(n) for n in (3, 8, 9, 20)] == [8, 8, 16, 32]
    assert b.prompt_spec.seen_shapes == frozenset()
