"""Lazy eager dispatch of the port (FLAGS_eager_lazy_dispatch,
``paddle_tpu_torch/core/lazy.py``), the port of ``tests/test_lazy_dispatch.py``.

Numeric parity against the per-op path (forward and grads, f32 and bf16,
``no_grad``), a failed flush raising on every read, the flush points
(``float``, ``numpy``, ``bool``, ``paddle.device.synchronize``), shape
access without a flush, the data-dependent-shape fallback, segment-cache
reuse, hooks and grad accumulation, double grad, the flag turned off, the
output-spec cache's LRU, ``eager_segment_max_ops``, and the LeNet
3-program guard. ``test_lenet_trains_like_jax_in_every_regime`` runs the
LeNet trainer on both packages, per-op, lazy and captured, and holds the
losses within 1e-5 over 5 steps.
"""
import numpy as np
import pytest

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as F
import paddle_tpu_torch.profiler as prof
from paddle_tpu_torch.core import lazy


@pytest.fixture(autouse=True)
def _cpu():
    previous = paddle.get_device()
    paddle.set_device("cpu")
    lazy.reset_lazy_state()
    prof.reset_dispatch_counters()
    paddle.set_flags({"FLAGS_eager_async_compile": False})
    try:
        yield
    finally:
        lazy.flush_if_pending("test_teardown")
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": False,
                          "FLAGS_eager_step_capture": True,
                          "FLAGS_eager_async_compile": True})
        lazy.reset_lazy_state()
        paddle.set_device(previous)


@pytest.fixture
def lazy_mode():
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True})
    yield


def _mlp_forward(x, w1, b1, w2):
    h = F.relu(paddle.matmul(x, w1) + b1)
    return paddle.matmul(h, w2).sum()


def _make_inputs(dtype="float32"):
    rng = np.random.default_rng(7)
    ts = []
    for shape in ((4, 8), (8, 16), (16,), (16, 2)):
        t = paddle.to_tensor(rng.standard_normal(shape).astype(np.float32))
        if dtype != "float32":
            t = t.astype(dtype)
        t.stop_gradient = False
        ts.append(t)
    return ts


def _f32(t):
    return np.asarray(t.astype("float32").numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_numeric_parity_forward_and_grads(dtype):
    ins_ref = _make_inputs(dtype)
    loss_ref = _mlp_forward(*ins_ref)
    loss_ref.backward()

    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True})
    ins_lazy = [paddle.to_tensor(t.numpy()) for t in ins_ref]
    for t in ins_lazy:
        t.stop_gradient = False
    loss_lazy = _mlp_forward(*ins_lazy)
    assert type(loss_lazy._v) is lazy.LazyRef  # deferred
    loss_lazy.backward()
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})

    np.testing.assert_allclose(_f32(loss_lazy), _f32(loss_ref), rtol=1e-6, atol=1e-6)
    for a, b in zip(ins_lazy, ins_ref):
        np.testing.assert_allclose(_f32(a.grad), _f32(b.grad), rtol=1e-6, atol=1e-6)


def test_no_grad_parity(lazy_mode):
    with paddle.no_grad():
        x = paddle.to_tensor(np.ones((3, 3), np.float32))
        x.stop_gradient = False
        y = (x * 2.0 + 1.0).sum()
        assert y.stop_gradient is True
        assert type(y._v) is lazy.LazyRef
    assert float(y) == pytest.approx(27.0)
    assert y._grad_node is None
    # a later recorded op must not treat the no_grad result as a leaf
    w = paddle.to_tensor(np.ones(4, np.float32))
    w.stop_gradient = False
    with paddle.no_grad():
        feat = w * 3.0
    (feat * w).sum().backward()
    assert feat.grad is None
    np.testing.assert_allclose(w.grad.numpy(), np.full(4, 3.0))


def test_failed_flush_raises_on_every_read(lazy_mode):
    x = paddle.to_tensor(np.ones(4, np.float32))
    y = x * 2.0
    seg = y._v._segment
    seg.ops[0].fn = lambda v: v.reshape(999, 999)  # breaks when the segment runs
    with pytest.raises(Exception):
        y.numpy()
    with pytest.raises(RuntimeError, match="flush failed"):
        y.numpy()


def test_flush_at_float_numpy_and_bool(lazy_mode):
    x = paddle.to_tensor(np.full((2, 2), 3.0, np.float32))
    y = x * 2.0
    assert type(y._v) is lazy.LazyRef
    assert lazy.pending_op_count() == 1
    s = y.sum()
    assert float(s) == pytest.approx(24.0)
    assert lazy.pending_op_count() == 0
    assert not isinstance(y._v, lazy.LazyRef)  # written back on its next read
    z = x + 1.0
    np.testing.assert_allclose(z.numpy(), np.full((2, 2), 4.0))
    c = (x.sum() * 0.0) + 1.0
    assert type(c._v) is lazy.LazyRef
    assert bool(c > 0.5)
    assert lazy.pending_op_count() == 0


def test_shape_access_does_not_flush(lazy_mode):
    x = paddle.to_tensor(np.ones((3, 5), np.float32))
    y = paddle.matmul(x, paddle.to_tensor(np.ones((5, 7), np.float32)))
    assert y.shape == [3, 7]
    assert y.ndim == 2
    assert y.dtype == paddle.float32
    assert y.stop_gradient is True
    assert lazy.pending_op_count() == 1  # answered from the spec


def test_explicit_synchronize_flushes(lazy_mode):
    x = paddle.to_tensor(np.ones(4, np.float32)) * 5.0
    assert lazy.pending_op_count() == 1
    paddle.device.synchronize()
    assert lazy.pending_op_count() == 0
    np.testing.assert_allclose(x.numpy(), np.full(4, 5.0))


def test_data_dependent_shape_forces_flush_and_fallback(lazy_mode):
    x = paddle.to_tensor(np.array([1.0, -2.0, 3.0, -4.0], np.float32))
    y = x * 2.0
    mask = paddle.to_tensor(np.array([True, False, True, False]))
    sel = paddle.masked_select(y, mask)  # its output shape depends on the mask
    np.testing.assert_allclose(sel.numpy(), [2.0, 6.0])
    c = prof.dispatch_counters()
    assert c["flush_reasons"].get("fallback_nojit", 0) >= 1, dict(c["flush_reasons"])
    assert c["op_programs"] >= 1


def test_segment_cache_reuse_second_step_builds_nothing(lazy_mode):
    rng = np.random.default_rng(3)
    w = paddle.to_tensor(rng.standard_normal((6, 6)).astype(np.float32))
    w.stop_gradient = False

    def step():
        x = paddle.to_tensor(np.ones((2, 6), np.float32))
        loss = F.relu(paddle.matmul(x, w)).sum()
        loss.backward()
        g = w.grad.numpy().copy()
        w.clear_grad()
        return g

    g1 = step()
    prof.reset_dispatch_counters()
    g2 = step()
    c = prof.dispatch_counters()
    assert c["segment_cache_misses"] == 0
    assert c["segment_cache_hits"] >= 1
    np.testing.assert_array_equal(g1, g2)


def _hook_scenario():
    x = paddle.to_tensor(np.array([2.0, 3.0], np.float32))
    x.stop_gradient = False
    seen = []
    x.register_hook(lambda g: seen.append(g.numpy().copy()))
    (x * x).sum().backward()
    (x * 4.0).sum().backward()
    return x.grad.numpy().copy(), seen


def test_backward_hooks_and_grad_accumulation(lazy_mode):
    grad_lazy, seen_lazy = _hook_scenario()
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})
    grad_ref, seen_ref = _hook_scenario()
    assert len(seen_lazy) == len(seen_ref) == 2
    for a, b in zip(seen_lazy, seen_ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(grad_lazy, grad_ref)
    np.testing.assert_allclose(grad_lazy, [4.0 + 4.0, 6.0 + 4.0])


def test_double_grad_through_lazy_segments(lazy_mode):
    x = paddle.to_tensor(np.array(3.0, np.float32))
    x.stop_gradient = False
    y = x * x * x
    assert type(y._v) is lazy.LazyRef
    (gx,) = paddle.grad(y, [x], create_graph=True)
    (ggx,) = paddle.grad(gx, [x])
    assert float(gx) == pytest.approx(27.0)
    assert float(ggx) == pytest.approx(18.0)


def test_flag_off_restores_per_op_path():
    assert not paddle.get_flags("FLAGS_eager_lazy_dispatch")["FLAGS_eager_lazy_dispatch"]
    x = paddle.to_tensor(np.ones((2, 2), np.float32))
    y = x + 1.0
    assert not isinstance(y._v, lazy.LazyRef)
    c = prof.dispatch_counters()
    assert c["op_programs"] >= 1
    assert c["lazy_ops_deferred"] == 0


def test_spec_cache_lru_eviction(lazy_mode):
    """The output-spec cache is bounded by FLAGS_eager_jit_cache_size (the
    JAX package bounds its per-op jit cache by the same flag)."""
    paddle.set_flags({"FLAGS_eager_jit_cache_size": 4})
    try:
        x = paddle.to_tensor(np.ones((2, 2), np.float32))
        for k in range(8):  # distinct static arguments: distinct entries
            paddle.clip(x, min=-float(k + 1), max=float(k + 1))
        paddle.device.synchronize()
        assert len(lazy._spec_cache) <= 4
        assert prof.dispatch_counters()["jit_cache_evictions"] >= 1
    finally:
        paddle.set_flags({"FLAGS_eager_jit_cache_size": 4096})


def test_segment_max_ops_bounds_segment_length(lazy_mode):
    paddle.set_flags({"FLAGS_eager_segment_max_ops": 4})
    try:
        x = paddle.to_tensor(np.ones(3, np.float32))
        for _ in range(9):
            x = x + 1.0
        c = prof.dispatch_counters()
        assert c["flush_reasons"].get("segment_limit", 0) == 2
        assert lazy.pending_op_count() == 1
        np.testing.assert_allclose(x.numpy(), np.full(3, 10.0))
    finally:
        paddle.set_flags({"FLAGS_eager_segment_max_ops": 256})


def _lenet_step(mod, batch=4):
    mod.seed(0)
    model = mod.vision.models.LeNet()
    opt = mod.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = mod.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = mod.to_tensor(rng.standard_normal((batch, 1, 28, 28)).astype(np.float32))
    y = mod.to_tensor(rng.integers(0, 10, (batch,)))

    def step():
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, step


def test_lenet_program_budget_regression_guard(lazy_mode):
    """The steady-state eager LeNet train step is at most 3 programs under
    lazy dispatch (1 forward segment + 1 backward + 1 optimizer update)."""
    paddle.set_flags({"FLAGS_eager_step_capture": False})
    _, step = _lenet_step(paddle)
    for _ in range(2):
        loss = step()
    float(loss)
    prof.reset_dispatch_counters()
    float(step())
    c = prof.dispatch_counters()
    assert c["programs"] <= 3, dict(c)
    assert c["segment_cache_misses"] == 0, dict(c)


def test_lenet_trains_like_jax_in_every_regime():
    """The LeNet trainer on both packages, the port's weights carried over
    from the JAX model's: per-op, lazy (capture off) and captured, 5 Adam
    steps each, losses within 1e-5 of the JAX package's in the same regime;
    the port's lazy and captured losses bitwise its per-op ones."""
    import paddle_tpu as jpaddle
    from paddle_tpu.core import lazy as jlazy
    from paddle_tpu_torch.convert import state_dict_from_numpy

    regimes = {"per_op": (False, False), "lazy": (True, False), "captured": (True, True)}
    got = {}
    for name, (lazy_on, capture) in regimes.items():
        flags = {"FLAGS_eager_lazy_dispatch": lazy_on, "FLAGS_eager_step_capture": capture,
                 "FLAGS_eager_async_compile": False}
        jmodel, jstep = _lenet_step(jpaddle)
        tmodel, tstep = _lenet_step(paddle)
        state_dict_from_numpy(tmodel, {k: np.asarray(v.numpy())
                                       for k, v in jmodel.state_dict().items()})
        jpaddle.set_flags(flags)
        try:
            jl = [float(jstep()) for _ in range(5)]
        finally:
            jlazy.flush_if_pending("test_teardown")
            jpaddle.set_flags({"FLAGS_eager_lazy_dispatch": False,
                               "FLAGS_eager_step_capture": True,
                               "FLAGS_eager_async_compile": True})
            jlazy._tls.observer = None  # no JAX state outlives the test
            jlazy._capture_cache.clear()
        paddle.set_flags(flags)
        lazy.reset_lazy_state()
        tl = [float(tstep()) for _ in range(5)]
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5, err_msg=name)
        got[name] = tl
    assert got["lazy"] == got["per_op"]
    assert got["captured"] == got["per_op"]
