"""Whole-step capture of the port (FLAGS_eager_step_capture under lazy
dispatch, ``paddle_tpu_torch/core/lazy.py``), the port of the capture tests
of ``tests/test_step_capture.py`` that need no mesh, memory planner or
analysis pass (those stay with ROADMAP queue 1 items 12 and 13).

On the CPU a captured program runs its step function eagerly and counts as
one program, so these tests hold the controller: the 1- and 3-program
counts (equal to the JAX package's for the same LeNet trainer), bitwise
parity with the per-op path, fresh batches, every fallback trigger under
its reason, the LRU, the clip kinds, gradient-accumulation cycles,
FLAGS_eager_async_compile (accepted, no effect) and layers changed
between steps (a new op key, bitwise the per-op steps).
``tests/test_torch_cuda_kernels.py`` holds a captured step on the card.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
import paddle_tpu_torch.profiler as prof
from paddle_tpu_torch.core import lazy


def _reset_flags():
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_eager_step_capture": True,
                      "FLAGS_eager_async_compile": True, "FLAGS_eager_capture_cache_size": 8})


@pytest.fixture
def capture_mode():
    previous = paddle.get_device()
    paddle.set_device("cpu")
    lazy.reset_lazy_state()
    prof.reset_dispatch_counters()
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": True,
                      "FLAGS_eager_async_compile": False})
    try:
        yield
    finally:
        lazy.flush_if_pending("test_teardown")
        _reset_flags()
        lazy.reset_lazy_state()
        paddle.set_device(previous)


def _mlp_trainer(seed=0, lr=1e-2, bsz=4):
    paddle.seed(seed)
    model = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                 paddle.nn.Linear(16, 4))
    opt = paddle.optimizer.Adam(learning_rate=lr, parameters=model.parameters())
    loss_fn = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(7)
    x = paddle.to_tensor(rng.standard_normal((bsz, 8)).astype(np.float32))
    y = paddle.to_tensor(rng.integers(0, 4, (bsz,)))

    def step(xt=None, yt=None):
        loss = loss_fn(model(xt if xt is not None else x), yt if yt is not None else y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, step, (x, y)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _snapshot(model, opt):
    params = [_np(p) for p in model.parameters()]
    states = [{k: _np(v) for k, v in (opt._accumulators.get(id(p)) or {}).items()}
              for p in model.parameters()]
    return params, states


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _lenet_trainer(mod):
    mod.seed(0)
    model = mod.vision.models.LeNet()
    opt = mod.optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = mod.nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = mod.to_tensor(rng.standard_normal((4, 1, 28, 28)).astype(np.float32))
    y = mod.to_tensor(rng.integers(0, 10, (4,)))

    def step():
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


_CATEGORIES = ("programs", "captured_programs", "capture_replays", "segment_programs",
               "backward_programs", "optimizer_programs")


def _jax_counts(capture: bool):
    import paddle_tpu as jpaddle
    import paddle_tpu.profiler as jprof
    from paddle_tpu.core import lazy as jlazy

    jlazy._tls.observer = None
    jlazy._capture_cache.clear()
    jpaddle.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": capture,
                       "FLAGS_eager_async_compile": False})
    try:
        c = jprof.measure_programs(_lenet_trainer(jpaddle), warmup=2)
    finally:
        jlazy.flush_if_pending("test_teardown")
        jpaddle.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_eager_step_capture": True,
                           "FLAGS_eager_async_compile": True})
        jlazy._tls.observer = None
        jlazy._capture_cache.clear()
    return {k: c[k] for k in _CATEGORIES}


# -- the budget: 1 program captured, 3 not, as in the JAX package ------------
def test_lenet_captured_step_is_one_program(capture_mode):
    step = _lenet_trainer(paddle)
    c = prof.measure_programs(step, warmup=2)
    assert c["programs"] == 1, c
    assert c["captured_programs"] == 1, c
    assert c["capture_replays"] == 1, c
    assert c["segment_programs"] == 0, c
    assert c["backward_programs"] == 0, c
    assert c["optimizer_programs"] == 0, c
    assert c["_capture_state"]["armed"] is True
    c2 = prof.measure_programs(step, warmup=1)
    assert c2["programs"] == 1 and c2["capture_builds"] == 0, c2
    assert {k: c[k] for k in _CATEGORIES} == _jax_counts(True)


def test_lenet_capture_off_is_three_programs(capture_mode):
    paddle.set_flags({"FLAGS_eager_step_capture": False})
    c = prof.measure_programs(_lenet_trainer(paddle), warmup=2)
    assert c["programs"] == 3, c
    assert c["captured_programs"] == 0, c
    assert c["segment_programs"] == 1, c
    assert c["backward_programs"] == 1, c
    assert c["optimizer_programs"] == 1, c
    assert {k: c[k] for k in _CATEGORIES} == _jax_counts(False)


def test_per_op_unit_counts_paddle_level_calls(capture_mode):
    """Per-op, the port's unit is one Paddle-level call (the model, the
    criterion), one backward sweep and one update: 4 for the LeNet step,
    where the JAX package launches one XLA program per op (~13)."""
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})
    c = prof.measure_programs(_lenet_trainer(paddle), warmup=1)
    assert (c["programs"], c["op_programs"], c["backward_programs"],
            c["optimizer_programs"]) == (4, 2, 1, 1), c


# -- parity ------------------------------------------------------------------
def _run_reference(n_steps):
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})
    try:
        model, opt, step, _ = _mlp_trainer()
        losses = [float(step()) for _ in range(n_steps)]
        return losses, _snapshot(model, opt)
    finally:
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": True})


def test_captured_numerics_bitwise_match_per_op(capture_mode):
    n = 5  # warm-up (2) + captured steps (3)
    losses_ref, (p_ref, s_ref) = _run_reference(n)
    model, opt, step, _ = _mlp_trainer()
    losses = [float(step()) for _ in range(n)]
    assert prof.dispatch_counters()["capture_replays"] >= 3
    assert losses == losses_ref
    p_cap, s_cap = _snapshot(model, opt)
    _assert_same(p_cap, p_ref)
    for a, b in zip(s_cap, s_ref):
        assert sorted(a) == sorted(b)
        _assert_same([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])


def test_fresh_batches_replay_and_match(capture_mode):
    def run(lazy_on, n=6):
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on,
                          "FLAGS_eager_step_capture": lazy_on})
        paddle.seed(0)
        model = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                     paddle.nn.Linear(16, 4))
        opt = paddle.optimizer.AdamW(learning_rate=1e-2, weight_decay=0.01,
                                     parameters=model.parameters())
        loss_fn = paddle.nn.CrossEntropyLoss()
        rng = np.random.default_rng(11)
        losses = []
        for _ in range(n):
            x = paddle.to_tensor(rng.standard_normal((4, 8)).astype(np.float32))
            y = paddle.to_tensor(rng.integers(0, 4, (4,)))
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses, [_np(p) for p in model.parameters()]

    l_ref, p_ref = run(False)
    prof.reset_dispatch_counters()
    l_cap, p_cap = run(True)
    c = prof.dispatch_counters()
    assert c["capture_replays"] >= 4, dict(c)
    assert c["capture_fallbacks"] == 0, dict(c)
    assert l_ref == l_cap
    _assert_same(p_ref, p_cap)


def test_captured_step_still_exposes_grads(capture_mode):
    loss_fn = paddle.nn.CrossEntropyLoss()

    def run(lazy_on):
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on})
        model, opt, _, (x, y) = _mlp_trainer()
        for i in range(4):
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            if i == 3:
                grads = [_np(p.grad) for p in model.parameters()]
            opt.clear_grad()
        return grads

    ref = run(False)
    got = run(True)
    assert prof.dispatch_counters()["capture_replays"] >= 1
    _assert_same(got, ref)


def test_second_backward_after_captured_step_raises(capture_mode):
    _model, _opt, step, _ = _mlp_trainer()
    for _ in range(4):
        loss = step()
    assert prof.dispatch_counters()["capture_replays"] >= 1
    with pytest.raises(RuntimeError, match="second time"):
        loss.backward()


def test_returned_loss_keeps_its_value_after_the_next_replay(capture_mode):
    _model, _opt, step, _ = _mlp_trainer()
    losses = [step() for _ in range(6)]
    values = [float(v) for v in losses]
    assert prof.dispatch_counters()["capture_replays"] >= 3
    assert len(set(values)) == len(values)  # each step's own value


# -- fallbacks: counted, never a change of numerics ---------------------------
def test_hooks_prevent_capture_with_identical_results(capture_mode):
    losses_ref, (p_ref, _) = _run_reference(4)
    model, opt, step, _ = _mlp_trainer()
    seen = []
    list(model.parameters())[0].register_hook(lambda g: seen.append(_np(g)))
    losses = [float(step()) for _ in range(4)]
    c = prof.dispatch_counters()
    assert c["capture_replays"] == 0, dict(c)
    assert c["capture_fallback_reasons"].get("tape_ineligible", 0) >= 1, dict(c)
    assert losses == losses_ref
    assert len(seen) == 4
    _assert_same(_snapshot(model, opt)[0], p_ref)


def test_retain_graph_step_takes_normal_path(capture_mode):
    model, opt, _, (x, y) = _mlp_trainer()
    loss_fn = paddle.nn.CrossEntropyLoss()
    for _ in range(3):
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert prof.dispatch_counters()["capture_replays"] >= 1
    loss = loss_fn(model(x), y)
    loss.backward(retain_graph=True)
    g1 = _np(list(model.parameters())[0].grad)
    loss.backward()
    g2 = _np(list(model.parameters())[0].grad)
    np.testing.assert_allclose(g2, 2.0 * g1, rtol=1e-6, atol=1e-7)
    opt.step()
    opt.clear_grad()


def test_shape_change_falls_back_and_recaptures(capture_mode):
    model, opt, step, _ = _mlp_trainer()
    rng = np.random.default_rng(3)
    x6 = paddle.to_tensor(rng.standard_normal((6, 8)).astype(np.float32))
    y6 = paddle.to_tensor(rng.integers(0, 4, (6,)))
    for _ in range(3):
        step()
    assert prof.dispatch_counters()["capture_replays"] >= 1
    prof.reset_dispatch_counters()
    float(step(x6, y6))
    c = prof.dispatch_counters()
    assert c["capture_replays"] == 0, dict(c)
    assert c["capture_fallbacks"] >= 1, dict(c)
    assert c["capture_fallback_reasons"].get("signature_mismatch", 0) >= 1, dict(c)
    assert c["programs"] == 3, dict(c)
    # the first shape arms again after the warm-up and replays its cached program
    prof.reset_dispatch_counters()
    for _ in range(3):
        step()
    c = prof.dispatch_counters()
    assert c["capture_replays"] >= 1, dict(c)
    assert c["capture_builds"] == 0, dict(c)


def test_grad_read_between_backward_and_step_aborts(capture_mode):
    loss_fn = paddle.nn.CrossEntropyLoss()

    def run(lazy_on):
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on})
        model, opt, step, (x, y) = _mlp_trainer()
        for _ in range(3):
            step()
        loss = loss_fn(model(x), y)
        loss.backward()  # deferred when armed
        prof.reset_dispatch_counters()
        got = _np(list(model.parameters())[0].grad)
        c = dict(prof.dispatch_counters())
        opt.step()
        opt.clear_grad()
        return got, _snapshot(model, opt)[0], c

    ref_grad, p_ref, _ = run(False)
    got, p_cap, c = run(True)
    np.testing.assert_array_equal(got, ref_grad)
    assert c["capture_fallbacks"] >= 1, c
    assert c["capture_fallback_reasons"].get("sync", 0) >= 1, c
    _assert_same(p_cap, p_ref)


def test_loss_read_between_backward_and_step_aborts(capture_mode):
    model, opt, _, (x, y) = _mlp_trainer()
    loss_fn = paddle.nn.CrossEntropyLoss()
    for _ in range(3):
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        float(loss)
    loss = loss_fn(model(x), y)
    loss.backward()  # deferred
    prof.reset_dispatch_counters()
    v = float(loss)  # a host read resolves the deferred step
    assert np.isfinite(v)
    c = prof.dispatch_counters()
    assert c["capture_fallbacks"] >= 1, dict(c)
    assert c["capture_fallback_reasons"].get("sync", 0) >= 1, dict(c)
    opt.step()
    opt.clear_grad()


def test_flag_off_between_backward_and_step_is_honored(capture_mode):
    model, opt, step, (x, y) = _mlp_trainer()
    loss_fn = paddle.nn.CrossEntropyLoss()
    for _ in range(3):
        step()
    assert prof.dispatch_counters()["capture_replays"] >= 1
    loss = loss_fn(model(x), y)
    loss.backward()  # deferred
    paddle.set_flags({"FLAGS_eager_step_capture": False})
    prof.reset_dispatch_counters()
    opt.step()
    opt.clear_grad()
    c = prof.dispatch_counters()
    assert c["capture_replays"] == 0, dict(c)
    assert c["capture_fallback_reasons"].get("capture_disabled", 0) == 1, dict(c)
    assert np.isfinite(float(loss))


def test_capture_without_donation_still_one_program(capture_mode):
    """FLAGS_eager_capture_donate=0 keeps the 1-program captured step: a
    CUDA graph writes parameters in place either way."""
    paddle.set_flags({"FLAGS_eager_capture_donate": False})
    try:
        losses_ref, (p_ref, _) = _run_reference(5)
        model, opt, step, _ = _mlp_trainer()
        losses = [float(step()) for _ in range(4)]
        c = prof.measure_programs(step, warmup=0)
        assert c["programs"] == 1 and c["captured_programs"] == 1, c
        losses.append(float(c["_step_result"]))
        assert losses == losses_ref
        _assert_same(_snapshot(model, opt)[0], p_ref)
    finally:
        paddle.set_flags({"FLAGS_eager_capture_donate": True})


def test_capture_build_error_falls_back_not_crashes(capture_mode, monkeypatch):
    losses_ref, (p_ref, _) = _run_reference(4)
    model, opt, step, _ = _mlp_trainer()
    losses = [float(step()) for _ in range(2)]  # armed, nothing captured yet

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(lazy, "_build_captured_step", boom)
    losses += [float(step()) for _ in range(2)]
    c = prof.dispatch_counters()
    assert c["capture_fallback_reasons"].get("capture_error", 0) >= 1, dict(c)
    assert c["capture_replays"] == 0, dict(c)
    assert losses == losses_ref
    _assert_same(_snapshot(model, opt)[0], p_ref)


def test_capture_cache_lru_eviction(capture_mode):
    paddle.set_flags({"FLAGS_eager_capture_cache_size": 1})
    _m1, _o1, step1, _ = _mlp_trainer(seed=0)
    _m2, _o2, step2, _ = _mlp_trainer(seed=1, bsz=6)
    for _ in range(3):
        step1()
    for _ in range(3):
        step2()
    c = prof.dispatch_counters()
    assert c["capture_builds"] == 2, dict(c)
    assert c["capture_evictions"] >= 1, dict(c)
    assert len(lazy._capture_cache) <= 1


def test_per_param_hyper_change_misses_capture_cache(capture_mode):
    """A new optimizer with other per-parameter hypers over the same
    parameters must not replay the old program: bitwise the per-op run."""

    def run(lazy_on):
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on,
                          "FLAGS_eager_step_capture": lazy_on})
        paddle.seed(0)
        model = paddle.nn.Sequential(paddle.nn.Linear(8, 8), paddle.nn.ReLU(),
                                     paddle.nn.Linear(8, 4))
        loss_fn = paddle.nn.CrossEntropyLoss()
        rng = np.random.default_rng(5)
        x = paddle.to_tensor(rng.standard_normal((4, 8)).astype(np.float32))
        y = paddle.to_tensor(rng.integers(0, 4, (4,)))

        def train(opt, n):
            for _ in range(n):
                loss = loss_fn(model(x), y)
                loss.backward()
                opt.step()
                opt.clear_grad()

        opt_a = paddle.optimizer.AdamW(learning_rate=1e-2, weight_decay=0.5,
                                       parameters=model.parameters())
        train(opt_a, 3)
        opt_b = paddle.optimizer.AdamW(learning_rate=1e-2, weight_decay=0.5,
                                       parameters=model.parameters(),
                                       apply_decay_param_fun=lambda name: False)
        opt_b._accumulators = opt_a._accumulators
        train(opt_b, 3)
        return [_np(p) for p in model.parameters()]

    params_ref = run(False)
    prof.reset_dispatch_counters()
    params_cap = run(True)
    c = prof.dispatch_counters()
    assert c["capture_replays"] >= 1, dict(c)
    assert c["capture_fallback_reasons"].get("optimizer_mismatch", 0) >= 1, dict(c)
    _assert_same(params_cap, params_ref)


def test_aux_output_backward_prevents_capture(capture_mode):
    model, opt, _, (x, y) = _mlp_trainer()
    loss_fn = paddle.nn.CrossEntropyLoss()
    w = paddle.to_tensor(np.ones(4, np.float32))
    w.stop_gradient = False
    auxes = []
    for _ in range(4):
        aux = (w * 3.0).sum()  # recorded, not an ancestor of the loss
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        auxes.append(aux)
        w.clear_grad()
    c = prof.dispatch_counters()
    assert c["capture_replays"] == 0, dict(c)
    assert c["capture_fallback_reasons"].get("non_tape_recorded_ops", 0) >= 1, dict(c)
    auxes[-1].backward()
    np.testing.assert_allclose(w.grad.numpy(), np.full(4, 3.0))


def _armed_then(lazy_on, between):
    """Three steps, then a fourth whose backward is deferred when armed,
    ``between(model, opt)`` before its step(). Returns what ``between``
    returned and the parameters after the step."""
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on, "FLAGS_eager_step_capture": lazy_on})
    model, opt, step, (x, y) = _mlp_trainer()
    loss_fn = paddle.nn.CrossEntropyLoss()
    for _ in range(3):
        step()
    loss = loss_fn(model(x), y)
    loss.backward()
    out = between(model, opt)
    opt.step()
    opt.clear_grad()
    return out, [_np(p) for p in model.parameters()]


def test_grad_write_between_backward_and_step_aborts(capture_mode):
    """A grad read at backward() time (aborts: ``sync``), then written: the
    update uses the user's grad, the saved one holds the real value."""

    def between(model, opt):
        p0 = list(model.parameters())[0]
        saved = p0.grad
        p0.grad = torch.zeros(p0.shape)
        return _np(saved)

    saved_ref, params_ref = _armed_then(False, between)
    prof.reset_dispatch_counters()
    saved_cap, params_cap = _armed_then(True, between)
    assert prof.dispatch_counters()["capture_fallbacks"] >= 1
    np.testing.assert_array_equal(saved_cap, saved_ref)
    _assert_same(params_cap, params_ref)


def test_grad_write_alone_is_honoured_as_grad_replaced(capture_mode):
    """A grad written without a read first: the step resolves on the
    3-program path under ``grad_replaced`` and updates with the user's grad."""

    def between(model, opt):
        p0 = list(model.parameters())[0]
        p0.grad = torch.full(p0.shape, 0.5)

    _, params_ref = _armed_then(False, between)
    prof.reset_dispatch_counters()
    _, params_cap = _armed_then(True, between)
    c = prof.dispatch_counters()
    assert c["capture_fallback_reasons"].get("grad_replaced", 0) == 1, dict(c)
    _assert_same(params_cap, params_ref)


def test_grad_clear_between_backward_and_step_aborts(capture_mode):
    def read_then_clear(model, opt):
        saved = [_np(p.grad) for p in model.parameters()]
        opt.clear_grad()
        return saved

    saved_ref, params_ref = _armed_then(False, read_then_clear)
    saved_cap, params_cap = _armed_then(True, read_then_clear)
    _assert_same(saved_cap, saved_ref)
    _assert_same(params_cap, params_ref)
    # cleared without a read: no update at all, under grad_replaced
    _, params_ref = _armed_then(False, lambda m, o: o.clear_grad())
    prof.reset_dispatch_counters()
    _, params_cap = _armed_then(True, lambda m, o: o.clear_grad())
    assert prof.dispatch_counters()["capture_fallback_reasons"].get("grad_replaced", 0) == 1
    _assert_same(params_cap, params_ref)


def test_dispatch_counters_expose_capture_keys():
    c = prof.dispatch_counters()
    for k in ("captured_programs", "capture_builds", "capture_replays", "capture_fallbacks",
              "capture_evictions", "capture_fallback_reasons", "flush_reasons",
              "trace_time_ms", "compile_time_ms", "replay_time_ms", "async_compile_ms"):
        assert k in c, k


# -- grad clipping inside the captured step -----------------------------------
_CLIP_MAKERS = {
    "global_norm": lambda: paddle.nn.ClipGradByGlobalNorm(0.5),
    "norm": lambda: paddle.nn.ClipGradByNorm(0.5),
    "value": lambda: paddle.nn.ClipGradByValue(0.01),
}


def _clip_trainer(clip_maker, accum=1, seed=0, lr=1e-2, bsz=4):
    paddle.seed(seed)
    model = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                 paddle.nn.Linear(16, 4))
    opt = paddle.optimizer.Adam(learning_rate=lr, parameters=model.parameters(),
                                grad_clip=clip_maker() if clip_maker else None)
    loss_fn = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(7)
    x = paddle.to_tensor(rng.standard_normal((bsz, 8)).astype(np.float32))
    y = paddle.to_tensor(rng.integers(0, 4, (bsz,)))

    def cycle():
        for _ in range(accum):
            loss = loss_fn(model(x), y)
            loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return model, opt, cycle


def _run_cycles(lazy_on, clip_maker, accum, n):
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on, "FLAGS_eager_step_capture": lazy_on})
    try:
        model, opt, cycle = _clip_trainer(clip_maker, accum)
        losses = [float(cycle()) for _ in range(n + 1)]
        return losses, _snapshot(model, opt)
    finally:
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": True})


def _assert_states(s_cap, s_ref):
    for a, b in zip(s_cap, s_ref):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("clip_kind", sorted(_CLIP_MAKERS))
def test_grad_clip_steps_capture_bitwise(capture_mode, clip_kind):
    maker = _CLIP_MAKERS[clip_kind]
    l_ref, (p_ref, s_ref) = _run_cycles(False, maker, 1, 5)
    prof.reset_dispatch_counters()
    l_cap, (p_cap, s_cap) = _run_cycles(True, maker, 1, 5)
    c = prof.dispatch_counters()
    assert c["capture_replays"] >= 3, dict(c)
    assert c["capture_fallbacks"] == 0, dict(c)
    assert dict(c["capture_fallback_reasons"]) == {}
    assert l_cap == l_ref
    _assert_same(p_cap, p_ref)
    _assert_states(s_cap, s_ref)


def test_grad_clip_captured_step_is_one_program(capture_mode):
    _model, _opt, cycle = _clip_trainer(_CLIP_MAKERS["global_norm"])
    c = prof.measure_programs(cycle, warmup=3)
    assert c["programs"] == 1, c
    assert c["captured_programs"] == 1, c
    assert c["capture_fallbacks"] == 0, c


def test_grad_clip_unclipped_grads_written_back(capture_mode):
    """After a captured clipped step, p.grad holds the UNCLIPPED gradient."""

    def run(lazy_on):
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on,
                          "FLAGS_eager_step_capture": lazy_on})
        model, opt, cycle = _clip_trainer(_CLIP_MAKERS["value"])
        for _ in range(4):
            cycle()
        loss_fn = paddle.nn.CrossEntropyLoss()
        x = paddle.to_tensor(np.ones((4, 8), np.float32))
        y = paddle.to_tensor(np.zeros((4,), np.int64))
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        grads = [_np(p.grad) for p in model.parameters()]
        opt.clear_grad()
        return grads

    g_ref = run(False)
    prof.reset_dispatch_counters()
    g_cap = run(True)
    assert prof.dispatch_counters()["capture_replays"] >= 1
    _assert_same(g_cap, g_ref)
    assert any(np.abs(a).max() > 0.01 for a in g_cap)


def test_custom_clip_subclass_stays_on_eager_path(capture_mode):
    class Halver(paddle.nn.ClipGradByGlobalNorm):
        def _clip(self, params_grads):
            return [(p, None if g is None else g * 0.5) for p, g in params_grads]

    def run(lazy_on, n=5):
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on,
                          "FLAGS_eager_step_capture": lazy_on})
        model, opt, cycle = _clip_trainer(lambda: Halver(0.5))
        return [float(cycle()) for _ in range(n)], _snapshot(model, opt)

    l_ref, (p_ref, _) = run(False)
    prof.reset_dispatch_counters()
    l_cap, (p_cap, _) = run(True)
    assert prof.dispatch_counters()["capture_replays"] == 0
    assert l_cap == l_ref
    _assert_same(p_cap, p_ref)


# -- gradient accumulation: a periodic signature ------------------------------
@pytest.mark.parametrize("k", [2, 4])
def test_accumulation_cycle_captures_bitwise(capture_mode, k):
    l_ref, (p_ref, s_ref) = _run_cycles(False, None, k, 4)
    prof.reset_dispatch_counters()
    l_cap, (p_cap, s_cap) = _run_cycles(True, None, k, 4)
    c = prof.dispatch_counters()
    assert c["capture_replays"] >= 2, dict(c)
    assert c["capture_accum_replays"] >= 2 * (k - 1), dict(c)
    assert c["capture_fallbacks"] == 0, dict(c)
    assert dict(c["capture_fallback_reasons"]) == {}
    assert l_cap == l_ref
    _assert_same(p_cap, p_ref)
    _assert_states(s_cap, s_ref)


def test_accumulation_with_clip_captures_bitwise(capture_mode):
    maker = _CLIP_MAKERS["global_norm"]
    l_ref, (p_ref, _) = _run_cycles(False, maker, 2, 4)
    prof.reset_dispatch_counters()
    l_cap, (p_cap, _) = _run_cycles(True, maker, 2, 4)
    c = prof.dispatch_counters()
    assert c["capture_replays"] >= 2, dict(c)
    assert c["capture_accum_replays"] >= 2, dict(c)
    assert c["capture_fallbacks"] == 0, dict(c)
    assert l_cap == l_ref
    _assert_same(p_cap, p_ref)


def test_accumulation_update_step_is_one_program(capture_mode):
    """Per-cycle budget at k=4: 3 accumulate programs + 1 update program."""
    _model, _opt, cycle = _clip_trainer(None, accum=4)
    c = prof.measure_programs(cycle, warmup=4)
    assert c["programs"] == 4, c
    assert c["captured_programs"] == 4, c
    assert c["capture_replays"] == 1, c
    assert c["capture_accum_replays"] == 3, c
    assert c["capture_fallbacks"] == 0, c
    assert c["_capture_state"]["cycle_len"] == 4, c["_capture_state"]


def test_accumulation_grad_read_mid_cycle_aborts_correctly(capture_mode):
    def run(lazy_on, k=2):
        paddle.set_flags({"FLAGS_eager_lazy_dispatch": lazy_on,
                          "FLAGS_eager_step_capture": lazy_on})
        model, opt, cycle = _clip_trainer(None, accum=k)
        for _ in range(4):
            cycle()
        loss_fn = paddle.nn.CrossEntropyLoss()
        x = paddle.to_tensor(np.ones((4, 8), np.float32))
        y = paddle.to_tensor(np.zeros((4,), np.int64))
        for _ in range(k):
            loss = loss_fn(model(x), y)
            loss.backward()
        g = _np(list(model.parameters())[0].grad)
        opt.step()
        opt.clear_grad()
        return g, [_np(p) for p in model.parameters()]

    g_ref, p_ref = run(False)
    prof.reset_dispatch_counters()
    g_cap, p_cap = run(True)
    assert prof.dispatch_counters()["capture_fallbacks"] >= 1
    np.testing.assert_array_equal(g_cap, g_ref)
    _assert_same(p_cap, p_ref)


# -- a layer changed between steps: a new key, never a stale program ----------
class _StateNet(paddle.nn.Layer):
    """An MLP whose forward reads batch norm's and dropout's modes, an
    activation sublayer and a plain attribute."""

    def __init__(self, dropout):
        super().__init__()
        self.fc1 = paddle.nn.Linear(8, 16)
        self.bn = paddle.nn.BatchNorm1D(16)
        self.act = paddle.nn.ReLU()
        self.drop = paddle.nn.Dropout(dropout)
        self.fc2 = paddle.nn.Linear(16, 4)
        self.scale = 1.0

    def forward(self, x):
        return self.fc2(self.drop(self.act(self.bn(self.fc1(x))))) * self.scale


def _change_layer(model, change):
    if change == "bn_eval":
        model.bn.eval()
    elif change == "dropout_eval":
        model.drop.eval()
    elif change == "swap_activation":
        model.act = paddle.nn.Tanh()
    elif change == "swap_sublayer":
        model.fc2 = paddle.nn.Linear(16, 4)
    elif change == "attribute":
        model.scale = 0.5
    elif change == "freeze":
        model.fc1.weight.requires_grad_(False)
    elif change == "forward_hook":
        model.bn.register_forward_post_hook(lambda layer, inputs, out: out * 2.0)
    else:
        raise ValueError(change)


_LAYER_CHANGES = ["bn_eval", "dropout_eval", "swap_activation", "swap_sublayer", "attribute",
                  "freeze", "forward_hook"]


@pytest.mark.parametrize("change", _LAYER_CHANGES)
def test_layer_key_tracks_the_layer_state(capture_mode, change):
    """A sublayer's mode, a replaced sublayer, an attribute, a frozen
    parameter or a new hook gives the layer another op key; a training step
    leaves it as it was."""
    paddle.seed(0)
    model = _StateNet(0.5)
    opt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    x = paddle.to_tensor(np.ones((4, 8), np.float32))
    key = lazy.layer_key(model)
    model(x).sum().backward()
    opt.step()
    opt.clear_grad()
    assert lazy.layer_key(model) == key
    _change_layer(model, change)
    assert lazy.layer_key(model) != key


def test_equal_stateless_layers_share_a_key_and_copies_do_not(capture_mode):
    """Two equal criteria are one op, as the JAX package keys them; a
    deep copy of a model, which has parameters of its own, is not the
    model."""
    import copy

    assert lazy.layer_key(paddle.nn.CrossEntropyLoss()) == lazy.layer_key(
        paddle.nn.CrossEntropyLoss())
    assert lazy.layer_key(paddle.nn.CrossEntropyLoss()) != lazy.layer_key(
        paddle.nn.CrossEntropyLoss(reduction="sum"))
    model = _StateNet(0.0)
    assert lazy.layer_key(copy.deepcopy(model)) != lazy.layer_key(model)


def _state_net_run(change, steps=9, at=4):
    """``steps`` Adam steps of _StateNet (dropout 0.5, BN in training) on
    fixed batches, with ``change`` made before step ``at``: the losses, the
    parameters and moments, and the counters of the steps from ``at`` on."""
    paddle.seed(0)
    model = _StateNet(0.5)
    opt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=model.parameters())
    loss_fn = paddle.nn.CrossEntropyLoss()
    rng = np.random.default_rng(3)
    x = paddle.to_tensor(rng.standard_normal((6, 8)).astype(np.float32))
    y = paddle.to_tensor(rng.integers(0, 4, (6,)))
    losses = []
    for i in range(steps):
        if i == at:
            _change_layer(model, change)
            if change == "swap_sublayer":  # the new parameters train too
                opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                            parameters=model.parameters())
            prof.reset_dispatch_counters()
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss)
    values = [float(v) for v in losses]
    params = [_np(p) for p in model.parameters()]
    params += [_np(b) for b in model.buffers()]
    params += [_np(v) for p in model.parameters() for v in (opt._accumulators.get(id(p)) or {})
               .values()]
    return values, params, dict(prof.dispatch_counters())


@pytest.mark.parametrize("regime", ["lazy", "captured"])
@pytest.mark.parametrize("change", _LAYER_CHANGES[:-1])
def test_layer_changed_between_steps_matches_per_op(capture_mode, regime, change):
    """A layer changed between steps after its segment (lazy) or its whole
    step (captured) was built: the next step builds anew, and every step is
    bitwise the per-op step, BN statistics and Adam moments included."""
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False})
    ref = _state_net_run(change)
    lazy.reset_lazy_state()
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True,
                      "FLAGS_eager_step_capture": regime == "captured"})
    got = _state_net_run(change)
    assert got[0] == ref[0]
    _assert_same(got[1], ref[1])
    c = got[2]
    if regime == "lazy":
        # the changed layer's first step misses the segment cache, the rest hit
        assert c["segment_cache_misses"] == 1 and c["segment_cache_hits"] == 4, c
    else:
        assert c["capture_fallback_reasons"].get("signature_mismatch") == 1, c
        assert c["capture_builds"] == 1 and c["capture_replays"] == 3, c


# -- FLAGS_eager_async_compile: accepted, no effect ------------------------------
# The JAX package compiles a new program on a background thread while its
# first occurrence runs the plain path, and joins the build at the next one.
# The port's build of a program is a tuple of plan ops, made on the calling
# thread (ROADMAP, deliberate differences): with the flag on, a program is
# built at its first occurrence, a build error raises there with its type,
# and the background counters stay 0.
_ASYNC_COUNTERS = ("async_compiles", "async_compile_joins", "async_compile_skipped",
                   "async_bridge_flushes", "capture_async_builds",
                   "capture_build_pending_steps")


@pytest.fixture
def async_mode(capture_mode):
    paddle.set_flags({"FLAGS_eager_async_compile": True})
    yield
    c = prof.dispatch_counters()
    assert all(c[k] == 0 for k in _ASYNC_COUNTERS), dict(c)
    assert c["async_compile_ms"] == 0.0


def test_async_segment_bridge_then_join(async_mode):
    """The flag on: the first flush builds the segment's program and runs
    it; the second is a cache hit; no bridge, no join."""
    x = paddle.to_tensor(np.arange(8, dtype=np.float32))
    v1 = float((x * 2.0 + 1.0).sum())
    c = prof.dispatch_counters()
    assert c["segment_cache_misses"] == 1 and c["segment_cache_hits"] == 0, dict(c)
    v2 = float((x * 2.0 + 1.0).sum())
    assert prof.dispatch_counters()["segment_cache_hits"] == 1
    assert v1 == v2 == float(np.sum(np.arange(8, dtype=np.float32) * 2 + 1))


def test_async_build_error_surfaces_at_join(async_mode, monkeypatch):
    """The flag on: a build error raises at the flush that builds, with its
    type; the values of that segment raise on every read; a fresh build
    recovers."""
    x = paddle.to_tensor(np.ones(16, np.float32))
    real_build = lazy._build_segment_fn
    calls = []

    def broken_build(plan):
        calls.append(1)
        if len(calls) == 1:
            raise TypeError("injected build failure")
        return real_build(plan)

    monkeypatch.setattr(lazy, "_build_segment_fn", broken_build)
    y = (x * 3.0).sum()
    with pytest.raises(TypeError, match="injected build failure"):
        float(y)
    with pytest.raises(RuntimeError, match="flush failed"):
        float(y)
    assert float((x * 3.0).sum()) == 48.0
    assert len(calls) == 2


def test_async_capture_reaches_one_program_and_matches(async_mode):
    """The flag on: the captured step is built at the first armed step, the
    steady state is one program, and the losses and parameters are bitwise
    the per-op ones."""
    paddle.set_flags({"FLAGS_eager_lazy_dispatch": False, "FLAGS_eager_step_capture": False})
    model_r, opt_r, cycle_r = _clip_trainer(_CLIP_MAKERS["global_norm"])
    l_ref = [float(cycle_r()) for _ in range(7)]
    p_ref = [_np(p) for p in model_r.parameters()]

    paddle.set_flags({"FLAGS_eager_lazy_dispatch": True, "FLAGS_eager_step_capture": True})
    prof.reset_dispatch_counters()
    model, opt, cycle = _clip_trainer(_CLIP_MAKERS["global_norm"])
    losses = []
    for _ in range(6):
        losses.append(float(cycle()))
        paddle.device.synchronize()
    c = prof.dispatch_counters()
    assert c["capture_builds"] == 1, dict(c)
    assert c["capture_replays"] == 4, dict(c)
    assert c["capture_fallbacks"] == 0, dict(c)
    prof.reset_dispatch_counters()
    losses.append(float(cycle()))
    c = prof.dispatch_counters()
    assert c["programs"] == 1 and c["captured_programs"] == 1, dict(c)
    assert losses == l_ref
    _assert_same([_np(p) for p in model.parameters()], p_ref)


def test_async_host_time_moves_off_the_critical_path(async_mode):
    """The flag on: a new segment's build is on the calling thread, in
    ``compile_time_ms``; its cached runs in ``replay_time_ms``; nothing in
    ``async_compile_ms``."""
    x = paddle.to_tensor(np.ones((32, 32), np.float32))
    float(paddle.matmul(x, x).mean())
    c = prof.dispatch_counters()
    assert c["compile_time_ms"] > 0.0 and c["replay_time_ms"] == 0.0, dict(c)
    float(paddle.matmul(x, x).mean())
    assert prof.dispatch_counters()["replay_time_ms"] > 0.0


@pytest.mark.parametrize("call,item", [
    (lambda: lazy.captured_step_program(), "item 12"),
    (lambda: lazy.captured_step_certificate(), "item 12"),
    (lambda: lazy.captured_step_handle(), "item 12"),
    (lambda: lazy.captured_step_shard_info(), "item 13"),
    (lambda: lazy.captured_step_donation_verdicts(), "item 13"),
    (lambda: paddle.set_flags({"FLAGS_check_programs": 2}), "item 12"),
    (lambda: paddle.set_flags({"FLAGS_memory_plan": "auto"}), "item 12"),
    (lambda: paddle.set_flags({"FLAGS_eager_capture_sharded": False}), "item 13"),
])
def test_what_later_items_bring_raises_naming_its_item(call, item):
    """The memory plan, certificates and launch budget of a capture (item
    12) and sharded capture (item 13) raise, naming their queue item; the
    flags keep their defaults."""
    with pytest.raises(NotImplementedError, match=item):
        call()
    assert paddle.get_flags(["FLAGS_check_programs", "FLAGS_memory_plan",
                             "FLAGS_eager_capture_sharded"]) == {
        "FLAGS_check_programs": 0, "FLAGS_memory_plan": "", "FLAGS_eager_capture_sharded": True}
