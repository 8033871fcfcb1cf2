"""The port's ``nn.Parameter`` against the JAX package's, on the CPU: a frozen
parameter (``stop_gradient = True`` or ``trainable = False``) stays bitwise
unchanged through eager SGD and Adam, ``compile_train_step`` (frozen before
it is built: left out; frozen after: still updated, as the JAX step's fixed
parameter list does) and a lazily captured step (frozen before the first
step and between steps), while the trainable ones move as the JAX
package's do; and the Paddle surface of a parameter (construction from
numpy, ``ParamAttr(trainable=False)``, ``numpy``, ``set_value``, ``astype``,
``place``, ``gradient``, ``name``, ``shape``), with torch's own uses of it
(deep copies, pickles, state dicts, ``paddle.save``/``load``, torch's
optimizers).

Tolerances: the JAX and port updates of the moving parameters agree to
float32 rtol 1e-5 / atol 1e-6 (``tests/test_torch_op_sweep.py``'s, sums in
another order); a frozen parameter is compared bit for bit.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import lazy

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


def _twins(seed=0):
    """A 2-layer MLP in each package with the same weights (from numpy)."""
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.5
          for s in [(4, 5), (5,), (5, 3), (3,)]]
    out = {}
    for p in (jp, tp):
        m = p.nn.Sequential(p.nn.Linear(4, 5), p.nn.Tanh(), p.nn.Linear(5, 3))
        for param, w in zip(m.parameters(), ws):
            param.set_value(w)
        out[p] = m
    return out


def _opt(p, kind, params):
    if kind == "sgd":
        return p.optimizer.SGD(learning_rate=0.1, parameters=params)
    return p.optimizer.Adam(learning_rate=0.05, parameters=params)


def _eager_steps(p, m, opt, n, x, y):
    for _ in range(n):
        loss = p.nn.functional.mse_loss(m(p.to_tensor(x)), p.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()


def _freeze(param, how):
    if how == "stop_gradient":
        param.stop_gradient = True
    else:
        param.trainable = False


def _assert_params(models, frozen_before=None):
    """Every parameter of the port's model within tolerance of the JAX
    one's; those of ``frozen_before`` (index -> numpy) bitwise unchanged."""
    jps, tps = list(models[jp].parameters()), list(models[tp].parameters())
    for i, (a, b) in enumerate(zip(jps, tps)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL, err_msg=str(i))
    for i, w in (frozen_before or {}).items():
        np.testing.assert_array_equal(tps[i].numpy(), w)
        np.testing.assert_array_equal(jps[i].numpy(), w)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("how", ["stop_gradient", "trainable"])
def test_frozen_parameter_keeps_its_bits_through_eager_steps(kind, how):
    models = _twins()
    x, y = _data()
    frozen = {}
    for p, m in models.items():
        first = list(m.parameters())[0]
        _freeze(first, how)
        assert first.stop_gradient and not first.trainable
        frozen[0] = first.numpy().copy()
        _eager_steps(p, m, _opt(p, kind, m.parameters()), 3, x, y)
    _assert_params(models, frozen)
    moved = list(models[tp].parameters())[2].numpy()
    assert not np.array_equal(moved, _twins()[tp][2].weight.numpy())


def test_freeze_between_eager_steps_and_unfreeze():
    models = _twins(1)
    x, y = _data(1)
    for p, m in models.items():
        opt = _opt(p, "adam", m.parameters())
        _eager_steps(p, m, opt, 2, x, y)
        m[0].weight.stop_gradient = True
        _eager_steps(p, m, opt, 2, x, y)
        m[0].weight.trainable = True
        _eager_steps(p, m, opt, 1, x, y)
    _assert_params(models)


@pytest.mark.parametrize("when", ["before_build", "after_build"])
def test_compile_train_step_sees_a_freeze_as_the_jax_step_does(when):
    """Frozen before ``compile_train_step`` is built: left out of its
    parameter list, bitwise unchanged. Frozen after: the list is fixed, so
    it keeps being updated, in both packages."""
    models = _twins(2)
    x, y = _data(2)
    frozen = {}
    for p, m in models.items():
        opt = _opt(p, "adam", m.parameters())
        if when == "before_build":
            m[0].weight.stop_gradient = True
            frozen[0] = m[0].weight.numpy().copy()
        step = p.jit.compile_train_step(m, p.nn.functional.mse_loss, opt)
        step(p.to_tensor(x), p.to_tensor(y))
        if when == "after_build":
            m[0].weight.stop_gradient = True
            before = m[0].weight.numpy().copy()
        step(p.to_tensor(x), p.to_tensor(y))
        step(p.to_tensor(x), p.to_tensor(y))
        if when == "after_build":
            assert not np.array_equal(m[0].weight.numpy(), before)
            assert m[0].weight.stop_gradient  # the step leaves the flag as it was
    _assert_params(models, frozen)


def _set_regime(regime):
    tp.set_flags({"FLAGS_eager_lazy_dispatch": regime != "per_op",
                  "FLAGS_eager_step_capture": regime == "captured"})


@pytest.fixture
def _restore_dispatch():
    flags = tp.get_flags(["FLAGS_eager_lazy_dispatch", "FLAGS_eager_step_capture"])
    yield
    tp.set_flags(flags)
    lazy.reset_lazy_state()


@pytest.mark.parametrize("when", ["before", "between"])
def test_lazily_captured_step_sees_a_freeze(when, _restore_dispatch):
    """A freeze made before the first step or between captured steps: the
    layer key changes, the step is captured again, the frozen weight keeps
    its bits, and every parameter equals the per-op run's bitwise and the
    JAX package's eager run within tolerance."""
    x, y = _data(3)
    runs = {}
    for regime in ("per_op", "captured"):
        _set_regime(regime)
        lazy.reset_lazy_state()
        models = _twins(3)
        m = models[tp]
        opt = _opt(tp, "adam", m.parameters())
        tp.profiler.reset_dispatch_counters()
        if when == "before":
            m[0].weight.stop_gradient = True
        frozen = m[0].weight.numpy().copy()
        for i in range(8):
            if when == "between" and i == 4:
                m[0].weight.stop_gradient = True
                frozen = m[0].weight.numpy().copy()
            _eager_steps(tp, m, opt, 1, x, y)
        np.testing.assert_array_equal(m[0].weight.numpy(), frozen)
        runs[regime] = (m, dict(tp.profiler.dispatch_counters()))
    _set_regime("per_op")
    c = runs["captured"][1]
    assert c["capture_replays"] >= 2 and c["capture_builds"] == (1 if when == "before" else 2), c
    for a, b in zip(runs["per_op"][0].parameters(), runs["captured"][0].parameters()):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    # the JAX package's eager steps with the same freeze
    jm = _twins(3)[jp]
    jopt = _opt(jp, "adam", jm.parameters())
    if when == "before":
        jm[0].weight.stop_gradient = True
    for i in range(8):
        if when == "between" and i == 4:
            jm[0].weight.stop_gradient = True
        _eager_steps(jp, jm, jopt, 1, x, y)
    for a, b in zip(jm.parameters(), runs["captured"][0].parameters()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)


def test_layer_key_changes_with_a_freeze():
    m = tp.nn.Linear(2, 2)
    key = lazy.layer_key(m)
    m.weight.trainable = False
    assert lazy.layer_key(m) != key
    m.weight.trainable = True
    assert lazy.layer_key(m) == key


# -- construction ---------------------------------------------------------------
def test_parameter_from_numpy_and_the_adam_step_of_the_reference():
    """``tests/test_optimizer.py::test_adam_matches_numpy_reference`` on both."""
    p0 = np.array([1.0, 2.0], np.float32)
    g0 = np.array([0.5, -1.0], np.float32)
    out = {}
    for p in (jp, tp):
        param = p.nn.Parameter(p0.copy())
        assert not param.stop_gradient and param.trainable
        o = p.optimizer.Adam(learning_rate=0.01, parameters=[param])
        param.grad = p.to_tensor(g0.copy())
        o.step()
        out[p] = param.numpy()
    m, v = 0.1 * g0, 0.001 * g0 ** 2
    expected = p0 - 0.01 * np.sqrt(1 - 0.999) / (1 - 0.9) * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(out[tp], expected, rtol=1e-5)
    np.testing.assert_allclose(out[tp], out[jp], rtol=RTOL, atol=ATOL)


def test_grad_scaler_on_a_numpy_parameter():
    """``tests/test_amp.py::test_grad_scaler_scales_and_unscales`` on both."""
    out = {}
    for p in (jp, tp):
        param = p.nn.Parameter(np.zeros(2, np.float32))
        o = p.optimizer.SGD(learning_rate=1.0, parameters=[param])
        scaler = p.amp.GradScaler(init_loss_scaling=128.0)
        scaler.scale((param * p.to_tensor([1.0, 2.0])).sum()).backward()
        grad = np.array(param.grad.numpy())  # a copy: unscale_ divides the grad in place
        scaler.step(o)
        scaler.update()
        out[p] = (grad, param.numpy())
    for a, b in zip(out[jp], out[tp]):
        np.testing.assert_allclose(b, a)
    np.testing.assert_allclose(out[tp][1], [-1.0, -2.0])


def test_parameter_constructors_names_and_param_attr():
    a = tp.nn.Parameter(np.ones(3, np.float32))
    b = tp.nn.Parameter(torch.zeros(2), trainable=False, name="frozen_w")
    c = tp.nn.Parameter(tp.to_tensor([1.0, 2.0]), False)
    assert a.is_leaf and not a.stop_gradient
    assert a.name.startswith("param_") and a.name == a.param_name
    assert (b.name, b.trainable, b.stop_gradient) == ("frozen_w", False, True)
    assert not c.requires_grad and c.numpy().tolist() == [1.0, 2.0]
    a.name = "renamed"
    assert a.name == a.param_name == "renamed"
    for p in (jp, tp):
        w = p.create_parameter([3, 4], "float32")
        assert not w.stop_gradient and w.shape == [3, 4]
        np.testing.assert_array_equal(p.create_parameter([4], "float32", is_bias=True).numpy(),
                                      np.zeros(4))
        lin = p.nn.Linear(2, 3, weight_attr=p.ParamAttr(trainable=False, name="w0"))
        assert not lin.weight.trainable and lin.weight.stop_gradient and lin.bias.trainable
        assert lin.weight.name == "w0"
        assert lin.weight.shape == [2, 3] and list(lin.weight.shape) == [2, 3]


def test_parameter_surface_matches_the_jax_parameter():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    x = rng.standard_normal((2, 3)).astype(np.float32)
    got = {}
    for p in (jp, tp):
        param = p.nn.Parameter(w.copy())
        assert type(param.place).__name__ == "CPUPlace"
        assert param.gradient is None
        (p.matmul(p.to_tensor(x), param) ** 2).sum().backward()
        half = param.astype("float16")
        assert half.dtype == p.float16 and not half.stop_gradient
        got[p] = (param.numpy(), param.gradient, half.numpy())
        with pytest.raises(ValueError, match="shape"):
            param.set_value(np.zeros((2, 3), np.float32))
        param.set_value(np.ones((3, 2), np.float64))
        np.testing.assert_array_equal(param.numpy(), np.ones((3, 2), np.float32))
        assert param.numpy().dtype == np.float32
    for a, b in zip(got[jp], got[tp]):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_set_value_writes_in_place():
    m = tp.nn.Linear(2, 2)
    ptr = m.weight.data_ptr()
    m.weight.set_value(tp.to_tensor(np.full((2, 2), 3.0, np.float32)))
    assert m.weight.data_ptr() == ptr and m.weight.requires_grad
    np.testing.assert_array_equal(m.weight.numpy(), np.full((2, 2), 3.0, np.float32))


# -- torch's own uses of a parameter ------------------------------------------
def test_torch_uses_of_a_parameter_survive(tmp_path):
    m = tp.nn.Linear(3, 2)
    m.weight.stop_gradient = True
    twin = copy.deepcopy(m)
    assert type(twin.weight) is type(m.weight)
    assert twin.weight.name == m.weight.name and twin.weight.stop_gradient
    assert twin.weight.data_ptr() != m.weight.data_ptr()
    np.testing.assert_array_equal(twin.weight.numpy(), m.weight.numpy())
    # a pickle rebuilds torch's Parameter (torch._utils._rebuild_parameter),
    # with the data, requires_grad and the Paddle name
    back = pickle.loads(pickle.dumps(m.bias))
    assert isinstance(back, torch.nn.Parameter) and back.requires_grad
    assert back.param_name == m.bias.name and torch.equal(back, m.bias)
    # state dicts, paddle.save / load
    other = tp.nn.Linear(3, 2)
    assert other.set_state_dict(m.state_dict()) == ([], [])
    tp.save(m.state_dict(), str(tmp_path / "m.pdparams"))
    third = tp.nn.Linear(3, 2)
    third.set_state_dict(tp.load(str(tmp_path / "m.pdparams")))
    for mod in (other, third):
        np.testing.assert_array_equal(mod.weight.numpy(), m.weight.numpy())
    assert m.state_dict()["weight"].shape == torch.Size([3, 2])
    # torch's own optimizer over port parameters skips the frozen one
    before = m.weight.numpy().copy()
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    m(torch.ones(4, 3)).sum().backward()
    opt.step()
    np.testing.assert_array_equal(m.weight.numpy(), before)
    assert m.bias.grad is not None


def test_lazy_spec_inference_runs_over_parameters(_restore_dispatch):
    """The FakeTensorMode run of lazy dispatch over a layer with a frozen
    parameter: the deferred forward's output equals the per-op one."""
    m = tp.nn.Linear(4, 3)
    m.weight.trainable = False
    x = tp.to_tensor(np.ones((2, 4), np.float32))
    want = m(x).numpy()
    _set_regime("lazy")
    lazy.reset_lazy_state()
    out = m(x)
    assert out.shape == [2, 3] and out.stop_gradient is False
    np.testing.assert_array_equal(out.numpy(), want)
