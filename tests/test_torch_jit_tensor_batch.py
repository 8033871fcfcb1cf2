"""``compile_train_step`` with the batch a Paddle user passes: ``paddle.Tensor``
inputs (``paddle.to_tensor``), and a loss function that calls Tensor
methods on the model's output (bench.py ``bench_resnet50``'s
``lambda out, y: loss_fn(out.astype("float32"), y)``), against the JAX
step on the same weights and data.

Before the nn slice the port's step ran ``torch.as_tensor`` on each batch
item, so a ``paddle.Tensor`` raised ``TypeError: len() of a 0-D tensor``,
and the loss function got a ``torch.Tensor`` without ``astype``.

f32 on the CPU, one small linear layer: losses and parameters agree to
1e-6 (the two frameworks sum the product in different orders). With torch
inputs the step runs the very same torch ops on the same storage, so it is
bitwise the Tensor-input step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import state_dict_from_numpy

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    previous = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(previous)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 4)).astype(np.float32),
            rng.integers(0, 3, (8,)).astype(np.int64))


def _pair():
    paddle.seed(0)
    jm = paddle.nn.Linear(4, 3)
    tm = pt.nn.Linear(4, 3)
    state_dict_from_numpy(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _step(mod, model):
    opt = mod.optimizer.Momentum(learning_rate=0.1, momentum=0.9, parameters=model.parameters())
    loss_fn = mod.nn.CrossEntropyLoss()
    return mod.jit.compile_train_step(model, lambda out, y: loss_fn(out.astype("float32"), y),
                                      opt)


def test_tensor_batch_and_astype_loss_match_the_jax_step():
    jm, tm = _pair()
    jstep, tstep = _step(paddle, jm), _step(pt, tm)
    for i in range(3):
        x, y = _data(i)
        jl = jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        tl = tstep(pt.to_tensor(x), pt.to_tensor(y))
        assert isinstance(tl, pt.Tensor) and tl.stop_gradient
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for name, jv in jm.state_dict().items():
        np.testing.assert_allclose(tm.state_dict()[name].detach().numpy(), jv.numpy(), **TOL)


def test_the_loss_function_gets_tensors():
    _, tm = _pair()
    seen = []
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())

    def loss_fn(out, y):
        seen.append((type(out), type(y)))
        return pt.nn.functional.cross_entropy(out, y)

    step = pt.jit.compile_train_step(tm, loss_fn, opt)
    x, y = _data()
    step(pt.to_tensor(x), pt.to_tensor(y))
    step(torch.from_numpy(x), torch.from_numpy(y))
    assert seen == [(pt.Tensor, pt.Tensor), (torch.Tensor, torch.Tensor)]


def test_torch_batch_is_bitwise_the_tensor_batch():
    _, ta = _pair()
    _, tb = _pair()
    crit = pt.nn.CrossEntropyLoss()
    steps = []
    for model in (ta, tb):
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
        steps.append(pt.jit.compile_train_step(model, lambda o, y: crit(o, y), opt))
    for i in range(3):
        x, y = _data(i)
        la = steps[0](torch.from_numpy(x), torch.from_numpy(y))
        lb = steps[1](pt.to_tensor(x), pt.to_tensor(y))
        assert isinstance(la, torch.Tensor) and not isinstance(la, pt.Tensor)
        assert la.numpy().tobytes() == lb.numpy().tobytes()
    for (name, a), b in zip(ta.state_dict().items(), tb.state_dict().values()):
        assert a.detach().numpy().tobytes() == b.detach().numpy().tobytes(), name
