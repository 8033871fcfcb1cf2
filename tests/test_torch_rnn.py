"""The recurrent layers of the port (``paddle_tpu_torch/nn/layer/rnn.py``)
against the JAX package's, on the CPU: ``LSTM`` and ``GRU`` here,
``SimpleRNN``, the cells, ``RNN``, ``BiRNN`` and beam search in
``tests/test_torch_rnn_cells.py``.

Each case builds the JAX layer from a seed, carries its parameters into the
port's with ``state_dict_from_numpy``, feeds both the same inputs made
from a seed with numpy, and compares the outputs, the final states and the
gradients of ``sum(out * w) + sum(state * v)`` (``w``, ``v`` from a seed)
with respect to the inputs, the initial states and every parameter, within
1e-5 (rtol and atol, f32). ``SimpleRNN``, ``LSTM`` and ``GRU`` run at 1 and
2 layers, forward and bidirectional, each once batch-major without
``sequence_length`` or initial states and once time-major with both.
``BeamSearchDecoder`` and ``dynamic_decode`` run the JAX test's case
(``tests/test_nn_surface2.py``), held to equal ids and lengths and scores
within 1e-5; dropout between layers is held against itself.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import state_dict_from_numpy

TOL = 1e-5
B, T, IN, H = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def _cpu():
    previous = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(previous)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.numpy())


def _pair(ctor):
    paddle.seed(0)
    jl = ctor(paddle)
    tl = ctor(pt)
    state_dict_from_numpy(tl, {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()})
    return jl, tl


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [x]


def _run(mod, layer, arrays, lengths=None):
    """Outputs, input grads and parameter grads of ``layer`` in ``mod``;
    ``arrays[0]`` is the input, the rest the initial states."""
    ts = [mod.to_tensor(a, stop_gradient=False) for a in arrays]
    init = None
    if len(ts) > 1:
        init = ts[1] if len(ts) == 2 else tuple(ts[1:])
    kwargs = {} if lengths is None else {"sequence_length": mod.to_tensor(lengths)}
    outs = _flat(layer(ts[0], init, **kwargs))
    rng = np.random.default_rng(11)
    loss = None
    for o in outs:
        w = rng.standard_normal(tuple(o.shape)).astype(np.float32)
        term = (o * mod.to_tensor(w)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    grads = [_np(t.grad) for t in ts]
    pgrads = {n: _np(p.grad) for n, p in layer.named_parameters()}
    return [_np(o) for o in outs], grads, pgrads


def _compare(jl, tl, arrays, lengths=None):
    jo, jg, jp = _run(paddle, jl, arrays, lengths)
    to, tg, tp = _run(pt, tl, arrays, lengths)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert sorted(tp) == sorted(jp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=TOL, atol=TOL, err_msg=n)


@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["LSTM", "GRU"])
def test_recurrent_layer_matches_jax(mode, layers, direction):
    rng = np.random.default_rng(3)
    d = 2 if direction == "bidirect" else 1
    comps = 2 if mode == "LSTM" else 1
    for time_major in (False, True):
        jl, tl = _pair(lambda m: getattr(m.nn, mode)(IN, H, num_layers=layers,
                                                     direction=direction,
                                                     time_major=time_major))
        x = rng.standard_normal((T, B, IN) if time_major else (B, T, IN)).astype(np.float32)
        if not time_major:
            _compare(jl, tl, [x])
            continue
        inits = [rng.standard_normal((layers * d, B, H)).astype(np.float32)
                 for _ in range(comps)]
        _compare(jl, tl, [x] + inits, lengths=np.array([5, 2, 4], np.int64))
