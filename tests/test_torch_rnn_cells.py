"""The recurrent layers of the port (``paddle_tpu_torch/nn/layer/rnn.py``)
against the JAX package's, on the CPU: ``SimpleRNN``, the cells, ``RNN``,
``BiRNN`` and beam search (``tests/test_torch_rnn.py`` holds ``LSTM`` and
``GRU``, and the helpers and tolerance both files use).

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
from tests.test_torch_rnn import B, H, IN, T, TOL, _compare, _cpu, _np, _pair  # noqa: F401


@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", ["SimpleRNN"])
def test_simple_rnn_matches_jax(mode, layers, direction):
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


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_rnn_reverse_and_birnn_match_jax(cell):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    # one step of the cell, with and without states
    jc, tc = _pair(lambda m: getattr(m.nn, cell)(IN, H))
    step = x[:, 0]
    _compare(_CellCall(jc), _CellCall(tc), [step])
    st = [rng.standard_normal((B, H)).astype(np.float32)
          for _ in range(2 if cell == "LSTMCell" else 1)]
    _compare(_CellCall(jc), _CellCall(tc), [step] + st)
    # RNN(cell, is_reverse=True) over a padded batch
    jr, tr = _pair(lambda m: m.nn.RNN(getattr(m.nn, cell)(IN, H), is_reverse=True))
    _compare(jr, tr, [x], lengths=np.array([5, 3, 1], np.int64))
    # BiRNN of two cells
    jb, tb = _pair(lambda m: m.nn.BiRNN(getattr(m.nn, cell)(IN, H), getattr(m.nn, cell)(IN, H)))
    _compare(jb, tb, [x])


class _CellCall:
    """A cell called as ``cell(x, states)``, with ``named_parameters``."""

    def __init__(self, cell):
        self.cell = cell

    def __call__(self, x, states=None, **kwargs):
        return self.cell(x, states)

    def named_parameters(self):
        return self.cell.named_parameters()


def test_aliases_and_state_names_follow_the_reference():
    jl, tl = _pair(lambda m: m.nn.LSTM(IN, H, num_layers=2, direction="bidirect"))
    assert list(tl.state_dict()) == list(jl.state_dict())
    for name in ("weight_ih_l0", "weight_hh_l1", "bias_ih_l0_reverse", "bias_hh_l1_reverse"):
        np.testing.assert_array_equal(_np(getattr(tl, name)), _np(getattr(jl, name)))
    assert getattr(tl, "weight_ih_l0") is tl.state_dict(keep_vars=True)["0.cell_fw.weight_ih"]


def test_dropout_between_layers_is_held_against_itself():
    """Dropout 0.5 falls between the layers in training only: two runs from
    one seed agree, eval mode equals a dropout-0 copy, and the training
    output differs from it."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((B, T, IN)).astype(np.float32))
    pt.seed(0)
    drop = pt.nn.LSTM(IN, H, num_layers=2, dropout=0.5)
    plain = pt.nn.LSTM(IN, H, num_layers=2)
    plain.set_state_dict(drop.state_dict())
    pt.seed(7)
    a, _ = drop(x)
    pt.seed(7)
    b, _ = drop(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref, _ = plain(x)
    assert not torch.allclose(a, ref)
    drop.eval()
    c, _ = drop(x)
    torch.testing.assert_close(c, ref, rtol=0, atol=0)


def _decode(mod):
    mod.seed(0)
    cell = mod.nn.GRUCell(4, 8)
    proj = mod.nn.Linear(8, 10)
    emb = mod.nn.Embedding(10, 4)
    return cell, proj, emb


def test_beam_search_and_dynamic_decode_match_jax():
    jcell, jproj, jemb = _decode(paddle)
    tcell, tproj, temb = _decode(pt)
    for j, t in ((jcell, tcell), (jproj, tproj), (jemb, temb)):
        state_dict_from_numpy(t, {k: np.asarray(v.numpy()) for k, v in j.state_dict().items()})
    res = []
    for mod, (cell, proj, emb) in ((paddle, (jcell, jproj, jemb)), (pt, (tcell, tproj, temb))):
        dec = mod.nn.BeamSearchDecoder(cell, start_token=0, end_token=1, beam_size=3,
                                       embedding_fn=emb, output_fn=proj)
        ids, scores, lens = mod.nn.dynamic_decode(dec, inits=mod.zeros([2, 8]), max_step_num=6,
                                                  return_length=True)
        res.append((_np(ids), _np(scores), _np(lens)))
    (ji, js, jn), (ti, ts, tn) = res
    assert ti.shape[:2] == (2, 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(ts, js, rtol=TOL, atol=TOL)
    assert (np.diff(ts, axis=1) <= 1e-6).all()
