"""Recurrent layers: ``SimpleRNN``, ``LSTM``, ``GRU``, their cells, the
``RNN`` and ``BiRNN`` wrappers, ``BeamSearchDecoder`` and
``dynamic_decode`` (``paddle_tpu/nn/layer/rnn.py``).

The JAX ``RNN`` runs one ``lax.scan`` per layer and direction; the port
runs the cell's torch ops in a Python loop over time, so autograd records
each step, and no cuDNN RNN is called. The semantics are the JAX
package's: gate orders (LSTM i, f, c, o; GRU r, z, c with the reset gate
applied after the hidden matmul), a reverse direction walking T-1..0
within each sequence's valid region, padded steps (``sequence_length``)
keeping their state and giving zeros, dropout between layers only in
training, ``{weight,bias}_{ih,hh}_l{k}[_reverse]`` aliases of the cells'
parameters, and the state-dict names ``<layer>.cell.*`` /
``<layer>.cell_fw.*`` / ``<layer>.cell_bw.*``. Parameters are drawn from
U(-1/sqrt(hidden), 1/sqrt(hidden)), as in both packages.

``BeamSearchDecoder`` and ``dynamic_decode`` loop on the host, reading the
step's log-probabilities back each step (under lazy dispatch each such
read flushes).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import dispatch
from ...core.tensor import Tensor, to_tensor
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
    "BeamSearchDecoder", "dynamic_decode",
]


class RNNCellBase(Layer):
    """reference: rnn.py:139."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None, init_value=0.0,
                           batch_dim_idx=0):
        ref = dispatch.unwrap(batch_ref)
        batch = ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dt = torch.float32 if dtype is None else _dtype(dtype)

        def full(s):
            return torch.full([batch] + list(s), float(init_value), dtype=dt, device=ref.device)

        if isinstance(shape, tuple) and shape and isinstance(shape[0], (tuple, list)):
            return tuple(full(s) for s in shape)
        return full(shape)


def _dtype(dtype):
    from ...core.dtype import to_torch_dtype

    return to_torch_dtype(dtype)


def _init_cell_params(cell, input_size, hidden_size, gates, weight_ih_attr=None,
                      weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
    std = 1.0 / np.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    cell.weight_ih = cell.create_parameter(
        [gates * hidden_size, input_size], attr=weight_ih_attr, default_initializer=u)
    cell.weight_hh = cell.create_parameter(
        [gates * hidden_size, hidden_size], attr=weight_hh_attr, default_initializer=u)
    cell.bias_ih = (None if bias_ih_attr is False else cell.create_parameter(
        [gates * hidden_size], attr=bias_ih_attr, is_bias=True, default_initializer=u))
    cell.bias_hh = (None if bias_hh_attr is False else cell.create_parameter(
        [gates * hidden_size], attr=bias_hh_attr, is_bias=True, default_initializer=u))


def _linear(x, w, b):
    """``x @ w^T`` plus ``b`` when there is one, as ``paddle.matmul(x, w,
    transpose_y=True) + b``."""
    y = torch.matmul(x, w.t())
    return y if b is None else y + b


class SimpleRNNCell(RNNCellBase):
    """reference: rnn.py:263 — ``h' = act(W_ih x + b_ih + W_hh h + b_hh)``."""

    def __init__(self, input_size, hidden_size, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        _init_cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        i2h = _linear(inputs, self.weight_ih, self.bias_ih)
        h2h = _linear(states, self.weight_hh, self.bias_hh)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        h = act(i2h + h2h)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    """reference: rnn.py:399 — gate order i, f, c, o."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _init_cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        pre_h, pre_c = states
        gates = _linear(inputs, self.weight_ih, self.bias_ih)
        gates = gates + torch.matmul(pre_h, self.weight_hh.t())
        if self.bias_hh is not None:
            gates = gates + self.bias_hh
        gi, gf, gc, go = torch.chunk(gates, 4, dim=-1)
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf)
        o = torch.sigmoid(go)
        c = f * pre_c + i * torch.tanh(gc)
        h = o * torch.tanh(c)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    """reference: rnn.py:556 — r/z/c gates, the reset applied after the
    hidden matmul: ``c = tanh(x_c + r·h_c); h = (h_prev − c)·z + c``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _init_cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                          weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        pre_h = states
        x_r, x_z, x_c = torch.chunk(_linear(inputs, self.weight_ih, self.bias_ih), 3, dim=-1)
        h_r, h_z, h_c = torch.chunk(_linear(pre_h, self.weight_hh, self.bias_hh), 3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        h = (pre_h - c) * z + c
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _flatten_states(states):
    return list(states) if isinstance(states, (tuple, list)) else [states]


def _pack_states(flat, is_tuple):
    return tuple(flat) if is_tuple else flat[0]


class RNN(Layer):
    """reference: rnn.py:707 — run ``cell`` over the time axis."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None, **kwargs):
        cell = self.cell
        if initial_states is None:
            ref = inputs if not self.time_major else inputs.transpose(0, 1)
            initial_states = cell.get_initial_states(ref, cell.state_shape)
        is_tuple = isinstance(initial_states, (tuple, list))
        carry = _flatten_states(initial_states)
        xs = inputs if self.time_major else inputs.transpose(0, 1)  # [T, B, I]
        steps = xs.shape[0]
        outs = []
        for t in range(steps):
            tt = steps - 1 - t if self.is_reverse else t
            out, new = cell(xs[tt], _pack_states(carry, is_tuple))
            new = _flatten_states(new)
            if sequence_length is not None:
                valid = (tt < sequence_length)[:, None]
                new = [torch.where(valid, n, c) for n, c in zip(new, carry)]
                out = torch.where(valid, out, torch.zeros_like(out))
            carry = new
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        outs = torch.stack(outs, 0)
        if not self.time_major:
            outs = outs.transpose(0, 1)
        return outs, _pack_states(carry, is_tuple)


class BiRNN(Layer):
    """reference: rnn.py:782 — a forward and a backward cell, their outputs
    concatenated. The two ``RNN`` wrappers are not sublayers, so the
    state dict names each parameter once, under ``cell_fw`` / ``cell_bw``,
    as the JAX package's does."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        object.__setattr__(self, "rnn_fw", RNN(cell_fw, is_reverse=False, time_major=time_major))
        object.__setattr__(self, "rnn_bw", RNN(cell_bw, is_reverse=True, time_major=time_major))
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None, **kwargs):
        if initial_states is None:
            st_fw = st_bw = None
        else:
            st_fw, st_bw = initial_states
        out_fw, fin_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        out_bw, fin_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (fin_fw, fin_bw)


class RNNBase(Layer):
    """reference: rnn.py:861 — layers × directions."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        bidi = direction in ("bidirectional", "bidirect")
        if not bidi and direction != "forward":
            raise ValueError(f"direction should be forward or bidirect, got {direction}")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_directions = 2 if bidi else 1
        self.time_major = time_major
        self.dropout = dropout
        self.state_components = 2 if mode == "LSTM" else 1
        kwargs = dict(weight_ih_attr=weight_ih_attr, weight_hh_attr=weight_hh_attr,
                      bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)
        cell_cls = {"LSTM": LSTMCell, "GRU": GRUCell}.get(mode, SimpleRNNCell)
        if mode not in ("LSTM", "GRU"):
            kwargs["activation"] = getattr(self, "activation", "tanh")
        layers = []
        for i in range(num_layers):
            in_sz = input_size if i == 0 else hidden_size * self.num_directions
            if bidi:
                wrap = BiRNN(cell_cls(in_sz, hidden_size, **kwargs),
                             cell_cls(in_sz, hidden_size, **kwargs), time_major)
            else:
                wrap = RNN(cell_cls(in_sz, hidden_size, **kwargs), time_major=time_major)
            self.add_sublayer(str(i), wrap)
            layers.append(wrap)
        object.__setattr__(self, "_layers_list", layers)
        # the reference's parameter aliases: weight_ih_l0, bias_hh_l1_reverse, ...
        for li, wrap in enumerate(layers):
            cells = [(wrap.cell_fw, ""), (wrap.cell_bw, "_reverse")] if bidi else [(wrap.cell, "")]
            for cell, suffix in cells:
                for pname in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    p = getattr(cell, pname)
                    if p is not None:
                        object.__setattr__(self, f"{pname}_l{li}{suffix}", p)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        D, L, C = self.num_directions, self.num_layers, self.state_components
        batch = inputs.shape[1 if self.time_major else 0]
        if initial_states is None:
            init = [torch.zeros(L * D, batch, self.hidden_size, dtype=inputs.dtype,
                                device=inputs.device) for _ in range(C)]
            initial_states = init[0] if C == 1 else tuple(init)
        states = [initial_states] if C == 1 else list(initial_states)  # C × [L*D, B, H]
        h = inputs
        finals = [[] for _ in range(C)]
        for li, wrap in enumerate(self._layers_list):
            if D == 2:
                def st(d):
                    comp = [s[li * D + d] for s in states]
                    return tuple(comp) if C > 1 else comp[0]

                h, (fin_fw, fin_bw) = wrap(h, (st(0), st(1)), sequence_length)
                fins = (fin_fw, fin_bw)
            else:
                comp = [s[li] for s in states]
                h, fin = wrap(h, tuple(comp) if C > 1 else comp[0], sequence_length)
                fins = (fin,)
            for fin in fins:
                for ci, s in enumerate(_flatten_states(fin)):
                    finals[ci].append(s)
            if self.dropout > 0.0 and li < L - 1 and self.training:
                h = F.dropout(h, self.dropout)
        final_states = [torch.stack(f, 0) for f in finals]
        return h, (final_states[0] if C == 1 else tuple(final_states))


class SimpleRNN(RNNBase):
    """reference: rnn.py:1105."""

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None):
        self.activation = activation
        super().__init__("RNN", input_size, hidden_size, num_layers, direction, time_major,
                         dropout, weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)


class LSTM(RNNBase):
    """reference: rnn.py:1215."""

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers, direction, time_major,
                         dropout, weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)


class GRU(RNNBase):
    """reference: rnn.py:1329."""

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers, direction, time_major,
                         dropout, weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)


class BeamSearchDecoder:
    """Beam search over an RNN cell, driven on the host by
    ``dynamic_decode`` (decode lengths depend on the data). ``embedding_fn``
    maps token ids to the cell's inputs, ``output_fn`` its outputs to
    logits over the vocabulary."""

    def __init__(self, cell, start_token, end_token, beam_size, embedding_fn=None,
                 output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _logits(self, tok, states):
        inp = to_tensor(np.asarray(tok, np.int64))
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        out, new_states = self.cell(inp, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        return out, new_states


def _gather_states(states, idx):
    if isinstance(states, (tuple, list)):
        return type(states)(_gather_states(s, idx) for s in states)
    return to_tensor(np.asarray(states.numpy() if isinstance(states, Tensor)
                                else states.detach().cpu().numpy())[idx])


def _log_softmax_host(logits) -> np.ndarray:
    return np.asarray(F.log_softmax(logits, axis=-1).numpy())


def dynamic_decode(decoder, inits=None, max_step_num=None, output_time_major=False,
                   impute_finished=False, is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every beam emitted ``end_token`` or
    ``max_step_num`` steps (64 when None). Returns ``(ids [B, beam, T],
    scores [B, beam])``, and the lengths with ``return_length``."""
    if max_step_num is None:
        max_step_num = 64
    beam = decoder.beam_size
    if inits is None:
        raise ValueError("dynamic_decode needs initial states (inits)")
    states = inits
    leaf = states
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    batch = leaf.shape[0]

    logits, states = decoder._logits(np.full((batch,), decoder.start_token), states)
    logp = _log_softmax_host(logits)
    vocab = logp.shape[-1]
    top = np.argsort(-logp, axis=-1)[:, :beam]              # [B, beam]
    scores = np.take_along_axis(logp, top, axis=-1)          # [B, beam]
    seqs = top[:, :, None]                                   # [B, beam, 1]
    finished = top == decoder.end_token
    rep = np.repeat(np.arange(batch), beam)                  # states [B] -> [B*beam]
    states = _gather_states(states, rep)
    lengths = np.ones((batch, beam), np.int64)

    for _ in range(1, max_step_num):
        if finished.all():
            break
        flat_tok = seqs[:, :, -1].reshape(-1)
        logits, new_states = decoder._logits(flat_tok, states)
        logp = _log_softmax_host(logits).reshape(batch, beam, vocab)
        # finished beams only extend with end_token, at no cost
        fin_mask = np.full((vocab,), -1e9, logp.dtype)
        fin_mask[decoder.end_token] = 0.0
        logp = np.where(finished[:, :, None], fin_mask[None, None, :], logp)
        total = scores[:, :, None] + logp                    # [B, beam, V]
        flat = total.reshape(batch, -1)
        pick = np.argsort(-flat, axis=-1)[:, :beam]          # [B, beam]
        scores = np.take_along_axis(flat, pick, axis=-1)
        src_beam = pick // vocab
        tok = pick % vocab
        seqs = np.concatenate([np.take_along_axis(seqs, src_beam[:, :, None], axis=1),
                               tok[:, :, None]], axis=2)
        was_fin = np.take_along_axis(finished, src_beam, axis=1)
        lengths = np.take_along_axis(lengths, src_beam, axis=1) + (~was_fin)
        finished = was_fin | (tok == decoder.end_token)
        gather_idx = (np.arange(batch)[:, None] * beam + src_beam).reshape(-1)
        states = _gather_states(new_states, gather_idx)

    ids = to_tensor(seqs)
    sc = to_tensor(scores)
    if output_time_major:
        ids = to_tensor(np.transpose(seqs, (2, 0, 1)))
    if return_length:
        return ids, sc, to_tensor(lengths)
    return ids, sc
