"""The recurrent layers (counterparts of paddle_tpu/nn/layer/rnn.py): the
cells, `RNN` over a cell, `SimpleRNN`, `LSTM`, `GRU` and `BiRNN`, in
plain torch ops (the reference's are `lax.scan`; no Pallas kernel).

The reference's gates and math: a cell's weights are (gates x hidden,
in) and (gates x hidden, hidden), uniform in +-1/sqrt(hidden); LSTM's
gates are i, f, g, o on x @ W_ih^T + b_ih + h @ W_hh^T + b_hh; GRU's are
r, z, n with n = tanh(x_n + r * h_n). The multi-layer nets take their
parameters under torch's names (`weight_ih_l{k}[_reverse]`, ...), start
from zero states unless `initial_states` is given ((layers x directions,
batch, hidden), a pair for LSTM), apply no dropout between layers (the
reference's `dropout` is kept and unused) and refuse `sequence_length`
(the reference ignores it); `RNN` over a cell masks padded steps as the
reference does.
"""
from __future__ import annotations

import torch

from ...core.tensor import Tensor
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU"]


def _t(x):
    return x._t if isinstance(x, Tensor) else x


def _wrap(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap(v) for v in x)
    return Tensor._wrap(x)


def _lstm(x, h, c, wih, whh, bih, bhh):
    gates = x @ wih.t() + bih + h @ whh.t() + bhh
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru(x, h, wih, whh, bih, bhh):
    ir, iz, in_ = (x @ wih.t() + bih).chunk(3, dim=-1)
    hr, hz, hn = (h @ whh.t() + bhh).chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def _simple(x, h, wih, whh, bih, bhh, act):
    pre = x @ wih.t() + bih + h @ whh.t() + bhh
    return torch.tanh(pre) if act == "tanh" else torch.relu(pre)


def _gate_params(layer, n_gates, in_size, hidden, suffix="", attrs=()):
    std = 1.0 / hidden ** 0.5
    attrs = dict(attrs)
    for name, shape, bias in (
            ("weight_ih", [n_gates * hidden, in_size], False),
            ("weight_hh", [n_gates * hidden, hidden], False),
            ("bias_ih", [n_gates * hidden], True),
            ("bias_hh", [n_gates * hidden], True)):
        layer.add_parameter(name + suffix, layer.create_parameter(
            shape, attr=attrs.get(name), is_bias=bias,
            default_initializer=I.Uniform(-std, std)))


class _RNNCellBase(Layer):
    _GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _gate_params(self, self._GATES, input_size, hidden_size, attrs=dict(
            weight_ih=weight_ih_attr, weight_hh=weight_hh_attr,
            bias_ih=bias_ih_attr, bias_hh=bias_hh_attr))

    def _zeros(self, x):
        return x.new_zeros(x.shape[0], self.hidden_size)

    def _weights(self):
        return [self._parameters[n] for n in ("weight_ih", "weight_hh",
                                               "bias_ih", "bias_hh")]


class SimpleRNNCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, **kw)
        self.activation = activation

    def forward(self, inputs, states=None):
        x = _t(inputs)
        h = self._zeros(x) if states is None else _t(states)
        out = _simple(x, h, *self._weights(), self.activation)
        return _wrap(out), _wrap(out)


class LSTMCell(_RNNCellBase):
    _GATES = 4

    def forward(self, inputs, states=None):
        x = _t(inputs)
        if states is None:
            h, c = self._zeros(x), self._zeros(x)
        else:
            h, c = (_t(s) for s in states)
        h, c = _lstm(x, h, c, *self._weights())
        return _wrap(h), (_wrap(h), _wrap(c))


class GRUCell(_RNNCellBase):
    _GATES = 3

    def forward(self, inputs, states=None):
        x = _t(inputs)
        h = self._zeros(x) if states is None else _t(states)
        out = _gru(x, h, *self._weights())
        return _wrap(out), _wrap(out)


def _map(states, fn):
    if isinstance(states, (tuple, list)):
        return type(states)(_map(s, fn) for s in states)
    return fn(states)


def _map2(a, b, fn):
    if isinstance(a, (tuple, list)):
        return type(a)(_map2(x, y, fn) for x, y in zip(a, b))
    return fn(a, b)


class RNN(Layer):
    """A cell run over time (paddle.nn.RNN). With `sequence_length`, a
    padded step emits zeros and keeps the previous state, so a reversed
    run starts at each sample's last valid step."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        valid_len = None
        if sequence_length is not None:
            valid_len = torch.as_tensor(
                _t(sequence_length), device=inputs._t.device).long()[:, None]
        outputs = []
        states = initial_states
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        for i in order:
            x_t = inputs[:, i] if time_axis == 1 else inputs[i]
            out, new_states = self.cell(x_t, states)
            if valid_len is not None:
                valid = valid_len > i
                out = _wrap(torch.where(valid, out._t,
                                        torch.zeros_like(out._t)))
                if states is None:
                    states = _map(new_states, lambda s: _wrap(
                        torch.zeros_like(s._t)))
                # select, so a NaN of a padded step cannot leak through
                new_states = _map2(new_states, states, lambda n, o: _wrap(
                    torch.where(valid, n._t, o._t)))
            states = new_states
            outputs.append(out._t)
        if self.is_reverse:
            outputs = outputs[::-1]
        return _wrap(torch.stack(outputs, dim=time_axis)), states


class BiRNN(Layer):
    """A forward and a reversed RNN, concatenated on the feature axis."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length)
        return (_wrap(torch.cat([out_fw._t, out_bw._t], dim=-1)),
                (st_fw, st_bw))


class _RNNBase(Layer):
    _MODE = ""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        n_gates = {"RNN_TANH": 1, "RNN_RELU": 1, "LSTM": 4, "GRU": 3}[
            self._MODE]
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else \
                hidden_size * self.num_directions
            for d in range(self.num_directions):
                _gate_params(self, n_gates, in_size, hidden_size,
                             f"_l{layer}{'_reverse' if d else ''}")

    def _step(self, x, carry, ws):
        if self._MODE == "LSTM":
            return _lstm(x, *carry, *ws)
        if self._MODE == "GRU":
            return _gru(x, carry, *ws)
        return _simple(x, carry, *ws,
                       "tanh" if self._MODE == "RNN_TANH" else "relu")

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if sequence_length is not None:
            raise NotImplementedError(
                f"{type(self).__name__}(sequence_length=...) is not "
                "supported; wrap a cell in nn.RNN for masked steps")
        lstm = self._MODE == "LSTM"
        xs = _t(inputs)
        xs = xs if self.time_major else xs.transpose(0, 1)   # (T, B, F)
        n = self.num_layers * self.num_directions
        if initial_states is None:
            zero = xs.new_zeros(n, xs.shape[1], self.hidden_size)
            init = (zero, zero) if lstm else zero
        else:
            init = _map(initial_states, _t)
        finals = []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_directions):
                k = layer * self.num_directions + d
                ws = [self._parameters[f"{w}_l{layer}"
                                       f"{'_reverse' if d else ''}"]
                      for w in ("weight_ih", "weight_hh", "bias_ih",
                                "bias_hh")]
                carry = (init[0][k], init[1][k]) if lstm else init[k]
                ys = []
                for t in (range(xs.shape[0] - 1, -1, -1) if d
                          else range(xs.shape[0])):
                    carry = self._step(xs[t], carry, ws)
                    ys.append(carry[0] if lstm else carry)
                outs.append(torch.stack(ys[::-1] if d else ys))
                finals.append(carry)
            xs = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        out = _wrap(xs if self.time_major else xs.transpose(0, 1))
        if lstm:
            return out, (_wrap(torch.stack([c[0] for c in finals])),
                         _wrap(torch.stack([c[1] for c in finals])))
        return out, _wrap(torch.stack(finals))


class SimpleRNN(_RNNBase):
    _MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        self._MODE = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kw)


class LSTM(_RNNBase):
    _MODE = "LSTM"


class GRU(_RNNBase):
    _MODE = "GRU"
