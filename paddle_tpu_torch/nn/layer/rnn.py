"""Recurrent layers (counterpart: paddle_tpu/nn/layer/rnn.py).

Paddle's cells, gate orders and weight layout: ``weight_ih`` [G * H,
in], ``weight_hh`` [G * H, H], both biases [G * H], all drawn uniform in
``±1 / sqrt(H)``; LSTM gates ``i, f, g, o``, ``c' = f * c + i * g``;
GRU gates ``r, z, g`` with ``g = tanh(x_g + r * (h_g))`` and ``h' = (1 -
z) * g + z * h``.  `RNN` runs a cell over time in a Python loop,
`BiRNN` a forward and a reversed cell, their outputs concatenated.

Two behaviours of the JAX package are kept: `RNN` and `BiRNN` ignore
``sequence_length`` (every step of every sequence runs), and
`SimpleRNN`/`LSTM`/`GRU` pass no ``initial_states`` on (every layer
starts from zeros).  While `static.fx_export` traces a model into a
ProgramDesc (`static.export_marker`'s program mode), `SimpleRNN`/`LSTM`/
`GRU` bind the ``paddle_tpu_torch::rnn`` marker op instead of their time
loop, and the exporter writes ONE reference ``rnn`` op.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from .. import initializer as init
from .container import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """Zeros (f32) of ``[batch] + shape`` for each state of the cell,
        on ``batch_ref``'s device."""
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dev = batch_ref.device
        if isinstance(shape[0], (list, tuple)):
            return tuple(torch.zeros([batch] + list(s), device=dev)
                         for s in shape)
        return torch.zeros([batch] + list(shape), device=dev)

    def _weights(self, gates, input_size, hidden_size, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr, device, dtype):
        std = 1.0 / np.sqrt(hidden_size)
        u = init.Uniform(-std, std)
        g = gates * hidden_size
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], weight_ih_attr, dtype, default_initializer=u,
            device=device)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], weight_hh_attr, dtype, default_initializer=u,
            device=device)
        self.bias_ih = self.create_parameter(
            [g], bias_ih_attr, dtype, is_bias=True, default_initializer=u,
            device=device)
        self.bias_hh = self.create_parameter(
            [g], bias_hh_attr, dtype, is_bias=True, default_initializer=u,
            device=device)

    def _gates(self, x, h):
        return (x @ self.weight_ih.T + self.bias_ih,
                h @ self.weight_hh.T + self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self._weights(1, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                      dtype)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi, gh = self._gates(inputs, states)
        act = torch.tanh if self.activation == "tanh" else torch.relu
        h = act(gi + gh)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self._weights(4, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                      dtype)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        gi, gh = self._gates(inputs, h)
        i, f, g, o = (gi + gh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self._weights(3, input_size, hidden_size, weight_ih_attr,
                      weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                      dtype)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi, gh = self._gates(inputs, states)
        ir, iz, ig = gi.chunk(3, dim=-1)
        hr, hz, hg = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        g = torch.tanh(ig + r * hg)
        h = (1 - z) * g + z * states
        return h, h


class RNN(Layer):
    """``cell`` over the time axis (1, or 0 with ``time_major``), in
    reverse with ``is_reverse``; returns the stacked outputs and the
    last states.  ``sequence_length`` is taken and not read."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        states = initial_states
        outputs = []
        order = range(steps - 1, -1, -1) if self.is_reverse else \
            range(steps)
        for t in order:
            out, states = self.cell(inputs.select(axis, t), states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return torch.stack(outputs, axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = initial_states if initial_states is not None else \
            (None, None)
        out_fw, st_fw = self.rnn_fw(inputs, s_fw)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        nd = 2 if direction in ("bidirect", "bidirectional") else 1
        self.num_directions = nd
        cell_cls = {"RNN_TANH": SimpleRNNCell, "RNN_RELU": SimpleRNNCell,
                    "LSTM": LSTMCell, "GRU": GRUCell}[mode]
        kw = dict(device=device, dtype=dtype)
        if mode.startswith("RNN_"):
            kw["activation"] = mode[4:].lower()

        def cell(in_size):
            return cell_cls(in_size, hidden_size, **kw)

        self._all_layers = LayerList()
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * nd
            self._all_layers.append(
                BiRNN(cell(in_size), cell(in_size), time_major) if nd == 2
                else RNN(cell(in_size), time_major=time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """Every layer from zeros (``initial_states`` and
        ``sequence_length`` taken and not read, as in the JAX package);
        returns the last layer's outputs and the final states stacked
        ``[num_layers * num_directions, B, H]`` (LSTM: ``(h, c)``)."""
        from ...static.export_marker import export_tracing

        if (export_tracing() and initial_states is None
                and sequence_length is None):
            return self._export_forward(inputs)
        out = inputs
        final_h, final_c = [], []
        for i, rnn_l in enumerate(self._all_layers):
            out, st = rnn_l(out)
            per_dir = list(st) if self.num_directions == 2 else [st]
            for s in per_dir:
                if self.mode == "LSTM":
                    final_h.append(s[0])
                    final_c.append(s[1])
                else:
                    final_h.append(s)
            if self.dropout > 0 and i < len(self._all_layers) - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        h = torch.stack(final_h, 0)
        if self.mode == "LSTM":
            return out, (h, torch.stack(final_c, 0))
        return out, h

    def _export_forward(self, inputs):
        """Export-time lowering: bind the ``paddle_tpu_torch::rnn`` marker
        so the exporter emits ONE unified `rnn` op
        (`operators/rnn_op.cc`) instead of T copies of the cell.  Weight
        order is the op's WeightList: (w_ih, w_hh) per (layer,
        direction), then (b_ih, b_hh) per (layer, direction)."""
        from ...static.export_marker import rnn_marker

        nd = self.num_directions
        cells = []
        for lyr in self._all_layers:
            if nd == 2:
                cells += [lyr.rnn_fw.cell, lyr.rnn_bw.cell]
            else:
                cells.append(lyr.cell)
        ws = [w for c in cells for w in (c.weight_ih, c.weight_hh)]
        bs = [b for c in cells for b in (c.bias_ih, c.bias_hh)]
        batch = inputs.shape[1] if self.time_major else inputs.shape[0]
        h0 = inputs.new_zeros((self.num_layers * nd, batch,
                               self.hidden_size))
        outs = rnn_marker(inputs, h0, torch.zeros_like(h0), ws + bs,
                          self.mode, self.hidden_size, self.num_layers,
                          nd == 2, bool(self.time_major),
                          float(self.dropout))
        if self.mode == "LSTM":
            out, h, c = outs
            return out, (h, c)
        out, h = outs
        return out, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", device=None, dtype=torch.float32,
                 **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device, dtype)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, dtype=torch.float32, **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device, dtype)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, dtype=torch.float32, **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device, dtype)
