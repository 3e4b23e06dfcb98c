"""Symbolic RNN cells (counterpart: mxnet_tpu/rnn/rnn_cell.py).

Cells build Symbol graphs.  ``FusedRNNCell`` maps to the fused ``RNN`` op
(ops/rnn_op.py: cuDNN on the card, the plain version on the host) and
``unfuse()``s into a stack of per-step cells (FullyConnected, SliceChannel,
Activation) with the same weights, which ``unpack_weights`` /
``pack_weights`` move between the two layouts as CPU NDArrays.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .. import ndarray as nd
from .. import symbol
from ..ops.rnn_op import _layer_param_shapes, rnn_unpack_params

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell"]


class RNNParams(object):
    """Container for a cell's parameter symbols (parity: RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract cell (parity: BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    def _resolve_states(self, states, like, batch_axis=0):
        """Replace begin-state init symbols carrying MXNet's 0 = unknown
        batch dim with ``_state_init(like)`` nodes that take the batch size
        from the live input (the JAX package's stand-in for nnvm's
        0-wildcard shape inference).  Handles the constant init funcs
        (zeros/ones/full) and forwards a dtype other than their default
        float32; other 0-batch producers raise.  A state left at the
        default takes the live input's dtype: torch's matmuls do not
        promote float32 states against float64 inputs as JAX's do, and for
        float32 inputs the two agree."""
        fill_of = {"_zeros": 0.0, "_ones": 1.0}
        out = []
        for s in states:
            node = s._outputs[0][0] if isinstance(s, symbol.Symbol) else None
            if node is not None and not node.is_var \
                    and node.op.name != "_state_init" \
                    and 0 in tuple(node.params.get("shape") or ()):
                if node.op.name in fill_of or node.op.name == "_full":
                    value = node.params.get("value") \
                        if node.op.name == "_full" \
                        else fill_of[node.op.name]
                    kwargs = {"shape": node.params["shape"],
                              "batch_axis": batch_axis,
                              "value": float(value or 0.0)}
                    if node.params.get("dtype") is not None:
                        kwargs["dtype"] = node.params["dtype"]
                    out.append(symbol.create("_state_init", like, **kwargs))
                else:
                    raise MXNetError(
                        "begin_state func %r with unknown (0) batch dim is "
                        "not supported; use zeros/ones/full or pass a "
                        "fully-shaped state" % node.op.name)
            else:
                out.append(s)
        return out

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_shape(self):
        raise NotImplementedError()

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial-state symbols (parity: begin_state)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        for info in self.state_shape:
            self._init_counter += 1
            if info is None:
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                        self._init_counter),
                             **kwargs)
            else:
                kwargs.update({"shape": info})
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                        self._init_counter),
                             **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split packed weights into per-gate entries, as CPU NDArrays
        (parity: unpack_weights)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copyto(cpu())
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copyto(cpu())
        return args

    def pack_weights(self, args):
        """Join per-gate entries into packed weights, as CPU NDArrays
        (parity: pack_weights)."""
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                nd.concatenate(weight).as_in_context(cpu())
            args["%s%s_bias" % (self._prefix, group_name)] = \
                nd.concatenate(bias).as_in_context(cpu())
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        """Unroll over time into a Symbol graph (parity:
        BaseRNNCell.unroll)."""
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1, \
                "unroll doesn't allow grouped symbol as input."
            axis = layout.find("T")
            inputs = symbol.create("SliceChannel", inputs, axis=axis,
                                   num_outputs=length, squeeze_axis=1,
                                   name="%sslice" % input_prefix)
            inputs = [inputs[i] for i in range(length)]
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.create("expand_dims", i, axis=1)
                       for i in outputs]
            outputs = symbol.create("Concat", *outputs, dim=1)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell, tanh or relu (parity: RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        states = self._resolve_states(states, inputs)
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.create("FullyConnected", data=inputs, weight=self._iW,
                            bias=self._iB, num_hidden=self._num_hidden,
                            name="%si2h" % name)
        h2h = symbol.create("FullyConnected", data=states[0], weight=self._hW,
                            bias=self._hB, num_hidden=self._num_hidden,
                            name="%sh2h" % name)
        output = symbol.create("Activation", i2h + h2h,
                               act_type=self._activation,
                               name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order i,f,g,o (parity: LSTMCell)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden), (0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        states = self._resolve_states(states, inputs)
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.create("FullyConnected", data=inputs, weight=self._iW,
                            bias=self._iB, num_hidden=self._num_hidden * 4,
                            name="%si2h" % name)
        h2h = symbol.create("FullyConnected", data=states[0], weight=self._hW,
                            bias=self._hB, num_hidden=self._num_hidden * 4,
                            name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.create("SliceChannel", gates, num_outputs=4,
                                    name="%sslice" % name)
        in_gate = symbol.create("Activation", slice_gates[0],
                                act_type="sigmoid", name="%si" % name)
        forget_gate = symbol.create("Activation", slice_gates[1],
                                    act_type="sigmoid", name="%sf" % name)
        in_transform = symbol.create("Activation", slice_gates[2],
                                     act_type="tanh", name="%sc" % name)
        out_gate = symbol.create("Activation", slice_gates[3],
                                 act_type="sigmoid", name="%so" % name)
        next_c = symbol.create("_plus", forget_gate * states[1],
                               in_gate * in_transform, name="%sstate" % name)
        next_h = symbol.create("_mul", out_gate,
                               symbol.create("Activation", next_c,
                                             act_type="tanh"),
                               name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order r,z,n (parity: GRUCell)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        states = self._resolve_states(states, inputs)
        name = "%st%d_" % (self._prefix, self._counter)
        prev_state_h = states[0]
        i2h = symbol.create("FullyConnected", data=inputs, weight=self._iW,
                            bias=self._iB, num_hidden=self._num_hidden * 3,
                            name="%si2h" % name)
        h2h = symbol.create("FullyConnected", data=prev_state_h,
                            weight=self._hW, bias=self._hB,
                            num_hidden=self._num_hidden * 3,
                            name="%sh2h" % name)
        i2h = symbol.create("SliceChannel", i2h, num_outputs=3,
                            name="%si2h_slice" % name)
        h2h = symbol.create("SliceChannel", h2h, num_outputs=3,
                            name="%sh2h_slice" % name)
        reset_gate = symbol.create("Activation", i2h[0] + h2h[0],
                                   act_type="sigmoid", name="%sr_act" % name)
        update_gate = symbol.create("Activation", i2h[1] + h2h[1],
                                    act_type="sigmoid", name="%sz_act" % name)
        next_h_tmp = symbol.create("Activation",
                                   i2h[2] + reset_gate * h2h[2],
                                   act_type="tanh", name="%sh_act" % name)
        next_h = symbol.create(
            "_plus", (1.0 - update_gate) * next_h_tmp,
            update_gate * prev_state_h, name="%sout" % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN over the whole sequence through the ``RNN`` op
    (parity: FusedRNNCell; cuDNN on the card)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None,
                 initializer=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        # the flat parameter vector initialises by unpack -> init -> pack
        from .. import initializer as init_mod
        if initializer is None:
            initializer = init_mod.Xavier(factor_type="in", magnitude=2.34)
        if not isinstance(initializer, init_mod.FusedRNN):
            initializer = init_mod.FusedRNN(initializer, num_hidden,
                                            num_layers, mode, bidirectional,
                                            forget_bias)
        self._parameter = self.params.get("parameters", init=initializer)

    @property
    def state_shape(self):
        b = self._num_layers * (2 if self._bidirectional else 1)
        n = 2 if self._mode == "lstm" else 1
        return [(b, 0, self._num_hidden)] * n

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _unfuse_prefix(self, layer, d):
        return "%s%s%d_" % (self._prefix, self._directions[d], layer)

    def unpack_weights(self, args):
        """Flat parameter vector -> per-cell weights, as CPU NDArrays
        (parity: unpack_weights)."""
        args = args.copy()
        arr = args.pop(self._prefix + "parameters").asnumpy()
        h = self._num_hidden
        input_size = self._input_size_hint
        parts = rnn_unpack_params(arr, self._mode, input_size, h,
                                  self._num_layers, self._bidirectional)
        for (layer, d, name), v in parts.items():
            prefix = self._unfuse_prefix(layer, d)
            args[prefix + name] = nd.array(v, ctx=cpu())
        return args

    def pack_weights(self, args):
        args = args.copy()
        h = self._num_hidden
        flat = []
        input_size = self._input_size_hint
        for layer, d, name, shape in _layer_param_shapes(
                self._mode, input_size, h, self._num_layers,
                self._bidirectional):
            prefix = self._unfuse_prefix(layer, d)
            flat.append(args.pop(prefix + name).asnumpy().reshape(-1))
        args[self._prefix + "parameters"] = nd.array(np.concatenate(flat),
                                                      ctx=cpu())
        return args

    _input_size_hint = 0  # set by callers needing pack/unpack

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=True):
        """The whole sequence through one ``RNN`` node (parity:
        FusedRNNCell.unroll)."""
        self.reset()
        assert inputs is not None, "FusedRNNCell requires symbolic input"
        if isinstance(inputs, (list, tuple)):
            inputs = [symbol.create("expand_dims", x, axis=0) for x in inputs]
            inputs = symbol.create("Concat", *inputs, dim=0)  # TNC
        elif layout == "NTC":
            inputs = symbol.create("SwapAxis", inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        # inputs are TNC here: batch is axis 1 of the like-input
        states = self._resolve_states(begin_state, inputs, batch_axis=1)
        kwargs = {}
        if self._mode == "lstm":
            kwargs["state_cell"] = states[1]
        rnn = symbol.create("RNN", data=inputs, parameters=self._parameter,
                            state=states[0], state_size=self._num_hidden,
                            num_layers=self._num_layers, mode=self._mode,
                            bidirectional=self._bidirectional,
                            p=self._dropout,
                            state_outputs=self._get_next_state,
                            name=self._prefix + "rnn", **kwargs)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if layout == "NTC":
            outputs = symbol.create("SwapAxis", outputs, dim1=0, dim2=1)
        if not merge_outputs:
            outputs = symbol.create("SliceChannel", outputs,
                                    axis=layout.find("T"),
                                    num_outputs=length, squeeze_axis=1)
            outputs = [outputs[i] for i in range(length)]
        return outputs, states

    def unfuse(self):
        """Equivalent unfused SequentialRNNCell (parity: unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, activation="relu",
                                          prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, activation="tanh",
                                          prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack cells (parity: SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child " \
                "cells, " \
                "not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            if isinstance(cell, BidirectionalCell):
                raise MXNetError("Bidirectional cannot be stepped; "
                                 "use unroll")
            n = len(cell.state_shape)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        """Unroll cell by cell over the whole sequence, so that stacked
        Bidirectional and Fused cells work (parity:
        SequentialRNNCell.unroll)."""
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_shape)
            cell_states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=cell_states,
                input_prefix=input_prefix, layout=layout,
                merge_outputs=False if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over opposite directions (parity: BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_shape(self):
        return sum([c.state_shape for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            axis = layout.find("T")
            inputs = symbol.create("SliceChannel", inputs, axis=axis,
                                   num_outputs=length, squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_shape)],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_shape):],
            layout=layout, merge_outputs=False)
        outputs = [symbol.create("Concat", l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        states = [l_states, r_states]
        return outputs, sum(states, [])


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (parity: ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_shape(self):
        return self.base_cell.state_shape

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Dropout on outputs (parity: DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_shape(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.create("Dropout", data=inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout state regularization (parity: ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = self.base_cell, self.zoneout_outputs, \
            self.zoneout_states
        # resolve 0-batch begin states HERE too: the where() below mixes the
        # base cell's (resolved) next_states with our captured old states
        states = self._resolve_states(states, inputs)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.create(
            "Dropout", symbol.create("ones_like", like), p=p)
        prev_output = self.prev_output if self.prev_output is not None else \
            symbol.create("zeros_like", next_output)
        output = symbol.create("where", mask(p_outputs, next_output),
                               next_output, prev_output) \
            if p_outputs != 0.0 else next_output
        states = [symbol.create("where", mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds residual connection (parity: ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.create("_plus", output, inputs,
                               name="%s_plus_residual"
                               % (output.name or "res"))
        return output, states
