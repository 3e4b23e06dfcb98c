"""Weight initializers (counterpart: mxnet_tpu/initializer.py): InitDesc,
the Initializer base with its name rules, Zero, One, Constant, Uniform,
Normal, Xavier, and the RNN slice's FusedRNN and LSTMBias.

Dispatch is by parameter-name suffix as in the JAX package: *_bias, *_gamma,
*_beta and moving_* get fixed defaults, *_weight goes to the concrete
initializer's ``_init_weight``, and a variable's ``__init__`` attribute
(``[name, kwargs]`` JSON) wins over both.  Random draws come from
``random.generator()``.
"""
from __future__ import annotations

import json

import numpy as np

from .base import MXNetError, string_types
from . import ndarray as nd
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "FusedRNN", "LSTMBias"]


class InitDesc(str):
    """Parameter name + attrs descriptor (parity: initializer.py
    InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _fill(arr, tensor):
    """Write a host tensor into ``arr`` at its dtype and device."""
    arr._set_value(tensor.to(arr.value.device, arr.value.dtype))


class Initializer(object):
    """Base initializer: ``init(name, arr)`` fills the NDArray arr."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, arr):
        if not isinstance(name, string_types):
            raise TypeError("name must be string")
        if not isinstance(arr, nd.NDArray):
            raise TypeError("arr must be NDArray")
        init_attr = (getattr(name, "attrs", None) or {}).get("__init__", "")
        if init_attr:
            klass, kwargs = json.loads(init_attr)
            _REGISTRY[klass.lower()](**kwargs)._init_weight(name, arr)
            return
        if name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("moving_inv_var"):
            self._init_zero(name, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    def _init_bilinear(self, _, arr):
        weight = np.zeros(arr.shape, dtype="float32").reshape(-1)
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override it")

    def _init_default(self, name, _):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization is "
            "now limited to \"weight\", \"bias\", \"gamma\", and \"beta\"."
            % name)


class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


class Uniform(Initializer):
    """U(-scale, scale) (parity: Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _fill(arr, _random.uniform(-self.scale, self.scale, arr.shape))


class Normal(Initializer):
    """N(0, sigma) (parity: Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _fill(arr, _random.normal(0.0, self.sigma, arr.shape))


class Xavier(Initializer):
    """Xavier/Glorot init (parity: Xavier): scale sqrt(magnitude / factor)
    with factor the average, the fan-in or the fan-out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            _fill(arr, _random.uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            _fill(arr, _random.normal(0.0, scale, shape))
        else:
            raise ValueError("Unknown random type")


class FusedRNN(Initializer):
    """A FusedRNNCell's flat parameter vector, initialised by unpacking it,
    applying ``init`` to each weight (biases 0, an LSTM's forget-gate slice
    ``forget_bias``) and packing it again (parity: FusedRNN)."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if init is None:
            raise MXNetError("FusedRNN requires an inner initializer")
        if not isinstance(init, Initializer):
            klass, kwargs = json.loads(init)
            init = _REGISTRY[klass.lower()](**kwargs)
        super().__init__(init=init.dumps(), num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _infer_input_size(self, total):
        """The input size that gives ``total`` parameters."""
        h = self._num_hidden
        d = 2 if self._bidirectional else 1
        g = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[self._mode]
        rest = (self._num_layers - 1) * (h * d + h + 2) + h + 2
        input_size = total // (d * g * h) - rest
        if (input_size + rest) * d * g * h != total:
            raise MXNetError("FusedRNN: cannot infer input size from "
                             "%d parameters" % total)
        return int(input_size)

    def _init_weight(self, _, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(self._num_hidden, self._num_layers,
                                     self._mode, self._bidirectional,
                                     forget_bias=self._forget_bias,
                                     prefix="")
        cell._input_size_hint = self._infer_input_size(arr.size)
        args = cell.unpack_weights({"parameters": arr})
        h = self._num_hidden
        for name in args:
            if name.endswith("_bias"):
                v = np.zeros(args[name].shape, np.float32)
                if self._mode == "lstm":
                    # gates i,f,c,o: the forget gate's slice
                    v[h:2 * h] = self._forget_bias
                args[name][:] = v
            else:
                self._init(InitDesc(name), args[name])
        arr[:] = cell.pack_weights(args)["parameters"]


class LSTMBias(Initializer):
    """LSTM biases: 0, with the forget gate's quarter at ``forget_bias``
    (parity: LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_bias(self, name, arr):
        v = np.zeros(arr.shape, np.float32)
        if arr.shape[0] % 4 == 0:
            num_hidden = arr.shape[0] // 4
            v[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = v

    _init_weight = _init_bias


_REGISTRY = {c.__name__.lower(): c
             for c in (Zero, One, Constant, Uniform, Normal, Xavier,
                       FusedRNN, LSTMBias)}
