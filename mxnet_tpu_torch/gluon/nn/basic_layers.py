"""Basic layers BERT uses (ref: python/mxnet/gluon/nn/basic_layers.py; the
JAX package's ``mxnet_tpu/gluon/nn/basic_layers.py``), with the same
parameter names and defaults."""
from __future__ import annotations

from ... import autograd
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Dropout", "Embedding", "LayerNorm",
           "Activation"]


class HybridSequential(HybridBlock):
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """(ref: basic_layers.py:Dense → FullyConnected)"""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          init=weight_initializer, dtype=dtype,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(units,),
                                            init=bias_initializer, dtype=dtype,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation else None

    def infer_shape(self, x, *args):
        in_units = x.shape[-1]
        if self._flatten:
            in_units = 1
            for s in x.shape[1:]:
                in_units *= s
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out


class Dropout(HybridBlock):
    """Inverted dropout while ``autograd`` is in training mode (inside
    ``record()``), the identity otherwise; the mask comes from
    ``random.generator(x.device)``."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        if axes:
            raise NotImplementedError("Dropout with shared axes is not "
                                      "ported yet")
        self._rate = rate

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, training=autograd.is_training())


class Embedding(HybridBlock):
    """(ref: basic_layers.py:Embedding)"""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get("weight",
                                          shape=(input_dim, output_dim),
                                          init=weight_initializer, dtype=dtype)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class LayerNorm(HybridBlock):
    """(ref: basic_layers.py:LayerNorm)"""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True,
                                         grad_req="write" if scale else "null")
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True,
                                        grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)
