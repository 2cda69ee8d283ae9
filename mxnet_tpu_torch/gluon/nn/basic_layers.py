"""Basic layers (ref: python/mxnet/gluon/nn/basic_layers.py; the JAX
package's ``mxnet_tpu/gluon/nn/basic_layers.py``), with the same parameter
names and defaults."""
from __future__ import annotations

import torch

from ... import autograd, ops
from ..block import Block, HybridBlock


def _symbolic(x):
    """``x`` is a Symbol: the layer is being traced into a graph."""
    from ...symbol import Symbol

    return isinstance(x, Symbol)

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Flatten",
           "Lambda", "HybridLambda", "Embedding", "BatchNorm", "LayerNorm",
           "InstanceNorm", "GroupNorm", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "Swish", "GELU"]


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self.prefix)
            net.add(*layers[key])
            return net
        return layers[key]

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_SequentialMixin, Block):
    """(ref: basic_layers.py:Sequential)"""

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_SequentialMixin, HybridBlock):
    """(ref: basic_layers.py:HybridSequential)"""

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


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
    ``random.generator(x.device)``. ``axes`` is accepted and, as in the
    JAX package, not used: the mask is drawn per element, where upstream
    shares it along ``axes`` (ROADMAP.md C.2)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def hybrid_forward(self, F, x):
        if _symbolic(x):  # the executor's is_train sets it
            return F.Dropout(x, p=self._rate)
        return F.Dropout(x, p=self._rate, training=autograd.is_training())


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Lambda(Block):
    """Wraps a function of tensors, or the name of an ``F`` op."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = getattr(ops.F, function) if isinstance(function, str) \
            else function

    def forward(self, *args):
        with torch.set_grad_enabled(autograd.is_recording()):
            return self._func(*args)


class HybridLambda(HybridBlock):
    """Wraps ``function(F, *args)``, or the name of an ``F`` op."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = function

    def hybrid_forward(self, F, *args):
        if isinstance(self._func, str):
            return getattr(F, self._func)(*args)
        return self._func(F, *args)


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


class _NormBase(HybridBlock):
    def _store_stats(self, running_mean, running_var, m, v):
        """Write the moving statistics of a training forward into the
        parameters' tensors in place, so that whatever holds them (a
        server's captured CUDA graphs) keeps their addresses. Statistics
        that did not move (``use_global_stats``) are the tensors
        themselves, which the backward may still read: left alone."""
        if autograd.is_training() and m is not running_mean:
            with torch.no_grad():
                running_mean.copy_(m)
                running_var.copy_(v)


class BatchNorm(_NormBase):
    """(ref: basic_layers.py:BatchNorm, src/operator/nn/batch_norm.cc).
    Inside ``autograd.record()`` (training) it normalizes with the batch's
    statistics and moves ``running_mean`` and ``running_var``; otherwise it
    normalizes with them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = dict(axis=axis, eps=epsilon, momentum=momentum,
                            fix_gamma=not scale,
                            use_global_stats=use_global_stats)
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True,
                                         grad_req="write" if scale else "null")
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True,
                                        grad_req="write" if center else "null")
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                grad_req="null")
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                grad_req="null")

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if _symbolic(x):
            # the visible output only (upstream's NumVisibleOutputs=1); a
            # graph never writes the moving statistics, and the executor's
            # is_train sets the training flag
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               **self._kwargs)
        out, m, v = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                                training=autograd.is_training(),
                                **self._kwargs)
        self._store_stats(running_mean, running_var, m, v)
        return out


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(HybridBlock):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[1]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod

        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or init_mod.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
